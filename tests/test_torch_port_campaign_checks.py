"""The port's campaign-level post-campaign checks against the JAX scripts, on the CPU.

* ``gl_spsi_check``, ``gl24_check`` and ``ivector_delta_rescore`` with the
  entry points they reach (the spoof-set, CM and curve CLIs, the GE2E
  harness, the i-vector pipeline) replaced by recorders that return
  scripted results, as in ``tests/test_torch_port_campaign.py``: both
  packages' scripts make the same calls with the same arguments (the GE2E
  configuration and the ``Config`` as dicts), write the same
  ``config_gl*.json`` bytes, and return the same output dicts and shift.
  The JAX scripts run in this process from ``scripts/`` (their
  ``campaign.py`` import parses the argv they set), with their writes to
  ``docs/`` sent under the test's directory and their compile-cache
  settings dropped.
* ``vad_ab`` on a few generated corpus wavs: the four host legs' JSON equal
  to the JAX script's, the embedding leg's cosines within 1e-4 with the
  same GE2E weights (seed-0 at ``GE2EConfig()``'s widths, saved by the
  port in the JAX harness's ``.npz`` layout).
* ``spec_rate_diag`` under a ``Synthesizer`` whose attention is a scripted
  function of its inputs: the identical output dict; a tiny real run of the
  port gives the JAX keys.
* Every new entry point refuses to run without a card unless it is given
  ``device="cpu"``.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_torch.cli import (campaign, exp_gl_init, gl24_check, gl_init_check, gl_mcd_ab,
                               gl_spsi_check, ivector_delta_rescore, spec_rate_diag, vad_ab)
from spoofsv_torch.config import Config
from spoofsv_torch.data.toy import generate_toy_corpus
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.models.ge2e import SpeechEmbedder
from spoofsv_torch.weights import save_ge2e_checkpoint

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
BASE = {"synthesize": {"n_batches": 1},
        "ge2e": {"EER": 0.25, "clean_threshold": 0.5, "spoof_rate": 0.5,
                 "spoof_rate_at_eer": 0.375, "gt_FRR": 0.125, "extra": 1},
        "ivector": {"mixed_eer": 0.375, "clean_eer": 0.25, "spoof_rate": 0.0625, "extra": 2},
        "cm": {"cm_eer": 0.5, "threshold": 0.1}}
# the GE2E embedder at narrow widths on both sides (the checks build
# ``GE2EConfig()``'s): the JAX LSTM compiles once a window count
GE2E_MODEL = dict(hidden=32, num_layer=1, proj=16)
CM_LINES = "B00 LA_D_1 bonafide 0.9\nB00 LA_D_2 bonafide 0.2\np1 s_1 spoof 0.4\np1 s_2 spoof -0.5\n"


def build_tree(root: Path) -> Config:
    """A campaign root with a toy corpus of 2 speakers (wavs at 48 kHz, their
    embeddings), seed-0 Text2Mel and SSRN at hidden 32 as ``.tar.pth``,
    ``config.json``, ``texts.txt`` and the base stages' markers."""
    data, spk = str(root / "corpus"), str(root / "spk_emb")
    generate_toy_corpus(data, spk, n_speakers=2, utts_per_spk=3, seed=0, min_chars=8,
                        max_chars=12)
    cfg = Config().replace(data_root_dir=data, spk_emb_dir=spk, src_root_dir=str(root) + "/",
                           hidden_dim=32, text_emb_dim=16, ssrn_dim=32, max_frame_num=12)
    torch.manual_seed(0)
    ck = root / "checkpoints" / "conditional" / "not_adversarial" / campaign.BASE_TAG
    ck.mkdir(parents=True)
    for name, m in (("text2mel", MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                                        cfg.mel.freq_bins, cfg.hidden_dim)),
                    ("ssrn", SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim))):
        torch.save({"model_state_dict": m.state_dict()}, ck / f"{name}_best_model.tar.pth")
    cfg = cfg.replace(inference_text2mel_model=str(ck / "text2mel_best_model.tar.pth"),
                      inference_ssrn_model=str(ck / "ssrn_best_model.tar.pth"))
    (root / "config.json").write_text(json.dumps(cfg.to_reference_dict(), indent=2))
    # 20 ids (19 characters and the end) sit on the arm-C rungs' 2.5 x 20 = 50 > 48 edge
    (root / "texts.txt").write_text("ab cd\nthe quick brown fox\n"
                                    "a longer line of words, twenty more\n")
    state = root / "state"
    state.mkdir()
    for k, v in BASE.items():
        (state / f"{k}.json").write_text(json.dumps(v))
    torch.manual_seed(0)
    emb = SpeechEmbedder(hidden=GE2E_MODEL["hidden"], num_layers=GE2E_MODEL["num_layer"],
                         proj=GE2E_MODEL["proj"])
    (root / "ge2e_ck").mkdir()
    save_ge2e_checkpoint(str(root / "ge2e_ck" / "final_1.npz"), emb)
    (state / "ge2e.json").write_text(json.dumps({**BASE["ge2e"],
                                                 "checkpoint": str(root / "ge2e_ck/final_1.npz")}))
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("campaign_checks") / "campaign"
    build_tree(root)
    return root


@pytest.fixture
def jax_scripts(monkeypatch, tmp_path):
    """``load(name, argv)`` imports ``scripts/<name>.py`` with ``sys.argv``
    set to ``argv`` (as the module ``as_name`` when given) and ``_benchlib``
    replaced, its ``OUT`` under
    ``tmp_path``; the JAX scripts' compile-cache settings are dropped and
    the scripts' own modules are dropped again afterwards."""
    from jax._src import xla_bridge

    before = set(sys.modules)
    bench = types.ModuleType("_benchlib")
    bench.setup_cache = lambda: None
    for name in ("_benchlib", "scripts._benchlib"):
        monkeypatch.setitem(sys.modules, name, bench)
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.syspath_prepend(str(REPO))
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None if name in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
        "jax_platforms") else update(name, value))
    monkeypatch.setattr(xla_bridge, "_clear_backends", lambda: None)

    def load(name, argv, as_name=None):
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        spec = importlib.util.spec_from_file_location(as_name or f"jax_script_{name}",
                                                      SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        if as_name:
            sys.modules[as_name] = mod
        spec.loader.exec_module(mod)
        if hasattr(mod, "OUT"):
            mod.OUT = str(tmp_path / f"jax_{name}.json")
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        return mod

    yield load
    for name in set(sys.modules) - before:     # the scripts' modules, not the packages'
        if str(getattr(sys.modules[name], "__file__", "") or "").startswith(str(SCRIPTS)):
            del sys.modules[name]


# -- the campaign-level re-scorings ------------------------------------------

def plain(o):
    if hasattr(o, "to_reference_dict"):
        return o.to_reference_dict()
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    if isinstance(o, np.generic):
        return o.item()
    return str(o)


def recorders(mods, calls, root):
    """(module, name, recorder) for every entry point the checks reach; the
    CM recorder writes the scores file the check reads back."""
    def rec(name, result=None):
        def fn(*args, **kw):
            calls.append([name, list(args), kw])
            if name == "cli.antispoof":
                tag = args[0][args[0].index("-T") + 1]
                os.makedirs(root / "cm_scores", exist_ok=True)
                (root / "cm_scores" / f"scores_{tag}.txt").write_text(CM_LINES)
            if callable(result):
                return result()
            return dict(result) if result is not None else None
        return fn

    count = [0]

    def ivector_result():
        count[0] += 1
        return {"mixed_eer": 0.375 / count[0], "clean_eer": 0.25, "clean_threshold": 1.5 * count[0],
                "spoof_rate": 0.0625 * count[0], "n_trials": 7}

    return [(mods["gtu"], "main", rec("cli.generate_test_utterances")),
            (mods["antispoof"], "main", rec("cli.antispoof")),
            (mods["gh"], "save_spectrogram_tisv", rec("ge2e.save_spectrogram_tisv")),
            (mods["gh"], "run_ge2e_evaluation",
             rec("ge2e.run_ge2e_evaluation", dict(EER=0.25, spoof_rate=0.5, gt_FRR=0.125))),
            (mods["ivector"], "run_ivector_pipeline",
             rec("ivector.run_ivector_pipeline", ivector_result))]


def _port_mods():
    from spoofsv_torch.cli import antispoof, generate_test_utterances as gtu
    from spoofsv_torch.spoofkit import ge2e_harness as gh, ivector

    return dict(gtu=gtu, antispoof=antispoof, gh=gh, ivector=ivector)


def _jax_mods():
    from spoofsv_tpu.cli import antispoof, generate_test_utterances as gtu
    from spoofsv_tpu.spoofkit import ge2e_harness as gh, ivector

    return dict(gtu=gtu, antispoof=antispoof, gh=gh, ivector=ivector)


def _clean(root: Path) -> None:
    for p in [*root.glob("config_gl*.json"), root / "cm_scores"]:
        if p.is_dir():
            for q in p.iterdir():
                q.unlink()
            p.rmdir()
        elif p.exists():
            p.unlink()


@pytest.mark.parametrize("check", ["gl_spsi_check", "gl24_check", "ivector_delta_rescore"])
def test_rescoring_checks_call_the_entry_points_as_the_jax_scripts(tree, jax_scripts,
                                                                   monkeypatch, check):
    """The same calls, config files, written results and output dicts."""
    port_mod = {"gl_spsi_check": gl_spsi_check, "gl24_check": gl24_check,
                "ivector_delta_rescore": ivector_delta_rescore}[check]
    argv = ["--root", str(tree)]
    out_name = {"gl_spsi_check": "gl_spsi_check.json", "gl24_check": "gl24_check.json",
                "ivector_delta_rescore": "IVECTOR_DELTAS.json"}[check]
    runs = {}
    for side in ("jax", "port"):
        _clean(tree)
        calls = []
        for mod, name, fn in recorders(_jax_mods() if side == "jax" else _port_mods(), calls,
                                       tree):
            monkeypatch.setattr(mod, name, fn)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if side == "jax":
                if check == "gl24_check":
                    # it hands campaign.py no flag: its campaign module comes
                    # first, from the argv that names the root
                    jax_scripts("campaign", argv, as_name="campaign")
                mod = jax_scripts(check, argv)
                mod.main()
                written = (tree / "state" / out_name if check != "ivector_delta_rescore"
                           else Path(mod.OUT))
                result = json.loads(written.read_text())
            else:
                result = port_mod.main(argv, device="cpu")
                written = tree / "state" / out_name
        for _, _, kw in calls:
            if "device" in kw:
                assert kw.pop("device") == torch.device("cpu")
        runs[side] = dict(calls=json.loads(json.dumps(calls, default=plain)),
                          result=json.loads(json.dumps(result, default=float)),
                          written=json.loads(written.read_text()),
                          configs={p.name: p.read_bytes() for p in tree.glob("config_gl*.json")})
    jx, pt = runs["jax"], runs["port"]
    assert pt["calls"] == jx["calls"] and pt["calls"]
    assert pt["configs"] == jx["configs"]
    assert pt["result"] == pt["written"] == jx["written"]
    if check == "ivector_delta_rescore":
        shift = pt["result"]["results"]["shift"]
        assert shift == {"mixed_eer": round(0.1875 - 0.375, 5), "clean_eer": 0.0,
                         "clean_threshold": 1.5, "spoof_rate": 0.0625}
    else:
        base = pt["result"]["base_production" if check == "gl_spsi_check" else "base_gl32"]
        assert base["ge2e"]["EER"] == 0.25 and base["cm"] == {"cm_eer": 0.5}
        assert sorted(pt["configs"]) == (["config_glspsi12.json", "config_glspsi16.json"]
                                         if check == "gl_spsi_check" else ["config_gl24.json"])


# -- vad_ab -------------------------------------------------------------------

def test_vad_ab_matches_the_jax_script(tree, jax_scripts, monkeypatch):
    """Two corpus wavs: the host legs' JSON equal, the embedding leg's
    counts equal and its cosines within 1e-4 (both embedders at
    ``GE2E_MODEL``'s widths)."""
    import spoofsv_torch.config as port_config
    import spoofsv_tpu.config as jax_config

    for mod in (port_config, jax_config):
        cls = mod.GE2EConfig
        monkeypatch.setattr(mod, "GE2EConfig", lambda _c=cls: dataclasses.replace(
            _c(), model=dataclasses.replace(_c().model, **GE2E_MODEL)))
    ck = str(tree / "ge2e_ck")
    argv = ["--root", str(tree), "--utts", "2", "--ge2e_ck", ck]
    J = jax_scripts("vad_ab", argv)
    with contextlib.redirect_stdout(io.StringIO()):
        J.main()
        got = vad_ab.main(argv, device="cpu")
    want = json.loads(Path(J.OUT).read_text())
    assert json.loads((tree / "state" / "VAD_AB.json").read_text()) == got
    emb, ref = got.pop("embedding_leg"), want.pop("embedding_leg")
    assert json.dumps(got) == json.dumps(want) and got["n_utts"] == 2
    assert got["clean"]["per_classifier"]["webrtc"]["segments"] > 0
    assert emb["n_compared"] == ref["n_compared"] >= 1
    assert emb["aligned_counts"] == ref["aligned_counts"] and emb["ge2e_ck"] == ref["ge2e_ck"]
    for k in ("mean_dvector_cos_mean", "mean_dvector_cos_min"):
        assert abs(emb[k] - ref[k]) <= 1e-4, (k, emb[k], ref[k])


# -- spec_rate_diag -------------------------------------------------------------

def scripted_attention(text, spk, n_frames: int) -> np.ndarray:
    """(B, N, n_frames) one-hot attention: each row walks its text at a rate
    drawn from its ids and embedding; some rows never reach the end."""
    text, spk = np.asarray(text), np.asarray(spk, np.float32)
    B, N = text.shape
    att = np.zeros((B, N, n_frames), np.float32)
    for b in range(B):
        rng = np.random.default_rng(int(text[b].sum()) + int(1e3 * abs(spk[b, :4]).sum()))
        rate = rng.uniform(0.1, 0.5)
        pos = np.minimum(N - 1, (np.arange(n_frames) * rate).astype(int))
        att[b, pos, np.arange(n_frames)] = 1.0
    return att


def test_spec_rate_diag_matches_the_jax_script(tree, jax_scripts, monkeypatch, tmp_path):
    from spoofsv_tpu.infer import synthesize as jsynthesize
    from spoofsv_torch.infer import synthesize as synthesize

    seen = {"jax": [], "port": []}

    def fake(side, wrap):
        class FakeSynthesizer:
            def __init__(self, cfg, *models, n_frames=None, **kw):
                self.n_frames = n_frames

            def __call__(self, text, spk, key):
                seen[side].append((np.asarray(text).copy(), np.asarray(spk).copy()))
                return None, None, wrap(scripted_attention(text, spk, self.n_frames))

            device_call = __call__   # the port's sweep reads the attention on the device
        return FakeSynthesizer

    monkeypatch.setattr(jsynthesize, "Synthesizer", fake("jax", jnp.asarray))
    monkeypatch.setattr(synthesize, "Synthesizer", fake("port", torch.from_numpy))
    out_j, out_p = tmp_path / "jax.json", tmp_path / "port.json"
    argv = ["--config", str(tree / "config.json"), "--batch", "4", "--n_frames", "160"]
    J = jax_scripts("spec_rate_diag", [*argv, "--out", str(out_j)])
    with contextlib.redirect_stdout(io.StringIO()):
        J.main()
        got = spec_rate_diag.main([*argv, "--out", str(out_p)], device="cpu")
    want = json.loads(out_j.read_text())
    assert json.loads(out_p.read_text()) == json.loads(json.dumps(got))
    assert want["detail"].pop("backend") == "cpu" and got["detail"].pop("backend") == "cpu"
    assert json.dumps(got) == json.dumps(want)
    assert got["detail"]["n_pairs"] == 3 * 2 and len(seen["port"]) == len(seen["jax"]) == 2
    assert 0.0 < got["detail"]["implied_escalation_rate_armC"] < 1.0, got
    for (tp, sp), (tj, sj) in zip(seen["port"], seen["jax"]):
        assert np.array_equal(tp, tj) and np.array_equal(sp, sj)


def test_spec_rate_diag_real_run_has_the_jax_keys(tree, jax_scripts, monkeypatch, tmp_path):
    """The port's sweep on the tree's seed-0 models against the keys of the
    JAX script's output under scripted attention."""
    from spoofsv_tpu.infer import synthesize as jsynthesize

    class Scripted:
        def __init__(self, cfg, *models, n_frames=None, **kw):
            self.n_frames = n_frames

        def __call__(self, text, spk, key):
            return None, None, jnp.asarray(scripted_attention(text, spk, self.n_frames))

    monkeypatch.setattr(jsynthesize, "Synthesizer", Scripted)
    argv = ["--config", str(tree / "config.json"), "--batch", "4", "--n_frames", "40"]
    J = jax_scripts("spec_rate_diag", [*argv, "--out", str(tmp_path / "jax.json")])
    with contextlib.redirect_stdout(io.StringIO()):
        J.main()
        got = spec_rate_diag.main(argv, device="cpu")
    want = json.loads((tmp_path / "jax.json").read_text())

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    assert keys(json.loads(json.dumps(got))) == keys(want)
    assert got["detail"]["n_pairs"] == 6 and np.isfinite(got["value"])


# -- the card ----------------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("entry,argv", [
    (gl_init_check, ["1"]), (gl_mcd_ab, []), (exp_gl_init, []),
    (spec_rate_diag, ["--config", "config.json"]), (gl_spsi_check, []), (gl24_check, []),
    (ivector_delta_rescore, []), (vad_ab, [])],
    ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__") else "")
def test_entry_points_ask_for_the_card(tmp_path, entry, argv):
    if "--root" not in argv and entry is not spec_rate_diag and entry is not exp_gl_init:
        argv = [*argv, "--root", str(tmp_path)]
    with pytest.raises(RuntimeError, match="cuda"):
        entry.main(argv)
    assert list(tmp_path.iterdir()) == []
