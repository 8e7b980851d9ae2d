"""The port's campaign and toy learning run against the JAX scripts, on the CPU.

``scripts/campaign.py`` runs in a subprocess (``JAX_PLATFORMS=cpu``) and
``spoofsv_torch.cli.campaign.main(..., device="cpu")`` in this process, at a
tiny depth and width (6 speakers x 8 utterances, 3 train speakers, hidden 32,
2 steps a trainer, a one-layer GE2E, 8 Gaussians / 8 dims, ``--skip
ivector_ref``), each on the same root path in turn:

* the ``corpus`` and ``prepare`` trees are byte-equal (wavs, ``.npy``
  embeddings, ``texts.txt``, ``config.json``, the protocols, the bona fide
  FLACs, the feature cache), except the copy-synthesised FLACs, whose phase
  init is the documented difference (the hash "random" init against jax's
  PRNG). Both runs cut that Griffin-Lim to one iteration here (its output is
  not compared); the copy-synthesis is held on its own at 64 iterations,
  from the same angles as ``jaxdsp.griffin_lim``, within 1e-3 relative L2
  (the bound of ``tests/test_torch_port_gl.py``);
* the port's tiny campaign runs every other stage end to end; its report,
  its control flow under ``--only``, ``--skip``, ``--force``, resume and
  ``--split_suffix``, and its flags are the JAX script's.

The stages' own code is held to the JAX script's on a copy of that tree:
with the entry points each stage calls (the CLIs, the GE2E harness, the
i-vector pipeline) replaced by recorders, both campaigns make the same calls
with the same arguments and configurations, and turn the same files (the CM
scores, the spoof wavs, the synthesize CLI's lines) into the same results.

``train_toy_e2e`` runs a few steps: the JAX script's summary keys, finite
values. Then both toy scripts run with a recording trainer and decoder that
return scripted losses and attention: the same batches from
``BucketedLoader(seed=0)``, the same decoder inputs and the same summary.
"""

import ast
import contextlib
import dataclasses
import io
import shutil
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.dsp import jaxdsp
from spoofsv_torch.cli import campaign, train_toy_e2e
from spoofsv_torch.config import Config
from spoofsv_torch.data.toy import random_sentence, synth_sentence
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.ops import gl_kernel

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

REPO = Path(__file__).resolve().parent.parent
JAX_CAMPAIGN = REPO / "scripts" / "campaign.py"

TINY = ["--speakers", "6", "--utts", "8", "--train_spk", "3", "--eval_num", "4",
        "--hidden_dim", "32", "--batch_size", "8", "--val_every_iter", "2"]
DEPTH = ["--t2m_steps", "2", "--ssrn_steps", "2", "--adv_steps", "2", "--ge2e_epochs", "2",
         "--ge2e_n", "3", "--ge2e_m", "4", "--ge2e_hidden", "32", "--ge2e_layers", "1",
         "--ge2e_proj", "16", "--ivec_gauss", "8", "--ivec_dim", "8", "--cm_steps", "2",
         "--cm_cap", "8", "--skip", "ivector_ref"]
# the JAX script under a one-iteration copy-synthesis (its FLACs are not compared)
JAX_RUNNER = """
import runpy, sys
from spoofsv_tpu.dsp import jaxdsp
_gl = jaxdsp.griffin_lim
def _gl1(*a, **kw):
    kw["n_iter"] = 1
    return _gl(*a, **kw)
jaxdsp.griffin_lim = _gl1
sys.argv = [sys.argv[1]] + sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
COPY_FLAC = re.compile(r"antispoof/ASVspoof2019_LA_train/flac/LA_T_COPY\d+\.flac$")
STAGE_LINE = re.compile(r"^\[campaign\] (\S+): (skipped.*|already done|start|done)")


def _jax(argv, home) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO), "HOME": str(home)}
    out = subprocess.run([sys.executable, "-c", JAX_RUNNER, str(JAX_CAMPAIGN), *argv],
                         capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _port(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = campaign.main(argv, device="cpu")
    return buf.getvalue(), results


def _stage_lines(text: str) -> list:
    return [m.groups() for m in map(STAGE_LINE.match, text.splitlines()) if m]


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _jax_ast():
    return ast.parse(JAX_CAMPAIGN.read_text())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX script's ``corpus`` and ``prepare`` at ``<tmp>/run``, moved to
    ``<tmp>/jax``; then the port's at ``<tmp>/run`` (both trees recorded),
    and the port's whole tiny campaign on from there."""
    tmp = tmp_path_factory.mktemp("campaign")
    root = tmp / "run"
    for stage in ("corpus", "prepare"):
        _jax([*TINY, "--root", str(root), "--only", stage], tmp)
    os.rename(root, tmp / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(campaign, "COPY_GL_ITERS", 1)
        for stage in ("corpus", "prepare"):
            _port([*TINY, "--root", str(root), "--only", stage])
    trees = {"jax": _tree(tmp / "jax"), "port": _tree(root)}
    log, results = _port([*TINY, *DEPTH, "--root", str(root)])
    return dict(tmp=tmp, root=root, trees=trees, log=log, results=results)


def test_corpus_and_prepare_trees_are_byte_equal(run):
    jax_tree, port_tree = run["trees"]["jax"], run["trees"]["port"]
    assert sorted(jax_tree) == sorted(port_tree)
    copies = [p for p in jax_tree if COPY_FLAC.search(p)]
    assert len(copies) == campaign.LA_SPEAKERS * campaign.LA_COPY
    compared = [p for p in jax_tree if p not in copies and not p.startswith("state/")]
    for kind in ("corpus/wav48/", "corpus/wav22/", "corpus/data_path/", "spk_emb/", "spec/",
                 "antispoof/ASVspoof2019_LA_dev/flac/", "antispoof/ASVspoof2019_LA_cm_protocols/",
                 "texts.txt", "config.json"):
        assert any(p.startswith(kind) for p in compared), kind
    differ = [p for p in compared if jax_tree[p] != port_tree[p]]
    assert not differ, differ[:10]
    for stage in ("corpus", "prepare"):
        j, p = (json.loads(t[f"state/{stage}.json"]) for t in (jax_tree, port_tree))
        j.pop("_wall_s"), p.pop("_wall_s")
        assert j == p


def test_copy_synthesis_matches_jaxdsp_from_the_same_angles():
    cfg = Config()
    rng = np.random.default_rng(4242)
    waves = [synth_sentence(random_sentence(rng, 18, 36), 22050, 1.0, rng) for _ in range(3)]
    n_fft, hop = cfg.stft.fft_length, cfg.stft.hop_length
    mags = [dsp_host.stft_mag(dsp_host.preemphasis(y, cfg.preemph), n_fft, hop).T
            for y in waves]
    batch = np.zeros((3, max(m.shape[0] for m in mags), n_fft // 2 + 1), np.float32)
    for i, m in enumerate(mags):
        batch[i, : m.shape[0]] = m
    init = gl_kernel.hash_phase_init(torch.tensor([3, 77, 2024]), *batch.shape[1:])
    got = campaign.copy_synthesize(waves, cfg, "cpu", init_angles=init)
    audio = jaxdsp.griffin_lim(jnp.asarray(batch), jax.random.PRNGKey(0), n_fft, hop, n_fft,
                               n_iter=64, use_matmul=False,
                               init_angles=tuple(jnp.asarray(a.numpy()) for a in init))
    audio = np.asarray(jaxdsp.deemphasis(audio, cfg.preemph))
    for k, y in enumerate(waves):
        w = audio[k][: len(y)]
        ref = 0.75 * w / max(1e-6, np.abs(w).max())
        assert got[k].shape == ref.shape
        assert np.linalg.norm(got[k] - ref) / np.linalg.norm(ref) <= 1e-3


def test_the_tiny_campaign_runs_every_stage(run):
    root, results = run["root"], run["results"]
    ran = [name for name, what in _stage_lines(run["log"]) if what == "start"]
    assert ran == [s for s in campaign.REPORT_STAGES + ("report",)
                   if s not in ("corpus", "prepare", "ivector_ref")]
    for name in campaign.REPORT_STAGES + ("report",):
        marker = root / "state" / f"{name}.json"
        assert marker.exists() == (name != "ivector_ref"), name
        if name != "ivector_ref":
            assert "_wall_s" in results[name] and json.loads(marker.read_text()) == results[name]
    report = json.loads((root / "RESULTS.json").read_text())
    assert list(report) == [s for s in _jax_report_stages() if s != "ivector_ref"]
    for chain in ("", "_adv"):
        ge2e, ivec, cm = (results[s + chain] for s in ("ge2e", "ivector", "cm"))
        for v in (ge2e["EER"], ge2e["spoof_rate"], ge2e["gt_FRR"], ivec["mixed_eer"],
                  ivec["spoof_rate"], cm["cm_eer"]):
            assert np.isfinite(v) and 0.0 <= v <= 1.0
        assert cm["n_bonafide"] > 0 and cm["n_spoof"] > 0
        assert results["spoofgen" + chain]["spoof_wavs"] == 6 * 4   # every speaker x eval_num
        png = results["curve" + chain]["curve"]
        assert os.path.exists(png) if png else "PNG skipped" in run["log"]
        points = json.loads(Path(results["curve" + chain]["points"]).read_text())
        assert {k: len(v["frr"]) for k, v in points.items()} == {"ge2e": 5000, "ivector": 8000}
    assert results["synthesize"]["n_batches"] > 0
    assert np.isfinite(results["synthesize"]["mcd_db"])
    conf = json.loads((root / "config.json").read_text())
    assert conf["INFERENCE_TEXT2MEL_MODEL"] == campaign.resolve_checkpoint(
        str(root), "campaign", "text2mel")
    adv = json.loads((root / "config_adv.json").read_text())
    assert adv["INFERENCE_TEXT2MEL_MODEL"].endswith(
        "adversarial/campaign_adv/text2mel_best_model.tar.pth")
    assert adv["INFERENCE_SSRN_MODEL"] == conf["INFERENCE_SSRN_MODEL"]


def _jax_report_stages() -> tuple:
    fn = next(n for n in ast.walk(_jax_ast())
              if isinstance(n, ast.FunctionDef) and n.name == "stage_report")
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For))
    return ast.literal_eval(loop.iter)


def test_stage_lists_and_flags_are_the_jax_scripts():
    tree = _jax_ast()
    split = next(n for n in tree.body if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "SPLIT_STAGES")
    assert campaign.SPLIT_STAGES == ast.literal_eval(split.value)
    assert campaign.REPORT_STAGES == _jax_report_stages()
    flags = {}
    for call in ast.walk(tree):
        if (isinstance(call, ast.Call) and getattr(call.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in call.keywords}
            flags[call.args[0].value] = (
                None if call.args[0].value == "--root" else ast.literal_eval(kw["default"]),
                getattr(kw.get("type"), "id", None), getattr(kw.get("action"), "value", None))
    ours = {a.option_strings[0]: (None if a.dest == "root" else a.default,
                                  getattr(a.type, "__name__", None),
                                  "append" if type(a).__name__ == "_AppendAction" else None)
            for a in campaign.build_parser()._actions if a.option_strings[0] != "-h"}
    assert ours == flags
    assert campaign.build_parser().parse_args([]).root == str(REPO / "_campaign")


@pytest.mark.parametrize("argv", [
    ["--force", "report"],                                  # resume: only report re-runs
    ["--only", "report", "--force", "report"],
    ["--skip", "report", "--force", "report"],              # nothing runs
    ["--split_suffix", "_s4", "--train_spk", "4", "--only", "report", "--force", "report"],
], ids=["resume", "only", "skip", "split"])
def test_control_flow_and_report_match_the_jax_script(run, argv):
    """The same stage decisions (skipped / already done / run) in the same
    order under the JAX script and the port on the port's finished tree,
    and the same ``RESULTS{suffix}.json`` bytes from either's report."""
    root = run["root"]
    full = [*TINY, *DEPTH, "--root", str(root), *argv]
    results = root / ("RESULTS_s4.json" if "--split_suffix" in argv else "RESULTS.json")
    before = {p.name: p.stat().st_mtime_ns for p in (root / "state").iterdir()}
    log, _ = _port(full)
    port_results = results.read_bytes() if results.exists() else None
    after = {p.name: p.stat().st_mtime_ns for p in (root / "state").iterdir()}
    rerun = sorted(k for k in after if before.get(k) != after[k])
    jlog = _jax(full, run["tmp"])
    assert _stage_lines(log) == _stage_lines(jlog)
    if "--skip" in argv:
        assert rerun == []
    else:
        assert rerun == ["report_s4.json" if "--split_suffix" in argv else "report.json"]
        assert results.read_bytes() == port_results


def test_split_suffix_needs_the_base_stages(tmp_path):
    with pytest.raises(RuntimeError, match="needs the base campaign stage 'corpus'"):
        campaign.main(["--root", str(tmp_path), "--split_suffix", "_s2"], device="cpu")


def test_resolver_prefers_the_best_model_then_the_last_iteration(tmp_path):
    base = tmp_path / "checkpoints" / "conditional" / "not_adversarial" / "run1"
    with pytest.raises(FileNotFoundError):
        campaign.resolve_checkpoint(str(tmp_path), "run1", "text2mel")
    base.mkdir(parents=True)
    for name in ("text2mel_iteration_9.tar.pth", "text2mel_iteration_10.tar.pth",
                 "ssrn_iteration_40.tar.pth", "text2mel_iteration_10.tar.pth.123.tmp"):
        (base / name).write_bytes(b"")
    assert campaign.resolve_checkpoint(str(tmp_path), "run1", "text2mel") == str(
        base / "text2mel_iteration_10.tar.pth")
    (base / "text2mel_best_model.tar.pth").write_bytes(b"")
    assert campaign.resolve_checkpoint(str(tmp_path), "run1", "text2mel") == str(
        base / "text2mel_best_model.tar.pth")
    assert campaign.resolve_checkpoint(str(tmp_path), "run1", "ssrn").endswith("_40.tar.pth")
    with pytest.raises(FileNotFoundError):
        campaign.resolve_checkpoint(str(tmp_path), "run1", "text2mel", adversarial=True)


def _jax_summary_keys() -> list:
    tree = ast.parse((REPO / "scripts" / "train_toy_e2e.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "summary")
    return [k.value for k in node.value.keys]


@pytest.mark.parametrize("adversarial", [False, True], ids=["ordinary", "wgan_gp"])
def test_toy_e2e_summary_has_the_jax_keys(tmp_path, monkeypatch, adversarial):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = train_toy_e2e.main(["7"] + (["--adversarial"] if adversarial else []),
                                     device="cpu")
    assert list(summary) == _jax_summary_keys()
    assert json.loads(buf.getvalue()[buf.getvalue().index("{"):]) == summary
    assert summary["steps"] == 7 and summary["adversarial"] is adversarial
    for k in ("loss_first", "loss_last", "forward_frac", "coverage", "confidence",
              "sec_per_iter"):
        assert np.isfinite(summary[k]), k
    assert 0.0 <= summary["forward_frac"] <= 1.0
    assert len(summary["wd_tail"]) == (5 if adversarial else 0)
    assert all(np.isfinite(v) for v in summary["wd_tail"])


# The entry points every stage calls, replaced by recorders: the same source
# runs in the JAX script's process (``mods`` from spoofsv_tpu) and in this one
# (from spoofsv_torch). ``run_ge2e_evaluation`` and ``run_ivector_pipeline``
# return scripted results; the synthesize CLI prints two batches' lines.
STUBS = r"""
import dataclasses
import numpy as np

SYN_LINES = ("syn set text2mel loss: 0.5 0.25 0.125 0.875\nsyn set ssrn loss: 0.25 0.5 0.75\n"
             "syn set mcd: 7.125 dB\nsyn set text2mel loss: 0.5 0.25 0.125 0.625\n"
             "syn set ssrn loss: 0.25 0.5 1.0\nsyn set mcd: 9.5 dB\n")


def plain(o):
    if hasattr(o, "to_reference_dict"):
        return o.to_reference_dict()
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    if isinstance(o, np.generic):
        return o.item()
    return str(o)


def stubs(mods, calls):
    def rec(name, result=None):
        def fn(*args, **kw):
            calls.append([name, list(args), kw])
            if name == "cli.main" and args[0][0] == "synthesize":
                print(SYN_LINES, end="")
            if name == "cli.curve":
                return args[0][args[0].index("--out") + 1]
            return dict(result) if result is not None else None
        return fn
    return [(mods["cli_main"], "main", rec("cli.main")),
            (mods["gtu"], "main", rec("cli.generate_test_utterances")),
            (mods["antispoof"], "main", rec("cli.antispoof")),
            (mods["curve"], "main", rec("cli.curve")),
            (mods["gh"], "save_spectrogram_tisv", rec("ge2e.save_spectrogram_tisv")),
            (mods["gh"], "train_ge2e", rec("ge2e.train_ge2e")),
            (mods["gh"], "run_ge2e_evaluation",
             rec("ge2e.run_ge2e_evaluation", dict(EER=0.25, spoof_rate=0.5, gt_FRR=0.125))),
            (mods["ivector"], "run_ivector_pipeline",
             rec("ivector.run_ivector_pipeline", dict(mixed_eer=0.375, spoof_rate=0.0625)))]
"""
TRAIN_STAGES = {"train_t2m": ("train_text2mel", "TAG", "t2m_steps", False),
                "train_ssrn": ("train_ssrn", "TAG", "ssrn_steps", False),
                "train_adv": ("train_text2mel", "TAG_ADV", "adv_steps", True)}
ATTACK = list(campaign.ATTACK_STAGES)
BASE = [s for s in campaign.REPORT_STAGES if s not in ("corpus", "prepare")]
# the JAX script's stage functions (its training stages are lambdas over
# ``_train`` inside ``main``) under the recorders, on ``--root``; its
# ``_ckpt`` looks for orbax directories, the port's checkpoints are files:
# ``resolve_checkpoint`` (held on its own below) stands in for it
JAX_STAGES = STUBS + r"""
import json, runpy, sys
from spoofsv_tpu.cli import antispoof, curve, generate_test_utterances as gtu, main as cli_main
from spoofsv_tpu.spoofkit import ge2e_harness as gh, ivector
from spoofsv_torch.cli.campaign import resolve_checkpoint

script, out_path, todo = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
mods = dict(cli_main=cli_main, gtu=gtu, antispoof=antispoof, curve=curve, gh=gh, ivector=ivector)
out = []
for argv, stages, train in todo:
    sys.argv = [script] + argv
    g = runpy.run_path(script, run_name="campaign_stages")["main"].__globals__   # not a copy
    g["_ckpt"] = lambda tag, prefix, adversarial=False: resolve_checkpoint(
        g["ROOT"], tag, prefix, adversarial)
    calls = []
    for mod, name, fn in stubs(mods, calls):
        setattr(mod, name, fn)
    got = {}
    for stage in stages:
        del calls[:]
        if stage in train:
            step, tag, steps, adv = train[stage]
            res = g["_train"](step, g[tag], getattr(g["ARGS"], steps), adv)
        else:
            res = g["stage_" + stage]()
        got[stage] = {"result": res, "calls": list(calls)}
    out.append(got)
with open(out_path, "w") as f:
    json.dump(out, f, default=plain)
"""


@pytest.fixture(scope="module")
def stage_tree(run):
    """A copy of the port's finished tree, with what the split ``_s4``'s
    scoring stages read made from the base's (the CM scores, the GE2E
    checkpoint and its marker, the similarity matrices)."""
    root = run["tmp"] / "stages"
    shutil.copytree(run["root"], root)
    for tag in ("", "_adv"):
        shutil.copy(root / "cm_scores" / f"scores_campaign{tag}.txt",
                    root / "cm_scores" / f"scores_campaign_s4{tag}.txt")
        shutil.copytree(root / f"simmat{tag}", root / f"simmat_s4{tag}")
    shutil.copytree(root / "ge2e_ck", root / "ge2e_ck_s4")
    ck = sorted((root / "ge2e_ck_s4").glob("final_*.npz"))[-1]
    (root / "state" / "ge2e_s4.json").write_text(json.dumps({"checkpoint": str(ck)}))
    return root


@pytest.mark.parametrize("split", [False, True], ids=["base", "split"])
def test_stages_call_the_entry_points_as_the_jax_script(stage_tree, monkeypatch, split):
    """Every stage after ``prepare``, the stage code alone: the same calls into
    the entry points (argv, GE2E configuration, i-vector arguments, the
    Config they are handed, as dicts), the same ``config.json`` /
    ``config_adv.json`` bytes, and the same results from the same files."""
    from spoofsv_torch.cli import antispoof, curve, generate_test_utterances as gtu
    from spoofsv_torch.cli import main as cli_main
    from spoofsv_torch.spoofkit import ge2e_harness as gh, ivector

    extra = ["--split_suffix", "_s4", "--train_spk", "4"] if split else []
    argv = [*TINY, *DEPTH, "--root", str(stage_tree), *extra]
    stages = ATTACK if split else BASE
    ns = {}
    exec(STUBS, ns)
    calls, port = [], {}
    mods = dict(cli_main=cli_main, gtu=gtu, antispoof=antispoof, curve=curve, gh=gh,
                ivector=ivector)
    for mod, name, fn in ns["stubs"](mods, calls):
        monkeypatch.setattr(mod, name, fn)
    c = campaign.Campaign(campaign.build_parser().parse_args(argv), torch.device("cpu"))
    buf = io.StringIO()
    for stage in stages:
        del calls[:]
        with contextlib.redirect_stdout(buf):
            res = getattr(c, "stage_" + stage)()
        for _, _, kw in calls:
            if "device" in kw:
                assert kw.pop("device") == c.device
        port[stage] = {"result": res, "calls": list(calls)}
    port = json.loads(json.dumps(port, default=ns["plain"]))
    configs = {p.name: p.read_bytes() for p in stage_tree.glob("config*.json")}

    out = stage_tree.parent / f"jax_stages_{split}.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "HOME": str(stage_tree.parent)}
    train = {k: list(v) for k, v in TRAIN_STAGES.items()}
    r = subprocess.run([sys.executable, "-c", JAX_STAGES, str(JAX_CAMPAIGN), str(out),
                        json.dumps([[argv, stages, train]])],
                       capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    jax_out = json.loads(out.read_text())[0]

    assert list(port) == list(jax_out) == stages
    for stage in stages:
        want = jax_out[stage]
        if stage.startswith("curve"):      # the port's curve also names its points file
            want["result"]["points"] = str(Path(want["result"]["curve"]).with_suffix(".json"))
        assert port[stage]["calls"] == want["calls"], stage
        assert port[stage]["result"] == want["result"], stage
        assert port[stage]["calls"], stage
    if not split:
        assert port["synthesize"]["result"] == {"n_batches": 2, "text2mel_loss": 0.75,
                                                "ssrn_loss": 0.875, "mcd_db": 8.3125}
        assert port["cm"]["result"]["n_bonafide"] > 0 and port["cm"]["result"]["n_spoof"] > 0
    assert {p.name: p.read_bytes() for p in stage_tree.glob("config*.json")} == configs


# A trainer and a decoder for both toy scripts: each batch recorded, losses
# and Wasserstein distances scripted (some iterations fetch no metrics), the
# attention a seeded function of the text batch.
TOY_FAKES = r"""
import numpy as np

seen = {"batches": [], "decodes": [], "trainer": []}


def host(v):
    return np.asarray(v.cpu() if hasattr(v, "cpu") else v)


class FakeTrainer:
    def __init__(self, cfg, model, train_kind, **kw):
        self.state, self.n = None, 0
        self.loss_logs = {"wd": [1.0 - 0.1 * k for k in range(9)]}
        seen["trainer"].append([train_kind, {k: v for k, v in kw.items()
                                             if k not in ("disc_model",)},
                                type(kw.get("disc_model")).__name__])

    def init(self, *a):
        self.state = "ready"

    def train_iteration(self, batch, *a):
        seen["batches"].append({k: host(v) for k, v in batch.items()})
        self.n += 1
        return {} if self.n % 4 == 2 else {"loss": 1.0 + 1.0 / self.n, "att": 0.125}

    def _gen_params(self):
        return None

    def close(self):
        pass


def attention(text, n_frames):
    text = host(text)
    rng = np.random.default_rng(int(text.sum()))
    a = rng.random((text.shape[0], text.shape[1], n_frames)).astype(np.float32) ** 4
    return a / a.sum(1, keepdims=True)


def fake_decoder(wrap):
    def make(model, n_frames):
        def run(*args):
            text, spk = args[-2:]
            seen["decodes"].append({"text": host(text), "spk": host(spk), "T": n_frames})
            return None, wrap(attention(text, n_frames)), None
        return run
    return make
"""
JAX_TOY = TOY_FAKES + r"""
import json, runpy, sys
from spoofsv_tpu.infer import decode
from spoofsv_tpu.train import loop

script, out_path = sys.argv[1], sys.argv[2]
loop.Trainer = FakeTrainer
decode.make_decoder = fake_decoder(lambda a: a)
sys.argv = [script] + sys.argv[3:]
runpy.run_path(script, run_name="__main__")
np.savez(out_path, **{f"b{i}_{k}": v for i, b in enumerate(seen["batches"]) for k, v in b.items()},
         **{f"d{i}_{k}": v for i, d in enumerate(seen["decodes"]) for k, v in d.items()})
print("TRAINER " + json.dumps(seen["trainer"]))
"""


@pytest.mark.parametrize("adversarial", [False, True], ids=["ordinary", "wgan_gp"])
def test_toy_e2e_batches_and_summary_match_the_jax_script(tmp_path, monkeypatch, adversarial):
    """Both scripts over 12 iterations (the toy train split's 9 batches, then
    a second epoch) with the same recording trainer and decoder: the same
    batches in the same order, the same validation batch decoded, the same
    trainer arguments and the same summary (loss window, per-row text and
    mel lengths into ``attention_monotonicity``, averages), but the time."""
    from spoofsv_torch import train as port_train
    from spoofsv_torch.infer import decode as port_decode
    from spoofsv_torch.ops import decode_kernel

    flags = ["12"] + (["--adversarial"] if adversarial else [])
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    out = tmp_path / "jax_toy.npz"
    r = subprocess.run([sys.executable, "-c", JAX_TOY, str(REPO / "scripts" / "train_toy_e2e.py"),
                        str(out), *flags], capture_output=True, text=True, env=env,
                       cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    jax_summary = json.loads(r.stdout[r.stdout.index("\n{") + 1:r.stdout.index("TRAINER ")])
    jax_trainer = json.loads(r.stdout.split("TRAINER ", 1)[1])
    jax_rec = np.load(out)

    ns = {}
    exec(TOY_FAKES, ns)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(port_train, "Trainer", ns["FakeTrainer"])
    make = ns["fake_decoder"](torch.from_numpy)
    monkeypatch.setattr(port_decode, "make_decoder", make)
    monkeypatch.setattr(decode_kernel, "make_fused_decoder", make)
    with contextlib.redirect_stdout(io.StringIO()):
        summary = train_toy_e2e.main(flags, device="cpu")
    seen = ns["seen"]

    assert len(seen["batches"]) == 12 and len(seen["decodes"]) == 1
    for i, batch in enumerate(seen["batches"]):
        assert sorted(batch) == sorted(k[len(f"b{i}_"):] for k in jax_rec.files
                                       if k.startswith(f"b{i}_"))
        for k, v in batch.items():
            assert np.array_equal(v, jax_rec[f"b{i}_{k}"]), (i, k)
    for k, v in seen["decodes"][0].items():
        assert np.array_equal(v, jax_rec[f"d0_{k}"]), k
    assert seen["trainer"] == jax_trainer
    assert summary.pop("sec_per_iter") > 0 and jax_summary.pop("sec_per_iter") > 0
    assert summary == jax_summary
    # the fetched losses: iterations 1, 3, 4, ... (every fourth from the 2nd fetches none)
    assert summary["loss_first"] == pytest.approx((2.0 + 4 / 3 + 5 / 4) / 3, abs=1e-12)
    assert summary["loss_last"] == pytest.approx((10 / 9 + 12 / 11 + 13 / 12) / 3, abs=1e-12)
    assert summary["wd_tail"] == [0.6, 0.5, 0.4, 0.3, 0.2]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_entry_points_ask_for_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        campaign.main(["--root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        train_toy_e2e.main(["1"])
    assert not (tmp_path / "state").exists()
