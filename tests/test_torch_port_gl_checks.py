"""The port's GL post-campaign checks against the JAX scripts, on the CPU.

A tiny campaign tree is built here (a 2-speaker toy corpus, its splits,
seed-0 Text2Mel and SSRN at hidden 32 saved as reference ``.tar.pth`` files,
which the JAX package reads through its torch bridge, ``config.json``). The
JAX scripts are imported from ``scripts/`` with ``_benchlib`` replaced (no
compile-cache setup; ``find_campaign_ckpt`` resolves the ``.tar.pth`` files
through ``cli/campaign.py::resolve_checkpoint``) and their ``OUT`` under the
test's directory, so nothing writes under ``docs/``. Both sides take the
plain routes in f32: the JAX scripts' bf16 models are built in f32 and their
fused decode is the scan decoder (the port's CPU route is
``decode_plain``'s arithmetic in f32). Tolerances:

* ``checklib`` against ``parity_tpu.py`` / ``exp_gl_init.py``: the
  distributions bit-equal, the spectral convergence within 1e-5 on the same
  audio (the port's FFT STFT against the scripts' matmul and FFT STFTs),
  ``_campaign_setup``'s ids and embeddings equal;
* ``gl_init_check``: the trained magnitudes within 1e-4 relative L2; every
  combo but random@64 within 1e-4 of the JAX script's spectral convergence
  from the same magnitudes (random@64's init is the documented difference:
  the hash init against jax's PRNG); the tensor-core candidates against the
  JAX fused kernel in interpret mode within 0.02
  (``tests/test_torch_port_gl_tc.py``'s bound);
* ``gl_mcd_ab``: the same audio gives the same MCD within 1e-4 dB; a tiny
  whole run gives the JAX summary's keys, the deterministic candidates
  within 0.05 dB;
* ``exp_gl_init`` at B=1, T=24: the JAX keys, every entry but random@64
  within 1e-4.
"""

import builtins
import importlib.util
import json
import os
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spoofsv_torch.cli import (campaign, checklib, exp_gl_init, gl_init_check, gl_mcd_ab)
from spoofsv_torch.config import Config
from spoofsv_torch.data.toy import generate_toy_corpus
from spoofsv_torch.data.vctk import prepare_vctk
from spoofsv_torch.models import SSRN, MelSyn

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
WIDTHS = dict(hidden_dim=32, text_emb_dim=16, ssrn_dim=32, max_frame_num=12, batch_size=4)
NFFT, HOP = 1024, 256
CPU = torch.device("cpu")


def build_tree(root: Path) -> Config:
    """A campaign root after its ``synthesize`` stage, at tiny widths."""
    data, spk = str(root / "corpus"), str(root / "spk_emb")
    generate_toy_corpus(data, spk, n_speakers=2, utts_per_spk=6, seed=0, min_chars=6,
                        max_chars=10)
    cfg = Config().replace(data_root_dir=data, spk_emb_dir=spk, src_root_dir=str(root) + "/",
                           **WIDTHS)
    prepare_vctk(cfg, verbose=False)
    torch.manual_seed(0)
    models = {"text2mel": MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                                 cfg.mel.freq_bins, cfg.hidden_dim),
              "ssrn": SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim)}
    ck = root / "checkpoints" / "conditional" / "not_adversarial" / campaign.BASE_TAG
    ck.mkdir(parents=True)
    for name, m in models.items():
        torch.save({"model_state_dict": m.state_dict()}, ck / f"{name}_best_model.tar.pth")
    cfg = cfg.replace(inference_text2mel_model=str(ck / "text2mel_best_model.tar.pth"),
                      inference_ssrn_model=str(ck / "ssrn_best_model.tar.pth"))
    (root / "config.json").write_text(json.dumps(cfg.to_reference_dict(), indent=2))
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("checks") / "campaign"
    build_tree(root)
    return root


@pytest.fixture
def jax_scripts(monkeypatch, tmp_path, tree):
    """``load(name)`` imports ``scripts/<name>.py`` as its own module, with
    ``_benchlib`` replaced and ``OUT`` under ``tmp_path``; the JAX models in
    f32 and the scan decoder (not unrolled: it compiles faster, and
    computes the same) in the fused decoder's place; the campaign
    root in ``$SPOOFSV_CAMPAIGN_ROOT``. The scripts' own modules are dropped
    again afterwards."""
    from jax._src import xla_bridge
    from spoofsv_tpu import models as jmodels
    from spoofsv_tpu.infer import decode as jdecode
    from spoofsv_tpu.infer import synthesize as jsynthesize
    from spoofsv_tpu.ops import pallas_decode
    from spoofsv_tpu.utils import checkpoints as jck

    before = set(sys.modules)
    bench = types.ModuleType("_benchlib")
    bench.setup_cache = lambda: None
    bench.find_campaign_ckpt = lambda root, prefix, adversarial=False: campaign.resolve_checkpoint(
        root, campaign.BASE_TAG_ADV if adversarial else campaign.BASE_TAG, prefix, adversarial)
    for name in ("_benchlib", "scripts._benchlib"):
        monkeypatch.setitem(sys.modules, name, bench)
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.syspath_prepend(str(REPO))
    monkeypatch.setenv("SPOOFSV_CAMPAIGN_ROOT", str(tree))
    # exp_gl_init.py re-pins the CPU at import and would drop the live backends
    monkeypatch.setattr(xla_bridge, "_clear_backends", lambda: None)
    for cls in ("MelSyn", "SSRN"):
        orig = getattr(jmodels, cls)
        monkeypatch.setattr(jmodels, cls, lambda *a, _c=orig, **kw: _c(*a, **{**kw,
                                                                         "dtype": jnp.float32}))
    scan = lambda model, n_frames, **kw: jdecode.make_decoder(model, n_frames,   # noqa: E731
                                                               unroll=1)
    monkeypatch.setattr(pallas_decode, "make_fused_decoder", scan)
    monkeypatch.setattr(jsynthesize, "make_decoder", scan)
    load_params = jck.load_generator_params
    # gl_init_check.py loads the SSRN without kind="ssrn", which only an
    # orbax checkpoint forgives
    monkeypatch.setattr(jck, "load_generator_params", lambda path, model, cfg, kind="text2mel":
                        load_params(path, model, cfg,
                                    "ssrn" if os.path.basename(path).startswith("ssrn") else kind))

    def load(name):
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if hasattr(mod, "OUT"):
            mod.OUT = str(tmp_path / f"jax_{name}.json")
        return mod

    yield load
    for name in set(sys.modules) - before:     # the scripts' modules, not the packages'
        if str(getattr(sys.modules[name], "__file__", "") or "").startswith(str(SCRIPTS)):
            del sys.modules[name]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- checklib -----------------------------------------------------------------

@pytest.mark.parametrize("script", ["parity_tpu", "exp_gl_init"])
def test_distributions_and_spectral_convergence_match(jax_scripts, script):
    mod = jax_scripts(script)
    got = checklib.mag_distributions(2, 16, 33, np.random.default_rng(0))
    want = mod.mag_distributions(2, 16, 33, np.random.default_rng(0))
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    rng = np.random.default_rng(3)
    audio = rng.normal(size=(2, HOP * 19)).astype(np.float32)
    mag = np.abs(rng.normal(size=(2, 20, NFFT // 2 + 1))).astype(np.float32)
    if script == "parity_tpu":
        port = checklib.spectral_convergence(audio, mag, NFFT, HOP)
        ref = mod.spectral_convergence(jnp.asarray(audio), jnp.asarray(mag), NFFT, HOP)
    else:
        port = checklib.spectral_convergence(audio, mag, NFFT, HOP)
        ref = mod.spectral_convergence(jnp.asarray(audio), jnp.asarray(mag))
    assert abs(port - ref) <= 1e-5, (port, ref)


def test_campaign_setup_matches(jax_scripts, tree):
    PT = jax_scripts("parity_tpu")
    jcfg, jdists, jspk, _ = PT._campaign_setup(2)
    cfg, dists, spk = checklib.campaign_setup(2, str(tree))
    assert cfg.to_reference_dict() == jcfg.to_reference_dict()
    assert list(dists) == list(jdists)
    for k in dists:
        assert np.array_equal(dists[k], np.asarray(jdists[k])), k
    assert np.array_equal(spk, np.asarray(jspk))


# -- gl_init_check ----------------------------------------------------------

@pytest.fixture(scope="module")
def port_mags(tree):
    return gl_init_check.trained_mags(2, CPU, str(tree))[1]


def test_trained_mags_match(jax_scripts, port_mags):
    J = jax_scripts("gl_init_check")
    _, jmags = J.trained_mags(2)
    assert list(port_mags) == list(jmags)
    for k, m in port_mags.items():
        assert m.shape == jmags[k].shape == (2, 4 * WIDTHS["max_frame_num"], NFFT // 2 + 1)
        assert _rel(m.numpy(), jmags[k]) <= 1e-4, k


def test_gl_init_check_matches_the_jax_script(jax_scripts, monkeypatch, tree, port_mags):
    """Both scripts' ``main`` on the same magnitudes (one distribution, B=1,
    its first 24 frames)."""
    J = jax_scripts("gl_init_check")
    mags = {"short_sentences": port_mags["short_sentences"][:1, :24].contiguous()}
    monkeypatch.setattr(J, "trained_mags", lambda B: (J.PT._campaign_setup(B)[0],
                                                      {k: v.numpy() for k, v in mags.items()}))
    monkeypatch.setattr(gl_init_check, "trained_mags",
                        lambda B, device, root: (checklib.campaign_setup(B, root)[0], mags))
    monkeypatch.setattr(sys, "argv", ["gl_init_check.py", "1"])
    J.main()
    with open(J.OUT) as f:
        want = json.load(f)
    state = tree / "state" / gl_init_check.OUT_NAME
    state.parent.mkdir(exist_ok=True)
    state.write_text(json.dumps({"mcd_ab": {"kept": 1}}))
    got = gl_init_check.main(["1", "--root", str(tree)], device="cpu")
    assert json.loads(state.read_text()) == {"mcd_ab": {"kept": 1}, **got}
    assert sorted(got) == sorted(want) and got["batch"] == want["batch"] == 1
    assert list(got["combos"]) == list(want["combos"])
    assert list(got["fused_candidate"]) == list(want["fused_candidate"])
    for key, by_dist in got["combos"].items():
        for d, sc in by_dist.items():
            assert np.isfinite(sc) and 0.0 < sc < 2.0, (key, d, sc)
            if key != "random@64":
                assert abs(sc - want["combos"][key][d]) <= 1e-4, (key, d, sc, want["combos"][key])
    for key, by_dist in got["fused_candidate"].items():
        for d, sc in by_dist.items():
            assert abs(sc - want["fused_candidate"][key][d]) <= 0.02, (key, sc)


# -- gl_mcd_ab --------------------------------------------------------------

def test_mcd_of_the_same_audio_matches(tree):
    from spoofsv_tpu.dsp import host as jhost
    from spoofsv_tpu.spoofkit.mcd import batch_mcd as jbatch_mcd
    from spoofsv_torch.spoofkit.mcd import batch_mcd

    cfg = checklib.campaign_setup(1, str(tree))[0]
    rng = np.random.default_rng(5)
    t = np.arange(22050) / 22050.0
    audio = [0.3 * np.sin(2 * np.pi * (180 + 40 * b) * t * (1 + 0.2 * t))
             + 0.02 * rng.normal(size=t.size) for b in range(2)]
    mel_gt = np.stack([jhost.tts_features(a.astype(np.float32) * 0.9, cfg.sampling_rate, cfg)[0]
                       for a in audio])
    lengths = np.array([mel_gt.shape[1], mel_gt.shape[1] - 3])
    mels = [gl_mcd_ab.audio_to_mel(a, cfg) for a in audio]
    jmels = [jhost.tts_features(np.asarray(a, np.float32), cfg.sampling_rate, cfg)[0]
             for a in audio]
    got = batch_mcd(mel_gt, mels, lengths, analysis_power=cfg.norm.analysis_power)
    want = jbatch_mcd(mel_gt, jmels, lengths, analysis_power=cfg.norm.analysis_power)
    assert np.isfinite(got) and abs(got - want) <= 1e-4, (got, want)


def test_gl_mcd_ab_whole_run_matches(jax_scripts, monkeypatch, tree):
    J = jax_scripts("gl_mcd_ab")
    flags = ["--root", str(tree), "--batches", "1", "--batch_size", "2"]
    monkeypatch.setattr(sys, "argv", ["gl_mcd_ab.py", *flags])
    J.main()
    with open(J.OUT) as f:
        want = json.load(f)["mcd_ab"]
    got = gl_mcd_ab.main(flags, device="cpu")
    with open(tree / "state" / "GL_SPSI_CHECK.json") as f:
        assert json.load(f)["mcd_ab"] == got
    assert sorted(got) == sorted(want)
    assert (got["batches"], got["batch_size"]) == (want["batches"], want["batch_size"]) == (1, 2)
    res, ref = got["results_db"], want["results_db"]
    assert list(res) == list(ref) == [f"{i}@{n}" for i, n in gl_mcd_ab.CANDIDATES]
    for name, legs in res.items():
        assert list(legs) == list(ref[name]) == ["copy_synthesis", "tts"]
        for leg, v in legs.items():
            assert np.isfinite(v) and v > 0, (name, leg, v)
            if not name.startswith("random"):
                assert abs(v - ref[name][leg]) <= 0.05, (name, leg, v, ref[name][leg])


def test_reference_mode_takes_the_f32_route(tree):
    from spoofsv_torch.infer.synthesize import gl_route

    cfg = checklib.campaign_setup(1, str(tree))[0]
    for init, iters in gl_mcd_ab.CANDIDATES:
        c = gl_mcd_ab.candidate_config(cfg, init, iters)
        assert (c.tpu.griffin_lim_init, c.tpu.griffin_lim_iters) == (init, iters)
        want = "f32" if init == "random" else "tc"
        assert gl_route(c, "cuda") == want and gl_route(c, "cpu") == "xla"


# -- exp_gl_init ------------------------------------------------------------

def test_exp_gl_init_matches_the_jax_script(jax_scripts, monkeypatch, tmp_path):
    """The real-audio magnitudes within 1e-5; then both ``main``s with their
    distributions cut to B=1, T=24, the real-audio one the JAX script's on
    both sides (SPSI's peak picking flips on such differences)."""
    J = jax_scripts("exp_gl_init")
    dists = J.mag_distributions
    real = np.asarray(J.real_audio_mags(1, 24, np.random.default_rng(1)), np.float32)
    assert _rel(exp_gl_init.real_audio_mags(1, 24, np.random.default_rng(1)), real) <= 1e-5
    monkeypatch.setattr(J, "mag_distributions", lambda B, T, F, rng: dists(1, 24, F, rng))
    monkeypatch.setattr(J, "real_audio_mags", lambda B, T, rng: real)
    jax_out = tmp_path / "jax_exp_gl_init.json"
    monkeypatch.setattr(J, "open", lambda path, *a, **kw: builtins.open(
        jax_out if path == "/tmp/exp_gl_init.json" else path, *a, **kw), raising=False)
    J.main()
    want = json.loads(jax_out.read_text())

    monkeypatch.setattr(checklib, "mag_distributions",
                        lambda B, T, F, rng: dists(1, 24, F, rng))
    monkeypatch.setattr(exp_gl_init, "real_audio_mags", lambda B, T, rng: real)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = exp_gl_init.main([], device="cpu")
    assert json.loads((tmp_path / "exp_gl_init.json").read_text()) == got
    assert list(got) == list(want) == ["speech_like", "white", "harmonic", "real_audio"]
    for d, by_key in got.items():
        assert list(by_key) == list(want[d])
        for key, sc in by_key.items():
            assert np.isfinite(sc), (d, key)
            if key != "random@64":
                assert abs(sc - want[d][key]) <= 1e-4, (d, key, sc, want[d][key])
