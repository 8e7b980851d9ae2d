"""The port's GE2E verifier against the JAX package's, on the CPU.

Same seeded numpy inputs and the same weights (flax parameters carried over
by ``export_ge2e_embedder``) on both sides, at a small width (hidden 32,
2 layers, projection 16, 40 mels, 24 frames), f32:

* the embedder within 1e-5; ``get_cossim`` (K = N and K != N), ``calc_loss``
  and ``GE2ELoss`` within 1e-6;
* 3 clipped SGD steps against ``make_ge2e_train_step`` (both groups'
  clips engage: gradient norms ~224 and ~1.4 at the first step): losses
  and parameters within 1e-5;
* TI-SV preprocessing, the reference's and the generic one (the same
  arrays), ``SpeakerBatcher``, ``DeviceSpeakerBank`` and
  ``OnTheFlySpeakerBatcher`` (the same batches), ``eer_sweep`` and
  ``spoof_rate_at_threshold`` (equal), checkpoints read both ways, and
  ``run_ge2e_evaluation`` on a small staged set, slice and staged
  formulations (every key within 1e-5);
* ``GE2EConfig.from_yaml`` against the JAX one (which uses PyYAML).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.config import GE2EConfig as JGE2EConfig
from spoofsv_tpu.models import ge2e as jge2e
from spoofsv_tpu.spoofkit import ge2e_harness as jh
from spoofsv_tpu.utils.torch_export import export_ge2e_embedder
from spoofsv_torch.cli import ge2e as cli_ge2e
from spoofsv_torch.config import GE2EConfig, parse_reference_yaml
from spoofsv_torch.dsp import host
from spoofsv_torch.models import ge2e
from spoofsv_torch.spoofkit import ge2e_harness as h
from spoofsv_torch.weights import (ge2e_flax_arrays, load_ge2e_params, load_state,
                                   save_ge2e_checkpoint)

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

HID, LAYERS, PROJ, MELS, FRAMES = 32, 2, 16, 40, 24


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def flax_params():
    emb = jge2e.SpeechEmbedder(hidden=HID, num_layers=LAYERS, proj=PROJ)
    return emb, emb.init(jax.random.PRNGKey(0), jnp.zeros((1, FRAMES, MELS)))


def _port_embedder(params) -> ge2e.SpeechEmbedder:
    return load_state(ge2e.SpeechEmbedder(MELS, HID, LAYERS, PROJ), export_ge2e_embedder(params))


def test_embedder_matches_flax(flax_params):
    jemb, params = flax_params
    x = np.random.default_rng(1).normal(size=(6, FRAMES, MELS)).astype(np.float32)
    want = np.asarray(jemb.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_embedder(params)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_init_draws_per_gate():
    """flax's per-gate xavier-normal: each gate block has variance
    2/(in+H) (not 2/(in+4H)); the projection lecun-normal; biases zero;
    the same generator seed gives the same weights."""
    a, b = (ge2e.SpeechEmbedder(40, 256, 2, 64, generator=torch.Generator().manual_seed(3))
            .requires_grad_(False) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    h = 256
    for name, p in a.LSTM_stack.named_parameters():
        if name.startswith("bias"):
            assert not p.any()
            continue
        for g in range(4):
            block = p[g * h:(g + 1) * h]
            want = (2.0 / (p.shape[1] + h)) ** 0.5
            assert abs(float(block.std()) / want - 1) < 0.05, (name, g)
            assert float(block.abs().max()) <= 2 * want / 0.8796 + 1e-6
    assert abs(float(a.projection.weight.std()) * 16 - 1) < 0.05   # sqrt(1/256)


@pytest.mark.parametrize("k", [4, 3, 6])
def test_cossim_loss_and_ge2e_loss(k):
    rng = np.random.default_rng(k)
    e = rng.normal(size=(4, 5, 8)).astype(np.float32)
    c = rng.normal(size=(k, 8)).astype(np.float32)
    got = ge2e.get_cossim(_t(e), _t(c)).numpy()
    want = np.asarray(jge2e.get_cossim(jnp.asarray(e), jnp.asarray(c)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ge2e.get_centroids(_t(e)).numpy(),
                               np.asarray(jge2e.get_centroids(jnp.asarray(e))), atol=1e-6)
    if k == 4:
        sim = rng.normal(size=(4, 5, 4)).astype(np.float32)
        (s, per), (js, jper) = ge2e.calc_loss(_t(sim)), jge2e.calc_loss(jnp.asarray(sim))
        np.testing.assert_allclose(per.numpy(), np.asarray(jper), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
        jloss = jge2e.GE2ELoss()
        lp = jloss.init(jax.random.PRNGKey(0), jnp.asarray(e))
        with torch.no_grad():
            port_loss = float(ge2e.GE2ELoss()(_t(e)))
        np.testing.assert_allclose(port_loss,
                                   float(jloss.apply(lp, jnp.asarray(e))), rtol=1e-6)


def test_three_clipped_sgd_steps_match_jax(flax_params):
    jemb, _ = flax_params
    rng = np.random.default_rng(7)
    batch = rng.normal(size=(3, 4, FRAMES, MELS)).astype(np.float32)
    init_fn, step_fn = jh.make_ge2e_train_step(jemb, jge2e.GE2ELoss(), 0.05)
    params, opt = init_fn(jax.random.PRNGKey(1), batch)
    emb = _port_embedder(params["embedder"])
    loss_mod = ge2e.GE2ELoss()
    step = h.make_ge2e_train_step(emb, loss_mod, 0.05, n_speakers=3)
    for i in range(3):
        params, opt, jl = step_fn(params, opt, jnp.asarray(batch))
        # the flat (N·M, ...) layout of DeviceSpeakerBank on the even steps
        got = step(_t(batch.reshape(12, FRAMES, MELS)) if i % 2 == 0 else _t(batch))
        np.testing.assert_allclose(float(got), float(jl), rtol=1e-5, err_msg=f"step {i}")
    want = export_ge2e_embedder(params["embedder"])
    for name, v in emb.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name], atol=1e-5, rtol=0, err_msg=name)
    lp = params["loss"]["params"]
    np.testing.assert_allclose([loss_mod.w.item(), loss_mod.b.item()],
                               [float(lp["w"]), float(lp["b"])], atol=1e-5)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eer_sweep_and_spoof_rate_equal(seed):
    rng = np.random.default_rng(seed)
    sim = rng.uniform(0.3, 1.0, (4, 8, 4)).astype(np.float32)
    sim[np.arange(4), :, np.arange(4)] += 0.15
    for enroll, spoof in ((1, True), (2, False)):
        assert h.eer_sweep(sim, enroll, spoof) == jh.eer_sweep(sim, enroll, spoof)
    for thr in (0.55, 0.8, 0.93):
        assert h.spoof_rate_at_threshold(sim, thr, 2) == jh.spoof_rate_at_threshold(sim, thr, 2)


# ---------------------------------------------------------------------------
# Data: preprocessing, batchers, checkpoints, evaluation
# ---------------------------------------------------------------------------

ENROLL, EVAL = 1, 2
SR = 16000


def _voice(rng, f0, seconds):
    t = np.arange(int(SR * seconds)) / SR
    sig = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k for k in range(1, 10))
    return (0.3 * sig / np.abs(sig).max() + 0.002 * rng.normal(size=t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """A staged GE2E layout: 3 train speakers of 5 real utterances, 3 test
    speakers of (enroll + eval) real then eval "spoof" utterances
    (``<sid>W###.wav``, as ``stage_ivector_data`` names them), a real-only
    ``test_nospoof`` copy, one utterance too short to crop; the JAX and port
    configurations preprocess it into their own directories."""
    root = tmp_path_factory.mktemp("ge2e")
    rng = np.random.default_rng(0)
    for i in range(6):
        sid = f"{900 + i}"
        d, ns = root / "ge2e_data" / sid, root / "nospoof" / sid
        d.mkdir(parents=True)
        n_real = 5 if i < 3 else ENROLL + EVAL
        for j in range(n_real + (EVAL if i >= 3 else 0)):
            f0 = 100 + 25 * i + (40 if j >= n_real else 0)
            y = _voice(rng, f0 + rng.uniform(-5, 5), rng.uniform(0.35, 0.5))
            host.write_wav(str(d / f"{sid}W{j + 1:03d}.wav"), y, SR)
            if i >= 3 and j < n_real:
                ns.mkdir(parents=True, exist_ok=True)
                host.write_wav(str(ns / f"{sid}W{j + 1:03d}.wav"), y, SR)
        if i == 0:
            host.write_wav(str(d / f"{sid}W099.wav"), _voice(rng, 100, 0.1), SR)
    yaml = f"""training: !!bool "true"
device: "cuda"
unprocessed_data: '{root}/ge2e_data/*/*.wav'
---
data:
    train_path: '{root}/{{pkg}}/train_tisv'
    test_path: '{root}/{{pkg}}/test_tisv'
    sr: 16000
    nfft: 512 # mel spectrogram
    window: 0.025 #(s)
    hop: 0.01 #(s)
    nmels: {MELS}
    tisv_frame: {FRAMES}
---
model:
    hidden: {HID}
    num_layer: {LAYERS}
    proj: {PROJ}
---
train:
    N : 2
    M : 3
    lr: 0.01
    epochs: 2
    log_interval: 1
    checkpoint_interval: 1
    checkpoint_dir: '{root}/{{pkg}}/ckpt'
---
test:
    N : 3
    M : {2 * (ENROLL + 2 * EVAL)}
    epochs: 1
save_simmat_dir: '{root}/{{pkg}}/simmat'
"""
    cfgs = {}
    for pkg, klass in (("jax", JGE2EConfig), ("port", GE2EConfig)):
        path = root / f"{pkg}.yaml"
        path.write_text(yaml.replace("{pkg}", pkg))
        cfgs[pkg] = klass.from_yaml(str(path))
    jh.save_spectrogram_tisv(cfgs["jax"], 3, ENROLL + EVAL, EVAL, seed=5, verbose=False)
    cli_ge2e.main(["preprocess", "--config", str(root / "port.yaml"), "--train_spk_num", "3",
                   "--enroll_num", str(ENROLL), "--eval_num", str(EVAL)])
    return root, cfgs


def test_yaml_config_matches_jax(staged, tmp_path):
    root, cfgs = staged
    port = GE2EConfig.from_yaml(str(root / "jax.yaml"))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfgs["jax"])
    assert cfgs["port"].training and cfgs["port"].train.N == 2
    assert cfgs["port"].save_simmat_dir.endswith("port/simmat")
    assert GE2EConfig.from_yaml(str(root / "port.yaml")) == cfgs["port"]
    for bad in ("a:\n  - 1\n", "a: [1, 2]\n", "a:\n  b:\n    c: 1\n", "a: &x 1\n",
                "a: 0x1F\n", "a: 2024-01-02\n", "a: !!python/name:os.system ''\n", "- 1\n"):
        with pytest.raises(ValueError):
            parse_reference_yaml(bad)
    p = tmp_path / "empty.yaml"
    p.write_text("# nothing\n---\n")
    assert GE2EConfig.from_yaml(str(p)) == GE2EConfig() == GE2EConfig(**{
        f.name: getattr(JGE2EConfig(), f.name) for f in dataclasses.fields(JGE2EConfig)
        if f.name not in ("data", "model", "train", "test")})


def test_preprocessing_writes_the_jax_arrays(staged):
    root, _ = staged
    for sub in ("train_tisv", "test_tisv"):
        names = sorted(os.listdir(root / "jax" / sub))
        assert names == sorted(os.listdir(root / "port" / sub)) and len(names) == 3
        for n in names:
            np.testing.assert_array_equal(np.load(root / "port" / sub / n),
                                          np.load(root / "jax" / sub / n))
    assert np.load(root / "port" / "test_tisv" / "speaker0.npy").shape == (
        2 * (ENROLL + 2 * EVAL), MELS, FRAMES)


def test_batchers_draw_the_jax_batches(staged):
    root, _ = staged
    path = str(root / "port" / "train_tisv")
    mine, ref = h.SpeakerBatcher(path, 3, seed=4), jh.SpeakerBatcher(path, 3, seed=4)
    bank, jbank = h.DeviceSpeakerBank(path, 3, seed=4, device="cpu"), jh.DeviceSpeakerBank(
        path, 3, seed=4)
    assert len(bank) == len(jbank) == 3
    for _ in range(4):
        want = ref.sample_batch(2)
        np.testing.assert_array_equal(mine.sample_batch(2), want)
        flat = bank.sample_batch(2)
        assert flat.device.type == "cpu" and flat.dtype == torch.float32
        np.testing.assert_array_equal(flat.numpy(), np.asarray(jbank.sample_batch(2)))
        np.testing.assert_array_equal(flat.numpy(), want.reshape(-1, FRAMES, MELS))
    test_path = str(root / "port" / "test_tisv")
    got = list(h.SpeakerBatcher(test_path, 4, shuffle=False).ordered_batches(2))
    want = list(jh.SpeakerBatcher(test_path, 4, shuffle=False).ordered_batches(2))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
    assert bank.nbytes == bank.flat.numel() * 4


def test_generic_preprocessing_and_on_the_fly_batches_match_jax(staged, tmp_path):
    """``save_spectrogram_tisv_generic`` (split on non-silent intervals, 80 %
    train) writes the JAX arrays; ``OnTheFlySpeakerBatcher`` draws the JAX
    batches (features computed as drawn)."""
    root, cfgs = staged
    out = {}
    for pkg, mod in (("jax", jh), ("port", h)):
        c = cfgs[pkg]
        c = dataclasses.replace(c, data=dataclasses.replace(
            c.data, train_path=str(tmp_path / pkg / "train"),
            test_path=str(tmp_path / pkg / "test")))
        mod.save_spectrogram_tisv_generic(c, verbose=False)
        out[pkg] = {f"{sub}/{f}": np.load(tmp_path / pkg / sub / f)
                    for sub in ("train", "test") for f in os.listdir(tmp_path / pkg / sub)}
        draws = mod.OnTheFlySpeakerBatcher(c, m=2, seed=3)
        assert len(draws) == 6
        out[pkg]["draws"] = [draws.sample_batch(2) for _ in range(2)]
    assert sorted(out["port"]) == sorted(out["jax"]) and len(out["port"]) == 7
    for k, v in out["jax"].items():
        for g, w in zip(out["port"][k] if k == "draws" else [out["port"][k]],
                        v if k == "draws" else [v]):
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)


def test_checkpoints_read_both_ways(flax_params, tmp_path):
    jemb, params = flax_params
    jloss = jge2e.GE2ELoss().init(jax.random.PRNGKey(0), jnp.zeros((2, 2, PROJ)))
    jh._save_ge2e_ckpt({"embedder": params, "loss": jloss}, str(tmp_path), "j.npz")
    emb, loss = ge2e.SpeechEmbedder(MELS, HID, LAYERS, PROJ), ge2e.GE2ELoss()
    with torch.no_grad():
        loss.w.fill_(1.0)
    load_ge2e_params(str(tmp_path / "j.npz"), emb, loss)
    assert (float(loss.w), float(loss.b)) == (10.0, -5.0)
    want = export_ge2e_embedder(params)
    for name, v in emb.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[name])
    # the port's .npz through the JAX loader gives the JAX tree back
    save_ge2e_checkpoint(str(tmp_path / "p.npz"), emb, loss)
    back = jh.load_ge2e_params(str(tmp_path / "p.npz"), jemb, PROJ)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(back)}
    arrays = ge2e_flax_arrays(emb, loss)
    assert set(flat) == {k[len("embedder/"):] for k in arrays if k.startswith("embedder/")}
    for k, v in flat.items():
        np.testing.assert_array_equal(v, arrays["embedder/" + k], err_msg=k)
    with np.load(tmp_path / "p.npz") as data:
        assert float(data["loss/params/w"]) == 10.0
    # a reference state dict, bare (.model) or under model_state_dict (.pth)
    save_ge2e_checkpoint(str(tmp_path / "r.model"), emb)
    torch.save({"model_state_dict": emb.state_dict()}, tmp_path / "r.pth")
    for name in ("r.model", "r.pth"):
        other = load_ge2e_params(str(tmp_path / name), ge2e.SpeechEmbedder(MELS, HID, LAYERS,
                                                                           PROJ))
        for (k, v), w in zip(other.state_dict().items(), emb.state_dict().values()):
            assert torch.equal(v, w), k
    jref = jh.load_ge2e_params(str(tmp_path / "r.model"), jemb, PROJ)
    x = np.random.default_rng(2).normal(size=(3, FRAMES, MELS)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(emb(_t(x)).numpy(), np.asarray(jemb.apply(jref, x)),
                                   atol=1e-5)


@pytest.mark.parametrize("staged_nospoof", [False, True])
def test_run_ge2e_evaluation_matches_jax(staged, flax_params, staged_nospoof):
    root, cfgs = staged
    _, params = flax_params
    jloss = jge2e.GE2ELoss().init(jax.random.PRNGKey(0), jnp.zeros((2, 2, PROJ)))
    ckdir = root / ("ck_staged" if staged_nospoof else "ck_slice")
    ckdir.mkdir()
    jh._save_ge2e_ckpt({"embedder": params, "loss": jloss}, str(ckdir), "m.npz")
    kw = dict(enroll_num=ENROLL, eval_num=EVAL, model_path=str(ckdir / "m.npz"), epochs=1,
              verbose=False)
    ns = {}
    if staged_nospoof:
        ns = dict(nospoof_data=str(root / "nospoof" / "*" / "*.wav"), seed=3)
    want = jh.run_ge2e_evaluation(cfgs["jax"], **kw, **ns,
                                  **({"nospoof_test_path": str(root / "jax" / "ns")}
                                     if ns else {}))
    got = h.run_ge2e_evaluation(cfgs["port"], **kw, **ns, device="cpu",
                                **({"nospoof_test_path": str(root / "port" / "ns")}
                                   if ns else {}))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    sim = np.load(root / "port" / "simmat" / "simmat_e1_b1.npy")
    assert sim.shape == (3, 2 * (ENROLL + 2 * EVAL) - 2 * ENROLL, 3)
    np.testing.assert_allclose(sim, np.load(root / "jax" / "simmat" / "simmat_e1_b1.npy"),
                               atol=1e-5)


def test_train_and_test_cli_on_the_cpu(staged):
    """``ge2e train`` (2 epochs, checkpoints each epoch) then ``test`` and
    ``dvector`` from its final checkpoint, all through ``main(argv)``."""
    root, cfgs = staged
    conf = str(root / "port.yaml")
    emb, loss = cli_ge2e.main(["train", "--config", conf], device="cpu")
    ck = root / "port" / "ckpt"
    assert sorted(os.listdir(ck)) == ["ckpt_epoch_1.npz", "ckpt_epoch_2.npz",
                                      "final_epoch_2.npz"]
    again = ge2e.SpeechEmbedder(MELS, HID, LAYERS, PROJ)
    load_ge2e_params(str(ck / "final_epoch_2.npz"), again)
    for (k, v), w in zip(again.state_dict().items(), emb.state_dict().values()):
        assert torch.equal(v, w), k
    assert float(loss.w) != 10.0                        # trained
    r = cli_ge2e.main(["test", "--config", conf, "--model_path", str(ck / "final_epoch_2.npz"),
                       "--enroll_num", str(ENROLL), "--eval_num", str(EVAL)], device="cpu")
    assert 0.0 <= r["EER"] <= 1.0 and 0.5 <= r["clean_threshold"] <= 0.99
    out = root / "dvec"
    out.mkdir()
    seq, ids = cli_ge2e.main(["dvector", "--config", conf, "--model_path",
                              str(ck / "final_epoch_2.npz"), "--out_dir", str(out)],
                             device="cpu")
    assert seq.shape[1] == PROJ and len(seq) == len(ids) > 0
    assert np.isfinite(seq).all()
