"""The port's ordinary training path vs the JAX package on the CPU.

Losses, the ordinary train step (JAX params → ``export_*`` → the port, three
Adam steps on one batch), the eval step, the Trainer's checkpoints in the
reference ``.tar.pth`` schema and resume, and the CLI helpers. Seeded numpy
inputs go to both sides. Tolerances are stated where they are used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.cli.main import build_models as jax_build_models
from spoofsv_tpu.train import losses as jlosses
from spoofsv_tpu.train.steps import make_ordinary_step as jax_ordinary_step
from spoofsv_tpu.train.steps import shift_right as jax_shift_right
from spoofsv_tpu.utils.torch_export import (export_melsyn, export_ssrn,
                                            save_reference_checkpoint)
from spoofsv_torch.cli import main as cli
from spoofsv_torch.models import layers
from spoofsv_torch.train import Trainer, losses, make_eval_step, make_ordinary_step, shift_right
from spoofsv_torch.weights import load_reference_checkpoint, load_state

KINDS = ("train_text2mel", "train_ssrn")
EXPORT = {"train_text2mel": export_melsyn, "train_ssrn": export_ssrn}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Losses (f32 reductions of a few hundred terms: rtol 1e-6)
# ---------------------------------------------------------------------------

def test_guided_attention_matrix_and_shift_right_equal():
    np.testing.assert_array_equal(losses.guided_attention_matrix(30, 24),
                                  jlosses.guided_attention_matrix(30, 24))
    mel = np.random.default_rng(0).uniform(size=(2, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(shift_right(_t(mel)).numpy(),
                                  np.asarray(jax_shift_right(jnp.asarray(mel))))


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    rng = np.random.default_rng(1)
    gt = rng.uniform(0.05, 0.95, (2, 9, 6)).astype(np.float32)
    pred = rng.uniform(0.05, 0.95, (2, 9, 6)).astype(np.float32)
    att = rng.uniform(0, 1, (2, 7, 9)).astype(np.float32)
    gaw = losses.guided_attention_matrix(12, 16)
    mask = np.arange(9)[None, :] < np.array([[9], [5]]) if masked else None
    att_mask = (np.arange(7)[None, :, None] < np.array([7, 4])[:, None, None]) & mask[:, None, :] \
        if masked else None
    tm = None if mask is None else _t(mask)
    jm = None if mask is None else jnp.asarray(mask)
    pairs = [
        (losses.l1_loss(_t(gt), _t(pred), tm), jlosses.l1_loss(gt, pred, jm)),
        (losses.binary_divergence(_t(gt), _t(pred), tm),
         jlosses.binary_divergence(gt, pred, jm)),
        (losses.guided_attention_loss(_t(att), _t(gaw), None if att_mask is None else _t(att_mask)),
         jlosses.guided_attention_loss(jnp.asarray(att), jnp.asarray(gaw),
                                       None if att_mask is None else jnp.asarray(att_mask))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_binary_divergence_saturated_stays_finite():
    """A sigmoid output just outside [0, 1] (``1 + 1e-7``, ``-1e-7``) gives the
    saturated value, finite, as in JAX (the ``maximum`` floor, not ``+1e-8``)."""
    t = np.asarray([[0.2, 0.9]], np.float32)
    pred = np.asarray([[1.0 + 1e-7, -1e-7]], np.float32)
    bd = float(losses.binary_divergence(_t(t), _t(pred)))
    assert np.isfinite(bd)
    sat = float(losses.binary_divergence(_t(t), _t(np.asarray([[1.0, 0.0]], np.float32))))
    assert abs(bd - sat) < 1e-5
    np.testing.assert_allclose(bd, float(jlosses.binary_divergence(t, pred)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Ordinary step: three Adam steps on one batch, JAX vs port
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "mel": rng.uniform(0.05, 0.95, (2, 12, cfg.mel.freq_bins)).astype(np.float32),
        "text": rng.integers(1, cfg.vocab_len - 1, (2, 16)).astype(np.int32),
        "spk": rng.normal(size=(2, cfg.spk_emb_dim)).astype(np.float32),
        "lin": rng.uniform(0.05, 0.95, (2, 48, cfg.lin_bins)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_steps(tiny_cfg):
    """Per train kind: the exported initial params, the three step losses and
    the exported params after step 3, from JAX's ``make_ordinary_step``."""
    melsyn, ssrn, _, _ = jax_build_models(tiny_cfg, "conditional")
    batch = _batch(tiny_cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for kind, model in zip(KINDS, (melsyn, ssrn)):
        init_fn, step_fn = jax_ordinary_step(model, tiny_cfg, kind)
        state = init_fn(jax.random.PRNGKey(0), jbatch)
        init = EXPORT[kind](state.params)
        steps = []
        for i in range(3):
            state, m = step_fn(state, jbatch, jax.random.PRNGKey(i))
            steps.append({k: float(v) for k, v in m.items()})
        out[kind] = dict(init=init, steps=steps, final=EXPORT[kind](state.params))
    return batch, out


@pytest.mark.parametrize("impl", ["xla", "fused_pair"])
@pytest.mark.parametrize("kind", KINDS)
def test_ordinary_step_matches_jax(tiny_cfg, jax_steps, kind, impl):
    """Losses at every step within rtol 1e-5 (f32 forward and backward, one
    batch); parameters after step 3 within atol 2e-5 through the reference
    schema: Adam's first steps move a parameter by about lr·sign(g), so a
    gradient differing by rounding moves it by rounding times lr."""
    batch, ref = jax_steps
    melsyn, ssrn = cli.build_models(tiny_cfg, device="cpu")
    model = load_state(melsyn if kind == "train_text2mel" else ssrn, ref[kind]["init"])
    tb = {k: _t(v) for k, v in batch.items()}
    with layers.gate_impl(impl):
        eval_loss = make_eval_step(model, tiny_cfg, kind)(tb)["loss"]
        init_fn, step_fn = make_ordinary_step(model, tiny_cfg, kind)
        state = init_fn()
        for want in ref[kind]["steps"]:
            state, m = step_fn(state, tb)
            for k, v in want.items():
                np.testing.assert_allclose(float(m[k]), v, rtol=1e-5,
                                           err_msg=f"step {state.step} {k}")
    assert state.step == 3
    # the eval loss at the initial weights is the JAX step-1 loss
    np.testing.assert_allclose(float(eval_loss), ref[kind]["steps"][0]["loss"], rtol=1e-5)
    got = model.state_dict()
    for k, v in ref[kind]["final"].items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=2e-5, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# Trainer: fit, reference-schema checkpoints, reload, resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_trainer_checkpoints_reload_and_resume(tiny_cfg, tmp_path, kind):
    cfg = tiny_cfg.replace(src_root_dir=str(tmp_path) + "/", val_every_iter=2)
    pick = 0 if kind == "train_text2mel" else 1
    torch.manual_seed(0)
    model = cli.build_models(cfg, device="cpu")[pick]
    data = [_batch(cfg, seed) for seed in range(3)]
    trainer = Trainer(cfg, model, kind, ctime="t")
    trainer.fit(lambda: iter(data), lambda: iter(data[:1]), max_iterations=4)
    trainer.close()
    assert trainer.iteration == 4 and len(trainer.loss_val_log) == 2
    assert np.all(np.isfinite(trainer.loss_val_log))
    path = trainer.ckpt.latest()
    prefix = kind[6:]
    assert path.endswith(f"{prefix}_iteration_4.tar.pth")
    base = tmp_path / "checkpoints" / "conditional" / "not_adversarial" / "t"
    assert (base / f"{prefix}_iteration_2.tar.pth").exists()
    assert (base / f"{prefix}_best_model.tar.pth").exists()
    assert (base / "metrics.jsonl").exists()

    # the reference schema: the keys save_reference_checkpoint writes
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    ref_path = str(tmp_path / "ref.tar.pth")
    save_reference_checkpoint(ref_path, {k: v.numpy() for k, v in model.state_dict().items()})
    assert set(ckpt) == set(torch.load(ref_path, weights_only=False))
    assert ckpt["iteration"] == 4 and ckpt["loss_val_log"] == trainer.loss_val_log
    adam = ckpt["optimizer_state_dict"]["state"]
    assert len(adam) == len(list(model.parameters()))
    assert all(float(s["step"]) == 4 and s["exp_avg_sq"].abs().sum() > 0 for s in adam.values())

    fresh = cli.build_models(cfg, device="cpu")[pick]
    load_reference_checkpoint(fresh, path)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)

    again = Trainer(cfg, cli.build_models(cfg, device="cpu")[pick], kind, ctime="t")
    again.resume(path)
    assert (again.iteration, again.state.step, again.loss_val_log) == (4, 4, trainer.loss_val_log)
    again.fit(lambda: iter(data), lambda: iter(data[:1]), max_iterations=6)
    again.close()
    assert again.iteration == 6 and again.ckpt.latest().endswith(f"{prefix}_iteration_6.tar.pth")


# ---------------------------------------------------------------------------
# CLI helpers
# ---------------------------------------------------------------------------

def test_cli_helpers(tiny_cfg):
    import dataclasses

    assert cli.training_dtype(tiny_cfg, "cpu") == torch.float32
    assert cli.inference_dtype(tiny_cfg, "cpu") == torch.float32
    melsyn, ssrn = cli.build_models(tiny_cfg.replace(apply_dropout=True), "unconditional",
                                   device="cpu")
    assert not melsyn.condition and melsyn.text_encoder.dropout_rate == 0.05
    assert ssrn.dropout_rate == 0.05 and next(ssrn.parameters()).dtype == torch.float32
    tpu = dataclasses.replace(tiny_cfg.tpu, highway_gate_impl="pallas",
                              highway_infer_impl="fused_pair")
    cfg = tiny_cfg.replace(tpu=tpu)
    with layers.gate_impl("xla"):
        cli.apply_runtime_knobs(cfg)
        assert layers.get_default_gate_impl() == "pallas"
        cli.apply_runtime_knobs(cfg, infer=True)
        assert layers.get_default_gate_impl() == "fused_pair"
    assert layers.get_default_gate_impl() == "xla"


def test_synthesizer_takes_the_infer_impl(tiny_cfg):
    """``apply_runtime_knobs(cfg, infer=True)`` gives the Synthesizer's text
    encoder and SSRN the infer impl; on the CPU the output matches "xla"
    (the plain versions: atol 1e-4 after GL4, whose momentum amplifies
    ~1e-6 mel differences)."""
    import dataclasses

    from spoofsv_torch.infer.synthesize import Synthesizer

    tpu = dataclasses.replace(tiny_cfg.tpu, highway_infer_impl="fused_pair", griffin_lim_iters=4)
    cfg = tiny_cfg.replace(tpu=tpu)
    torch.manual_seed(1)
    melsyn, ssrn = cli.build_models(cfg, device="cpu")
    b = _batch(cfg, 5)
    outs = []
    for infer in (False, True):
        with layers.gate_impl("xla"):
            cli.apply_runtime_knobs(cfg, infer=infer)
            outs.append(Synthesizer(cfg, melsyn, ssrn, n_frames=12)(b["text"], b["spk"]))
    for got, ref in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
