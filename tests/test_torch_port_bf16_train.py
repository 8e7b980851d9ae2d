"""bf16 training in the port against the JAX package's bf16 training, on the CPU.

The port keeps f32 parameters and Adam state and runs the steps' forwards
under ``torch.autocast(bfloat16)`` (``train_compute_dtype="bfloat16"``); the
JAX package builds its models with ``dtype=jnp.bfloat16`` over f32
parameters (on a TPU only; here the models are built so by hand). Same
seeded weights and batch, the tiny configuration, every highway impl (the
kernels' plain versions on the CPU, their inputs cast by autocast).

Tolerances come from bf16 rounding: bf16 keeps 8 bits of mantissa
(2^-8 ≈ 4e-3 relative), and the two packages round at different places
(autocast casts per op; flax casts each module's inputs and parameters).

* A step loss lies within 1e-2 relative of JAX's bf16 loss, and differs
  from the port's own f32 loss (autocast is on).
* The gradient: at this size bf16 rounding moves JAX's own Text2Mel
  gradient by 61 % (relative norm, all parameters) from its f32 gradient,
  SSRN's by 20 %. The port's bf16 gradient must part from JAX's f32
  gradient by no more than 1.25 times what JAX's bf16 gradient does
  (readings 0.61-0.91 times), and by more than a tenth of it (an f32
  step parts by 1e-5).
* The update (parameters after the steps less the initial ones), over the
  entries whose gradient is not rounding-level in the reference (JAX's f32
  gradient at least its leaf's RMS, JAX's bf16 gradient within half of
  it), as one relative norm against JAX's bf16 update: within 0.25 after
  one step (readings at most 0.12) and 0.6 after three (readings at most
  0.47; Adam moves every parameter by about ±lr a step, so an entry whose
  gradient changes sign in bf16 in a later step parts by 2·lr). A zero
  update parts by 1 and a reversed one by 2, so both fail.
* The adversarial metrics lie within eight roundings (3e-2) of JAX's bf16
  value, relative to the metric's size; the G step's loss, recon +
  coeff·loss_disc, cancels to rounding when loss_disc < 0, so its size is
  that of its two terms. The critic's outputs are bf16 in every step, and
  the critic's metrics differ from the port's f32 ones.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.cli.main import build_models as jax_build_models
from spoofsv_tpu.train.steps import make_adversarial_steps as jax_adversarial_steps
from spoofsv_tpu.train.steps import make_eval_step as jax_eval_step
from spoofsv_tpu.train.steps import make_ordinary_step as jax_ordinary_step
from spoofsv_tpu.utils import torch_export as jexport
from spoofsv_torch.cli import main as cli
from spoofsv_torch.models import LinDisc, MelDisc, layers
from spoofsv_torch.ops import hconv_kernel
from spoofsv_torch.train import Trainer, loop, make_ordinary_step, steps
from spoofsv_torch.weights import load_state

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

KINDS = ("train_text2mel", "train_ssrn")
EXPORT = {"train_text2mel": jexport.export_melsyn, "train_ssrn": jexport.export_ssrn}
BF16 = torch.bfloat16


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "mel": rng.uniform(0.05, 0.95, (2, 12, cfg.mel.freq_bins)).astype(np.float32),
        "text": rng.integers(1, cfg.vocab_len - 1, (2, 16)).astype(np.int32),
        "spk": rng.normal(size=(2, cfg.spk_emb_dim)).astype(np.float32),
        "lin": rng.uniform(0.05, 0.95, (2, 48, cfg.lin_bins)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_runs(tiny_cfg):
    """Per train kind, from the JAX models built with ``dtype=bfloat16``:
    the exported initial generator (and critic), the initial gradient of
    the bf16 and of the f32 model, 3 ordinary steps' losses and the
    parameters after each, and a WGAN-GP G, D, D sequence's metrics with
    its penalty draws."""
    batch = _batch(tiny_cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    melsyn, ssrn, mel_disc, lin_disc = jax_build_models(tiny_cfg, "conditional",
                                                        dtype=jnp.bfloat16)
    f32_models = jax_build_models(tiny_cfg, "conditional")[:2]
    for kind, gen, gen32, disc in zip(KINDS, (melsyn, ssrn), f32_models, (mel_disc, lin_disc)):
        init_fn, step_fn = jax_ordinary_step(gen, tiny_cfg, kind)
        state = init_fn(jax.random.PRNGKey(0), jb)
        init = EXPORT[kind](state.params)
        grads = {name: {k: np.asarray(v) for k, v in EXPORT[kind](jax.grad(
                     lambda p: jax_eval_step(g, tiny_cfg, kind)(p, jb)["loss"])(state.params)).items()}
                 for name, g in (("bf16", gen), ("f32", gen32))}
        losses, params = [], []
        for i in range(3):
            state, m = step_fn(state, jb, jax.random.PRNGKey(i))
            losses.append({k: float(v) for k, v in m.items()})
            params.append(EXPORT[kind](state.params))
        ordinary = dict(init=init, grads=grads, losses=losses, params=params)
        init_fn, g_step, d_step = jax_adversarial_steps(gen, disc, tiny_cfg, kind, "wgan-gp")
        state = init_fn(jax.random.PRNGKey(0), jb)
        adv_init = (EXPORT[kind](state.gen_params), jexport.export_critic(state.disc_params))
        state, m = g_step(state, jb, jax.random.PRNGKey(1))
        metrics, draws = [{k: float(v) for k, v in m.items()}], []
        for seed in (2, 3):
            key = jax.random.PRNGKey(seed)
            draws.append(np.asarray(jax.random.uniform(jax.random.split(key)[1], (2, 1, 1),
                                                       jnp.float32)))
            state, m = d_step(state, jb, key)
            metrics.append({k: float(v) for k, v in m.items()})
        out[kind] = dict(ordinary=ordinary, adv_init=adv_init, metrics=metrics, draws=draws)
    return batch, out


def _relative(have, want) -> float:
    """‖have − want‖ / ‖want‖ over every leaf as one vector."""
    return float(np.sqrt(sum(np.sum((have[k] - want[k]) ** 2) for k in want)
                         / sum(np.sum(want[k] ** 2) for k in want)))


def _not_rounding_level(grads):
    """Per leaf, the entries whose gradient is not rounding-level in JAX's
    bf16 step: the f32 gradient at least the leaf's RMS, and the bf16
    gradient within half of it."""
    keep = {}
    for k, g32 in grads["f32"].items():
        keep[k] = ((np.abs(g32) >= np.sqrt(np.mean(g32 ** 2)))
                   & (np.abs(grads["bf16"][k] - g32) <= 0.5 * np.abs(g32)))
    return keep


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused_pair"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_ordinary_step_matches_jax_bf16(tiny_cfg, jax_runs, kind, impl):
    batch, ref = jax_runs
    want = ref[kind]["ordinary"]
    tb = {k: _t(v) for k, v in batch.items()}
    pick = 0 if kind == "train_text2mel" else 1
    got, grad, params = {}, {}, []
    for dt, n_steps in ((BF16, 3), (torch.float32, 1)):
        model = load_state(cli.build_models(tiny_cfg, device="cpu")[pick], want["init"])
        with layers.gate_impl(impl):
            init_fn, step_fn = make_ordinary_step(model, tiny_cfg, kind, compute_dtype=dt)
            state = init_fn()
            got[dt] = []
            for i in range(n_steps):
                got[dt].append(step_fn(state, tb)[1])
                if i == 0:   # the step leaves its gradient, taken at the initial parameters
                    grad[dt] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
                if dt == BF16:
                    params.append({k: v.numpy().copy() for k, v in model.state_dict().items()})
        assert all(p.dtype == torch.float32 for p in model.parameters())
    # autocast is really on: the bf16 losses are not the f32 ones
    assert float(got[BF16][0]["loss"]) != float(got[torch.float32][0]["loss"])
    for i, (have, w) in enumerate(zip(got[BF16], want["losses"])):
        for k, v in w.items():
            np.testing.assert_allclose(float(have[k]), v, rtol=1e-2, err_msg=f"step {i} {k}")
    # the gradient parts from f32 by bf16 rounding, and no more than JAX's does
    jax_err = _relative(want["grads"]["bf16"], want["grads"]["f32"])
    port_err = _relative(grad[BF16], want["grads"]["f32"])
    assert 0.1 * jax_err < port_err <= 1.25 * jax_err, (port_err, jax_err)
    assert _relative(grad[torch.float32], want["grads"]["f32"]) < 1e-3
    # the update, over the entries whose gradient is not rounding-level
    keep = _not_rounding_level(want["grads"])
    assert sum(m.sum() for m in keep.values()) >= 0.1 * sum(m.size for m in keep.values())

    def update(p):
        return {k: (p[k] - want["init"][k])[m] for k, m in keep.items()}

    for step, bound in ((0, 0.25), (2, 0.6)):
        ref_update, have = update(want["params"][step]), update(params[step])
        assert _relative(have, ref_update) <= bound, (step, _relative(have, ref_update))
        for wrong in ({k: 0 * v for k, v in have.items()}, {k: -v for k, v in have.items()}):
            assert _relative(wrong, ref_update) > bound


@pytest.mark.parametrize("impl", ["xla", "fused_pair"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_adversarial_steps_match_jax_bf16(tiny_cfg, jax_runs, monkeypatch, kind, impl):
    """A WGAN-GP G, D, D sequence with JAX's penalty draws handed in; the
    critic computes in bf16 too (the JAX package builds it with the same
    dtype) and its double backward stays on the plain highway block."""
    batch, ref = jax_runs
    r = ref[kind]
    tb = {k: _t(v) for k, v in batch.items()}
    got, critic_out = {}, {}
    for dt in (BF16, torch.float32):
        gen = load_state(cli.build_models(tiny_cfg, device="cpu")[0 if kind == KINDS[0] else 1],
                         r["adv_init"][0])
        disc = (MelDisc(tiny_cfg.disc_dim, freq_bins=tiny_cfg.mel.freq_bins) if kind == KINDS[0]
                else LinDisc(tiny_cfg.disc_dim, lin_bins=tiny_cfg.lin_bins))
        load_state(disc, r["adv_init"][1])
        critic_out[dt] = set()
        disc.register_forward_hook(lambda m, i, out, seen=critic_out[dt]: seen.add(out.dtype))
        draws = iter(r["draws"])
        monkeypatch.setattr(steps, "draw_mixing", lambda b, g, d: _t(next(draws)).to(d))
        with layers.gate_impl(impl):
            init_fn, g_step, d_step = steps.make_adversarial_steps(gen, disc, tiny_cfg, kind,
                                                                   compute_dtype=dt)
            state = init_fn()
            got[dt] = [g_step(state, tb)[1]] + [d_step(state, tb)[1] for _ in range(2)]
        assert all(p.dtype == torch.float32 for p in (*gen.parameters(), *disc.parameters()))
    # autocast is really on in the critic: its outputs are bf16, and its
    # metrics are not the f32 step's
    assert critic_out == {BF16: {BF16}, torch.float32: {torch.float32}}
    for i, (have, want, f32) in enumerate(zip(got[BF16], r["metrics"], got[torch.float32])):
        assert sorted(have) == sorted(want)
        assert float(have["loss_disc" if i == 0 else "gp"]) != float(f32["loss_disc" if i == 0 else "gp"])
        for k, v in want.items():
            size = abs(v)
            if k == "loss" and i == 0:   # recon + coeff·loss_disc: two terms of recon's size
                size = 2 * sum(want[p] for p in ("l1", "bd", "att") if p in want)
            assert abs(float(have[k]) - v) <= 3e-2 * size, (i, k, float(have[k]), v)


def test_autocast_reaches_the_kernel_wrappers(monkeypatch):
    """Under autocast a kernel's ``autograd.Function`` gets every floating
    input cast to bf16 (autocast does not cast a Function's inputs itself),
    returns bf16, and the f32 parameters get f32 gradients."""
    seen = []
    plain = hconv_kernel.highway_conv_plain

    def spy(*args):
        seen.append({a.dtype for a in args if isinstance(a, torch.Tensor)})
        return plain(*args)

    monkeypatch.setattr(hconv_kernel, "highway_conv_plain", spy)
    blk = layers.HighwayConv(32, 3, 3)
    x = torch.randn(2, 20, 32)
    with layers.gate_impl("fused_conv"), torch.autocast("cpu", dtype=BF16):
        y = blk(x)
    assert y.dtype == BF16 and seen[0] == {BF16}
    y.float().square().sum().backward()
    assert blk.conv.weight.grad.dtype == torch.float32 and blk.ln1.weight.grad is not None
    with layers.gate_impl("fused_conv"):
        assert blk(x).dtype == torch.float32 and seen[-1] == {torch.float32}


def test_trainer_validates_in_bf16(tiny_cfg, tmp_path, monkeypatch):
    """The Trainer under bf16: parameters and Adam state stay f32; the AR
    validation decodes a bf16 copy of the model, as the JAX Trainer's
    validation decodes with its bf16 module, one copy for all the batches
    of a validation call; the copy leaves the model untouched."""
    decoded, copies = [], []
    fused = loop.make_fused_decoder

    def spy(model, n_frames):
        decoded.append(next(model.parameters()).dtype)
        copies.append(model)
        return fused(model, n_frames)

    monkeypatch.setattr(loop, "make_fused_decoder", spy)
    cfg = tiny_cfg.replace(src_root_dir=str(tmp_path) + "/", val_every_iter=2)
    torch.manual_seed(0)
    model = cli.build_models(cfg, device="cpu")[0]
    data = [_batch(cfg, seed) for seed in range(2)]
    trainer = Trainer(cfg, model, "train_text2mel", ctime="bf16", compute_dtype=BF16)
    trainer.fit(lambda: iter(data), lambda: iter(data[:1]), max_iterations=2)
    trainer.close()
    # one validation call: the validation batch and the training probe, one copy
    assert decoded == [BF16, BF16] and copies[0] is copies[1] and copies[0] is not model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for s in trainer.state.optimizer.state.values()
               for k, v in s.items() if k != "step")
    assert np.isfinite(trainer.loss_val_log).all()
