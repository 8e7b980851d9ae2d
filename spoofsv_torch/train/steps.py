"""Train and eval steps for Text2Mel and SSRN: ordinary and adversarial.

Port of :mod:`spoofsv_tpu.train.steps`:

  * ordinary: teacher-forced Text2Mel or SSRN with L1 + binary-divergence
    (+ guided attention) losses and one Adam update per call;
  * adversarial (:func:`make_adversarial_steps`): WGAN-GP (the default),
    weight-clip WGAN and vanilla GAN, a generator step with the reference's
    adaptive critic weighting and a critic step, the gradient penalty's
    nested gradient taken with ``torch.autograd.grad(create_graph=True)``.

PyTorch runs eagerly, so a step is the forward, the backward and
``optimizer.step()``; the generator's highway blocks go through the
process-wide implementation (:func:`spoofsv_torch.models.layers.gate_impl`),
the critic's are pinned to the plain one. With ``compute_dtype=bfloat16``
the forwards and losses run under ``torch.autocast`` over the f32
parameters and Adam state (the JAX package's models built with
``dtype=bfloat16``); the backwards run outside it.

Data parallelism (``mesh``, a :class:`spoofsv_torch.parallel.mesh.Mesh`
with a process group): each rank steps on its rows of the global batch, with the
same parameters. The losses are the global batch's (masked means over the
ranks' counts, :mod:`spoofsv_torch.train.losses`; the G step's adaptive
coefficient from the global reconstruction and critic losses; the penalty's
mixing draws made for the global batch from a generator every rank seeds
alike, then sliced); the gradients are all-reduced (mean, in buckets) after
the backward and before the optimizer, so Adam, and the weight clip, run
alike on every rank; the returned metrics are the global batch's. Explicit
all-reduces, not ``DistributedDataParallel``: the penalty takes a double
backward, which DDP does not support.

Batches are dicts of time-major tensors on the model's device:
``mel`` (B, T, 80), ``lin`` (B, 4T, 513), ``text`` (B, N) int, ``spk``
(B, 200), and optional masks ``mel_mask`` (B, T), ``lin_mask``,
``att_mask`` (B, N, T).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from spoofsv_torch.config import Config
from spoofsv_torch.parallel.mesh import active, all_reduce_grads, batch_sharding
from spoofsv_torch.train.losses import guided_attention_matrix, ssrn_losses, text2mel_losses
from spoofsv_torch.train.state import AdvTrainState, TrainState

Batch = Dict[str, torch.Tensor]
TRAIN_KINDS = ("train_text2mel", "train_ssrn")
GAN_TYPES = ("wgan-gp", "wgan", "vanilla")
#: the fused step's metrics, every key present on both branches
FUSED_METRICS = ("l1", "bd", "att", "loss", "loss_disc", "loss_d", "wd", "gp")


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam(α=2e-4, β=(0.5, 0.9), ε=1e-6): the update ``optax.adam`` makes,
    lr·m̂/(√v̂ + ε)."""
    a = cfg.adam
    return torch.optim.Adam(params, lr=a.alpha, betas=(a.beta_1, a.beta_2), eps=a.epsilon)


def autocast_to(device: torch.device, dtype: torch.dtype):
    """``torch.autocast`` to ``dtype`` on ``device``'s type, or nothing for f32."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def shift_right(mel: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing input: the mel shifted right one frame after a zero frame."""
    return torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], dim=1)


def _model_dtype(model: nn.Module) -> torch.dtype:
    return next(model.parameters()).dtype


def _gen_forward(model: nn.Module, batch: Batch, train_kind: str
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    dt = _model_dtype(model)
    if train_kind == "train_text2mel":
        return model(shift_right(batch["mel"].to(dt)), batch["text"], batch["spk"].to(dt))
    return model(batch["mel"].to(dt)), None


def _recon_losses(batch: Batch, y: torch.Tensor, a: Optional[torch.Tensor],
                  gaw: Callable[[torch.device], torch.Tensor], train_kind: str,
                  use_masks: bool, mesh=None):
    y = y.float()
    if train_kind == "train_text2mel":
        l1, bd, att = text2mel_losses(
            batch["mel"], y, a.float(), gaw(a.device),
            mel_mask=batch.get("mel_mask") if use_masks else None,
            att_mask=batch.get("att_mask") if use_masks else None, mesh=mesh)
        return l1 + bd + att, {"l1": l1, "bd": bd, "att": att}
    l1, bd = ssrn_losses(batch["lin"], y, batch.get("lin_mask") if use_masks else None, mesh)
    return l1 + bd, {"l1": l1, "bd": bd}


def _global(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Detached metrics, as the ranks' means over a mesh (one all-reduce)."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is None:
        return metrics
    flat = mesh.mean(torch.stack([v.float() for v in metrics.values()]))
    return dict(zip(metrics, flat.unbind(0)))


def guided_attention_table(cfg: Config) -> Callable[[torch.device], torch.Tensor]:
    """The (max_text_len, max_frame_num) guided-attention table, one copy per device."""
    host = torch.from_numpy(guided_attention_matrix(cfg.max_text_len, cfg.max_frame_num))
    on: Dict[torch.device, torch.Tensor] = {}

    def table(device: torch.device) -> torch.Tensor:
        if device not in on:
            on[device] = host.to(device)
        return on[device]

    return table


@contextlib.contextmanager
def eval_mode(model: nn.Module) -> Iterator[nn.Module]:
    """``model`` in eval mode with gradients off, its training flag restored after."""
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield model
    finally:
        model.train(was)


def make_ordinary_step(model: nn.Module, cfg: Config, train_kind: str,
                       use_masks: bool = False, compute_dtype: torch.dtype = torch.float32,
                       mesh=None):
    """Returns ``(init_fn, step_fn)``: ``init_fn()`` → a :class:`TrainState`
    with a fresh Adam over ``model``'s parameters; ``step_fn(state, batch)``
    → ``(state, metrics)``, updating the model and optimizer in place, the
    forward under :func:`autocast_to` ``compute_dtype``. Dropout
    (``cfg.apply_dropout``) draws from PyTorch's default generator."""
    if train_kind not in TRAIN_KINDS:
        raise ValueError(f"train_kind must be one of {TRAIN_KINDS}, got {train_kind!r}")
    gaw = guided_attention_table(cfg)
    has_dropout = cfg.apply_dropout
    mesh = active(mesh)

    def init_fn() -> TrainState:
        return TrainState(step=0, model=model, optimizer=make_optimizer(cfg, model.parameters()))

    def step_fn(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train(has_dropout)
        with autocast_to(_device(model), compute_dtype):
            y, a = _gen_forward(model, batch, train_kind)
            loss, parts = _recon_losses(batch, y, a, gaw, train_kind, use_masks, mesh)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            all_reduce_grads(model.parameters(), mesh)
        state.optimizer.step()
        state.step += 1
        return state, _global({**parts, "loss": loss}, mesh)

    return init_fn, step_fn


def make_eval_step(model: nn.Module, cfg: Config, train_kind: str, use_masks: bool = False):
    """Teacher-forced eval losses, ``eval_fn(batch)`` → metrics (the AR-decode
    validation is :func:`spoofsv_torch.train.loop.make_ar_validator`)."""
    gaw = guided_attention_table(cfg)

    def eval_fn(batch: Batch) -> Dict[str, torch.Tensor]:
        with eval_mode(model):
            y, a = _gen_forward(model, batch, train_kind)
            loss, parts = _recon_losses(batch, y, a, gaw, train_kind, use_masks)
        return {**parts, "loss": loss}

    return eval_fn


# ----------------------------------------------------------------------
# Adversarial training
# ----------------------------------------------------------------------

def draw_mixing(batch: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The gradient penalty's per-sample mixing coefficients, (B, 1, 1) U[0, 1)
    f32, drawn on ``device`` from ``generator`` (a generator of that device;
    the device's default one when None), so no host copy stalls the step."""
    return torch.rand((batch, 1, 1), generator=generator, device=device)


def is_g_step(step: int, ratio: int) -> bool:
    """The reference's alternation: a G step when ``step % (ratio+1) == 0``,
    a D step otherwise (``train/adversarial_wasserstein_gp.py:267``)."""
    return step % (ratio + 1) == 0


def clip_weights(module: nn.Module) -> None:
    """WGAN weight clipping to ±0.1 of every ``weight`` parameter (the
    Dense, conv and LayerNorm weights, the JAX ``kernel`` and ``scale``
    leaves), no bias (``train/adversarial_wasserstein.py:20-25``)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1] == "weight":
                p.clamp_(-0.1, 0.1)


def make_adversarial_steps(gen: nn.Module, disc: nn.Module, cfg: Config, train_kind: str,
                           gan_type: str = "wgan-gp", use_masks: bool = False,
                           compute_dtype: torch.dtype = torch.float32, mesh=None):
    """Returns ``(init_fn, g_step, d_step)``; ``gan_type`` is ``"wgan-gp"``
    (the reference's default trainer), ``"wgan"`` (weight clip) or
    ``"vanilla"`` (log loss on the time frames 1:9 of the mel, 1:33 of the
    linear spectrogram; it needs a critic with ``sigmoid_out``).

    * ``init_fn()`` → an :class:`AdvTrainState` with a fresh Adam for each net.
    * ``g_step(state, batch)``: the reconstruction loss plus ``coeff·loss_disc``,
      ``coeff = recon / (|loss_disc| + 1e-12)`` detached (no ``abs`` for
      vanilla); only the generator is updated.
    * ``d_step(state, batch, generator=None)``: the generator's forward
      without gradients, then ``mean(D(fake) − D(real))`` plus, for WGAN-GP,
      ``λ·mean((‖∇ₓD(x̂)‖₂ − 1)²)`` at ``x̂ = c·real + (1−c)·fake``, ``c`` from
      :func:`draw_mixing` with ``generator``; only the critic is updated
      (then clipped, for WGAN).

    Both return ``(state, metrics)`` and update the modules and optimizers in
    place. The critic is called as the JAX steps call it, deterministic. The
    forwards, the penalty's inner gradient and the losses run under
    :func:`autocast_to` ``compute_dtype``. ``mesh``: data parallelism over
    its ranks (the module docstring).
    """
    if train_kind not in TRAIN_KINDS:
        raise ValueError(f"train_kind must be one of {TRAIN_KINDS}, got {train_kind!r}")
    if gan_type not in GAN_TYPES:
        raise ValueError(f"gan_type must be one of {GAN_TYPES}, got {gan_type!r}")
    gaw = guided_attention_table(cfg)
    has_dropout = cfg.apply_dropout
    n_slice = 8 if train_kind == "train_text2mel" else 32   # adversarial.py:298-300,329
    real_key = "mel" if train_kind == "train_text2mel" else "lin"
    mesh = active(mesh)

    def disc_in(x: torch.Tensor) -> torch.Tensor:
        return x[:, 1: 1 + n_slice, :] if gan_type == "vanilla" else x

    def init_fn() -> AdvTrainState:
        return AdvTrainState(step=0, gen=gen, gen_optimizer=make_optimizer(cfg, gen.parameters()),
                             disc=disc, disc_optimizer=make_optimizer(cfg, disc.parameters()))

    def g_step(state: AdvTrainState, batch: Batch) -> Tuple[AdvTrainState, Dict[str, torch.Tensor]]:
        gen.train(has_dropout)
        with autocast_to(_device(gen), compute_dtype):
            y, a = _gen_forward(gen, batch, train_kind)
            recon, parts = _recon_losses(batch, y, a, gaw, train_kind, use_masks, mesh)
            d_out = disc(disc_in(y.float())).float()
            if gan_type == "vanilla":
                loss_disc = torch.mean(-torch.log(d_out + 1e-8))    # adversarial.py:307
            else:
                loss_disc = torch.mean(-d_out)                       # …wasserstein_gp.py:288
            # the coefficient from the global batch's losses
            r, ld = (recon.detach(), loss_disc.detach()) if mesh is None else \
                mesh.mean(torch.stack([recon.detach(), loss_disc.detach()])).unbind(0)
            denom = ld if gan_type == "vanilla" else ld.abs()    # no abs (adversarial.py:310)
            coeff = r / (denom + 1e-12)                              # …wasserstein_gp.py:290
            loss = recon + coeff * loss_disc
        params = [p for p in gen.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = g
        if mesh is not None:
            all_reduce_grads(params, mesh)
        state.gen_optimizer.step()
        state.gen_optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, _global({**parts, "loss_disc": loss_disc, "loss": loss}, mesh)

    def d_step(state: AdvTrainState, batch: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[AdvTrainState, Dict[str, torch.Tensor]]:
        gen.train(has_dropout)
        with torch.no_grad(), autocast_to(_device(gen), compute_dtype):
            y, _ = _gen_forward(gen, batch, train_kind)
        real, fake = batch[real_key].float(), y.float()
        metrics: Dict[str, torch.Tensor] = {}

        def critic(x: torch.Tensor) -> torch.Tensor:
            return disc(x).float()

        with autocast_to(real.device, compute_dtype):
            if gan_type == "vanilla":
                d_real, d_fake = critic(disc_in(real)), critic(disc_in(fake))
                loss = torch.mean(-torch.log(d_real + 1e-8) - torch.log(1.0 - d_fake + 1e-8))
                metrics["wd"] = torch.zeros((), device=loss.device)
            else:
                loss = torch.mean(critic(fake) - critic(real))       # …wasserstein_gp.py:314
                metrics["wd"] = -loss.detach()
                if gan_type == "wgan-gp":
                    b = real.shape[0] * (1 if mesh is None else mesh.size)
                    c = draw_mixing(b, generator, real.device)       # …gp.py:300-301
                    if mesh is not None:                              # the global batch's draw
                        c = c[batch_sharding(mesh, b)]
                    x_mid = (c * real + (1.0 - c) * fake).requires_grad_(True)
                    grad_x, = torch.autograd.grad(critic(x_mid).sum(), x_mid, create_graph=True)
                    norms = torch.sqrt((grad_x.float() ** 2).sum(dim=(1, 2)) + 1e-12)
                    gp = torch.mean(cfg.gp_lambda * (norms - 1.0) ** 2)   # …gp.py:306
                    metrics["gp"] = gp.detach()
                    loss = loss + gp
        state.disc_optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            all_reduce_grads(disc.parameters(), mesh)
        state.disc_optimizer.step()
        state.disc_optimizer.zero_grad(set_to_none=True)
        if gan_type == "wgan":
            clip_weights(disc)
        state.step += 1
        return state, _global({**metrics, "loss_d": loss}, mesh)

    return init_fn, g_step, d_step


def make_fused_adversarial_step(gen: nn.Module, disc: nn.Module, cfg: Config, train_kind: str,
                                gan_type: str = "wgan-gp", use_masks: bool = False,
                                compute_dtype: torch.dtype = torch.float32, mesh=None):
    """Returns ``(init_fn, step)``: ``step(state, batch, generator=None)``
    takes the G step when :func:`is_g_step` of ``state.step`` and the D step
    otherwise, a choice made on the host, and returns every key of
    :data:`FUSED_METRICS` (0 where the branch has none). It is the step
    :class:`spoofsv_torch.train.loop.Trainer` takes."""
    init_fn, g_step, d_step = make_adversarial_steps(gen, disc, cfg, train_kind, gan_type,
                                                     use_masks, compute_dtype, mesh)

    def step(state: AdvTrainState, batch: Batch, generator: Optional[torch.Generator] = None):
        if is_g_step(state.step, cfg.ratio):
            state, m = g_step(state, batch)
        else:
            state, m = d_step(state, batch, generator)
        zero = torch.zeros((), device=next(iter(m.values())).device)
        return state, {k: m.get(k, zero) for k in FUSED_METRICS}

    return init_fn, step
