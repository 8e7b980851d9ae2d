"""Ordinary (non-adversarial) train and eval steps for Text2Mel and SSRN.

Port of the ordinary part of :mod:`spoofsv_tpu.train.steps`: teacher-forced
Text2Mel or SSRN with L1 + binary-divergence (+ guided attention) losses and
one Adam update per call. PyTorch runs eagerly, so a step is the forward,
``backward()`` and ``optimizer.step()``; the highway blocks go through the
process-wide implementation (:func:`spoofsv_torch.models.layers.gate_impl`).

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
from spoofsv_torch.train.losses import guided_attention_matrix, ssrn_losses, text2mel_losses
from spoofsv_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
TRAIN_KINDS = ("train_text2mel", "train_ssrn")


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam(α=2e-4, β=(0.5, 0.9), ε=1e-6): the update ``optax.adam`` makes,
    lr·m̂/(√v̂ + ε)."""
    a = cfg.adam
    return torch.optim.Adam(params, lr=a.alpha, betas=(a.beta_1, a.beta_2), eps=a.epsilon)


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
                  use_masks: bool):
    y = y.float()
    if train_kind == "train_text2mel":
        l1, bd, att = text2mel_losses(
            batch["mel"], y, a.float(), gaw(a.device),
            mel_mask=batch.get("mel_mask") if use_masks else None,
            att_mask=batch.get("att_mask") if use_masks else None)
        return l1 + bd + att, {"l1": l1, "bd": bd, "att": att}
    l1, bd = ssrn_losses(batch["lin"], y, batch.get("lin_mask") if use_masks else None)
    return l1 + bd, {"l1": l1, "bd": bd}


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
                       use_masks: bool = False):
    """Returns ``(init_fn, step_fn)``: ``init_fn()`` → a :class:`TrainState`
    with a fresh Adam over ``model``'s parameters; ``step_fn(state, batch)``
    → ``(state, metrics)``, updating the model and optimizer in place.
    Dropout (``cfg.apply_dropout``) draws from PyTorch's default generator."""
    if train_kind not in TRAIN_KINDS:
        raise ValueError(f"train_kind must be one of {TRAIN_KINDS}, got {train_kind!r}")
    gaw = guided_attention_table(cfg)
    has_dropout = cfg.apply_dropout

    def init_fn() -> TrainState:
        return TrainState(step=0, model=model, optimizer=make_optimizer(cfg, model.parameters()))

    def step_fn(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train(has_dropout)
        y, a = _gen_forward(model, batch, train_kind)
        loss, parts = _recon_losses(batch, y, a, gaw, train_kind, use_masks)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {**{k: v.detach() for k, v in parts.items()}, "loss": loss.detach()}

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
