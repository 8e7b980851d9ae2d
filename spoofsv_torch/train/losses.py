"""Training losses: L1 + binary divergence + guided attention.

Port of :mod:`spoofsv_tpu.train.losses`. With ``mask=None`` the numerics are
the reference's (it averages over zero-padded frames too); with masks,
padded frames are excluded.

Over a data-parallel ``mesh`` (:class:`spoofsv_torch.parallel.mesh.Mesh`)
each rank holds its rows of the global batch. A plain mean then needs
nothing: the ranks' shards are equal, so the mean of the shards' means is
the global mean. A masked mean divides by a count that depends on the data,
so its denominator is the ranks' mean count: each rank's loss is then its
numerator over the global count times the rank count, and the mean of the
ranks' losses (and of their gradients) is the global batch's.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def guided_attention_matrix(max_text_len: int, max_frame_num: int,
                            g: float = 0.2) -> np.ndarray:
    """W[n, t] = 1 − exp(−(t/T − n/N)² / (2g²)), f32 (N, T)."""
    n = np.arange(max_text_len)[:, None] / max_text_len
    t = np.arange(max_frame_num)[None, :] / max_frame_num
    return (1.0 - np.exp(-((t - n) ** 2) / (2.0 * g * g))).astype(np.float32)


def _count(m: torch.Tensor, mesh) -> torch.Tensor:
    """The mask's count, as the ranks' mean count over a mesh."""
    c = m.sum()
    return c if mesh is None else mesh.mean(c)


def _masked_mean(v: torch.Tensor, mask: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    if mask is None:
        return v.mean()
    m = mask[..., None].to(v.dtype)
    return (v * m).sum() / (_count(m, mesh) * v.shape[-1])


def l1_loss(target: torch.Tensor, pred: torch.Tensor,
            mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """mean |target − pred|; ``mask``: (B, T) validity."""
    return _masked_mean((target - pred).abs(), mask, mesh)


def binary_divergence(target: torch.Tensor, pred: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """BCE on sigmoid outputs. The log arguments are floored with
    ``maximum(·, 1e-8)``, not offset by ``+1e-8``: ``1 + 1e-8`` is 1.0 in f32,
    so the offset form gives ``log(0)`` for a saturated sigmoid, while the
    floor equals the reference wherever the reference is finite."""
    pred = pred.clamp(0.0, 1.0)
    floor = torch.tensor(1e-8, dtype=pred.dtype, device=pred.device)
    bd = (-target * torch.log(torch.maximum(pred, floor))
          - (1.0 - target) * torch.log(torch.maximum(1.0 - pred, floor)))
    return _masked_mean(bd, mask, mesh)


def guided_attention_loss(attention: torch.Tensor, gaw: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """sum(A · W[:N, :T]) / count. ``attention``: (B, N, T); ``gaw``: the full
    (MAX_N, MAX_T) table; ``mask``: (B, N, T) validity."""
    _, n, t = attention.shape
    weighted = attention * gaw[:n, :t].to(attention.device, attention.dtype)[None]
    if mask is None:
        return weighted.sum() / weighted.numel()
    m = mask.to(weighted.dtype)
    return (weighted * m).sum() / _count(m, mesh)


def text2mel_losses(mel_gt, pred, attention, gaw, mel_mask=None, att_mask=None,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (l1_loss(mel_gt, pred, mel_mask, mesh), binary_divergence(mel_gt, pred, mel_mask, mesh),
            guided_attention_loss(attention, gaw, att_mask, mesh))


def ssrn_losses(lin_gt, pred, mask=None, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    return l1_loss(lin_gt, pred, mask, mesh), binary_divergence(lin_gt, pred, mask, mesh)
