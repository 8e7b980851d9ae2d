"""Eager autoregressive Text2Mel decoder: the plain version of the decode kernel.

Port of :func:`spoofsv_tpu.infer.decode.make_decoder`: a Python loop of
:meth:`MelSyn.decode_step` over ``n_frames`` frames (the JAX package scans
the same step). :mod:`spoofsv_torch.ops.decode_kernel` runs the same rollout
in one CUDA launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from spoofsv_torch.models.text2mel import MelSyn


def make_decoder(model: MelSyn, n_frames: int, monotonic: bool = True):
    """Returns ``decode(text_ids (B, N), spk_emb (B, E)) -> (Y (B, T, F),
    A (B, N, T), pma (B,))`` with ``T = n_frames``."""

    @torch.no_grad()
    def decode(text_ids: torch.Tensor, spk_emb: Optional[torch.Tensor],
               text_mask: Optional[torch.Tensor] = None):
        K, V = model.encode_text(text_ids)
        if spk_emb is not None:
            spk_emb = spk_emb.to(K.dtype)
        state = model.init_state(text_ids.shape[0], device=K.device)
        ys, attn = [], []
        for _ in range(n_frames):
            state, (y_t, a_t) = model.decode_step(state, K, V, spk_emb,
                                                  text_mask, monotonic)
            ys.append(y_t)
            attn.append(a_t)
        return torch.stack(ys, dim=1), torch.stack(attn, dim=2), state.pma

    return decode
