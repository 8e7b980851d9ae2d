"""GAN critics: ``Critic1D`` and its mel and linear instances.

Port of the critics of :mod:`spoofsv_tpu.models.discriminator` (the
reference's ``models/discriminator.py:6-80``: WGAN critics, no output
sigmoid by default). Layout is time-major ``(B, T, F)``; 1×1 convs are
:class:`~spoofsv_torch.models.layers.Conv1x1` in the reference ``state_dict``
schema; ``AvgPool1d(k)`` has window = stride = k with floor semantics;
``AdaptiveAvgPool1d(1)`` is the time mean.

The critic's highway block is pinned to ``"xla"``: the WGAN-GP penalty
differentiates the critic twice, and the highway kernels' backwards are
first-order only. ``forward(x, deterministic=True)`` keeps the JAX default;
the adversarial steps never pass ``deterministic``, so the critic's dropout
never fires in training, as in the JAX package. ``ResBasicBlock`` and ``DRS``
come with the anti-spoofing slice (ROADMAP A.7).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spoofsv_torch.models.layers import Conv1x1, HighwayConv, LayerNorm


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean over windows of ``k`` frames with stride ``k`` (a partial last window dropped)."""
    return F.avg_pool1d(x.transpose(1, 2), k, k).transpose(1, 2)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.05)


class Critic1D(nn.Module):
    """Shared topology of the mel and linear critics: ``pool1``/``pool2`` are
    (4, 2) for mel and (8, 4) for linear; ``pool2=None`` drops the second
    pool, ``extra_stage`` adds a conv/pool/LayerNorm stage of width 8,
    ``sigmoid_out`` gives the countermeasure variant."""

    def __init__(self, in_dim: int, disc_dim: int = 128, pool1: int = 4,
                 pool2: Optional[int] = 2, mid_dim: int = 4, extra_stage: bool = False,
                 sigmoid_out: bool = False, dropout_rate: float = 0.05):
        super().__init__()
        self.pool1, self.pool2 = pool1, pool2
        self.extra_stage = extra_stage
        self.sigmoid_out = sigmoid_out
        self.dropout_rate = dropout_rate
        self.conv1 = Conv1x1(in_dim, disc_dim)
        self.ln1 = LayerNorm(disc_dim)
        self.hc = HighwayConv(disc_dim, 3, 1, False, 0.0, gate_impl="xla")
        self.conv2 = Conv1x1(disc_dim, 64)
        self.ln2 = LayerNorm(64)
        self.conv3 = Conv1x1(64, 16)
        self.ln3 = LayerNorm(16)
        if extra_stage:
            self.conv3_2 = Conv1x1(16, 8)
            self.ln3_2 = LayerNorm(8)
        self.conv4 = Conv1x1(8 if extra_stage else 16, mid_dim)
        self.ln4 = LayerNorm(mid_dim)
        self.conv5 = Conv1x1(mid_dim, 1)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """``x``: (B, T, F) spectrogram → (B,) critic scalar."""
        def drop(v):
            return v if deterministic else F.dropout(v, self.dropout_rate, training=True)

        x = drop(self.ln1(self.conv1(x)))
        x = self.hc(x)
        x = self.ln2(_avg_pool(self.conv2(x), self.pool1))
        x = drop(_lrelu(x))
        x = self.conv3(x)
        if self.pool2:
            x = _avg_pool(x, self.pool2)
        x = self.ln3(x)
        if self.extra_stage:
            x = self.ln3_2(_avg_pool(self.conv3_2(x), 2))
        x = self.ln4(self.conv4(_lrelu(x)))
        x = self.conv5(_lrelu(x)).mean(dim=1)[..., 0]
        return torch.sigmoid(x) if self.sigmoid_out else x


def MelDisc(disc_dim: int = 128, sigmoid_out: bool = False, freq_bins: int = 80) -> Critic1D:
    """The coarse-mel critic (``models/discriminator.py:6-42``)."""
    return Critic1D(freq_bins, disc_dim, pool1=4, pool2=2, mid_dim=4, sigmoid_out=sigmoid_out)


def LinDisc(disc_dim: int = 128, sigmoid_out: bool = False, lin_bins: int = 513) -> Critic1D:
    """The linear-spectrogram critic (``models/discriminator.py:44-80``)."""
    return Critic1D(lin_bins, disc_dim, pool1=8, pool2=4, mid_dim=8, sigmoid_out=sigmoid_out)
