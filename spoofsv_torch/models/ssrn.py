"""SSRN: spectrogram super-resolution network.

Port of :mod:`spoofsv_tpu.models.ssrn`: coarse mel (B, T, 80) → linear
magnitude (B, 4T, 513). ×2 temporal upsampling is ``ConvTranspose1d(k=2,
s=2)`` twice, with the reference's weight layout ``(in, out, k)`` — the JAX
package stores that kernel k-flipped, and ``torch_export`` un-flips it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spoofsv_torch.models.layers import Conv1x1, HighwayConv, LayerNorm, highway_pair


class Upsample2x(nn.Module):
    """ConvTranspose1d(k=2, s=2) + two highway convs."""

    def __init__(self, dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.deconv = nn.ConvTranspose1d(dim, dim, 2, stride=2)
        self.hc1 = HighwayConv(dim, 3, 1, False, dropout_rate)
        self.hc2 = HighwayConv(dim, 3, 3, False, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv_transpose1d(x.transpose(1, 2), self.deconv.weight,
                               self.deconv.bias, stride=2).transpose(1, 2)
        return highway_pair(self.hc1, self.hc2, x)


class SSRN(nn.Module):
    """(B, T, freq_bins) coarse mel → (B, 4T, output_bins) in (0, 1)."""

    def __init__(self, freq_bins: int = 80, output_bins: int = 513,
                 ssrn_dim: int = 256, dropout_rate: float = 0.0):
        super().__init__()
        d = ssrn_dim
        self.dropout_rate = dropout_rate
        widths = [(freq_bins, d), (d, 2 * d), (2 * d, output_bins),
                  (output_bins, output_bins), (output_bins, output_bins),
                  (output_bins, output_bins)]
        for i, (a, b) in enumerate(widths, start=1):
            setattr(self, f"conv{i}", Conv1x1(a, b))
            setattr(self, f"ln{i}", LayerNorm(b))
        self.hc1 = HighwayConv(d, 3, 1, False, dropout_rate)
        self.hc2 = HighwayConv(d, 3, 3, False, dropout_rate)
        self.ups1 = Upsample2x(d, dropout_rate)
        self.ups2 = Upsample2x(d, dropout_rate)
        self.hc3 = HighwayConv(2 * d, 3, 1, False, dropout_rate)
        self.hc4 = HighwayConv(2 * d, 3, 1, False, dropout_rate)

    def _ln_dense(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return getattr(self, f"ln{i}")(getattr(self, f"conv{i}")(x))

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.dropout_rate > 0:
            x = F.dropout(x, self.dropout_rate, training=True)
        return x

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self._drop(self._ln_dense(mel, 1))
        x = highway_pair(self.hc1, self.hc2, x)
        x = self.ups2(self.ups1(x))
        x = self._drop(self._ln_dense(x, 2))
        x = highway_pair(self.hc3, self.hc4, x)
        x = self._drop(self._ln_dense(x, 3))
        x = self._drop(torch.relu(self._ln_dense(x, 4)))
        x = torch.relu(self._ln_dense(x, 5))
        return torch.sigmoid(self._ln_dense(x, 6))
