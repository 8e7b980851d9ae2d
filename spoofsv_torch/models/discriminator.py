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
never fires in training, as in the JAX package; the countermeasure's step
passes it with its own ``torch.Generator``.

``ResBasicBlock`` and ``DRS`` are the small 2-D ResNet countermeasure
(``models/discriminator.py:86-178`` of the reference). They take the JAX
package's NHWC input and compute in NCHW; their BatchNorm follows flax's:
momentum 0.99 on the running statistics (torch's 0.01), the batch's biased
fast variance both to normalize and to update the running variance.
"""

from __future__ import annotations

from typing import Optional, Tuple

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

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: (B, T, F) spectrogram → (B,) critic scalar. Dropout (when
        not ``deterministic``) keeps each unit with probability 1 − rate,
        drawn from ``generator`` (the global generator if None), and scales
        kept units by 1 / (1 − rate), as flax's ``nn.Dropout``."""
        def drop(v):
            if deterministic:
                return v
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(v.shape, generator=generator, device=v.device) < keep
            return torch.where(mask, v / keep, 0.0)

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


class BatchNormFlax(nn.BatchNorm2d):
    """``nn.BatchNorm`` of flax over the channel axis of an NCHW (or NC)
    tensor: in training the batch's biased variance E[x²] − E[x]² (flax's
    fast variance) normalizes and updates ``running_var``, with
    ``running = 0.99·running + 0.01·batch`` (flax's momentum 0.99). The
    state-dict keys are ``nn.BatchNorm2d``'s, so a reference state dict loads."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.01)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected a 2-D or 4-D input, got {x.dim()}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(axes)
            var = ((x * x).mean(axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class ResBasicBlock(nn.Module):
    """Pre-activation 2-D residual block (``models/discriminator.py:86-104``):
    BN → leaky ReLU → 3×3 conv (no bias), twice, plus the input. NCHW."""

    def __init__(self, planes: int):
        super().__init__()
        self.bn1 = BatchNormFlax(planes)
        self.cnn1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNormFlax(planes)
        self.cnn2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        for conv in (self.cnn1, self.cnn2):
            nn.init.kaiming_normal_(conv.weight, nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cnn1(_lrelu(self.bn1(x)))
        return x + self.cnn2(_lrelu(self.bn2(h)))


class DRS(nn.Module):
    """Small 2-D ResNet countermeasure (``models/discriminator.py:106-178``).

    ``input_hw`` is the (H, W) of the spectrogram image the model takes: it
    sets each dilated conv's padding (VALID where the map is larger than
    twice the dilation, else SAME, as the JAX module pads where the
    reference's VALID conv would underflow) and the width of ``fc``. The
    input is NHWC ``(B, H, W, 1)``, the output ``(B, num_classes)``: a
    softmax, or the logits with ``focal_loss``. Train mode (``.train()``)
    normalizes with batch statistics and updates the running ones."""

    WIDTHS = (8, 16, 32, 64)
    DILATIONS = ((2, 2), (4, 4), (8, 8), (9, 6))

    def __init__(self, input_hw: Tuple[int, int], num_classes: int = 2, resnet_blocks: int = 1,
                 focal_loss: bool = False):
        super().__init__()
        self.focal_loss = focal_loss
        self.expansion = nn.Conv2d(1, 8, 3, padding=1)
        h, w = input_hw
        self.pads = []
        for bi, (width, d) in enumerate(zip(self.WIDTHS, self.DILATIONS)):
            for r in range(resnet_blocks):
                self.add_module(f"block{bi + 1}_{r}", ResBasicBlock(width))
            h, w = h // 2, w // 2
            nxt = self.WIDTHS[bi + 1] if bi + 1 < len(self.WIDTHS) else 64
            fits = h > 2 * d[0] and w > 2 * d[1]
            self.pads.append((0, 0) if fits else d)
            if fits:
                h, w = h - 2 * d[0], w - 2 * d[1]
            self.add_module(f"cnn{bi + 1}", nn.Conv2d(width, nxt, 3, dilation=d,
                                                      padding=self.pads[-1]))
        self.resnet_blocks = resnet_blocks
        self.fc = nn.Linear(64 * h * w, 100)
        self.bn = BatchNormFlax(100)
        self.fc_out = nn.Linear(100, num_classes)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.expansion(x.permute(0, 3, 1, 2))
        for bi in range(len(self.WIDTHS)):
            for r in range(self.resnet_blocks):
                x = getattr(self, f"block{bi + 1}_{r}")(x)
            x = getattr(self, f"cnn{bi + 1}")(F.avg_pool2d(x, 2, 2))
        x = self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))   # flax flattens NHWC
        x = self.fc_out(_lrelu(self.bn(x)))
        return x if self.focal_loss else torch.softmax(x, dim=-1)
