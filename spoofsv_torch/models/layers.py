"""Core network blocks: gated highway convolutions with incremental decoding.

Port of :mod:`spoofsv_tpu.models.layers`. Layout is time-major ``(B, T, C)``;
parameters follow the reference torch ``state_dict`` schema that
``spoofsv_tpu.utils.torch_export`` emits (``Conv1d`` weights ``(out, in, k)``,
LayerNorm ``weight``/``bias``).

The full-sequence highway block has four implementations, chosen
process-wide as in the JAX package (``set_default_gate_impl``, or the
:func:`gate_impl` context manager): ``"xla"`` (plain PyTorch), ``"pallas"``
(the conv in PyTorch, then the gate kernel K6), ``"fused_conv"`` (the whole
block in kernel K4) and ``"fused_pair"`` (:func:`highway_pair` runs two
consecutive blocks in kernel K5; a block without a fusable partner runs K4).
The names are the JAX package's. CPU tensors take each kernel's plain version.
A block built with its own ``gate_impl`` runs that one whatever the process
default (the critics pin ``"xla"``: the gradient penalty differentiates them
twice, which the kernels' backwards do not support).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spoofsv_torch.ops.gate_kernel import fused_highway_gate
from spoofsv_torch.ops.hconv_kernel import (fused_highway_conv, fused_highway_conv_pair,
                                            pad_left)

LN_EPS = 1e-5   # torch.nn.LayerNorm default epsilon
GATE_IMPLS = ("xla", "pallas", "fused_conv", "fused_pair")
PALLAS_BLOCK_T = 256   # the JAX kernels' frame tile, which decides what they fuse
_default_gate_impl = "xla"


def set_default_gate_impl(impl: str) -> None:
    """Select the full-sequence highway implementation for the whole process."""
    global _default_gate_impl
    if impl not in GATE_IMPLS:
        raise ValueError(f"highway impl must be one of {GATE_IMPLS}, got {impl!r}")
    _default_gate_impl = impl


def get_default_gate_impl() -> str:
    return _default_gate_impl


@contextlib.contextmanager
def gate_impl(impl: str) -> Iterator[None]:
    """Run a block of code under ``impl``, restoring the previous one after."""
    before = get_default_gate_impl()
    set_default_gate_impl(impl)
    try:
        yield
    finally:
        set_default_gate_impl(before)


def functional_dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    if not training or rate <= 0.0:
        return x
    return F.dropout(x, rate, training=True)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's fast-variance form.

    ``var = max(E[x²] − μ², 0)``, eps 1e-5, statistics in f32 — what flax
    ``nn.LayerNorm`` and the decode kernel compute. ``F.layer_norm``'s
    two-pass variance differs at the ulp level, which an AR loop amplifies.
    """

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        mean2 = (x32 * x32).mean(-1, keepdim=True)
        var = (mean2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight.float()
        return ((x32 - mean) * mul + self.bias.float()).to(x.dtype)


class Conv1x1(nn.Module):
    """``Conv1d(k=1)`` applied in ``(..., C)`` layout: a dense layer whose
    weight keeps the reference's ``(out, in, 1)`` shape."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        nn.init.kaiming_normal_(self.weight, nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[..., 0], self.bias)


class LNDense(nn.Module):
    """A dense layer (a ``Conv1d(k=1)``, :class:`Conv1x1`) followed by
    :class:`LayerNorm`: the reference's ``conv(k=1) → LayerNorm`` idiom
    (``models/TTSModel.py:115-118``), the JAX package's ``LNDense``; its
    parameters are ``dense.{weight,bias}`` and ``ln.{weight,bias}``."""

    def __init__(self, in_dim: int, features: int, use_ln: bool = True):
        super().__init__()
        self.dense = Conv1x1(in_dim, features)
        self.ln = LayerNorm(features) if use_ln else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense(x)
        return self.ln(x) if self.ln is not None else x


class HighwayConv(nn.Module):
    """Gated ("highway") 1-D convolution.

    ``y = σ(LN1(h1))·LN2(h2) + (1−σ(LN1(h1)))·x`` where ``[h1, h2]`` is a
    width-``2·dim`` conv of the input. The causal variant left-pads
    ``dilation·(kernel_size−1)`` zeros. ``gate_impl`` (one of
    :data:`GATE_IMPLS`) overrides the process-wide implementation for this
    block; None follows it.
    """

    def __init__(self, dim: int, kernel_size: int = 3, dilation: int = 1,
                 causal: bool = False, dropout_rate: float = 0.0,
                 gate_impl: Optional[str] = None):
        super().__init__()
        if gate_impl is not None and gate_impl not in GATE_IMPLS:
            raise ValueError(f"highway impl must be one of {GATE_IMPLS}, got {gate_impl!r}")
        self.gate_impl = gate_impl
        self.dim = dim
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.causal = causal
        self.dropout_rate = dropout_rate
        self.conv = nn.Conv1d(dim, 2 * dim, kernel_size, dilation=dilation)
        nn.init.kaiming_normal_(self.conv.weight, nonlinearity="relu")
        nn.init.zeros_(self.conv.bias)
        self.ln1 = LayerNorm(dim)
        self.ln2 = LayerNorm(dim)

    @property
    def pad(self) -> int:
        return self.dilation * (self.kernel_size - 1)

    def _gate(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h1, h2 = h.chunk(2, dim=-1)
        g = torch.sigmoid(self.ln1(h1))
        return g * self.ln2(h2) + (1.0 - g) * x

    def ln_params(self) -> Tuple[torch.Tensor, ...]:
        return self.ln1.weight, self.ln1.bias, self.ln2.weight, self.ln2.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward; ``x``: (B, T, C)."""
        impl = self.gate_impl or _default_gate_impl
        if impl in ("fused_conv", "fused_pair") and self.pad <= min(PALLAS_BLOCK_T, x.shape[1]):
            # whole block in K4 (a "fused_pair" block with no fusable partner
            # lands here too); shorter inputs than the conv's halo take the
            # plain block, as in the JAX package
            out = fused_highway_conv(x, self.conv.weight, self.conv.bias, *self.ln_params(),
                                     self.dilation, self.causal)
            return functional_dropout(out, self.dropout_rate, self.training)
        left = pad_left(self.kernel_size, self.dilation, self.causal)
        inp = F.pad(x.transpose(1, 2), (left, self.pad - left))
        h = F.conv1d(inp, self.conv.weight, self.conv.bias,
                     dilation=self.dilation).transpose(1, 2)
        if impl == "pallas":
            out = fused_highway_gate(h, x, *self.ln_params())
        else:
            out = self._gate(h, x)
        return functional_dropout(out, self.dropout_rate, self.training)

    # -- incremental decoding ------------------------------------------------
    def init_cache(self, batch: int, device=None, dtype=None) -> torch.Tensor:
        """Buffer of the last ``pad`` inputs; zeros == left zero-padding."""
        assert self.causal, "cache only makes sense for causal convs"
        return torch.zeros(batch, max(self.pad, 1), self.dim, device=device,
                           dtype=dtype or self.conv.weight.dtype)

    def step(self, x_t: torch.Tensor, cache: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One causal step; ``x_t``: (B, C), cache: (B, pad, C) of past inputs.

        The k taps are concatenated into one (B, k·C) row so the conv is a
        single matmul against the ``(k·C, 2C)`` kernel.
        """
        k, d, c = self.kernel_size, self.dilation, self.dim
        taps = [cache[:, i * d, :] for i in range(k - 1)] + [x_t]
        stacked = torch.cat(taps, dim=-1)
        w = self.conv.weight.permute(2, 1, 0).reshape(k * c, 2 * c)
        h = stacked @ w + self.conv.bias
        out = self._gate(h, x_t)
        if self.pad > 0:
            cache = torch.cat([cache[:, 1:, :], x_t[:, None, :]], dim=1)
        return out, cache


def pair_fusable(a: HighwayConv, b: HighwayConv, T: int, deterministic: bool) -> bool:
    """Whether the JAX package's ``highway_pair`` fuses blocks ``a`` → ``b``
    over ``T`` frames: same width, causality and kernel size; no dropout
    between them in training; and the combined halo within the JAX kernel's
    frame tile ``min(256, max(8, T))`` on each side. The CUDA kernel takes
    any such pair whatever its own tile."""
    span_a, span_b = a.pad, b.pad
    block_t = min(PALLAS_BLOCK_T, max(8, T))
    pa_l = pad_left(a.kernel_size, a.dilation, a.causal)
    pb_l = pad_left(b.kernel_size, b.dilation, b.causal)
    return (a.dim == b.dim and a.causal == b.causal and a.kernel_size == b.kernel_size
            and (deterministic or (a.dropout_rate == 0.0 and b.dropout_rate == 0.0))
            and pa_l + pb_l <= block_t
            and (span_a - pa_l) + (span_b - pb_l) <= block_t)


def highway_pair(a: HighwayConv, b: HighwayConv, x: torch.Tensor) -> torch.Tensor:
    """``b(a(x))``; under ``"fused_pair"`` (``a``'s own impl, else the
    process-wide one) one K5 pass where the JAX package fuses the pair
    (:func:`pair_fusable`)."""
    if ((a.gate_impl or _default_gate_impl) == "fused_pair"
            and pair_fusable(a, b, x.shape[1], deterministic=not a.training)):
        out = fused_highway_conv_pair(x, a.conv.weight, a.conv.bias, *a.ln_params(),
                                      b.conv.weight, b.conv.bias, *b.ln_params(),
                                      a.dilation, b.dilation, a.causal)
        out = functional_dropout(out, a.dropout_rate, a.training)
        return functional_dropout(out, b.dropout_rate, b.training)
    return b(a(x))


class HighwayDilationStack(nn.Module):
    """Four stacked k=3 highway convs, dilations 1/3/9/27."""

    DILATIONS = (1, 3, 9, 27)

    def __init__(self, dim: int, causal: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        for i, d in enumerate(self.DILATIONS):
            setattr(self, f"hc{i + 1}", HighwayConv(dim, 3, d, causal, dropout_rate))

    @property
    def blocks(self):
        return [self.hc1, self.hc2, self.hc3, self.hc4]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under "fused_pair" the (1, 3) and (9, 27) blocks fuse two by two
        x = highway_pair(self.hc1, self.hc2, x)
        return highway_pair(self.hc3, self.hc4, x)

    def init_cache(self, batch: int, device=None, dtype=None):
        return tuple(b.init_cache(batch, device, dtype) for b in self.blocks)

    def step(self, x_t: torch.Tensor, caches):
        new = []
        for blk, c in zip(self.blocks, caches):
            x_t, c2 = blk.step(x_t, c)
            new.append(c2)
        return x_t, tuple(new)
