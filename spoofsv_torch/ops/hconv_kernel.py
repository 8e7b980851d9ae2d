"""K4 and K5: whole highway blocks (conv, LayerNorms, gate) in one pass.

Port of :mod:`spoofsv_tpu.ops.pallas_conv`. Both kernels are one template in
``csrc/hconv_pair.cu``: K4 (``_hconv_kernel``) is its one-layer instance and
runs one block; K5 (``_hconv_pair_kernel``) runs two consecutive blocks in
one launch, the activation between them in an L2-resident scratch tile.
:func:`highway_conv_plain` ports ``highway_conv_reference`` and
:func:`highway_pair_plain` the chained pair reference.

The conv weight is the reference schema ``(2C, C, K)`` (``Conv1d``). The
kernels take it as one ``(2·CH, K·C)`` slice per CTA of their cluster
(:func:`pair_weight_operand`), split into TF32 hi and lo parts for f32
(:func:`tf32_split`), prepared once per call here. Both wrappers are
differentiable: the forward launches the kernel for CUDA tensors (the plain
version for CPU tensors) and the backward is the gradient of the plain
version recomputed from the saved inputs, as ``fused_highway_conv_ad`` and
``fused_highway_conv_pair_ad`` do.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from spoofsv_torch.ops import _build
from spoofsv_torch.ops.gate_kernel import LN_EPS, aligned, highway_gate_plain, recompute_grads

hconv_kernel = _build.LaunchCounter()        # K4
hconv_pair_kernel = _build.LaunchCounter()   # K5


def pad_left(kernel_size: int, dilation: int, causal: bool) -> int:
    """Zero frames before the sequence: all of the conv's span when causal,
    half of it (SAME) otherwise."""
    span = dilation * (kernel_size - 1)
    return span if causal else span // 2


def highway_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       ln1_scale, ln1_bias, ln2_scale, ln2_bias, dilation: int = 1,
                       causal: bool = False, eps: float = LN_EPS) -> torch.Tensor:
    """One highway block: ``x`` (B, T, C), ``weight`` (2C, C, K) → (B, T, C).

    The conv runs in f32 on the operands' values (the TPU reference's
    ``preferred_element_type=f32``), then the two-pass LayerNorm gate."""
    K = weight.shape[-1]
    left = pad_left(K, dilation, causal)
    inp = F.pad(x.float().transpose(1, 2), (left, dilation * (K - 1) - left))
    h = F.conv1d(inp, weight.float(), bias.float(), dilation=dilation).transpose(1, 2)
    return highway_gate_plain(h, x, ln1_scale, ln1_bias, ln2_scale, ln2_bias, eps)


def highway_pair_plain(x, wa, ba, s1a, b1a, s2a, b2a, wb, bb, s1b, b1b, s2b, b2b,
                       dilation_a: int = 1, dilation_b: int = 1,
                       causal: bool = False) -> torch.Tensor:
    """Two chained :func:`highway_conv_plain` blocks (y₁ in ``x.dtype`` between them)."""
    y1 = highway_conv_plain(x, wa, ba, s1a, b1a, s2a, b2a, dilation_a, causal)
    return highway_conv_plain(y1, wb, bb, s1b, b1b, s2b, b2b, dilation_b, causal)


def pack_ln(s1, b1, s2, b2) -> torch.Tensor:
    """K4's and K5's (4, C) f32 LayerNorm operand: LN1 scale, LN1 bias, LN2 scale, LN2 bias."""
    return torch.stack([s1, b1, s2, b2]).detach().float().contiguous()


# The tile (csrc/hconv_pair.cu): layer A runs over PAIR_ROWS rows of y1 and
# layer B over the PAIR_ROWS - d_b·(K-1) output frames they cover (K4: the
# PAIR_ROWS rows are the output frames); a CTA owns PAIR_CHANNELS channels of
# h1 and h2 (fewer when C is smaller)
PAIR_ROWS = 128
PAIR_CHANNELS = 128


class PairPlan(NamedTuple):
    """K4's or K5's tiling of one call."""
    layers: int          # 1 (K4) or 2 (K5)
    rows_a: int          # layer A's rows per tile (y1 rows; K4: output frames)
    rows_out: int        # output frames per tile
    rows_b: int          # layer B's rows per tile: rows_out rounded up to 64 (K4: 0)
    tiles: int           # tiles per utterance
    cluster: int         # CTAs per tile, along the channels
    channels: int        # channels of h1 (and of h2) per CTA
    stages: int          # depth of the operand ring
    smem_bytes: int      # dynamic shared memory per CTA

    def executed_over_useful(self, T: int) -> float:
        """Rows the layers compute over the rows the blocks need (layers·T)."""
        return self.tiles * (self.rows_a + self.rows_b) / (self.layers * T)


def pair_tile_plan(C: int, K: int, dilation_b: int, T: int, dtype: torch.dtype,
                   layers: int = 2) -> PairPlan:
    """The tile plan of K5 (``layers=2``) or K4 (``layers=1``), as
    ``csrc/hconv_pair.cu`` lays it out. K5: a halo that leaves layer B no row
    (``d_b·(K-1) >= 128``) gives ``rows_out < 1``, which the kernel refuses at
    launch. K4: 128 output frames a tile whatever the conv's span (each tap's
    rows are fetched at their own offset), so ``K`` and ``dilation_b`` do not
    enter."""
    if layers not in (1, 2):
        raise ValueError(f"a highway tile runs 1 or 2 layers, got {layers}")
    ch = min(C, PAIR_CHANNELS)
    rows_out = PAIR_ROWS - dilation_b * (K - 1) if layers == 2 else PAIR_ROWS
    split = dtype == torch.float32           # 3xTF32: weight hi and lo
    stages = 5 if split else 8
    # per stage: 64 bytes of each operand row and of each of the 2·ch weight rows
    ring = stages * (PAIR_ROWS * 64 + (2 if split else 1) * 2 * ch * 64)
    cluster = C // ch
    # + alignment slack, the cluster's row-sum exchange and a barrier per stage
    smem = 1024 + ring + 4 * 2 * cluster * PAIR_ROWS * 2 + 8 * stages
    rows_b = 0 if layers == 1 else PAIR_ROWS if rows_out > 64 else 64
    return PairPlan(layers, PAIR_ROWS, rows_out, rows_b, -(-T // max(rows_out, 1)), cluster, ch,
                    stages, smem)


def tf32_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``t`` → (hi, lo), both TF32 (the low 13 mantissa bits zero): hi is
    ``t`` rounded to the nearest TF32, ties away from zero (as the kernel's
    ``cvt.rna`` rounds its operand), lo is ``t - hi`` rounded likewise, so
    hi + lo is ``t`` to 2⁻²² relative and hi·w_hi + hi·w_lo + lo·w_hi
    (3xTF32) holds an f32 product to about that."""
    def round_tf32(v: torch.Tensor) -> torch.Tensor:
        return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    t = t.float()
    hi = round_tf32(t)
    return hi, round_tf32(t - hi)


def pair_weight_operand(weight: torch.Tensor, cluster: int) -> torch.Tensor:
    """(..., 2C, C, K) → K5's (..., cluster, 2·CH, K·C), CH = C / cluster: CTA
    r's row j < CH is h1 column r·CH + j, row CH + j is h2 column
    C + r·CH + j, and column k·C + i holds ``weight[..., o, i, k]``."""
    *lead, two_c, c, k = weight.shape
    w = weight.detach().transpose(-1, -2).reshape(*lead, 2, cluster, c // cluster, k * c)
    return w.transpose(-4, -3).reshape(*lead, cluster, two_c // cluster, k * c)


def _check(x: torch.Tensor, *weights: torch.Tensor) -> int:
    B, T, C = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"highway conv kernels take f32 or bf16, got {x.dtype}")
    if C < 32 or C > 1024 or C & (C - 1):
        # C >= 32: a CTA's h1 and h2 columns (2·min(C, 128)) fill at least a wgmma n64
        raise ValueError(f"highway conv kernels need C a power of two in [32, 1024], got {C}")
    K = weights[0].shape[-1]
    for w in weights:
        if tuple(w.shape) != (2 * C, C, K):
            raise ValueError(f"conv weight {tuple(w.shape)} is not (2C, C, K) for C={C}, K={K}")
    return K


def _weight_parts(weight: torch.Tensor, cluster: int, dtype: torch.dtype):
    """The kernels' weight operand (:func:`pair_weight_operand`): f32 as its
    TF32 (hi, lo) parts; bf16 has no lo part and passes hi twice."""
    w = pair_weight_operand(weight, cluster)
    return tf32_split(w) if dtype == torch.float32 else (w.to(dtype),) * 2


def hconv_launch(x, weight, bias, s1, b1, s2, b2, dilation: int, causal: bool,
                 eps: float = LN_EPS) -> torch.Tensor:
    """Launch K4, the one-layer instance of ``csrc/hconv_pair.cu``, on CUDA
    tensors; raises on anything the kernel does not take."""
    K = _check(x, weight)
    B, T, C = x.shape
    lib = _build.load("hconv_pair")
    plan = pair_tile_plan(C, K, dilation, T, x.dtype, layers=1)
    x = aligned(x)
    hi, lo = _weight_parts(weight, plan.cluster, x.dtype)
    ops = [x, hi, lo, bias.detach().float().contiguous(), pack_ln(s1, b1, s2, b2)]
    out = torch.empty_like(x)
    _build.require_cuda(*ops, out)
    err = lib.spoofsv_hconv_launch(_build.DTYPE_CODES[x.dtype], *(t.data_ptr() for t in ops),
                                   out.data_ptr(), B, T, C, K, dilation,
                                   pad_left(K, dilation, causal), plan.tiles, eps,
                                   _build.stream_ptr(x.device))
    _build.check(lib, "hconv_pair", err, "hconv_kernel")
    hconv_kernel.launches += 1
    return out


def hconv_pair_launch(x, wa, ba, s1a, b1a, s2a, b2a, wb, bb, s1b, b1b, s2b, b2b,
                      dilation_a: int, dilation_b: int, causal: bool,
                      eps: float = LN_EPS) -> torch.Tensor:
    """Launch K5 on CUDA tensors; raises on anything the kernel does not take
    (including a layer-B halo that leaves its tile no output row)."""
    K = _check(x, wa, wb)
    B, T, C = x.shape
    lib = _build.load("hconv_pair")
    plan = pair_tile_plan(C, K, dilation_b, T, x.dtype)
    x = aligned(x)
    hi, lo = _weight_parts(torch.stack([wa, wb]), plan.cluster, x.dtype)   # both layers at once
    ops = [x, hi[0], lo[0], ba.detach().float().contiguous(), pack_ln(s1a, b1a, s2a, b2a),
           hi[1], lo[1], bb.detach().float().contiguous(), pack_ln(s1b, b1b, s2b, b2b),
           torch.empty(B, plan.tiles, plan.rows_a, C, dtype=x.dtype, device=x.device)]
    out = torch.empty_like(x)
    _build.require_cuda(*ops, out)
    err = lib.spoofsv_hconv_pair_launch(_build.DTYPE_CODES[x.dtype],
                                        *(t.data_ptr() for t in (*ops, out)), B, T, C, K,
                                        dilation_a, dilation_b, pad_left(K, dilation_a, causal),
                                        pad_left(K, dilation_b, causal), plan.rows_out,
                                        plan.tiles, eps, _build.stream_ptr(x.device))
    _build.check(lib, "hconv_pair", err, "hconv_pair_kernel")
    hconv_pair_kernel.launches += 1
    return out


class _FusedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, s1, b1, s2, b2, dilation, causal):
        ctx.save_for_backward(x, weight, bias, s1, b1, s2, b2)
        ctx.static = (dilation, causal)
        if x.device.type == "cpu":
            return highway_conv_plain(x, weight, bias, s1, b1, s2, b2, dilation, causal)
        return hconv_launch(x, weight, bias, s1, b1, s2, b2, dilation, causal)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, highway_conv_plain, grad_out, *ctx.static) + (None, None)


class _FusedPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wa, ba, s1a, b1a, s2a, b2a, wb, bb, s1b, b1b, s2b, b2b,
                dilation_a, dilation_b, causal):
        args = (x, wa, ba, s1a, b1a, s2a, b2a, wb, bb, s1b, b1b, s2b, b2b)
        ctx.save_for_backward(*args)
        ctx.static = (dilation_a, dilation_b, causal)
        if x.device.type == "cpu":
            return highway_pair_plain(*args, *ctx.static)
        return hconv_pair_launch(*args, *ctx.static)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, highway_pair_plain, grad_out, *ctx.static) + (None,) * 3


def fused_highway_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       ln1_scale, ln1_bias, ln2_scale, ln2_bias, dilation: int = 1,
                       causal: bool = False) -> torch.Tensor:
    """One whole highway block, ``x`` (B, T, C), ``weight`` (2C, C, K): K4 on
    CUDA tensors, :func:`highway_conv_plain` on CPU tensors."""
    return _FusedConv.apply(x, weight, bias, ln1_scale, ln1_bias, ln2_scale, ln2_bias,
                            dilation, causal)


def fused_highway_conv_pair(x, wa, ba, s1a, b1a, s2a, b2a, wb, bb, s1b, b1b, s2b, b2b,
                            dilation_a: int = 1, dilation_b: int = 1,
                            causal: bool = False) -> torch.Tensor:
    """Two consecutive highway blocks (same C, K and causality): K5 on CUDA
    tensors, :func:`highway_pair_plain` on CPU tensors. Computes what two
    chained :func:`fused_highway_conv` calls compute, up to summation order."""
    return _FusedPair.apply(x, wa, ba, s1a, b1a, s2a, b2a, wb, bb, s1b, b1b, s2b, b2b,
                            dilation_a, dilation_b, causal)
