"""K4 and K5: whole highway blocks (conv, LayerNorms, gate) in one pass.

Port of :mod:`spoofsv_tpu.ops.pallas_conv`. K4 (``_hconv_kernel`` →
``csrc/highway.cu::hconv_kernel``) runs one block; K5
(``_hconv_pair_kernel`` → ``csrc/highway.cu::hconv_pair_kernel``) runs two
consecutive blocks with the activation between them kept on chip.
:func:`highway_conv_plain` ports ``highway_conv_reference`` and
:func:`highway_pair_plain` the chained pair reference.

The conv weight is the reference schema ``(2C, C, K)`` (``Conv1d``); the
kernels take it as ``(K·C, 2C)``, reshaped once per call here. Both wrappers
are differentiable: the forward launches the kernel for CUDA tensors (the
plain version for CPU tensors) and the backward is the gradient of the plain
version recomputed from the saved inputs, as ``fused_highway_conv_ad`` and
``fused_highway_conv_pair_ad`` do.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from spoofsv_torch.ops import _build
from spoofsv_torch.ops.gate_kernel import (LN_EPS, aligned, highway_gate_plain, pack_ln,
                                           recompute_grads)

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


def _kernel_operand(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2C, C, K) → the kernels' (K·C, 2C), row k·C + i, column o = weight[o, i, k]."""
    two_c, c, k = weight.shape
    return aligned(weight.detach().permute(2, 1, 0).reshape(k * c, two_c).to(dtype))


def _check(x: torch.Tensor, *weights: torch.Tensor) -> int:
    B, T, C = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"highway conv kernels take f32 or bf16, got {x.dtype}")
    if C < 16 or C > 1024 or C & (C - 1):
        raise ValueError(f"highway conv kernels need C a power of two in [16, 1024], got {C}")
    K = weights[0].shape[-1]
    for w in weights:
        if tuple(w.shape) != (2 * C, C, K):
            raise ValueError(f"conv weight {tuple(w.shape)} is not (2C, C, K) for C={C}, K={K}")
    return K


def hconv_launch(x, weight, bias, s1, b1, s2, b2, dilation: int, causal: bool,
                 eps: float = LN_EPS) -> torch.Tensor:
    """Launch K4 on CUDA tensors; raises on anything the kernel does not take."""
    K = _check(x, weight)
    lib = _build.load("highway")
    B, T, C = x.shape
    x = aligned(x)
    w = _kernel_operand(weight, x.dtype)
    b = bias.detach().float().contiguous()
    ln = pack_ln(s1, b1, s2, b2).detach()
    out = torch.empty_like(x)
    _build.require_cuda(x, w, b, ln, out)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, w, b, ln, out)]
    err = lib.spoofsv_hconv_launch(_build.DTYPE_CODES[x.dtype], *ptrs, B, T, C, K, dilation,
                                   pad_left(K, dilation, causal), eps,
                                   _build.stream_ptr(x.device))
    _build.check(lib, "highway", err, "hconv_kernel")
    hconv_kernel.launches += 1
    return out


def hconv_pair_launch(x, wa, ba, s1a, b1a, s2a, b2a, wb, bb, s1b, b1b, s2b, b2b,
                      dilation_a: int, dilation_b: int, causal: bool,
                      eps: float = LN_EPS) -> torch.Tensor:
    """Launch K5 on CUDA tensors; raises on anything the kernel does not take
    (including a y₁ tile too large for the card's shared memory)."""
    K = _check(x, wa, wb)
    lib = _build.load("highway")
    B, T, C = x.shape
    x = aligned(x)
    ops = [x, _kernel_operand(wa, x.dtype), ba.detach().float().contiguous(),
           pack_ln(s1a, b1a, s2a, b2a).detach(), _kernel_operand(wb, x.dtype),
           bb.detach().float().contiguous(), pack_ln(s1b, b1b, s2b, b2b).detach()]
    out = torch.empty_like(x)
    _build.require_cuda(*ops, out)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*ops, out)]
    err = lib.spoofsv_hconv_pair_launch(_build.DTYPE_CODES[x.dtype], *ptrs, B, T, C, K,
                                        dilation_a, dilation_b, pad_left(K, dilation_a, causal),
                                        pad_left(K, dilation_b, causal), eps,
                                        _build.stream_ptr(x.device))
    _build.check(lib, "highway", err, "hconv_pair_kernel")
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
