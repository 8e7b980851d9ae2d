"""K6: the highway gate (two LayerNorms, sigmoid, residual blend) in one pass.

Port of :mod:`spoofsv_tpu.ops.pallas_ops` (``_gate_kernel``). The kernel is
``csrc/highway.cu::gate_kernel``; :func:`highway_gate_plain` ports
``highway_gate_reference``. :func:`fused_highway_gate` is differentiable: its
forward launches the kernel for CUDA tensors (the plain version for CPU
tensors) and its backward is the gradient of the plain version recomputed
from the saved inputs, the design of ``fused_highway_gate_ad``.
"""

from __future__ import annotations

import torch

from spoofsv_torch.ops import _build

LN_EPS = 1e-5

gate_kernel = _build.LaunchCounter()   # K6


def layer_norm_two_pass(v: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis of an f32 ``v`` with the two-pass variance
    ``mean((v − μ)²)`` of the TPU kernels (the port's ``LayerNorm`` module
    uses flax's fast form ``E[v²] − μ²``)."""
    mu = v.mean(-1, keepdim=True)
    var = ((v - mu) ** 2).mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def highway_gate_plain(h: torch.Tensor, x: torch.Tensor, ln1_scale, ln1_bias,
                       ln2_scale, ln2_bias, eps: float = LN_EPS) -> torch.Tensor:
    """``h`` (..., 2C) conv output, ``x`` (..., C) → ``σ(LN1(h₁))·LN2(h₂) +
    (1−σ(LN1(h₁)))·x`` in f32, returned in ``x.dtype``."""
    c = h.shape[-1] // 2
    h32 = h.float()
    g = torch.sigmoid(layer_norm_two_pass(h32[..., :c], ln1_scale, ln1_bias, eps))
    n2 = layer_norm_two_pass(h32[..., c:], ln2_scale, ln2_bias, eps)
    return (g * n2 + (1.0 - g) * x.float()).to(x.dtype)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels load 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gate_launch(h: torch.Tensor, x: torch.Tensor, s1, b1, s2, b2,
                eps: float = LN_EPS) -> torch.Tensor:
    """Launch K6 on CUDA tensors, one launch a call; raises on anything the
    kernel does not take. The LayerNorm vectors go as they are, f32 or bf16."""
    *lead, c2 = h.shape
    c = c2 // 2
    if tuple(x.shape) != (*lead, c) or c2 != 2 * c:
        raise ValueError(f"gate kernel: h {tuple(h.shape)} and x {tuple(x.shape)} do not match")
    if x.dtype not in _build.DTYPE_CODES or h.dtype != x.dtype:
        raise ValueError(f"gate kernel takes f32 or bf16 h and x of one dtype, "
                         f"got {h.dtype}/{x.dtype}")
    if c < 32 or c > 1024 or c & (c - 1):
        raise ValueError(f"gate kernel needs C a power of two in [32, 1024], got {c}")
    lns = [aligned(t) for t in (s1, b1, s2, b2)]
    if any(t.shape != (c,) or t.dtype != lns[0].dtype for t in lns) \
            or lns[0].dtype not in _build.DTYPE_CODES:
        raise ValueError(f"gate kernel takes four LayerNorm vectors of {c} f32 or bf16 values "
                         f"of one dtype, got {[(tuple(t.shape), t.dtype) for t in lns]}")
    lib = _build.load("highway")
    h, x = aligned(h), aligned(x)
    out = torch.empty_like(x)
    _build.require_cuda(h, x, *lns, out)
    err = lib.spoofsv_highway_gate_launch(
        _build.DTYPE_CODES[x.dtype], h.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in lns),
        _build.DTYPE_CODES[lns[0].dtype], out.data_ptr(), x.numel() // c, c, eps,
        _build.stream_ptr(x.device))
    _build.check(lib, "highway", err, "gate_kernel")
    gate_kernel.launches += 1
    return out


def recompute_grads(ctx, plain, grad_out: torch.Tensor, *static):
    """Backward of the fused wrappers: the gradient of the plain version,
    recomputed from the saved inputs (the JAX package's custom_vjp design)."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = plain(*ins, *static)
        wanted = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out.to(out.dtype)) if wanted else ())
    return tuple(next(grads) if n else None for n in need)


class _FusedGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, s1, b1, s2, b2):
        ctx.save_for_backward(h, x, s1, b1, s2, b2)
        if h.device.type == "cpu":
            return highway_gate_plain(h, x, s1, b1, s2, b2)
        return gate_launch(h, x, s1, b1, s2, b2)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, highway_gate_plain, grad_out)


def fused_highway_gate(h: torch.Tensor, x: torch.Tensor, ln1_scale: torch.Tensor,
                       ln1_bias: torch.Tensor, ln2_scale: torch.Tensor,
                       ln2_bias: torch.Tensor) -> torch.Tensor:
    """``h`` (..., 2C), ``x`` (..., C) → (..., C): K6 on CUDA tensors, the
    plain version on CPU tensors; differentiable in every input."""
    return _FusedGate.apply(h, x, ln1_scale, ln1_bias, ln2_scale, ln2_bias)
