"""The highway kernels' cases on the card, and a tool that times them: K4 and
K5 (``csrc/hconv_pair.cu``), K6 (``csrc/highway.cu``).

:func:`cases` builds the inputs ``chip_smoke.py`` phase 6 checks and times.
Run alone on one GPU,

    python3 -m spoofsv_torch.ops.hconv_probe [--tag NAME]

prints for each case its max |d| against its plain version, the device time
of a call (every kernel it runs) and of its kernel alone (``torch.profiler``),
the host time a call takes to enqueue, and K6's call without its
``autograd.Function``. To compare two trees on one card, unpack the other
one (``git archive``) into a git-ignored directory, copy this file into its
``spoofsv_torch/ops/``, and run both in turns (A, B, B, A) in one call.

It gates nothing and prints no result line; ``chip_smoke.py`` is the check.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, NamedTuple

import torch

from spoofsv_torch import reference_precision
from spoofsv_torch.ops import _build, gate_kernel, hconv_kernel

# the kernel each case launches, as the profiler names it (K4 and K5 are one template)
KERNEL_NAMES = {"highway_gate": "gate_kernel", "highway_conv": "hconv_kernel",
                "highway_conv_pair": "hconv_kernel"}


class Case(NamedTuple):
    fused: Callable     # the kernel's wrapper on the checked inputs
    plain: Callable     # its plain version on the same inputs
    work: dict          # ops, bytes and peak rate of its bound; for K4/K5 flop and row ratio
    timed: Callable     # the call that is timed


def rand(shape, seed: int, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dev, dtype)


def hw_params(C: int, K: int, seed: int, dev, dtype=torch.float32) -> list:
    """Conv weight (2C, C, K) at the models' Kaiming scale, bias, LN params."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(2 * C, C, K, generator=g) * (2.0 / (K * C)) ** 0.5
    b = torch.randn(2 * C, generator=g) * 0.1
    lns = [torch.randn(C, generator=g) * 0.2 + (1.0 if i % 2 == 0 else 0.0) for i in range(4)]
    return [t.to(dev, dtype) for t in (w, b, *lns)]


def conv_work(B, T, C, K, layers, dtype, rows_ratio) -> dict:
    """Useful FLOPs (products), the operations and bytes of the bound and its
    peak rate: f32 as 3xTF32 (3 passes at 495 TFLOP/s), bf16 at 989."""
    flop = layers * 2.0 * B * T * K * C * 2 * C
    es = 4 if dtype == torch.float32 else 2
    nbytes = es * (2 * B * T * C + layers * K * C * 2 * C) + 4 * layers * 6 * C
    three = dtype == torch.float32
    return dict(ratio=rows_ratio, flop=flop, ops=3 * flop if three else flop, bytes=nbytes,
                peak=495e12 if three else 989e12)


def gate_case(rows: int, C: int, seed: int, dev) -> Case:
    """K6 on 16 x ``rows`` rows. Timed over input sets that together hold
    three times the L2, each call on the next set with its own output, so
    each call's h and x come from DRAM as its bound assumes."""
    lns = hw_params(C, 1, seed + 2, dev)[2:]
    # h (2C) and x (C) in, y (C) out; ~10 operations an element on the CUDA
    # cores (67 TFLOP/s)
    per_set = 4 * 16 * rows * 4 * C
    work = dict(ops=10 * 16 * rows * 2 * C, bytes=per_set + 4 * 4 * C, peak=67e12)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size if dev.type == "cuda" else 0
    sets = [(rand((16, rows, 2 * C), seed + 10 * i, dev),
             rand((16, rows, C), seed + 10 * i + 1, dev)) for i in range(1 + 3 * l2 // per_set)]
    outs = [None] * len(sets)
    turn = [0]

    def timed():
        i = turn[0] = (turn[0] + 1) % len(sets)
        outs[i] = gate_kernel.fused_highway_gate(*sets[i], *lns)
        return outs[i]

    return Case(lambda: gate_kernel.fused_highway_gate(*sets[0], *lns),
                lambda: gate_kernel.highway_gate_plain(*sets[0], *lns), work, timed)


def conv_case(T: int, C: int, dil: int, causal: bool, seed: int, dev, B: int = 16,
              dtype=torch.float32) -> Case:
    x, p = rand((B, T, C), seed, dev, dtype), hw_params(C, 3, seed + 1, dev, dtype)
    plan = hconv_kernel.pair_tile_plan(C, 3, dil, T, dtype, layers=1)
    fused = lambda: hconv_kernel.fused_highway_conv(x, *p, dil, causal)  # noqa: E731
    return Case(fused, lambda: hconv_kernel.highway_conv_plain(x, *p, dil, causal),
                conv_work(B, T, C, 3, 1, dtype, plan.executed_over_useful(T)), fused)


def pair_case(T: int, C: int, da: int, db: int, causal: bool, seed: int, dev, B: int = 16,
              dtype=torch.float32) -> Case:
    x = rand((B, T, C), seed, dev, dtype)
    pa, pb = hw_params(C, 3, seed + 1, dev, dtype), hw_params(C, 3, seed + 2, dev, dtype)
    plan = hconv_kernel.pair_tile_plan(C, 3, db, T, dtype)
    fused = lambda: hconv_kernel.fused_highway_conv_pair(x, *pa, *pb, da, db, causal)  # noqa: E731
    return Case(fused, lambda: hconv_kernel.highway_pair_plain(x, *pa, *pb, da, db, causal),
                conv_work(B, T, C, 3, 2, dtype, plan.executed_over_useful(T)), fused)


def cases(dev) -> dict:
    """name -> (TPU kernel, [(label, builder of its Case)]): the training
    path's shapes in f32 (B=16), K4 and K5 also in bf16 at the synthesis
    batch (B=64). The first case of each is the one ``chip_smoke.py``'s
    kernels line reports."""
    bf16 = torch.bfloat16
    return {
        "highway_gate": ("spoofsv_tpu/ops/pallas_ops.py:40", [
            ("audio encoder 16x325 rows C=256", lambda: gate_case(325, 256, 30, dev)),
            ("text encoder 16x186 rows C=512", lambda: gate_case(186, 512, 33, dev))]),
        "highway_conv": ("spoofsv_tpu/ops/pallas_conv.py:57", [
            ("SSRN hc3 T=1300 C=512 d=1 SAME", lambda: conv_case(1300, 512, 1, False, 40, dev)),
            ("bf16 SSRN hc3 B=64 T=1300 C=512 d=1 SAME",
             lambda: conv_case(1300, 512, 1, False, 41, dev, B=64, dtype=bf16)),
            ("audio encoder T=325 C=256 d=27 causal",
             lambda: conv_case(325, 256, 27, True, 42, dev))]),
        "highway_conv_pair": ("spoofsv_tpu/ops/pallas_conv.py:204", [
            ("SSRN hc3->hc4 T=1300 C=512 (1,1)",
             lambda: pair_case(1300, 512, 1, 1, False, 50, dev)),
            ("ups2 pair T=1300 C=256 (1,3)", lambda: pair_case(1300, 256, 1, 3, False, 53, dev)),
            ("causal (9,27) T=325 C=256", lambda: pair_case(325, 256, 9, 27, True, 56, dev)),
            ("text encoder (9,27) SAME N=186 C=512",
             lambda: pair_case(186, 512, 9, 27, False, 59, dev)),
            ("bf16 SSRN hc3->hc4 B=64 T=1300 C=512 (1,1)",
             lambda: pair_case(1300, 512, 1, 1, False, 62, dev, B=64, dtype=bf16))]),
    }


def host_us(fn, reps: int = 200) -> float:
    """Host time a call takes to return (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="tree", help="label of this checkout in the output")
    tag = ap.parse_args().tag
    dev = torch.device("cuda:0")
    reference_precision()   # the plain versions' f32 convs in f32, not TF32
    t0 = time.perf_counter()
    _build.load("hconv_pair")
    _build.load("highway")
    print(f"[{tag}] build {time.perf_counter() - t0:.1f} s")
    for name, (_, named) in cases(dev).items():
        for label, build in named:
            case = build()
            err = float((case.fused().float() - case.plain().float()).abs().max())
            reps = 100 if name == "highway_gate" else 20
            call_ms, kernel_ms = _build.device_ms(case.timed, KERNEL_NAMES[name], reps)
            print(f"[{tag}] {name} {label}: max|d| {err:.3g}; device {call_ms:.4f} ms a call, "
                  f"its kernel {kernel_ms:.4f} ms; host enqueue {host_us(case.timed, 50):.1f} us",
                  flush=True)
            del case
    C = 256
    h, x = rand((16, 325, 2 * C), 4, dev), rand((16, 325, C), 5, dev)
    lns = hw_params(C, 1, 6, dev)[2:]
    call = host_us(lambda: gate_kernel.fused_highway_gate(h, x, *lns))
    bare = host_us(lambda: gate_kernel.gate_launch(h, x, *lns))
    print(f"[{tag}] K6 f32 16x325 C256: call {call:.1f} us, without autograd.Function "
          f"{bare:.1f} us on [{torch.cuda.get_device_name(0)}]")


if __name__ == "__main__":
    main()
