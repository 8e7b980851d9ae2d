"""Developer tool for the f32 Griffin-Lim kernels (``csrc/gl.cu``'s K3) on one GPU.

    python3 -m spoofsv_torch.ops.gl_probe [--tag NAME] [--shapes 160x1300x64,200x313x64]

For each shape ``BxTxITERS`` (default: the refgl64 cell's B=160, T=1300,
GL64, and the campaign's copy-synthesis, B=200, T=313, GL64), on the |STFT|
of harmonic test signals from K2's hash ("random") phases at n_fft 1024,
hop 256, it prints:

- a whole ``griffin_lim_fused`` call with CUDA events (the mean of three
  after a warm-up);
- each kernel alone, synthesis, analysis and the overlap-add epilogue, by
  its device time a launch under ``torch.profiler``, against its bytes
  (each plane read or written once: synthesis reads |S| and both angle
  planes and writes ``fsyn``; analysis reads ``fsyn`` and both rebuilt
  planes and writes the angles and the rebuilt planes; the epilogue reads
  ``fsyn`` and writes the audio) at 3.35 TB/s and its operations (2.5·n·log2 n
  a transform, the windows and the momentum) at the f32 67 TFLOP/s;
- whether two calls on the same inputs are bit-equal;
- where the tree has the probe build (``-DSPOOFSV_GL_PROBE``,
  ``_build.VARIANTS``): one block's phases (the middle block of the last
  synthesis and analysis launches, thread 0's global timer at each phase
  boundary, µs).

It uses only ``gl_kernel.griffin_lim_fused``, ``init_angles_plain`` and the
kernels' names, which earlier trees have too, so it can be copied into
another checkout's ``spoofsv_torch/ops/`` and run there: two trees compared
in one call on one card, in turns (A, B, B, A). It gates nothing;
``chip_smoke.py`` is the check.
"""

from __future__ import annotations

import argparse
import math
import subprocess

import numpy as np
import torch

from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.ops import _build, gl_kernel

NFFT, HOP = 1024, 256
BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
KERNELS = ("gl_synth_kernel", "gl_analysis_kernel", "gl_ola_kernel")
# the probe build's marks: kernel -> the phase that ends at each slot
MARKS = {0: ["staged", "merge", "transform", "stores"],
         1: ["staged", "signal", "first pass in", "transform", "split + momentum", "barrier",
             "stores"]}


def harmonic_mag(B: int, T: int, dev, seed: int = 1) -> torch.Tensor:
    """|STFT| (B, T, 513) of harmonic test signals with noise, made on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L = HOP * (T - 1)
    t = torch.arange(L, device=dev, dtype=torch.float64) / 22050.0
    f0 = 110.0 * (1 + torch.arange(B, device=dev) % 4)[:, None]
    y = sum(torch.sin(2 * math.pi * f0 * k * t + 6 * torch.rand(B, 1, generator=g, device=dev,
                                                                  dtype=torch.float64)) / k
            for k in range(1, 6))
    y = y + 0.1 * torch.randn(B, L, generator=g, device=dev, dtype=torch.float64)
    y = (y * torch.hann_window(L, periodic=False, device=dev, dtype=torch.float64)).float()
    re, im = torchdsp.stft_ri(y, NFFT, HOP)
    return torch.sqrt(re * re + im * im)[:, :T].contiguous()


def work(B: int, T: int) -> dict:
    """(bytes, operations) a launch of each kernel."""
    F, frames = NFFT // 2 + 1, B * T
    fft = 2.5 * NFFT * math.log2(NFFT)
    return {"gl_synth_kernel": (4.0 * frames * (3 * F + NFFT), frames * (fft + 8 * F + NFFT)),
            "gl_analysis_kernel": (4.0 * frames * (NFFT + 6 * F),
                                   frames * (fft + 4 * NFFT + 12 * F)),
            "gl_ola_kernel": (4.0 * (frames * NFFT + B * HOP * (T - 1)),
                              B * HOP * (T - 1) * (NFFT / HOP + 1))}


def kernel_us(fn) -> dict:
    """Device µs a launch of each of KERNELS over one call of ``fn`` (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in KERNELS:
            if name in e.key:
                us = getattr(e, "self_device_time_total", None)
                us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
                tot, n = out.get(name, (0.0, 0))
                out[name] = (tot + us, n + e.count)
    return {k: (tot / n, n) for k, (tot, n) in out.items() if n}


def phase_marks(call) -> str:
    """One call with the probe build of ``csrc/gl.cu`` in place of the
    product build; its middle blocks' phase times."""
    lib = _build.load("gl_probe")
    saved = _build._LIBS.get("gl")
    _build._LIBS["gl"] = lib
    try:
        call()
        torch.cuda.synchronize()
    finally:
        if saved is None:
            _build._LIBS.pop("gl")
        else:
            _build._LIBS["gl"] = saved
    marks = np.zeros((2, 16), np.uint64)
    _build.check(lib, "gl", lib.spoofsv_gl_probe_read(marks.ctypes.data), "spoofsv_gl_probe_read")
    out = []
    for k, names in MARKS.items():
        t = marks[k].astype(np.int64)
        steps = ", ".join(f"{n} {(t[i + 1] - t[i]) / 1e3:.1f}" for i, n in enumerate(names))
        out.append(f"{KERNELS[k]}: {steps}; total {(t[len(names)] - t[0]) / 1e3:.1f} us")
    return "; ".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--shapes", default="160x1300x64,200x313x64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gl_probe needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    plan = getattr(gl_kernel, "gl_plan", None)
    if plan is not None:
        print(f"[{args.tag}] plan n={NFFT} hop={HOP}: {plan(NFFT, HOP)}")
    for shape in args.shapes.split(","):
        B, T, iters = (int(v) for v in shape.split("x"))
        mag = harmonic_mag(B, T, dev)
        seeds = torch.arange(B, dtype=torch.int32, device=dev) * 7919 + 3
        init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "random", seeds)
        call = lambda: gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=iters,  # noqa: E731
                                                   init_angles=init)
        first = call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 3
        equal = bool(torch.equal(call(), first))
        print(f"[{args.tag}] B={B} T={T} GL{iters}: a call {ms:.3f} ms (CUDA events), two calls "
              f"bit-equal: {equal} on [{smi}]")
        launches = kernel_us(call)
        for name, (nbytes, ops) in work(B, T).items():
            if name not in launches:
                print(f"[{args.tag}]   {name}: no device time recorded")
                continue
            us, n = launches[name]
            bound_us = max(nbytes / BYTES_PER_S, ops / F32_OPS_PER_S) * 1e6
            print(f"[{args.tag}]   {name}: {us:.1f} us a launch ({n} launches); {nbytes / 1e9:.3f} "
                  f"GB -> {nbytes / us / 1e3:.0f} GB/s, {100 * nbytes / BYTES_PER_S / (us * 1e-6):.1f} % "
                  f"of the byte bound; {ops / 1e9:.2f} GFLOP -> "
                  f"{100 * ops / F32_OPS_PER_S / (us * 1e-6):.1f} % of f32; bound {bound_us:.1f} us")
        if "gl_probe" in _build.VARIANTS:
            print(f"[{args.tag}]   one block: {phase_marks(call)}")
        del mag, init, first
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
