"""Developer tool for the tensor-core K3 (``csrc/gl_tc.cu``) on one GPU.

    python3 -m spoofsv_torch.ops.gl_tc_probe [--batch 64] [--frames 1300]

Builds the source with ``-DSPOOFSV_GLTC_PROBE`` (``_build.VARIANTS``; the
product build carries none of this) and, on the |STFT| of harmonic test
signals from the SPSI init, for int8 and bf16 operands:

- times GL with 0, 1, 2 and 12 iterations with CUDA events (the final
  launch alone, then each iteration launch beside it);
- prints one CTA's phase times (tile 1 of utterance 0, thread 0's global
  timer at each phase boundary, µs) in the first iteration launch, a later
  one and the final launch: operand build, each 256-column product chunk and
  its epilogue, and when the producer thread issued its last copy.

It gates nothing and prints no result line; ``chip_smoke.py`` is the check.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.ops import _build
from spoofsv_torch.ops import gl_kernel as gk

NFFT, HOP = 1024, 256
# the probe's marks in the kernel (MARK(i)): slot -> the phase that ends there
MARKS = {1: "synthesis operand", 2: "syn product 0", 6: "syn epilogue 0", 3: "syn product 1",
         7: "syn epilogue 1", 4: "syn product 2", 8: "syn epilogue 2", 5: "syn product 3",
         9: "syn epilogue 3", 10: "barrier", 11: "analysis operand (final: audio)",
         12: "ana product 0", 16: "ana epilogue 0", 13: "ana product 1", 17: "ana epilogue 1",
         14: "ana product 2", 18: "ana epilogue 2", 15: "ana product 3", 19: "ana epilogue 3"}


def harmonic_mag(B: int, T: int, dev, seed: int = 1) -> torch.Tensor:
    """|STFT| (B, T, 513) of harmonic test signals with noise."""
    rng = np.random.default_rng(seed)
    L = HOP * (T - 1)
    t = np.arange(L) / 22050.0
    sigs = [sum(np.sin(2 * np.pi * 110.0 * (1 + b % 4) * k * t + rng.uniform(0, 6)) / k
                for k in range(1, 6)) + 0.1 * rng.normal(size=L) for b in range(B)]
    y = torch.from_numpy(np.stack(sigs) * np.hanning(L)).float().to(dev)
    re, im = torchdsp.stft_ri(y, NFFT, HOP)
    return torch.sqrt(re * re + im * im)[:, :T].contiguous()


def phase_lines(prof: np.ndarray) -> str:
    """One launch's 32 timer slots → 'phase µs' in the kernel's order."""
    t0, out, last = prof[0], [], prof[0]
    for slot in sorted(MARKS, key=lambda s: prof[s] if prof[s] else 1 << 62):
        if prof[slot]:
            out.append(f"{MARKS[slot]} {(prof[slot] - last) / 1e3:.1f}")
            last = prof[slot]
    out.append(f"producer done at {(prof[21] - t0) / 1e3:.1f}, total {(last - t0) / 1e3:.1f}")
    return "; ".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=1300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gl_tc_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _build.load("gl_tc_probe")
    for ln in _build.BUILD_LOG["gl_tc_probe"]["ptxas"]:
        print(f"[ptxas] {ln.strip()}")
    mag = harmonic_mag(args.batch, args.frames, dev)
    init = gk.init_angles_plain(mag, NFFT, HOP, "spsi")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for int8 in (True, False):
        name = "int8" if int8 else "bf16"
        times = {}
        for n_iter in (0, 1, 2, 12):
            run = lambda: gk.griffin_lim_tc(mag, NFFT, HOP, n_iter=n_iter,  # noqa: E731
                                            init_angles=init, int8=int8)
            run()
            torch.cuda.synchronize()
            start.record()
            for _ in range(3):
                run()
            end.record()
            torch.cuda.synchronize()
            times[n_iter] = start.elapsed_time(end) / 3
        print(f"[{name}] B={args.batch} T={args.frames} ms: final alone {times[0]:.3f}, GL1 "
              f"{times[1]:.3f}, GL2 {times[2]:.3f}, GL12 {times[12]:.3f}; a later iteration "
              f"{times[2] - times[1]:.3f}, the first {times[1] - times[0]:.3f} on [{smi}]")
        prof = torch.zeros(13 * 32, dtype=torch.int64, device=dev)
        ang_re, ang_im = (x.float().expand(mag.shape).contiguous() for x in init)
        gk._gl_tc_cuda(mag, ang_re, ang_im, 12, 0.99, int8, prof=prof)
        torch.cuda.synchronize()
        p = prof.view(13, 32).cpu().numpy()
        for label, i in (("first iteration", 0), ("iteration 5", 5), ("final", 12)):
            print(f"[{name}] CTA (1, 0) {label}, µs: {phase_lines(p[i])}")


if __name__ == "__main__":
    main()
