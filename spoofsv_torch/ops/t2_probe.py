"""Per-launch times of Tacotron 2's step kernels and gate products on the card.

    python3 -m spoofsv_torch.ops.t2_probe [--batches 2,40,160] [--texts 8,49]

Each step kernel (``t2_att_step_kernel``, ``t2_dec_step_kernel``) and each
cuBLAS gate product of ``ops/t2_kernel.py`` alone, 200 back-to-back
launches at the published widths over random states, CUDA events, in µs a
launch; one line of JSON per (B, N), with the card's name and power limit.
Comparing batches tells a launch bound by one block's path (flat in B) from
one bound by the card's bandwidth (growing with B). Then one launch of each
kernel from the ``-DSPOOFSV_T2_PROBE`` build (``_build.VARIANTS``) at the
last shapes, block 0's clock cycles phase by phase. It gates nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from spoofsv_torch import reference_precision
from spoofsv_torch.config import Tacotron2Config
from spoofsv_torch.models.tacotron2 import build_tacotron2
from spoofsv_torch.ops import _build, t2_kernel

REPS = 200
ATT_PHASES = ("lstm+loads", "query", "location", "energies", "softmax", "context")
DEC_PHASES = ("lstm+context", "projection", "prenet1", "mask1+prenet2", "mask2+store")


def _us(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / REPS


def main(argv=None) -> None:
    ps = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ps.add_argument("--batches", default="2,40,160")
    ps.add_argument("--texts", default="8,49")
    args = ps.parse_args(argv)
    dev = torch.device("cuda:0")
    reference_precision()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    w = t2_kernel.StepWeights(build_tacotron2(Tacotron2Config(weights_seed=1), dev,
                                              torch.bfloat16))
    for B in (int(b) for b in args.batches.split(",")):
        for N in (int(n) for n in args.texts.split(",")):
            s = t2_kernel.Buffers(w, B, N, 8, torch.bfloat16, dev)
            s.lengths.fill_(N)
            s.w.fill_(1.0 / N)
            g_att = torch.randn(B, 4 * w.A, device=dev)
            g_dec = torch.randn(B, 4 * w.D, device=dev)
            line = {"card": card, "B": B, "N": N,
                    "att_step_us": _us(lambda: t2_kernel.att_step_kernel(g_att, w, s, 3)),
                    "dec_step_us": _us(lambda: t2_kernel.dec_step_kernel(g_dec, w, s, 3)),
                    "gemm_att_us": _us(lambda: torch.mm(s.a_buf, w.w_att.t(),
                                                        out_dtype=torch.float32)),
                    "gemm_dec_us": _us(lambda: torch.mm(s.d_buf, w.w_dec.t(),
                                                        out_dtype=torch.float32))}
            print(json.dumps(line), flush=True)
    # one launch of each kernel at the last shapes, clocked phase by phase
    t2_kernel.BUILD = "t2_rollout_probe"
    lib = _build.load(t2_kernel.BUILD)
    t2_kernel.att_step_kernel(g_att, w, s, 3)
    t2_kernel.dec_step_kernel(g_dec, w, s, 3)
    torch.cuda.synchronize()
    clocks = (ctypes.c_longlong * 32)()
    _build.check(lib, t2_kernel.LIB, lib.spoofsv_t2_probe_read(ctypes.addressof(clocks)), "probe")
    for k, name, phases in ((0, "att", ATT_PHASES), (1, "dec", DEC_PHASES)):
        c = clocks[16 * k: 16 * k + len(phases) + 1]
        print(json.dumps({"kernel": name, "B": B, "N": N, "cycles": dict(
            zip(phases, (b - a for a, b in zip(c[:-1], c[1:]))))}), flush=True)


if __name__ == "__main__":
    main()
