"""Per-launch times of Tacotron 2's step kernels and gate products on the card.

    python3 -m spoofsv_torch.ops.t2_probe [--batches 2,40,160] [--texts 8,49]

Each step kernel (``t2_att_step_kernel``, ``t2_dec_step_kernel``) and each
cuBLAS gate product of ``ops/t2_kernel.py`` alone, 200 back-to-back
launches at the published widths over random states, replayed as one CUDA
graph and timed by CUDA events, in µs a launch, each kernel beside its plan
(rows and CTAs a cluster, clusters, the memory whole or streamed) and its
byte bound (the bytes its copies bring in, :func:`t2_kernel.staged_bytes`,
over 3.35 TB/s); one line of JSON per (B, N), with the card's name and power
limit. Comparing batches tells a launch bound by one cluster's path (flat in
B) from one bound by the card's bandwidth (growing with B). Then one launch
of each kernel from the ``-DSPOOFSV_T2_PROBE`` build (``_build.VARIANTS``)
at the last shapes: block 0's clock cycles phase by phase (the rows' lengths
spread over [N/2, N]), and the start and end (ns from the first start) of
each CTA of the first cluster. It gates nothing.
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
BYTES_PER_S = 3.35e12   # H100 SXM device memory
ATT_PHASES = ("barriers", "issue", "gates wait", "lstm", "weights wait", "query",
              "query send", "location", "query+pm wait", "energies+send", "energies wait",
              "softmax", "context", "cluster exit")
DEC_PHASES = ("barriers", "issue", "gates wait", "lstm", "weights wait", "projection",
              "projection send", "partials wait", "frame", "prenet1+send", "prenet1 wait",
              "gather", "prenet2", "cluster exit")


def _us(fn) -> float:
    """µs a launch of ``fn``'s work: REPS launches captured into a CUDA graph
    (as the rollout runs them: no host time between them), its replay timed
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
            # the rows' lengths spread over [N/2, N], as a spoof-set call's texts are
            s.lengths.copy_(N - torch.arange(B, device=dev) * 7 % (N // 2 + 1))
            s.w.fill_(1.0 / N)
            g_att = torch.randn(B, 4 * w.A, device=dev)
            g_dec = torch.randn(B, 4 * w.D, device=dev)
            plans = dict(zip(("att", "dec"), t2_kernel.kernel_plans(w, B, N, dev)))
            line = {"card": card, "B": B, "N": N,
                    "att_step_us": _us(lambda: t2_kernel.att_step_kernel(g_att, w, s, 3)),
                    "dec_step_us": _us(lambda: t2_kernel.dec_step_kernel(g_dec, w, s, 3)),
                    "gemm_att_us": _us(lambda: torch.mm(s.a_buf, w.w_att.t(),
                                                        out_dtype=torch.float32)),
                    "gemm_dec_us": _us(lambda: torch.mm(s.d_buf, w.w_dec.t(),
                                                        out_dtype=torch.float32))}
            for k, p in plans.items():
                line[f"{k}_bound_us"] = 1e6 * t2_kernel.staged_bytes(
                    k, p, B, N, w.widths) / BYTES_PER_S
                line[f"{k}_plan"] = p._asdict()
            line["resident_clusters"] = t2_kernel._RESIDENT[(0, w.C)]
            print(json.dumps(line), flush=True)
    # one launch of each kernel at the last shapes, clocked phase by phase
    t2_kernel.BUILD = "t2_rollout_probe"
    lib = _build.load(t2_kernel.BUILD)
    t2_kernel.att_step_kernel(g_att, w, s, 3)
    t2_kernel.dec_step_kernel(g_dec, w, s, 3)
    torch.cuda.synchronize()
    clocks = (ctypes.c_longlong * 96)()
    _build.check(lib, t2_kernel.LIB, lib.spoofsv_t2_probe_read(ctypes.addressof(clocks)), "probe")
    for k, name, phases in ((0, "att", ATT_PHASES), (1, "dec", DEC_PHASES)):
        c = clocks[48 * k: 48 * k + len(phases) + 1]
        ns = clocks[48 * k + 32: 48 * k + 48]
        t0 = min(ns[0::2])
        out = {"kernel": name, "B": B, "N": N, "cycles": dict(
            zip(phases, (b - a for a, b in zip(c[:-1], c[1:])))),
            "cluster0_ns": [(ns[2 * i] - t0, ns[2 * i + 1] - t0) for i in range(8)]}
        if k == 0:   # the context's parts: its first chunk's wait, its sums, its stores
            out["cycles"].update({"context: memory wait": clocks[15] - clocks[12],
                                  "context: sums": clocks[16] - clocks[15],
                                  "context: stores": clocks[13] - clocks[16]})
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
