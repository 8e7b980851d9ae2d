#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spoofsv_torch``) once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and ``nvcc``; without a device it exits non-zero and prints no result.

Phases (any failure raises and exits non-zero):
  1. card name/power limit; build the kernels from ``spoofsv_torch/csrc/``;
  2. K2 (GL phase init, ``csrc/gl.cu``: segment sums, their scan, a second
     pass) vs its plain version at the main path's B=64, T=1300, its time
     against the plain version's and its bound;
  3. K3 (Griffin-Lim) at B=64, T=1300 from the same init: the tensor-core
     K3 (``csrc/gl_tc.cu``) in int8 and in bf16 against its plain version
     (1 iteration at momentum 0) and GL12 against plain f32 GL (spectral
     convergence), its ptxas lines (spills fail); the f32 K3
     (``csrc/gl.cu``, the "highest" route) against plain f32 GL;
  4. K1 (decode, ``csrc/decode_cluster.cu``) at the main path's B=64,
     N=100, T=325: f32 (3xTF32 products) vs the plain eager decode and vs
     ``decode_plain`` (divergence onsets, the frames before them), its
     ptxas lines (spills fail), its plans and times at B=64 and at the
     Trainer's validation shape B=16, N=186 against ``decode_plain`` and
     its bound; bf16 vs ``decode_plain`` (the kernel's
     arithmetic in plain torch) at B=64 and B=768 over frames 0-1, and over
     64 frames at one text position (no attention flips); the cluster
     kernel's ptxas lines (spills fail), its plan, its CUDA-event times
     (the default plan, clusters of 16, clusters of 8) and the L2 bytes a
     frame;
  5. the main path: ``Synthesizer`` at full width in bf16, B=64, N=100,
     T=325, GL12 from the SPSI init, then ``finalize_audio``; launch counts
     reset just before and read just after (K1 through decode_cluster.cu
     once, K3 through gl_tc.cu once and gl.cu never); per-stage times and one call
     under ``torch.profiler`` (device time, idle share, the largest
     kernels); the SSRN stage from the same mel under the "xla",
     "fused_conv" and "fused_pair" highway impls (times, launches, the
     kernel impls' output against "xla"); plus a small f32 end-to-end
     comparison of the CUDA path against the CPU path;
  6. K4/K5/K6 (highway kernels, the cases of ``ops/hconv_probe.py``) vs
     their plain versions in f32 at the training path's shapes (B=16), and
     K4 and K5 in bf16 at the synthesis batch (B=64): max |d|, the device
     time of a call (every kernel it runs) and of its kernel alone
     (``torch.profiler``; K6 over input sets three times the L2, so its
     bytes come from DRAM), the call's host-clock time, plain ms, each
     case's bound (a device time under it fails), for K4 and K5 the
     executed/useful row ratio, the TFLOP/s achieved and the ptxas
     registers and spills of each instantiation of their one source
     (spills fail the run); gradients through each ``autograd.Function``
     against plain autograd;
  7. the ordinary training path: ``Trainer`` for Text2Mel and SSRN at full
     width, f32, B=16, N=186, T=325 (lin 1300 frames), 5 iterations from the
     same seed-0 weights under each highway impl, one validation (Text2Mel
     through the f32 K1) and one checkpoint round trip each; launch counts
     reset just before each run and read just after.
Prints a kernels JSON line (each kernel's time, plain time, launches on
the main path and bound), the card line, then the ``{"ok": true, ...}`` line
last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
]
NFFT, HOP = 1024, 256


def gate(ok: bool, detail) -> None:
    """Fail the run (non-zero exit) when a check does not hold."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {detail}")


def log(msg: str) -> None:
    print(msg, flush=True)


def highway_kernel_phase(dev, cuda_ms, kernels: dict, smi: str) -> None:
    """Phase 6: K6, K4 and K5 against their plain versions in f32 at the
    training path's shapes (B=16), K4 and K5 also in bf16 at the synthesis
    batch (B=64), then gradients through each autograd.Function."""
    import re

    import torch

    from spoofsv_torch.ops import _build, gate_kernel, hconv_kernel, hconv_probe
    from spoofsv_torch.ops.hconv_probe import hw_params, rand

    # the ptxas lines of K4 (1 layer) and K5 (2 layers), one instantiation
    # (storage type, channels per CTA, layers) each: 12, none may spill
    info = _build.BUILD_LOG["hconv_pair"].get("ptxas", [])
    seen = set()
    for i, ln in enumerate(info):
        inst = re.search(r"hconv_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)E", ln)
        if inst and i + 2 < len(info):
            seen.add(inst.groups())
            log(f"[{'highway_conv' if inst[3] == '1' else 'highway_conv_pair'}] ptxas "
                f"<{'f32' if inst[1] == 'f' else 'bf16'}, {32 * int(inst[2])} channels per CTA, "
                f"{inst[3]} layer(s)>: {info[i + 2].split(':', 1)[-1].strip()}; "
                f"{info[i + 1].strip()}")
            gate(info[i + 1].strip().startswith("0 bytes stack frame, 0 bytes spill stores"),
                 ("K4/K5 spills", info[i + 1]))
    gate(len(seen) == 12, ("K4/K5 instantiations in the ptxas lines", sorted(seen)))

    # f32: sums of up to K·C = 1536 products in another order, then LayerNorm;
    # bf16: outputs within a few bf16 ulps (the card tests' gate)
    tols = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    sources = {"highway_gate": "spoofsv_torch/csrc/highway.cu"}
    for name, (replaces, named) in hconv_probe.cases(dev).items():
        errs, first = [], None
        for label, build_case in named:
            case = build_case()
            got, ref = case.fused(), case.plain()
            err = float((got.float() - ref.float()).abs().max())
            tol = tols[got.dtype]
            if got.dtype == torch.float32:
                errs.append(err)
            # device time of a call (every kernel and copy it runs), of its
            # kernel alone, and the call's host-clock time: the small calls
            # are host work
            calls = 100 if name == "highway_gate" else 20
            ms, kernel_ms = _build.device_ms(case.timed, hconv_probe.KERNEL_NAMES[name], calls)
            gate(ms is not None and kernel_ms is not None,
                 (name, label, "torch.profiler recorded no device time of the kernel"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                case.timed()
            torch.cuda.synchronize()
            call_ms = 1e3 * (time.perf_counter() - t0) / calls
            plain_ms = cuda_ms(case.plain, reps=5)
            work = case.work
            b_ms, b_by = bound_ms(work["ops"], work["bytes"], work["peak"])
            extra = ""
            if name != "highway_gate":   # executed/useful rows, useful FLOPs over the kernel's time
                extra = (f"; executed/useful rows {work['ratio']:.3f}, "
                         f"{work['flop'] / (kernel_ms * 1e-3) / 1e12:.1f} TFLOP/s")
            log(f"[{name}] {label}: max|d| {err:.3g} (gate {tol}); device {ms:.4f} ms a call, "
                f"its kernel {kernel_ms:.4f} ms (torch.profiler), call {call_ms:.4f} ms (host "
                f"clock, {calls} calls), plain {plain_ms:.3f} ms{extra}; bound {b_ms:.4f} ms "
                f"({b_by}), {100 * b_ms / ms:.1f} % of it, on [{smi}]")
            gate(err <= tol, (name, label, err))
            gate(ms >= b_ms, (name, label, "device time under its bound", ms, b_ms))
            if first is None:
                first = dict(ms=ms, kernel_ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by)
            del case, got, ref
        kernels[name] = dict(name=name, route="cuda",
                             source=sources.get(name, "spoofsv_torch/csrc/hconv_pair.cu"),
                             replaces=replaces, max_abs_err=max(errs), library_ms=None, **first)

    # gradients through each autograd.Function (the plain version recomputed
    # from the saved inputs) against autograd of the plain version
    C, T = 256, 64
    grad_cases = {
        "highway_gate": (gate_kernel.fused_highway_gate, gate_kernel.highway_gate_plain,
                         [rand((2, T, 2 * C), 60, dev), rand((2, T, C), 61, dev)]
                         + hw_params(C, 1, 62, dev)[2:], ()),
        "highway_conv": (hconv_kernel.fused_highway_conv, hconv_kernel.highway_conv_plain,
                         [rand((2, T, C), 63, dev)] + hw_params(C, 3, 64, dev), (3, True)),
        "highway_conv_pair": (hconv_kernel.fused_highway_conv_pair,
                              hconv_kernel.highway_pair_plain,
                              [rand((2, T, C), 65, dev)] + hw_params(C, 3, 66, dev)
                              + hw_params(C, 3, 67, dev),
                              (1, 3, False)),
    }
    for name, (fused, plain, ins, static) in grad_cases.items():
        grads = []
        for fn in (fused, plain):
            ts = [t.clone().requires_grad_(True) for t in ins]
            (fn(*ts, *static) ** 2).sum().backward()
            grads.append([t.grad for t in ts])
        excess = max(float(((g - r).abs() - (5e-4 + 1e-4 * r.abs())).max())
                     for g, r in zip(*grads))
        worst = max(float((g - r).abs().max()) for g, r in zip(*grads))
        log(f"[{name}] grads vs plain autograd B=2 T={T} C={C}: max|d| {worst:.3g} "
            f"(gate atol 5e-4 + rtol 1e-4)")
        gate(excess <= 0.0, (name, worst))


def gl_phase(dev, cuda_ms, mag, init, kernels: dict, spectral_err, smi: str) -> None:
    """Phase 3 at the main path's B=64, T=1300, from the same SPSI init: the
    tensor-core K3 (``csrc/gl_tc.cu``) in int8 and in bf16 against its plain
    version (1 iteration at momentum 0, rel-L2 < 0.03) and GL12 against plain
    f32 GL (spectral convergence within 0.02), its ptxas lines (spills fail);
    the f32 K3 (``csrc/gl.cu``) against plain f32 GL under the same gates.
    Times, and each route's bound."""
    import torch

    from spoofsv_torch.dsp import torchdsp
    from spoofsv_torch.ops import _build, gl_kernel

    info = _build.BUILD_LOG["gl_tc"].get("ptxas", [])
    for ln in info:
        log(f"[K3 tc] ptxas: {ln.strip()}")
    spills = [ln for ln in info if "spill" in ln]
    gate(len(spills) == 3 and all("0 bytes spill stores, 0 bytes spill loads" in ln
                                  for ln in spills), ("gl_tc spills", spills))
    r12 = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=12, momentum=0.99, init_angles=init)
    sc_f32 = spectral_err(r12, mag)
    f32_plain = cuda_ms(lambda: torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=12, init_angles=init),
                        reps=2)
    Bm, Tm, Fm = mag.shape
    frames = Bm * Tm
    # bytes every route must move: |S| and the initial angles in, the audio out (f32)
    gl_bytes = 4.0 * (3 * mag.numel() + Bm * HOP * (Tm - 1))
    tc = {}
    for int8 in (True, False):
        name = "int8" if int8 else "bf16"
        g1 = gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=1, momentum=0.0, init_angles=init,
                                      int8=int8)
        p1 = gl_kernel.griffin_lim_tc_plain(mag, *init, NFFT, HOP, 1, 0.0, int8)
        rel1 = float(torch.linalg.norm(g1 - p1) / torch.linalg.norm(p1))
        err1 = float((g1 - p1).abs().max())
        g12 = gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=12, init_angles=init, int8=int8)
        p12 = gl_kernel.griffin_lim_tc_plain(mag, *init, NFFT, HOP, 12, 0.99, int8)
        sc_k, sc_p = spectral_err(g12, mag), spectral_err(p12, mag)
        rel12 = float(torch.linalg.norm(g12 - p12) / torch.linalg.norm(p12))
        log(f"[K3 tc {name}] 1 iter mom 0 vs its plain version: rel-L2 {rel1:.3g} (gate < 0.03), "
            f"max|d| {err1:.3g}; GL12 mom 0.99: spectral conv kernel {sc_k:.5f}, its plain "
            f"version {sc_p:.5f}, plain f32 GL {sc_f32:.5f} (gate |kernel - f32| <= 0.02); "
            f"GL12 rel-L2 vs its plain version {rel12:.3g} (context)")
        gate(rel1 < 0.03, (name, rel1))
        gate(abs(sc_k - sc_f32) <= 0.02, (name, sc_k, sc_f32))
        ms = cuda_ms(lambda: gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=12, init_angles=init,
                                                      int8=int8), reps=5)
        plain = cuda_ms(lambda: gl_kernel.griffin_lim_tc_plain(mag, *init, NFFT, HOP, 12, 0.99,
                                                               int8), reps=1)
        # operations: per frame and iteration a synthesis and an analysis
        # product of 1024 x 1024 multiply-adds, plus the final bf16 synthesis
        ops = 2.0 * 1024 * 1024 * frames
        t_ops = (12 * 2 * ops / (1979e12 if int8 else 989e12) + ops / 989e12)
        t_bytes = gl_bytes / 3.35e12
        b_ms, b_by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
        log(f"[K3 tc {name}] B={Bm} T={Tm} GL12: kernel {ms:.3f} ms (13 launches), its plain "
            f"version {plain:.3f} ms, plain f32 GL {f32_plain:.3f} ms; bound {b_ms:.4f} ms "
            f"({b_by}: {12 * 2 * ops / 1e12:.3f} T{'OP' if int8 else 'FLOP'} + "
            f"{ops / 1e12:.3f} TFLOP bf16, {gl_bytes / 1e9:.3f} GB) on [{smi}]")
        tc[int8] = dict(max_abs_err=err1, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        del g1, p1, g12, p12
    kernels["griffin_lim"] = dict(
        name="griffin_lim", route="cuda", source="spoofsv_torch/csrc/gl_tc.cu",
        replaces="spoofsv_tpu/ops/pallas_gl.py:122", library_ms=None, **tc[True])
    log(f"[K3 tc] JSON entry: int8 (the main path's); bf16 {tc[False]['ms']:.3f} ms, bound "
        f"{tc[False]['bound_ms']:.4f} ms")

    # the f32 K3, the "highest" precision route
    g1 = gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=1, momentum=0.0, init_angles=init)
    r1 = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=1, momentum=0.0, init_angles=init)
    rel1 = float(torch.linalg.norm(g1 - r1) / torch.linalg.norm(r1))
    err1 = float((g1 - r1).abs().max())
    g12 = gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=12, momentum=0.99, init_angles=init)
    sc_k = spectral_err(g12, mag)
    log(f"[K3 f32] 1 iter mom 0: rel-L2 {rel1:.3g} (gate < 0.03), max|d| {err1:.3g}; GL12 mom "
        f"0.99: spectral conv kernel {sc_k:.5f} plain {sc_f32:.5f} (gate delta <= 0.02)")
    gate(rel1 < 0.03, rel1)
    gate(abs(sc_k - sc_f32) <= 0.02, (sc_k, sc_f32))
    ms = cuda_ms(lambda: gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=12, init_angles=init))
    # 12 iterations of an inverse and a forward real FFT per frame (2.5·n·log2 n
    # operations each, f32 at 67 TFLOP/s) against the same bytes
    gl_flop = 12 * frames * (2 * 2.5 * NFFT * np.log2(NFFT) + 10 * Fm)
    b_ms, b_by = bound_ms(gl_flop, gl_bytes, 67e12)
    log(f"[K3 f32] B={Bm} T={Tm} GL12: kernel {ms:.3f} ms, plain {f32_plain:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}: {gl_flop / 1e9:.1f} GFLOP, {gl_bytes / 1e9:.3f} GB)")
    kernels["griffin_lim_f32"] = dict(
        name="griffin_lim_f32", route="cuda", source="spoofsv_torch/csrc/gl.cu",
        replaces="spoofsv_tpu/ops/pallas_gl.py:122", max_abs_err=err1, ms=ms,
        plain_ms=f32_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def bound_ms(flop: float, nbytes: float, peak_flops: float) -> tuple:
    """(least ms the card could take, "bytes" or "operations"): the larger of
    the bytes over 3.35 TB/s and the operations over ``peak_flops``."""
    t_bytes, t_ops = nbytes / 3.35e12, flop / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def decode_work(C: int, F: int, B: int, N: int, T: int, elem: int) -> tuple:
    """K1's FLOPs over a rollout (its products: 16 highway layers of K=3, the
    attention and decoder projections) and the bytes it must move (the
    weights, K, V, the speaker projections and the outputs, ``elem`` bytes a
    value)."""
    macs_row = 16 * 3 * C * 2 * C + 5 * C * C + 2 * C * C + F * C + C * F
    return (2.0 * macs_row * B * T,
            elem * (macs_row + 2 * B * N * C + 2 * B * C + B * T * F + B * N * T))


def cluster_phase(dev, cuda_ms, mbf, packed, kv, cfg, T: int, smi: str) -> dict:
    """Phase 4, bf16 K1 (csrc/decode_cluster.cu): its ptxas lines (spills
    fail), the plan chosen, the kernel against decode_plain over frames 0-1 at
    B=768 on two speaker draws (B=64 is gated by the caller) and over 64
    frames at one text position, and CUDA-event times at B=64 and B=768 of
    the default plan and of the plans chosen with clusters of 16 and of 8,
    with the L2 bytes a frame each reads. Returns the JSON entry's numbers
    at B=64."""
    import torch

    from spoofsv_torch.data.text import encode_texts
    from spoofsv_torch.ops import _build, decode_kernel

    info = _build.BUILD_LOG["decode_cluster"].get("ptxas", [])
    for ln in info:
        log(f"[K1 cluster] ptxas: {ln.strip()}")
    spills = [ln for ln in info if "spill" in ln]
    gate(bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
         ("decode_cluster spills", spills))
    F = cfg.mel.freq_bins
    streams = {}

    def run(plan, ins, n_frames=T):
        if plan.cluster not in streams:
            streams[plan.cluster] = decode_kernel.pack_decode_stream(
                {k: packed[k] for k in decode_kernel.MATRIX_NAMES}, plan)
        return decode_kernel.decode_fused(packed, *ins, n_frames=n_frames, freq_bins=F,
                                          plan=plan, stream=streams[plan.cluster])

    def cluster_sizes(B, ins, default):
        """The default plan and the plans chosen with clusters of 16 and of 8:
        ms, L2 bytes a frame."""
        out = {}
        for n in dict.fromkeys((default.cluster, 16, 8)):
            plan = decode_kernel.decode_cluster_plan(B, cfg.hidden_dim, F, cluster=n)
            ms = cuda_ms(lambda: run(plan, ins), reps=3)
            out[(n, plan.rows)] = ms
            log(f"[K1 cluster] B={B} cluster {n} rows {plan.rows}: {plan.tiles} tiles, "
                f"{plan.tiles * n} CTAs, {plan.waves} wave(s) of at most "
                f"{decode_kernel.H100_CLUSTERS_PER_WAVE[n]} clusters, smem {plan.smem_bytes} B; "
                f"{ms:.3f} ms = {1e3 * ms / T:.2f} us a frame; L2 "
                f"{plan.l2_bytes_per_frame / 1e6:.2f} MB a frame = "
                f"{plan.l2_bytes_per_frame * T / (ms * 1e-3) / 1e12:.3f} TB/s"
                f"{' (default plan)' if plan == default else ''} on [{smi}]")
        return out

    # B=64: the main path's batch
    B = kv[0].shape[0]
    plan64 = decode_kernel.decode_cluster_plan(B, cfg.hidden_dim, F)
    log(f"[K1 cluster] plan B={B}: {plan64}; {plan64.chunks_per_frame} chunks of the weight "
        f"stream a frame, {2 * plan64.cta_elems} bytes a CTA a frame")
    times64 = cluster_sizes(B, kv, plan64)
    ms64 = times64[(plan64.cluster, plan64.rows)]

    # One text position: the window cannot move, so no argmax flip parts the
    # rollouts; 64 frames pass the first wrap of every ring (2d ≤ 54), and a
    # stale cache tap moves the mel by more than the gate.
    k1, v1 = kv[0][:, :1].contiguous(), kv[1][:, :1].contiguous()
    y, _, _ = run(plan64, (k1, v1, *kv[2:]), n_frames=64)
    yq, _, _ = decode_kernel.decode_plain(packed, k1, v1, *kv[2:], n_frames=64, freq_bins=F)
    long_err = float((y.float() - yq.float()).abs().max())
    log(f"[K1 cluster] B={B} N=1 over 64 frames vs decode_plain: mel max|d| {long_err:.3g} "
        f"(gate 0.05)")
    gate(long_err <= 0.05, ("K1 long rollout", long_err))
    del y, yq
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    decode_kernel.decode_plain(packed, *kv, n_frames=T, freq_bins=F)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)

    # B=768: the bench batch, frames 0-1 against decode_plain, on two draws of
    # speakers
    texts = encode_texts([SENTENCES[i % len(SENTENCES)] for i in range(768)],
                         cfg.vocabulary, max_len=100)
    plan768 = decode_kernel.decode_cluster_plan(768, cfg.hidden_dim, F)
    packed32 = {k: v.float() for k, v in packed.items()}

    def top2_gap(att0):   # (rows, N) frame-0 attention -> its top-2 gap
        top = att0.float().topk(2, dim=1).values
        return top[:, 0] - top[:, 1]

    ok768 = []
    for spk_seed in (5, 6):
        spk = np.random.default_rng(spk_seed).normal(size=(768, cfg.spk_emb_dim))
        with torch.no_grad():
            K, V = mbf.encode_text(torch.from_numpy(texts).to(dev))
            sb = torch.from_numpy(spk.astype(np.float32)).to(dev, torch.bfloat16)
            kv768 = (K, V, mbf.audio_encoder.fc1(sb), mbf.audio_encoder.fc2(sb))
        y, a, p = run(plan768, kv768)
        yq, aq, _ = decode_kernel.decode_plain(packed, *kv768, n_frames=2, freq_bins=F)
        dy = (y[:, :2].float() - yq.float()).abs().amax(2)          # (B, 2)
        da = (a[:, :, :2].float() - aq.float()).abs().amax(1)       # (B, 2)
        mel2, att2 = float(dy.max()), float(da.max())
        flip = (a[:, :, 0].float().argmax(1) != aq[:, :, 0].float().argmax(1))
        rows = flip.nonzero().flatten()
        gap_k, gap_q = top2_gap(a[rows, :, 0]), top2_gap(aq[rows, :, 0])
        # Two more witnesses of each flipped row's frame 0: the cluster's
        # decomposition in plain torch (bf16, another summation order within
        # each product), and decode_plain in f32 on the same weights and inputs
        _, ae, _ = decode_kernel.decode_cluster_emulate(packed, *kv768, plan768, 1)
        _, a32, _ = decode_kernel.decode_plain(packed32, *(t.float() for t in kv768), n_frames=1,
                                               freq_bins=F)
        g32 = top2_gap(a32[:, :, 0])                     # every row's f32 near-tie gap
        rank32 = g32.argsort().argsort()
        near = g32.argsort()[:5]
        bad = ((dy > 0.05) | (da > 0.02)).any(1)
        log(f"[K1 cluster] bf16 B=768 speakers seed {spk_seed} vs decode_plain: frames 0-1 mel "
            f"max|d| {mel2:.3g} (gate 0.05), attention max|d| {att2:.3g} (gate 0.02); frame 0 "
            f"alone mel {float(dy[:, 0].max()):.3g} attention {float(da[:, 0].max()):.3g}; rows "
            f"over a gate {int(bad.sum())} {bad.nonzero().flatten().tolist()[:16]}; frame-0 "
            f"argmax flips on rows {rows.tolist()[:16]}: top-2 gap in the kernel "
            f"{gap_k.tolist()[:16]}, decode_plain {gap_q.tolist()[:16]}, the emulation "
            f"{top2_gap(ae[rows, :, 0]).tolist()[:16]} (argmax as the kernel "
            f"{(ae[rows, :, 0].float().argmax(1) == a[rows, :, 0].float().argmax(1)).tolist()[:16]}"
            f"), f32 decode_plain {g32[rows].tolist()[:16]} (rank of 768 from the smallest "
            f"{rank32[rows].tolist()[:16]}); smallest f32 gaps: rows {near.tolist()} "
            f"{g32[near].tolist()}; plan {plan768}")
        # An ulp flips a near-tied argmax (as in the onsets at B=64): a row whose
        # frame-0 argmax differs on a tie within 2 bf16 ulps at 0.5 (2^-8) on
        # both sides reads another window at frame 1. Frame 0 is held on every
        # row, frames 0-1 on the others, and such rows may be at most 1 % of the
        # batch.
        keep = ~flip
        ok = (float(dy[:, 0].max()) <= 0.05 and float(da[:, 0].max()) <= 0.02
              and float(dy[keep].max()) <= 0.05 and float(da[keep].max()) <= 0.02
              and bool((gap_q <= 2.0 ** -8).all()) and bool((gap_k <= 2.0 ** -8).all())
              and int(flip.sum()) <= 768 // 100 and bool(torch.isfinite(y.float()).all()))
        log(f"[K1 cluster] B=768 seed {spk_seed} gate: frame 0 on all rows, frames 0-1 on the "
            f"{int(keep.sum())} rows without a frame-0 near-tie flip: mel "
            f"{float(dy[keep].max()):.3g}, attention {float(da[keep].max()):.3g} -> "
            f"{'pass' if ok else 'FAIL'}")
        ok768.append(ok)
        del y, a, p, yq, aq, ae, a32
    times768 = cluster_sizes(768, kv768, plan768)
    gate(all(ok768), ("B=768", ok768))
    del kv768, K, V, packed32

    # the bound at B=64: the products (bf16, 989 TFLOP/s) against the bytes
    flop, nbytes = decode_work(cfg.hidden_dim, F, B, kv[0].shape[1], T, 2)
    b_ms, b_by = bound_ms(flop, nbytes, 989e12)
    log(f"[K1 cluster] B={B} T={T}: kernel {ms64:.3f} ms, decode_plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {flop / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); B=768 default "
        f"{times768[(plan768.cluster, plan768.rows)]:.3f} ms on [{smi}]")
    return dict(ms=ms64, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def f32_decode_phase(cuda_ms, build_models, onsets, before_onset, cfg, text_d, spk_d, T: int,
                     smi: str) -> dict:
    """Phase 4, f32 K1 (the 3xTF32 instance of csrc/decode_cluster.cu): its
    ptxas lines (spills fail), the gates at the main path's B=64, N=100 (per
    row, the first frame whose attention argmax differs, at least 32, and
    mel and attention within 1e-3 before it) against the eager f32 decode
    and against decode_plain, then its plans and CUDA-event times at B=64,
    N=100 and at the Trainer's validation shape B=16, N=186, against
    decode_plain and the bound. Returns the JSON entry (B=64)."""
    import torch

    from spoofsv_torch.infer.decode import make_decoder
    from spoofsv_torch.ops import _build, decode_kernel

    # each instantiation's "Function properties" line, then its spill and
    # register lines; the f32 ones are decode_cluster_kernel<float, ...>
    info = _build.BUILD_LOG["decode_cluster"].get("ptxas", [])
    lines = [ln for i, head in enumerate(info) if "decode_cluster_kernelIf" in head
             for ln in info[i:i + 3]]
    for ln in lines:
        log(f"[K1 f32] ptxas: {ln.strip()}")
    spills = [ln for ln in lines if "spill" in ln]
    gate(len(spills) == 4 and all("0 bytes spill stores, 0 bytes spill loads" in ln
                                  for ln in spills), ("K1 f32 spills", spills))
    F = cfg.mel.freq_bins
    # Random weights make the rollout chaotic once a near-tie flips an
    # argmax, so frames are held only before each row's first flip
    # (scripts/parity_tpu.py).
    m32, _ = build_models(torch.float32)
    packed32 = decode_kernel.pack_decode_weights(m32)
    with torch.no_grad():
        kv32 = (*m32.encode_text(text_d), m32.audio_encoder.fc1(spk_d),
                m32.audio_encoder.fc2(spk_d))
    yk, ak, _ = decode_kernel.make_fused_decoder(m32, T)(text_d, spk_d)
    mel_err = 0.0
    for ref_name, (yp, ap) in (
            ("eager f32 decode", make_decoder(m32, T)(text_d, spk_d)[:2]),
            ("decode_plain f32", decode_kernel.decode_plain(packed32, *kv32, n_frames=T,
                                                             freq_bins=F)[:2])):
        ons = onsets(ak, ap)
        mel, att = before_onset(yk, ak, yp, ap, ons)
        log(f"[K1 f32] B=64 N=100 T={T} vs {ref_name}: per-row divergence onset {ons}; before "
            f"onset mel max|d| {mel:.3g}, attention max|d| {att:.3g} (gates 1e-3, onset >= 32)")
        gate(min(ons) >= 32, (ref_name, ons))
        gate(mel <= 1e-3 and att <= 1e-3, (ref_name, mel, att))
        mel_err = max(mel_err, mel)
    del yk, ak, yp, ap
    # times alone (text encoder and speaker projections done once), the
    # bound: f32-accurate products as 3xTF32 (3 passes at 495 TFLOP/s)
    # against the f32 bytes
    rng = np.random.default_rng(2)
    text16 = torch.from_numpy(rng.integers(1, cfg.vocab_len - 1, (16, 186)).astype(np.int32))
    with torch.no_grad():
        text16 = text16.to(text_d.device)
        kv16 = (*m32.encode_text(text16), m32.audio_encoder.fc1(spk_d[:16]),
                m32.audio_encoder.fc2(spk_d[:16]))
    out = {}
    for B, kv in ((64, kv32), (16, kv16)):
        N = kv[0].shape[1]
        plan = decode_kernel.decode_cluster_plan(B, cfg.hidden_dim, F, elem=4)
        stream = decode_kernel.pack_decode_stream(
            {k: packed32[k] for k in decode_kernel.MATRIX_NAMES}, plan)
        ms = cuda_ms(lambda: decode_kernel.decode_fused(packed32, *kv, n_frames=T, freq_bins=F,
                                                        plan=plan, stream=stream), reps=3)
        plain = cuda_ms(lambda: decode_kernel.decode_plain(packed32, *kv, n_frames=T,
                                                           freq_bins=F), reps=1)
        flop, nbytes = decode_work(cfg.hidden_dim, F, B, N, T, 4)
        b_ms, b_by = bound_ms(3 * flop, nbytes, 495e12)
        log(f"[K1 f32] plan B={B}: {plan}; {plan.chunks_per_frame} chunks of the weight stream "
            f"a frame, {4 * plan.cta_elems} bytes a CTA a frame, L2 "
            f"{plan.l2_bytes_per_frame / 1e6:.2f} MB a frame")
        log(f"[K1 f32] B={B} N={N} T={T} (csrc/decode_cluster.cu, 3xTF32): kernel {ms:.3f} ms "
            f"(CUDA events, mean of 3) = {1e3 * ms / T:.2f} us a frame, decode_plain "
            f"{plain:.1f} ms; bound {b_ms:.4f} ms ({b_by}: 3 x {flop / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), {100 * b_ms / ms:.2f} % of it, on [{smi}]")
        out[B] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
    del m32, packed32, kv32, kv16
    return dict(name="decode_f32", route="cuda", source="spoofsv_torch/csrc/decode_cluster.cu",
                replaces="spoofsv_tpu/ops/pallas_decode.py:144", max_abs_err=mel_err,
                library_ms=None, **out[64])


def device_view(call, smi: str) -> None:
    """One call under ``torch.profiler``: the device time of its kernels and
    copies against the call's wall time (the device's idle share; the
    profiler's own host cost inflates the wall), and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_us = {}   # the device's own events (kernels, copies, sets), not the host ops
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            dev_us[e.key] = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
    if not sum(dev_us.values()):
        log("[main] device view: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
    log(f"[main] device view of one Synthesizer call: {busy_ms:.1f} ms of device time in "
        f"{wall_ms:.1f} ms of wall ({100 * (1 - busy_ms / wall_ms):.1f} % idle); largest: "
        + ", ".join(f"{k[:60]} {v / 1e3:.1f} ms" for k, v in top) + f" on [{smi}]")


def ssrn_impls(syn, mel, cuda_ms, smi: str) -> None:
    """The main path's SSRN stage (bf16, from the main path's mel) under the
    "xla", "fused_conv" (K4) and "fused_pair" (K5, K4 for unpaired blocks)
    highway impls: CUDA-event times, launches, and each kernel impl's output
    against "xla" within the bf16 gate (5e-2). Measurement only: the main
    path's impl stays "xla"."""
    import torch

    from spoofsv_torch.models.layers import gate_impl
    from spoofsv_torch.ops import hconv_kernel

    counters = {"K4": hconv_kernel.hconv_kernel, "K5": hconv_kernel.hconv_pair_kernel}
    outs, times = {}, {}
    for impl in ("xla", "fused_conv", "fused_pair"):
        with gate_impl(impl), torch.no_grad():
            for c in counters.values():
                c.launches = 0
            outs[impl] = syn.ssrn_apply(mel)
            n = {k: c.launches for k, c in counters.items()}
            times[impl] = cuda_ms(lambda: syn.ssrn_apply(mel), reps=5)
        log(f"[ssrn] B={mel.shape[0]} T={mel.shape[1]} {outs[impl].dtype} under {impl}: "
            f"{times[impl]:.3f} ms (CUDA events, mean of 5), launches of one call {n} on [{smi}]")
        gate(impl == "xla" or n["K4"] + n["K5"] > 0, (impl, "no highway kernel ran", n))
    for impl in ("fused_conv", "fused_pair"):
        err = float((outs[impl].float() - outs["xla"].float()).abs().max())
        log(f"[ssrn] {impl} vs xla: lin max|d| {err:.3g} (gate 5e-2), mean|d| "
            f"{float((outs[impl].float() - outs['xla'].float()).abs().mean()):.3g}")
        gate(err <= 5e-2 and bool(torch.isfinite(outs[impl].float()).all()), (impl, err))


def training_phase(cfg, dev, counters: dict, B: int, N: int, T: int):
    """Phase 7: the ordinary training path. For each train kind and highway
    impl, a ``Trainer`` takes 5 steps on one synthetic batch (B utterances,
    N text ids, T mel frames, 4T lin frames) from the same seed-0 weights,
    validates once and checkpoints; the checkpoint is reloaded and resumed.
    Launch counts are reset just before each run and read just after.
    Returns (K4/K5/K6 and f32 K1 launches summed over the runs, step ms per
    run)."""
    import torch

    from spoofsv_torch.cli.main import build_models
    from spoofsv_torch.models.layers import GATE_IMPLS, gate_impl
    from spoofsv_torch.train import Trainer
    from spoofsv_torch.weights import load_reference_checkpoint, load_state

    rng = np.random.default_rng(2)
    batch = {"text": rng.integers(1, cfg.vocab_len - 1, (B, N)).astype(np.int32),
             "mel": rng.uniform(0.05, 0.95, (B, T, cfg.mel.freq_bins)).astype(np.float32),
             "lin": rng.uniform(0.05, 0.95, (B, 4 * T, cfg.lin_bins)).astype(np.float32),
             "spk": rng.normal(size=(B, cfg.spk_emb_dim)).astype(np.float32)}
    torch.manual_seed(0)
    models = dict(zip(("train_text2mel", "train_ssrn"), build_models(cfg, device=dev)))
    init_sd = {k: {n: v.detach().clone() for n, v in m.state_dict().items()}
               for k, m in models.items()}
    impl_kernel = {"pallas": "highway_gate", "fused_conv": "highway_conv",
                   "fused_pair": "highway_conv_pair"}
    totals = dict.fromkeys([*impl_kernel.values(), "decode_f32"], 0)
    ckpt_keys = {"epoch", "iteration", "model_state_dict", "optimizer_state_dict",
                 "loss_val_log"}
    step_ms = {}
    with tempfile.TemporaryDirectory() as root:
        tcfg = cfg.replace(src_root_dir=root + "/", val_every_iter=5)
        for kind, model in models.items():
            first_loss = {}
            for impl in GATE_IMPLS:
                load_state(model, init_sd[kind])
                trainer = Trainer(tcfg, model, kind, ctime=f"{kind}-{impl}")
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                with gate_impl(impl):
                    trainer.fit(lambda: [batch] * 5, lambda: [batch], max_iterations=5)
                torch.cuda.synchronize()
                n = {k: c.launches for k, c in counters.items()}
                trainer.close()
                with open(os.path.join(trainer.ckpt.base, "metrics.jsonl")) as f:
                    recs = [json.loads(ln) for ln in f]
                losses = [r["loss"] for r in recs if r["split"] == "train"]
                secs = [r["sec_per_iter"] for r in recs if r["split"] == "train"]
                val = [r["loss"] for r in recs if r["split"] == "validate"]
                step_ms[f"{kind[6:]}/{impl}"] = round(1e3 * float(np.median(secs[1:])), 2)
                first_loss[impl] = losses[0]
                for k in totals:
                    totals[k] += n[k]
                log(f"[train] {kind} {impl}: losses {[round(v, 6) for v in losses]}; validation "
                    f"{val}; step ms (iters 2-5) {[round(1e3 * v, 2) for v in secs[1:]]}; "
                    f"launches {n}")
                gate(len(losses) == 5 and len(val) == 1, (kind, impl, losses, val))
                gate(bool(np.isfinite(losses + val).all()), (kind, impl, losses, val))
                gate(losses[-1] < losses[0], (kind, impl, "loss did not fall", losses))
                gate(abs(losses[0] - first_loss["xla"]) <= 1e-4 * abs(first_loss["xla"]),
                     (kind, impl, "step-1 loss vs xla", losses[0], first_loss["xla"]))
                # only the impl's own kernels ran (fused_pair runs K4 on unpaired blocks)
                own = {impl_kernel.get(impl)}
                if impl == "fused_pair":
                    own.add("highway_conv")
                gate(all(n[k] == 0 for k in impl_kernel.values() if k not in own),
                     (kind, impl, "a kernel of another impl ran", n))
                if impl in impl_kernel:
                    gate(n[impl_kernel[impl]] > 0, (kind, impl, "kernel not launched", n))
                if kind == "train_text2mel":
                    gate(n["decode_f32"] > 0, (kind, impl, "validation did not run K1 f32", n))
                # checkpoint round trip: reference schema, reload, resume
                path = trainer.ckpt.latest()
                ck = torch.load(path, map_location="cpu", weights_only=True)
                gate(set(ck) == ckpt_keys and ck["iteration"] == 5
                     and len(ck["optimizer_state_dict"]["state"]) == len(list(model.parameters())),
                     (kind, impl, sorted(ck), ck["iteration"]))
                fresh = build_models(cfg, device=dev)[0 if kind == "train_text2mel" else 1]
                load_reference_checkpoint(fresh, path)
                same = all(torch.equal(fresh.state_dict()[k], v)
                           for k, v in model.state_dict().items())
                again = Trainer(tcfg, fresh, kind, ctime=f"{kind}-{impl}")
                again.resume(path)
                again.close()
                gate(same and again.iteration == 5 and again.state.step == 5,
                     (kind, impl, "checkpoint round trip", same, again.iteration))
                del fresh, again, ck
    return totals, step_ms


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        sys.exit(2)
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))

    import dataclasses

    from spoofsv_torch import reference_precision
    from spoofsv_torch.config import Config
    from spoofsv_torch.data.text import encode_texts
    from spoofsv_torch.dsp import torchdsp
    from spoofsv_torch.infer.decode import make_decoder
    from spoofsv_torch.infer.synthesize import Synthesizer, finalize_audio
    from spoofsv_torch.models import SSRN, MelSyn
    from spoofsv_torch.ops import _build, decode_kernel, gate_kernel, gl_kernel, hconv_kernel

    dev = torch.device("cuda:0")

    # ---- phase 1: card and build -------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {build_s:.1f} s for {sorted(build)}")
    for name, info in build.items():
        for ln in info.get("ptxas", []):
            log(f"[ptxas {name}] {ln.strip()}")

    def cuda_ms(fn, reps: int = 3) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def test_mag(B: int, T: int, seed: int) -> torch.Tensor:
        """|STFT| of harmonic test signals (realistic structure for GL)."""
        rng = np.random.default_rng(seed)
        L = HOP * (T - 1)
        t = np.arange(L) / 22050.0
        sigs = [sum(np.sin(2 * np.pi * 110.0 * (1 + b % 4) * k * t + rng.uniform(0, 6)) / k
                    for k in range(1, 6)) + 0.1 * rng.normal(size=L) for b in range(B)]
        y = torch.from_numpy(np.stack(sigs) * np.hanning(L)).float().to(dev)
        re, im = torchdsp.stft_ri(y, NFFT, HOP)
        return torch.sqrt(re * re + im * im)[:, :T].contiguous()

    def spectral_err(audio: torch.Tensor, mag: torch.Tensor) -> float:
        re, im = torchdsp.stft_ri(audio, NFFT, HOP)
        got = torch.sqrt(re * re + im * im)[:, :mag.shape[1]]
        return float(torch.linalg.norm(got - mag) / torch.linalg.norm(mag))

    reference_precision()
    kernels = {}

    # ---- phase 2: K2 vs plain, at the main path's shape (B=64, T=1300) ------
    mag = test_mag(64, 1300, seed=1)
    seeds = torch.from_numpy(np.random.default_rng(1).integers(0, 2 ** 31 - 1, 64, np.int32))
    seeds[:4] = torch.tensor([0, 7, 123456, 2 ** 31 - 2])
    seeds = seeds.to(dev)
    k_re, k_im = gl_kernel.gl_init_angles(mag, NFFT, HOP, "spsi")
    p_re, p_im = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
    cos_dphi = float(((k_re * p_re + k_im * p_im)
                      / torch.sqrt(k_re ** 2 + k_im ** 2)).min())
    spsi_err = float(torch.maximum((k_re - p_re).abs(), (k_im - p_im).abs()).max())
    h_re, h_im = gl_kernel.gl_init_angles(mag, NFFT, HOP, "random", seeds)
    q_re, q_im = gl_kernel.init_angles_plain(mag, NFFT, HOP, "random", seeds)
    hash_err = float(torch.maximum((h_re - q_re).abs(), (h_im - q_im).abs()).max())
    a_re, _ = gl_kernel.gl_init_angles(mag, NFFT, HOP, "advance")
    b_re, _ = gl_kernel.init_angles_plain(mag, NFFT, HOP, "advance")
    adv_err = float((a_re - b_re).abs().max())
    log(f"[K2] spsi min cos dphi {cos_dphi:.7f} (gate >= 0.99995), max|d| {spsi_err:.3g}; "
        f"hash angles max|d| {hash_err:.3g}; advance max|d| {adv_err:.3g}")
    gate(cos_dphi >= 0.99995, cos_dphi)
    gate(hash_err < 1e-5 and adv_err < 1e-5, (hash_err, adv_err))
    k2_ms = cuda_ms(lambda: gl_kernel.gl_init_angles(mag, NFFT, HOP, "spsi"), reps=10)
    k2_plain = cuda_ms(lambda: gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi"))
    # bound: |S| in, the two angle planes out (f32; 512 MB, ten times the
    # L2, so back-to-back calls read and write device memory); ~30
    # operations a bin
    bins = mag.numel()
    b_ms, b_by = bound_ms(30.0 * bins, 3 * 4.0 * bins, 67e12)
    log(f"[K2] B=64 T=1300 spsi: kernel {k2_ms:.4f} ms (CUDA events, mean of 10), plain "
        f"{k2_plain:.3f} ms; bound {b_ms:.4f} ms ({b_by}: {3 * 4.0 * bins / 1e6:.1f} MB), "
        f"{100 * b_ms / k2_ms:.1f} % of it, on [{smi}]")
    kernels["gl_init"] = dict(
        name="gl_init", route="cuda", source="spoofsv_torch/csrc/gl.cu",
        replaces="spoofsv_tpu/ops/pallas_gl.py:618", max_abs_err=spsi_err, ms=k2_ms,
        plain_ms=k2_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- phase 3: K3 vs its plain versions -------------------------------------
    init = (p_re, p_im)
    gl_phase(dev, cuda_ms, mag, init, kernels, spectral_err, smi)
    del mag, init, k_re, k_im, p_re, p_im, h_re, h_im, q_re, q_im

    # ---- phase 4: K1 vs the plain eager decode --------------------------------
    cfg = Config()
    rng = np.random.default_rng(0)

    def build_models(dtype: torch.dtype, seed: int = 0):
        torch.manual_seed(seed)
        melsyn = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                        cfg.mel.freq_bins, cfg.hidden_dim)
        ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim)
        return melsyn.to(dev, dtype).eval(), ssrn.to(dev, dtype).eval()

    def onsets(a_k: torch.Tensor, a_p: torch.Tensor) -> list:
        """Per row, the first frame whose attention argmax differs (T if none)."""
        diff = (a_k.float().argmax(1) != a_p.float().argmax(1)).cpu().numpy()
        return [int(np.argmax(r)) if r.any() else diff.shape[1] for r in diff]

    texts = encode_texts([SENTENCES[i % len(SENTENCES)] for i in range(64)],
                         cfg.vocabulary, max_len=100)
    spk = rng.normal(size=(64, cfg.spk_emb_dim)).astype(np.float32)
    text_d = torch.from_numpy(texts).to(dev)
    spk_d = torch.from_numpy(spk).to(dev)

    T = cfg.max_frame_num

    def before_onset(yk, ak, yp, ap, ons):
        """max |mel diff|, max |attention diff| over each row's frames before its onset."""
        mel = max(float((yk[i, :o].float() - yp[i, :o].float()).abs().max()) if o else 0.0
                  for i, o in enumerate(ons))
        att = max(float((ak[i, :, :o].float() - ap[i, :, :o].float()).abs().max()) if o else 0.0
                  for i, o in enumerate(ons))
        return mel, att

    kernels["decode_f32"] = f32_decode_phase(cuda_ms, build_models, onsets, before_onset, cfg,
                                             text_d, spk_d, T, smi)

    # bf16 (the main path's dtype) against decode_plain, the kernel's arithmetic in
    # plain torch (bf16 operands, f32 accumulation). Summation order alone moves
    # bf16 roundings by an ulp; with random weights the 3-wide attention window is
    # often near a tie, so an ulp flips the in-loop argmax within a few frames, and
    # the bf16-rounded attention the decoders return can hide that flip. So the
    # gates of scripts/parity_tpu.py (mel 0.05, attention 0.02) hold frames 0 and 1
    # of every row: the whole network once with empty caches, then once with ring
    # reads, before any AR feedback. Onsets are context.
    mbf, sbf = build_models(torch.bfloat16)
    fused_bf = decode_kernel.make_fused_decoder(mbf, T)
    plain_bf = make_decoder(mbf, T)
    yk, ak, _ = fused_bf(text_d, spk_d)
    with torch.no_grad():
        K, V = mbf.encode_text(text_d)
        spk_b = spk_d.to(torch.bfloat16)
        s1, s2 = mbf.audio_encoder.fc1(spk_b), mbf.audio_encoder.fc2(spk_b)
    packed_bf = decode_kernel.pack_decode_weights(mbf)
    yq, aq, _ = decode_kernel.decode_plain(packed_bf, K, V, s1, s2, n_frames=T,
                                           freq_bins=cfg.mel.freq_bins)
    mel2 = float((yk[:, :2].float() - yq[:, :2].float()).abs().max())
    att2 = float((ak[:, :, :2].float() - aq[:, :, :2].float()).abs().max())
    ons_q = onsets(ak, aq)
    yp, ap, _ = plain_bf(text_d, spk_d)
    ons_bf = onsets(ak, ap)
    log(f"[K1] bf16 B=64 T={T} vs decode_plain: frames 0-1 mel max|d| {mel2:.3g} "
        f"(gate 0.05), attention max|d| {att2:.3g} (gate 0.02); onset min {min(ons_q)} "
        f"median {int(np.median(ons_q))}; vs eager bf16 onset min {min(ons_bf)} median "
        f"{int(np.median(ons_bf))} (context)")
    gate(mel2 <= 0.05 and att2 <= 0.02, (mel2, att2))
    del yk, ak, yq, aq, yp, ap
    k1_ms = cuda_ms(lambda: fused_bf(text_d, spk_d), reps=2)
    k1_plain = cuda_ms(lambda: plain_bf(text_d, spk_d), reps=1)
    log(f"[K1] bf16 B=64 N=100 T=325 decode (incl. text encoder): kernel {k1_ms:.3f} ms, "
        f"plain eager {k1_plain:.3f} ms")
    k1 = cluster_phase(dev, cuda_ms, mbf, packed_bf, (K, V, s1, s2), cfg, T, smi)
    kernels["decode"] = dict(
        name="decode", route="cuda",
        source="spoofsv_torch/csrc/decode_cluster.cu",
        replaces="spoofsv_tpu/ops/pallas_decode.py:144", max_abs_err=mel2, **k1)
    del K, V, s1, s2, packed_bf

    # ---- phase 5: the main path ----------------------------------------------
    syn = Synthesizer(cfg, mbf, sbf, n_frames=cfg.max_frame_num,
                      gl_iters=cfg.tpu.griffin_lim_iters)
    counters = {"decode": decode_kernel.decode_kernel, "gl_init": gl_kernel.init_kernel,
                "griffin_lim": gl_kernel.gl_tc_kernel, "griffin_lim_f32": gl_kernel.gl_kernel}
    cluster = decode_kernel.cluster_kernel   # the bf16 instance of K1 alone

    def drive() -> dict:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        mel, _, _ = syn.decode(text_d, spk_d)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        lin = syn.ssrn_apply(mel)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        audio = syn.vocode(lin)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        return dict(audio=audio, lin=lin,
                    stages_ms={"decode": 1e3 * (t[1] - t[0]), "ssrn": 1e3 * (t[2] - t[1]),
                               "vocoder": 1e3 * (t[3] - t[2])})

    # the main path as a user calls it, with the launch counts reset around it
    for c in [*counters.values(), cluster]:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, mel, attn = syn(texts, spk)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    B, L = audio.shape
    log(f"[main] launches {launches}, of which decode_cluster.cu {cluster.launches}; audio "
        f"{tuple(audio.shape)}; first call {first_s:.3f} s")
    gate(all(n > 0 for k, n in launches.items() if k != "griffin_lim_f32"), launches)
    gate(launches["decode"] == 1 and cluster.launches == 1,
         ("the main path's K1 did not run decode_cluster.cu once", launches, cluster.launches))
    gate(launches["griffin_lim"] == 1 and launches["griffin_lim_f32"] == 0,
         ("the main path's K3 did not run gl_tc.cu once and gl.cu never", launches))
    gate((B, L) == (64, HOP * (4 * cfg.max_frame_num - 1)), audio.shape)
    gate(mel.shape == (64, cfg.max_frame_num, cfg.mel.freq_bins)
         and attn.shape == (64, 100, cfg.max_frame_num), (mel.shape, attn.shape))
    gate(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) > 1e-4,
         "main-path audio is not finite or is silent")
    wavs = [finalize_audio(a, cfg, trim_db=30.0, max_seconds=9.0)
            for a in audio.cpu().numpy()]
    gate(all(np.isfinite(w).all() and len(w) > 0 for w in wavs), "finalize_audio output")
    # steady state: per-stage times, then the whole call for the end-to-end rate
    staged = drive()
    gate(staged["lin"].shape == (64, 4 * cfg.max_frame_num, cfg.lin_bins), staged["lin"].shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syn(texts, spk)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    audio_s = B * L / cfg.sampling_rate
    rate = audio_s / wall_s
    log(f"[main] steady stages ms "
        f"{ {k: round(v, 3) for k, v in staged['stages_ms'].items()} }; whole call: "
        f"{audio_s:.1f} s of audio in {wall_s:.3f} s = {rate:.2f} audio s per wall s "
        f"on [{smi}]")
    device_view(lambda: syn(texts, spk), smi)
    for k, n in launches.items():
        kernels[k]["launches"] = n
    ssrn_impls(syn, mel, cuda_ms, smi)
    del mbf, sbf, syn, staged, fused_bf, plain_bf, audio, mel, attn

    # small f32 end-to-end: the CUDA path against the CPU (plain) path
    # "highest": the f32 K3 on the card, plain f32 GL on the CPU (int8 GL
    # turns the paths' ~1e-6 mel differences into rounding flips that momentum
    # amplifies; phase 3 holds the int8 K3 against its plain version)
    tiny = dataclasses.replace(cfg.tpu, griffin_lim_iters=4, griffin_lim_precision="highest")
    cfg_s = cfg.replace(tpu=tiny)
    m_c, s_c = build_models(torch.float32, seed=3)
    m_h = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                 cfg.mel.freq_bins, cfg.hidden_dim)
    s_h = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim)
    m_h.load_state_dict(m_c.state_dict())
    s_h.load_state_dict(s_c.state_dict())
    a_c, mel_c, att_c = Synthesizer(cfg_s, m_c, s_c, n_frames=24)(texts[:2], spk[:2])
    a_h, mel_h, att_h = Synthesizer(cfg_s, m_h.eval(), s_h.eval(), n_frames=24)(texts[:2],
                                                                                spk[:2])
    ons_s = onsets(att_c.cpu(), att_h)
    mel_s = float((mel_c.cpu() - mel_h).abs().max())
    rel_s = float(torch.linalg.norm(a_c.cpu() - a_h) / torch.linalg.norm(a_h))
    # audio gate: the repo's GL kernel-vs-XLA gate (tests/test_pallas_gl.py:97);
    # GL with momentum 0.99 amplifies the ~1e-6 mel/SSRN differences
    log(f"[main] f32 B=2 T=24 GL4, CUDA vs CPU: mel max|d| {mel_s:.3g} (gate 1e-3), "
        f"audio rel-L2 {rel_s:.3g} (gate 0.03), onsets {ons_s}")
    gate(min(ons_s) == 24 and mel_s <= 1e-3 and rel_s < 0.03, (ons_s, mel_s, rel_s))

    del m_c, s_c, m_h, s_h, a_c, a_h, mel_c, mel_h, att_c, att_h

    # ---- phase 6: K4/K5/K6 vs their plain versions -----------------------------
    t0 = time.perf_counter()
    highway_kernel_phase(dev, cuda_ms, kernels, smi)
    log(f"[time] phase 6 {time.perf_counter() - t0:.1f} s")

    # ---- phase 7: the ordinary training path at full width --------------------
    counters.update({"highway_gate": gate_kernel.gate_kernel,
                     "highway_conv": hconv_kernel.hconv_kernel,
                     "highway_conv_pair": hconv_kernel.hconv_pair_kernel,
                     "decode_f32": decode_kernel.f32_kernel})
    t0 = time.perf_counter()
    train_launches, step_ms = training_phase(cfg, dev, counters, B=16, N=186, T=325)
    log(f"[time] phase 7 {time.perf_counter() - t0:.1f} s")
    for k, v in train_launches.items():
        kernels[k]["launches"] = v
    log(f"[train] step ms per impl, B=16 N=186 T=325 f32 (median of iterations 2-5): "
        f"{step_ms} on [{smi}]")

    # a kernel faster than the least time the card could take means a bound
    # or a timing is wrong (data left in the L2, a rate too low)
    for k in kernels.values():
        gate(k["ms"] >= k["bound_ms"], (k["name"], "time under its bound", k["ms"], k["bound_ms"]))
    out = {"kernels": list(kernels.values())}
    log(json.dumps(out))
    log(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
