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
     through the f32 K1) and one checkpoint round trip each; then the same
     runs under bf16 autocast over the f32 parameters, K4-K6's bf16
     instances held against their plain versions on each run's own first
     call (5e-2), Text2Mel's validation through the bf16 K1; launch counts
     reset just before each run and read just after;
  8. serving: seed-0 bf16 weights saved as ``.tar.pth`` and loaded by
     ``load_generator_params``, a warmed ``BatchingSynthesizer`` (rungs
     1-8, frames buckets 120/200/325, speculative, attention trim) behind
     ``make_http_server``: 32 concurrent requests (all 200, audio finite,
     K1/K2/K3 once a batch run and the f32 K3 never, the worker on the
     default stream), a 400, a 404 and a 413; latency, requests per second,
     each rung x bucket's call time, the burst's time split between the
     worker's device calls, its host finalize and the handler threads;
     K1 at every rung and bucket against ``decode_plain`` (frames 0-1), a
     row alone and in a batch of 8 bit-equal, K2 and K3 at B=8 per bucket
     against their plain versions, each timed against its bound; one
     request solo against co-batched, and where the text encoder's
     outputs part between B=1 and B=8 (cuDNN on and off);
  9. spoof-set synthesis: ``generate_spoof_set`` of 8 speakers x 20
     sentences, one B=160 call under K1's 8x16 plan, 160 wavs in the
     reference layout; K1 on that call's inputs against ``decode_plain``
     (frames 0-1); the call's time, the host tail's, audio s per wall s;
 10. the training CLI (``python -m spoofsv_torch.cli.main``'s ``main``) on a
     toy corpus of 4 speakers x 24 utterances of 110-160 characters, the
     shipping widths, f32, batch 16: ``train_text2mel --adversarial`` (12
     iterations, "fused_pair", validations through the f32 K1),
     ``train_ssrn --adversarial`` ("fused_conv"), ``-R latest`` for 2 more
     ("pallas", the resumed state bit-equal to its checkpoint) and
     ``synthesize`` from the best checkpoints (bf16 K1, K2, K3); each G and
     D step's launches and time; a G and a D step of each impl from the
     same weights against "xla"; no highway kernel in a critic's penalty;
     steady G/D step times (Text2Mel's also under bf16 autocast) and one of
     each under ``torch.profiler``; the
     "wgan" (clipped) and "vanilla" critics for 6 iterations; 6 bf16
     Text2Mel iterations (``train_compute_dtype="bfloat16"``, "fused_pair"),
     K5 and K4 held on the run's own inputs, the validation's bf16 K1 on
     its own batches against ``decode_plain``;
 11. the GE2E attack path through the CLIs' ``main(argv)``: a toy corpus of
     12 speakers x 24 utterances prepared by ``cli/metagen.py``;
     ``cli/generate_test_utterances.py`` with staging (bf16 synthesis of
     the 20 Harvard sentences a speaker, K1-K3 held on each call's own
     inputs; the i-vector, GE2E and anti-spoofing layouts, every staged
     FLAC read back to its int16 samples); ``cli/ge2e.py`` ``preprocess``,
     ``train`` at full width (LSTM 3x768, projection 256, N=6 x M=50 crops
     of 120 x 40, 8 steps), ``test`` (EER, the clean threshold from the
     staged real-only copy, the spoof rate) and ``dvector``; the GE2E step
     time, the embedder's utterances/s at B=960 x 120 x 40 (bf16, f32), the
     staging and preprocessing seconds;
 12. the scoring of the attack on phase 11's tree, through the CLIs' ``main(argv)``:
     ``cli/ivector.py`` at 64 Gaussians / 100 dims with the native and the
     torch backends (EERs, spoof rates), the torch backend's Baum-Welch stats
     and extractions against native on the staged train utterances' own
     features, the full configuration (1024 Gaussians, 400 dims, full UBM,
     deltas) on the card with ``--models_dir``, trained and then reused,
     every stage timed, ``--recompute_eer`` against ``result.json``;
     ``cli/antispoof.py`` on a toy train protocol (200 steps at batch 64 on
     mel, each timed; one step of v1, v2 and lin), ``dev`` on the staged
     spoofs (CM EER), a checkpoint round trip; the GE2E and i-vector curves
     against numpy recomputations, the PNG when matplotlib is installed; no
     hand-written kernel launches;
 13. the mesh layer (``spoofsv_torch.parallel``): two ranks time-sharing
     the card over gloo (NCCL refuses two ranks on one device), each a
     process of its own: sharded synthesis at phase 5's shape (each rank's
     rows bit-equal to a single-rank call at B=32, the gathered batch
     bit-equal to the B=64 call with cuDNN off, K1-K3 against their plain
     versions at the shard's shapes); sharded WGAN-GP Text2Mel training
     ("fused_pair", f32, B=16, plain and masked: ranks bit-equal, the first
     steps' gradients within phase 10's gates of one rank's, K4-K6 at the
     shard's shapes); ``generate_test_utterances`` and ``serve`` with
     ``--mesh 2 --mesh_share`` (wavs and a burst of 8 replies against
     single-rank synthesis of the same rows); the NCCL path at world size 1.
     Each rank reports its launches; they are summed under the path "mesh".
 14. the paper's whole experiment from one entry point:
     ``python -m spoofsv_torch.cli.campaign``'s ``main`` at full width and
     reduced depth (10 speakers x 10 utterances, 4 evaluation sentences,
     200 Text2Mel and SSRN steps, 100 adversarial, 40 GE2E epochs, 200 CM
     steps; the cuts in ``CAMPAIGN_DEPTH``), every stage on the card, the
     split variant ``--split_suffix _s7`` and a resumed call that runs
     nothing; each stage's launches held to ``CAMPAIGN_KERNELS`` (K4-K6
     never); the results (every marker and report key, EERs and spoof rates
     in [0, 1], the spoof-wav count, the curves' points); K1 f32 and bf16,
     K2 and K3 held against their plain versions on the trained weights,
     the first frame where the bf16 attention argmax parts; the f32
     ``csrc/gl.cu`` (the corpus's GL64 copy-synthesis, its first caller)
     against plain f32 GL from the same init (relative L2 1e-3), timed
     against its bound; and ``python -m spoofsv_torch.cli.train_toy_e2e 2500`` in
     a process of its own beside the campaign (the loss at most 0.75 of its
     start, forward fraction >= 0.95);
 15. the post-campaign checks on phase 14's tree, each through its port in
     ``spoofsv_torch/cli/`` (``main(argv, device)``), its launches counted
     from 0 around it (the path "checks"): ``gl_init_check`` at B=16
     (spectral convergence of eight init/iteration combos through K2 and
     ``gl.cu``, and of GL12/GL16 through K2 and K3 int8 and bf16, on the
     trained TTS's magnitudes), ``gl_mcd_ab`` (the MCD of five GL
     candidates, copy-synthesis and TTS, over the synthesize split;
     copy-synthesis spsi@12 at most 0.5 dB above random@64),
     ``exp_gl_init`` (B=6, T=400: K2 at lock 1, 0 and -1, ``gl.cu`` from 0
     to 64 iterations), ``spec_rate_diag`` (every text x speaker pair at 160
     frames), ``gl24_check`` and ``gl_spsi_check``'s spsi@16 (spoof sets
     regenerated and re-scored by the trained GE2E, i-vector and CM),
     ``ivector_delta_rescore`` (1024 / 400, cached and trained afresh) and
     ``vad_ab`` (20 utterances, the campaign's GE2E); K1 bf16 against
     ``decode_plain`` over frames 0-1 on each check's own inputs, K2 in
     every mode (lock 0 and -1 included) and K3 int8 and bf16 against their
     plain versions, ``gl.cu`` at 0, 1 and 64 iterations against plain f32 GL
     (GL64 also against float64 GL, its bound from plain f32 GL's distance),
     K2 at lock -1 and ``gl.cu`` at 0 iterations timed against their bounds;
 16. multi-speaker Tacotron 2 (``Tacotron2Synthesizer``, published widths,
     bf16) on the spoof-set call, B=160, N=49, 1000 steps: launches reset
     just before (each step kernel 1000 times, no graph capture, K2 and K3
     once); the captured rollout bit-equal to its steps run eagerly; the
     whole rollout against ``rollout_plain``'s steps resumed every 25 steps
     from its kept state (the Tacotron 2 cell's limits); ``t2_att_step_kernel``
     and ``t2_dec_step_kernel`` against their plain versions on that call's
     states at steps 0, 500 and 975, each timed against its bound.
Prints a kernels JSON line (each kernel's time, plain time, launches on
the main path, launches on each path, and bound), the card line, then the
``{"ok": true, ...}`` line last.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
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
    "Four hours of steady work faced us.",
    "Large size in stockings is hard to sell.",
    "The boy was there when the sun rose.",
    "A rod is used to catch pink salmon.",
    "The source of the huge river is the clear spring.",
    "Kick the ball straight and follow through.",
    "Help the woman get back to her feet.",
    "A pot of tea helps to pass the evening.",
    "Smoky fires lack flame and heat.",
    "The soft cushion broke the man's fall.",
    "The salt breeze came across from the sea.",
    "The girl at the booth sold fifty bonds.",
]   # Harvard sentences, lists 1-2; phases 4-5 and 8 take the first 8
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
        b_ms, b_by, ops = gl_tc_bound(Bm, Tm, int8)
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


def gl_tc_bound(B: int, T: int, int8: bool) -> tuple:
    """The tensor-core K3's GL12 bound at B utterances of T frames: (ms, "bytes"
    or "operations", the multiply-add operations of one pass). Per frame and
    iteration a synthesis and an analysis product of 1024 x 1024
    multiply-adds (int8 at 1,979 TOP/s, or bf16 at 989 TFLOP/s), plus the
    final bf16 synthesis; bytes: |S| and the two initial angle planes in,
    the f32 audio out."""
    ops = 2.0 * 1024 * 1024 * B * T
    t_ops = 12 * 2 * ops / (1979e12 if int8 else 989e12) + ops / 989e12
    t_bytes = 4.0 * (3 * B * T * (NFFT // 2 + 1) + B * HOP * (T - 1)) / 3.35e12
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops


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
    texts = encode_texts([SENTENCES[i % 8] for i in range(768)],
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
        # the same rows through hold_k1: each row held through its flip frame
        # (seed 5's row 696 flips its frame-0 argmax, ROADMAP C)
        hold_k1(mbf, texts, spk, 2, dev, f"K1 cluster B=768 speakers seed {spk_seed}")
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


def device_view(call, smi: str, what: str = "[main] device view of one Synthesizer call") -> None:
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
        log(f"{what}: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
    log(f"{what}: {busy_ms:.1f} ms of device time in "
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


# K4-K6's launch functions: counter name -> (module, launch, plain version)
HIGHWAY_LAUNCH = {"highway_gate": ("gate_kernel", "gate_launch", "highway_gate_plain"),
                  "highway_conv": ("hconv_kernel", "hconv_launch", "highway_conv_plain"),
                  "highway_conv_pair": ("hconv_kernel", "hconv_pair_launch",
                                        "highway_pair_plain")}


@contextlib.contextmanager
def recording_highway(store: dict):
    """Within the block, the first call of each of K4-K6's launch functions
    records its arguments (tensors detached and copied) in ``store``."""
    import torch

    from spoofsv_torch.ops import gate_kernel, hconv_kernel

    mods = {"gate_kernel": gate_kernel, "hconv_kernel": hconv_kernel}
    saved = []
    for name, (mod, fn, _) in HIGHWAY_LAUNCH.items():
        orig = getattr(mods[mod], fn)

        def run(*args, _orig=orig, _name=name, **kw):
            if _name not in store:
                store[_name] = [a.detach().clone() if isinstance(a, torch.Tensor) else a
                                for a in args]
            return _orig(*args, **kw)

        setattr(mods[mod], fn, run)
        saved.append((mods[mod], fn, orig))
    try:
        yield store
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def hold_highway(store: dict, tol: float, what: str, dtype) -> None:
    """Each recorded kernel call again, against its plain version on the same
    arguments (outside any counted run): max |d| <= ``tol``, inputs in ``dtype``."""
    import torch

    from spoofsv_torch.ops import gate_kernel, hconv_kernel

    mods = {"gate_kernel": gate_kernel, "hconv_kernel": hconv_kernel}
    for name, args in sorted(store.items()):
        mod, fn, plain = HIGHWAY_LAUNCH[name]
        with torch.no_grad():
            got = getattr(mods[mod], fn)(*args)
            want = getattr(mods[mod], plain)(*args)
        d = float((got.float() - want.float()).abs().max())
        log(f"[{what}] {name} on the run's own inputs {tuple(args[0].shape)} {args[0].dtype}: "
            f"kernel vs plain max|d| {d:.3g} (gate {tol})")
        gate(args[0].dtype == dtype and d <= tol, (what, name, args[0].dtype, d))


def training_phase(cfg, dev, counters: dict, B: int, N: int, T: int):
    """Phase 7: the ordinary training path. For each train kind and highway
    impl, a ``Trainer`` takes 5 steps on one synthetic batch (B utterances,
    N text ids, T mel frames, 4T lin frames) from the same seed-0 weights,
    validates once and checkpoints; the checkpoint is reloaded and resumed.
    Then the same runs under bf16 autocast over the f32 parameters
    (``train_compute_dtype="bfloat16"``): K4-K6's bf16 instances, each held
    against its plain version on the first call's own inputs (5e-2), the
    validation through the bf16 K1. Launch counts are reset just before each
    run and read just after. Returns (K4/K5/K6 and f32 K1 launches summed
    over the f32 runs, step ms per run, K4-K6 and K1 launches summed over
    the bf16 runs)."""
    import torch

    from spoofsv_torch.cli.main import build_models
    from spoofsv_torch.models.layers import GATE_IMPLS, gate_impl
    from spoofsv_torch.ops import decode_kernel
    from spoofsv_torch.train import Trainer
    from spoofsv_torch.weights import load_reference_checkpoint, load_state

    rng = np.random.default_rng(2)
    batch = {"text": rng.integers(1, cfg.vocab_len - 1, (B, N)).astype(np.int32),
             "mel": rng.uniform(0.05, 0.95, (B, T, cfg.mel.freq_bins)).astype(np.float32),
             "lin": rng.uniform(0.05, 0.95, (B, 4 * T, cfg.lin_bins)).astype(np.float32),
             "spk": rng.normal(size=(B, cfg.spk_emb_dim)).astype(np.float32)}
    torch.manual_seed(0)
    models = dict(zip(("train_text2mel", "train_ssrn"), build_models(cfg, device=dev)[:2]))
    init_sd = {k: {n: v.detach().clone() for n, v in m.state_dict().items()}
               for k, m in models.items()}
    impl_kernel = {"pallas": "highway_gate", "fused_conv": "highway_conv",
                   "fused_pair": "highway_conv_pair"}
    totals = dict.fromkeys([*impl_kernel.values(), "decode_f32"], 0)
    bf16_totals = dict.fromkeys([*impl_kernel.values(), "decode_bf16", "decode_f32"], 0)
    cluster_counter = decode_kernel.cluster_kernel
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
            # bf16: autocast over the f32 parameters, every impl, 5 steps
            for impl in GATE_IMPLS:
                load_state(model, init_sd[kind])
                trainer = Trainer(tcfg, model, kind, ctime=f"{kind}-{impl}-bf16",
                                  compute_dtype=torch.bfloat16)
                recorded = {}
                for c in [*counters.values(), cluster_counter]:
                    c.launches = 0
                torch.cuda.synchronize()
                with gate_impl(impl), recording_highway(recorded):
                    trainer.fit(lambda: [batch] * 5, lambda: [batch], max_iterations=5)
                torch.cuda.synchronize()
                n = {k: c.launches for k, c in counters.items()}
                n["decode_bf16"] = cluster_counter.launches
                trainer.close()
                with open(os.path.join(trainer.ckpt.base, "metrics.jsonl")) as f:
                    recs = [json.loads(ln) for ln in f]
                losses = [r["loss"] for r in recs if r["split"] == "train"]
                secs = [r["sec_per_iter"] for r in recs if r["split"] == "train"]
                val = [r["loss"] for r in recs if r["split"] == "validate"]
                step_ms[f"{kind[6:]}/{impl}/bf16"] = round(1e3 * float(np.median(secs[1:])), 2)
                for k in bf16_totals:
                    bf16_totals[k] += n[k]
                log(f"[train bf16] {kind} {impl}: losses {[round(v, 6) for v in losses]}; "
                    f"validation {val}; step ms (iters 2-5) "
                    f"{[round(1e3 * v, 2) for v in secs[1:]]} (f32: "
                    f"{step_ms[f'{kind[6:]}/{impl}']}); launches {n}")
                gate(len(losses) == 5 and len(val) == 1
                     and bool(np.isfinite(losses + val).all()), (kind, impl, "bf16", losses, val))
                gate(abs(losses[0] - first_loss["xla"]) <= 2e-2 * abs(first_loss["xla"]),
                     (kind, impl, "bf16 step-1 loss vs f32", losses[0], first_loss["xla"]))
                gate(all(p.dtype == torch.float32 for p in model.parameters())
                     and all(v.dtype == torch.float32 for st in
                             trainer.state.optimizer.state.values()
                             for key, v in st.items() if key != "step"),
                     (kind, impl, "bf16 training left f32 parameters or Adam state"))
                if impl in impl_kernel:
                    gate(n[impl_kernel[impl]] > 0 and impl_kernel[impl] in recorded,
                         (kind, impl, "bf16 kernel not launched", n))
                if kind == "train_text2mel":
                    gate(n["decode_bf16"] > 0 and n["decode_f32"] == 0,
                         (kind, impl, "bf16 validation did not run K1 bf16", n))
                hold_highway(recorded, 5e-2, f"train bf16 {kind} {impl}", torch.bfloat16)
    return totals, step_ms, bf16_totals


# The serving phase's clients: argv url, a JSON file of request bodies. Fires
# them all at once from threads; prints one JSON line: the wall time from the
# first send to the last reply, and per request its status, latency (ms),
# sampling rate, sample count and whether every sample is finite.
HTTP_CLIENT = r"""
import io, json, sys, threading, time, urllib.error, urllib.request
import numpy as np
from scipy.io import wavfile
url, path = sys.argv[1], sys.argv[2]
with open(path) as f:
    bodies = [json.dumps(b).encode() for b in json.load(f)]
out = [None] * len(bodies)
def fire(i):
    req = urllib.request.Request(url + "/synthesize", data=bodies[i],
                                 headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, ctype, body = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        code, ctype, body = e.code, e.headers["Content-Type"], e.read()
    ms = 1e3 * (time.perf_counter() - t)
    sr, y = 0, np.zeros(0, np.float32)
    if code == 200 and ctype == "audio/wav":
        sr, y = wavfile.read(io.BytesIO(body))
        y = y.astype(np.float32) / 32767.0
    elif code == 200:
        js = json.loads(body)
        sr, y = js["sr"], np.asarray(js["samples"], np.float32)
    out[i] = {"code": code, "ms": ms, "sr": sr, "n": len(y),
              "finite": bool(np.isfinite(y).all()), "head": body[:200].decode("latin-1")
              if code != 200 else ""}
threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(bodies))]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"wall_s": time.perf_counter() - t0, "replies": out}))
"""


def serving_phase(cfg, dev, state_dicts, counters: dict, cluster, cuda_ms, test_mag,
                  spectral_err, smi: str) -> dict:
    """Phase 8: the serving path as a user starts it (``spoofsv_torch.cli.serve``'s
    steps): the shipping ``Config()`` at full width in bf16 from seed-0
    weights saved as reference ``.tar.pth`` and loaded by
    ``load_generator_params``; a ``BatchingSynthesizer`` (rungs 1-8, frames
    buckets 120/200/325, speculative, attention trim 4) warmed; an HTTP
    server over 4 speakers answering 32 concurrent requests; then the bad
    requests, each bucket's call time, where a burst's time goes (worker
    and handler threads), K1, K2 and K3 alone at the serving shapes against
    their plain versions and their bounds, and one request solo against
    co-batched, with where the text encoder's outputs part between batch
    sizes. Returns the serving launches of each kernel."""
    import threading
    import urllib.error
    import urllib.request

    import torch

    from spoofsv_torch.cli.main import apply_runtime_knobs, build_models, inference_dtype
    from spoofsv_torch.data.text import encode_texts
    from spoofsv_torch.infer.synthesize import Synthesizer, gl_seeds
    from spoofsv_torch.ops import _build, decode_kernel, gl_kernel
    from spoofsv_torch.serve import (MAX_BODY_BYTES, BatchingSynthesizer, SpeakerTable,
                                     make_http_server)
    from spoofsv_torch.weights import load_generator_params

    buckets, ladder, C, F = [120, 200, 325], [1, 2, 4, 8], cfg.hidden_dim, cfg.mel.freq_bins
    with tempfile.TemporaryDirectory() as root:
        paths = {}
        for kind, sd in state_dicts.items():
            paths[kind] = os.path.join(root, f"{kind}_iteration_0.tar.pth")
            torch.save({"model_state_dict": sd}, paths[kind])
        apply_runtime_knobs(cfg, infer=True)
        melsyn, ssrn, _, _ = build_models(cfg, dtype=inference_dtype(cfg, dev), device=dev)
        load_generator_params(paths["text2mel"], melsyn)
        load_generator_params(paths["ssrn"], ssrn)
        gate(next(melsyn.parameters()).dtype == torch.bfloat16, "serving models are not bf16")
        syn = Synthesizer(cfg, melsyn, ssrn)
        batcher = BatchingSynthesizer(cfg, syn, max_batch=8, batch_wait_ms=10,
                                      frames_buckets=buckets, frames_per_char=3.0,
                                      speculative=True, attn_trim=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batcher.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        log(f"[serve] warmup of rungs {batcher._ladder()} x frames {batcher.frames_buckets}: "
            f"{warm_s:.2f} s")
        rng = np.random.default_rng(8)
        names = [f"p{225 + i}" for i in range(4)]
        os.makedirs(os.path.join(root, "spk_emb"))
        embs = rng.normal(size=(4, cfg.spk_emb_dim)).astype(np.float32)
        for name, e in zip(names, embs):
            np.save(os.path.join(root, "spk_emb", name + ".npy"), e)
        # the worker's stream and the batches it ran
        worker = {"streams": set(), "batches": []}
        process = batcher._process

        def traced(batch, frames):
            worker["streams"].add(_build.stream_ptr(dev) == torch.cuda.default_stream(dev)
                                  .cuda_stream)
            t = time.perf_counter()
            process(batch, frames)
            worker["batches"].append((len(batch), frames,
                                      round(1e3 * (time.perf_counter() - t), 1)))

        batcher._process = traced
        httpd = make_http_server(batcher, SpeakerTable(os.path.join(root, "spk_emb")), port=0)
        # where a burst's time goes, host clock: in the worker each device
        # call (it ends in .cpu(), so it waits for the card) and the rest of
        # its batch run (host finalize, escalation, stats); in the handler
        # threads each request's parse, its wait for the worker and its reply
        # (encoding and send)
        split = {"device": [], "req": []}
        device_call, synthesize, marks = batcher._device_call, batcher.synthesize, \
            threading.local()

        def timed_call(batch, frames, bsz):
            t = time.perf_counter()
            out = device_call(batch, frames, bsz)
            split["device"].append((bsz, frames, 1e3 * (time.perf_counter() - t)))
            return out

        def timed_synthesize(*a, **k):
            marks.t_in = time.perf_counter()
            try:
                return synthesize(*a, **k)
            finally:
                marks.t_out = time.perf_counter()

        handler = httpd.RequestHandlerClass
        do_post = handler.do_POST

        def timed_post(h):
            marks.t_in = marks.t_out = None
            t = time.perf_counter()
            do_post(h)
            if marks.t_out is not None:
                split["req"].append((1e3 * (marks.t_in - t), 1e3 * (marks.t_out - marks.t_in),
                                     1e3 * (time.perf_counter() - marks.t_out)))

        batcher._device_call, batcher.synthesize, handler.do_POST = \
            timed_call, timed_synthesize, timed_post
        rounds = {}
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"

        def post(body: bytes):
            req = urllib.request.Request(url + "/synthesize", data=body,
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    out = (r.status, r.headers["Content-Type"], r.read())
            except urllib.error.HTTPError as e:
                out = (e.code, e.headers["Content-Type"], e.read())
            return out + (1e3 * (time.perf_counter() - t),)

        try:
            reqs = []
            for i in range(32):   # 8 sentences x 4 speakers, by name / vector, wav / json
                body = {"text": SENTENCES[i % 8], "format": "wav" if (i // 2) % 2 else "json"}
                if i % 2:
                    body["speaker"] = names[i // 8]
                else:
                    body["spk_emb"] = embs[i // 8].tolist()
                reqs.append(body)
            with open(os.path.join(root, "requests.json"), "w") as f:
                json.dump(reqs, f)
            # the clients run in a process of their own, as they would in use:
            # their reads and parsing do not take this interpreter's lock
            for c in [*counters.values(), cluster]:
                c.launches = 0
            run = subprocess.run([sys.executable, "-c", HTTP_CLIENT, url,
                                  os.path.join(root, "requests.json")],
                                 capture_output=True, text=True, timeout=600)
            gate(run.returncode == 0, ("HTTP client", run.returncode, run.stderr[-2000:]))
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            client = json.loads(run.stdout.strip().splitlines()[-1])
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                stats = json.load(r)["stats"]
            for i, rep in enumerate(client["replies"]):
                gate(rep["code"] == 200, ("serving reply", i, rep))
                gate(rep["sr"] == cfg.sampling_rate and rep["n"] > 0 and rep["finite"],
                     ("serving audio", i, rep))
            wall = client["wall_s"]
            lat = np.array([rep["ms"] for rep in client["replies"]])
            audio_s = sum(rep["n"] for rep in client["replies"]) / cfg.sampling_rate
            fmt = {f: np.median([r["ms"] for r, q in zip(client["replies"], reqs)
                                 if q["format"] == f]) for f in ("wav", "json")}
            log(f"[serve] 32 concurrent POST /synthesize (8 sentences x 4 speakers, half by "
                f"name, half wav; clients in another process): {wall:.3f} s wall = "
                f"{32 / wall:.2f} requests/s, latency p50 {np.percentile(lat, 50):.1f} ms p95 "
                f"{np.percentile(lat, 95):.1f} ms max {lat.max():.1f} ms (client clock; median "
                f"wav {fmt['wav']:.1f}, json {fmt['json']:.1f}); {audio_s:.1f} s of audio = "
                f"{audio_s / wall:.1f} audio s per wall s; server stats {stats}; batches "
                f"(size, frames, ms in _process) {worker['batches']}; launches {launches}, of "
                f"which decode_cluster.cu {cluster.launches} on [{smi}]")
            n = stats["n_batches"]
            gate(stats["n_requests"] == 32 and stats["n_errors"] == 0
                 and stats["max_batch_seen"] >= 2, ("serving stats", stats))
            gate(n == len(worker["batches"]) and worker["streams"] == {True},
                 ("worker batches or stream", n, worker))
            gate(launches["decode"] == cluster.launches == n and launches["gl_init"] == n
                 and launches["griffin_lim"] == n and launches["griffin_lim_f32"] == 0,
                 ("serving launches: K1 (decode_cluster.cu), K2 and K3 (gl_tc.cu) once a "
                  "batch, gl.cu never", launches, cluster.launches, n))
            rounds["mixed"] = (wall, list(worker["batches"]), split["device"], split["req"])
            worker["batches"], split["device"], split["req"] = [], [], []
            # what the JSON replies cost: the same 32 requests all as wav,
            # and one reply's JSON encoding on this host (it holds the
            # interpreter's lock, which the worker needs to launch)
            with open(os.path.join(root, "requests_wav.json"), "w") as f:
                json.dump([dict(q, format="wav") for q in reqs], f)
            n0 = stats["n_batches"]
            run = subprocess.run([sys.executable, "-c", HTTP_CLIENT, url,
                                  os.path.join(root, "requests_wav.json")],
                                 capture_output=True, text=True, timeout=600)
            gate(run.returncode == 0, ("HTTP client, wav", run.returncode, run.stderr[-2000:]))
            wav_only = json.loads(run.stdout.strip().splitlines()[-1])
            gate(all(r["code"] == 200 and r["n"] > 0 and r["finite"]
                     for r in wav_only["replies"]), ("wav-only replies", wav_only["replies"][:2]))
            lat_w = np.array([r["ms"] for r in wav_only["replies"]])
            rounds["wav"] = (wav_only["wall_s"], list(worker["batches"]), split["device"],
                             split["req"])
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                stats_w = json.load(r)["stats"]
            y = np.random.default_rng(0).normal(scale=0.3, size=HOP * (4 * 200 - 1))
            t = time.perf_counter()
            json.dumps({"samples": np.asarray(y, np.float64).round(6).tolist()})
            enc_ms = 1e3 * (time.perf_counter() - t)
            log(f"[serve] the same 32 requests all as wav: {wav_only['wall_s']:.3f} s wall = "
                f"{32 / wav_only['wall_s']:.2f} requests/s, latency p50 "
                f"{np.percentile(lat_w, 50):.1f} ms p95 {np.percentile(lat_w, 95):.1f} ms "
                f"(client clock), {stats_w['n_batches'] - n0} batch runs; one 200-frame "
                f"reply's JSON encoding {enc_ms:.1f} ms (host clock) on [{smi}]")
            bad = {400: post(b'{"speaker": "p225"}')[0],
                   413: post(json.dumps({"text": "x", "pad": "a" * (MAX_BODY_BYTES + 10)})
                             .encode())[0]}
            try:
                urllib.request.urlopen(url + "/nothing", timeout=30)
                bad[404] = 200
            except urllib.error.HTTPError as e:
                bad[404] = e.code
            log(f"[serve] bad requests: expected -> got {bad}")
            gate(all(k == v for k, v in bad.items()), ("bad request codes", bad))
        finally:
            httpd.shutdown()
            batcher.close()
        out = launches

        # each rung x frames bucket, one whole call after warmup (host clock)
        texts = encode_texts([SENTENCES[i % 8] for i in range(8)], cfg.vocabulary,
                             max_len=cfg.max_text_len)
        spk8 = np.repeat(embs, 2, axis=0)
        call_ms = {}
        for frames in buckets:
            s = batcher._syn_for(frames)
            for b in ladder:
                seeds = gl_seeds(b, torch.Generator().manual_seed(0))
                ts = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    s(texts[:b], spk8[:b], seeds)
                    torch.cuda.synchronize()
                    ts.append(1e3 * (time.perf_counter() - t))
                call_ms[(b, frames)] = float(np.mean(ts))
        device_view(lambda: batcher._syn_for(120)(texts[:1], spk8[:1]), smi,
                    "[serve] device view of one B=1 T=120 Synthesizer call")
        log("[serve] Synthesizer call ms (host clock, mean of 3), rows B, columns frames "
            f"{buckets}: " + "; ".join(
                f"B={b}: " + ", ".join(f"{call_ms[(b, f)]:.2f}" for f in buckets)
                for b in ladder) + f" on [{smi}]")

        # the burst's split beside the same calls alone (host clock)
        for name, (wall_r, runs, dev_calls, reqs_r) in rounds.items():
            busy = sum(ms for _, _, ms in runs)
            dev_ms = sum(ms for _, _, ms in dev_calls)
            slow = [ms / call_ms[(b, f)] for b, f, ms in dev_calls]
            parse, wait, reply = (np.array(c) for c in zip(*reqs_r))
            log(f"[serve split, {name} round] wall {1e3 * wall_r:.1f} ms; worker busy {busy:.1f} "
                f"ms ({100 * busy / (1e3 * wall_r):.1f} %): {len(dev_calls)} device calls "
                f"{dev_ms:.1f} ms ({', '.join(f'{ms:.1f}' for _, _, ms in dev_calls)}), each "
                f"{np.median(slow):.2f}x (median; {min(slow):.2f}-{max(slow):.2f}) the same rung "
                f"and bucket alone; the rest of the batch runs (host finalize, escalation, "
                f"stats) {busy - dev_ms:.1f} ms. Handler threads, per request median / max ms: "
                f"parse {np.median(parse):.2f} / {parse.max():.2f}, wait for the worker "
                f"{np.median(wait):.1f} / {wait.max():.1f}, reply (encode, send) "
                f"{np.median(reply):.2f} / {reply.max():.2f}, {reply.sum():.1f} in all; on [{smi}]")

        # K1, K2 and K3 alone at the serving shapes: each against its plain
        # version on the same tensors at the repo's gates, then timed
        # against its bound
        text_d = torch.from_numpy(texts).to(dev)
        with torch.no_grad():
            K, V = melsyn.encode_text(text_d)
            sb = torch.from_numpy(spk8).to(dev, K.dtype)
            s1, s2 = melsyn.audio_encoder.fc1(sb), melsyn.audio_encoder.fc2(sb)
        packed = decode_kernel.pack_decode_weights(melsyn)
        N = K.shape[1]
        for b in ladder:
            plan = decode_kernel.decode_cluster_plan(b, C, F)
            stream = decode_kernel.pack_decode_stream(
                {k: packed[k] for k in decode_kernel.MATRIX_NAMES}, plan)
            ins = [t[:b].contiguous() for t in (K, V, s1, s2)]
            yq, aq, _ = decode_kernel.decode_plain(packed, *ins, n_frames=2, freq_bins=F)
            for T in buckets:
                y, a, _ = decode_kernel.decode_fused(packed, *ins, n_frames=T, freq_bins=F,
                                                     plan=plan, stream=stream)
                mel2 = float((y[:, :2].float() - yq.float()).abs().max())
                att2 = float((a[:, :, :2].float() - aq.float()).abs().max())
                ms = cuda_ms(lambda: decode_kernel.decode_fused(
                    packed, *ins, n_frames=T, freq_bins=F, plan=plan, stream=stream), reps=3)
                flop, nbytes = decode_work(C, F, b, N, T, 2)
                b_ms, b_by = bound_ms(flop, nbytes, 989e12)
                log(f"[serve K1] bf16 B={b} N={N} T={T} plan {plan.cluster}x{plan.rows}: vs "
                    f"decode_plain frames 0-1 mel max|d| {mel2:.3g} (gate 0.05), attention "
                    f"{att2:.3g} (gate 0.02); {ms:.3f} ms (CUDA events, mean of 3) = "
                    f"{1e3 * ms / T:.2f} us a frame; bound {b_ms:.4f} ms ({b_by}), "
                    f"{100 * b_ms / ms:.3f} % of it, on [{smi}]")
                gate(mel2 <= 0.05 and att2 <= 0.02, ("serving K1 vs decode_plain", b, T, mel2, att2))
                gate(ms >= b_ms, ("K1 under its bound", b, T, ms, b_ms))
        # under one plan K1's rows are independent: row 0 of the B=8 inputs
        # alone (B=1, the same 16x16 plan) gives bit-equal outputs
        plans = [decode_kernel.decode_cluster_plan(b, C, F) for b in (1, 8)]
        y8, a8, p8 = decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=200, freq_bins=F)
        y1, a1, p1 = decode_kernel.decode_fused(packed, *[t[:1].contiguous() for t in (K, V, s1, s2)],
                                                n_frames=200, freq_bins=F)
        same = torch.equal(y1[0], y8[0]) and torch.equal(a1[0], a8[0]) and torch.equal(p1[0], p8[0])
        log(f"[serve K1] row 0 alone vs in the batch of 8, identical inputs, T=200, plans "
            f"{[(p.cluster, p.rows) for p in plans]}: bit-equal {same}")
        gate(same and len({(p.cluster, p.rows) for p in plans}) == 1, ("K1 row invariance", plans))
        for T in buckets:
            mag = test_mag(8, 4 * T, seed=T)
            init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
            k_re, k_im = gl_kernel.gl_init_angles(mag, NFFT, HOP, "spsi")
            cos_dphi = float(((k_re * init[0] + k_im * init[1])
                              / torch.sqrt(k_re ** 2 + k_im ** 2)).min())
            g12 = gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=12, init_angles=init, int8=True)
            p12 = gl_kernel.griffin_lim_tc_plain(mag, *init, NFFT, HOP, 12, 0.99, True)
            sc_k, sc_p = spectral_err(g12, mag), spectral_err(p12, mag)
            k2 = cuda_ms(lambda: gl_kernel.gl_init_angles(mag, NFFT, HOP, "spsi"), reps=10)
            k2_b, k2_by = bound_ms(30.0 * mag.numel(), 12.0 * mag.numel(), 67e12)
            k3 = cuda_ms(lambda: gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=12,
                                                          init_angles=init, int8=True), reps=5)
            k3_b, k3_by, _ = gl_tc_bound(8, 4 * T, True)
            log(f"[serve K2/K3] B=8 lin frames {4 * T}: K2 spsi vs plain min cos dphi "
                f"{cos_dphi:.7f} (gate >= 0.99995), {k2:.4f} ms, bound {k2_b:.4f} ({k2_by}); K3 "
                f"GL12 int8 spectral conv {sc_k:.5f}, its plain version {sc_p:.5f} (gate delta "
                f"<= 0.02), {k3:.3f} ms, bound {k3_b:.4f} ({k3_by}), {100 * k3_b / k3:.1f} % of "
                f"it (CUDA events) on [{smi}]")
            gate(cos_dphi >= 0.99995 and abs(sc_k - sc_p) <= 0.02,
                 ("serving K2/K3 vs plain", T, cos_dphi, sc_k, sc_p))
            gate(k2 >= k2_b and k3 >= k3_b, ("K2/K3 under their bounds", T, k2, k3))
        del K, V, s1, s2, packed, mag, init, k_re, k_im, g12, p12, y8, a8, y1, a1

        # one request solo (rung 1) and inside a batch of 8 (rung 8), its bucket
        frames = batcher._frames_bucket(int((texts[0] > 0).sum()))
        s = batcher._syn_for(frames)
        rows = {}
        for b in (1, 8):
            td = torch.from_numpy(texts[:b]).to(dev)
            with torch.no_grad():
                k, v = melsyn.encode_text(td)
                sb = torch.from_numpy(spk8[:b]).to(dev, k.dtype)
                p1, p2 = melsyn.audio_encoder.fc1(sb), melsyn.audio_encoder.fc2(sb)
            audio, mel, att = s(texts[:b], spk8[:b], gl_seeds(b, torch.Generator().manual_seed(1)))
            rows[b] = [t[0].float() for t in (k, v, p1, p2, mel, att, audio)]
        d = {n: float((x - y).abs().max()) for n, x, y in
             zip(("K", "V", "s1", "s2", "mel", "attention", "audio"), rows[1], rows[8])}
        diff = (rows[1][5].argmax(0) != rows[8][5].argmax(0)).cpu().numpy()
        onset = int(np.argmax(diff)) if diff.any() else frames
        mel_b = float((rows[1][4][:onset] - rows[8][4][:onset]).abs().max()) if onset else 0.0
        att_b = float((rows[1][5][:, :onset] - rows[8][5][:, :onset]).abs().max()) if onset \
            else 0.0
        log(f"[serve] one request (frames bucket {frames}) solo vs in a batch of 8: max|d| "
            f"{ {k: round(v, 6) for k, v in d.items()} }; attention argmax onset {onset} of "
            f"{frames}; before it mel {mel_b:.3g} (gate 0.05), attention {att_b:.3g} (gate 0.02)")
        gate(mel_b <= 0.05 and att_b <= 0.02, ("solo vs co-batched", mel_b, att_b))
        gate(all(bool(torch.isfinite(r[6]).all()) for r in rows.values()), "solo audio")
        # where K and V part: row 0's output of each text-encoder module at
        # B=1 against B=8 (the 8 sentences; 8 copies of row 0) and, for the
        # 8 sentences, with cuDNN off (the 1x1 convs are F.linear, cuBLAS;
        # the highway convs F.conv1d, cuDNN)
        enc = melsyn.text_encoder
        mods = [(n, m) for n, m in enc.named_modules()
                if n and (n.count(".") == 0 or n.startswith(("hci1.hc", "hci2.hc"))
                          and n.count(".") == 1)]
        outs: dict = {}

        def hook(name):
            def record(_, __, out):
                outs.setdefault(name, []).append(out[0].float().clone())
            return record

        handles = [m.register_forward_hook(hook(n)) for n, m in mods]

        def parts(t_a, t_b) -> str:
            outs.clear()
            with torch.no_grad():
                enc(torch.from_numpy(t_a).to(dev))
                enc(torch.from_numpy(t_b).to(dev))
            d = [(n, float((v[0] - v[1]).abs().max())) for n, v in outs.items() if len(v) == 2]
            first = next((n for n, x in d if x > 0), None)
            return f"first parts at {first}; " + ", ".join(f"{n} {x:.3g}" for n, x in d)

        try:
            mixed = parts(texts[:1], texts[:8])
            copies = parts(texts[:1], np.repeat(texts[:1], 8, axis=0))
            with torch.backends.cudnn.flags(enabled=False):
                no_cudnn = parts(texts[:1], texts[:8])
        finally:
            for h in handles:
                h.remove()
        log(f"[serve] text encoder, row 0 at B=1 vs B=8, max|d| of each module's output: the 8 "
            f"sentences: {mixed}. 8 copies of row 0: {copies}. The 8 sentences, cuDNN off: "
            f"{no_cudnn} (on [{smi}])")
        del melsyn, ssrn, syn, batcher, s, rows
    return out


def spoofgen_phase(cfg, dev, state_dicts, counters: dict, cluster, smi: str) -> dict:
    """Phase 9: spoof-set synthesis (``generate_spoof_set``) of 8 speakers x
    20 Harvard sentences at full width in bf16, one B=160 call (K1's 8x16
    plan), into the reference layout; K1 on that call's inputs against
    ``decode_plain``. Returns its launches."""
    import torch
    from scipy.io import wavfile

    from spoofsv_torch.cli.main import build_models, inference_dtype
    from spoofsv_torch.infer.synthesize import Synthesizer
    from spoofsv_torch.ops import decode_kernel
    from spoofsv_torch.spoofkit.spoofgen import generate_spoof_set
    from spoofsv_torch.weights import load_state

    speakers = [f"p{225 + i}" for i in range(8)]
    rng = np.random.default_rng(9)
    with tempfile.TemporaryDirectory() as root:
        for spk in speakers:
            os.makedirs(os.path.join(root, "data", "wav22", spk))
        os.makedirs(os.path.join(root, "spk_emb"))
        for spk in speakers:
            np.save(os.path.join(root, "spk_emb", spk + ".npy"),
                    rng.normal(size=cfg.spk_emb_dim).astype(np.float32))
        with open(os.path.join(root, "havard.txt"), "w") as f:
            f.write("\n".join(SENTENCES) + "\n")
        cfg9 = cfg.replace(data_root_dir=os.path.join(root, "data"),
                           spk_emb_dir=os.path.join(root, "spk_emb"), src_root_dir=root + "/",
                           tts_texts=os.path.join(root, "havard.txt"))
        melsyn, ssrn, _, _ = build_models(cfg9, dtype=inference_dtype(cfg9, dev), device=dev)
        load_state(melsyn, state_dicts["text2mel"])
        load_state(ssrn, state_dicts["ssrn"])
        syn = Synthesizer(cfg9, melsyn, ssrn, n_frames=cfg9.max_frame_num)
        C, F = cfg.hidden_dim, cfg.mel.freq_bins
        plan = decode_kernel.decode_cluster_plan(160, C, F)
        calls, inputs = [], []

        def timed(text, spk, seeds):
            """The synthesizer call alone (device work closed by a sync)."""
            inputs.append((text, spk))
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = syn(text, spk, seeds)
            torch.cuda.synchronize()
            calls.append((text.shape[0], time.perf_counter() - t))
            return out

        # first use: the decoder packs its weights and the 8x16 plan's stream
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        syn(np.ones((160, 8), np.int32), np.zeros((160, cfg.spk_emb_dim), np.float32))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for c in [*counters.values(), cluster]:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_dir = generate_spoof_set(cfg9, "smoke", timed, eval_utt_num=20, speaker_batch=8,
                                      verbose=False)
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        wavs = sorted(os.path.join(d, f) for d, _, fs in os.walk(save_dir) for f in fs)
        expect = sorted(os.path.join(save_dir, f"s{s[1:]}", f"s{s[1:]}_{k:03d}.wav")
                        for s in speakers for k in range(1, 21))
        gate(wavs == expect, ("spoof-set layout", len(wavs), wavs[:3]))
        audio_s = 0.0
        for w in wavs:
            sr, y = wavfile.read(w)
            gate(sr == cfg.sampling_rate and 0 < len(y) <= 9 * sr
                 and bool(np.isfinite(y.astype(np.float32)).all()), ("spoof wav", w, sr, len(y)))
            audio_s += len(y) / sr
        synth_s = sum(t for _, t in calls)
        log(f"[spoofgen] 8 speakers x 20 sentences: calls (B, s) {calls}, K1 plan "
            f"{plan.cluster}x{plan.rows} ({plan.tiles} tiles); synthesis {1e3 * synth_s:.1f} ms, "
            f"host tail (finalize + write) {1e3 * (wall - synth_s):.1f} ms, whole function "
            f"{wall:.3f} s; {audio_s:.1f} s of audio = {audio_s / wall:.2f} audio s per wall s "
            f"(a first B=160 call before it, packing the weights: {first_s:.3f} s); "
            f"launches {launches}, of which decode_cluster.cu {cluster.launches} on [{smi}]")
        gate([b for b, _ in calls] == [160] and (plan.cluster, plan.rows) == (8, 16),
             ("one B=160 call under the 8x16 plan", calls, plan))
        gate(launches["decode"] == cluster.launches == 1 and launches["gl_init"] == 1
             and launches["griffin_lim"] == 1 and launches["griffin_lim_f32"] == 0,
             ("spoofgen launches", launches, cluster.launches))
        # K1 under the 8x16 plan on that call's inputs against decode_plain
        with torch.no_grad():
            K, V = melsyn.encode_text(torch.as_tensor(inputs[0][0]).to(dev))
            sb = torch.as_tensor(inputs[0][1]).to(dev, K.dtype)
            s1, s2 = melsyn.audio_encoder.fc1(sb), melsyn.audio_encoder.fc2(sb)
        packed = decode_kernel.pack_decode_weights(melsyn)
        y, a, _ = decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=cfg9.max_frame_num,
                                             freq_bins=F, plan=plan)
        yq, aq, _ = decode_kernel.decode_plain(packed, K, V, s1, s2, n_frames=2, freq_bins=F)
        mel2 = float((y[:, :2].float() - yq.float()).abs().max())
        att2 = float((a[:, :, :2].float() - aq.float()).abs().max())
        log(f"[spoofgen K1] B=160 N={K.shape[1]} T={cfg9.max_frame_num} plan "
            f"{plan.cluster}x{plan.rows} vs decode_plain frames 0-1: mel max|d| {mel2:.3g} "
            f"(gate 0.05), attention {att2:.3g} (gate 0.02)")
        gate(mel2 <= 0.05 and att2 <= 0.02, ("spoofgen K1 vs decode_plain", mel2, att2))
        del K, V, s1, s2, packed, y, a, yq, aq
        del melsyn, ssrn, syn
    return launches


def hold_k1(m, text_ids, spk_emb, n_frames: int, dev, what: str) -> None:
    """K1 (``m``'s dtype) on these inputs and weights under its plan against
    ``decode_plain`` over frames 0-1 at mel max|d| 0.05 and attention 0.02,
    each row through its first attention argmax flip there: frame t reads the
    window that frame t-1's argmax chose, so a flip parts the rollouts from
    the next frame on. A flip is allowed where ``decode_plain``'s top-2
    attention values at that frame lie within the attention gate of each
    other (an ulp flips a near-tie, ROADMAP C, "B=768, seed 5"), on at most
    ``max(2, B // 50)`` rows; each flipped row's frame, top-2 gaps and
    differences at that frame are logged."""
    import torch

    from spoofsv_torch.ops import decode_kernel

    F = m.freq_bins
    with torch.no_grad():
        K, V = m.encode_text(torch.as_tensor(text_ids).to(dev))
        sb = torch.as_tensor(spk_emb, dtype=torch.float32).to(dev, K.dtype)
        s1, s2 = m.audio_encoder.fc1(sb), m.audio_encoder.fc2(sb)
    packed = decode_kernel.pack_decode_weights(m)
    plan = decode_kernel.decode_cluster_plan(K.shape[0], K.shape[2], F, elem=K.element_size())
    y, a, _ = decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=n_frames, freq_bins=F,
                                         plan=plan)
    yq, aq, _ = decode_kernel.decode_plain(packed, K, V, s1, s2, n_frames=2, freq_bins=F)
    yk, ak, yq, aq = y[:, :2].float(), a[:, :, :2].float(), yq.float(), aq.float()
    flip = ak.argmax(1) != aq.argmax(1)                                    # (B, 2)
    first = torch.where(flip.any(1), flip.float().argmax(1), 2)            # 2: no flip
    held = torch.arange(2, device=flip.device)[None, :] <= first[:, None]  # through the flip
    dmel, datt = (yk - yq).abs().amax(2), (ak - aq).abs().amax(1)          # (B, 2) each
    mel2, att2 = float(dmel[held].max()), float(datt[held].max())

    def gap(att):   # (N,) -> its top-2 gap
        top = att.topk(2).values
        return round(float(top[0] - top[1]), 6)

    flipped = {i: dict(frame=o, gap_plain=gap(aq[i, :, o]), gap_kernel=gap(ak[i, :, o]),
                       mel=round(float(dmel[i, o]), 6), att=round(float(datt[i, o]), 6))
               for i in flip.any(1).nonzero().flatten().tolist() for o in [int(first[i])]}
    cap = max(2, K.shape[0] // 50)
    log(f"[{what}] K1 B={K.shape[0]} N={K.shape[1]} T={n_frames} {K.dtype} plan "
        f"{plan.cluster}x{plan.rows} vs decode_plain frames 0-1, each row through its first "
        f"argmax flip: mel max|d| {mel2:.3g} (gate 0.05), attention {att2:.3g} (gate 0.02); rows "
        f"flipped {json.dumps(flipped)} (gates: at most {cap} rows, plain top-2 gap <= 0.02)")
    gate(mel2 <= 0.05 and att2 <= 0.02 and len(flipped) <= cap
         and all(f["gap_plain"] <= 0.02 for f in flipped.values()),
         (what, "K1 vs decode_plain", K.shape, mel2, att2, flipped))


def hold_synthesis(syn_calls, gl_calls, dev, spectral_err, what: str) -> None:
    """K1 bf16 on each recorded ``Synthesizer`` call's own inputs and weights
    (:func:`hold_k1`); K2 against ``init_angles_plain`` (min cos Δφ >= 0.99995)
    and K3 GL12 against ``griffin_lim_tc_plain`` (Δ spectral convergence
    <= 0.02) on each call's vocoder input. Outside any counted run."""
    import torch

    from spoofsv_torch.ops import gl_kernel

    gate(len(syn_calls) == len(gl_calls) > 0, (what, "calls recorded", len(syn_calls),
                                               len(gl_calls)))
    for (syn, text_ids, spk_emb), (mag, int8) in zip(syn_calls, gl_calls):
        hold_k1(syn.melsyn, text_ids, spk_emb, syn.n_frames, dev, what)
        init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
        k_re, k_im = gl_kernel.gl_init_angles(mag, NFFT, HOP, "spsi")
        cos_dphi = float(((k_re * init[0] + k_im * init[1])
                          / torch.sqrt(k_re ** 2 + k_im ** 2)).min())
        g12 = gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=12, init_angles=init, int8=int8)
        p12 = gl_kernel.griffin_lim_tc_plain(mag, *init, NFFT, HOP, 12, 0.99, int8)
        sc_k, sc_p = spectral_err(g12, mag), spectral_err(p12, mag)
        log(f"[{what}] lin frames {mag.shape[1]}: K2 spsi vs plain min cos dphi "
            f"{cos_dphi:.7f} (gate >= 0.99995); K3 GL12 int8={int8} spectral conv {sc_k:.5f}, "
            f"its plain version {sc_p:.5f} (gate delta <= 0.02)")
        gate(cos_dphi >= 0.99995 and abs(sc_k - sc_p) <= 0.02,
             (what, "K2/K3 vs plain", mag.shape, cos_dphi, sc_k, sc_p))


class SynthesisRecorder:
    """Records, while installed, the inputs of the f32 K1 decodes that the
    training validations run (``loop.make_fused_decoder``; each record also
    holds ``val_tag()``'s fields), of each ``Synthesizer`` call (``__call__``
    or ``device_call``) and of its tensor-core vocoder; ``make_fused`` is the
    unrecorded decoder."""

    def __init__(self, val_tag=dict):
        from spoofsv_torch.infer import synthesize as syn_mod
        from spoofsv_torch.train import loop

        self.loop, self.syn_mod, self.val_tag = loop, syn_mod, val_tag
        self.val_calls, self.syn_calls, self.gl_calls = [], [], []
        self.make_fused = loop.make_fused_decoder
        self.syn_call, self.gl_tc = syn_mod.Synthesizer.__call__, syn_mod.griffin_lim_tc
        self.syn_device_call = syn_mod.Synthesizer.device_call

    def install(self) -> None:
        rec = self

        def recorded_decoder(model, n_frames, *a, **kw):
            decode = rec.make_fused(model, n_frames, *a, **kw)

            def run(text_ids, spk_emb, *x):
                rec.val_calls.append(dict(rec.val_tag(), model=model, T=n_frames,
                                          text=text_ids, spk=spk_emb))
                return decode(text_ids, spk_emb, *x)
            return run

        def recorded_call(self, text_ids, spk_emb, seeds=None):
            rec.syn_calls.append((self, text_ids, spk_emb))
            return rec.syn_call(self, text_ids, spk_emb, seeds)

        def recorded_device_call(self, text_ids, spk_emb, seeds=None):
            rec.syn_calls.append((self, text_ids, spk_emb))
            return rec.syn_device_call(self, text_ids, spk_emb, seeds)

        def recorded_gl(spec, *a, **kw):
            rec.gl_calls.append((spec, kw["int8"]))
            return rec.gl_tc(spec, *a, **kw)

        self.loop.make_fused_decoder = recorded_decoder
        self.syn_mod.Synthesizer.__call__ = recorded_call
        self.syn_mod.Synthesizer.device_call = recorded_device_call
        self.syn_mod.griffin_lim_tc = recorded_gl

    def restore(self) -> None:
        self.loop.make_fused_decoder = self.make_fused
        self.syn_mod.Synthesizer.__call__ = self.syn_call
        self.syn_mod.Synthesizer.device_call = self.syn_device_call
        self.syn_mod.griffin_lim_tc = self.gl_tc


def train_cli_phase(cfg, dev, counters: dict, cluster, smi: str, onsets, before_onset,
                    spectral_err, n_speakers: int = 4, utts_per_spk: int = 24,
                    min_chars: int = 110, max_chars: int = 160) -> dict:
    """Phase 10: the training CLI on a toy corpus (VCTK is not on the card's
    machine): ``generate_toy_corpus`` (rich voices) and ``prepare_vctk``,
    the features cached; then through ``spoofsv_torch.cli.main.main`` at the
    shipping widths, f32, batch 16, validation every 6 iterations:
    ``train_text2mel --adversarial`` for 12 iterations under "fused_pair"
    (2 G steps, 10 D steps, validations at 6 and 12 through the f32 K1),
    ``train_ssrn --adversarial`` under "fused_conv", ``-R latest`` for 2
    more Text2Mel iterations (the resumed state checked against its
    checkpoint), and ``synthesize`` from the two best checkpoints (bf16: K1,
    K2, K3). Each G and D step's launches and time are read by wrapping the
    steps ``Trainer`` builds; the inputs of the last validation's f32 K1
    calls, of each synthesize batch's decode and of its vocoder are
    recorded. Then, outside the counted runs: the f32 K1 on each recorded
    validation batch against the eager f32 decode and ``decode_plain``
    (1e-3 before each row's first attention argmax flip, onsets >= 32, as
    phase 4); the bf16 K1 on each synthesize batch against ``decode_plain``
    over frames 0-1 (mel 0.05, attention 0.02), K2 against
    ``init_angles_plain`` and K3 GL12 against ``griffin_lim_tc_plain`` on
    each batch's vocoder input (as phase 8); a G step and a D step of both
    kinds under every highway impl on one batch of each (frames, text)
    bucket, each from the same initial weights, against "xla": the
    generator's output (and Text2Mel's attention) in the G step element by
    element (1e-4), the gradients of the reconstruction loss and of the
    critic's term apart (the whole gradient's relative difference 1e-2,
    each parameter's 5e-2), the losses (1e-4 relative); a critic's forward
    plus penalty launches no
    highway kernel; each kind's steady G and D step times (5 each after a
    warm-up, at the epoch's largest batch; Text2Mel's in f32 and under bf16
    autocast) and one of each under ``torch.profiler``;
    ``Trainer`` with the "wgan" (weights within ±0.1) and "vanilla" critics
    for 6 iterations. Returns the launches of each kernel on the two CLI
    paths."""
    import dataclasses
    import statistics

    import torch
    from scipy.io import wavfile

    from spoofsv_torch.cli import main as cli
    from spoofsv_torch.data.pipeline import DeviceReplayLoader, TTSDataSource, _bucket_for
    from spoofsv_torch.data.toy import generate_toy_corpus
    from spoofsv_torch.data.vctk import prepare_vctk
    from spoofsv_torch.infer.decode import make_decoder
    from spoofsv_torch.models import LinDisc, MelDisc
    from spoofsv_torch.models.layers import GATE_IMPLS, gate_impl
    from spoofsv_torch.ops import decode_kernel
    from spoofsv_torch.train import Trainer, steps
    from spoofsv_torch.weights import load_state

    highway = ("highway_gate", "highway_conv", "highway_conv_pair")
    impl_kernel = {"pallas": "highway_gate", "fused_conv": "highway_conv",
                   "fused_pair": "highway_conv_pair"}
    ckpt_keys = {"epoch", "iteration", "model_state_dict", "optimizer_state_dict",
                 "loss_val_log", "disc_state_dict", "disc_optimizer_state_dict", "loss_logs"}

    def snap() -> dict:
        return {k: c.launches for k, c in counters.items()}

    def since(before: dict) -> dict:
        return {k: n - before[k] for k, n in snap().items()}

    def reset() -> None:
        for c in [*counters.values(), cluster]:
            c.launches = 0

    def same_tensors(a, b) -> bool:
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(same_tensors(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same_tensors(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a.detach().cpu(), torch.as_tensor(b).cpu())
        return a == b

    def matches_checkpoint(state, path: str) -> bool:
        """Both nets and both Adam states bit-equal to the checkpoint's, at its step."""
        ck = torch.load(path, map_location="cpu", weights_only=True)
        return (state.step == ck["iteration"]
                and same_tensors(state.gen.state_dict(), ck["model_state_dict"])
                and same_tensors(state.disc.state_dict(), ck["disc_state_dict"])
                and same_tensors(state.gen_optimizer.state_dict(), ck["optimizer_state_dict"])
                and same_tensors(state.disc_optimizer.state_dict(),
                                 ck["disc_optimizer_state_dict"]))

    # every G and D step the Trainer takes: its kind, time and launches
    seen, resume_check = [], {}
    make_steps = steps.make_adversarial_steps

    def recorded_steps(gen, disc, cfg_, train_kind, *args, **kwargs):
        init_fn, g_step, d_step = make_steps(gen, disc, cfg_, train_kind, *args, **kwargs)

        def record(which, fn):
            def run(state, *a):
                if resume_check.pop("path", None):
                    resume_check["ok"] = matches_checkpoint(state, resume_check["want"])
                before = snap()
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(state, *a)
                torch.cuda.synchronize()
                seen.append(dict(kind=train_kind, step=which, ms=1e3 * (time.perf_counter() - t),
                                 launches=since(before), metrics=out[1]))
                return out
            return run

        return init_fn, record("G", g_step), record("D", d_step)

    def median_ms(rows, which) -> float:
        return round(statistics.median(r["ms"] for r in rows if r["step"] == which), 3)

    # the inputs of the validator's decodes (with the steps taken before
    # them), of each Synthesizer call and of its tensor-core vocoder
    rec = SynthesisRecorder(lambda: dict(steps=len(seen)))
    val_calls, syn_calls, gl_calls, make_fused = (rec.val_calls, rec.syn_calls, rec.gl_calls,
                                                  rec.make_fused)

    out = {}
    steps.make_adversarial_steps = recorded_steps
    rec.install()
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            generate_toy_corpus(os.path.join(root, "data"), os.path.join(root, "emb"),
                                n_speakers=n_speakers, utts_per_spk=utts_per_spk,
                                spk_emb_dim=cfg.spk_emb_dim, seed=0, min_chars=min_chars,
                                max_chars=max_chars, rich_speakers=True)
            base = cfg.replace(data_root_dir=os.path.join(root, "data"),
                               spk_emb_dir=os.path.join(root, "emb"),
                               src_root_dir=os.path.join(root, "work") + "/", batch_size=16,
                               val_every_iter=6)
            prepare_vctk(base, verbose=False)
            corpus_s = time.perf_counter() - t0
            spec = os.path.join(base.src_root_dir, "spec")
            t0 = time.perf_counter()
            srcs = {m: TTSDataSource(base, m, spec, need_lin=True)
                    for m in ("train", "validate", "synthesize")}
            for s in srcs.values():
                s.warm_cache()
            feature_s = time.perf_counter() - t0
            shapes = {m: sorted({(_bucket_for(e.mel.shape[0], base.tpu.bucket_frames),
                                  _bucket_for(len(e.text), base.tpu.bucket_text))
                                 for e in (s[i] for i in range(len(s)))})
                      for m, s in srcs.items()}
            log(f"[train-cli] toy corpus {n_speakers} speakers x {utts_per_spk}: "
                f"{ {m: len(s) for m, s in srcs.items()} } utterances, written and split in "
                f"{corpus_s:.2f} s, features (host numpy, cached) {feature_s:.2f} s; "
                f"(frames, text) buckets {shapes}")
            gate(len(srcs["train"]) > 0 and len(srcs["synthesize"]) > 0, "empty toy corpus")

            def conf(name: str, tpu=None, **fields) -> str:
                c = base.replace(**fields)
                if tpu:
                    c = c.replace(tpu=dataclasses.replace(c.tpu, **tpu))
                path = os.path.join(root, name + ".json")
                with open(path, "w") as f:
                    json.dump(c.to_reference_dict(), f)
                return path

            def cli_run(argv):
                """``main(argv)`` on the card, launches counted from 0."""
                reset()
                for log_list in (seen, val_calls, syn_calls, gl_calls):
                    log_list.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                with gate_impl("xla"):   # main sets the process-wide impl; restore it after
                    result = cli.main(argv, device=dev)
                torch.cuda.synchronize()
                return result, time.perf_counter() - t, snap(), list(seen)

            def check_training(tr, kind, impl, n_iter, g_n, d_n, rows, n, wall, resumed=False):
                recs = [json.loads(ln) for ln in open(os.path.join(tr.ckpt.base,
                                                                   "metrics.jsonl"))]
                train = [r for r in recs if r["split"] == "train"]
                vals = [r["loss"] for r in recs if r["split"] == "validate"]
                finite = [v for r in train for k, v in r.items() if k in
                          ("loss", "loss_d", "gp", "wd", "loss_disc", "l1", "bd", "att")]
                data = [r for r in recs if r["split"] == "data"]
                gs = [r for r in rows if r["step"] == "G"]
                ds = [r for r in rows if r["step"] == "D"]
                log(f"[train-cli] {kind} --adversarial under {impl}"
                    f"{' (resumed)' if resumed else ''}: iterations {tr.iteration}, "
                    f"{len(gs)} G / {len(ds)} D steps, G ms "
                    f"{[round(r['ms'], 2) for r in gs]}, D ms {[round(r['ms'], 2) for r in ds]}"
                    f" (host clock, synchronized), validation losses {vals}, resident train "
                    f"set {[r['device_bytes'] for r in data]} bytes, run wall {wall:.2f} s, "
                    f"launches {n} on [{smi}]")
                gate(tr.iteration == n_iter and len(gs) == g_n and len(ds) == d_n,
                     (kind, "iterations / G / D", tr.iteration, len(gs), len(ds)))
                gate(bool(np.isfinite(finite + vals).all()) and len(finite) > 0,
                     (kind, "losses not finite", finite, vals))
                own = impl_kernel[impl]
                for r in rows:
                    gate(r["launches"][own] > 0, (kind, r["step"], f"{own} not launched",
                                                  r["launches"]))
                    gate(all(r["launches"][k] == 0 for k in highway if k != own
                             and not (impl == "fused_pair" and k == "highway_conv")),
                         (kind, r["step"], "another impl's kernel ran", r["launches"]))
                    gate(r["launches"]["decode_f32"] == 0, (kind, "K1 in a step", r["launches"]))
                return gs, ds

            # -- Text2Mel, adversarial, "fused_pair" ----------------------------
            t2m_conf = conf("t2m", {"highway_gate_impl": "fused_pair"})
            tr, wall, n, rows = cli_run(["train_text2mel", "-C", t2m_conf, "-T", "t2m",
                                         "--adversarial", "--max_iterations", "12",
                                         "--save_spectrogram"])
            train_launches = {k: n[k] for k in (*highway, "decode_f32")}
            gs, ds = check_training(tr, "text2mel", "fused_pair", 12, 2, 10, rows, n, wall)
            gate({k: len(v) for k, v in tr.loss_logs.items()}
                 == {"wd": 10, "t_s": 2, "t_s_o": 2, "t_d": 10}, ("loss_logs", tr.loss_logs))
            gate(n["decode_f32"] > 0, ("validation did not run K1 f32", n))
            t2m_path = tr.ckpt.latest()
            ck = torch.load(t2m_path, map_location="cpu", weights_only=True)
            gate(set(ck) == ckpt_keys and ck["iteration"] == 12
                 and len(ck["loss_logs"]["t_d"]) == 10, ("checkpoint keys", sorted(ck)))
            t2m_ms = (median_ms(rows, "G"), median_ms(rows, "D"))
            # the f32 K1 on the last validation's own batches (the weights of
            # iteration 12, the run's last) against the eager f32 decode and
            # decode_plain, before each row's first attention argmax flip
            F = base.mel.freq_bins
            last = [c for c in val_calls if c["steps"] == 12]
            gate(len(last) > 0 and all(c["model"] is tr.gen_model for c in last),
                 ("validation decodes at iteration 12", len(val_calls)))
            m32 = tr.gen_model.eval()
            packed32 = decode_kernel.pack_decode_weights(m32)
            for c in last:
                text, spk = c["text"], c["spk"]
                with torch.no_grad():
                    kv = (*m32.encode_text(text), m32.audio_encoder.fc1(spk),
                          m32.audio_encoder.fc2(spk))
                yk, ak, _ = make_fused(m32, c["T"])(text, spk)
                for ref_name, (yp, ap) in (
                        ("eager f32 decode", make_decoder(m32, c["T"])(text, spk)[:2]),
                        ("decode_plain f32", decode_kernel.decode_plain(
                            packed32, *kv, n_frames=c["T"], freq_bins=F)[:2])):
                    ons = onsets(ak, ap)
                    mel, att = before_onset(yk, ak, yp, ap, ons)
                    log(f"[train-cli K1 f32] validation batch B={text.shape[0]} "
                        f"N={text.shape[1]} T={c['T']} vs {ref_name}: per-row divergence "
                        f"onset {ons}; before onset mel max|d| {mel:.3g}, attention max|d| "
                        f"{att:.3g} (gates 1e-3, onset >= 32)")
                    gate(min(ons) >= 32 and mel <= 1e-3 and att <= 1e-3,
                         ("validation K1 f32", ref_name, text.shape, c["T"], ons, mel, att))
            del m32, packed32, kv, yk, ak, yp, ap, last
            t2m_bytes = [json.loads(ln)["device_bytes"] for ln in open(os.path.join(
                tr.ckpt.base, "metrics.jsonl")) if '"data"' in ln]

            # -- SSRN, adversarial, "fused_conv" --------------------------------
            tr_s, wall, n, rows = cli_run(["train_ssrn", "-C", conf("ssrn", {
                "highway_gate_impl": "fused_conv"}), "-T", "ssrn", "--adversarial",
                "--max_iterations", "12", "--save_spectrogram"])
            for k in train_launches:
                train_launches[k] += n[k]
            check_training(tr_s, "ssrn", "fused_conv", 12, 2, 10, rows, n, wall)
            gate(n["decode_f32"] == 0, ("SSRN ran K1", n))
            ssrn_ms = (median_ms(rows, "G"), median_ms(rows, "D"))
            ssrn_bytes = [json.loads(ln)["device_bytes"] for ln in open(os.path.join(
                tr_s.ckpt.base, "metrics.jsonl")) if '"data"' in ln]

            # -- -R latest: 2 more Text2Mel iterations, under "pallas" (K6) ------
            resume_check.update(path=True, want=t2m_path)
            tr_r, wall, n, rows = cli_run(["train_text2mel", "-C", conf("t2m_pallas", {
                "highway_gate_impl": "pallas"}), "-T", "t2m", "--adversarial", "-R", "latest",
                "--max_iterations", "14", "--save_spectrogram"])
            for k in train_launches:
                train_launches[k] += n[k]
            check_training(tr_r, "text2mel", "pallas", 14, 1, 1, rows, n, wall, resumed=True)
            gate({k: len(v) for k, v in tr_r.loss_logs.items()}
                 == {"wd": 11, "t_s": 3, "t_s_o": 3, "t_d": 11}, ("resumed loss_logs",
                                                                  tr_r.loss_logs))
            gate(resume_check.get("ok") is True,
                 ("the resumed state differs from its checkpoint at iteration 12", resume_check))
            log(f"[train-cli] -R latest: resumed at iteration 12 with both nets and both Adam "
                f"states bit-equal to {os.path.basename(t2m_path)}")

            # -- bf16 training: Text2Mel under "fused_pair", 6 iterations -------
            recorded = {}
            with recording_highway(recorded):
                tr_b, wall, n, rows = cli_run(["train_text2mel", "-C", conf("t2m_bf16", {
                    "highway_gate_impl": "fused_pair", "train_compute_dtype": "bfloat16"}),
                    "-T", "t2m_bf16", "--adversarial", "--max_iterations", "6",
                    "--save_spectrogram"])
            bf16_cli = {k: n[k] for k in highway}
            bf16_cli.update(decode=cluster.launches, decode_f32=n["decode_f32"])
            check_training(tr_b, "text2mel (bf16)", "fused_pair", 6, 1, 5, rows, n, wall)
            gate(cluster.launches > 0 and n["decode_f32"] == 0,
                 ("bf16 training's validation did not run the bf16 K1", n, cluster.launches))
            gate(all(p_.dtype == torch.float32 for p_ in tr_b.gen_model.parameters()),
                 "bf16 training cast the parameters")
            hold_highway(recorded, 5e-2, "train-cli bf16", torch.bfloat16)
            bf16_ms = (median_ms(rows, "G"), median_ms(rows, "D"))
            # its validation's bf16 K1 on the batches it decoded, frames 0-1
            for c in val_calls:
                m = c["model"]
                gate(next(m.parameters()).dtype == torch.bfloat16,
                     ("bf16 validation decoded an f32 model", next(m.parameters()).dtype))
                with torch.no_grad():
                    K, V = m.encode_text(c["text"])
                    sb = c["spk"].to(K.dtype)
                    s1, s2 = m.audio_encoder.fc1(sb), m.audio_encoder.fc2(sb)
                packed = decode_kernel.pack_decode_weights(m)
                y, a, _ = decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=c["T"],
                                                     freq_bins=F)
                yq, aq, _ = decode_kernel.decode_plain(packed, K, V, s1, s2, n_frames=2,
                                                       freq_bins=F)
                mel2 = float((y[:, :2].float() - yq.float()).abs().max())
                att2 = float((a[:, :, :2].float() - aq.float()).abs().max())
                log(f"[train-cli bf16 K1] validation batch B={K.shape[0]} N={K.shape[1]} "
                    f"T={c['T']} vs decode_plain frames 0-1: mel max|d| {mel2:.3g} (gate "
                    f"0.05), attention {att2:.3g} (gate 0.02)")
                gate(mel2 <= 0.05 and att2 <= 0.02, ("bf16 validation K1", mel2, att2))
            log(f"[train-cli] text2mel bf16 (autocast over f32) under fused_pair: G/D ms "
                f"{bf16_ms} (f32 CLI run {t2m_ms}; first steps included), launches "
                f"{bf16_cli} on [{smi}]")
            del tr_b, recorded

            # -- synthesize from the two best checkpoints (bf16) ----------------
            best = {k: os.path.join(base.src_root_dir, "checkpoints", "conditional",
                                    "adversarial", k, f"{'text2mel' if k == 't2m' else k}"
                                    "_best_model.tar.pth") for k in ("t2m", "ssrn")}
            sample_dir, syn_wall, n, _ = cli_run(
                ["synthesize", "-C", conf("syn", inference_text2mel_model=best["t2m"],
                                          inference_ssrn_model=best["ssrn"]),
                 "-T", "syn", "--save_spectrogram"])
            syn_launches = {k: n[k] for k in ("gl_init", "griffin_lim", "griffin_lim_f32")}
            syn_launches["decode"] = cluster.launches
            wavs = sorted(f for f in os.listdir(sample_dir) if f.endswith(".wav"))
            audio_s = 0.0
            for w in wavs:
                sr, y = wavfile.read(os.path.join(sample_dir, w))
                gate(sr == base.sampling_rate and len(y) > 0
                     and bool(np.isfinite(y.astype(np.float32)).all()), ("synthesized wav", w))
                audio_s += len(y) / sr
            log(f"[train-cli] synthesize from the best checkpoints: {len(wavs)} wavs "
                f"({audio_s:.1f} s of audio) in {syn_wall:.3f} s wall (host features cached, "
                f"bf16), launches {n}, of which decode_cluster.cu {cluster.launches}, "
                f"on [{smi}]")
            gate(len(wavs) == len(srcs["synthesize"]) and all(w.startswith("S") for w in wavs),
                 ("synthesize wrote", wavs))
            gate(n["decode"] == cluster.launches > 0 and n["decode_f32"] == 0
                 and n["gl_init"] > 0 and n["griffin_lim"] > 0 and n["griffin_lim_f32"] == 0,
                 ("synthesize launches", n, cluster.launches))
            # K1 bf16, K2 and K3 on each synthesize batch's own inputs
            hold_synthesis(syn_calls, gl_calls, dev, spectral_err, "train-cli synthesize")
            del syn_calls[:], gl_calls[:]

            # -- outside the counted runs: every impl against "xla" --------------
            loaders = {kind: DeviceReplayLoader(TTSDataSource(base, "train", spec, need_lin=lin),
                                                base.batch_size, with_lin=lin, seed=0,
                                                device=dev)
                       for kind, lin in (("train_text2mel", False), ("train_ssrn", True))}
            torch.manual_seed(0)
            melsyn, ssrn, mel_disc, lin_disc = cli.build_models(base, device=dev)
            nets = {"train_text2mel": (melsyn, mel_disc), "train_ssrn": (ssrn, lin_disc)}
            steady = {}
            for kind, (gen, disc) in nets.items():
                # the largest batch of the epoch (B × frames), the shape a step times
                batch = max(loaders[kind], key=lambda b: b["mel"].shape[0] * b["mel"].shape[1])
                # one batch of each (frames, text) bucket the CLI runs trained on
                buckets = {}
                for b in loaders[kind]:
                    buckets.setdefault((b["mel"].shape[1], b["text"].shape[1]), b)
                init = [{k: v.clone() for k, v in m.state_dict().items()} for m in (gen, disc)]
                names, params = zip(*[(k, p) for k, p in gen.named_parameters()
                                      if p.requires_grad])
                gaw = steps.guided_attention_table(base)
                for (T_b, N_b), bb in sorted(buckets.items()):
                    first = {}
                    for impl in GATE_IMPLS:
                        with gate_impl(impl):
                            init_fn, g_step, d_step = make_steps(gen, disc, base, kind)
                            # each step from the initial weights: after one Adam step a
                            # parameter moves by ~lr·sign(g), so rounding in a near-zero
                            # gradient would move the second step's inputs by ~lr
                            for m, sd in zip((gen, disc), init):
                                load_state(m, sd)
                            # the generator's outputs in the G step
                            got = {}
                            hook = gen.register_forward_hook(lambda mod, i, o: got.update(
                                out=[t.detach().clone() for t in (o if isinstance(o, tuple)
                                                                  else (o,))]))
                            before = snap()
                            _, gm = g_step(init_fn(), bb)
                            torch.cuda.synchronize()
                            g_n = since(before)
                            hook.remove()
                            for m, sd in zip((gen, disc), init):
                                load_state(m, sd)
                            before = snap()
                            mix = torch.Generator(device=dev).manual_seed(1)
                            _, dm = d_step(init_fn(), bb, mix)
                            torch.cuda.synchronize()
                            d_n = since(before)
                            # the G step's gradient is ∇recon + c·∇loss_disc with c =
                            # recon/|loss_disc| from the forward; the two are held
                            # apart, from the initial weights. The backwards recompute
                            # the plain version, so a fault there moves them by O(1);
                            # rounding alone moves them far more than the outputs
                            # (K6's 4e-6 in the outputs gave 8.6e-4 in ∇recon on the
                            # card: the L1 loss's sign and the ReLUs' masks flip), so
                            # the gates sit at 1e-2 (whole) and 5e-2 (a parameter)
                            for m, sd in zip((gen, disc), init):
                                load_state(m, sd)
                            gen.train(base.apply_dropout)
                            y, a = steps._gen_forward(gen, bb, kind)
                            rl, _ = steps._recon_losses(bb, y, a, gaw, kind, False)
                            ld = torch.mean(-disc(y.float()))
                            got["grads"] = [
                                [torch.zeros_like(p) if g is None else g for p, g in zip(
                                    params, torch.autograd.grad(loss, params, retain_graph=True,
                                                                allow_unused=True))]
                                for loss in (rl, ld)]
                            got["coeff"] = float(rl / ld.abs())
                            del y, a, rl, ld
                        recon = sum(float(gm[k]) for k in ("l1", "bd", "att") if k in gm)
                        first[impl] = dict(losses=(float(gm["loss"]), float(dm["loss_d"]),
                                                   float(dm["gp"]), recon), **got)
                        if impl in impl_kernel:
                            gate(g_n[impl_kernel[impl]] > 0 and d_n[impl_kernel[impl]] > 0,
                                 (kind, impl, "the impl's kernel did not run in G and D", g_n,
                                  d_n))
                        ref = first["xla"]
                        # the G loss is recon·(1 ± 1) (the adaptive weight cancels it when
                        # the critic's term is negative), so it is held relative to recon
                        scale = (ref["losses"][3], abs(ref["losses"][1]), abs(ref["losses"][2]),
                                 ref["losses"][3])
                        rel = max(abs(a - b) / s_ for a, b, s_ in zip(first[impl]["losses"],
                                                                      ref["losses"], scale))
                        out_d = max(float((o - r).abs().max()) for o, r in
                                    zip(first[impl]["out"], ref["out"]))
                        # of ∇recon and ∇loss_disc: each parameter's difference over
                        # its norm, and the whole gradient's (all parameters as one)
                        whole, worst = [], []
                        for gs_i, gs_x in zip(first[impl]["grads"], ref["grads"]):
                            d2 = [float(torch.linalg.norm(g - r)) ** 2
                                  for g, r in zip(gs_i, gs_x)]
                            r2 = [float(torch.linalg.norm(r)) ** 2 for r in gs_x]
                            whole.append(float(np.sqrt(sum(d2) / sum(r2))))
                            worst.append(max((float(np.sqrt(d / max(r, 1e-60))), n)
                                             for d, r, n in zip(d2, r2, names)))
                        c_rel = abs(first[impl]["coeff"] / ref["coeff"] - 1.0)
                        outs = "s (mel, attention)" if len(ref["out"]) > 1 else ""
                        log(f"[train-cli] {kind} B={bb['mel'].shape[0]} T={T_b} N={N_b} first "
                            f"G loss / D loss_d / gp / recon under {impl}: "
                            f"{first[impl]['losses']}, max relative to xla {rel:.3g} (gate "
                            f"1e-4); G-step generator output{outs} "
                            f"max|d| {out_d:.3g} (gate 1e-4); gradients of recon / loss_disc "
                            f"(all {len(params)} parameters) relative difference "
                            f"{whole[0]:.3g} / {whole[1]:.3g} (gate 1e-2), largest per "
                            f"parameter {worst[0][0]:.3g} ({worst[0][1]}) / {worst[1][0]:.3g} "
                            f"({worst[1][1]}) (gate 5e-2); the adaptive weight "
                            f"recon/|loss_disc| {first[impl]['coeff']:.6g}, relative to xla "
                            f"{c_rel:.3g}; G launches "
                            f"{ {k: g_n[k] for k in highway} }, D "
                            f"{ {k: d_n[k] for k in highway} }")
                        gate(rel <= 1e-4, (kind, impl, T_b, N_b, "first steps vs xla",
                                           first[impl]["losses"], ref["losses"]))
                        gate(out_d <= 1e-4 and max(whole) <= 1e-2
                             and max(w for w, _ in worst) <= 5e-2,
                             (kind, impl, T_b, N_b, "G-step outputs / gradients vs xla", out_d,
                              whole, worst))
                    del first, got
                # the critic alone: forward, penalty gradient and its backward
                x = batch["mel" if kind == "train_text2mel" else "lin"].clone().requires_grad_()
                for impl in GATE_IMPLS:
                    with gate_impl(impl):
                        before = snap()
                        gx, = torch.autograd.grad(disc(x).sum(), x, create_graph=True)
                        ((gx.flatten(1).norm(dim=1) - 1.0) ** 2).mean().backward()
                        torch.cuda.synchronize()
                        c_n = since(before)
                    gate(all(c_n[k] == 0 for k in highway), (kind, impl, "critic launched", c_n))
                log(f"[train-cli] {kind} critic forward + penalty under every impl: 0 highway "
                    f"kernel launches")
                # steady-state step times under the impl the CLI run used: one warm-up
                # step each, then 5 G and 5 D steps, host clock closed by a sync;
                # Text2Mel also under bf16 autocast, as its bf16 CLI run trains
                impl = "fused_pair" if kind == "train_text2mel" else "fused_conv"
                dts = ((torch.float32, torch.bfloat16) if kind == "train_text2mel"
                       else (torch.float32,))
                for dt in dts:
                    tag = kind if dt == torch.float32 else f"{kind} bf16"
                    for m, sd in zip((gen, disc), init):
                        load_state(m, sd)
                    with gate_impl(impl):
                        init_fn, g_step, d_step = make_steps(gen, disc, base, kind,
                                                             compute_dtype=dt)
                        state = init_fn()
                        mix = torch.Generator(device=dev).manual_seed(2)
                        times = {"G": [], "D": []}
                        for which in ["G", "D"] + ["G"] * 5 + ["D"] * 5:
                            torch.cuda.synchronize()
                            t = time.perf_counter()
                            state, _ = (g_step(state, batch) if which == "G"
                                        else d_step(state, batch, mix))
                            torch.cuda.synchronize()
                            times[which].append(1e3 * (time.perf_counter() - t))
                        for which, step in (("G", lambda: g_step(state, batch)),
                                            ("D", lambda: d_step(state, batch, mix))):
                            device_view(step, smi, f"[train-cli] {tag} device view of one "
                                                   f"{which} step under {impl}")
                    steady[tag] = {k: round(statistics.median(v[1:]), 3)
                                   for k, v in times.items()}
                    log(f"[train-cli] {tag} steady steps under {impl}, "
                        f"B={batch['mel'].shape[0]} T={batch['mel'].shape[1]} "
                        f"N={batch['text'].shape[1]}: G ms "
                        f"{[round(v, 2) for v in times['G'][1:]]}, D ms "
                        f"{[round(v, 2) for v in times['D'][1:]]} (after one warm-up each; "
                        f"host clock closed by synchronize) on [{smi}]")
            data_bytes = {kind: ld.nbytes for kind, ld in loaders.items()}
            del loaders, melsyn, ssrn, mel_disc, lin_disc, nets, batch, x, gx

            # -- the weaker GAN variants: Trainer alone, Text2Mel ----------------
            variant_ms = {}
            loader = DeviceReplayLoader(TTSDataSource(base, "train", spec, need_lin=False),
                                        base.batch_size, seed=0, device=dev)
            for gan_type in ("wgan", "vanilla"):
                torch.manual_seed(0)
                gen = cli.build_models(base, device=dev)[0]
                disc = MelDisc(base.disc_dim, sigmoid_out=gan_type == "vanilla",
                               freq_bins=base.mel.freq_bins).to(dev)
                seen.clear()
                tr_v = Trainer(base, gen, "train_text2mel", adversarial=True, gan_type=gan_type,
                               disc_model=disc, ctime=gan_type)
                tr_v.fit(lambda: loader, max_iterations=6)
                tr_v.close()
                vals = [float(v) for r in seen for v in r["metrics"].values()]
                variant_ms[gan_type] = (median_ms(seen, "G"), median_ms(seen, "D"))
                clipped = max(float(p.detach().abs().max()) for name, p in
                              disc.named_parameters() if name.endswith(".weight"))
                log(f"[train-cli] {gan_type}: 6 iterations, G/D ms (median) "
                    f"{variant_ms[gan_type]}, losses {[round(v, 5) for v in vals]}, critic "
                    f"max |weight| {clipped:.6f}")
                gate(tr_v.iteration == 6 and len(seen) == 6 and bool(np.isfinite(vals).all()),
                     (gan_type, "losses", vals))
                if gan_type == "wgan":
                    gate(all(bool((p.abs() <= 0.1).all()) for name, p in disc.named_parameters()
                             if name.endswith(".weight")), ("wgan critic not clipped", clipped))
            log(f"[train-cli] step ms (median, host clock closed by synchronize): wgan-gp "
                f"steady G/D {steady}; in the CLI runs (first steps included) text2mel G/D "
                f"{t2m_ms}, ssrn G/D {ssrn_ms}; text2mel wgan "
                f"{variant_ms['wgan']}, vanilla {variant_ms['vanilla']}; features "
                f"{feature_s:.2f} s; synthesize wall {syn_wall:.3f} s; device-resident "
                f"training sets: text2mel {t2m_bytes} bytes, ssrn {ssrn_bytes} bytes (loaders "
                f"{data_bytes}) on [{smi}]")
            out = {"train_cli": train_launches, "synthesize_cli": syn_launches,
                   "train_cli_bf16": bf16_cli}
    finally:
        steps.make_adversarial_steps = make_steps
        rec.restore()
    return out


GE2E_YAML = """training: !!bool "true"
device: "cuda"
unprocessed_data: '{unprocessed}'
---
data:
    train_path: '{root}/tisv/train'
    test_path: '{root}/tisv/test'
    sr: 16000
    nfft: 512 # the reference's GE2E features: 25 ms window, 10 ms hop, 40 mels
    window: 0.025
    hop: 0.01
    nmels: 40
    tisv_frame: 120
---
model:
    hidden: 768
    num_layer: 3
    proj: 256
    model_path: '{root}/ge2e_ckpt/final_epoch_{epochs}.npz'
---
train:
    N : 6
    M : 50
    lr: 0.01
    epochs: {epochs}
    log_interval: 1
    log_file: '{root}/ge2e_train.log'
    checkpoint_interval: {epochs}
    checkpoint_dir: '{root}/ge2e_ckpt'
---
test:
    N : 6
    M : 86
    epochs: 1
save_simmat_dir: '{root}/simmat'
"""


@contextlib.contextmanager
def quiet():
    """The block's standard output (the CLIs' per-file progress) dropped."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        yield


def ge2e_attack_phase(cfg, dev, state_dicts, counters: dict, cluster, smi: str, spectral_err,
                      root: str, n_speakers: int = 12, utts_per_spk: int = 24,
                      epochs: int = 8) -> tuple:
    """Phase 11: the GE2E attack path, through the CLIs' own ``main(argv)``.
    A toy corpus in VCTK's layout (12 speakers x 24 utterances of 20-32
    characters, ~2-3 s each) prepared by ``cli/metagen.py``;
    ``cli/generate_test_utterances.py`` with staging from the seed-0 weights
    (``.tar.pth``): bf16 synthesis of the 20 Harvard sentences for every
    speaker (K1-K3, held on each call's own inputs), then the i-vector, GE2E
    and anti-spoofing layouts, every staged FLAC read back to the int16
    samples it was written from; ``cli/ge2e.py preprocess`` (6 train, 6
    test speakers of 3 enroll + 20 eval real and 20 spoof utterances), then
    ``train`` at full width (LSTM 3x768, projection 256, 40 mels, 120-frame
    crops, N=6 x M=50 crops a step) for ``epochs`` steps, ``test`` (EER, the
    clean threshold from the staged real-only copy, the spoof rate) and
    ``dvector``. Times: the GE2E step (median of 5 after a warm-up), the
    embedder's utterances/s at B=960 x 120 x 40 in bf16 and f32, the
    staging, the preprocessing. Everything is written under ``root``, which
    phase 12 scores. Returns K1-K3's launches on the staging run and the
    configuration file (``config.json``) phase 12 runs the CLIs with."""
    import copy
    import statistics

    import torch
    from scipy.io import wavfile

    from spoofsv_torch.cli import ge2e as cli_ge2e
    from spoofsv_torch.cli import generate_test_utterances as cli_gen
    from spoofsv_torch.cli import metagen as cli_metagen
    from spoofsv_torch.config import GE2EConfig
    from spoofsv_torch.data.toy import generate_toy_corpus
    from spoofsv_torch.dsp import host as dsp_host
    from spoofsv_torch.spoofkit import flacio, ge2e_harness, spoofgen

    def reset() -> None:
        for c in [*counters.values(), cluster]:
            c.launches = 0

    rec, stage_s = SynthesisRecorder(), {}
    syn_calls, gl_calls = rec.syn_calls, rec.gl_calls
    stagers = {k: getattr(spoofgen, k) for k in ("generate_spoof_set", "stage_ivector_data",
                                                 "stage_ge2e_data", "stage_antispoof_data")}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[name] = time.perf_counter() - t
            return out
        return run

    rec.install()
    for k, fn in stagers.items():
        setattr(spoofgen, k, timed(k, fn))
    try:
        # -- corpus, metagen, the generators' checkpoints ------------------
        t0 = time.perf_counter()
        speakers = generate_toy_corpus(os.path.join(root, "data"), os.path.join(root, "emb"),
                                       n_speakers=n_speakers, utts_per_spk=utts_per_spk,
                                       spk_emb_dim=cfg.spk_emb_dim, seed=1, min_chars=20,
                                       max_chars=32, rich_speakers=True)
        with open(os.path.join(root, "havard.txt"), "w") as f:
            f.write("\n".join(SENTENCES) + "\n")
        ckpt = {}
        for kind, sd in state_dicts.items():
            ckpt[kind] = os.path.join(root, f"{kind}_iteration_0.tar.pth")
            torch.save({"model_state_dict": sd}, ckpt[kind])
        c11 = cfg.replace(data_root_dir=os.path.join(root, "data"),
                          spk_emb_dir=os.path.join(root, "emb"), src_root_dir=root + "/",
                          tts_texts=os.path.join(root, "havard.txt"),
                          antispoof_dir=os.path.join(root, "cm"),
                          inference_text2mel_model=ckpt["text2mel"],
                          inference_ssrn_model=ckpt["ssrn"])
        conf = os.path.join(root, "config.json")
        with open(conf, "w") as f:
            json.dump(c11.to_reference_dict(), f)
        with quiet():
            cli_metagen.main(["-c", conf])
        wav22 = os.path.join(root, "data", "wav22")
        gate(sorted(os.listdir(wav22)) == speakers
             and all(len(os.listdir(os.path.join(wav22, s))) == utts_per_spk
                     for s in speakers), ("metagen wav22", sorted(os.listdir(wav22))))
        corpus_s = time.perf_counter() - t0

        # -- the spoof set and its staging: the counted run ---------------
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with quiet():
            cli_gen.main(["-C", conf, "-T", "attack", "--train_spk_num", "6",
                          "--enroll_utt_num", "3", "--eval_utt_num", "20",
                          "--speaker_batch", "8"], device=dev)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        n = {k: c.launches for k, c in counters.items()}
        launches = {"decode": cluster.launches, "gl_init": n["gl_init"],
                    "griffin_lim": n["griffin_lim"], "griffin_lim_f32": n["griffin_lim_f32"],
                    "decode_f32": n["decode_f32"]}
        log(f"[attack] generate_test_utterances ({n_speakers} speakers x 20 sentences, "
            f"bf16, speaker batch 8) with staging: {gen_wall:.3f} s wall; synthesis "
            f"{stage_s['generate_spoof_set']:.3f} s, i-vector staging "
            f"{stage_s['stage_ivector_data']:.3f} s, GE2E staging "
            f"{stage_s['stage_ge2e_data']:.3f} s, anti-spoofing staging (16 kHz FLAC) "
            f"{stage_s['stage_antispoof_data']:.3f} s; calls (B) "
            f"{[len(t) for _, t, _ in syn_calls]}; launches {launches} on [{smi}]")
        gate(len(syn_calls) == 2 and launches["decode"] == n["decode"] == 2
             and launches["gl_init"] == 2 and launches["griffin_lim"] == 2
             and launches["griffin_lim_f32"] == 0 and launches["decode_f32"] == 0,
             ("staging run launches", launches, n))
        hold_synthesis(syn_calls, gl_calls, dev, spectral_err, "attack synthesis")
        syn_calls.clear()
        gl_calls.clear()
        test_root = os.path.join(root, "test", "attack")
        spoof_dir = os.path.join(test_root, "spoof_data")
        spoofs = [os.path.join(spoof_dir, d, f) for d in sorted(os.listdir(spoof_dir))
                  for f in sorted(os.listdir(os.path.join(spoof_dir, d)))]
        gate(len(spoofs) == 20 * n_speakers, ("spoof set", len(spoofs)))
        iv = os.path.join(test_root, "ivector_data")
        sids = [s[1:] for s in speakers]
        gate(sorted(os.listdir(os.path.join(iv, "wav", "train"))) == sids[:6]
             and sorted(os.listdir(os.path.join(iv, "wav", "test"))) == sids[6:]
             and all(len(os.listdir(os.path.join(iv, "wav", "test", s))) == 43
                     for s in sids[6:])
             and all(len(os.listdir(os.path.join(iv, "test_nospoof", s))) == 23
                     for s in sids[6:])
             and sorted(os.listdir(os.path.join(test_root, "ge2e_data"))) == sids,
             ("i-vector / GE2E layouts", sorted(os.listdir(os.path.join(iv, "wav")))))
        flac_dir = os.path.join(root, "cm", "attack", "flac")
        flacs = sorted(os.listdir(flac_dir))
        gate(flacs == [f"LA_D_{i + 1:07d}.flac" for i in range(len(spoofs))],
             ("CM layout", flacs[:3], len(flacs)))
        for path, name in zip(spoofs, flacs):
            y, _ = dsp_host.load_wav(path, sr=16000)
            want = (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int32)
            got, sr = flacio.decode_flac(os.path.join(flac_dir, name))
            gate(sr == 16000 and np.array_equal(np.round(got * 32768.0).astype(np.int32),
                                                want), ("staged FLAC", name))
        with open(os.path.join(root, "cm", "ASVspoof2019_LA_cm_protocols",
                               "customized_data_attack.txt")) as f:
            proto = f.read().splitlines()
        gate(len(proto) == len(spoofs) and all(ln.endswith(" - - spoof") for ln in proto),
             ("CM protocol", proto[:2]))
        audio_s = sum(len(wavfile.read(p_)[1]) / cfg.sampling_rate for p_ in spoofs)
        log(f"[attack] staged: {len(spoofs)} spoof wavs ({audio_s:.1f} s of audio), "
            f"i-vector train/test/test_nospoof, {len(sids)} GE2E links, {len(flacs)} FLACs "
            f"each read back to its int16 samples; corpus + metagen {corpus_s:.2f} s")

        # -- GE2E: preprocess, train, test, dvector -------------------------
        yaml_path = os.path.join(root, "ge2e.yaml")
        with open(yaml_path, "w") as f:
            f.write(GE2E_YAML.format(root=root, epochs=epochs, unprocessed=os.path.join(
                test_root, "ge2e_data", "*", "*.wav")))
        ge2e = GE2EConfig.from_yaml(yaml_path)
        gate(ge2e.model.hidden == 768 and ge2e.train.N == 6 and ge2e.train.M == 50
             and ge2e.data.tisv_frame == 120, ("GE2E config", ge2e))
        reset()
        t0 = time.perf_counter()
        with quiet():
            cli_ge2e.main(["preprocess", "--config", yaml_path, "--train_spk_num", "6",
                           "--enroll_num", "3", "--eval_num", "20"])
        prep_s = time.perf_counter() - t0
        tisv = {k: sorted(os.listdir(os.path.join(root, "tisv", k)))
                for k in ("train", "test")}
        shapes = {k: [np.load(os.path.join(root, "tisv", k, f), mmap_mode="r").shape
                      for f in fs] for k, fs in tisv.items()}
        log(f"[attack] ge2e preprocess: {prep_s:.3f} s; crops {shapes}")
        gate(len(tisv["train"]) == len(tisv["test"]) == 6
             and all(sh == (86, 40, 120) for sh in shapes["test"])
             and all(sh[0] >= 2 and sh[1:] == (40, 120) for sh in shapes["train"]),
             ("TI-SV crops", shapes))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with quiet():
            emb, loss_mod = cli_ge2e.main(["train", "--config", yaml_path], device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        with open(ge2e.train.log_file) as f:
            losses = [float(ln.split("Loss:")[1].split()[0]) for ln in f if "Loss:" in ln]
        gate(len(losses) == epochs and bool(np.isfinite(losses).all())
             and next(emb.parameters()).device.type == "cuda",
             ("GE2E training", losses))
        gate(os.path.exists(ge2e.model.model_path), ("final checkpoint", ge2e.model.model_path))
        with quiet():
            result = cli_ge2e.main(
                ["test", "--config", yaml_path, "--enroll_num", "3", "--eval_num", "20",
                 "--nospoof_data", os.path.join(iv, "test_nospoof", "*", "*.wav")],
                device=dev)
        gate(all(np.isfinite(v) for v in result.values()) and 0 <= result["EER"] <= 1
             and 0.5 <= result["clean_threshold"] <= 0.99, ("GE2E test", result))
        dvec_yaml = os.path.join(root, "dvec.yaml")
        with open(dvec_yaml, "w") as f:
            f.write(GE2E_YAML.format(root=root, epochs=epochs, unprocessed=os.path.join(
                iv, "test_nospoof", "*", "*.wav")))
        out_dir = os.path.join(root, "dvec")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        with quiet():
            seq, ids = cli_ge2e.main(["dvector", "--config", dvec_yaml, "--out_dir",
                                      out_dir], device=dev)
        dvec_s = time.perf_counter() - t0
        gate(seq.shape[1] == 256 and len(seq) == len(ids) > 0 and bool(np.isfinite(seq).all())
             and set(ids) == set(sids[6:]), ("d-vectors", seq.shape, sorted(set(ids))))
        n = {k: c.launches for k, c in counters.items()}
        gate(all(v == 0 for v in n.values()) and cluster.launches == 0,
             ("a hand-written kernel ran in the GE2E commands", n))
        log(f"[attack] ge2e train: {epochs} steps (N=6 x M=50 crops of 120 x 40, LSTM "
            f"3x768, projection 256, f32) in {train_s:.3f} s, losses "
            f"{[round(v, 4) for v in losses]}; test (slice and staged real-only threshold) "
            f"{json.dumps(result)}; dvector {seq.shape} in {dvec_s:.3f} s. EER and spoof "
            f"rate after {epochs} steps on a toy corpus with a random-weight synthesizer "
            f"prove the path runs, not the verifier or the attack")

        # -- timings: the train step, the embedder's throughput -------------
        bank = ge2e_harness.DeviceSpeakerBank(ge2e.data.train_path, 50, seed=1, device=dev)
        e2, l2 = ge2e_harness.build_ge2e(ge2e, dev, seed=1)
        step = ge2e_harness.make_ge2e_train_step(e2, l2, ge2e.train.lr, n_speakers=6)
        times = []
        for _ in range(6):
            batch = bank.sample_batch(6)
            torch.cuda.synchronize()
            t = time.perf_counter()
            float(step(batch))
            times.append(1e3 * (time.perf_counter() - t))
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(960, 120, 40)).astype(
            np.float32)).to(dev)
        rates = {}
        for name, model in (("bf16", copy.deepcopy(emb).to(torch.bfloat16)), ("f32", emb)):
            model.eval()
            with torch.no_grad():
                xs = x.to(next(model.parameters()).dtype)
                e = model(xs)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for i in range(5):
                    e = model(xs * (1.0 + 1e-3 * i))
                torch.cuda.synchronize()
                rates[name] = round(960 * 5 / (time.perf_counter() - t), 1)
            gate(e.shape == (960, 256) and bool(torch.isfinite(e.float()).all()),
                 ("embedder", name, e.shape))
        log(f"[attack] GE2E train step N=6 M=50 (300 x 120 x 40, f32, device-resident crops "
            f"{bank.nbytes} bytes): {[round(v, 2) for v in times[1:]]} ms, median "
            f"{statistics.median(times[1:]):.2f} ms (after a warm-up; host clock closed by "
            f"synchronize) on [{smi}]")
        log(f"[attack] GE2E embedder B=960 x 120 x 40 (bench.py's shape): {rates} utterances/s "
            f"(5 calls, host clock closed by synchronize) on [{smi}]")
        staging = sum(v for k, v in stage_s.items() if k != "generate_spoof_set")
        log(f"[attack] staging {staging:.3f} s, preprocessing {prep_s:.3f} s on [{smi}]")
        del emb, loss_mod, e2, l2, bank, x, e
    finally:
        rec.restore()
        for k, fn in stagers.items():
            setattr(spoofgen, k, fn)
    return launches, conf


def em_view(args, gauss: int, ivec_dim: int, smi: str) -> None:
    """One more T-matrix EM iteration on a run's own last inputs under
    ``torch.profiler``: its device time by kind of kernel (the Gram and
    accumulator GEMMs, the batched Cholesky factorizations, the triangular
    solves, the rest) and its wall time (the device's idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spoofsv_torch.spoofkit import ivector_torch

    ivector_torch._em_accumulate_and_update(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ivector_torch._em_accumulate_and_update(*args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kinds = {"GEMM": ("gemm", "gemv", "cutlass", "xmma", "sm90_", "sm80_", "ampere"),
             "Cholesky": ("potrf", "chol"), "triangular solves": ("trsm", "potrs", "trsv")}
    by_kind, by_name, n = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        name = e.key.lower()
        kind = next((k for k, keys in kinds.items() if any(w in name for w in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        by_name[e.key] = us / 1e3
        n += e.count
    if not by_name:
        log("[score] EM iteration under torch.profiler: no device time recorded (not measured)")
        return
    busy = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[score] one T-matrix EM iteration at {gauss} / {ivec_dim} under torch.profiler: "
        f"{busy:.3f} ms of device time in {wall_ms:.3f} ms of wall "
        f"({100 * (1 - busy / wall_ms):.1f} % idle), {n} device events; by kind (ms) "
        f"{json.dumps({k: round(v, 3) for k, v in sorted(by_kind.items())})}; largest: "
        + ", ".join(f"{k[:70]} {v:.3f}" for k, v in top) + f" on [{smi}]")


def scoring_phase(conf: str, root: str, dev, counters: dict, cluster, smi: str,
                  ctime: str = "attack", gauss: int = 1024, ivec_dim: int = 400,
                  cm_steps: int = 200) -> dict:
    """Phase 12: the scoring half of the attack on phase 11's staged tree
    (``root``), through the CLIs' own ``main(argv)``.

    i-vector/PLDA: ``cli/ivector.py`` at 64 Gaussians and 100 dims (diagonal
    UBM) with the native and the torch backends (both EERs and spoof
    rates); on the phase's own features (the staged train utterances, MFCC +
    deltas + CMVN + VAD) the torch backend's Baum-Welch stats (diag, and full
    after one device full-UBM sweep) against native (rtol 2e-4 / 3e-4) and
    its extractions (diag, and a device-trained full extractor) against
    native (2e-3), counting the rows re-solved natively; then the full
    configuration (``gauss`` 1024 Gaussians, ``ivec_dim`` 400 dims,
    full-covariance UBM, deltas; halved while the toy pool cannot fit that
    many components finitely) on the card with ``--models_dir``, each stage timed (features, diag UBM,
    full UBM, stats, every T-matrix EM iteration, extraction, PLDA), and
    again reusing the models; EERs and spoof rate finite in [0, 1],
    ``--recompute_eer`` on the mixed score file equal to ``result.json``'s.
    The countermeasure: a toy ``ASVspoof2019.LA.cm.train.trn.txt`` with the
    spoofs of phase 11's six train speakers, ``cli/antispoof.py train`` at
    batch 64 on mel for ``cm_steps`` steps (each timed), one step each of v1,
    v2 and ``--feat lin``, ``dev`` on the staged ``customized_data_<ctime>``
    (score file, CM EER), a checkpoint round trip. The curves:
    ``ge2e_curve`` on phase 11's first similarity matrix and
    ``ivector_curve`` on the mixed score file, each against a numpy
    recomputation, and the PNG through ``cli/curve.py`` when matplotlib is
    installed. No hand-written kernel runs here: the launch counts are held
    at 0. Returns them."""
    import glob
    import importlib.util
    import shutil
    import statistics

    import torch

    from spoofsv_torch.cli import antispoof as cli_cm
    from spoofsv_torch.cli import curve as cli_curve
    from spoofsv_torch.cli import ivector as cli_iv
    from spoofsv_torch.config import load_config
    from spoofsv_torch.spoofkit import antispoof, curve, ivector, ivector_torch
    from spoofsv_torch.weights import load_critic_params, save_critic_params

    cfg = load_config(conf)
    for c in [*counters.values(), cluster]:
        c.launches = 0
    iv_root = os.path.join(root, "test", ctime, "ivector_data")
    score_dir = os.path.join(iv_root, "scores")
    resolved = []
    repair = ivector._repair_nonfinite_rows

    def counted_repair(extract_fn, out, stats):
        resolved.append(int((~np.isfinite(out).all(axis=1)).sum()))
        return repair(extract_fn, out, stats)

    def close(got, want, rtol) -> float:
        """Worst |got − want| − rtol·|want|."""
        return float(np.max(np.abs(got - want) - rtol * np.abs(want)))

    ivector._repair_nonfinite_rows = counted_repair
    try:
        # -- i-vector at 64 / 100: the torch backend against native ---------
        small = ["-C", conf, "-T", ctime, "--num_gauss", "64", "--ivec_dim", "100",
                 "--diag_ubm"]
        res = {}
        for backend in ("native", "torch"):
            t = time.perf_counter()
            with quiet():
                res[backend] = cli_iv.main(small + ["--backend", backend, "--models_dir",
                                                    os.path.join(root, f"iv64_{backend}")],
                                           device=dev)
            log(f"[score] i-vector 64 Gaussians / 100 dims, diag UBM, backend {backend}: "
                f"{time.perf_counter() - t:.3f} s; mixed EER {res[backend]['mixed_eer']:.4f}, "
                f"clean EER {res[backend]['clean_eer']:.4f}, spoof rate "
                f"{res[backend]['spoof_rate']:.4f} ({res[backend]['n_spoof_targets']} spoof "
                f"targets, {res[backend]['n_mixed_trials']} trials) on [{smi}]")
            gate(all(np.isfinite(res[backend][k]) and 0 <= res[backend][k] <= 1
                     for k in ("mixed_eer", "clean_eer", "spoof_rate")), (backend, res[backend]))

        train_dir = os.path.join(iv_root, "wav", "train")
        paths = [os.path.join(train_dir, s, u) for s in sorted(os.listdir(train_dir))
                 for u in sorted(os.listdir(os.path.join(train_dir, s)))]
        feats = [f for f in ivector._thread_map(ivector.mfcc_vad_features, paths, 8) if len(f)]
        ubm = ivector.UBM.load(os.path.join(root, "iv64_torch", "ubm.npz"))
        nat_d = ubm.acc_stats_batch(feats, backend="native")
        dev_d = ubm.acc_stats_batch(feats, backend="torch", device=dev)
        fubm = ivector.FullUBM.train(ubm, np.concatenate(feats), iters=1, backend="torch",
                                     device=dev)
        nat_f = fubm.acc_stats_batch(feats, backend="native")
        dev_f = fubm.acc_stats_batch(feats, backend="torch", device=dev)
        worst = {}
        for name, nat, got, rtol in (("diag", nat_d, dev_d, 2e-4), ("full", nat_f, dev_f, 3e-4)):
            # The unit tests' elementwise tolerance (rtol, atol 1e-5 on N and
            # rtol on F) misses a few entries on these features for the JAX
            # backend too (0.16 % and 0.05 % on the CPU rehearsal's tree), so
            # the gate is the share outside it. Each utterance's largest gap
            # over its largest entry is reported only: the toy full-covariance
            # log-likelihoods reach 1e5, where f32 (JAX's precision as well)
            # moves an outlier frame's posterior split (2.6e-2 seen on the card)
            out = sum(int((np.abs(g[0] - n[0]) > 1e-5 + rtol * np.abs(n[0])).sum())
                      + int((np.abs(g[1] - n[1]) > rtol + rtol * np.abs(n[1])).sum())
                      for g, n in zip(got, nat))
            size = sum(n[0].size + n[1].size for n in nat)
            gaps = [max(float(np.abs(g[k] - n[k]).max() / np.abs(n[k]).max()) for k in (0, 1))
                    for g, n in zip(got, nat)]
            i = int(np.argmax(gaps))
            worst[name] = (out / size, gaps[i], float(np.median(gaps)))
            log(f"[score] {name} stats, the utterance with the largest gap: {len(feats[i])} "
                f"voiced frames, N total {nat[i][0].sum():.3f}, max|dN| "
                f"{np.abs(got[i][0] - nat[i][0]).max():.4g}, max|dF| "
                f"{np.abs(got[i][1] - nat[i][1]).max():.4g} (max|F| {np.abs(nat[i][1]).max():.4g})")
            gate(worst[name][0] <= 0.01, (f"{name} stats against native", worst[name]))
        ext_d = ivector.IvectorExtractor.load(os.path.join(root, "iv64_torch", "extractor.npz"))
        ext_f = ivector.IvectorExtractorFull.train(fubm, nat_f, ivec_dim=100, iters=2, seed=0,
                                                   backend="torch", device=dev)
        for name, ext, st in (("diag", ext_d, nat_d), ("full", ext_f, nat_f)):
            resolved.clear()
            got = ext.extract_batch(st, backend="torch", device=dev)
            want = np.stack([ext.extract(*s_) for s_ in st])
            worst[f"extract {name}"] = close(got, want, 2e-3)
            log(f"[score] {name} extraction of {len(st)} utterances at 64 / 100: torch against "
                f"native worst |d| - 2e-3|native| {worst[f'extract {name}']:.3g} (gate 2e-3); "
                f"rows re-solved natively {resolved}")
            gate(worst[f"extract {name}"] <= 2e-3, (f"{name} extraction", worst))
        log(f"[score] Baum-Welch stats of the {len(feats)} staged train utterances "
            f"({sum(len(f) for f in feats)} voiced frames x {feats[0].shape[1]}), torch "
            f"against native: (share of N and F entries outside rtol and atol 1e-5 / rtol, "
            f"max|d| / max|native| of an utterance: the largest, the median) diag "
            f"{worst['diag']} (rtol 2e-4), "
            f"full {worst['full']} (rtol 3e-4); gate 1 % on the share")

        # -- the full configuration on the card -----------------------------
        stage, last_args = {}, {}

        def timed(mod, name, label, sync=True):
            fn, orig = getattr(mod, name), vars(mod)[name]

            def run(*a, **kw):
                last_args[label] = a
                if sync:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                stage.setdefault(label, []).append(time.perf_counter() - t)
                return out
            setattr(mod, name, run)
            return mod, name, orig

        patched = [timed(ivector, "_thread_map", "features", sync=False),
                   timed(ivector_torch, "train_diag_ubm", "diag UBM"),
                   timed(ivector_torch, "train_full_ubm", "full UBM"),
                   timed(ivector_torch, "acc_stats_full_batch", "stats"),
                   timed(ivector_torch, "_em_accumulate_and_update", "EM iteration"),
                   timed(ivector_torch, "extract_ivectors", "extraction"),
                   timed(ivector.PLDA, "train", "PLDA train", sync=False),
                   timed(ivector.PLDA, "llr", "PLDA scoring", sync=False)]
        cuts, runs = [], []
        try:
            while True:
                full = ["-C", conf, "-T", ctime, "--num_gauss", str(gauss), "--ivec_dim",
                        str(ivec_dim),
                        "--backend", "torch", "--models_dir", os.path.join(root, f"iv{gauss}")]
                try:
                    for _ in range(2):
                        stage.clear()
                        resolved.clear()
                        torch.cuda.reset_peak_memory_stats()
                        t = time.perf_counter()
                        with quiet():
                            result = cli_iv.main(full, device=dev)
                        runs.append((result, time.perf_counter() - t, dict(stage), list(resolved),
                                     torch.cuda.max_memory_allocated()))
                    break
                except RuntimeError as e:
                    if "non-finite" not in str(e) or gauss <= 64:
                        raise
                    log(f"[score] {gauss} Gaussians do not fit the toy pool finitely ({e}); "
                        f"halving")
                    cuts.append(gauss)
                    gauss //= 2
                    runs.clear()
        finally:
            for mod, name, fn in patched:
                setattr(mod, name, fn)
        for i, (result, wall, st, rs, peak) in enumerate(runs):
            summary = {k: ([round(1e3 * v, 3) for v in vs] if k in ("EM iteration", "stats",
                                                                     "extraction", "features")
                           else round(1e3 * sum(vs), 3)) for k, vs in st.items()}
            log(f"[score] i-vector {gauss} Gaussians / {ivec_dim} dims, full UBM, deltas, torch "
                f"{'(training)' if i == 0 else '(models reused)'}: {wall:.3f} s wall; stage ms "
                f"{json.dumps(summary)}; rows re-solved natively {rs}; peak device memory "
                f"{peak} bytes; result {json.dumps(result)} on [{smi}]")
            gate(all(np.isfinite(result[k]) and 0 <= result[k] <= 1
                     for k in ("mixed_eer", "clean_eer", "spoof_rate")), ("full i-vector", result))
        gate(len(runs) == 2 and "EM iteration" not in runs[1][2]
             and all(abs(runs[1][0][k] - runs[0][0][k]) <= 1e-6
                     for k in ("mixed_eer", "clean_eer", "spoof_rate")),
             ("models reused", [r[0] for r in runs], sorted(runs[1][2])))
        gate(len(runs[0][2].get("EM iteration", [])) == 5, ("EM iterations", runs[0][2]))
        em_view(last_args["EM iteration"], gauss, ivec_dim, smi)
        t = time.perf_counter()
        ivector.IvectorExtractorFull.load(os.path.join(root, f"iv{gauss}", "extractor.npz"))
        log(f"[score] the native extractor's handle from the saved arrays (T {gauss} x 60 x "
            f"{ivec_dim}, f64, one host core; both runs build one): "
            f"{time.perf_counter() - t:.3f} s on [{smi}]")
        mixed = os.path.join(score_dir, "plda_scores_mixed.txt")
        with open(os.path.join(score_dir, "result.json")) as f:
            written = json.load(f)
        with quiet():
            again = cli_iv.main(["--recompute_eer", mixed])
        gate(again["eer"] == written["mixed_eer"], ("--recompute_eer", again, written))
        log(f"[score] --recompute_eer on plda_scores_mixed.txt: {json.dumps(again)} "
            f"(result.json mixed_eer {written['mixed_eer']}); Gaussians cut from "
            f"{cuts or 'none'}")
    finally:
        ivector._repair_nonfinite_rows = repair

    # -- the countermeasure ---------------------------------------------------
    spoof_root = os.path.join(root, "test", ctime, "spoof_data")
    train_flac = os.path.join(cfg.antispoof_dir, "ASVspoof2019_LA_train", "flac")
    os.makedirs(train_flac, exist_ok=True)
    proto = []
    for spk in sorted(os.listdir(spoof_root))[:6]:
        for f in sorted(os.listdir(os.path.join(spoof_root, spk))):
            name = f"LA_T_{len(proto) + 1:07d}"
            shutil.copyfile(os.path.join(spoof_root, spk, f), os.path.join(train_flac, name + ".wav"))
            proto.append(f"LA_0000 {name} - - spoof\n")
    with open(os.path.join(cfg.antispoof_dir, "ASVspoof2019_LA_cm_protocols",
                           "ASVspoof2019.LA.cm.train.trn.txt"), "w") as f:
        f.writelines(proto)
    with open(os.path.join(cfg.data_root_dir, "data_path", "ordinary", "wav.path.train")) as f:
        n_bona = sum(1 for ln in f if ln.strip())
    cap = str(n_bona * 2 // 3)
    step_ms = []
    make = antispoof.make_cm_train_step

    def timed_make(model, *a, **kw):
        step, score, opt = make(model, *a, **kw)

        def run(x, label):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(x, label)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            return out
        return run, score, opt

    cwd = os.getcwd()
    os.chdir(root)           # the CLI writes ./checkpoints and ./cm_scores
    antispoof.make_cm_train_step = timed_make
    try:
        base = ["-C", conf, "--bonafide_cap", cap]
        t = time.perf_counter()
        with quiet():
            model = cli_cm.main(["train", "-T", ctime, "--max_iterations", str(cm_steps),
                                 "--save_interval", str(cm_steps // 2)] + base, device=dev)
        train_s = time.perf_counter() - t
        gate(len(step_ms) == cm_steps and next(model.parameters()).device.type == "cuda"
             and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
             ("CM training", len(step_ms)))
        log(f"[score] CM train ({n_bona} bonafide list, cap {cap}; {len(proto)} toy train "
            f"spoofs; mel, disc_dim {cfg.disc_dim}, batch 64): {cm_steps} steps in "
            f"{train_s:.3f} s, step median {statistics.median(step_ms[1:]):.3f} ms (after the "
            f"first; host clock closed by synchronize), first {step_ms[0]:.3f} ms on [{smi}]")
        for extra in (["--variant", "v1"], ["--variant", "v2"], ["--feat", "lin"]):
            step_ms.clear()
            t = time.perf_counter()
            with quiet():
                m = cli_cm.main(["train", "-T", f"{ctime}_{extra[1]}", "--max_iterations", "1"]
                                + extra + base, device=dev)
            gate(len(step_ms) == 1 and all(bool(torch.isfinite(p).all())
                                           for p in m.parameters()), ("CM", extra))
            log(f"[score] CM {' '.join(extra)}: one step {step_ms[0]:.3f} ms, the run "
                f"{time.perf_counter() - t:.3f} s on [{smi}]")
    finally:
        antispoof.make_cm_train_step = make
        os.chdir(cwd)
    os.chdir(root)
    try:
        ck = os.path.join(root, "checkpoints", ctime, "final.npz")
        gate(os.path.exists(os.path.join(root, "checkpoints", ctime,
                                         f"{cm_steps // 2}_iteration.npz")), "CM save interval")
        with quiet():
            path, eer, thr = cli_cm.main(["dev", "-T", ctime, "-R", ck] + base, device=dev)
        with open(path) as f:
            rows = f.read().splitlines()
        n_dev = n_bona - int(cap) + len(os.listdir(os.path.join(cfg.antispoof_dir, ctime, "flac")))
        gate(len(rows) == n_dev and np.isfinite(eer) and 0 <= eer <= 1, ("CM dev", len(rows), eer))
        log(f"[score] CM dev on customized_data_{ctime}.txt: {len(rows)} scores "
            f"({n_bona - int(cap)} bonafide), CM EER {eer:.4f} at {thr:.4f}")
    finally:
        os.chdir(cwd)
    back = load_critic_params(ck, cli_cm.build_cm(cfg, None, "mel").to(dev))
    x = torch.rand(64, 80, cfg.mel.freq_bins, generator=torch.Generator().manual_seed(0)).to(dev)
    again_ck = os.path.join(root, "cm_again.npz")
    save_critic_params(again_ck, back)
    with np.load(ck) as a, np.load(again_ck) as b:
        same_file = a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    with torch.no_grad():
        gate(torch.equal(back(x), model(x)) and same_file, "CM checkpoint round trip")
    log("[score] CM checkpoint round trip: loaded scores bit-equal to the trained model's, "
        "re-saved arrays equal")

    # -- the curves -----------------------------------------------------------
    simmats = sorted(glob.glob(os.path.join(root, "simmat", "simmat_e*_b*.npy")))
    gate(len(simmats) > 0, "phase 11's similarity matrices")
    sim = np.load(simmats[0])
    n_spk, half = sim.shape[0], 40
    srs, frrs = curve.ge2e_curve(simmats[0], n_spk, 20)
    thr_g = (0.5 + 0.0001 * np.arange(5000)).astype(sim.dtype)   # numpy compares f32 to a float in f32
    diag = np.stack([sim[j, :, j] for j in range(n_spk)])
    want_sr = (diag[None, :, -half:] > thr_g[:, None, None]).sum((1, 2)) / half / n_spk
    want_frr = (half * n_spk - (diag[None, :, :half] > thr_g[:, None, None]).sum((1, 2))
                ) / half / n_spk
    gate(np.allclose(srs, want_sr, rtol=0, atol=1e-12)
         and np.allclose(frrs, want_frr, rtol=0, atol=1e-12), "GE2E curve")
    i_srs, i_frrs = curve.ivector_curve(mixed)
    trials = [t_ for t_ in ivector.read_score_file(mixed) if t_[0] == t_[1]]
    real = np.asarray([t_[3] for t_ in trials if t_[2] <= 23])
    fake = np.asarray([t_[3] for t_ in trials if t_[2] > 23])
    thr_i = -50 + 0.01 * np.arange(8000)
    gate(np.allclose(i_srs, (fake[None] > thr_i[:, None]).sum(1) / len(real), rtol=0, atol=1e-12)
         and np.allclose(i_frrs, 1 - (real[None] > thr_i[:, None]).sum(1) / len(real), rtol=0,
                         atol=1e-12), "i-vector curve")
    drawn = "matplotlib not installed: curves computed, no PNG drawn"
    if importlib.util.find_spec("matplotlib") is not None:
        png = os.path.join(root, "curve.png")
        with quiet():
            cli_curve.main(["--simmat", simmats[0], "--ivector_score", mixed, "--n_speakers",
                            str(n_spk), "--eval_num", "20", "--out", png])
        gate(os.path.getsize(png) > 0, "curve PNG")
        drawn = f"PNG drawn ({os.path.getsize(png)} bytes)"
    log(f"[score] curves: GE2E on {os.path.basename(simmats[0])} {sim.shape} (SR at 0.5: "
        f"{srs[0]:.4f}, gt FRR {frrs[0]:.4f}); i-vector on the mixed scores ({len(real)} real, "
        f"{len(fake)} spoof target trials); both equal to the numpy recomputation; {drawn}")

    launches = {k: c.launches for k, c in counters.items()}
    gate(all(v == 0 for v in launches.values()) and cluster.launches == 0,
         ("a hand-written kernel ran in the scoring phase", launches))
    return launches


def mesh_phase(cfg, dev, state_dicts, counters: dict, cluster, smi: str, spectral_err,
               texts, spk, iterations: int = 7) -> dict:
    """Phase 13: the mesh layer on the card. Two ranks share ``cuda:0`` over
    gloo (NCCL refuses two ranks on one device): (a) sharded synthesis at
    the main path's shape (bf16, B=64, N=100, T=325, GL12 from SPSI), each
    rank's rows bit-equal to a single-rank call on the same rows at the
    same batch, the gathered batch bit-equal to the single-rank B=64 call
    with cuDNN off on both sides (the cuDNN-on difference reported), K1-K3
    held against their plain versions at the shard's shapes; (b) sharded
    adversarial training (Text2Mel "fused_pair", f32, B=16 global, N=186,
    T=325, WGAN-GP, ``iterations`` iterations and a validation), plain and
    with ``use_masks``: the ranks' parameters bit-equal, the first G and D
    steps' all-reduced gradients within phase 10's gates (1e-2 whole, 5e-2
    a parameter) of the single-rank run's, K4-K6 held against their plain
    versions at the shard's shapes; (c) the spoof-set CLI and the serve CLI
    with ``--mesh 2 --mesh_share``: wavs and a burst of 8 replies against
    single-rank synthesis of the same rows at the same batch; (d) the NCCL
    path at world size 1: one synthesis call and one training step against
    the single-device ones. Returns the kernels' launches summed over the
    ranks of (a) and (b) and rank 0 of (c)'s spoof-set CLI."""
    import signal
    import threading
    import urllib.request

    import torch
    import torch.distributed as dist

    from spoofsv_torch import serve as tserve
    from spoofsv_torch.cli import generate_test_utterances as cli_gen
    from spoofsv_torch.cli.main import apply_runtime_knobs, inference_dtype
    from spoofsv_torch.data.text import encode_texts
    from spoofsv_torch.dsp import host as dsp_host
    from spoofsv_torch.infer import synthesize as syn_mod
    from spoofsv_torch.infer.synthesize import Synthesizer, finalize_audio
    from spoofsv_torch.models import LinDisc, MelDisc
    from spoofsv_torch.models.layers import gate_impl
    from spoofsv_torch.ops import gl_kernel
    from spoofsv_torch.parallel import mesh as mesh_lib
    from spoofsv_torch.parallel import multihost, ranks
    from spoofsv_torch.train import TrainState
    from spoofsv_torch.train.loop import CheckpointManager
    from spoofsv_torch.train.steps import shift_right

    share = {"devices": [str(dev)] * 2, "backend": "gloo", "timeout_s": 600}
    total = {}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    T, B = cfg.max_frame_num, len(texts)
    half = B // 2
    root = tempfile.mkdtemp(prefix="mesh_phase_")
    apply_runtime_knobs(cfg, infer=True)   # the synthesis impl the ranks and the CLIs run
    dt = inference_dtype(cfg, dev)          # bf16 on the card, as the CLIs load it
    dtype = {torch.bfloat16: "bfloat16", torch.float32: "float32"}[dt]
    mbf, sbf = ranks.build_generators(cfg, state_dicts, dev, dt)
    single = Synthesizer(cfg, mbf, sbf, n_frames=T)

    # ---- (a) sharded synthesis ---------------------------------------------
    part_t0 = time.perf_counter()
    part_s = {}
    gl_tc = syn_mod.griffin_lim_tc

    def reference(text, spk_rows, cudnn: bool = True):
        """The single-rank call on these rows: (audio, mel, attn) on the CPU
        and the magnitudes its vocoder took."""
        mags = []

        def recorded_gl(spec, *a, **kw):
            mags.append(spec)
            return gl_tc(spec, *a, **kw)

        syn_mod.griffin_lim_tc = recorded_gl
        try:
            with torch.backends.cudnn.flags(enabled=cudnn):
                out = [t.float().cpu() for t in single.call_local(text, spk_rows)]
        finally:
            syn_mod.griffin_lim_tc = gl_tc
        return out, mags[0]

    def held(got, want) -> dict:
        """audio, mel and attention max|d| (bit-equal: 0)."""
        return {k: float((g - w).abs().max())
                for k, g, w in zip(("audio", "mel", "attn"), got, want)}

    def gate_held(h: dict, what) -> None:
        gate(h["audio"] == 0.0 and h["mel"] == 0.0 and h["attn"] == 0.0, (what, h))

    t0 = time.perf_counter()
    res = multihost.spawn(2, ranks.synth_rank, cfg, state_dicts, texts, spk, None, n_frames=T,
                          dtype=dtype, reps=3, run_dir=os.path.join(root, "a"), **share)
    spawn_s = time.perf_counter() - t0
    for r in res:
        add(r["launches"])
    gate(all(torch.equal(res[0][k], res[1][k]) for k in ("audio", "mel", "attn")),
         "the ranks' gathered outputs differ")
    rows_held, syn_calls, gl_calls = [], [], []
    for r, out in enumerate(res):
        rows = slice(*out["rows"])
        gate((rows.start, rows.stop) == (r * half, (r + 1) * half), ("rows", r, out["rows"]))
        gate(all(torch.equal(out[k][rows], v) for k, v in zip(("mel", "attn"),
                                                               out["local"][1:])),
             ("a rank's gathered rows are not its own output", r))
        want, mag = reference(texts[rows], spk[rows])
        rows_held.append(held([out[k][rows] for k in ("audio", "mel", "attn")], want))
        syn_calls.append((single, texts[rows], spk[rows]))
        gl_calls.append((mag, cfg.tpu.griffin_lim_int8))
    hold_synthesis(syn_calls, gl_calls, dev, spectral_err, "mesh shard")
    mag = gl_calls[0][0]
    init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
    k3 = [gl_tc(mag, NFFT, HOP, n_iter=12, init_angles=init, int8=cfg.tpu.griffin_lim_int8)
          for _ in range(2)]
    k3_twice = float((k3[0] - k3[1]).abs().max())
    gate(k3_twice == 0.0, ("K3 twice on one shard's magnitudes", k3_twice))
    del syn_calls[:], gl_calls[:], k3
    want, _ = reference(texts, spk)
    on = held([res[0][k] for k in ("audio", "mel", "attn")], want)
    off = multihost.spawn(2, ranks.synth_rank, cfg, state_dicts, texts, spk, None, n_frames=T,
                          dtype=dtype, cudnn=False, run_dir=os.path.join(root, "a_off"),
                          **share)
    want, _ = reference(texts, spk, cudnn=False)
    off = held([off[0][k] for k in ("audio", "mel", "attn")], want)
    log(f"[mesh a] 2 gloo ranks on {dev}, {dtype} B={B} N={texts.shape[1]} T={T} GL12 spsi: "
        f"each rank's rows vs a single-rank call at B={half}: {rows_held}; the gathered batch vs "
        f"the single-rank B={B} call, cuDNN off: {off}; cuDNN on (reported, ROADMAP C.1): {on} "
        f"(gates: audio, mel and attention max|d| 0; K3 alone twice on one shard's magnitudes "
        f"max|d| {k3_twice:.4g}, gate 0); launches rank 0 {res[0]['launches']}, rank 1 "
        f"{res[1]['launches']}; spawn and first call {spawn_s:.1f} s")
    for r, h in enumerate(rows_held):
        gate_held(h, ("rank rows vs a single-rank call at B/2", r))
    gate_held(off, "gathered vs the single-rank B=64 call, cuDNN off")
    for r in res:
        gate(r["launches"]["decode"] == 1 and r["launches"]["griffin_lim"] == 1
             and r["launches"]["gl_init"] == 1 and r["launches"]["griffin_lim_f32"] == 0,
             ("a rank's synthesis launches", r["launches"]))
    synth_ms = [[round(v, 2) for v in r["local_ms"]] for r in res]
    gather_ms = [[round(v, 3) for v in r["gather_ms"]] for r in res]
    del res, want

    # ---- (b) sharded adversarial training ----------------------------------
    part_s["a"] = round(time.perf_counter() - part_t0, 1)
    N, Bt = 186, 16
    rng = np.random.default_rng(13)
    torch.manual_seed(5)
    disc_sd = {k: v.cpu() for k, v in MelDisc(cfg.disc_dim,
                                              freq_bins=cfg.mel.freq_bins).state_dict().items()}

    def batch(b: int, masks: bool) -> dict:
        out = {"mel": rng.uniform(0.05, 0.95, (b, T, cfg.mel.freq_bins)).astype(np.float32),
               "text": rng.integers(1, cfg.vocab_len - 1, (b, N)).astype(np.int32),
               "spk": rng.normal(size=(b, cfg.spk_emb_dim)).astype(np.float32)}
        if masks:
            fl, tl = rng.integers(T // 3, T + 1, b), rng.integers(N // 2, N + 1, b)
            out["mel_mask"] = (np.arange(T)[None] < fl[:, None]).astype(np.float32)
            tm = (np.arange(N)[None] < tl[:, None]).astype(np.float32)
            out["att_mask"] = tm[:, :, None] * out["mel_mask"][:, None, :]
        return out

    torch.manual_seed(6)
    lin_disc_sd = {k: v.cpu() for k, v in LinDisc(cfg.disc_dim,
                                                  lin_bins=cfg.lin_bins).state_dict().items()}

    def lin_batch(b: int) -> dict:
        return {"mel": rng.uniform(0.05, 0.95, (b, T, cfg.mel.freq_bins)).astype(np.float32),
                "lin": rng.uniform(0.05, 0.95, (b, 4 * T, cfg.lin_bins)).astype(np.float32)}

    # Text2Mel "fused_pair" (K5, and the f32 K1 in its validation), plain and
    # masked; SSRN "fused_conv" (K4), one G and two D steps
    # phase 10's gates hold the gradients of the first step taken from the
    # weights both runs were given: the generator's in the Text2Mel runs (G
    # first), the critic's in the SSRN run (D first); the other net's first
    # step follows a step that rounding already parted, so it is reported
    runs = [("train_text2mel", False, "fused_pair", iterations, 0),
            ("train_text2mel", True, "fused_pair", iterations, 0),
            ("train_ssrn", False, "fused_conv", 3, 1)]
    def grad_gap(g2: dict, g1: dict) -> tuple:
        """Relative gradient difference: all parameters as one vector, and
        the worst parameter."""
        gate(sorted(g2) == sorted(g1) and len(g1) > 0, "first-step gradients")
        num = sum(float((g2[k].double() - g1[k].double()).norm() ** 2) for k in g1)
        den = sum(float(g1[k].double().norm() ** 2) for k in g1)
        per = max(float((g2[k].double() - g1[k].double()).norm())
                  / max(float(g1[k].double().norm()), 1e-30) for k in g1)
        return num ** 0.5 / den ** 0.5, per

    step_ms, allreduce_ms = {}, {}
    for kind, masks, impl, iters, start in runs:
        name = f"{kind[6:]}{'/masks' if masks else ''}"
        if kind == "train_text2mel":
            batches, val = [batch(Bt, masks) for _ in range(2)], [batch(8, False)]
            args = (cfg, kind, state_dicts["text2mel"], disc_sd, batches, iters)
        else:
            batches, val = [lin_batch(Bt) for _ in range(2)], None
            args = (cfg, kind, state_dicts["ssrn"], lin_disc_sd, batches, iters)
        kw = dict(use_masks=masks, impl=impl, val_batches=val, start_step=start)
        held_net = "disc" if start else "gen"
        tag = name.replace("/", "_")
        t0 = time.perf_counter()
        two = multihost.spawn(2, ranks.train_rank, *args, run_dir=os.path.join(root, tag),
                              workdir=os.path.join(root, tag + "_run"), **kw, **share)
        spawn_s = time.perf_counter() - t0
        one = ranks.train_rank(mesh_lib.make_mesh(device=dev), *args,
                               workdir=os.path.join(root, tag + "_one"), **kw)
        for r in two:
            add(r["launches"])
        same = all(torch.equal(two[0][p][k], two[1][p][k])
                   for p in ("gen", "disc", "moments") for k in two[0][p])
        gate(same and two[0]["iteration"] == iters, ("ranks' states differ", name))
        worst = {net: grad_gap(two[0]["first_grads"][net], one["first_grads"][net])
                 for net in sorted(two[0]["first_grads"])}
        params = max(float((two[0][p][k].double() - one[p][k].double()).abs().max())
                     for p in ("gen", "disc") for k in one[p])
        log(f"[mesh b] {name} {impl} f32 B={Bt} (2 x {Bt // 2}) N={N} T={T} WGAN-GP, {iters} "
            f"iterations from step {start}: ranks bit-equal; each net's first-step gradients "
            f"vs the single-rank run, relative (whole, worst parameter): "
            f"{ {k: (f'{a:.3g}', f'{b:.3g}') for k, (a, b) in worst.items()} } (gates 1e-2, "
            f"5e-2 on the {held_net}'s, from the same weights; the other's reported); "
            f"parameters after the run max|d| {params:.3g} (reported); losses "
            f"{two[0]['loss_logs']}; validation {two[0]['val']} vs single {one['val']}; "
            f"launches rank 0 {two[0]['launches']}, rank 1 {two[1]['launches']}; two ranks' "
            f"run with their start {spawn_s:.1f} s")
        gate(worst[held_net][0] <= 1e-2 and worst[held_net][1] <= 5e-2,
             ("mesh gradients", name, held_net, worst))
        own = {"fused_pair": ("highway_conv_pair", "decode_f32"), "fused_conv": ("highway_conv",)}
        gate(all(two[0]["launches"][k] > 0 for k in own[impl]),
             ("sharded training did not run its kernels", name, two[0]["launches"]))
        step_ms[name] = [[round(v, 1) for v in r["step_ms"]] for r in two]
        step_ms[f"single {name}"] = [round(v, 1) for v in one["step_ms"]]
        allreduce_ms[name] = [round(r["allreduce_ms"], 3) for r in two]
        del two, one
    # K4-K6 at the shard's shapes: a rank's 8 rows through the generators' forwards
    m32, s32 = ranks.build_generators(cfg, state_dicts, dev, torch.float32)
    shard = {k: torch.from_numpy(v[:Bt // 2]).to(dev) for k, v in batch(Bt, False).items()}
    for impl, kernels in (("pallas", {"highway_gate"}), ("fused_pair", {"highway_conv_pair"}),
                          ("fused_conv", {"highway_conv"})):
        recorded = {}
        with gate_impl(impl), recording_highway(recorded), torch.no_grad():
            m32(shift_right(shard["mel"]), shard["text"], shard["spk"])
            if impl == "fused_conv":
                s32(shard["mel"])
        gate(kernels <= set(recorded), (impl, "kernels not recorded", sorted(recorded)))
        hold_highway(recorded, 1e-4, f"mesh shard {impl}", torch.float32)
    del m32, s32

    # ---- (c) the CLIs with --mesh 2 --mesh_share ---------------------------
    part_s["b"] = round(time.perf_counter() - part_t0 - sum(part_s.values()), 1)
    names = [f"p{225 + i}" for i in range(4)]
    emb_dir, data_dir = os.path.join(root, "spk_emb"), os.path.join(root, "data")
    os.makedirs(emb_dir)
    for i, name in enumerate(names):
        os.makedirs(os.path.join(data_dir, "wav22", name))
        np.save(os.path.join(emb_dir, name + ".npy"),
                np.random.default_rng(20 + i).normal(size=cfg.spk_emb_dim).astype(np.float32))
    with open(os.path.join(root, "havard.txt"), "w") as f:
        f.write("\n".join(SENTENCES) + "\n")
    # the CLIs run the configuration's own route (K1-K3); wavs held bit for bit
    ccfg = cfg.replace(src_root_dir=os.path.join(root, "cli") + "/", data_root_dir=data_dir,
                        spk_emb_dir=emb_dir, tts_texts=os.path.join(root, "havard.txt"))
    m32, s32 = ranks.build_generators(cfg, state_dicts, "cpu", torch.float32)
    ckpt = {}
    for kind, model in (("text2mel", m32), ("ssrn", s32)):
        mgr = CheckpointManager(ccfg, "conditional", False, "ck", f"train_{kind}")
        ckpt[kind] = mgr.save(TrainState(0, model, torch.optim.Adam(model.parameters())),
                              {"epoch": 0, "iteration": 1, "loss_val_log": []})
    ccfg = ccfg.replace(inference_text2mel_model=ckpt["text2mel"],
                        inference_ssrn_model=ckpt["ssrn"])
    conf = os.path.join(root, "config.json")
    with open(conf, "w") as f:
        json.dump(ccfg.to_reference_dict(), f)
    for c in [*counters.values(), cluster]:
        c.launches = 0
    t0 = time.perf_counter()
    cli_gen.main(["-C", conf, "-T", "mesh", "--eval_utt_num", "20", "--speaker_batch", "4",
                  "--skip_staging", "--mesh", "2", "--mesh_share"], device=str(dev))
    gen_s = time.perf_counter() - t0
    gen_launches = {k: c.launches for k, c in counters.items()}
    add(gen_launches)   # rank 0 of the CLI is this process; rank 1's are in its log only
    gate(gen_launches["decode"] > 0 and gen_launches["gl_init"] > 0
         and gen_launches["griffin_lim"] > 0, ("the spoof-set CLI's K1-K3 launches", gen_launches))
    ids = encode_texts(SENTENCES[:20], cfg.vocabulary)
    text = np.tile(ids, (4, 1))
    embs = np.repeat(np.stack([np.load(os.path.join(emb_dir, n + ".npy")) for n in names]), 20, 0)
    rows = len(text) // 2
    want = np.concatenate([single.call_local(text[r * rows:(r + 1) * rows],
                                             embs[r * rows:(r + 1) * rows])[0].float().cpu().numpy()
                           for r in range(2)])
    bad = []
    for i, name in enumerate(names):
        for k in range(20):
            rel = os.path.join(f"s{name[1:]}", f"s{name[1:]}_{k + 1:03d}.wav")
            got = dsp_host.load_wav(os.path.join(ccfg.src_root_dir, "test", "mesh", "spoof_data",
                                                 rel))[0]
            ref_path = os.path.join(root, "ref.wav")
            dsp_host.write_wav(ref_path, finalize_audio(want[i * 20 + k], cfg, trim_db=30.0,
                                                        max_seconds=9.0), cfg.sampling_rate)
            if not np.array_equal(got, dsp_host.load_wav(ref_path)[0]):
                bad.append(rel)
    log(f"[mesh c] generate_test_utterances --mesh 2 --mesh_share "
        f"(griffin_lim_impl {cfg.tpu.griffin_lim_impl}): 4 speakers x 20 sentences, "
        f"one call of {len(text)} rows ({rows} a rank) in {gen_s:.1f} s (two processes' start "
        f"included); wavs not bit-equal to single-rank synthesis of the same rows at B={rows}: "
        f"{len(bad)} of 80 {bad[:3]}; rank 0's launches {gen_launches}")
    gate(not bad, ("spoof-set CLI over 2 ranks vs single-rank rows", bad[:5]))

    # a served burst of 8 through the serve CLI, in its own process
    log_path = os.path.join(root, "serve.log")
    with open(log_path, "w") as out:
        server = subprocess.Popen(
            [sys.executable, "-m", "spoofsv_torch.cli.serve", "-C", conf, "--port", "0",
             "--mesh", "2", "--mesh_share", "--max_batch", "8", "--batch_wait_ms", "3000"],
            stdout=out, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        url = None
        deadline = time.time() + 300
        while url is None and time.time() < deadline and server.poll() is None:
            time.sleep(0.5)
            for ln in open(log_path).read().splitlines():
                if "[serve] listening on " in ln:
                    url = ln.split("listening on ")[1].split()[0]
        gate(url is not None, ("the mesh server did not start", open(log_path).read()[-3000:]))
        reqs = [{"text": SENTENCES[i], "speaker": names[i % 4]} for i in range(8)]
        replies = [None] * 8

        def post(i: int) -> None:
            r = urllib.request.Request(url + "/synthesize", data=json.dumps(reqs[i]).encode(),
                                       headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=300) as resp:
                replies[i] = (resp.status, resp.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        burst_s = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            stats = json.loads(resp.read())["stats"]
    finally:
        server.send_signal(signal.SIGINT)
        try:
            server.wait(120)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait(30)
    gate(all(r is not None and r[0] == 200 for r in replies), ("burst replies", replies))
    gate(server.returncode == 0, ("the mesh server's exit", server.returncode,
                                  open(log_path).read()[-3000:]))
    # all 8 ran as one batch (rung 8: 4 rows a rank); a row's output at a
    # fixed shape does not depend on its neighbours, so each reply is the
    # single-rank B=4 call's row of its own request
    ids = encode_texts([q["text"] for q in reqs], cfg.vocabulary, max_len=cfg.max_text_len)
    sp = np.stack([np.load(os.path.join(emb_dir, q["speaker"] + ".npy")) for q in reqs])
    ref = torch.cat([single.call_local(ids[g:g + 4], sp[g:g + 4])[0] for g in (0, 4)])
    pcm = tserve.pcm16(ref).cpu().numpy()
    mismatch = [i for i in range(8) if replies[i][1] != tserve.wav_bytes(
        finalize_audio(pcm[i].astype(np.float32) / 32767.0, cfg, trim_db=30.0),
        cfg.sampling_rate)]
    log(f"[mesh c] serve --mesh 2 --mesh_share: a burst of 8 in {burst_s:.2f} s, stats "
        f"{ {k: stats[k] for k in ('n_batches', 'max_batch_seen', 'n_requests')} }; replies "
        f"200; wav bytes unlike single-rank B=4 synthesis of the same rows: {mismatch}")
    gate(stats["n_batches"] == 1 and stats["max_batch_seen"] == 8, ("one batch of 8", stats))
    gate(not mismatch, ("served replies vs single-rank rows", mismatch))

    # ---- (d) the NCCL path at world size 1 --------------------------------
    part_s["c"] = round(time.perf_counter() - part_t0 - sum(part_s.values()), 1)
    port, lock = multihost.reserve_port()
    try:
        multihost.initialize_distributed(f"tcp://localhost:{port}", 1, 0, "nccl", dev)
    finally:
        lock.close()
    try:
        mesh = mesh_lib.make_mesh(1, dev)
        gate(mesh.backend == "nccl" and mesh.grouped, ("an NCCL group of one", mesh))
        got = Synthesizer(cfg, mbf, sbf, n_frames=T, mesh=mesh)(texts, spk)
        want = single(texts, spk)
        syn_ok = all(torch.equal(g, w) for g, w in zip(got, want))
        b1 = [batch(Bt, False)]
        args = (cfg, "train_text2mel", state_dicts["text2mel"], disc_sd, b1, 1)
        nccl = ranks.train_rank(mesh, *args, impl="fused_pair",
                                workdir=os.path.join(root, "d_nccl"))
        ref1 = ranks.train_rank(mesh_lib.make_mesh(device=dev), *args, impl="fused_pair",
                                workdir=os.path.join(root, "d_one"))
        # a step's backward is not bit-reproducible (atomic accumulations in
        # cuDNN's and the embedding's gradients), so the step is held as (b)'s
        gap = grad_gap(nccl["first_grads"]["gen"], ref1["first_grads"]["gen"])
        log(f"[mesh d] NCCL world size 1 on {dev}: synthesis B={B} "
            f"bit-equal to the single-device call: {syn_ok}; one G step's gradients vs the "
            f"single-device step, relative (whole, worst parameter): ({gap[0]:.3g}, "
            f"{gap[1]:.3g}) (gates 1e-2, 5e-2); step ms {[round(v, 1) for v in nccl['step_ms']]}, "
            f"gradient all-reduce {nccl['allreduce_ms']:.3f} ms")
        gate(syn_ok and gap[0] <= 1e-2 and gap[1] <= 5e-2,
             ("the NCCL path at world size 1", syn_ok, gap))
    finally:
        dist.destroy_process_group()
    part_s["d"] = round(time.perf_counter() - part_t0 - sum(part_s.values()), 1)
    log(f"[time] phase 13 parts (s) {part_s}")
    log(f"[mesh] two ranks time-sharing one card: overhead, not scaling. Per rank "
        f"synthesis ms (B={half}, 3 calls) {synth_ms}; audio all-gather ms (host staged) "
        f"{gather_ms}; training step ms (ranks) and single-rank {step_ms}; one gradient "
        f"all-reduce ms {allreduce_ms} on [{smi}]")
    shutil.rmtree(root, ignore_errors=True)
    return total


# the campaign at reduced depth and full width (phase 14): Config()'s widths
# (hidden 256), GE2E 3x768 -> 256 at N=6 x M=50, the i-vectors at 256 / 100
# and the reference's 1024 / 400, the CM at its defaults; cut (the JAX
# script's defaults in brackets): 10 speakers x 10 utterances (60 x 110),
# 6 train speakers (40), 4 evaluation sentences (20), Text2Mel and SSRN 200
# steps (40000 / 30000), adversarial 100 (20000), validation every 100
# (2000), GE2E 40 epochs (600), the CM 200 steps (4000) on the first 30 of
# the TTS train list (3500; the rest, 10, are its dev set's bona fide). The
# i-vector stages at 256 Gaussians train and
# score on one host core (the native backend below 512, as in the JAX
# package): their time grows with the utterances, which is what the depth
# is cut for.
CAMPAIGN_DEPTH = ["--speakers", "10", "--utts", "10", "--train_spk", "6", "--enroll", "3",
                  "--eval_num", "4", "--t2m_steps", "200", "--ssrn_steps", "200",
                  "--adv_steps", "100", "--val_every_iter", "100", "--ge2e_epochs", "40",
                  "--cm_steps", "200", "--cm_cap", "30"]
CAMPAIGN_SPLIT = ["--split_suffix", "_s7", "--train_spk", "7"]
# the toy learning run in a process of its own beside the campaign (both
# hold the host far more than the card): its summary and its launches
TOY_RUN = r"""
import json, sys
from spoofsv_torch.cli import train_toy_e2e
from spoofsv_torch.ops import decode_kernel, gate_kernel, gl_kernel, hconv_kernel
summary = train_toy_e2e.main([sys.argv[1]], device=sys.argv[2])
launches = {"gl_init": gl_kernel.init_kernel, "griffin_lim": gl_kernel.gl_tc_kernel,
            "griffin_lim_f32": gl_kernel.gl_kernel, "highway_gate": gate_kernel.gate_kernel,
            "highway_conv": hconv_kernel.hconv_kernel,
            "highway_conv_pair": hconv_kernel.hconv_pair_kernel,
            "decode_f32": decode_kernel.f32_kernel, "decode_bf16": decode_kernel.cluster_kernel}
print("TOY " + json.dumps({"summary": summary,
                           "launches": {k: c.launches for k, c in launches.items()}}))
"""
# the kernels each stage launches (every other count must be 0), by counter
SYNTH_KERNELS = {"decode_bf16", "gl_init", "griffin_lim"}
CAMPAIGN_KERNELS = {"corpus": {"gl_init", "griffin_lim_f32"}, "train_t2m": {"decode_f32"},
                    "train_adv": {"decode_f32"}, "synthesize": SYNTH_KERNELS,
                    "spoofgen": SYNTH_KERNELS, "spoofgen_adv": SYNTH_KERNELS}


def campaign_phase(dev, counters: dict, cluster, smi: str, onsets, before_onset, spectral_err,
                   cuda_ms, root: str, depth=CAMPAIGN_DEPTH, toy_steps: int = 2500) -> dict:
    """Phase 14: the campaign (:func:`campaign_runs`) with the toy learning
    run, ``python -m spoofsv_torch.cli.train_toy_e2e <toy_steps>`` on the
    card, in a process of its own beside it (both hold the host far more
    than the card), its launches counted there from 0: ``loss_last <= 0.75
    loss_first``, ``forward_frac >= 0.95``, the f32 K1 launched and nothing
    else. The process is stopped if the phase fails. Returns the campaign's
    launches, the toy run's and the corpus GL's readings."""
    toy_path = os.path.join(root, "toy_e2e.log")
    toy_log = open(toy_path, "w")
    toy_t0 = time.perf_counter()
    toy_proc = subprocess.Popen([sys.executable, "-c", TOY_RUN, str(toy_steps), str(dev)],
                                stdout=toy_log, stderr=subprocess.STDOUT,
                                cwd=str(Path(__file__).resolve().parent),
                                env={**os.environ, "TMPDIR": root})
    try:
        out = campaign_runs(dev, counters, cluster, smi, onsets, before_onset, spectral_err,
                            cuda_ms, root, depth)
        toy_wait = time.perf_counter()
        rc = toy_proc.wait(timeout=900)
    finally:
        if toy_proc.poll() is None:
            toy_proc.kill()
            toy_proc.wait()
        toy_log.close()
    toy_s, waited = time.perf_counter() - toy_t0, time.perf_counter() - toy_wait
    with open(toy_path) as f:
        lines = f.read().splitlines()
    for ln in lines:
        if ln.startswith("[toy-e2e] iter"):
            log(ln)
    found = [json.loads(ln[4:]) for ln in lines if ln.startswith("TOY ")]
    gate(rc == 0 and len(found) == 1, ("the toy run failed", rc, lines[-20:]))
    summary, toy = found[0]["summary"], found[0]["launches"]
    log(f"[toy] train_toy_e2e {toy_steps} steps (hidden 64, 4 speakers x 40, f32, its own "
        f"process beside the campaign): {json.dumps(summary)}; {toy_s:.1f} s, {waited:.1f} s "
        f"of it after the campaign; launches {toy} on [{smi}]")
    gate(summary["loss_last"] <= 0.75 * summary["loss_first"]
         and summary["forward_frac"] >= 0.95, ("the toy run did not learn", summary))
    gate(toy["decode_f32"] > 0 and all(v == 0 for k, v in toy.items() if k != "decode_f32"),
         ("toy launches", toy))
    return {**out, "toy": toy}


def campaign_runs(dev, counters: dict, cluster, smi: str, onsets, before_onset, spectral_err,
                  cuda_ms, root: str, depth=CAMPAIGN_DEPTH) -> dict:
    """Phase 14's campaign: the paper's whole experiment from one entry point,
    ``spoofsv_torch.cli.campaign.main(argv)``, at reduced depth and full
    width (``CAMPAIGN_DEPTH``), every stage on the card: the corpus and its
    fake LA sides (the copy-synthesis through K2's random mode and the f32
    ``csrc/gl.cu``), the feature cache, Text2Mel, SSRN and WGAN-GP training
    (validations through the f32 K1), ``synthesize`` and the two spoof sets
    (K1 bf16, K2 SPSI, K3 int8), GE2E, the i-vectors (and the 1024 / 400
    reference run), the CM, the curves (their points files), the report;
    then the split variant ``CAMPAIGN_SPLIT`` and a resumed call that runs
    nothing. Each stage's launches are counted from 0 just before it and
    read just after, and held to ``CAMPAIGN_KERNELS``. On the trained
    weights, outside the counted runs: the f32 K1 on the last validation's
    own batches against ``decode_plain`` (1e-3 before each row's first
    attention argmax flip, onsets >= 32), the bf16 K1 on the first
    ``synthesize`` batch against ``decode_plain`` over frames 0-1 (mel 0.05,
    attention 0.02) and the first frame where the argmax parts over the
    whole rollout, K2 and K3 on that batch and on the first spoof-set call
    (``hold_synthesis``), ``gl.cu`` against ``torchdsp.griffin_lim`` from
    the same init on the corpus batch (relative L2 1e-3), timed at that
    shape against its bound. Returns the launches summed over the
    campaign's stages and the corpus GL's readings."""
    import torch

    from spoofsv_torch.cli import campaign
    from spoofsv_torch.dsp import torchdsp
    from spoofsv_torch.ops import decode_kernel, gl_kernel

    def snap() -> dict:
        n = {k: c.launches for k, c in counters.items() if k != "decode"}
        n["decode_bf16"] = cluster.launches
        return n

    def reset() -> None:
        for c in [*counters.values(), cluster]:
            c.launches = 0

    runs, corpus_gl = [], []
    current = {"stage": None}
    rec = SynthesisRecorder(lambda: dict(stage=current["stage"]))
    run_stage, gl_fused = campaign.Campaign.run_stage, gl_kernel.griffin_lim_fused

    def counted_stage(self, name, fn):
        """A stage's launches, seconds and recorded synthesis calls, counted
        from 0 around it."""
        mname = os.path.basename(self.marker(name))[:-5]
        current["stage"] = mname
        calls = (len(rec.syn_calls), len(rec.gl_calls))
        reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_stage(self, name, fn)
        torch.cuda.synchronize()
        runs[-1][mname] = row = dict(s=time.perf_counter() - t, launches=snap(),
                                     syn=rec.syn_calls[calls[0]:], gl=rec.gl_calls[calls[1]:])
        print(f"[phase 14] stage {mname}: {row['s']:.2f} s, launches {row['launches']}",
              flush=True)
        return out

    def recorded_fused(mag, *a, **kw):
        corpus_gl.append((mag, kw["init_angles"], kw["n_iter"]))
        return gl_fused(mag, *a, **kw)

    stdout = open(os.path.join(root, "campaign.log"), "w")

    def drive(argv) -> tuple:
        """``campaign.main(argv)`` on the card; its stdout, its results, its
        seconds (each stage's seconds and launches go to ``runs``)."""
        runs.append({})
        tee = campaign._Tee(stdout)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            results = campaign.main(argv, device=dev)
        torch.cuda.synchronize()
        return tee.buf.getvalue(), results, time.perf_counter() - t

    base = [*depth, "--root", os.path.join(root, "campaign")]
    campaign.Campaign.run_stage = counted_stage
    gl_kernel.griffin_lim_fused = recorded_fused
    rec.install()
    try:
        log_base, results, wall_base = drive(base)
        log_split, split, wall_split = drive([*base, *CAMPAIGN_SPLIT])
        log_again, again, wall_again = drive(base)
    except BaseException:
        stdout.flush()
        with open(stdout.name) as f:
            log("[campaign] the run failed; its output's last lines:\n"
                + "".join(f.readlines()[-40:]))
        raise
    finally:
        campaign.Campaign.run_stage = run_stage
        gl_kernel.griffin_lim_fused = gl_fused
        rec.restore()
        stdout.close()

    # -- the runs: every stage, its launches, its results ------------------
    args = campaign.build_parser().parse_args(base)
    split_args = campaign.build_parser().parse_args([*base, *CAMPAIGN_SPLIT])
    croot = args.root
    log(f"[campaign] depth {' '.join(depth)}: base run {wall_base:.1f} s, split "
        f"{' '.join(CAMPAIGN_SPLIT)} {wall_split:.1f} s, resumed call {wall_again:.1f} s on "
        f"[{smi}]")
    # the base run's stages, then the split's (ivector_ref, not split, is the base's)
    counted = {**runs[0], **{m: r for m, r in runs[1].items() if m not in runs[0]}}
    for mname, row in counted.items():
        log(f"[campaign] stage {mname}: {row['s']:.2f} s, launches {row['launches']}")
    names = [*campaign.REPORT_STAGES, "report"]
    attack = [*campaign.ATTACK_STAGES, "report"]
    sfx = split_args.split_suffix
    split_names = [s + sfx if s in campaign.SPLIT_STAGES else s for s in attack]
    gate(list(runs[0]) == names and list(runs[1]) == split_names,
         ("stages", list(runs[0]), list(runs[1])))
    gate(runs[1]["ivector_ref"]["s"] < 1.0, ("the split run re-ran ivector_ref", runs[1]))
    for mname in names + split_names:
        gate(os.path.exists(os.path.join(croot, "state", f"{mname}.json")), ("marker", mname))
    gate(all(results[n] for n in names) and all(split[n] for n in attack),
         ("an empty stage result", results, split))
    for name, want in (("RESULTS.json", names[:-1]), (f"RESULTS{sfx}.json", names[:-1])):
        with open(os.path.join(croot, name)) as f:
            got = list(json.load(f))
        gate(got == want, (name, got))
    for res, tag, a in ((results, "", args), (split, sfx, split_args)):
        for chain in ("", "_adv"):
            g, iv, cm = (res[s + chain] for s in ("ge2e", "ivector", "cm"))
            vals = {"ge2e EER": g["EER"], "ge2e spoof rate": g["spoof_rate"],
                    "ge2e spoof rate at EER": g["spoof_rate_at_eer"], "ge2e gt FRR": g["gt_FRR"],
                    "ivector mixed EER": iv["mixed_eer"], "ivector clean EER": iv["clean_eer"],
                    "ivector spoof rate": iv["spoof_rate"], "CM EER": cm["cm_eer"]}
            if not chain:
                r = res["ivector_ref"]
                vals.update({"ivector_ref mixed EER": r["mixed_eer"],
                             "ivector_ref spoof rate": r["spoof_rate"]})
            with open(res["curve" + chain]["points"]) as f:
                points = json.load(f)
            lens = {k: (len(v["spoof_rate"]), len(v["frr"])) for k, v in points.items()}
            rates = [x for v in points.values() for x in (*v["spoof_rate"], *v["frr"])]
            log(f"[campaign] results{tag}{chain}: "
                f"{ {k: round(float(v), 4) for k, v in vals.items()} }; CM bona fide "
                f"{cm['n_bonafide']}, spoof {cm['n_spoof']}; spoof wavs "
                f"{res['spoofgen' + chain]['spoof_wavs']}; curve points {lens}")
            gate(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals.values()),
                 ("EER / spoof rate", tag, chain, vals))
            gate(cm["n_bonafide"] > 0 and cm["n_spoof"] > 0, ("CM trials", cm))
            gate(res["spoofgen" + chain]["spoof_wavs"] == a.speakers * a.eval_num,
                 ("spoof wavs (every speaker x eval_num)", res["spoofgen" + chain]))
            gate(lens == {"ge2e": (5000, 5000), "ivector": (8000, 8000)}
                 and all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in rates),
                 ("curve points", tag, chain, lens))
    syn = results["synthesize"]
    log(f"[campaign] synthesize: {syn}; training {[results[s] for s in names[2:5]]}")
    gate(syn["n_batches"] > 0 and all(np.isfinite(syn[k]) for k in ("text2mel_loss",
                                                                     "ssrn_loss", "mcd_db")),
         ("synthesize", syn))
    for mname, row in counted.items():
        want = CAMPAIGN_KERNELS.get(mname[:-len(sfx)] if mname.endswith(sfx) else mname, set())
        n = row["launches"]
        gate(all(n[k] > 0 for k in want) and all(v == 0 for k, v in n.items() if k not in want),
             ("stage launches", mname, n, sorted(want)))
    lines = [ln for ln in log_again.splitlines() if ln.startswith("[campaign] ")]
    gate(len(lines) == len(names) and all(ln.endswith(": already done") for ln in lines)
         and again == json.loads(json.dumps(results, default=float))
         and all(sum(r["launches"].values()) == 0 for r in runs[2].values()),
         ("the resumed call ran a stage", lines, runs[2]))
    log(f"[campaign] resumed call: {len(lines)} stages already done, no launch, results equal")

    # -- the kernels on the trained weights --------------------------------
    # the f32 K1 on the last validation's own batches (every validation
    # decodes the same batches; the model holds train_t2m's final weights)
    val = [c for c in rec.val_calls if c["stage"] == "train_t2m"]
    rounds = args.t2m_steps // args.val_every_iter
    gate(len(val) > 0 and len(val) % rounds == 0, ("train_t2m validation decodes", len(val)))
    calls = val[-(len(val) // rounds):]
    m32 = calls[0]["model"].eval()
    F = m32.freq_bins
    packed32 = decode_kernel.pack_decode_weights(m32)
    for c in calls:
        text, spk = c["text"], c["spk"]
        with torch.no_grad():
            kv = (*m32.encode_text(text), m32.audio_encoder.fc1(spk), m32.audio_encoder.fc2(spk))
        yk, ak, _ = rec.make_fused(m32, c["T"])(text, spk)
        yp, ap, _ = decode_kernel.decode_plain(packed32, *kv, n_frames=c["T"], freq_bins=F)
        ons = onsets(ak, ap)
        mel, att = before_onset(yk, ak, yp, ap, ons)
        log(f"[campaign K1 f32] trained Text2Mel ({args.t2m_steps} steps), last validation "
            f"batch B={text.shape[0]} N={text.shape[1]} T={c['T']} vs decode_plain: onsets "
            f"{ons}; before onset mel max|d| {mel:.3g}, attention {att:.3g} (gates 1e-3, "
            f"onset >= 32)")
        gate(min(ons) >= min(32, c["T"]) and mel <= 1e-3 and att <= 1e-3,
             ("trained K1 f32", text.shape, c["T"], ons, mel, att))
    del m32, packed32, kv, yk, ak, yp, ap, calls, val
    rec.val_calls.clear()

    # the bf16 K1 on the first synthesize batch: frames 0-1 (hold_synthesis
    # also holds K2 and K3 there), then where the attention argmax parts
    def first(stage):
        s, g = counted[stage]["syn"], counted[stage]["gl"]
        gate(len(s) > 0 and len(s) == len(g), ("recorded calls", stage, len(s), len(g)))
        return s[:1], g[:1]

    s1, g1 = first("synthesize")
    hold_synthesis(s1, g1, dev, spectral_err, "campaign synthesize, trained")
    synth, text_ids, spk_emb = s1[0]
    mbf = synth.melsyn
    with torch.no_grad():
        K, V = mbf.encode_text(torch.as_tensor(text_ids).to(dev))
        sb = torch.as_tensor(spk_emb, dtype=torch.float32).to(dev, K.dtype)
        s_1, s_2 = mbf.audio_encoder.fc1(sb), mbf.audio_encoder.fc2(sb)
    packed = decode_kernel.pack_decode_weights(mbf)
    T = synth.n_frames
    y, a, _ = decode_kernel.decode_fused(packed, K, V, s_1, s_2, n_frames=T, freq_bins=F)
    yq, aq, _ = decode_kernel.decode_plain(packed, K, V, s_1, s_2, n_frames=T, freq_bins=F)
    ons = onsets(a, aq)
    part = min(ons)
    log(f"[campaign K1 bf16] trained weights, first synthesize batch B={K.shape[0]} "
        f"N={K.shape[1]} T={T}: first frame where the attention argmax parts from "
        f"decode_plain: {part if part < T else 'none'} (per row {ons}); mel max|d| over all "
        f"frames {float((y.float() - yq.float()).abs().max()):.3g} (context)")
    del y, a, yq, aq, K, V, s_1, s_2, packed, mbf, synth
    s1, g1 = first("spoofgen")
    hold_synthesis(s1, g1, dev, spectral_err, "campaign spoofgen, trained")
    for row in counted.values():
        del row["syn"], row["gl"]
    del s1, g1
    rec.syn_calls.clear()
    rec.gl_calls.clear()

    # gl.cu on the corpus batch against plain f32 GL from the same init
    gate(len(corpus_gl) == 1, ("corpus GL calls", len(corpus_gl)))
    mag, init, n_iter = corpus_gl.pop()
    got = gl_fused(mag, NFFT, HOP, n_iter=n_iter, init_angles=init)
    ref = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=n_iter, init_angles=init)
    sc_k, sc_p = spectral_err(got, mag), spectral_err(ref, mag)
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    Bm, Tm, Fm = mag.shape
    ms = cuda_ms(lambda: gl_fused(mag, NFFT, HOP, n_iter=n_iter, init_angles=init), reps=2)
    plain = cuda_ms(lambda: torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=n_iter,
                                                 init_angles=init), reps=1)
    gl_flop = n_iter * Bm * Tm * (2 * 2.5 * NFFT * np.log2(NFFT) + 10 * Fm)
    gl_bytes = 4.0 * (3 * mag.numel() + Bm * HOP * (Tm - 1))
    b_ms, b_by = bound_ms(gl_flop, gl_bytes, 67e12)
    log(f"[campaign gl.cu] corpus copy-synthesis B={Bm} T={Tm} GL{n_iter} from K2's random "
        f"init: rel-L2 kernel vs plain {rel:.3g} (gate 1e-3, tests/test_torch_port_gl.py's "
        f"bound); spectral conv kernel {sc_k:.5f}, plain f32 GL {sc_p:.5f} (context); kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{gl_flop / 1e9:.1f} GFLOP, {gl_bytes / 1e9:.3f} GB) on [{smi}]")
    gate(rel <= 1e-3, ("corpus gl.cu vs plain GL from the same init", rel, sc_k, sc_p))
    gate(ms >= b_ms, ("corpus gl.cu under its bound", ms, b_ms))
    del mag, init, got, ref
    corpus = dict(shape=[Bm, Tm, Fm], n_iter=n_iter, ms=ms, plain_ms=plain, bound_ms=b_ms,
                  bound_by=b_by, spectral_conv=sc_k, plain_spectral_conv=sc_p, rel_l2=rel)

    total = {k: sum(row["launches"][k] for row in counted.values()) for k in snap()}
    log(f"[campaign] phase 14 stage seconds "
        f"{ {m: round(r['s'], 2) for m, r in counted.items()} }")
    return {"campaign": total, "corpus_gl": corpus}


def griffin_lim_f64(mag, init, n_iter: int, momentum: float = 0.99):
    """``torchdsp.griffin_lim`` in float64 (window, FFTs, overlap-add and its
    normalisation): the witness of exact arithmetic that ``gl.cu`` and plain
    f32 GL are both held against where momentum grows their rounding."""
    import torch
    import torch.nn.functional as F

    from spoofsv_torch.dsp import torchdsp
    from spoofsv_torch.dsp.primitives import hann_window, pad_center, window_sumsquare

    f64 = dict(device=mag.device, dtype=torch.float64)
    win = torch.as_tensor(pad_center(hann_window(NFFT), NFFT), **f64)
    wss = torch.as_tensor(window_sumsquare(hann_window(NFFT), mag.shape[-2], HOP, NFFT), **f64)
    real_bins = torch.ones(mag.shape[-1], **f64)
    real_bins[[0, -1]] = 0.0

    def istft(spec):
        frames = torch.fft.irfft(torch.complex(spec.real, spec.imag * real_bins), n=NFFT, dim=-1)
        y = torchdsp.overlap_add(frames * win, HOP)
        y = torch.where(wss > torchdsp.WSS_FLOOR, y / wss.clamp_min(torchdsp.WSS_FLOOR), y)
        return y[..., NFFT // 2: y.shape[-1] - NFFT // 2]

    def stft(y):
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (NFFT // 2, NFFT // 2),
                  mode="reflect").reshape(*lead, -1)
        return torch.fft.rfft(torchdsp.frame_signal(y, NFFT, HOP) * win, dim=-1)

    mag = mag.to(torch.float64)
    ang = torch.complex(init[0].to(torch.float64), init[1].to(torch.float64)).expand(mag.shape)
    reb = torch.zeros_like(ang)
    alpha = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        r = stft(istft(mag * ang))
        acc = r - alpha * reb
        ang, reb = acc / (acc.abs() + 1e-16), r
    return istft(mag * ang)


# phase 15: the post-campaign checks on phase 14's tree, each counted from 0
GL_KERNELS = {"decode_bf16", "gl_init", "griffin_lim", "griffin_lim_f32"}
CHECK_KERNELS = {"gl_init_check": GL_KERNELS, "gl_mcd_ab": GL_KERNELS,
                 "exp_gl_init": {"gl_init", "griffin_lim_f32"}, "spec_rate_diag": SYNTH_KERNELS,
                 "gl24_check": SYNTH_KERNELS, "gl_spsi_check spsi@16": SYNTH_KERNELS,
                 "ivector_delta_rescore": set(), "vad_ab": set()}
# the keys of the JAX scripts' outputs (scripts/spec_rate_diag.py:120-141, vad_ab.py:114-125)
SPEC_DETAIL = ["n_pairs", "n_never_completed_at_160", "fpc_p10", "fpc_p50", "fpc_p90", "fpc_max",
               "implied_escalation_rate_armC", "never_completed_rate_by_margin",
               "per_speaker_mean_fpc_min", "per_speaker_mean_fpc_max", "spec_margin", "n_frames",
               "backend"]
# gl.cu's GL64 on TTS magnitudes against plain f32 GL and float64 GL, in units
# of plain f32 GL's own distance from float64 GL (checks_phase)
GL64_SPREAD = 3.0
VAD_KEYS = ["n_utts", "corpus", "clean", "noisy_5db_snr", "gapped_quiet_floor",
            "gapped_loud_floor", "scope_note", "embedding_leg"]


def checks_phase(dev, counters: dict, cluster, smi: str, spectral_err, cuda_ms, root: str,
                 depth=CAMPAIGN_DEPTH, batch: int = 16) -> dict:
    """Phase 15: the post-campaign checks (``spoofsv_torch/cli/``'s ports of
    ``scripts/``) on phase 14's tree ``<root>/campaign``, each through its
    ``main(argv, device)`` (``gl_spsi_check`` through ``score_candidate`` for
    spsi@16: spsi@12 is the base campaign's own configuration), its launches
    counted from 0 just before it and read just after and held to
    ``CHECK_KERNELS``. Outside the counted runs, on each check's own inputs:
    K1 bf16 against ``decode_plain`` over frames 0-1 (gl_init_check's three
    sentence sets, the first ``Synthesizer`` call of gl_mcd_ab,
    spec_rate_diag and each spoof set), K2 (SPSI, advance, the hash init) and
    K3 int8 and bf16 (one iteration at momentum 0) against their plain
    versions on the trained magnitudes, ``gl.cu`` from the random init
    against plain f32 GL from the same angles (one iteration within 1e-5
    relative L2; GL64 within ``GL64_SPREAD`` times plain f32 GL's distance
    from float64 GL, 1e-3 at least, of both, and its spectral convergence
    within 1e-4), K2 at lock
    0 and −1 and ``gl.cu`` at 0 iterations on exp_gl_init's inputs; from the
    results: the tensor-core GL12/GL16 within 0.02 of the f32 combo's
    spectral convergence, copy-synthesis spsi@12 at most 0.5 dB above
    random@64, EERs and spoof rates in [0, 1], spoof sets as large as the
    base's, the JAX scripts' keys. ``batch``: gl_init_check's B. Returns the
    launches summed over the checks, each check's seconds and the lock /
    n_iter 0 readings."""
    import tempfile as tmp_mod

    import torch

    from spoofsv_torch.cli import (checklib, exp_gl_init, gl24_check, gl_init_check, gl_mcd_ab,
                                   gl_spsi_check, ivector_delta_rescore, spec_rate_diag, vad_ab)
    from spoofsv_torch.dsp import torchdsp
    from spoofsv_torch.ops import decode_kernel, gl_kernel

    croot = os.path.join(root, "campaign")
    flags = [*depth, "--root", croot]

    def snap() -> dict:
        n = {k: c.launches for k, c in counters.items() if k != "decode"}
        n["decode_bf16"] = cluster.launches
        return n

    runs = {}
    rec = SynthesisRecorder()
    decodes, gl64 = [], []
    make_fused, gl_fused = decode_kernel.make_fused_decoder, gl_kernel.griffin_lim_fused

    def recorded_decoder(model, n_frames, *a, **kw):
        decode = make_fused(model, n_frames, *a, **kw)

        def run(text_ids, spk_emb, *x):
            decodes.append((model, n_frames, text_ids, spk_emb))
            return decode(text_ids, spk_emb, *x)
        return run

    def recorded_fused(mag, *a, **kw):
        if kw.get("n_iter") == 64 and not gl64:
            gl64.append((mag, kw["init_angles"]))
        return gl_fused(mag, *a, **kw)

    def counted(name: str, fn):
        """``fn()`` with the launches counted from 0 around it (its output
        kept back, shown on failure); its result, and the Synthesizer calls
        and vocoder inputs it recorded."""
        calls = (len(rec.syn_calls), len(rec.gl_calls))
        for c in [*counters.values(), cluster]:
            c.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                out = fn()
        except BaseException:
            log(f"[phase 15] {name} failed; its output's last lines:\n"
                + "\n".join(buf.getvalue().splitlines()[-40:]))
            raise
        torch.cuda.synchronize()
        runs[name] = dict(s=time.perf_counter() - t, launches=snap())
        log(f"[phase 15] {name}: {runs[name]['s']:.2f} s, launches {runs[name]['launches']}")
        return out, rec.syn_calls[calls[0]:], rec.gl_calls[calls[1]:]

    def in01(vals: dict, what: str) -> None:
        gate(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals.values()), (what, vals))

    decode_kernel.make_fused_decoder = recorded_decoder
    gl_kernel.griffin_lim_fused = recorded_fused
    rec.install()
    try:
        # -- gl_init_check at B=16 on the trained magnitudes -----------------
        art, _, _ = counted("gl_init_check",
                            lambda: gl_init_check.main([str(batch), "--root", croot], device=dev))
        decode_kernel.make_fused_decoder = make_fused
        gl_kernel.griffin_lim_fused = gl_fused
        dists = list(art["combos"]["spsi@12"])
        log(f"[gl_init_check] B={batch} spectral convergence by combo {json.dumps(art['combos'])}; "
            f"tensor-core candidates {json.dumps(art['fused_candidate'])} on [{smi}]")
        gate(len(decodes) == 3 and len(dists) == 3, ("gl_init_check decodes", len(decodes), dists))
        for (m, T, text, spk), d in zip(decodes, dists):
            hold_k1(m, text, spk, T, dev, f"gl_init_check {d}")
        for iters in (12, 16):
            for tag in ("int8", "bf16"):
                for d in dists:
                    sc_k = art["fused_candidate"][f"spsi{iters}_{tag}"][d]
                    sc_f = art["combos"][f"spsi@{iters}"][d]
                    gate(abs(sc_k - sc_f) <= 0.02, ("K3 vs gl.cu, same init and iterations",
                                                    iters, tag, d, sc_k, sc_f))
        gate(len(gl64) == 1, ("gl_init_check random@64 calls", len(gl64)))
        mag, init = gl64.pop()
        seeds = (torch.arange(mag.shape[0], dtype=torch.int32, device=dev) * 7919 + 11)
        errs = {}
        for mode in ("spsi", "advance", "random"):
            k = gl_kernel.gl_init_angles(mag, NFFT, HOP, mode, seeds if mode == "random" else None)
            p = gl_kernel.init_angles_plain(mag, NFFT, HOP, mode, seeds)
            errs[mode] = (float(((k[0] * p[0] + k[1] * p[1]) / torch.sqrt(k[0] ** 2 + k[1] ** 2))
                                .min()), float(torch.maximum((k[0] - p[0]).abs(),
                                                             (k[1] - p[1]).abs()).max()))
        p_init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
        rel1 = {}
        for int8 in (True, False):
            g1 = gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=1, momentum=0.0,
                                          init_angles=p_init, int8=int8)
            q1 = gl_kernel.griffin_lim_tc_plain(mag, *p_init, NFFT, HOP, 1, 0.0, int8)
            rel1["int8" if int8 else "bf16"] = float(torch.linalg.norm(g1 - q1)
                                                     / torch.linalg.norm(q1))
        # gl.cu against plain f32 GL from the same angles after 1 and 64
        # iterations (the random init's imaginary DC and Nyquist bins dropped
        # by both, ROADMAP C.5), and both against GL in float64: where momentum
        # 0.99 grows f32 rounding on these magnitudes, GL64 from the kernel lies
        # no farther from plain f32 GL, nor from float64 GL, than GL64_SPREAD
        # times plain f32 GL's own distance from float64 GL (1e-3 at least)
        def rel_l2(x, ref):
            return float(torch.linalg.norm(x.double() - ref.double())
                         / torch.linalg.norm(ref.double()))

        rel = {}
        for n in (1, 64):
            got = gl_fused(mag, NFFT, HOP, n_iter=n, init_angles=init)
            ref = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=n, init_angles=init)
            exact = griffin_lim_f64(mag, init, n)
            rel[n] = dict(kernel_plain=rel_l2(got, ref), kernel_f64=rel_l2(got, exact),
                          plain_f64=rel_l2(ref, exact))
        bound64 = max(1e-3, GL64_SPREAD * rel[64]["plain_f64"])
        sc64 = tuple(checklib.spectral_convergence(y, mag, NFFT, HOP) for y in (got, ref))
        log(f"[gl_init_check K2/K3] trained magnitudes {tuple(mag.shape)}: K2 vs plain (min cos "
            f"dphi, max|d|) {errs} (gates spsi cos >= 0.99995, advance and hash max|d| < 1e-5); "
            f"K3 1 iter mom 0 vs its plain version rel-L2 {rel1} (gate < 0.03); gl.cu from the "
            f"random init, rel-L2 to plain f32 GL and of both to float64 GL: GL1 {rel[1]} (gate "
            f"kernel_plain 1e-5), GL64 {rel[64]} (gate kernel_plain and kernel_f64 <= "
            f"{bound64:.3g}); GL64 spectral convergence (kernel, plain) {sc64} (gate |delta| <= "
            f"1e-4) on [{smi}]")
        gate(errs["spsi"][0] >= 0.99995 and errs["advance"][1] < 1e-5 and errs["random"][1] < 1e-5,
             ("gl_init_check K2", errs))
        gate(max(rel1.values()) < 0.03, ("gl_init_check K3 1 iteration", rel1))
        gate(rel[1]["kernel_plain"] <= 1e-5 and rel[64]["kernel_plain"] <= bound64
             and rel[64]["kernel_f64"] <= bound64 and abs(sc64[0] - sc64[1]) <= 1e-4,
             ("gl_init_check gl.cu GL1 / GL64", rel, bound64, sc64))
        gl64_rel = rel
        del mag, init, got, ref, exact, p_init, decodes[:]

        # -- gl_mcd_ab: the MCD table ----------------------------------------
        mcd, syn, glc = counted("gl_mcd_ab", lambda: gl_mcd_ab.main(
            ["--root", croot, "--batches", "3", "--batch_size", "16"], device=dev))
        res = mcd["results_db"]
        log(f"[gl_mcd_ab] {len(syn)} batch(es) of the synthesize split (B={len(syn[0][1])} "
            f"first), MCD dB {json.dumps(res)} on [{smi}]")
        gate(len(syn) >= 1 and all(np.isfinite(v) and v > 0 for legs in res.values()
                                   for v in legs.values()), ("gl_mcd_ab", len(syn), res))
        gate(res["spsi@12"]["copy_synthesis"] <= res["random@64"]["copy_synthesis"] + 0.5,
             ("copy-synthesis spsi@12 (K3 int8) more than 0.5 dB above random@64 (gl.cu)", res))
        hold_synthesis(syn[:1], glc[:1], dev, spectral_err, "gl_mcd_ab, trained")

        # -- exp_gl_init at B=6, T=400 ----------------------------------------
        tmp_keep = tmp_mod.tempdir
        tmp_mod.tempdir = root
        try:
            exp, _, _ = counted("exp_gl_init", lambda: exp_gl_init.main([], device=dev))
        finally:
            tmp_mod.tempdir = tmp_keep
        log(f"[exp_gl_init] B=6 T=400 spectral convergence {json.dumps(exp)} on [{smi}]")
        gate(list(exp) == ["speech_like", "white", "harmonic", "real_audio"]
             and all(len(v) == 1 + len(exp_gl_init.INITS) * len(exp_gl_init.ITERS)
                     and all(np.isfinite(x) for x in v.values())
                     for v in exp.values()), ("exp_gl_init", exp))
        mags = checklib.mag_distributions(6, 400, 513, np.random.default_rng(0))
        mags["real_audio"] = exp_gl_init.real_audio_mags(6, 400, np.random.default_rng(1))
        locks, n0 = {}, {}
        for d, m_np in mags.items():
            m = torch.from_numpy(np.ascontiguousarray(m_np, np.float32)).to(dev)
            for lock in (0.0, -1.0):
                k = gl_kernel.gl_init_angles(m, NFFT, HOP, "spsi", lock=lock)
                p = gl_kernel.init_angles_plain(m, NFFT, HOP, "spsi", lock=lock)
                locks[(d, lock)] = float(((k[0] * p[0] + k[1] * p[1])
                                          / torch.sqrt(k[0] ** 2 + k[1] ** 2)).min())
            a = gl_kernel.init_angles_plain(m, NFFT, HOP, "advance")
            y0 = gl_fused(m, NFFT, HOP, n_iter=0, init_angles=a)
            r0 = torchdsp.griffin_lim(m, NFFT, HOP, n_iter=0, init_angles=a)
            n0[d] = float(torch.linalg.norm(y0 - r0) / torch.linalg.norm(r0))
        log(f"[exp_gl_init K2] lock 0 / -1 vs init_angles_plain, min cos dphi "
            f"{ {f'{d} {lk:g}': round(v, 7) for (d, lk), v in locks.items()} } (gate >= 0.99995); "
            f"gl.cu n_iter 0 (init + synthesis) vs plain rel-L2 {n0} (gate 1e-4)")
        gate(min(locks.values()) >= 0.99995, ("K2 lock 0 / -1", locks))
        gate(max(n0.values()) <= 1e-4, ("gl.cu n_iter 0", n0))
        m = torch.from_numpy(np.ascontiguousarray(mags["speech_like"], np.float32)).to(dev)
        k2_ms = cuda_ms(lambda: gl_kernel.gl_init_angles(m, NFFT, HOP, "spsi", lock=-1.0), reps=10)
        k2_plain = cuda_ms(lambda: gl_kernel.init_angles_plain(m, NFFT, HOP, "spsi", lock=-1.0))
        k2_b, k2_by = bound_ms(30.0 * m.numel(), 3 * 4.0 * m.numel(), 67e12)
        a = gl_kernel.init_angles_plain(m, NFFT, HOP, "advance")
        n0_ms = cuda_ms(lambda: gl_fused(m, NFFT, HOP, n_iter=0, init_angles=a), reps=10)
        n0_plain = cuda_ms(lambda: torchdsp.griffin_lim(m, NFFT, HOP, n_iter=0, init_angles=a))
        Bm, Tm, Fm = m.shape
        n0_b, n0_by = bound_ms(Bm * Tm * (2.5 * NFFT * np.log2(NFFT) + 4 * Fm),
                               4.0 * (3 * m.numel() + Bm * HOP * (Tm - 1)), 67e12)
        log(f"[exp_gl_init] B=6 T=400: K2 spsi lock -1 {k2_ms:.4f} ms (plain {k2_plain:.3f}, "
            f"bound {k2_b:.4f}, {k2_by}); gl.cu n_iter 0 {n0_ms:.4f} ms (plain {n0_plain:.3f}, "
            f"bound {n0_b:.4f}, {n0_by}) on [{smi}]")
        gate(k2_ms >= k2_b and n0_ms >= n0_b, ("under the bound", k2_ms, k2_b, n0_ms, n0_b))
        del m, a, mags

        # -- spec_rate_diag on the campaign's config ----------------------------
        spec, syn, glc = counted("spec_rate_diag", lambda: spec_rate_diag.main(
            ["--config", os.path.join(croot, "config.json"),
             "--out", os.path.join(root, "spec_rate_diag.json")], device=dev))
        with open(os.path.join(croot, "texts.txt")) as f:
            n_texts = sum(1 for ln in f if ln.strip())
        n_spk = len(os.listdir(os.path.join(croot, "spk_emb")))
        log(f"[spec_rate_diag] {json.dumps(spec)}")
        gate(sorted(spec) == ["detail", "metric", "unit", "value"]
             and list(spec["detail"]) == SPEC_DETAIL
             and spec["detail"]["n_pairs"] == n_texts * n_spk and np.isfinite(spec["value"]),
             ("spec_rate_diag", spec, n_texts, n_spk))
        hold_synthesis(syn[:1], glc[:1], dev, spectral_err, "spec_rate_diag, first batch")

        # -- gl24_check and gl_spsi_check's spsi@16 ------------------------------
        with open(os.path.join(croot, "state", "spoofgen.json")) as f:
            base_wavs = json.load(f)["spoof_wavs"]
        rescored = {}
        gl24, syn, glc = counted("gl24_check", lambda: gl24_check.main(flags, device=dev))
        rescored["gl24_check"] = gl24
        hold_synthesis(syn[:1], glc[:1], dev, spectral_err, "gl24_check spoof set")
        c = checklib.campaign_check(flags, dev)
        s16, syn, glc = counted("gl_spsi_check spsi@16",
                                lambda: gl_spsi_check.score_candidate(c, 16, "spsi"))
        rescored["gl_spsi_check spsi@16"] = s16
        hold_synthesis(syn[:1], glc[:1], dev, spectral_err, "gl_spsi_check spsi@16 spoof set")
        base = checklib.base_summary(c)
        for name, r in rescored.items():
            g, iv, cm = r["ge2e"], r["ivector"], r["cm"]
            vals = {"ge2e EER": g["EER"], "ge2e spoof rate": g["spoof_rate"],
                    "ge2e spoof rate at EER": g["spoof_rate_at_eer"], "ge2e gt FRR": g["gt_FRR"],
                    "ivector mixed EER": iv["mixed_eer"], "ivector clean EER": iv["clean_eer"],
                    "ivector spoof rate": iv["spoof_rate"], "CM EER": cm["cm_eer"]}
            log(f"[{name}] {json.dumps({k: round(float(v), 4) for k, v in vals.items()})}; spoof "
                f"wavs {r['spoofgen']['spoof_wavs']} (base {base_wavs}); base {json.dumps(base)}")
            in01(vals, name)
            gate(r["spoofgen"]["spoof_wavs"] == base_wavs, (name, "spoof wavs", r["spoofgen"]))
        gate(sorted(gl24) == ["base_gl32", "cm", "ge2e", "ivector", "spoofgen"]
             and gl24["base_gl32"] == base, ("gl24_check keys", sorted(gl24)))

        # -- ivector_delta_rescore at 1024 / 400 ---------------------------------
        deltas, _, _ = counted("ivector_delta_rescore", lambda: ivector_delta_rescore.main(
            ["--root", croot, "--enroll", "3", "--eval_num", "4"], device=dev))
        legs = deltas["results"]
        for leg in ("no_deltas_cached_r3", "deltas_fresh"):
            in01({k: legs[leg][k] for k in ("mixed_eer", "clean_eer", "spoof_rate")},
                 f"ivector_delta_rescore {leg}")
        log(f"[ivector_delta_rescore] 1024 / 400: cached {legs['no_deltas_cached_r3']['_wall_s']}"
            f" s, fresh {legs['deltas_fresh']['_wall_s']} s; shift {legs.get('shift')}")

        # -- vad_ab with the campaign's GE2E checkpoint ---------------------------
        with open(os.path.join(croot, "state", "ge2e.json")) as f:
            ck = json.load(f)["checkpoint"]
        vad, _, _ = counted("vad_ab", lambda: vad_ab.main(
            ["--root", croot, "--utts", "20", "--ge2e_ck", ck], device=dev))
        emb = vad["embedding_leg"]
        log(f"[vad_ab] {vad['n_utts']} utterances: clean {json.dumps(vad['clean'])}; gapped loud "
            f"{json.dumps(vad['gapped_loud_floor'])}; embedding leg {json.dumps(emb)}")
        gate(list(vad) == VAD_KEYS and emb["n_compared"] >= 1
             and np.isfinite(emb["mean_dvector_cos_mean"]), ("vad_ab", list(vad), emb))
    finally:
        decode_kernel.make_fused_decoder = make_fused
        gl_kernel.griffin_lim_fused = gl_fused
        rec.restore()

    for name, row in runs.items():
        want, n = CHECK_KERNELS[name], row["launches"]
        gate(all(n[k] > 0 for k in want) and all(v == 0 for k, v in n.items() if k not in want),
             ("check launches", name, n, sorted(want)))
    total = {k: sum(row["launches"][k] for row in runs.values()) for k in snap()}
    gate(all(total[k] > 0 for k in GL_KERNELS), ("checks launches", total))
    log(f"[phase 15] seconds by check {json.dumps({k: round(r['s'], 2) for k, r in runs.items()})}")
    return {"checks": total, "seconds": {k: r["s"] for k, r in runs.items()},
            "lock": {f"{d} {lk:g}": v for (d, lk), v in locks.items()}, "n_iter0": n0,
            "gl64": gl64_rel,
            "k2_lock_ms": dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_b, bound_by=k2_by),
            "gl_n_iter0_ms": dict(ms=n0_ms, plain_ms=n0_plain, bound_ms=n0_b, bound_by=n0_by)}


# phase 16: multi-speaker Tacotron 2. The rollout's gates are the Tacotron 2
# cell's limits (PERF.md section 2: sound runs read at most 0.0164 / 0.00179 /
# 0.0113 against float32, the fp8 control at least 0.399 / 0.169 / 0.254);
# here the plain steps read the same bf16 operand rows as the kernels
T2_GATES = {"mel": 0.075, "att": 0.015, "gate": 0.05}
H100 = {"bf16": 989e12, "f32": 67e12, "bytes_per_s": 3.35e12}   # the bounds' rates (section 6)


def t2_restore(t2_kernel, w, s, state: dict, mel_prev, t: int) -> None:
    """The decoder's state kept before step ``t`` (one entry of the
    rollout's ``states``) into the buffers ``s``: the operand rows, c, w, Σw,
    and the prenet's output for step ``t`` from the frame emitted before it
    (``mel_prev``; the go frame's prenet is 0), its masks hashed as the
    kernel hashes them."""
    import torch

    A, D, P, M = w.A, w.D, w.P, w.M
    for k in ("c_att", "c_dec", "w", "cum"):
        getattr(s, k).copy_(state[k])
    s.d_buf[:, :A] = state["h_att"]
    s.d_buf[:, A:A + D] = state["h_dec"]
    s.d_buf[:, A + D:] = state["ctx"]
    s.a_buf[:, P:P + M] = state["ctx"]
    s.a_buf[:, P + M:] = state["h_att"]
    y = mel_prev.float() if t else torch.zeros_like(mel_prev, dtype=torch.float32)
    for layer, wl in enumerate((w.w_pre1, w.w_pre2)):
        y = torch.relu(y @ wl.float().t()) * t2_kernel.prenet_mask_plain(
            s.seeds, t, layer, wl.shape[0], w.drop)
    s.a_buf[:, :P] = y.to(s.a_buf.dtype)


def tacotron2_phase(dev, cuda_ms, counters: dict, kernels: dict, smi: str) -> dict:
    """Phase 16: multi-speaker Tacotron 2 (``Tacotron2Synthesizer``) at the
    published widths in bf16, on the spoof-set call: 8 speakers x the 20
    Harvard sentences (B=160, N=49), the full 1000-step rollout, GL12 from
    SPSI on int8 K2/K3. The path's own call with every launch count reset
    just before (1000 launches of each step kernel, one graph replay, no
    capture; K2 and K3 once, K1 never). Then on that call's inputs: the
    captured rollout bit-equal to the same steps run eagerly (states
    included); the whole rollout against ``rollout_plain``'s steps
    (``att_step_plain``, ``dec_step_plain`` over the same bf16 operand rows),
    each segment of 25 steps resumed from the rollout's kept state, within
    ``T2_GATES``, its mel gap no wider in the last hundred steps than
    allowed in the first; each step kernel against its plain version on the
    same card inputs at steps 0, 500 and 975 (float32 outputs within 1e-4,
    bf16 rows within two units in the last place, the prenet's dropped units
    exactly), each timed (CUDA events, a launch) against its bound. Returns
    the path's launches."""
    import copy
    import dataclasses

    import torch

    from portbench.work import tacotron2 as t2work
    from spoofsv_torch.config import Tacotron2Config
    from spoofsv_torch.data.text import t2_encode_texts
    from spoofsv_torch.infer.synthesize import Tacotron2Synthesizer
    from spoofsv_torch.models.tacotron2 import build_tacotron2
    from spoofsv_torch.ops import t2_kernel
    from spoofsv_torch.utils import profiling

    cfg = Tacotron2Config(weights_seed=3)
    syn = Tacotron2Synthesizer(cfg, build_tacotron2(cfg, dev, torch.bfloat16),
                               gl_iters=cfg.tpu.griffin_lim_iters)
    T = syn.n_frames
    texts = np.tile(t2_encode_texts(SENTENCES), (8, 1))
    rng = np.random.default_rng(16)
    spk = rng.standard_normal((8, cfg.speaker_embedding_dim))
    spk = np.repeat(spk / np.linalg.norm(spk, axis=1, keepdims=True), 20, 0).astype(np.float32)
    seeds = rng.integers(-2 ** 31, 2 ** 31 - 1, 160)
    seeds[:3] = [0, -1, 2 ** 31 - 1]
    B, N = texts.shape
    gate((B, N, T) == (160, 49, 1000), ("the spoof-set call's shape", B, N, T))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syn(texts, spk, seeds)       # the (B, N) graph's capture
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps = {k: t2_kernel.LAUNCHES[k] for k in ("t2_att_step", "t2_dec_step")}
    for c in [*counters.values(), *steps.values()]:
        c.launches = 0
    before = profiling.snapshot()["counters"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, mel, attn = syn(texts, spk, seeds)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    after = profiling.snapshot()["counters"]
    launches = {**{k: c.launches for k, c in counters.items()},
                **{k: c.launches for k, c in steps.items()}}
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in ("t2_rollout_steps",
                                                            "t2_graph_captures")}
    log(f"[t2] B={B} N={N} T={T}: launches {launches}, counters {grew}; audio "
        f"{tuple(audio.shape)}; call {call_s:.3f} s (the first, with the capture, "
        f"{first_s:.3f} s) = {B * audio.shape[1] / 22050 / call_s:.1f} audio s per wall s "
        f"on [{smi}]")
    gate(launches["t2_att_step"] == T and launches["t2_dec_step"] == T,
         ("a step kernel's launches on the Tacotron 2 path", launches))
    gate(launches["gl_init"] == 1 and launches["griffin_lim"] == 1
         and all(n == 0 for k, n in launches.items()
                 if k not in ("gl_init", "griffin_lim", *steps)),
         ("the Tacotron 2 path's other launches", launches))
    gate(grew == {"t2_rollout_steps": T, "t2_graph_captures": 0}, ("t2 counters", grew))
    gate(tuple(audio.shape) == (B, HOP * (T - 1)) and tuple(mel.shape) == (B, T, 80)
         and tuple(attn.shape) == (B, N, T), (audio.shape, mel.shape, attn.shape))
    gate(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) > 1e-4,
         "Tacotron 2 audio is not finite or is silent")
    del audio, mel, attn

    # the rollout on that call's inputs: graph, eager kernel steps, plain steps
    w = syn.rollout.weights
    text_d = torch.from_numpy(texts).to(dev)
    lengths = torch.from_numpy((texts != 0).sum(1))
    seeds_d = torch.from_numpy(seeds).to(dev, torch.int32)
    memory, pm = syn.encode(text_d, lengths, torch.from_numpy(spk).to(dev))
    mel_g, gate_g, att_g, states = syn.rollout(memory, pm, lengths, seeds_d)
    states = {k: v.clone() for k, v in states.items()}
    roll_ms = cuda_ms(lambda: syn.rollout(memory, pm, lengths, seeds_d), reps=3)

    def buffers():
        s = t2_kernel.Buffers(w, B, N, T, torch.bfloat16, dev)
        s.memory.copy_(memory)
        s.pm.copy_(pm.transpose(1, 2))
        s.lengths.copy_(lengths)
        s.seeds.copy_(seeds_d)
        return s

    eager = buffers()
    with torch.no_grad():
        t2_kernel.run_steps(w, eager, plain=False)
    gate(all(torch.equal(a, b) for a, b in zip((mel_g, gate_g, att_g),
                                               (eager.mel, eager.gate, eager.att)))
         and all(torch.equal(states[k], eager.ckpt[k]) for k in t2_kernel.STATE),
         "the captured rollout is not the eager rollout")
    del eager
    plain = buffers()
    starts = [int(x) for x in states["step"]] + [T]
    with torch.no_grad():
        for i, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
            t2_restore(t2_kernel, w, plain, {k: states[k][i] for k in t2_kernel.STATE},
                       mel_g[:, a - 1], a)
            for t in range(a, b):
                t2_kernel.att_step_plain(plain.a_buf.float() @ w.w_att.float().t(), w, plain, t)
                t2_kernel.dec_step_plain(plain.d_buf.float() @ w.w_dec.float().t(), w, plain, t)
    d_mel = (plain.mel - mel_g).abs().amax(dim=(0, 2))
    gaps = {"mel": float(d_mel.max()), "att": float((plain.att - att_g).abs().max()),
            "gate": float((plain.gate - gate_g).abs().max())}
    first100, last100 = float(d_mel[:100].max()), float(d_mel[-100:].max())
    log(f"[t2] the rollout against rollout_plain's steps, resumed every "
        f"{t2_kernel.CHECKPOINT_EVERY} steps from its state: max|d| mel {gaps['mel']:.3g}, "
        f"attention {gaps['att']:.3g}, gate {gaps['gate']:.3g} (gates {T2_GATES}); mel "
        f"first 100 steps {first100:.3g}, last 100 {last100:.3g}")
    gate(all(gaps[k] <= T2_GATES[k] for k in T2_GATES), ("t2 rollout vs plain", gaps))
    gate(last100 <= T2_GATES["mel"] and first100 <= T2_GATES["mel"], (first100, last100))
    del plain

    def close_bf16(a, b) -> float:
        """max |a - b| in units of two bf16 ulps of the larger (≤ 1 passes)."""
        a, b = a.float(), b.float()
        return float(((a - b).abs() / (2.0 ** -6 * torch.maximum(a.abs(), b.abs()) + 1e-6)).max())

    hp = dataclasses.asdict(cfg)
    errs = {"t2_att_step": 0.0, "t2_dec_step": 0.0}
    times = {}
    for t in (0, 500, 975):
        i = t // t2_kernel.CHECKPOINT_EVERY
        s1 = buffers()
        t2_restore(t2_kernel, w, s1, {k: states[k][i] for k in t2_kernel.STATE},
                   mel_g[:, t - 1], t)
        s2 = copy.deepcopy(s1)
        g = torch.mm(s1.a_buf, w.w_att.t(), out_dtype=torch.float32)
        t2_kernel.att_step_kernel(g, w, s1, t)
        t2_kernel.att_step_plain(g, w, s2, t)
        torch.cuda.synchronize()
        f32 = max(float(((getattr(s1, k) - getattr(s2, k)).abs()
                         / (1e-4 * getattr(s2, k).abs() + 1e-5)).max())
                  for k in ("c_att", "w", "cum", "att"))
        ulps = max(close_bf16(s1.a_buf, s2.a_buf), close_bf16(s1.d_buf, s2.d_buf))
        errs["t2_att_step"] = max(errs["t2_att_step"], float((s1.att - s2.att).abs().max()))
        log(f"[t2 att_step] step {t}: f32 outputs {f32:.3g} of their tolerance (1e-4 rel + "
            f"1e-5), bf16 rows {ulps:.3g} of two ulps")
        gate(f32 <= 1.0 and ulps <= 1.0, ("t2_att_step_kernel vs att_step_plain", t, f32, ulps))
        s3, s4 = s1, copy.deepcopy(s1)   # the decoder cell after this step's attention
        g = torch.mm(s3.d_buf, w.w_dec.t(), out_dtype=torch.float32)
        t2_kernel.dec_step_kernel(g, w, s3, t)
        t2_kernel.dec_step_plain(g, w, s4, t)
        torch.cuda.synchronize()
        f32 = max(float(((getattr(s3, k) - getattr(s4, k)).abs()
                         / (1e-4 * getattr(s4, k).abs() + 1e-4)).max())
                  for k in ("c_dec", "mel", "gate"))
        ulps = max(close_bf16(s3.a_buf, s4.a_buf), close_bf16(s3.d_buf, s4.d_buf))
        masks = torch.equal(s3.a_buf[:, :w.P] == 0, s4.a_buf[:, :w.P] == 0)
        dropped = float((s4.a_buf[:, :w.P] == 0).float().mean())
        errs["t2_dec_step"] = max(errs["t2_dec_step"], float((s3.mel - s4.mel).abs().max()))
        log(f"[t2 dec_step] step {t}: f32 outputs {f32:.3g} of their tolerance (1e-4 rel + "
            f"1e-4), bf16 rows {ulps:.3g} of two ulps, the prenet's zeros equal: {masks} "
            f"({100 * dropped:.1f} % of units zero)")
        gate(f32 <= 1.0 and ulps <= 1.0 and masks,
             ("t2_dec_step_kernel vs dec_step_plain", t, f32, ulps, masks))
        if t == 500:
            g_att = torch.mm(s1.a_buf, w.w_att.t(), out_dtype=torch.float32)
            times = {
                "t2_att_step": (cuda_ms(lambda: t2_kernel.att_step_kernel(g_att, w, s1, t),
                                        reps=200),
                                cuda_ms(lambda: t2_kernel.att_step_plain(g_att, w, s2, t))),
                "t2_dec_step": (cuda_ms(lambda: t2_kernel.dec_step_kernel(g, w, s3, t),
                                        reps=200),
                                cuda_ms(lambda: t2_kernel.dec_step_plain(g, w, s4, t)))}
        del s1, s2, s3, s4

    work = {"t2_att_step": t2work.att_step_kernel(hp, B, N, 1),
            "t2_dec_step": t2work.dec_step_kernel(hp, B, 1)}
    for k, (ms, plain_ms) in times.items():
        c = work[k]
        t_ops = c["bf16"] / H100["bf16"] + c["f32"] / H100["f32"]
        t_bytes = c["bytes"] / H100["bytes_per_s"]
        b_ms = 1e3 * max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[{k}] B={B} N={N} a launch: kernel {ms:.4f} ms (CUDA events, mean of 200), plain "
            f"{plain_ms:.3f} ms; bound {b_ms:.4f} ms ({by}: products at bf16, the rest at f32), "
            f"{100 * b_ms / ms:.1f} % of it, on [{smi}]")
        kernels[k] = dict(
            name=k, route="cuda", source="spoofsv_torch/csrc/t2_rollout.cu", replaces=None,
            max_abs_err=errs[k], ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
            library_ms=None, launches=launches[k])
    r_ops, r_bytes = t2work.rollout(hp, B, N, T, 2)
    r_ms = 1e3 * max(r_ops / H100["bf16"], r_bytes / H100["bytes_per_s"])
    log(f"[t2] the rollout's graph (1000 steps, 4,000 kernels): {roll_ms:.3f} ms (CUDA events, "
        f"mean of 3), bound {r_ms:.3f} ms (operations at bf16), {100 * r_ms / roll_ms:.1f} %")
    del syn, memory, pm, mel_g, gate_g, att_g, states
    torch.cuda.empty_cache()
    return launches


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

    texts = encode_texts([SENTENCES[i % 8] for i in range(64)],
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
    train_launches, step_ms, bf16_launches = training_phase(cfg, dev, counters, B=16, N=186,
                                                            T=325)
    log(f"[time] phase 7 {time.perf_counter() - t0:.1f} s")
    for k, v in train_launches.items():
        kernels[k]["launches"] = v
    log(f"[train] step ms per impl, B=16 N=186 T=325, f32 and bf16 autocast (median of "
        f"iterations 2-5): {step_ms}; bf16 launches {bf16_launches} on [{smi}]")

    # ---- phases 8-9: serving and spoof-set synthesis, bf16, seed-0 weights ----
    m0, s0 = build_models(torch.float32, seed=0)
    state_dicts = {"text2mel": {k: v.cpu() for k, v in m0.state_dict().items()},
                   "ssrn": {k: v.cpu() for k, v in s0.state_dict().items()}}
    del m0, s0
    t0 = time.perf_counter()
    serve_launches = serving_phase(cfg, dev, state_dicts, counters, cluster, cuda_ms, test_mag,
                                   spectral_err, smi)
    log(f"[time] phase 8 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gen_launches = spoofgen_phase(cfg, dev, state_dicts, counters, cluster, smi)
    log(f"[time] phase 9 {time.perf_counter() - t0:.1f} s")

    # ---- phase 10: the training CLI on a toy corpus, then synthesize ----------
    t0 = time.perf_counter()
    cli_launches = train_cli_phase(cfg, dev, counters, cluster, smi, onsets, before_onset,
                                   spectral_err)
    log(f"[time] phase 10 {time.perf_counter() - t0:.1f} s")

    # ---- phases 11-12: the GE2E attack path, then the scoring of the attack ---
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        attack_launches, attack_conf = ge2e_attack_phase(cfg, dev, state_dicts, counters,
                                                         cluster, smi, spectral_err, root)
        log(f"[time] phase 11 {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        scoring_launches = scoring_phase(attack_conf, root, dev, counters, cluster, smi)
        log(f"[time] phase 12 {time.perf_counter() - t0:.1f} s")

    # ---- phase 13: the mesh layer, two ranks sharing the card ----------------
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(cfg, dev, state_dicts, counters, cluster, smi, spectral_err,
                               texts, spk)
    log(f"[time] phase 13 {time.perf_counter() - t0:.1f} s")

    # ---- phase 14: the campaign at reduced depth, then the toy learning run ---
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        camp = campaign_phase(dev, counters, cluster, smi, onsets, before_onset, spectral_err,
                              cuda_ms, root)
        log(f"[time] phase 14 {time.perf_counter() - t0:.1f} s")

        # ---- phase 15: the post-campaign checks on phase 14's tree ----------
        t0 = time.perf_counter()
        checks = checks_phase(dev, counters, cluster, smi, spectral_err, cuda_ms, root)
        log(f"[time] phase 15 {time.perf_counter() - t0:.1f} s")

    # ---- phase 16: multi-speaker Tacotron 2, the spoof-set call ---------------
    t0 = time.perf_counter()
    t2_launches = tacotron2_phase(dev, cuda_ms, counters, kernels, smi)
    log(f"[time] phase 16 {time.perf_counter() - t0:.1f} s")
    kernels["griffin_lim_f32"]["campaign_corpus"] = camp["corpus_gl"]
    kernels["gl_init"]["checks_lock"] = dict(min_cos_dphi=checks["lock"], **checks["k2_lock_ms"])
    kernels["griffin_lim_f32"]["checks_n_iter0"] = dict(rel_l2=checks["n_iter0"],
                                                        **checks["gl_n_iter0_ms"])
    training_bf16 = {"decode": bf16_launches.pop("decode_bf16"), **bf16_launches}
    paths = {"synthesis": launches, "training": train_launches, "serving": serve_launches,
             "spoofgen": gen_launches, **cli_launches, "training_bf16": training_bf16,
             "ge2e_attack": attack_launches, "scoring": scoring_launches, "mesh": mesh_launches,
             **{p: {("decode" if k == "decode_bf16" else k): n for k, n in launches.items()}
                for p, launches in (("campaign", camp["campaign"]), ("toy", camp["toy"]),
                                    ("checks", checks["checks"]))},
             "tacotron2": t2_launches}
    for k, entry in kernels.items():
        entry["launches_by_path"] = {p: n[k] for p, n in paths.items() if k in n}

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
