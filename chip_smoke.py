#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spoofsv_torch``) once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and ``nvcc``; without a device it exits non-zero and prints no result.

Phases (any failure raises and exits non-zero):
  1. card name/power limit; build the kernels from ``spoofsv_torch/csrc/``;
  2. K2 (GL phase init) vs its plain version at the main path's B=64, T=1300;
  3. K3 (Griffin-Lim) vs plain torch GL at B=64, T=1300, same init;
  4. K1 (decode) at the main path's B=64, N=100, T=325: f32 vs the plain
     eager decode, and bf16 vs ``decode_plain`` (the kernel's arithmetic in
     plain torch);
  5. the main path: ``Synthesizer`` at full width in bf16, B=64, N=100,
     T=325, GL12 from the SPSI init, then ``finalize_audio``; launch counts
     reset just before and read just after; plus a small f32 end-to-end
     comparison of the CUDA path against the CPU path;
  6. K4/K5/K6 (highway kernels) vs their plain versions in f32 at the
     training path's shapes (B=16), and K5 in bf16 at the synthesis batch
     (B=64): max |d|, kernel and plain ms, for K5 the executed/useful row
     ratio, the TFLOP/s achieved and the ptxas registers and spills of
     each instantiation (spills fail the run); gradients through each
     ``autograd.Function`` against plain autograd;
  7. the ordinary training path: ``Trainer`` for Text2Mel and SSRN at full
     width, f32, B=16, N=186, T=325 (lin 1300 frames), 5 iterations from the
     same seed-0 weights under each highway impl, one validation (Text2Mel
     through K1) and one checkpoint round trip each; launch counts reset
     just before each run and read just after.
Prints the card line and a kernels JSON line, then the ``{"ok": true, ...}``
line last.
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


def highway_kernel_phase(dev, cuda_ms, kernels: dict) -> None:
    """Phase 6: K6, K4 and K5 against their plain versions in f32 at the
    training path's shapes (B=16), K5 also in bf16 at the synthesis batch
    (B=64), then gradients through each autograd.Function."""
    import re

    import torch

    from spoofsv_torch.ops import _build, gate_kernel, hconv_kernel

    def rand(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dev, dtype)

    def hw_params(C: int, K: int, seed: int, dtype=torch.float32) -> list:
        """Conv weight (2C, C, K) at the models' Kaiming scale, bias, LN params."""
        g = torch.Generator().manual_seed(seed)
        w = torch.randn(2 * C, C, K, generator=g) * (2.0 / (K * C)) ** 0.5
        b = torch.randn(2 * C, generator=g) * 0.1
        lns = [torch.randn(C, generator=g) * 0.2 + (1.0 if i % 2 == 0 else 0.0) for i in range(4)]
        return [t.to(dev, dtype) for t in (w, b, *lns)]

    # K5's ptxas lines, one instantiation (storage type, channels per CTA) each
    info = _build.BUILD_LOG["hconv_pair"].get("ptxas", [])
    for i, ln in enumerate(info):
        inst = re.search(r"hconv_pair_kernelI(f|13__nv_bfloat16)Li(\d)E", ln)
        if inst and i + 2 < len(info):
            log(f"[highway_conv_pair] ptxas <{'f32' if inst[1] == 'f' else 'bf16'}, "
                f"{32 * int(inst[2])} channels per CTA>: {info[i + 2].split(':', 1)[-1].strip()}; "
                f"{info[i + 1].strip()}")
            gate(info[i + 1].strip().startswith("0 bytes stack frame, 0 bytes spill stores"),
                 ("K5 spills", info[i + 1]))

    def gate_case(rows: int, C: int, seed: int):
        args = (rand((16, rows, 2 * C), seed), rand((16, rows, C), seed + 1),
                *hw_params(C, 1, seed + 2)[2:])
        return (lambda: gate_kernel.fused_highway_gate(*args),
                lambda: gate_kernel.highway_gate_plain(*args))

    def conv_case(T: int, C: int, dil: int, causal: bool, seed: int):
        x, p = rand((16, T, C), seed), hw_params(C, 3, seed + 1)
        return (lambda: hconv_kernel.fused_highway_conv(x, *p, dil, causal),
                lambda: hconv_kernel.highway_conv_plain(x, *p, dil, causal))

    def pair_case(T: int, C: int, da: int, db: int, causal: bool, seed: int, B: int = 16,
                  dtype=torch.float32):
        x = rand((B, T, C), seed, dtype)
        pa, pb = hw_params(C, 3, seed + 1, dtype), hw_params(C, 3, seed + 2, dtype)
        plan = hconv_kernel.pair_tile_plan(C, 3, db, T, dtype)
        flop = 2 * (2 * B * T * 3 * C * 2 * C)   # two layers of (B·T, K·C) × (K·C, 2C)
        return (lambda: hconv_kernel.fused_highway_conv_pair(x, *pa, *pb, da, db, causal),
                lambda: hconv_kernel.highway_pair_plain(x, *pa, *pb, da, db, causal),
                (plan.executed_over_useful(T), flop))

    # f32: sums of up to K·C = 1536 products in another order, then LayerNorm;
    # bf16: outputs within a few bf16 ulps (the card tests' gate)
    tols = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    cases = {   # name -> (TPU kernel, [(case, builder)]); the first case is the JSON's
        "highway_gate": ("spoofsv_tpu/ops/pallas_ops.py:40", [
            ("audio encoder 16x325 rows C=256", lambda: gate_case(325, 256, 30)),
            ("text encoder 16x186 rows C=512", lambda: gate_case(186, 512, 33))]),
        "highway_conv": ("spoofsv_tpu/ops/pallas_conv.py:57", [
            ("SSRN hc3 T=1300 C=512 d=1 SAME", lambda: conv_case(1300, 512, 1, False, 40)),
            ("audio encoder T=325 C=256 d=27 causal", lambda: conv_case(325, 256, 27, True, 42))]),
        "highway_conv_pair": ("spoofsv_tpu/ops/pallas_conv.py:204", [
            ("SSRN hc3->hc4 T=1300 C=512 (1,1)", lambda: pair_case(1300, 512, 1, 1, False, 50)),
            ("ups2 pair T=1300 C=256 (1,3)", lambda: pair_case(1300, 256, 1, 3, False, 53)),
            ("causal (9,27) T=325 C=256", lambda: pair_case(325, 256, 9, 27, True, 56)),
            ("text encoder (9,27) SAME N=186 C=512",
             lambda: pair_case(186, 512, 9, 27, False, 59)),
            ("bf16 SSRN hc3->hc4 B=64 T=1300 C=512 (1,1)",
             lambda: pair_case(1300, 512, 1, 1, False, 62, B=64, dtype=torch.bfloat16))]),
    }
    sources = {"highway_conv_pair": "spoofsv_torch/csrc/hconv_pair.cu"}
    for name, (replaces, named) in cases.items():
        errs, times = [], []
        for label, build_case in named:
            fused, plain, *work = build_case()
            got, ref = fused(), plain()
            err = float((got.float() - ref.float()).abs().max())
            tol = tols[got.dtype]
            if got.dtype == torch.float32:
                errs.append(err)
            times.append((cuda_ms(fused, reps=5), cuda_ms(plain, reps=5)))
            extra = ""
            if work:   # K5: executed/useful rows, useful FLOPs over the kernel's time
                ratio, flop = work[0]
                extra = (f"; executed/useful rows {ratio:.3f}, "
                         f"{flop / (times[-1][0] * 1e-3) / 1e12:.1f} TFLOP/s")
            log(f"[{name}] {label}: max|d| {err:.3g} (gate {tol}); kernel "
                f"{times[-1][0]:.3f} ms, plain {times[-1][1]:.3f} ms{extra}")
            gate(err <= tol, (name, label, err))
            del fused, plain, got, ref
        kernels[name] = dict(name=name, route="cuda",
                             source=sources.get(name, "spoofsv_torch/csrc/highway.cu"),
                             replaces=replaces, max_abs_err=max(errs), ms=times[0][0],
                             plain_ms=times[0][1])

    # gradients through each autograd.Function (the plain version recomputed
    # from the saved inputs) against autograd of the plain version
    C, T = 256, 64
    grad_cases = {
        "highway_gate": (gate_kernel.fused_highway_gate, gate_kernel.highway_gate_plain,
                         [rand((2, T, 2 * C), 60), rand((2, T, C), 61)]
                         + hw_params(C, 1, 62)[2:], ()),
        "highway_conv": (hconv_kernel.fused_highway_conv, hconv_kernel.highway_conv_plain,
                         [rand((2, T, C), 63)] + hw_params(C, 3, 64), (3, True)),
        "highway_conv_pair": (hconv_kernel.fused_highway_conv_pair,
                              hconv_kernel.highway_pair_plain,
                              [rand((2, T, C), 65)] + hw_params(C, 3, 66) + hw_params(C, 3, 67),
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


def training_phase(cfg, dev, counters: dict, B: int, N: int, T: int):
    """Phase 7: the ordinary training path. For each train kind and highway
    impl, a ``Trainer`` takes 5 steps on one synthetic batch (B utterances,
    N text ids, T mel frames, 4T lin frames) from the same seed-0 weights,
    validates once and checkpoints; the checkpoint is reloaded and resumed.
    Launch counts are reset just before each run and read just after.
    Returns (K4/K5/K6 launches summed over the runs, step ms per run)."""
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
    hw_launches = dict.fromkeys(impl_kernel.values(), 0)
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
                for k in hw_launches:
                    hw_launches[k] += n[k]
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
                gate(all(n[k] == 0 for k in hw_launches if k not in own),
                     (kind, impl, "a kernel of another impl ran", n))
                if impl in impl_kernel:
                    gate(n[impl_kernel[impl]] > 0, (kind, impl, "kernel not launched", n))
                if kind == "train_text2mel":
                    gate(n["decode"] > 0, (kind, impl, "validation did not run K1", n))
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
    return hw_launches, step_ms


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
    k2_ms = cuda_ms(lambda: gl_kernel.gl_init_angles(mag, NFFT, HOP, "spsi"))
    k2_plain = cuda_ms(lambda: gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi"))
    log(f"[K2] B=64 T=1300 spsi: kernel {k2_ms:.3f} ms, plain {k2_plain:.3f} ms")
    kernels["gl_init"] = dict(
        name="gl_init", route="cuda", source="spoofsv_torch/csrc/gl.cu",
        replaces="spoofsv_tpu/ops/pallas_gl.py:618", max_abs_err=spsi_err, ms=k2_ms,
        plain_ms=k2_plain)

    # ---- phase 3: K3 vs plain torch GL -----------------------------------------
    init = (p_re, p_im)
    g1 = gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=1, momentum=0.0, init_angles=init)
    r1 = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=1, momentum=0.0, init_angles=init)
    rel1 = float(torch.linalg.norm(g1 - r1) / torch.linalg.norm(r1))
    gl_err = float((g1 - r1).abs().max())
    g12 = gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=12, momentum=0.99, init_angles=init)
    r12 = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=12, momentum=0.99, init_angles=init)
    sc_k, sc_p = spectral_err(g12, mag), spectral_err(r12, mag)
    log(f"[K3] arithmetic: {gl_kernel.ARITHMETIC}")
    log(f"[K3] 1 iter mom 0: rel-L2 {rel1:.3g} (gate < 0.03), max|d| {gl_err:.3g}; "
        f"12 iter mom 0.99: spectral conv kernel {sc_k:.5f} plain {sc_p:.5f} "
        f"(gate delta <= 0.02)")
    gate(rel1 < 0.03, rel1)
    gate(abs(sc_k - sc_p) <= 0.02, (sc_k, sc_p))
    k3_ms = cuda_ms(lambda: gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=12,
                                                        init_angles=init))
    k3_plain = cuda_ms(lambda: torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=12,
                                                    init_angles=init))
    log(f"[K3] B=64 T=1300 GL12: kernel {k3_ms:.3f} ms, plain {k3_plain:.3f} ms")
    kernels["griffin_lim"] = dict(
        name="griffin_lim", route="cuda", source="spoofsv_torch/csrc/gl.cu",
        replaces="spoofsv_tpu/ops/pallas_gl.py:122", max_abs_err=gl_err, ms=k3_ms,
        plain_ms=k3_plain)
    del mag, init, g1, r1, g12, r12, k_re, k_im, p_re, p_im, h_re, h_im, q_re, q_im

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

    # f32 at the main path's B=64, N=100, T=325 against the eager decode. Random
    # weights make the rollout chaotic once a near-tie flips an argmax, so
    # frames are held only before each row's first flip (scripts/parity_tpu.py).
    m32, _ = build_models(torch.float32)
    yk, ak, _ = decode_kernel.make_fused_decoder(m32, T)(text_d, spk_d)
    yp, ap, _ = make_decoder(m32, T)(text_d, spk_d)
    ons = onsets(ak, ap)
    mel_err, att_err = before_onset(yk, ak, yp, ap, ons)
    log(f"[K1] f32 B=64 N=100 T={T}: per-row divergence onset {ons}; before onset mel "
        f"max|d| {mel_err:.3g}, attention max|d| {att_err:.3g} (gates 1e-3, onset >= 32)")
    gate(min(ons) >= 32, ons)
    gate(mel_err <= 1e-3 and att_err <= 1e-3, (mel_err, att_err))
    del m32, yk, ak, yp, ap

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
    yq, aq, _ = decode_kernel.decode_plain(decode_kernel.pack_decode_weights(mbf), K, V, s1, s2,
                                           n_frames=T, freq_bins=cfg.mel.freq_bins)
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
    del K, V, s1, s2, yk, ak, yq, aq, yp, ap
    k1_ms = cuda_ms(lambda: fused_bf(text_d, spk_d), reps=2)
    k1_plain = cuda_ms(lambda: plain_bf(text_d, spk_d), reps=1)
    log(f"[K1] bf16 B=64 N=100 T=325 decode (incl. text encoder): kernel {k1_ms:.3f} ms, "
        f"plain eager {k1_plain:.3f} ms")
    kernels["decode"] = dict(
        name="decode", route="cuda", source="spoofsv_torch/csrc/decode.cu",
        replaces="spoofsv_tpu/ops/pallas_decode.py:144", max_abs_err=mel_err, ms=k1_ms,
        plain_ms=k1_plain)

    # ---- phase 5: the main path ----------------------------------------------
    syn = Synthesizer(cfg, mbf, sbf, n_frames=cfg.max_frame_num,
                      gl_iters=cfg.tpu.griffin_lim_iters)
    counters = {"decode": decode_kernel.decode_kernel, "gl_init": gl_kernel.init_kernel,
                "griffin_lim": gl_kernel.gl_kernel}

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
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, mel, attn = syn(texts, spk)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    B, L = audio.shape
    log(f"[main] launches {launches}; audio {tuple(audio.shape)}; first call {first_s:.3f} s")
    gate(all(n > 0 for n in launches.values()), launches)
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
    for k, n in launches.items():
        kernels[k]["launches"] = n
    del mbf, sbf, syn, staged, fused_bf, plain_bf, audio, mel, attn

    # small f32 end-to-end: the CUDA path against the CPU (plain) path
    tiny = dataclasses.replace(cfg.tpu, griffin_lim_iters=4)
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
    highway_kernel_phase(dev, cuda_ms, kernels)
    log(f"[time] phase 6 {time.perf_counter() - t0:.1f} s")

    # ---- phase 7: the ordinary training path at full width --------------------
    counters.update({"highway_gate": gate_kernel.gate_kernel,
                     "highway_conv": hconv_kernel.hconv_kernel,
                     "highway_conv_pair": hconv_kernel.hconv_pair_kernel})
    t0 = time.perf_counter()
    hw_launches, step_ms = training_phase(cfg, dev, counters, B=16, N=186, T=325)
    log(f"[time] phase 7 {time.perf_counter() - t0:.1f} s")
    for k, v in hw_launches.items():
        kernels[k]["launches"] = v
    log(f"[train] step ms per impl, B=16 N=186 T=325 f32 (median of iterations 2-5): "
        f"{step_ms} on [{smi}]")

    out = {"kernels": list(kernels.values())}
    log(json.dumps(out))
    log(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
