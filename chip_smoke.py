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
     comparison of the CUDA path against the CPU path.
Prints the card line and a kernels JSON line, then the ``{"ok": true, ...}``
line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    from spoofsv_torch.ops import _build, decode_kernel, gl_kernel

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

    out = {"kernels": list(kernels.values())}
    log(json.dumps(out))
    log(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
