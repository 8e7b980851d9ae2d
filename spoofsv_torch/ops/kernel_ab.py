"""Time K1, K2 and K3 through their public wrappers, for an A/B of two trees on one GPU.

    python3 -m spoofsv_torch.ops.kernel_ab --tag NAME [--reps 3]

On the shipping ``Config()`` at full width with seed-0 random weights, with
CUDA events (after a warm-up call), it prints:

- K1 f32 (``decode_kernel.decode_fused``; the text encoder and speaker
  projections done once) at B=64, N=100, T=325 (the main path's shape) and
  at B=16, N=186, T=325 (the Trainer's validation shape), and K1 bf16 at
  the main path's shape;
- K2 (``gl_kernel.gl_init_angles``) at B=64, T=1300 on the magnitudes of
  harmonic test signals, in each init mode ("spsi", the main path's, then
  "advance" and "random", which only write), beside two references for the
  card's write rate: ``fill_`` of two planes of the same size and a
  ``copy_`` of the magnitudes;
- K3 (``gl_kernel.griffin_lim_tc``, 12 iterations from the SPSI angles)
  with int8 and with bf16 operands on the same magnitudes.

Each kernel's output is also checked run to run: ``--repeat`` calls on the
same inputs (after the timed ones) and whether all are bit-equal to the
first, with the largest difference (a kernel is a pure function of its
inputs; a race inside a launch shows here).

It uses only calls that earlier trees have too, so it can be copied into
another checkout's ``spoofsv_torch/ops/`` and run there: two trees compared
in one call on one card, in turns (A, B, B, A). A tree whose f32 decode
takes no cluster plan is given none. It gates nothing; ``chip_smoke.py`` is
the check.
"""

from __future__ import annotations

import argparse
import copy
import subprocess

import numpy as np
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.data.text import encode_texts
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.models import MelSyn
from spoofsv_torch.ops import decode_kernel as dk
from spoofsv_torch.ops import gl_kernel

SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
]
NFFT, HOP = 1024, 256


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _repeat(fn, n: int) -> str:
    """Whether ``n`` calls of ``fn`` (its first output) are bit-equal to the first call."""
    first = fn()
    first = first[0] if isinstance(first, tuple) else first
    worst = 0.0
    for _ in range(n - 1):
        out = fn()
        out = out[0] if isinstance(out, tuple) else out
        worst = max(worst, float((out.float() - first.float()).abs().max()))
    return f"{n} calls bit-equal: {worst == 0.0} (max|d| {worst:.6g})"


def _plan_and_stream(packed, B: int, C: int, F: int):
    """The f32 cluster plan and weight stream, or (None, None) in a tree whose
    f32 decode takes none."""
    try:
        plan = dk.decode_cluster_plan(B, C, F, elem=4)
    except TypeError:
        return None, None
    return plan, dk.pack_decode_stream({k: packed[k] for k in dk.MATRIX_NAMES}, plan)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="tree", help="label of this checkout in the output")
    ap.add_argument("--reps", type=int, default=3, help="K1 and K3 calls timed (K2: 20)")
    ap.add_argument("--repeat", type=int, default=6, help="calls compared run to run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    dev, tag = torch.device("cuda:0"), args.tag
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg, T = Config(), 325
    F, C = cfg.mel.freq_bins, cfg.hidden_dim
    torch.manual_seed(0)
    model = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, F, C).to(dev).eval()
    packed = dk.pack_decode_weights(model)
    rng = np.random.default_rng(0)
    shapes = {64: encode_texts([SENTENCES[i % len(SENTENCES)] for i in range(64)],
                               cfg.vocabulary, max_len=100),
              16: rng.integers(1, cfg.vocab_len - 1, (16, 186)).astype(np.int32)}
    for B, texts in shapes.items():
        spk = torch.from_numpy(rng.normal(size=(B, cfg.spk_emb_dim)).astype(np.float32)).to(dev)
        with torch.no_grad():
            K, V = model.encode_text(torch.from_numpy(texts).to(dev))
            ins = (K, V, model.audio_encoder.fc1(spk), model.audio_encoder.fc2(spk))
        plan, stream = _plan_and_stream(packed, B, C, F)
        ms = _ms(lambda: dk.decode_fused(packed, *ins, n_frames=T, freq_bins=F, plan=plan,
                                         stream=stream), args.reps)
        same = _repeat(lambda: dk.decode_fused(packed, *ins, n_frames=T, freq_bins=F, plan=plan,
                                               stream=stream), args.repeat)
        print(f"[{tag}] K1 f32 B={B} N={K.shape[1]} T={T}: {ms:.3f} ms (CUDA events, mean of "
              f"{args.reps}); plan {plan}; mel {same} on [{smi}]", flush=True)
        del K, V, ins, stream
    mbf = copy.deepcopy(model).to(torch.bfloat16)
    packed_bf = dk.pack_decode_weights(mbf)
    spk = torch.from_numpy(rng.normal(size=(64, cfg.spk_emb_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        K, V = mbf.encode_text(torch.from_numpy(shapes[64]).to(dev))
        spk = spk.to(torch.bfloat16)
        ins = (K, V, mbf.audio_encoder.fc1(spk), mbf.audio_encoder.fc2(spk))
    call = lambda: dk.decode_fused(packed_bf, *ins, n_frames=T, freq_bins=F)  # noqa: E731
    ms = _ms(call, args.reps)
    print(f"[{tag}] K1 bf16 B=64 N={K.shape[1]} T={T}: {ms:.3f} ms (CUDA events, mean of "
          f"{args.reps}); mel {_repeat(call, args.repeat)} on [{smi}]", flush=True)
    del K, V, ins, mbf, packed_bf

    L = HOP * (1300 - 1)
    t = np.arange(L) / 22050.0
    sigs = [sum(np.sin(2 * np.pi * 110.0 * (1 + b % 4) * k * t + rng.uniform(0, 6)) / k
                for k in range(1, 6)) + 0.1 * rng.normal(size=L) for b in range(64)]
    re, im = torchdsp.stft_ri(torch.from_numpy(np.stack(sigs) * np.hanning(L)).float().to(dev),
                              NFFT, HOP)
    mag = torch.sqrt(re * re + im * im)[:, :1300].contiguous()
    del re, im
    seeds = torch.arange(64, dtype=torch.int32, device=dev)
    for mode in ("spsi", "advance", "random"):
        ms = _ms(lambda: gl_kernel.gl_init_angles(mag, NFFT, HOP, mode, seeds), 20)
        print(f"[{tag}] K2 {mode} B=64 T=1300: {ms:.4f} ms (CUDA events, mean of 20) on [{smi}]",
              flush=True)
    planes, dst = (torch.empty_like(mag), torch.empty_like(mag)), torch.empty_like(mag)
    ms = _ms(lambda: [p.fill_(1.0) for p in planes], 20)
    print(f"[{tag}] fill_ of two {mag.numel() * 4 / 1e6:.1f} MB planes: {ms:.4f} ms; ", end="")
    print(f"copy_ of the magnitudes: {_ms(lambda: dst.copy_(mag), 20):.4f} ms", flush=True)
    del planes, dst
    init = gl_kernel.gl_init_angles(mag, NFFT, HOP, "spsi")
    for int8 in (True, False):
        call = lambda: gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=12,  # noqa: E731
                                                init_angles=init, int8=int8)
        ms = _ms(call, args.reps)
        print(f"[{tag}] K3 {'int8' if int8 else 'bf16'} GL12 B=64 T=1300: {ms:.3f} ms (CUDA "
              f"events, mean of {args.reps}); audio {_repeat(call, args.repeat)} on [{smi}]",
              flush=True)


if __name__ == "__main__":
    main()
