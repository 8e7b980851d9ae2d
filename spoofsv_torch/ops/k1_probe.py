"""Developer tool for K1 (``csrc/decode_cluster.cu``) on one GPU.

    python3 -m spoofsv_torch.ops.k1_probe [--dtype bf16|f32] [--batches 64,128,256,512,768]
                                          [--frames 325] [--text 100]

Builds the source with ``-DSPOOFSV_K1_PROBE`` (``_build.VARIANTS``; the
product build carries none of this) and, on the shipping ``Config()`` at
full width with seed-0 random weights in ``--dtype`` (f32: the 3xTF32
instance), for each batch:

- times every plan of up to two waves (cluster 16, 8, 4, 2 × rows 16, 32,
  64) with CUDA events, beside the L2 bytes a frame it reads and the plan
  :func:`~spoofsv_torch.ops.decode_kernel.decode_cluster_plan` chooses;
- prints each cluster size's clusters per wave as the card reports them
  (``cudaOccupancyMaxActiveClusters``) against ``H100_CLUSTERS_PER_WAVE``;
- prints the default plan's phase profile: the clock of each phase in one
  CTA's warp 0, summed over the rollout (:data:`PHASES`).

It gates nothing and prints no result line; ``chip_smoke.py`` is the check.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from spoofsv_torch.ops import _build, decode_kernel as dk

# the profile's phases in the kernel's order (kPhases)
PHASES = ("chunk wait", "products", "row partials", "partials exchange", "norm", "scores",
          "slice exchange + taps", "attention", "product epilogue + barrier", "product entry",
          "tap copies issued")
SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
]


def _launch(lib, packed, ins, plan, stream, n_frames, freq_bins, prof=None):
    """One launch of the probe library (with the profile when ``prof`` is given)."""
    K = ins[0]
    plan, tensors, out = dk.cluster_launch_args(packed, *ins, n_frames, freq_bins, plan, stream)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    code = _build.DTYPE_CODES[K.dtype]
    shape = (plan.cluster, plan.rows, plan.tiles, n_frames, K.shape[1], freq_bins, plan.fpad,
             K.shape[2], 1, plan.chunk_bytes, plan.stages, _build.stream_ptr(K.device))
    if prof is None:
        err = lib.spoofsv_decode_cluster_launch(code, ptrs, *shape)
    else:
        err = lib.spoofsv_decode_cluster_probe_launch(code, ptrs, prof.data_ptr(), *shape)
    _build.check(lib, "decode_cluster", err, "decode_cluster_kernel (probe build)")
    return out


def _ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    parser.add_argument("--batches", default="64,128,256,512,768")
    parser.add_argument("--frames", type=int, default=325)
    parser.add_argument("--text", type=int, default=100, help="text ids an utterance")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe needs a CUDA device")
    from spoofsv_torch.config import Config
    from spoofsv_torch.data.text import encode_texts
    from spoofsv_torch.models import MelSyn

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[probe] card {smi}", flush=True)
    lib = _build.load("decode_cluster_probe")
    info = _build.BUILD_LOG["decode_cluster_probe"]
    print(f"[probe] build {info.get('seconds', 0.0):.1f} s", flush=True)
    for ln in info.get("ptxas", []):
        print(f"[probe] ptxas: {ln.strip()}", flush=True)

    cfg, T = Config(), args.frames
    F, C = cfg.mel.freq_bins, cfg.hidden_dim
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    elem, code = dtype.itemsize, _build.DTYPE_CODES[dtype]
    torch.manual_seed(0)
    model = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, F,
                   C).to(dev, dtype).eval()
    packed = dk.pack_decode_weights(model)
    mats = {k: packed[k] for k in dk.MATRIX_NAMES}
    streams = {}
    for n in (16, 8, 4, 2):
        try:
            plan = dk.decode_cluster_plan(16, C, F, cluster=n, rows=16, elem=elem)
        except ValueError as e:
            print(f"[probe] {args.dtype} cluster {n}: {e}", flush=True)
            continue
        streams[n] = dk.pack_decode_stream(mats, plan)
        active = lib.spoofsv_decode_cluster_max_active(code, C, plan.fpad, n, 16,
                                                       plan.chunk_bytes, plan.stages)
        print(f"[probe] {args.dtype} cluster {n}: {active} clusters at once on the card, "
              f"H100_CLUSTERS_PER_WAVE {dk.H100_CLUSTERS_PER_WAVE[n]}", flush=True)

    for B in [int(b) for b in args.batches.split(",")]:
        rng = np.random.default_rng(0)
        if args.text == 100:
            texts = encode_texts([SENTENCES[i % len(SENTENCES)] for i in range(B)],
                                 cfg.vocabulary, max_len=100)
        else:   # random ids, as the Trainer's validation batch of chip_smoke.py
            texts = rng.integers(1, cfg.vocab_len - 1, (B, args.text)).astype(np.int32)
        spk = rng.normal(size=(B, cfg.spk_emb_dim)).astype(np.float32)
        with torch.no_grad():
            K, V = model.encode_text(torch.from_numpy(texts).to(dev))
            sb = torch.from_numpy(spk).to(dev, dtype)
            ins = (K, V, model.audio_encoder.fc1(sb), model.audio_encoder.fc2(sb))
        default = dk.decode_cluster_plan(B, C, F, elem=elem)
        for rows in (16, 32, 64):
            for n in (16, 8, 4, 2):
                try:
                    plan = dk.decode_cluster_plan(B, C, F, cluster=n, rows=rows, elem=elem)
                except ValueError:
                    continue
                if plan.waves > 2 and plan != default:
                    continue
                ms = _ms(lambda: _launch(lib, packed, ins, plan, streams[n], T, F))
                print(f"[probe] {args.dtype} B={B} N={K.shape[1]} cluster {n} rows {rows}: "
                      f"{plan.tiles} tiles, {plan.waves} "
                      f"wave(s), {plan.stages} stages; {ms:.3f} ms = {1e3 * ms / T:.2f} us a "
                      f"frame; L2 {plan.l2_bytes_per_frame / 1e6:.2f} MB a frame"
                      f"{' (default plan)' if plan == default else ''} on [{smi}]", flush=True)
        prof = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
        _launch(lib, packed, ins, default, streams[default.cluster], T, F, prof)
        cyc = prof.cpu().numpy().astype(float)
        layers = T * len(dk.CLUSTER_LAYERS)
        print(f"[probe] {args.dtype} B={B} phase profile, plan {default.cluster}x{default.rows} "
              f"({cyc.sum() / T:.0f} cycles a frame): "
              + ", ".join(f"{k} {100 * v / cyc.sum():.1f} % ({v / layers:.0f} cycles a layer)"
                          for k, v in zip(PHASES, cyc)), flush=True)
        del K, V, ins


if __name__ == "__main__":
    main()
