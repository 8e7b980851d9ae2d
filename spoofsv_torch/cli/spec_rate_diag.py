"""``python -m spoofsv_torch.cli.spec_rate_diag --config <root>/config.json``: speculative rates.

Port of ``scripts/spec_rate_diag.py``: why does speculative serving
escalate? Every (campaign text × speaker embedding) pair is decoded once at
a full ``--n_frames`` rollout (``Synthesizer``, batches of ``--batch``, the
last padded with copies of its first row) on the trained checkpoints named
by the configuration, and each pair's completion frame is read from the
attention argmax: the first frame whose attended position reaches the last
text position less ``--spec_margin``, the criterion ``serve.py``'s
speculative path checks. The decode is causal, so done by frame f in a long
rollout is done in a rollout of f frames: one sweep predicts the escalation
rate of any bucket ladder. The summary is one JSON line with the JAX
script's keys: the frames a character over the pairs, the arm-C policy's
implied escalation rate (buckets 48/96/160, 2.5 frames a character, at
least 24), and the never-completed rate at margins 0-5.

On the card the decode is kernel K1 in the inference dtype (bf16) and the
vocoder K2 and K3; unless :func:`main` is given ``device="cpu"``, which takes
their plain versions in f32. The "random" GL init's seeds come from
``torch.Generator().manual_seed(lo)``, batch by batch, not jax's PRNG.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from spoofsv_torch.cli import checklib


def main(argv=None, device=None) -> dict:
    """Run the sweep on ``device`` (the card unless ``device="cpu"``);
    prints and returns the one-line summary."""
    ps = argparse.ArgumentParser(description="speculative-serving completion sweep")
    ps.add_argument("--config", type=str, required=True)
    ps.add_argument("--n_frames", type=int, default=160)
    ps.add_argument("--batch", type=int, default=64)
    ps.add_argument("--spec_margin", type=int, default=1)
    ps.add_argument("--out", type=str, default=None)
    args = ps.parse_args(argv)
    device = checklib.check_device(device)

    from spoofsv_torch.cli.main import apply_runtime_knobs, build_models, inference_dtype
    from spoofsv_torch.config import load_config
    from spoofsv_torch.data.text import encode_texts
    from spoofsv_torch.infer.synthesize import Synthesizer, gl_seeds
    from spoofsv_torch.weights import load_generator_params

    cfg = load_config(args.config)
    apply_runtime_knobs(cfg, infer=True)
    melsyn, ssrn, _, _ = build_models(cfg, "conditional", dtype=inference_dtype(cfg, device),
                                      device=device)
    load_generator_params(cfg.inference_text2mel_model, melsyn)
    load_generator_params(cfg.inference_ssrn_model, ssrn)
    syn = Synthesizer(cfg, melsyn, ssrn, n_frames=args.n_frames)

    with open(os.path.join(os.path.dirname(args.config), "texts.txt")) as f:
        texts = [ln.strip() for ln in f if ln.strip()]
    ids = encode_texts(texts, cfg.vocabulary, max_len=cfg.max_text_len)
    n_valid = (ids > 0).sum(axis=1).astype(np.int32)
    spk_files = sorted(os.listdir(cfg.spk_emb_dir))
    embs = np.stack([np.load(os.path.join(cfg.spk_emb_dir, f))
                     for f in spk_files]).astype(np.float32)

    # all pairs, decoded in fixed-size batches
    pair_t, pair_s = np.meshgrid(np.arange(len(texts)), np.arange(len(embs)), indexing="ij")
    pair_t, pair_s = pair_t.ravel(), pair_s.ravel()
    comp = np.full(len(pair_t), -1, np.int32)   # completion frame (or -1)
    all_pos = []                                # furthest attended position
    for lo in range(0, len(pair_t), args.batch):
        sel = slice(lo, min(lo + args.batch, len(pair_t)))
        ti, si = pair_t[sel], pair_s[sel]
        pad = args.batch - len(ti)
        tb = np.concatenate([ids[ti], ids[ti[:1]].repeat(pad, 0)])
        sb = np.concatenate([embs[si], embs[si[:1]].repeat(pad, 0)])
        seeds = gl_seeds(args.batch, torch.Generator().manual_seed(lo))
        _, _, attn = syn.device_call(tb, sb, seeds)   # the attention alone
        # attn: (B, N_text, F); furthest attended position per frame
        pos = attn.argmax(dim=1).cpu().numpy()[:len(ti)]
        all_pos.append(pos)
        tgt = (n_valid[ti] - 1 - args.spec_margin)[:, None]
        done = pos >= tgt
        any_done = done.any(axis=1)
        comp[sel] = np.where(any_done, done.argmax(axis=1) + 1, -1)
        print(f"[spec_rate_diag] {sel.stop}/{len(pair_t)} decoded", flush=True)

    chars = n_valid[pair_t].astype(np.float64)
    fin = comp > 0
    fpc = comp[fin] / chars[fin]
    # implied escalation under the arm-C policy (buckets 48/96/160, fpc 2.5,
    # min 24): the first rung's rollout must contain the completion frame
    buckets = np.array([48, 96, 160])
    est = np.maximum(24, np.ceil(2.5 * chars)).astype(int)
    rung = buckets[np.argmax(est[:, None] <= buckets[None, :], axis=1)]
    escal = (~fin) | (comp > rung)
    # spec_margin sensitivity: from the same attention paths, how many pairs
    # would never fire the completion check at looser margins?
    pos_all = np.concatenate(all_pos)           # (pairs, F)
    margin_sweep = {}
    for m in range(0, 6):
        never = ~(pos_all >= (n_valid[pair_t] - 1 - m)[:, None]).any(axis=1)
        margin_sweep[m] = round(float(never.mean()), 3)
    per_spk = {}
    for s, f in zip(pair_s[fin], fpc):
        per_spk.setdefault(int(s), []).append(float(f))
    spk_mean = {spk_files[k]: round(float(np.mean(v)), 2) for k, v in sorted(per_spk.items())}
    out = {
        "metric": "real_speaker_frames_per_char",
        "value": round(float(np.median(fpc)), 2),
        "unit": "frames/char",
        "detail": {
            "n_pairs": int(len(pair_t)),
            "n_never_completed_at_160": int((~fin).sum()),
            "fpc_p10": round(float(np.percentile(fpc, 10)), 2),
            "fpc_p50": round(float(np.percentile(fpc, 50)), 2),
            "fpc_p90": round(float(np.percentile(fpc, 90)), 2),
            "fpc_max": round(float(fpc.max()), 2),
            "implied_escalation_rate_armC": round(float(escal.mean()), 3),
            "never_completed_rate_by_margin": margin_sweep,
            "per_speaker_mean_fpc_min": min(spk_mean.values()),
            "per_speaker_mean_fpc_max": max(spk_mean.values()),
            "spec_margin": args.spec_margin,
            "n_frames": args.n_frames,
            "backend": device.type,
        },
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
