"""``python -m spoofsv_torch.cli.vad_ab [--root DIR] [--utts 60] [--ge2e_ck PATH]``: the VAD A/B.

Port of ``scripts/vad_ab.py``: the WebRTC-transcription detector (the
default) against the energy detector, on ``--utts`` corpus wavs drawn with
``default_rng(0)`` from ``<root>/corpus/wav48``. In the reference the VAD
feeds one consumer, the d-vector creator (``dvector_create.py:92``), so the
A/B surface is that pipeline's: segments, voiced seconds, 0.4 s chunks,
utterances with nothing voiced and the voiced masks' IoU, under four
conditions: the clean wavs, additive noise at 5 dB SNR, and the speech
between noise-only flanks and a mid-utterance gap at a quiet (−35 dB) and
a loud (−12 dB) floor (noise from ``default_rng(1)``, drawn in the JAX
script's order). These legs run on the host.

With ``--ge2e_ck`` (a GE2E checkpoint, or a directory whose last ``*.npz``
is taken; the campaign's is ``state/ge2e.json``'s ``"checkpoint"``), the
embedding leg: on the first 20 wavs, each detector's aligned segment
d-vectors (``spoofkit/dvector.py``) from the embedder at ``GE2EConfig()``'s
widths (``models/ge2e.py``), and the cosine of their means. The JAX script
pins that leg to the CPU; here it runs on the card unless :func:`main` is
given ``device="cpu"``. The result goes to ``<root>/state/VAD_AB.json`` (the
JAX script writes ``docs/``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from spoofsv_torch.cli import checklib
from spoofsv_torch.cli.campaign import REPO

SCOPE_NOTE = ("VAD feeds only the d-vector creator in the reference "
              "(dvector_create.py:92); GE2E EER/SR staging does not "
              "pass through it. The raw campaign corpus is voiced "
              "end-to-end, so both detectors saturate on it (IoU "
              "1.0 — the default flip is behavior-preserving "
              "there); the gapped legs insert noise-only flanks/"
              "gaps so the detectors must locate speech, which is "
              "where the fixed-point GMM and the energy heuristic "
              "genuinely differ.")


def run_condition(wavs, condition) -> dict:
    """A/B both classifiers over ``wavs``; ``condition(y, i)`` transforms
    each waveform (the identity for the clean corpus audio)."""
    from spoofsv_torch.dsp import host as dsp_host
    from spoofsv_torch.spoofkit.vad import vad_chunk, vad_collector

    stats = {c: {"segments": 0, "voiced_s": 0.0, "chunks": 0, "utts_empty": 0}
             for c in ("webrtc", "energy")}
    span_agreement = []
    for i, path in enumerate(wavs):
        y, sr = dsp_host.load_wav(path, sr=16000)
        y = condition(y, i)
        masks = {}
        for c in ("webrtc", "energy"):
            segs = vad_collector(y, sr, classifier=c)
            chunks, _ = vad_chunk(y, sr, classifier=c)
            st = stats[c]
            st["segments"] += len(segs)
            st["voiced_s"] += sum((e - s) for s, e in segs) / sr
            st["chunks"] += len(chunks)
            st["utts_empty"] += not segs
            m = np.zeros(len(y), bool)
            for s, e in segs:
                m[s:e] = True
            masks[c] = m
        inter = float(np.sum(masks["webrtc"] & masks["energy"]))
        union = float(np.sum(masks["webrtc"] | masks["energy"]))
        span_agreement.append(inter / union if union else 1.0)
    return {
        "per_classifier": {
            c: {"segments": s["segments"], "voiced_s": round(s["voiced_s"], 1),
                "chunks_0p4s": s["chunks"], "utts_with_no_voiced": s["utts_empty"]}
            for c, s in stats.items()},
        "voiced_mask_iou_mean": round(float(np.mean(span_agreement)), 4),
        "voiced_mask_iou_min": round(float(np.min(span_agreement)), 4),
    }


def embedding_leg(wavs, ge2e_ck: str, device) -> dict:
    """Each detector's mean aligned d-vector an utterance, and their cosine."""
    import torch

    from spoofsv_torch.config import GE2EConfig
    from spoofsv_torch.dsp import host as dsp_host
    from spoofsv_torch.models.ge2e import SpeechEmbedder
    from spoofsv_torch.spoofkit.dvector import align_embeddings, concat_segs, get_stfts
    from spoofsv_torch.spoofkit.vad import vad_chunk
    from spoofsv_torch.weights import load_ge2e_params

    ge2e = GE2EConfig()
    emb = SpeechEmbedder(hidden=ge2e.model.hidden, num_layers=ge2e.model.num_layer,
                         proj=ge2e.model.proj)
    ck = ge2e_ck
    if os.path.isdir(ck):
        cands = sorted(glob.glob(os.path.join(ck, "*.npz")))
        if not cands:
            raise FileNotFoundError(f"no .npz under {ck}")
        ck = cands[-1]
    load_ge2e_params(ck, emb)
    emb = emb.to(device).eval()
    sims, counts = [], {"webrtc": 0, "energy": 0}
    for path in wavs[:20]:
        y, sr = dsp_host.load_wav(path, sr=16000)
        means = {}
        for c in ("webrtc", "energy"):
            chunks, spans = vad_chunk(y, sr, classifier=c)
            if not chunks:
                continue
            segs, _ = concat_segs(spans, chunks)
            windows = get_stfts(segs, ge2e)
            if not windows:
                continue
            with torch.no_grad():
                e = emb(torch.from_numpy(np.stack(windows)).to(device)).float().cpu().numpy()
            aligned = align_embeddings(e)
            counts[c] += len(aligned)
            means[c] = aligned.mean(axis=0)
        if len(means) == 2:
            a, b = means["webrtc"], means["energy"]
            sims.append(float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))))
    return {
        "ge2e_ck": ge2e_ck,
        "aligned_counts": counts,
        "n_compared": len(sims),
        "mean_dvector_cos_mean": round(float(np.mean(sims)), 4) if sims else None,
        "mean_dvector_cos_min": round(float(np.min(sims)), 4) if sims else None,
    }


def main(argv=None, device=None) -> dict:
    """Run the A/B (the embedding leg on ``device``: the card unless
    ``device="cpu"``); returns what it writes to ``state/VAD_AB.json``."""
    ps = argparse.ArgumentParser(description="WebRTC vs energy VAD A/B")
    ps.add_argument("--root", default=os.path.join(REPO, "_campaign_r5"))
    ps.add_argument("--utts", type=int, default=60)
    ps.add_argument("--ge2e_ck", default=None,
                    help="trained GE2E checkpoint (or a directory of .npz); adds an "
                         "embedding-level comparison")
    args = ps.parse_args(argv)
    device = checklib.check_device(device)

    wavs = sorted(glob.glob(os.path.join(args.root, "corpus", "wav48", "*", "*.wav")))
    if not wavs:
        raise FileNotFoundError(f"no corpus wavs under {args.root}")
    rng = np.random.default_rng(0)
    wavs = [wavs[i] for i in rng.choice(len(wavs), min(args.utts, len(wavs)), replace=False)]

    noise_rng = np.random.default_rng(1)

    def add_noise(y, i, snr_db=5.0):
        sig = float(np.sqrt(np.mean(y ** 2) + 1e-12))
        n = noise_rng.normal(size=len(y)).astype(np.float32)
        n *= sig / 10 ** (snr_db / 20) / float(np.sqrt(np.mean(n ** 2)))
        return (y + n).astype(np.float32)

    def gapped(noise_rel_db):
        """1 s noise-only flanks and a mid-utterance noise gap around the
        speech: the detectors must locate speech here."""
        def f(y, i):
            sig = float(np.sqrt(np.mean(y ** 2) + 1e-12))
            amp = sig * 10 ** (noise_rel_db / 20)

            def noise(n_samp):
                return (amp * noise_rng.normal(size=n_samp)).astype(np.float32)

            half = len(y) // 2
            return np.concatenate([noise(16000), y[:half], noise(8000), y[half:], noise(16000)])
        return f

    art = {
        "n_utts": len(wavs),
        "corpus": os.path.join(args.root, "corpus"),
        "clean": run_condition(wavs, lambda y, i: y),
        "noisy_5db_snr": run_condition(wavs, add_noise),
        "gapped_quiet_floor": run_condition(wavs, gapped(-35.0)),
        "gapped_loud_floor": run_condition(wavs, gapped(-12.0)),
        "scope_note": SCOPE_NOTE,
    }
    if args.ge2e_ck:
        art["embedding_leg"] = embedding_leg(wavs, args.ge2e_ck, device)

    out = os.path.join(args.root, "state", "VAD_AB.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(art, indent=1))
    print(f"[vad_ab] wrote {out}")
    return art


if __name__ == "__main__":
    main()
