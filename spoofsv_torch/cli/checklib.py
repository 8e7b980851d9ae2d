"""Helpers of the post-campaign checks (``cli/gl_init_check.py`` and its kin).

The port's copy of what ``scripts/parity_tpu.py`` and ``scripts/exp_gl_init.py``
share with the checks: the three synthetic magnitude distributions, the
spectral convergence, and the campaign's sentences and speaker embeddings
(``_campaign_setup``; ``_mk_melsyn``'s part is ``cli/main.py::build_models``);
and what ``gl_spsi_check.py`` and ``gl24_check.py`` share: re-scoring a spoof
set with the base campaign's trained systems, through
:class:`~spoofsv_torch.cli.campaign.Campaign`'s own stages. The checks
resolve trained checkpoints with
:func:`spoofsv_torch.cli.campaign.resolve_checkpoint`.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict

import numpy as np
import torch


def check_device(device=None) -> torch.device:
    """The checks' device: the card unless ``device="cpu"``, with TF32 off
    there (f32 means f32, as in ``campaign.main``)."""
    from spoofsv_torch import reference_precision, resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        reference_precision()
    return device


def merge_json(path: str, update: dict) -> dict:
    """Merge ``update`` into the JSON object at ``path`` (created with its
    directory when missing) and write it back; returns the merged object."""
    merged = {}
    if os.path.isfile(path):
        with open(path) as f:
            merged = json.load(f)
    merged.update(update)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)
    return merged


def mag_distributions(B: int, T: int, F: int, rng: np.random.Generator
                      ) -> Dict[str, np.ndarray]:
    """Three magnitude distributions: GL behaves differently on correlated
    speech-like spectra, white spectra, and sparse harmonic spectra."""
    # (a) speech-like: smooth in time and frequency (filtered noise)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    for ax, k in ((1, 9), (2, 15)):
        ker = np.ones(k) / k
        x = np.apply_along_axis(lambda v: np.convolve(v, ker, "same"), ax, x)
    speech = np.abs(x) + 0.05
    # (b) white: uniform random magnitudes
    white = rng.uniform(0.05, 1.0, size=(B, T, F)).astype(np.float32)
    # (c) harmonic: sparse comb structure with an envelope
    harm = np.full((B, T, F), 0.02, np.float32)
    for b in range(B):
        f0 = rng.integers(4, 12)
        for h in range(1, F // f0):
            harm[b, :, h * f0] = 1.0 / np.sqrt(h)
    harm *= (0.5 + 0.5 * np.sin(np.linspace(0, 6, T)))[None, :, None]
    return {"speech_like": speech, "white": white, "harmonic": harm}


def spectral_convergence(audio, mag, n_fft: int, hop: int) -> float:
    """Mean over the batch of ‖|STFT(audio)| − mag‖ / ‖mag‖ over the frames
    both have, the STFT an FFT (``exp_gl_init.py:73``; ``parity_tpu.py:88``
    computes the same as a DFT matmul, the TPU's route)."""
    from spoofsv_torch.dsp import torchdsp

    audio = torch.as_tensor(audio, dtype=torch.float32)
    mag = torch.as_tensor(mag, dtype=torch.float32).to(audio.device)
    re, im = torchdsp.stft_ri(audio, n_fft, hop)
    s = torch.sqrt(re * re + im * im)
    m = mag[:, : s.shape[1], :]
    s = s[:, : m.shape[1], :]
    num = torch.linalg.norm((s - m).reshape(s.shape[0], -1), dim=1)
    den = torch.linalg.norm(m.reshape(m.shape[0], -1), dim=1)
    return float(torch.mean(num / den.clamp_min(1e-9)))


def campaign_setup(B: int, root: str):
    """The campaign's ``config.json``, three sentence distributions of ``B``
    corpus transcripts each (short, median, long) as (B, max_text_len) ids,
    and ``B`` speaker embeddings (B, spk_emb_dim) f32, as
    ``parity_tpu.py::_campaign_setup`` picks them; the trained Text2Mel is
    ``cfg.inference_text2mel_model``."""
    from spoofsv_torch.config import Config
    from spoofsv_torch.data.text import encode_texts

    with open(os.path.join(root, "config.json")) as f:
        cfg = Config.from_reference_dict(json.load(f))
    txts = sorted(glob.glob(os.path.join(cfg.data_root_dir, "txt", "*", "*.txt")))
    if not txts:
        raise FileNotFoundError(f"no corpus transcripts under {cfg.data_root_dir}")
    sents = []
    for p in txts[:: max(1, len(txts) // (3 * B))]:
        with open(p) as f:
            sents.append(f.read().strip())
    sents.sort(key=len)
    dists = {
        "short_sentences": sents[:B],
        "median_sentences": sents[len(sents) // 2: len(sents) // 2 + B],
        "long_sentences": sents[-B:],
    }
    text_dists = {k: encode_texts(v, cfg.vocabulary, cfg.max_text_len) for k, v in dists.items()}
    embs = sorted(glob.glob(os.path.join(cfg.spk_emb_dir, "*.npy")))
    spk = np.stack([np.load(embs[i % len(embs)]).astype(np.float32) for i in range(B)])
    return cfg, text_dists, spk


# -- re-scoring a spoof set with the base campaign's trained systems ---------
# (gl_spsi_check.py and gl24_check.py)

BASE_NEEDS = ("synthesize", "ge2e", "ivector", "cm")


def campaign_check(argv, device, root_env: bool = False):
    """A :class:`~spoofsv_torch.cli.campaign.Campaign` from the campaign's
    own flags (``campaign.build_parser()``), on the check's device. The JAX
    checks hand ``campaign.py`` only the root, so they score with the
    campaign's default depth; the port's take every depth flag, and with
    none given behave as the JAX scripts do. ``root_env``: the root
    defaults to ``$SPOOFSV_CAMPAIGN_ROOT`` when that is set
    (``gl_spsi_check.py``'s rule). Raises when a base stage is missing."""
    from spoofsv_torch.cli import campaign

    ps = campaign.build_parser()
    if root_env and os.environ.get("SPOOFSV_CAMPAIGN_ROOT"):
        ps.set_defaults(root=os.environ["SPOOFSV_CAMPAIGN_ROOT"])
    c = campaign.Campaign(ps.parse_args(argv), check_device(device))
    for req in BASE_NEEDS:
        if not os.path.exists(c.marker(req)):
            raise RuntimeError(f"base campaign stage '{req}' must be done first")
    return c


def config_variant(c, name: str, tpu: dict) -> str:
    """``<root>/<name>``: the campaign's ``config.json`` with the ``TPU``
    fields ``tpu`` set; returns its path."""
    with open(c.cfg_path) as f:
        d = json.load(f)
    d.setdefault("TPU", {}).update(tpu)
    path = os.path.join(c.root, name)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)
    return path


def rescore(c, tag: str, cfg_path: str, extra: str, out: dict) -> dict:
    """The spoof set ``tag`` from the same trained ordinary TTS under
    ``cfg_path`` (unless its wavs exist), then the same trained GE2E,
    i-vector models (scoring only) and CM on it: ``out``'s ``spoofgen``
    (when generated), ``ge2e``, ``ivector`` and ``cm``."""
    marker = os.path.join(c.root, "test", tag)
    if not glob.glob(os.path.join(marker, "spoof_data", "*", "*.wav")):
        out["spoofgen"] = c.stage_spoofgen(tag=tag, cfg_path=cfg_path)
        print(f"[{tag}] spoofgen done", flush=True)
    ge2e = c.ge2e_config(tag=tag, extra=extra)
    c._ge2e_preprocess(ge2e)
    with open(c.marker("ge2e")) as f:
        ck = json.load(f)["checkpoint"]
    res = c._ge2e_evaluate(ge2e, tag, ck)
    res.pop("checkpoint")    # the JAX checks record the evaluation's result alone
    out["ge2e"] = res
    print(f"[{tag}] ge2e done", flush=True)
    out["ivector"] = c._ivector(tag)
    print(f"[{tag}] ivector done", flush=True)
    out["cm"] = c._score_cm(tag)
    print(f"[{tag}] cm done", flush=True)
    return out


def base_summary(c) -> dict:
    """The base campaign's EERs, threshold and spoof rates, from its markers."""
    base = {}
    for k in ("ge2e", "ivector", "cm"):
        with open(c.marker(k)) as f:
            base[k] = json.load(f)
    return {
        "ge2e": {k: base["ge2e"][k] for k in
                 ("EER", "clean_threshold", "spoof_rate", "spoof_rate_at_eer", "gt_FRR")},
        "ivector": {k: base["ivector"][k] for k in ("mixed_eer", "clean_eer", "spoof_rate")},
        "cm": {k: base["cm"][k] for k in ("cm_eer",)},
    }
