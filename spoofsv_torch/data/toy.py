"""Synthetic learnable TTS corpus in the VCTK directory layout.

Copy of :mod:`spoofsv_tpu.data.toy` (importing it loads jax). Each character
maps to a fixed harmonic tone (speaker-scaled) and a sentence is its
characters' segments in a row, so text→audio alignment is monotonic and
learnable: a Text2Mel trained on it must develop monotonic attention, and
the whole pipeline (``prepare_vctk`` splits, features, bucketing, trainer,
decoder) runs on it unchanged. It is the corpus the tests and the card's
smoke run train on (VCTK is on neither machine).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host as dsp_host

CHAR_SECONDS = 0.093          # ≈ 2 coarse mel frames per character
BASE_FREQ = 170.0


def _char_freq(ch: str) -> float:
    """Deterministic per-character fundamental (0 = silence for space)."""
    if ch == " ":
        return 0.0
    return BASE_FREQ * (1.0 + 0.11 * max(0, ord(ch) - ord("a")))


def synth_sentence(text: str, sr: int, speaker_scale: float, rng: np.random.Generator,
                   harmonics: Optional[Sequence[float]] = None) -> np.ndarray:
    """Render a sentence: per-character harmonic tones under a Hann envelope.
    ``harmonics[h-1]`` weighs harmonic h (the speaker's timbre); the default
    is the 3-harmonic ``0.5/h`` profile."""
    if harmonics is None:
        harmonics = [0.5 / h for h in (1, 2, 3)]
    seg = int(CHAR_SECONDS * sr)
    env = np.hanning(seg).astype(np.float32)
    t = np.arange(seg) / sr
    out: List[np.ndarray] = []
    for ch in text:
        f = _char_freq(ch if ch.isalpha() or ch == " " else "z")
        if f <= 0:
            out.append(np.zeros(seg, np.float32))
            continue
        f = f * speaker_scale
        y = sum(w * np.sin(2 * np.pi * f * h * t + rng.uniform(0, 6))
                for h, w in enumerate(harmonics, start=1))
        out.append((y * env).astype(np.float32))
    sig = np.concatenate(out) if out else np.zeros(seg, np.float32)
    return 0.6 * sig / max(1e-6, np.abs(sig).max())


def random_sentence(rng: np.random.Generator, min_chars: int = 10, max_chars: int = 24) -> str:
    words = []
    total = 0
    target = int(rng.integers(min_chars, max_chars + 1))
    while total < target:
        w = "".join(chr(ord("a") + int(rng.integers(0, 26)))
                    for _ in range(int(rng.integers(2, 6))))
        words.append(w)
        total += len(w) + 1
    return " ".join(words)


def generate_toy_corpus(data_root: str, spk_emb_dir: str, n_speakers: int = 4,
                        utts_per_spk: int = 40, sr: int = 22050, spk_emb_dim: int = 200,
                        seed: int = 0, verbose: bool = False, min_chars: int = 10,
                        max_chars: int = 24, rich_speakers: bool = False) -> List[str]:
    """Write ``wav48/<spk>/*.wav``, ``txt/<spk>/*.txt`` and ``<spk_emb_dir>/<spk>.npy``
    (what :func:`spoofsv_torch.data.vctk.prepare_vctk` reads); returns the
    speaker names. ``rich_speakers=True`` gives each speaker a pitch scale in
    [0.8, 1.35] and a random 6-harmonic timbre instead of the ``0.85 + 0.12·k``
    pitch ladder (which aliases past ~5 speakers)."""
    rng = np.random.default_rng(seed)
    speakers = [f"p9{str(k).zfill(2)}" for k in range(n_speakers)]
    os.makedirs(spk_emb_dir, exist_ok=True)
    for k, spk in enumerate(speakers):
        wav_dir = os.path.join(data_root, "wav48", spk)
        txt_dir = os.path.join(data_root, "txt", spk)
        os.makedirs(wav_dir, exist_ok=True)
        os.makedirs(txt_dir, exist_ok=True)
        emb = rng.normal(size=(spk_emb_dim,)).astype(np.float32)
        np.save(os.path.join(spk_emb_dir, spk + ".npy"), emb)
        if rich_speakers:
            scale = float(0.8 + 0.55 * rng.random())
            harmonics = rng.uniform(0.08, 1.0, 6)
            harmonics = (harmonics / harmonics.sum()).tolist()
        else:
            scale = 0.85 + 0.12 * k
            harmonics = None
        for i in range(utts_per_spk):
            text = random_sentence(rng, min_chars, max_chars)
            y = synth_sentence(text, sr, scale, rng, harmonics=harmonics)
            stem = f"{spk}_{str(i + 1).zfill(3)}"
            dsp_host.write_wav(os.path.join(wav_dir, stem + ".wav"), y, sr)
            with open(os.path.join(txt_dir, stem + ".txt"), "w") as f:
                f.write(text + "\n")
        if verbose:
            print(f"[toy] wrote {utts_per_spk} utts for {spk}")
    return speakers


def toy_config(data_root: str, spk_emb_dir: str, work_dir: str, hidden_dim: int = 64,
               **overrides) -> Config:
    """A small-model Config wired to the toy corpus."""
    kw = dict(data_root_dir=data_root, spk_emb_dir=spk_emb_dir, src_root_dir=work_dir,
              hidden_dim=hidden_dim, text_emb_dim=32, ssrn_dim=hidden_dim, disc_dim=32,
              batch_size=16)
    kw.update(overrides)
    return Config().replace(**kw)


def attention_monotonicity(att: np.ndarray, text_len: int,
                           n_frames: Optional[int] = None) -> dict:
    """Alignment quality of one attention matrix ``(N_text, T_frames)``: the
    fraction of forward steps of its argmax path, the text coverage and the
    mean per-frame peak."""
    a = att[:text_len, :n_frames] if n_frames else att[:text_len]
    path = a.argmax(axis=0)
    steps = np.diff(path)
    forward = float(np.mean(steps >= 0)) if len(steps) else 1.0
    coverage = float(len(np.unique(path)) / text_len)
    confidence = float(a.max(axis=0).mean())
    return {"forward_frac": forward, "coverage": coverage, "confidence": confidence}
