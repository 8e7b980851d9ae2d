"""Mel-cepstral distortion (MCD), the objective TTS quality metric.

Numpy copy of :mod:`spoofsv_tpu.spoofkit.mcd` (importing ``spoofsv_tpu``
loads jax); ``synthesize --mcd`` reports it. Mel-cepstra are the orthonormal
DCT-II of the log mel spectrogram (the (T, 80) features de-normalized by
inverting the ``^analysis_power`` compression), coefficients 1..K (c0, the
energy, excluded), and

    MCD(t) = (10 / ln 10) * sqrt(2 * sum_k (c_ref[t,k] - c_syn[t,k])^2)   [dB]

averaged over DTW-aligned frames (free decoding drifts in time);
``align="frame"`` pairs frames as they are.
"""

from __future__ import annotations

from typing import Literal, Tuple

import numpy as np

# -60 dB below the (per-utterance max-normalized) peak. Hard-zero mel bins —
# common in sparse/synthetic spectra — otherwise dominate the cepstra: with a
# 1e-5 floor the campaign corpus measured GT-vs-other-GT at 159 dB and
# cepstral stds of ~9/coefficient, i.e. the floor, not the speech, carried
# the distance.
_LOG_FLOOR = 1e-3
_MCD_CONST = 10.0 / np.log(10.0)


def mel_cepstra(mel: np.ndarray, n_coef: int = 13,
                analysis_power: float = 0.6) -> np.ndarray:
    """(T, n_mels) normalized mel → (T, n_coef) cepstra (c1..c_n_coef).

    ``analysis_power``: the feature pipeline stores ``mel_norm^power``
    (``data/dataset.py:107-112``); invert it before the log.
    """
    from scipy.fftpack import dct

    m = np.asarray(mel, np.float64)
    if analysis_power and analysis_power != 1.0:
        m = np.power(np.maximum(m, 0.0), 1.0 / analysis_power)
    logm = np.log(np.maximum(m, _LOG_FLOOR))
    ceps = dct(logm, type=2, axis=-1, norm="ortho")
    return ceps[:, 1: n_coef + 1]


def dtw_path(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric DTW over euclidean frame distances; returns index arrays
    (path_x, path_y) of equal length."""
    tx, ty = len(x), len(y)
    # pairwise distances (tx, ty)
    d = np.sqrt(np.maximum(
        (x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :]
        - 2.0 * (x @ y.T), 0.0))
    acc = np.full((tx + 1, ty + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, tx + 1):
        # vectorized inner loop would break the row dependency; ty ≲ 1300
        row = acc[i - 1]
        cur = acc[i]
        for j in range(1, ty + 1):
            cur[j] = d[i - 1, j - 1] + min(row[j], row[j - 1], cur[j - 1])
    # backtrack
    i, j = tx, ty
    px, py = [], []
    while i > 0 and j > 0:
        px.append(i - 1)
        py.append(j - 1)
        moves = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(moves, key=lambda m: m[0])
    return np.asarray(px[::-1]), np.asarray(py[::-1])


def active_length(mel: np.ndarray, threshold: float = 0.02,
                  min_frames: int = 2) -> int:
    """Last frame whose peak mel magnitude exceeds ``threshold`` (features are
    per-utterance max-normalized to [0, 1]). A free-running AR decoder rolls
    out a fixed frame budget (infer: ``decode_frames``) and pads the tail with
    near-silence; aligning that tail against a trimmed reference dominates the
    distortion mean, so MCD trims it first."""
    peaks = np.asarray(mel).max(axis=-1)
    above = np.nonzero(peaks > threshold)[0]
    return max(min_frames, int(above[-1]) + 1) if len(above) else min_frames


def mcd(mel_ref: np.ndarray, mel_syn: np.ndarray, n_coef: int = 13,
        analysis_power: float = 0.6,
        align: Literal["dtw", "frame"] = "dtw",
        trim_syn_tail: bool = True) -> float:
    """MCD in dB between two (T, n_mels) normalized mel spectrograms.

    ``mel_ref`` is assumed already silence-trimmed (the feature pipeline trims
    at load); ``mel_syn``'s fixed-rollout silent tail is trimmed here unless
    ``trim_syn_tail=False``."""
    if trim_syn_tail:
        mel_syn = mel_syn[: active_length(mel_syn)]
    c_ref = mel_cepstra(mel_ref, n_coef, analysis_power)
    c_syn = mel_cepstra(mel_syn, n_coef, analysis_power)
    if align == "dtw":
        pi, pj = dtw_path(c_ref, c_syn)
        c_ref, c_syn = c_ref[pi], c_syn[pj]
    else:
        t = min(len(c_ref), len(c_syn))
        c_ref, c_syn = c_ref[:t], c_syn[:t]
    per_frame = _MCD_CONST * np.sqrt(2.0 * ((c_ref - c_syn) ** 2).sum(-1))
    return float(per_frame.mean())


def batch_mcd(mel_ref: np.ndarray, mel_syn: np.ndarray,
              lengths: np.ndarray | None = None, n_coef: int = 13,
              analysis_power: float = 0.6,
              align: Literal["dtw", "frame"] = "dtw") -> float:
    """Mean MCD over a (B, T, n_mels) batch; ``lengths`` masks ref padding."""
    vals = []
    for b in range(mel_ref.shape[0]):
        t = int(lengths[b]) if lengths is not None else mel_ref.shape[1]
        if t < 2:
            continue
        vals.append(mcd(mel_ref[b, :t], mel_syn[b], n_coef,
                        analysis_power, align))
    return float(np.mean(vals)) if vals else float("nan")
