"""Host-side (numpy) audio tail: silence trimming and wav output.

Copies of :func:`spoofsv_tpu.dsp.host.trim_silence` (librosa.effects.trim
semantics) and :func:`spoofsv_tpu.dsp.host.write_wav`; importing
``spoofsv_tpu.dsp`` loads jax.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _frame_count(n_samples: int, frame_length: int, hop_length: int) -> int:
    if n_samples < frame_length:
        return 0
    return 1 + (n_samples - frame_length) // hop_length


def _rms_db(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Framewise power in dB relative to the max frame (librosa trim internals)."""
    y = np.asarray(y, dtype=np.float32)
    padded = np.pad(y, frame_length // 2, mode="reflect") if len(y) > frame_length // 2 \
        else np.pad(y, frame_length // 2, mode="constant")
    n_frames = _frame_count(len(padded), frame_length, hop_length)
    if n_frames <= 0:
        return np.zeros((0,), dtype=np.float32)
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    power = np.mean(padded[idx].astype(np.float64) ** 2, axis=1)
    amin = 1e-10
    return (10.0 * np.log10(np.maximum(amin, power))
            - 10.0 * np.log10(np.maximum(amin, np.max(power))))


def trim_silence(y: np.ndarray, top_db: float, frame_length: int = 2048,
                 hop_length: int = 512) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Trim leading/trailing silence below ``top_db`` relative to peak power."""
    db = _rms_db(y, frame_length, hop_length)
    nonsilent = np.flatnonzero(db > -top_db)
    if len(nonsilent) == 0:
        return y[0:0], (0, 0)
    start = int(nonsilent[0] * hop_length)
    end = min(len(y), int((nonsilent[-1] + 1) * hop_length))
    return y[start:end], (start, end)


def write_wav(path, y: np.ndarray, sr: int) -> None:
    """Write float audio as 16-bit PCM wav to ``path`` (a file name or a
    binary file object)."""
    from scipy.io import wavfile

    y = np.asarray(y, dtype=np.float32)
    y = np.clip(y, -1.0, 1.0)
    wavfile.write(path, sr, (y * 32767.0).astype(np.int16))
