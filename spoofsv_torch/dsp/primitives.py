"""Window helpers (numpy, host-precomputed).

Copies of :func:`spoofsv_tpu.dsp.primitives.hann_window`, ``pad_center`` and
``window_sumsquare`` (importing ``spoofsv_tpu.dsp`` loads jax).
"""

from __future__ import annotations

import numpy as np


def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic ("fftbins") Hann window, as scipy.signal.get_window('hann', N)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` samples (librosa.util.pad_center)."""
    n = len(window)
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))


def window_sumsquare(window: np.ndarray, n_frames: int, hop_length: int,
                     n_fft: int) -> np.ndarray:
    """Sum of squared, hop-shifted windows — ISTFT normalization denominator."""
    total = n_fft + hop_length * (n_frames - 1)
    out = np.zeros(total, dtype=np.float64)
    wsq = (pad_center(window, n_fft) ** 2).astype(np.float64)
    for i in range(n_frames):
        s = i * hop_length
        out[s: s + n_fft] += wsq
    return out
