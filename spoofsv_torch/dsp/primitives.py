"""Windows and mel filterbanks (numpy, host-precomputed).

Copies of :mod:`spoofsv_tpu.dsp.primitives` (``hann_window``, ``pad_center``,
the Slaney mel scale ``hz_to_mel``/``mel_to_hz``, ``mel_filterbank``,
``frame_indices``, ``window_sumsquare``; importing ``spoofsv_tpu.dsp`` loads
jax). They reproduce librosa 0.7's helpers (Slaney scale, area norm,
periodic Hann), which the reference's features use.
"""

from __future__ import annotations

import functools

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


# Slaney mel scale (librosa htk=False default)
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(log_region,
                    _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    mels)


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = mel * _F_SP
    log_region = mel >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), freq)


@functools.lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape ``(n_mels, 1+n_fft//2)``
    (``librosa.filters.mel(sr, n_fft, n_mels)`` with ``htk=False, norm=1``).
    Cached: callers must not write to the array."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])   # Slaney area norm
    return (weights * enorm[:, None]).astype(np.float32)


def frame_indices(n_samples: int, frame_length: int, hop_length: int) -> int:
    """Number of frames produced by framing ``n_samples`` (no centering)."""
    if n_samples < frame_length:
        return 0
    return 1 + (n_samples - frame_length) // hop_length


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
