"""Host-side (numpy) DSP: audio I/O, trimming and the features.

Copies of :mod:`spoofsv_tpu.dsp.host` (importing ``spoofsv_tpu.dsp`` loads
jax): ``load_wav``/``write_wav``/``resample`` through scipy, ``load_flac``/
``write_flac`` through the native codec (:mod:`spoofsv_torch.spoofkit.flacio`),
``trim_silence`` and ``split_nonsilent`` (librosa.effects.trim/split
semantics), pre- and de-emphasis, ``amplitude_to_db``, the centered STFT,
``tts_features`` (the reference dataset's pipeline, ``data/dataset.py:94-118``),
and GE2E's features: ``mfccs_and_spec`` (``GE2E/utils.py:61-87``) and
``ge2e_logmel`` (``GE2E/data_preprocess.py:49-52``). This is host code in
both packages; ``--save_spectrogram`` caches the training features.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from spoofsv_torch.config import Config
from spoofsv_torch.dsp.primitives import frame_indices, hann_window, mel_filterbank, pad_center


def load_wav(path: str, sr: Optional[int] = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a wav (or FLAC) file → (float32 in [-1, 1], sample rate),
    resampled to ``sr`` when given and different."""
    from scipy.io import wavfile

    if path.lower().endswith(".flac"):
        return load_flac(path, sr=sr, mono=mono)
    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if mono and y.ndim > 1:
        y = y.mean(axis=1)
    if sr is not None and sr != rate:
        y = resample(y, rate, sr)
        rate = sr
    return y, rate


def write_wav(path, y: np.ndarray, sr: int) -> None:
    """Write float audio as 16-bit PCM wav to ``path`` (a file name or a
    binary file object)."""
    from scipy.io import wavfile

    y = np.asarray(y, dtype=np.float32)
    y = np.clip(y, -1.0, 1.0)
    wavfile.write(path, sr, (y * 32767.0).astype(np.int16))


def load_flac(path: str, sr: Optional[int] = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file with the native codec → (float32 in [-1, 1], rate)."""
    from spoofsv_torch.spoofkit.flacio import decode_flac

    y, rate = decode_flac(path)
    if mono and y.ndim > 1:
        y = y.mean(axis=1)
    if sr is not None and sr != rate:
        y = resample(y, rate, sr)
        rate = sr
    return y.astype(np.float32), rate


def write_flac(path: str, y: np.ndarray, sr: int) -> None:
    """Write float audio as 16-bit FLAC with the native codec (the format the
    reference stages for the anti-spoofing CM, ``generate_test_utterances.py:246-255``)."""
    from spoofsv_torch.spoofkit.flacio import encode_flac

    y = np.clip(np.asarray(y, dtype=np.float32), -1.0, 1.0)
    encode_flac(path, (y * 32767.0).astype(np.int32), sr)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy's Kaiser-windowed FIR)."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(orig_sr), int(target_sr))
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def _rms_db(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Framewise power in dB relative to the max frame (librosa trim internals)."""
    y = np.asarray(y, dtype=np.float32)
    padded = np.pad(y, frame_length // 2, mode="reflect") if len(y) > frame_length // 2 \
        else np.pad(y, frame_length // 2, mode="constant")
    n_frames = frame_indices(len(padded), frame_length, hop_length)
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


def split_nonsilent(y: np.ndarray, top_db: float = 30.0, frame_length: int = 2048,
                    hop_length: int = 512) -> np.ndarray:
    """Non-silent (start, end) sample intervals, (n, 2) int64
    (librosa.effects.split semantics, ``GE2E/synthetic_data_preprocess.py:36``)."""
    nonsilent = _rms_db(y, frame_length, hop_length) > -top_db
    intervals = []
    in_run, s = False, 0
    for i, v in enumerate(nonsilent):
        if v and not in_run:
            in_run, s = True, i
        elif not v and in_run:
            in_run = False
            intervals.append((s, i))
    if in_run:
        intervals.append((s, len(nonsilent)))
    return np.asarray([[int(a * hop_length), int(min(len(y), b * hop_length))]
                       for a, b in intervals], dtype=np.int64).reshape(-1, 2)


def amplitude_to_db(S: np.ndarray, amin: float = 1e-5, top_db: float = 80.0) -> np.ndarray:
    """librosa.amplitude_to_db(ref=1.0) semantics."""
    db = 20.0 * np.log10(np.maximum(amin, np.abs(S)))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db.astype(np.float32)


def mfccs_and_spec(y: np.ndarray, sr: int, n_fft: int, window_s: float, hop_s: float,
                   n_mels: int, tisv_frame: int, wav_process: bool = False,
                   calc_mfccs: bool = False):
    """(mfccs or None, mel_db (T, n_mels), mag_db (F, T)): the reference's
    on-the-fly GE2E features (``GE2E/utils.py:61-87``)."""
    win = int(window_s * sr)
    hop = int(hop_s * sr)
    if wav_process:
        y, _ = trim_silence(y, 60.0, frame_length=win, hop_length=hop)
        target = int(sr * (tisv_frame * hop_s + window_s))
        y = np.pad(y[:target], (0, max(0, target - len(y))))
    mag = np.abs(stft(y, n_fft, hop, win_length=win))
    mel = mel_filterbank(sr, n_fft, n_mels) @ mag
    mag_db = amplitude_to_db(mag)
    mel_db = amplitude_to_db(mel).T
    mfccs = None
    if calc_mfccs:
        from scipy.fftpack import dct

        mfccs = dct(mel_db.T, type=2, axis=0, norm="ortho")[:40].T
    return mfccs, mel_db.astype(np.float32), mag_db


def preemphasis(y: np.ndarray, coeff: float) -> np.ndarray:
    """First-difference pre-emphasis (``data/dataset.py:96``)."""
    return np.append(y[0], y[1:] - coeff * y[:-1]).astype(np.float32)


def deemphasis(y: np.ndarray, coeff: float) -> np.ndarray:
    """Inverse of :func:`preemphasis`, the IIR ``y[n] = x[n] + c·y[n-1]``."""
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coeff], y).astype(np.float32)


def stft(y: np.ndarray, n_fft: int, hop_length: int, win_length: Optional[int] = None,
         center: bool = True) -> np.ndarray:
    """Complex STFT, shape ``(1+n_fft//2, n_frames)`` (librosa layout)."""
    if win_length is None:
        win_length = n_fft
    window = pad_center(hann_window(win_length), n_fft).astype(np.float32)
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = frame_indices(len(y), n_fft, hop_length)
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    return np.fft.rfft(y[idx] * window[None, :], axis=1).T


def stft_mag(y: np.ndarray, n_fft: int, hop_length: int,
             win_length: Optional[int] = None) -> np.ndarray:
    return np.abs(stft(y, n_fft, hop_length, win_length)).astype(np.float32)


def tts_features(y: np.ndarray, sr: int, cfg: Config) -> Tuple[np.ndarray, np.ndarray]:
    """The reference feature pipeline → (coarse mel (Tr, M), lin (4·Tr, F)),
    time-major: trim (22 dB) → pre-emphasis → |STFT| → Slaney mel → per-utterance
    max-norm and power ``analysis_power`` (or the log-dB clip) → every r-th
    mel frame, lin cut to r·Tr frames."""
    y, _ = trim_silence(y, top_db=22.0)
    y = preemphasis(y, cfg.preemph)
    lin = stft_mag(y, cfg.stft.fft_length, cfg.stft.hop_length)     # (F, T)
    fb = mel_filterbank(sr, cfg.stft.fft_length, cfg.mel.freq_bins)  # (M, F)
    mel = fb @ lin                                                   # (M, T)
    if cfg.norm.log_feature:
        mel_db = 20.0 * np.log10(np.maximum(1e-5, mel))
        lin_db = 20.0 * np.log10(np.maximum(1e-5, lin))
        mel_n = np.clip((mel_db - cfg.norm.ref_db + cfg.norm.max_db) / cfg.norm.max_db, 1e-8, 1.0)
        lin_n = np.clip((lin_db - cfg.norm.ref_db + cfg.norm.max_db) / cfg.norm.max_db, 1e-8, 1.0)
    else:
        mel_n = (mel / np.max(mel)) ** cfg.norm.analysis_power
        lin_n = (lin / np.max(lin)) ** cfg.norm.analysis_power
    r = cfg.mel.reduction
    t_reduced = mel.shape[1] // r
    coarse = mel_n[:, : t_reduced * r: r]
    return coarse.T.astype(np.float32), lin_n[:, : t_reduced * r].T.astype(np.float32)


def ge2e_logmel(y: np.ndarray, sr: int, n_fft: int, window_s: float, hop_s: float,
                n_mels: int) -> np.ndarray:
    """GE2E's log10 mel power, (n_mels, T) (``GE2E/data_preprocess.py:49-52``):
    the power STFT (25 ms window, 10 ms hop), Slaney mel, ``log10(mel + 1e-6)``."""
    S = np.abs(stft(y, n_fft, int(hop_s * sr), win_length=int(window_s * sr))) ** 2
    return np.log10(mel_filterbank(sr, n_fft, n_mels) @ S + 1e-6).astype(np.float32)
