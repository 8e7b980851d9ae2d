"""Plain-torch reference of the Griffin-Lim vocoder and the host tail.

The published vocoder (``synthesize.py:134-147`` of the reference:
``librosa.griffinlim`` with momentum 0.99 and a periodic Hann window,
``center=True``) after the peak renorm and the power ``1.3/0.6``, from one
of three phase inits (random phases, by a seeded hash of frame, bin and
seed; each bin advanced by its centre frequency; SPSI), then de-emphasis.
Transforms are ``torch.fft`` in float32. ``Rounding`` rounds the operands of
every transform for a control: ``"int4"`` (a symmetric 4-bit grid scaled to
each frame's largest value) below an int8 configuration, ``"bf16"`` below a
float32 one. :func:`finalize` and :func:`pcm16_wav_samples` are the served
reply's host tail.

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Rounding:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "bf16", "int4"):
            raise ValueError(f"unknown rounding {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        if self.kind == "bf16":
            return x.to(torch.bfloat16).float()
        scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 7.0
        return torch.round(x / scale).clamp(-7, 7) * scale


EXACT = Rounding("f32")


def hann(n_fft: int, device) -> torch.Tensor:
    """Periodic Hann window, float32."""
    k = torch.arange(n_fft, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)).float()


def stft(y: torch.Tensor, n_fft: int, hop: int, r: Rounding = EXACT
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) → (re, im), each (B, T, n_fft//2 + 1), reflect-padded by n_fft/2."""
    y = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop) * hann(n_fft, y.device)
    spec = torch.fft.rfft(r(frames), dim=-1)
    return spec.real, spec.imag


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
          r: Rounding = EXACT) -> torch.Tensor:
    """(B, T, F) → (B, hop·(T−1)): overlap-add of windowed frames over the
    window's sum of squares, the n_fft/2 padding cut off. The DC and Nyquist
    bins of a real signal's spectrum are real."""
    B, T, nb = re.shape
    im = im.clone()
    im[..., 0] = 0.0
    im[..., nb - 1] = 0.0
    spec = torch.complex(r(re), r(im))
    w = hann(n_fft, re.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w
    length = n_fft + hop * (T - 1)
    y = F.fold(frames.transpose(1, 2), (1, length), (1, n_fft), stride=(1, hop))[:, 0, 0]
    wss = F.fold((w * w).expand(1, T, n_fft).transpose(1, 2), (1, length), (1, n_fft),
                 stride=(1, hop))[0, 0, 0]
    y = torch.where(wss > 1e-11, y / wss.clamp_min(1e-11), y)
    return y[:, n_fft // 2: length - n_fft // 2]


# ---- phase inits -------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_angles(seeds: torch.Tensor, T: int, nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random phases: φ = (h & 0xFFFFFF)·2π/2²⁴ with h a murmur3-style mix
    of (frame, bin, seed) in 32-bit arithmetic. (B,) → (cos, sin) (B, T, F)."""
    dev = seeds.device
    t = torch.arange(T, device=dev, dtype=torch.int64)[None, :, None]
    k = torch.arange(nb, device=dev, dtype=torch.int64)[None, None, :]
    s = seeds.to(torch.int64)[:, None, None] & _U32
    h = _mul32(t, 73856093) ^ _mul32(k, 19349663) ^ _mul32(s, 83492791)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    phase = (h & 0xFFFFFF).to(torch.float32) * np.float32(2.0 * np.pi / (1 << 24))
    return torch.cos(phase), torch.sin(phase)


def advance_angles(T: int, nb: int, n_fft: int, hop: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin k advanced by its centre frequency each hop: φ = 2π·hop·k·t/n_fft."""
    t = torch.arange(T, device=device)[:, None]
    k = torch.arange(nb, device=device)[None, :]
    phase = ((t * ((k * hop) % n_fft)) % n_fft).to(torch.float32) * np.float32(2 * np.pi / n_fft)
    return torch.cos(phase), torch.sin(phase)


def spsi_angles(mag: torch.Tensor, n_fft: int, hop: int, lock: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pass spectrogram inversion: the advance phase rotated by each
    bin's running instantaneous-frequency offset δ (the vertex of the
    parabola through the log magnitudes of bins k−1, k, k+1 where they are
    concave), plus the phase lock ``lock·πδ(n_fft−1)/n_fft``."""
    logm = torch.log(mag.clamp_min(1e-10))
    a = torch.cat([logm[..., :1], logm[..., :-1]], dim=-1)
    c = torch.cat([logm[..., 1:], logm[..., -1:]], dim=-1)
    denom = a - 2.0 * logm + c
    concave = denom < -1e-6
    delta = torch.where(concave, 0.5 * (a - c) / torch.where(concave, denom, -1.0), 0.0)
    delta = delta.clamp(-0.5, 0.5)
    cyc = (torch.cumsum(delta, dim=-2) - delta) * np.float32(hop / n_fft)
    frac = (cyc - torch.round(cyc)) * np.float32(2.0 * np.pi)
    frac = frac + delta * np.float32(lock * np.pi * (n_fft - 1) / n_fft)
    b_re, b_im = advance_angles(mag.shape[-2], mag.shape[-1], n_fft, hop, mag.device)
    c_f, s_f = torch.cos(frac), torch.sin(frac)
    return b_re * c_f - b_im * s_f, b_re * s_f + b_im * c_f


def init_angles(mag: torch.Tensor, mode: str, n_fft: int, hop: int,
                seeds: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, nb = mag.shape
    if mode == "random":
        return hash_angles(seeds.to(mag.device), T, nb)
    if mode == "advance":
        a_re, a_im = advance_angles(T, nb, n_fft, hop, mag.device)
        return a_re.expand(B, T, nb), a_im.expand(B, T, nb)
    if mode == "spsi":
        return spsi_angles(mag, n_fft, hop)
    raise ValueError(f"unknown init {mode!r}")


# ---- the vocoder ------------------------------------------------------------------

def griffin_lim(mag: torch.Tensor, angles: Tuple[torch.Tensor, torch.Tensor], n_fft: int,
                hop: int, n_iter: int, momentum: float = 0.99, r: Rounding = EXACT
                ) -> torch.Tensor:
    """librosa 0.7's ``griffinlim`` with momentum, batched: (B, T, F) → (B, hop·(T−1))."""
    ang_re, ang_im = angles
    ang_re, ang_im = ang_re.expand(mag.shape), ang_im.expand(mag.shape)
    prev_re = torch.zeros_like(mag)
    prev_im = torch.zeros_like(mag)
    alpha = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        y = istft(mag * ang_re, mag * ang_im, n_fft, hop, r)
        re, im = stft(y, n_fft, hop, r)
        a_re, a_im = re - alpha * prev_re, im - alpha * prev_im
        norm = torch.sqrt(a_re * a_re + a_im * a_im) + 1e-16
        ang_re, ang_im = a_re / norm, a_im / norm
        prev_re, prev_im = re, im
    return istft(mag * ang_re, mag * ang_im, n_fft, hop, r)


def deemphasis(x: np.ndarray, coeff: float) -> np.ndarray:
    """``y[n] = x[n] + c·y[n−1]`` along the last axis, in float64."""
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coeff], np.asarray(x, np.float64), axis=-1)


def vocode(lin: torch.Tensor, voc: dict, seeds: Optional[torch.Tensor],
           r: Rounding = EXACT, rows: int = 32) -> np.ndarray:
    """Linear magnitude (B, T, F) in (0, 1) → audio (B, hop·(T−1)) float64 on
    the host: per-utterance peak renorm, power, Griffin-Lim from ``voc``'s
    init and iterations, de-emphasis. ``rows`` utterances at a time."""
    n_fft, hop = voc["n_fft"], voc["hop"]
    out = []
    for i in range(0, lin.shape[0], rows):
        x = lin[i: i + rows].float()
        x = x / x.amax(dim=(1, 2), keepdim=True).clamp_min(1e-8)
        spec = torch.pow(x, voc["power"])
        ang = init_angles(spec, voc["init"], n_fft, hop,
                          None if seeds is None else seeds[i: i + rows])
        out.append(griffin_lim(spec, ang, n_fft, hop, voc["iters"], r=r).cpu().numpy())
    return deemphasis(np.concatenate(out), voc["preemph"])


# ---- the served reply's host tail ----------------------------------------------

def _rms_db(y: np.ndarray, frame_length: int = 2048, hop: int = 512) -> np.ndarray:
    """Frame power in dB below the loudest frame, frames centred (reflect
    padding), as ``librosa.effects.trim`` measures it."""
    y = np.asarray(y, dtype=np.float32)
    mode = "reflect" if len(y) > frame_length // 2 else "constant"
    padded = np.pad(y, frame_length // 2, mode=mode)
    n = 1 + (len(padded) - frame_length) // hop if len(padded) >= frame_length else 0
    if n <= 0:
        return np.zeros((0,), dtype=np.float32)
    idx = np.arange(n)[:, None] * hop + np.arange(frame_length)[None, :]
    power = np.mean(padded[idx].astype(np.float64) ** 2, axis=1)
    return 10.0 * np.log10(np.maximum(1e-10, power)) - 10.0 * np.log10(
        np.maximum(1e-10, np.max(power)))


def finalize(y: np.ndarray, top_db: Optional[float], hop: int = 512) -> np.ndarray:
    """Trim leading and trailing frames quieter than ``top_db`` below the
    loudest (keep all if none is louder), then scale to a peak of 0.75 by
    the signed maximum, as the published synthesis does."""
    y = np.asarray(y, dtype=np.float32)
    if top_db is not None:
        loud = np.flatnonzero(_rms_db(y) > -top_db)
        if len(loud):
            y = y[int(loud[0] * hop): min(len(y), int((loud[-1] + 1) * hop))]
    return y / np.max(y) * 0.75


def pcm16_wav_samples(audio: torch.Tensor, top_db: Optional[float]) -> list:
    """The 16-bit samples of each row's reply: the row scaled to ±0.75 by
    its |peak| and rounded to 16 bits (half to even), read back as floats,
    :func:`finalize`, clipped to ±1 and truncated to int16."""
    a = audio.float()
    peak = a.abs().amax(dim=1, keepdim=True)
    q = torch.round((a / peak.clamp_min(1e-8) * 0.75).clamp(-1.0, 1.0) * 32767.0)
    q = q.to(torch.int16).cpu().numpy()
    out = []
    for row in q:
        y = finalize(row.astype(np.float32) / 32767.0, top_db)
        out.append((np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16))
    return out
