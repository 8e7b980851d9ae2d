"""Batched STFT, ISTFT, Griffin-Lim and de-emphasis in plain PyTorch.

Port of :mod:`spoofsv_tpu.dsp.jaxdsp` on ``torch.fft`` (the JAX package's
DFT-as-matmul path existed only because its TPU backend lacked an FFT).
Layout is time-major ``(..., T, F)``. These are the plain versions that the
CUDA kernels of :mod:`spoofsv_torch.ops.gl_kernel` are held against.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spoofsv_torch.dsp.primitives import hann_window, pad_center, window_sumsquare

WSS_FLOOR = 1e-11   # librosa istft's window-sum-square threshold


@functools.lru_cache(maxsize=8)
def fft_window(win_length: int, n_fft: int) -> np.ndarray:
    return pad_center(hann_window(win_length), n_fft).astype(np.float32)


@functools.lru_cache(maxsize=16)
def wss_table(win_length: int, n_frames: int, hop_length: int, n_fft: int) -> np.ndarray:
    """``window_sumsquare`` as f32, length ``n_fft + hop·(n_frames−1)``."""
    return window_sumsquare(hann_window(win_length), n_frames, hop_length,
                            n_fft).astype(np.float32)


def _window(win_length: int, n_fft: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(fft_window(win_length, n_fft)).to(like.device)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Frame ``(..., L)`` → ``(..., T, n_fft)`` with T = 1 + (L−n_fft)//hop."""
    return y.unfold(-1, n_fft, hop_length)


def stft_ri(y: torch.Tensor, n_fft: int, hop_length: int,
            win_length: Optional[int] = None, center: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real/imag STFT of ``(..., L)`` → (re, im) each ``(..., T, 1+n_fft//2)``
    (librosa ``center=True``, reflect padding)."""
    win_length = win_length or n_fft
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(*lead, -1)
    frames = frame_signal(y, n_fft, hop_length) * _window(win_length, n_fft, y)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real, spec.imag


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None,
         center: bool = True) -> torch.Tensor:
    """Complex STFT of ``(..., L)`` → ``(..., T, 1+n_fft//2)`` (time-major)."""
    re, im = stft_ri(y, n_fft, hop_length, win_length, center)
    return torch.complex(re, im)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """OLA of ``(..., T, n_fft)`` → ``(..., n_fft + hop·(T−1))`` (hop | n_fft)."""
    *lead, T, n_fft = frames.shape
    assert n_fft % hop_length == 0, "overlap-add needs hop | n_fft"
    k = n_fft // hop_length
    chunks = frames.reshape(*lead, T, k, hop_length)
    out = frames.new_zeros(*lead, T + k - 1, hop_length)
    for i in range(k):
        out[..., i:i + T, :] += chunks[..., :, i, :]
    return out.reshape(*lead, (T + k - 1) * hop_length)


def istft_ri(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
             win_length: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """Inverse STFT of (re, im) ``(..., T, 1+n_fft//2)`` → ``(..., hop·(T−1))``."""
    win_length = win_length or n_fft
    T = re.shape[-2]
    # a real signal's DC and Nyquist bins are real: numpy's and the JAX
    # package's inverse drop their imaginary parts, and so does torch's on the
    # CPU, but cuFFT's C2R does not at every size (a hash "random" init puts
    # phases there), so they are dropped before the transform
    real_bins = torch.ones(re.shape[-1], device=re.device)
    real_bins[0] = 0.0
    if n_fft % 2 == 0:
        real_bins[-1] = 0.0
    frames = torch.fft.irfft(torch.complex(re.float(), im.float() * real_bins), n=n_fft, dim=-1)
    y = overlap_add(frames * _window(win_length, n_fft, re), hop_length)
    wss = torch.from_numpy(wss_table(win_length, T, hop_length, n_fft)).to(y.device)
    y = torch.where(wss > WSS_FLOOR, y / wss.clamp_min(WSS_FLOOR), y)
    if center:
        y = y[..., n_fft // 2: y.shape[-1] - n_fft // 2]
    return y


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None,
          center: bool = True) -> torch.Tensor:
    """Inverse STFT of complex ``(..., T, 1+n_fft//2)`` → ``(..., hop·(T−1))``."""
    return istft_ri(spec.real, spec.imag, n_fft, hop_length, win_length, center)


def preemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """``y[0] = x[0]``, ``y[n] = x[n] − c·x[n−1]`` (``data/dataset.py:96``), batched."""
    return x - coeff * F.pad(x[..., :-1], (1, 0))


def mel_project(lin_mag: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """``(..., T, F)`` magnitudes through a mel filterbank ``(M, F)`` → ``(..., T, M)``."""
    return torch.einsum("...tf,mf->...tm", lin_mag, fb.to(lin_mag.dtype))


def gl_advance_angles(t_frames: int, freq_bins: int, n_fft: int, hop_length: int,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocoder-consistent phase init ``φ[t, k] = 2π·hop·k·t / n_fft`` (exact
    via integer mod ``n_fft``) → ``(cos φ, sin φ)``, each ``(T, F)`` f32."""
    t = torch.arange(t_frames, device=device)[:, None]
    k = torch.arange(freq_bins, device=device)[None, :]
    p = (t * ((k * hop_length) % n_fft)) % n_fft
    phase = p.to(torch.float32) * np.float32(2.0 * np.pi / n_fft)
    return torch.cos(phase), torch.sin(phase)


def gl_if_deltas(mag: torch.Tensor) -> torch.Tensor:
    """Per-bin fractional-frequency offsets δ ∈ [−0.5, 0.5] from the parabola
    through the log-magnitudes of bins (k−1, k, k+1), where that triple is
    concave (SPSI frequency estimator); 0 elsewhere. ``(..., T, F)`` f32."""
    logm = torch.log(mag.float().clamp_min(1e-10))
    a = torch.cat([logm[..., :1], logm[..., :-1]], dim=-1)
    c = torch.cat([logm[..., 1:], logm[..., -1:]], dim=-1)
    denom = a - 2.0 * logm + c
    concave = denom < -1e-6
    delta = torch.where(concave, 0.5 * (a - c) / torch.where(concave, denom, -1.0),
                        0.0)
    return delta.clamp(-0.5, 0.5)


def gl_spsi_angles(mag: torch.Tensor, n_fft: int, hop_length: int,
                   lock: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """SPSI phase init: the advance phase rotated by ``2π·(hop/N)·`` the
    exclusive frame-cumsum of δ (wrapped to cycles) plus the lock term
    ``lock·πδ(N−1)/N``. ``mag``: ``(..., T, F)`` → ``(cos φ, sin φ)`` f32."""
    T, nb = mag.shape[-2], mag.shape[-1]
    delta = gl_if_deltas(mag)
    cyc = (torch.cumsum(delta, dim=-2) - delta) * np.float32(hop_length / n_fft)
    frac = (cyc - torch.round(cyc)) * np.float32(2.0 * np.pi)
    if lock:
        frac = frac + delta * np.float32(lock * np.pi * (n_fft - 1) / n_fft)
    b_re, b_im = gl_advance_angles(T, nb, n_fft, hop_length, mag.device)
    c_f, s_f = torch.cos(frac), torch.sin(frac)
    return b_re * c_f - b_im * s_f, b_re * s_f + b_im * c_f


def griffin_lim(mag: torch.Tensor, n_fft: int, hop_length: int,
                win_length: Optional[int] = None, n_iter: int = 64,
                momentum: float = 0.99, *,
                init_angles: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Batched f32 Griffin-Lim (librosa 0.7 ``griffinlim`` with momentum).

    ``mag``: ``(..., T, 1+n_fft//2)`` → audio ``(..., hop·(T−1))``. Phases
    start from ``init_angles`` (cos, sin), e.g. from
    :func:`spoofsv_torch.ops.gl_kernel.gl_init_angles`.
    """
    mag = mag.float()
    ang_re = init_angles[0].float().expand(mag.shape)
    ang_im = init_angles[1].float().expand(mag.shape)
    reb_re = torch.zeros_like(mag)
    reb_im = torch.zeros_like(mag)
    alpha = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        inverse = istft_ri(mag * ang_re, mag * ang_im, n_fft, hop_length, win_length)
        r_re, r_im = stft_ri(inverse, n_fft, hop_length, win_length)
        a_re = r_re - alpha * reb_re
        a_im = r_im - alpha * reb_im
        norm = torch.sqrt(a_re * a_re + a_im * a_im) + 1e-16
        ang_re, ang_im = a_re / norm, a_im / norm
        reb_re, reb_im = r_re, r_im
    return istft_ri(mag * ang_re, mag * ang_im, n_fft, hop_length, win_length)


def deemphasis(x: torch.Tensor, coeff: float = 0.97, block: int = 128) -> torch.Tensor:
    """First-order IIR ``y[n] = x[n] + c·y[n−1]``, evaluated in parallel.

    Same closed form as :func:`spoofsv_tpu.dsp.jaxdsp.deemphasis`: within
    ``block``-sample tiles ``y_local[n] = cⁿ·cumsum(x[m]/cᵐ)``; across tiles
    the carry's multiplier ``c^block`` truncates, below f32 eps, to a short
    causal sum over a few previous tiles.
    """
    c = torch.tensor(coeff, dtype=torch.float32, device=x.device)
    orig_len = x.shape[-1]
    lead = x.shape[:-1]
    xp = F.pad(x.float(), (0, (-orig_len) % block))
    nb = xp.shape[-1] // block
    xb = xp.reshape(*lead, nb, block)
    n = torch.arange(block, dtype=torch.float32, device=x.device)
    c_pow = torch.pow(c, n)
    y_local = c_pow * torch.cumsum(xb * torch.pow(c, -n), dim=-1)
    ends = y_local[..., -1]
    ck = float(coeff) ** block
    j_terms = int(min(nb, max(1, math.ceil(math.log(1e-9) / math.log(ck))))) if ck > 0 else 1
    s_prev = torch.zeros_like(ends)
    for j in range(1, j_terms + 1):
        s_prev = s_prev + (ck ** (j - 1)) * F.pad(ends[..., : nb - j], (j, 0))
    y = y_local + (c_pow * c) * s_prev[..., None]
    return y.reshape(*lead, nb * block)[..., :orig_len]
