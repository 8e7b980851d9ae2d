"""Griffin-Lim kernels: K2 (phase init) and K3 (iterations), with plain versions.

Port of :mod:`spoofsv_tpu.ops.pallas_gl`. ``gl_init_angles`` runs K2
(``csrc/gl.cu::gl_init_kernel``; replaces ``_spsi_angles_kernel`` and the
init branches of ``_gl_kernel``) and ``griffin_lim_fused`` runs K3
(``csrc/gl.cu::spoofsv_gl_run``; replaces ``_gl_kernel``). CPU tensors take
the plain versions (:func:`hash_phase_init`, :mod:`spoofsv_torch.dsp.torchdsp`);
CUDA tensors launch the kernels or raise. Everything is f32: the TPU kernel's
int8 DFT operands are a matrix-unit rate trick, not carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.ops import _build

INIT_MODES = {"random": 0, "advance": 1, "spsi": 2}
ARITHMETIC = "f32 radix-2 FFT in shared memory (no int8/bf16 DFT operands)"

_U32 = 0xFFFFFFFF


init_kernel = _build.LaunchCounter()     # K2
gl_kernel = _build.LaunchCounter()       # K3


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a · c) mod 2³²`` for int64 ``a`` in [0, 2³²) without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_mix(tt: torch.Tensor, kk: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3-style mixer over (frame, bin, seed), bit-equal to
    ``pallas_gl._hash_mix`` read as uint32. Computed in int64 masked to 32
    bits: torch's ``>>`` on int32 is arithmetic, the mixer's is logical."""
    tt, kk, seed = (x.to(torch.int64) & _U32 for x in (tt, kk, seed))
    h = _mul32(tt, 73856093) ^ _mul32(kk, 19349663) ^ _mul32(seed, 83492791)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_phase_init(seeds: torch.Tensor, T: int, F: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic "random" phase init: ``seeds`` (B,) → (cos φ, sin φ), each
    (B, T, F) f32, ``φ = (hash & 0xFFFFFF)·2π/2²⁴``."""
    dev = seeds.device
    h = _hash_mix(torch.arange(T, device=dev)[None, :, None],
                  torch.arange(F, device=dev)[None, None, :], seeds[:, None, None])
    phase = (h & 0xFFFFFF).to(torch.float32) * np.float32(2.0 * np.pi / (1 << 24))
    return torch.cos(phase), torch.sin(phase)


def init_angles_plain(mag: torch.Tensor, n_fft: int, hop: int, mode: str,
                      seeds: Optional[torch.Tensor] = None, lock: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, F = mag.shape
    if mode == "random":
        return hash_phase_init(seeds, T, F)
    if mode == "advance":
        a_re, a_im = torchdsp.gl_advance_angles(T, F, n_fft, hop, mag.device)
        return a_re.expand(B, T, F).contiguous(), a_im.expand(B, T, F).contiguous()
    return torchdsp.gl_spsi_angles(mag, n_fft, hop, lock)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_mode(mode: str, seeds: Optional[torch.Tensor]) -> None:
    if mode not in INIT_MODES:
        raise ValueError(f"unknown init mode {mode!r}")
    if mode == "random" and seeds is None:
        raise ValueError("init mode 'random' needs seeds")


def gl_init_angles(mag: torch.Tensor, n_fft: int, hop: int, mode: str = "spsi",
                   seeds: Optional[torch.Tensor] = None, lock: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Griffin-Lim phase init: ``mag`` (B, T, F) → (cos φ, sin φ) f32 (B, T, F).

    ``mode``: "random" (hash of (frame, bin, seed), ``seeds`` (B,) int),
    "advance" (bin k advanced by its centre frequency per hop) or "spsi"
    (advance refined by per-bin instantaneous frequencies from ``mag``).
    """
    _check_mode(mode, seeds)
    if mag.device.type == "cpu":
        return init_angles_plain(mag.float(), n_fft, hop, mode, seeds, lock)
    B, T, F = mag.shape
    mag = mag.float().contiguous()
    seeds_i = (seeds.to(device=mag.device, dtype=torch.int32).contiguous()
               if seeds is not None else None)
    dev = _build.require_cuda(mag, *(() if seeds_i is None else (seeds_i,)))
    lib = _build.load("gl")
    out_re = torch.empty_like(mag)
    out_im = torch.empty_like(mag)
    f32 = np.float32
    err = lib.spoofsv_gl_init_launch(
        INIT_MODES[mode], mag.data_ptr(), seeds_i.data_ptr() if seeds_i is not None else None,
        out_re.data_ptr(), out_im.data_ptr(), B, T, F, n_fft, hop,
        *(float(f32(v)) for v in (2.0 * np.pi / n_fft, 2.0 * np.pi / (1 << 24), hop / n_fft,
                                  2.0 * np.pi, lock * np.pi * (n_fft - 1) / n_fft)),
        _build.stream_ptr(dev))
    _build.check(lib, "gl", err, "gl_init_kernel")
    init_kernel.launches += 1
    return out_re, out_im


@functools.lru_cache(maxsize=8)
def _constants(n_fft: int, win_length: int, T: int, hop: int, device: torch.device):
    """(twiddles (n/2, 2), window (n,), window_sumsquare) on ``device``."""
    m = np.arange(n_fft // 2, dtype=np.float64)
    tw = np.stack([np.cos(2 * np.pi * m / n_fft), -np.sin(2 * np.pi * m / n_fft)], -1)
    return (torch.from_numpy(tw.astype(np.float32)).to(device),
            torch.from_numpy(torchdsp.fft_window(win_length, n_fft)).to(device),
            torch.from_numpy(torchdsp.wss_table(win_length, T, hop, n_fft)).to(device))


def _gl_cuda(mag, ang_re, ang_im, n_fft, hop, win_length, n_iter, momentum):
    B, T, F = mag.shape
    dev = _build.require_cuda(mag, ang_re, ang_im)
    if F != n_fft // 2 + 1 or n_fft & (n_fft - 1) or not 16 <= n_fft <= 2048:
        raise ValueError(f"griffin_lim_fused: unsupported n_fft={n_fft} / F={F}")
    if hop * (T - 1) <= n_fft // 2:
        raise ValueError(f"griffin_lim_fused: T={T} too short for reflect padding")
    lib = _build.load("gl")
    tw, window, wss = _constants(n_fft, win_length, T, hop, dev)
    reb_re = torch.zeros_like(mag)
    reb_im = torch.zeros_like(mag)
    fsyn = torch.empty(B, T, n_fft, device=dev, dtype=torch.float32)
    audio = torch.empty(B, hop * (T - 1), device=dev, dtype=torch.float32)
    err = lib.spoofsv_gl_run(
        mag.data_ptr(), ang_re.data_ptr(), ang_im.data_ptr(), reb_re.data_ptr(),
        reb_im.data_ptr(), fsyn.data_ptr(), wss.data_ptr(), window.data_ptr(),
        tw.data_ptr(), audio.data_ptr(), B, T, F, n_fft, hop, n_iter,
        ctypes.c_float(momentum / (1.0 + momentum)), _build.stream_ptr(dev))
    _build.check(lib, "gl", err, "griffin_lim kernels")
    gl_kernel.launches += 1
    return audio


def griffin_lim_fused(mag: torch.Tensor, n_fft: int, hop: int,
                      win_length: Optional[int] = None, n_iter: int = 12,
                      momentum: float = 0.99,
                      init_angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      init_mode: str = "spsi", seeds: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Griffin-Lim from a phase init: ``mag`` (B, T, F) → audio (B, hop·(T−1)) f32.

    The init is ``init_angles`` (cos, sin) when given, else
    :func:`gl_init_angles` with ``init_mode``/``seeds``. CPU tensors run
    :func:`spoofsv_torch.dsp.torchdsp.griffin_lim`; CUDA tensors run K3.
    """
    win_length = win_length or n_fft
    mag = mag.float().contiguous()
    if init_angles is None:
        init_angles = gl_init_angles(mag, n_fft, hop, init_mode, seeds)
    if mag.device.type == "cpu":
        return torchdsp.griffin_lim(mag, n_fft, hop, win_length, n_iter, momentum,
                                    init_angles=init_angles)
    ang_re = init_angles[0].float().expand(mag.shape).contiguous().clone()
    ang_im = init_angles[1].float().expand(mag.shape).contiguous().clone()
    return _gl_cuda(mag, ang_re, ang_im, n_fft, hop, win_length, n_iter, momentum)
