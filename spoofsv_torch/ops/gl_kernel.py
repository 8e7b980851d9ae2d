"""Griffin-Lim kernels: K2 (phase init) and K3 (iterations), with plain versions.

Port of :mod:`spoofsv_tpu.ops.pallas_gl`. ``gl_init_angles`` runs K2
(``csrc/gl.cu::gl_init_kernel``; replaces ``_spsi_angles_kernel`` and the
init branches of ``_gl_kernel``): each utterance's frames in 32 segments, a
block a segment over all bins (whole rows read and written), the SPSI
cumsum as segment totals, their scan in segment order by look-back, and a
second pass (:func:`spsi_segments_emulate`). K3 (replaces
``_gl_kernel``) has two routes:

* :func:`griffin_lim_tc` (``csrc/gl_tc.cu``): the TPU kernel's arithmetic
  on the tensor cores. The DFTs are int8 products (``int8=True``, the
  TPU kernel's ``int8_fwd``) or bf16 ones, with the magnitudes' int8 scale
  hoisted out of the loop, bf16 angles and f32 rebuilt spectra; one fused
  launch an iteration and one for the final synthesis. Its plain version is
  :func:`griffin_lim_tc_plain`.
* :func:`griffin_lim_fused` (``csrc/gl.cu::spoofsv_gl_run``): f32 real
  FFTs as half-size complex ones in registers, several frames a block
  (:func:`gl_plan`), the "highest" precision route; its plain version is
  :func:`spoofsv_torch.dsp.torchdsp.griffin_lim`, and :func:`gl_f32_emulate`
  follows the kernels' plan step by step.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.ops import _build
from spoofsv_torch.utils.profiling import count

INIT_MODES = {"random": 0, "advance": 1, "spsi": 2}

_U32 = 0xFFFFFFFF


init_kernel = _build.LaunchCounter()     # K2
gl_kernel = _build.LaunchCounter()       # K3, f32 (csrc/gl.cu)
gl_tc_kernel = _build.LaunchCounter()    # K3 on the tensor cores (csrc/gl_tc.cu), one a GL call


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


def gl_reference(mag: torch.Tensor, init_angles: Tuple[torch.Tensor, torch.Tensor], n_fft: int,
                 hop: int, win_length: int, n_iter: int, momentum: float = 0.99) -> torch.Tensor:
    """librosa's ``griffinlim`` (centre and reflect padding, momentum, the
    imaginary parts of bins 0 and n/2 dropped) with ``torch.fft`` and an
    ``index_add_`` overlap-add: any hop, in ``mag``'s dtype and on its device.
    The witness that the f32 K3 and its emulation are held against (float64
    where momentum grows f32 rounding)."""
    B, T, F = mag.shape
    dt, dev = mag.dtype, mag.device
    w = torch.from_numpy(torchdsp.fft_window(win_length, n_fft)).to(dev, dt)
    wss = torch.from_numpy(torchdsp.wss_table(win_length, T, hop, n_fft)).to(dev, dt)
    idx = (hop * torch.arange(T, device=dev)[:, None]
           + torch.arange(n_fft, device=dev)[None, :]).reshape(-1)
    L = hop * (T - 1)
    real_bins = torch.arange(F, device=dev) % (F - 1) != 0

    def istft(spec):
        fr = torch.fft.irfft(torch.complex(spec.real, spec.imag * real_bins), n=n_fft) * w
        y = torch.zeros(B, n_fft + L, device=dev, dtype=dt).index_add_(1, idx, fr.reshape(B, -1))
        y = torch.where(wss > torchdsp.WSS_FLOOR, y / wss.clamp_min(torchdsp.WSS_FLOOR), y)
        return y[:, n_fft // 2: n_fft // 2 + L]

    def stft(y):
        yp = torch.nn.functional.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
        return torch.fft.rfft(yp[:, idx].reshape(B, T, n_fft) * w)

    ang = torch.complex(init_angles[0].to(dt), init_angles[1].to(dt)).expand(mag.shape)
    reb, alpha = torch.zeros_like(ang), momentum / (1.0 + momentum)
    for _ in range(n_iter):
        r = stft(istft(mag * ang))
        acc = r - alpha * reb
        ang, reb = acc / (acc.abs() + 1e-16), r
    return istft(mag * ang)


INIT_SEGMENTS = 32   # K2: segments of ⌈T/32⌉ frames an utterance is cut into, a block each


def spsi_segments_emulate(mag: torch.Tensor, n_fft: int, hop: int, lock: float = 1.0,
                          segments: int = INIT_SEGMENTS) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's SPSI decomposition in plain torch: the frames cut into
    ``segments`` of ⌈T/segments⌉; per segment the running sum of δ in frame
    order (its total), the totals' exclusive scan in segment order, then each
    segment's running sum again from its prefix, which gives every frame the
    exclusive cumsum of δ before it. The same angles as
    :func:`init_angles_plain` (``"spsi"``), the cumsum associated as the
    kernel associates it."""
    mag = mag.float()
    B, T, F = mag.shape
    delta = torchdsp.gl_if_deltas(mag)
    S, L = segments, -(-T // segments)
    seg = torch.nn.functional.pad(delta, (0, 0, 0, S * L - T)).reshape(B, S, L, F)
    tot = torch.zeros(B, S, F, device=mag.device)
    for i in range(L):
        tot = tot + seg[:, :, i]
    pre, run = torch.empty_like(tot), torch.zeros(B, F, device=mag.device)
    for w in range(S):
        pre[:, w] = run
        run = run + tot[:, w]
    excl, cum = torch.empty_like(seg), pre
    for i in range(L):
        excl[:, :, i] = cum
        cum = cum + seg[:, :, i]
    excl = excl.reshape(B, S * L, F)[:, :T]
    cyc = excl * np.float32(hop / n_fft)
    frac = (cyc - torch.round(cyc)) * np.float32(2.0 * np.pi)
    frac = frac + delta * np.float32(lock * np.pi * (n_fft - 1) / n_fft)
    b_re, b_im = torchdsp.gl_advance_angles(T, F, n_fft, hop, mag.device)
    c_f, s_f = torch.cos(frac), torch.sin(frac)
    return b_re * c_f - b_im * s_f, b_re * s_f + b_im * c_f


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
    agg = sync = None
    if mode == "spsi":   # the segments' δ totals, and the block counter and flags
        agg = torch.empty(B * INIT_SEGMENTS * F, device=dev)
        sync = torch.zeros(1 + B * INIT_SEGMENTS, device=dev, dtype=torch.int32)
    f32 = np.float32
    err = lib.spoofsv_gl_init_launch(
        INIT_MODES[mode], mag.data_ptr(), seeds_i.data_ptr() if seeds_i is not None else None,
        out_re.data_ptr(), out_im.data_ptr(), agg.data_ptr() if agg is not None else None,
        sync.data_ptr() if sync is not None else None, B, T, F, n_fft, hop,
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


GL_WARPS = 8            # csrc/gl.cu: warps a K3 f32 block
SMEM_LIMIT = 232448     # shared memory a block may ask for


def gl_plan(n_fft: int, hop: int) -> dict:
    """The f32 K3's plan at ``n_fft`` and ``hop`` (``csrc/gl.cu::GlPlan`` and
    ``gl_run``): the frame's n-point real transform as an ``N2 = n/2`` point
    complex one, ``E`` values a lane, ``P`` lanes (``G = 32/P`` frames) a
    warp, ``radices`` (16s, then one smaller pass), ``frames_max`` frames a
    synthesis run, ``frames`` an analysis run (fewer where hop leaves the
    run's synthesis frames and signal no room in shared memory), ``plane``
    floats a staged plane, and each kernel's shared memory in bytes."""
    N2 = n_fft // 2
    log2n = N2.bit_length()
    E = 32 if N2 >= 1024 else (N2 if N2 < 16 else 16)
    P = N2 // E
    G = 32 // P
    A = (log2n - 1) // 4
    rem = N2 >> (4 * A)
    plane = (GL_WARPS * G * (N2 + 1) + 6) & ~3

    def smem(analysis: bool, frames: int) -> int:
        if not analysis:
            return 4 * (2 * N2 + 3 * plane)
        raw = (n_fft * (frames + 2 * ((n_fft - 1) // hop)) + 6) & ~3   # the run's synthesis frames
        sig = (hop * (frames - 1) + n_fft + 2 + 6) & ~3     # with window_sumsquare's shift
        return 4 * (2 * N2 + 2 * plane + max(raw, 2 * plane) + sig)

    frames = GL_WARPS * G
    while frames > 1 and smem(True, frames) > SMEM_LIMIT:
        frames -= 1
    return {"N2": N2, "E": E, "P": P, "G": G, "radices": [16] * A + ([rem] if rem > 1 else []),
            "frames_max": GL_WARPS * G, "frames": frames, "plane": plane,
            "smem_synth": smem(False, 0), "smem_analysis": smem(True, frames)}


def _swz(i: np.ndarray) -> np.ndarray:
    """``csrc/gl.cu::swz``: where element i of a group's exchange arrays lives."""
    return i ^ ((i >> 4) & 31)


def _w16(q: int, inverse: bool) -> complex:
    """exp(∓2πiq/16); in complex64 the kernel's f32 literals."""
    return complex(np.cos(2 * np.pi * q / 16), (1 if inverse else -1) * np.sin(2 * np.pi * q / 16))


def _dft_dif(v: torch.Tensor, inverse: bool) -> torch.Tensor:
    """``dft_reg``: an R-point DFT of the last axis by radix-2 decimation in
    frequency, the result in bit-reversed order."""
    R = v.shape[-1]
    h = R // 2
    while h >= 1:
        lo = [i for i in range(R) if not i & h]
        hi = [i + h for i in lo]
        w = torch.tensor([_w16((i & (h - 1)) * (8 // h), inverse) for i in lo], dtype=v.dtype)
        a, b = v[..., lo], v[..., hi]
        v = v.clone()
        v[..., lo], v[..., hi] = a + b, (a - b) * w
        h //= 2
    return v


def _brev(r: int, bits: int) -> int:
    return int(format(r, f"0{bits}b")[::-1], 2) if bits else 0


def _tw_n(tab: torch.Tensor, e: np.ndarray) -> torch.Tensor:
    """W_n^e from the table of W_n^k, k < N2 (``tw_n``)."""
    N2 = tab.shape[0]
    w = tab[torch.from_numpy(e & (N2 - 1))]
    return torch.where(torch.from_numpy((e & N2) != 0), -w, w)


def stockham_emulate(z: torch.Tensor, plan: dict, tab: torch.Tensor,
                     inverse: bool = False) -> torch.Tensor:
    """``fft_pass``: the N2-point complex transform of the last axis (complex
    ``z``, unnormalised; ``inverse`` takes the + sign) by the kernel's lanes,
    butterflies, twiddles and swizzled exchange arrays, pass by pass.
    ``tab``: W_n^k, k < N2, complex of ``z``'s precision."""
    N2, E, P = plan["N2"], plan["E"], plan["P"]
    tab = tab.conj() if inverse else tab
    g = np.arange(P)[:, None, None]
    buf, ns = z, 1
    for p, R in enumerate(plan["radices"]):
        b = np.arange(E // R)[None, :, None]
        r = np.arange(R)[None, None, :]
        j = g + P * b
        src = j + r * (N2 // R)                       # (P, E/R, R): the slot's element
        regs = buf[..., torch.from_numpy(_swz(src) if p else src)]
        if ns > 1:
            regs = regs * _tw_n(tab, r * (j % ns) * (2 * N2 // (ns * R)))
        regs = _dft_dif(regs, inverse)
        dst = (j // ns) * ns * R + j % ns + r * ns    # output element r of each butterfly
        vals = regs[..., [_brev(q, R.bit_length() - 1) for q in range(R)]]
        last = p == len(plan["radices"]) - 1
        flat = (dst if last else _swz(dst)).reshape(-1)
        assert np.array_equal(np.sort(flat), np.arange(N2)), "a pass's stores are not a permutation"
        out = torch.empty_like(buf)
        out[..., torch.from_numpy(flat)] = vals.reshape(*vals.shape[:-3], -1)
        buf, ns = out, ns * R
    return buf


def rfft_emulate(x: torch.Tensor, plan: dict, tab: torch.Tensor) -> torch.Tensor:
    """The analysis transform: real frames (..., n) → (..., n/2 + 1) complex,
    z[m] = x[2m] + i·x[2m+1] through :func:`stockham_emulate`, then the
    split X[k] = E + W_n^k·O, X[N2−k] = conj(E − W_n^k·O) as the kernel
    computes it."""
    N2 = plan["N2"]
    Z = stockham_emulate(torch.complex(x[..., 0::2], x[..., 1::2]), plan, tab)
    k = torch.arange(N2 // 2 + 1)
    zk, zc = Z[..., k], Z[..., (N2 - k) % N2]
    e = torch.complex(0.5 * (zk.real + zc.real), 0.5 * (zk.imag - zc.imag))
    o = torch.complex(0.5 * (zk.imag + zc.imag), -0.5 * (zk.real - zc.real)) * tab[k]
    X = torch.empty(*x.shape[:-1], N2 + 1, dtype=Z.dtype)
    X[..., N2 - k] = (e - o).conj()
    X[..., k] = e + o
    return X


def irfft_emulate(X: torch.Tensor, plan: dict, tab: torch.Tensor) -> torch.Tensor:
    """The synthesis transform: (..., n/2 + 1) complex → real (..., n) without
    the 1/n, the imaginary parts of bins 0 and n/2 dropped; the merge
    Z[k] = (X[k] + conj X[N2−k]) + i·conj(W_n^k)·(X[k] − conj X[N2−k]), then
    :func:`stockham_emulate` inverse."""
    N2 = plan["N2"]
    X = X.clone()
    X[..., 0] = X[..., 0].real
    X[..., N2] = X[..., N2].real
    k = torch.arange(N2)
    a, bc = X[..., k], X[..., N2 - k].conj()
    Z = (a + bc) + 1j * (tab.conj() * (a - bc))
    z = stockham_emulate(Z, plan, tab, inverse=True)
    return torch.stack([z.real, z.imag], -1).reshape(*z.shape[:-1], 2 * N2)


def gl_f32_emulate(mag: torch.Tensor, ang_re: torch.Tensor, ang_im: torch.Tensor, n_fft: int,
                   hop: int, win_length: Optional[int] = None, n_iter: int = 12,
                   momentum: float = 0.99, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``csrc/gl.cu``'s f32 K3 step by step in plain torch (CPU): its
    launches; synthesis through :func:`irfft_emulate`; analysis by runs of
    ``gl_plan(...)["frames"]`` frames, each with its stretch [u0, u1) of the
    ISTFT signal built as the kernel stages it, from the run's synthesis
    frames t0 − H .. t0 + nf − 1 + H, H = (n − 1) // hop, but for the two end
    samples (every sample a frame reads, reflected ends included, must lie in
    the stretch, and every inner sample's frames among those staged), then
    :func:`rfft_emulate`, momentum and normalisation; the overlap-add
    epilogue. ``dtype`` float64 checks the plan's algebra alone."""
    win_length = win_length or n_fft
    B, T, F = mag.shape
    N, N2, plan = n_fft, n_fft // 2, gl_plan(n_fft, hop)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    m = np.arange(N2)
    tab = torch.from_numpy(np.exp(-2j * np.pi * m / N)).to(cdt)   # in f32: the kernel's table
    window = torch.from_numpy(torchdsp.fft_window(win_length, N)).to(dtype)
    wss = torch.from_numpy(torchdsp.wss_table(win_length, T, hop, N)).to(dtype)
    mag, a_re, a_im = (x.to(dtype) for x in (mag, ang_re, ang_im))
    reb = torch.zeros(B, T, F, dtype=cdt)
    alpha = momentum / (1.0 + momentum)
    L = hop * (T - 1)

    def ola(fsyn: torch.Tensor, u: np.ndarray, staged=None) -> torch.Tensor:   # ola_sample at each u
        acc = torch.zeros(B, len(u), dtype=dtype)
        t_hi = np.minimum(u // hop, T - 1)
        lo = u - N + 1
        t_lo = np.where(lo <= 0, 0, (lo + hop - 1) // hop)
        if staged is not None:   # (samples read from the staged frames, their first and last)
            inner, tA, tB = staged
            assert t_lo[inner].min() >= tA and t_hi[inner].max() <= tB, "a sample needs an unstaged frame"
        for c in range(int((t_hi - t_lo).max()) + 1):
            tp = t_lo + c
            ok = tp <= t_hi
            tpc = np.where(ok, tp, 0)
            v = fsyn[:, torch.from_numpy(tpc), torch.from_numpy(np.where(ok, u - hop * tpc, 0))]
            acc = acc + torch.where(torch.from_numpy(ok), v, torch.zeros((), dtype=dtype))
        w = wss[torch.from_numpy(u)]
        return torch.where(w > torchdsp.WSS_FLOOR, acc / w, acc)

    def synthesis(a_re, a_im):
        x = irfft_emulate(mag * torch.complex(a_re, a_im), plan, tab)
        return (x * np.float32(1.0 / N)).to(dtype) * window

    for _ in range(n_iter):
        fsyn = synthesis(a_re, a_im)
        a_re, a_im = a_re.clone(), a_im.clone()
        for t0 in range(0, T, plan["frames"]):
            nf = min(plan["frames"], T - t0)
            u0, u1 = max(0, hop * t0 - 1), min(N + L, hop * (t0 + nf - 1) + N + 1)
            u = np.arange(u0, u1)
            H = (N - 1) // hop    # the staged frames tA..tB; the two end samples from fsyn
            inner = (u >= hop * t0) & (u < hop * (t0 + nf - 1) + N)
            sig = ola(fsyn, u, (inner, max(0, t0 - H), min(T - 1, t0 + nf - 1 + H)))
            t = np.arange(t0, t0 + nf)[:, None]
            s = hop * t + np.arange(N)[None, :] - N2
            v = np.where(s < 0, -s, np.where(s >= L, 2 * (L - 1) - s, s)) + N2 - u0
            assert v.min() >= 0 and v.max() < u1 - u0, "a frame reads outside its run's signal"
            X = rfft_emulate(sig[:, torch.from_numpy(v)] * window, plan, tab)
            a = X - alpha * reb[:, t0:t0 + nf]
            norm = torch.sqrt(a.real * a.real + a.imag * a.imag) + 1e-16
            a_re[:, t0:t0 + nf], a_im[:, t0:t0 + nf] = a.real / norm, a.imag / norm
            reb[:, t0:t0 + nf] = X
    return ola(synthesis(a_re, a_im), np.arange(L) + N2)


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
    count("gl_f32_frames", B * T * (2 * n_iter + 1))
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


# ---------------------------------------------------------------------------
# K3 on the tensor cores (csrc/gl_tc.cu): constants, operand streams, plain
# version, emulation of the kernel's tiling, wrapper
# ---------------------------------------------------------------------------

TC_NFFT = 1024        # the kernel's transform size (hop = n_fft/4 = 256)
TC_ROWS = 64          # synthesis rows a CTA: its frames and 3 halo frames each side
TC_HALO = 3           # analysis frame t reads synthesis frames t-3..t+3 (hop = n_fft/4)
TC_MAX_FRAMES = TC_ROWS - 2 * TC_HALO   # 58 analysis frames a CTA at most
TC_STAGE = 16384      # bytes of one stage of an operand stream: 256 columns x 32 or 64 of k
Q_SCALE = 126.5       # int8 operand scale: |q| <= 126.5 plus rounding < 127.5, no clip
_F32 = np.float32


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).float()


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int) -> dict:
    """The TPU kernel's DFT operands over the 512 aligned bins
    (``pallas_gl.py:150-197``), in its layouts: forward ``(n_fft, n_fft/2)``
    indexed [sample, bin], inverse ``(n_fft/2, n_fft)`` indexed [bin, sample].
    bf16 matrices (``dftc``, ``dfts``, ``invc`` with the ``w_k/N`` fold,
    ``invs``) and 127-scaled int8 ones (``dftc8``, ``dfts8``, ``inv8c``,
    ``inv8s``; the fold lives in the magnitudes' scale instead). Angles are
    the exact integer ``n·k mod N`` times ``f32(2π/N)``, as the TPU kernel
    computes them."""
    N, Fa = n_fft, n_fft // 2
    step = torch.tensor(_F32(2.0 * np.pi / N))
    th = ((torch.arange(N)[:, None] * torch.arange(Fa)[None, :]) % N).float() * step
    th2 = th.t().contiguous()
    wk = torch.where(torch.arange(Fa)[:, None] == 0, 1.0, 2.0) / N
    cos, sin, cos2, sin2 = torch.cos(th), torch.sin(th), torch.cos(th2), torch.sin(th2)
    q = lambda x: torch.round(x * 127.0).to(torch.int8)   # noqa: E731  (half to even, as jnp.round)
    return {"dftc": cos.to(torch.bfloat16), "dfts": (-sin).to(torch.bfloat16),
            "invc": (wk * cos2).to(torch.bfloat16), "invs": (-wk * sin2).to(torch.bfloat16),
            "dftc8": q(cos), "dfts8": q(-sin), "inv8c": q(cos2), "inv8s": q(-sin2)}


def gl_window(n_fft: int) -> torch.Tensor:
    """The periodic Hann window as the TPU kernel computes it, f32 (n_fft,)."""
    j = torch.arange(n_fft).float()
    return 0.5 - 0.5 * torch.cos(j * torch.tensor(_F32(2.0 * np.pi / n_fft)))


def edge_tables(n_fft: int, hop: int) -> torch.Tensor:
    """1/window_sumsquare of the six OLA chunks at each end (``pallas_gl.py:176-186``):
    rows 0-5 chunks 0-5, rows 6-11 chunks T-3..T+2, f32 (12, hop)."""
    w2 = gl_window(n_fft) ** 2
    part = [w2[hop * r: hop * (r + 1)] for r in range(4)]
    rows = []
    for m in range(6):
        rows.append(sum(part[r] for r in range(min(3, m) + 1)))
    for idx in range(6):
        rows.append(sum(part[r] for r in range(max(0, idx - 2), 4)))
    acc = torch.stack(rows)
    return torch.where(acc > 1e-11, 1.0 / torch.clamp(acc, min=1e-11), torch.ones_like(acc))


def hoist_qm(mag: torch.Tensor, n_fft: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loop-invariant int8 scale of the magnitudes (``pallas_gl.py:204-222``):
    ``qm = bf16(mag·w_k·126.5/rowmax)`` (B, T, n_fft/2) and the dequantisation
    ``rowmax/(126.5·127·N)`` (B, T, 1) f32, from the bf16-rounded magnitudes."""
    Fa = n_fft // 2
    wk = torch.full((Fa,), 2.0, device=mag.device)
    wk[0] = 1.0
    mw = _bf16r(mag[..., :Fa].float()) * wk
    amax = mw.amax(-1, keepdim=True) + _F32(1e-20)
    qm = (mw * (torch.tensor(_F32(Q_SCALE), device=mag.device) / amax)).to(torch.bfloat16)
    return qm, amax * _F32(1.0 / (Q_SCALE * 127.0 * n_fft))


def tc_frames_per_tile(T: int) -> int:
    """Analysis frames a CTA: the most (58) whose last tile keeps at least 3
    frames, so that frame T-1's reflected samples (chunk T-2) lie in its CTA."""
    for tf in range(TC_MAX_FRAMES, 2, -1):
        if T - tf * (-(-T // tf) - 1) >= 3:
            return tf
    raise ValueError(f"griffin_lim_tc: no tiling for T={T}")


def _check_tc(mag: torch.Tensor, n_fft: int, hop: int, win_length: int) -> None:
    T, F = mag.shape[-2:]
    if (win_length != n_fft or hop * 4 != n_fft or F != n_fft // 2 + 1 or n_fft % 64
            or T < 16):
        raise ValueError(f"griffin_lim_tc: unsupported geometry n_fft={n_fft} hop={hop} "
                         f"win_length={win_length} F={F} T={T} (needs hop = n_fft/4, "
                         f"win_length = n_fft, T >= 16)")


def _tc_signal(fsyn: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA chunks of the synthesis frames: (B, T, N) → (B, T+3, hop),
    ``sig[c] = Σ_{r=0..3} frame[c−r][chunk r]`` summed in that order."""
    B, T, N = fsyn.shape
    parts = fsyn.view(B, T, 4, hop)
    sig = parts.new_zeros(B, T + 3, hop)
    for r in range(4):
        sig[:, r:r + T] += parts[:, :, r]
    return sig


@functools.lru_cache(maxsize=8)
def _edge_gather(T: int, n_fft: int, hop: int):
    """For the analysis frames {0, 1, 2, T−3, T−2, T−1}: the OLA sample each
    frame sample reads (librosa's centre reflect padding) and the row of
    :func:`edge_tables` that scales it, as flat indices into (T+3)·hop and
    12·hop."""
    frames = [0, 1, 2, T - 3, T - 2, T - 1]
    L, half = hop * (T - 1), n_fft // 2
    j = np.arange(n_fft)
    src, tab = [], []
    for t in frames:
        s = hop * t + j - half
        s = np.where(s < 0, -s, np.where(s >= L, 2 * (L - 1) - s, s))
        u = s + half
        c = u // hop
        row = c if t < 3 else 6 + c - (T - 3)
        src.append(u)
        tab.append(row * hop + u % hop)
    return frames, torch.from_numpy(np.stack(src)), torch.from_numpy(np.stack(tab))


def _tc_synthesis(mag_b, ang_re, ang_im, mats, qm, deq, quant: bool, window):
    """Synthesis frames ``bf16(w · irfft(mag·ang))`` (B, T, N) f32 as the TPU
    kernel's ``phase_a`` computes them: int8 products against the hoisted
    ``qm`` (``quant``) or bf16 ones; the Nyquist bin as a rank-1 f32 term."""
    N = window.shape[0]
    Fa = N // 2
    sign = torch.where(torch.arange(N, device=window.device) % 2 == 0, 1.0, -1.0) / N
    if quant:
        q_re = torch.round(qm.float() * ang_re[..., :Fa])
        q_im = torch.round(qm.float() * ang_im[..., :Fa])
        # integer sums below 2^24: exact as f32 products (TF32 off)
        fr = (q_re @ mats["inv8c"].float() + q_im @ mats["inv8s"].float()) * deq
    else:
        cre, cim = mag_b[..., :Fa] * ang_re[..., :Fa], mag_b[..., :Fa] * ang_im[..., :Fa]
        fr = _bf16r(cre) @ mats["invc"].float()
        fr = fr + _bf16r(cim) @ mats["invs"].float()
    fr = fr + (mag_b[..., Fa:] * ang_re[..., Fa:]) * sign
    return _bf16r(fr * window)


def _tc_analysis_frames(sig, window, tables, quant: bool, T: int, hop: int):
    """Windowed analysis frames (B, T, N): interior frames ``sig[t..t+3]·w/1.5``,
    the six edge frames with the exact window_sumsquare and reflect padding.
    f32 for int8 products, bf16-rounded for bf16 ones (the TPU kernel's ``ana``)."""
    B = sig.shape[0]
    N = window.shape[0]
    frames = sig.unfold(1, 4, 1)[:, :T].transpose(-1, -2).reshape(B, T, N)
    wsc = window * torch.tensor(_F32(1.0 / 1.5), device=sig.device)
    ana = frames * wsc if quant else _bf16r(_bf16r(frames) * _bf16r(wsc))
    rows, src, tab = _edge_gather(T, N, hop)
    flat = sig.reshape(B, -1)
    edge = (flat[:, src.to(sig.device)] * tables.reshape(-1)[tab.to(sig.device)]) * window
    ana[:, rows] = edge if quant else _bf16r(edge)
    return ana


def griffin_lim_tc_plain(mag: torch.Tensor, ang_re: torch.Tensor, ang_im: torch.Tensor,
                         n_fft: int, hop: int, n_iter: int, momentum: float,
                         int8: bool = True) -> torch.Tensor:
    """K3's arithmetic in plain torch (``pallas_gl._gl_kernel`` with
    ``int8_fwd=int8``): ``mag`` (B, T, F) f32 and the initial (cos, sin)
    (B, T, F) → audio (B, hop·(T−1)) f32. Magnitudes and angles are rounded
    to bf16 as the TPU kernel stores them; the rebuilt spectra stay f32; the
    final synthesis is bf16 whatever ``int8`` says. Needs TF32 off on a card
    (:func:`spoofsv_torch.reference_precision`)."""
    B, T, F = mag.shape
    N, Fa, dev = n_fft, n_fft // 2, mag.device
    mats = {k: v.to(dev) for k, v in dft_matrices(N).items()}
    window = gl_window(N).to(dev)
    tables = edge_tables(N, hop).to(dev)
    mag_b = _bf16r(mag.float())
    qm, deq = hoist_qm(mag, N) if int8 else (None, None)
    a_re, a_im = _bf16r(ang_re.float()), _bf16r(ang_im.float())
    reb_re = torch.zeros(B, T, F, device=dev)
    reb_im = torch.zeros(B, T, F, device=dev)
    alpha = momentum / (1.0 + momentum)
    nyq_c = torch.where(torch.arange(N, device=dev) % 2 == 0, 1.0, -1.0)
    for _ in range(n_iter):
        fsyn = _tc_synthesis(mag_b, a_re, a_im, mats, qm, deq, int8, window)
        ana = _tc_analysis_frames(_tc_signal(fsyn, hop), window, tables, int8, T, hop)
        if int8:
            amax = ana.abs().amax(-1, keepdim=True) + _F32(1e-20)
            q = torch.round(ana * (torch.tensor(_F32(Q_SCALE), device=dev) / amax))
            dq = amax * _F32(1.0 / (Q_SCALE * 127.0))
            rr = (q @ mats["dftc8"].float()) * dq
            ri = (q @ mats["dfts8"].float()) * dq
        else:
            rr, ri = ana @ mats["dftc"].float(), ana @ mats["dfts"].float()
        rr_n = (ana * nyq_c).sum(-1, keepdim=True)
        rr = torch.cat([rr, rr_n], -1)
        ri = torch.cat([ri, torch.zeros_like(rr_n)], -1)
        x_re, x_im = rr - alpha * reb_re, ri - alpha * reb_im
        inv = torch.rsqrt(x_re * x_re + x_im * x_im + 1e-32)
        a_re, a_im = _bf16r(x_re * inv), _bf16r(x_im * inv)
        reb_re, reb_im = rr, ri
    fsyn = _tc_synthesis(mag_b, a_re, a_im, mats, None, None, False, window)
    sig = _tc_signal(fsyn, hop)
    audio = sig[:, 2:T + 1] * _F32(1.0 / 1.5)
    audio[:, 0] = sig[:, 2] * tables[2]
    audio[:, T - 2] = sig[:, T] * tables[9]
    return audio.reshape(B, hop * (T - 1))


def _bytes(x: torch.Tensor) -> np.ndarray:
    """An int8 or bf16 matrix's bytes as uint8 (rows, row bytes)."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    a = x.contiguous().numpy()
    return a.view(np.uint8).reshape(a.shape[0], -1)


def operand_matrices(n_fft: int, int8: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two B operands, K-major (rows = output columns), int8 or
    bf16: synthesis (n_fft samples, 2·bin + {0: cos, 1: sin} over the 512
    aligned bins) and analysis (2·bin + {0: cos, 1: sin}, n_fft samples). The
    interleaving puts a bin's two parts side by side: in the synthesis
    operand row, and in one thread's pair of accumulators of the analysis."""
    m = dft_matrices(n_fft)
    N = n_fft
    ic, is_, fc, fs = ((m["inv8c"], m["inv8s"], m["dftc8"], m["dfts8"]) if int8
                       else (m["invc"], m["invs"], m["dftc"], m["dfts"]))
    syn = torch.stack([ic.t(), is_.t()], -1).reshape(N, N)
    ana = torch.stack([fc.t(), fs.t()], 1).reshape(N, N)
    return syn, ana


def _stream_index(n_rows: int, kb: int):
    """For each u32 of an operand stream: its (row, u32 column) in the matrix.
    Stream order: 256-row chunk, stage of 64 bytes of k, 32-byte k unit,
    pair of 8-row n-tiles, lane, then the mma.sync B fragment's registers
    (n-tile 0: b0, b1; n-tile 1: b0, b1). Lane l of an n-tile holds row
    ``l/4`` and k bytes ``4·(l%4) .. +3`` (b0) and ``+16`` (b1)."""
    nc, spc = n_rows // 256, kb // 64
    NC, ST, KK, NP, LN, J = np.ogrid[:nc, :spc, :2, :16, :32, :4]
    row = 256 * NC + 16 * NP + 8 * (J // 2) + LN // 4
    word = ((2 * ST + KK) * 32 + (LN % 4) * 4 + 16 * (J % 2)) // 4
    return np.broadcast_arrays(row, word)


def pack_operand_stream(mat: np.ndarray) -> np.ndarray:
    """An operand (rows, k bytes) uint8 → its stream in the order the
    kernel's ring consumes it, one 16 KB stage after another (uint8)."""
    rows, kb = mat.shape
    if rows % 256 or kb % 64:
        raise ValueError(f"operand shape {mat.shape}: rows % 256 and k bytes % 64 must be 0")
    row, word = _stream_index(rows, kb)
    return np.ascontiguousarray(mat).view("<u4")[row, word].reshape(-1).view(np.uint8)


def unpack_operand_stream(stream: np.ndarray, rows: int, kb: int) -> np.ndarray:
    out = np.zeros((rows, kb // 4), "<u4")
    row, word = _stream_index(rows, kb)
    out[row, word] = stream.view("<u4").reshape(row.shape)
    return out.view(np.uint8)


def a_word(row, kb):
    """Where the kernel's operand builders put the 4 bytes of A at (row, k
    byte ``kb``, a multiple of 4) in shared memory, as a u32 index: 32-byte k
    unit, 16-row m-tile, lane, then the mma.sync A fragment's register (a0:
    rows 0-7 bytes 0-15, a1: rows 8-15, a2/a3: bytes 16-31). Mirrors
    ``csrc/gl_tc.cu::a_word``."""
    u, kin, mt, rin = kb >> 5, kb & 31, row >> 4, row & 15
    lane = (rin & 7) * 4 + ((kin & 15) >> 2)
    return ((u * 4 + mt) * 32 + lane) * 4 + (rin >> 3) + 2 * (kin >> 4)


@functools.lru_cache(maxsize=8)
def _tc_device_operands(int8: bool, device: torch.device):
    """(synthesis, analysis, final synthesis) streams on ``device``, packed once."""
    def stream(m: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(pack_operand_stream(_bytes(m))).to(device)
    syn, ana = operand_matrices(TC_NFFT, int8)
    fin = operand_matrices(TC_NFFT, False)[0]
    return stream(syn), stream(ana), stream(fin) if int8 else None


def gl_tc_emulate(mag: torch.Tensor, ang_re: torch.Tensor, ang_im: torch.Tensor,
                  n_iter: int, momentum: float, int8: bool = True) -> torch.Tensor:
    """``csrc/gl_tc.cu`` step by step in plain torch (CPU, f64 products): its
    launches, its tiles of ``tc_frames_per_tile(T)`` frames with 3 halo frames
    each side, its shared signal chunks, its state buffers (the angles
    ping-ponged between launches, the rebuilt spectra and the hoisted scale
    written by a frame's own CTA). Equal to :func:`griffin_lim_tc_plain` up to
    the order of f32 sums; a test of the kernel's index arithmetic."""
    B, T, F = mag.shape
    N, hop, Fa, H = TC_NFFT, TC_NFFT // 4, TC_NFFT // 2, TC_HALO
    tf = tc_frames_per_tile(T)
    f64 = torch.float64
    window, tables = gl_window(N), edge_tables(N, hop).reshape(-1)
    wsc = window * torch.tensor(_F32(1.0 / 1.5))
    sign = torch.where(torch.arange(N) % 2 == 0, 1.0, -1.0)
    ops = {q: [m.double() for m in operand_matrices(N, q)] for q in {int8, False}}
    mag = mag.float()
    ang = torch.zeros(2, B, T, N)            # (re, im) of bin k at 2k, 2k+1
    angn = torch.zeros(2, B, T)
    reb, rebn = torch.zeros(B, T, N), torch.zeros(B, T)
    qm_g, deq_g = torch.zeros(B, T, Fa), torch.zeros(B, T)
    audio = torch.zeros(B, T - 1, hop)
    alpha = momentum / (1.0 + momentum)
    wk = torch.full((Fa,), 2.0)
    wk[0] = 1.0
    for launch in range(n_iter + 1):
        final, first = launch == n_iter, launch == 0
        q8 = int8 and not final
        src, dst = launch & 1, (launch + 1) & 1
        syn_op = ops[q8][0]
        for b in range(B):
            for t0 in range(0, T, tf):
                A = torch.zeros(TC_ROWS, N)
                deq_s, nyq_s = torch.zeros(TC_ROWS), torch.zeros(TC_ROWS)
                for i in range(TC_ROWS):
                    f = t0 - H + i
                    if not 0 <= f < T:
                        continue
                    if first:
                        re, im = _bf16r(ang_re[b, f].float()), _bf16r(ang_im[b, f].float())
                        re_n = re[Fa]
                    else:
                        re, im, re_n = ang[src, b, f, 0::2], ang[src, b, f, 1::2], angn[src, b, f]
                    nyq_s[i] = _bf16r(mag[b, f, Fa]) * re_n
                    if q8:
                        if first:
                            mw = _bf16r(mag[b, f, :Fa]) * wk
                            amax = mw.max() + _F32(1e-20)
                            qm = _bf16r(mw * (torch.tensor(_F32(Q_SCALE)) / amax))
                            dq = amax * _F32(1.0 / (Q_SCALE * 127.0 * N))
                            if t0 <= f < t0 + tf:
                                qm_g[b, f], deq_g[b, f] = qm, dq
                        else:
                            qm, dq = qm_g[b, f], deq_g[b, f]
                        deq_s[i] = dq
                        A[i, 0::2], A[i, 1::2] = torch.round(qm * re[:Fa]), torch.round(qm * im[:Fa])
                    else:
                        m = _bf16r(mag[b, f, :Fa])
                        A[i, 0::2], A[i, 1::2] = _bf16r(m * re[:Fa]), _bf16r(m * im[:Fa])
                acc = (A.double() @ syn_op.t()).float()
                sig = torch.full((tf + 3, hop), float("nan"))
                for r in range(4):
                    for i in range(TC_ROWS):
                        sc = t0 - H + i + r - t0
                        if not 0 <= sc < tf + 3:
                            continue
                        cols = slice(r * hop, (r + 1) * hop)
                        fr = acc[i, cols] * deq_s[i] if q8 else acc[i, cols]
                        v = _bf16r((fr + nyq_s[i] * (sign[cols] / N)) * window[cols])
                        sig[sc] = v if r == 0 else sig[sc] + v
                if final:
                    c_hi = T + 1 if t0 + tf >= T else t0 + tf
                    for c in range(max(t0, 2), c_hi):
                        scale = (tables[2 * hop:3 * hop] if c == 2 else
                                 tables[9 * hop:10 * hop] if c == T else _F32(1.0 / 1.5))
                        audio[b, c - 2] = sig[c - t0] * scale
                    continue
                A2 = torch.zeros(TC_ROWS, N)
                deq_a, nyq_a = torch.zeros(TC_ROWS), torch.zeros(TC_ROWS)
                flat = sig.reshape(-1)
                L = hop * (T - 1)
                for i in range(min(tf, T - t0)):
                    t = t0 + i
                    if 3 <= t < T - 3:
                        v = flat[i * hop:i * hop + N]
                        v = v * wsc if q8 else _bf16r(_bf16r(v) * _bf16r(wsc))
                    else:
                        s = hop * t + torch.arange(N) - N // 2
                        s = torch.where(s < 0, -s, torch.where(s >= L, 2 * (L - 1) - s, s))
                        u = s + N // 2
                        c = u // hop
                        row = c if t < 3 else 6 + c - (T - 3)
                        v = (flat[(c - t0) * hop + u % hop] * tables[row * hop + u % hop]) * window
                        v = v if q8 else _bf16r(v)
                    if q8:
                        amax = v.abs().max() + _F32(1e-20)
                        A2[i] = torch.round(v * (torch.tensor(_F32(Q_SCALE)) / amax))
                        deq_a[i] = amax * _F32(1.0 / (Q_SCALE * 127.0))
                    else:
                        A2[i], deq_a[i] = v, 1.0
                    nyq_a[i] = (v * sign).sum()
                acc = (A2.double() @ ops[q8][1].t()).float()
                for i in range(min(tf, T - t0)):
                    t = t0 + i
                    rr, ri = acc[i, 0::2] * deq_a[i], acc[i, 1::2] * deq_a[i]
                    p_re, p_im = (0.0, 0.0) if first else (reb[b, t, 0::2], reb[b, t, 1::2])
                    x_re, x_im = rr - alpha * p_re, ri - alpha * p_im
                    inv = torch.rsqrt(x_re * x_re + x_im * x_im + 1e-32)
                    ang[dst, b, t, 0::2], ang[dst, b, t, 1::2] = _bf16r(x_re * inv), _bf16r(x_im * inv)
                    reb[b, t, 0::2], reb[b, t, 1::2] = rr, ri
                    xn = nyq_a[i] - alpha * (0.0 if first else rebn[b, t])
                    angn[dst, b, t] = _bf16r(xn * torch.rsqrt(xn * xn + 1e-32))
                    rebn[b, t] = nyq_a[i]
    return audio.reshape(B, hop * (T - 1))


def _gl_tc_cuda(mag, ang_re, ang_im, n_iter, momentum, int8, prof=None):
    """Launch ``csrc/gl_tc.cu``; ``prof`` (int64, 32 a launch) takes the
    probe build's phase times (``ops/gl_tc_probe.py``)."""
    B, T, F = mag.shape
    dev = _build.require_cuda(mag, ang_re, ang_im)
    tf = tc_frames_per_tile(T)
    name = "gl_tc" if prof is None else "gl_tc_probe"
    lib = _build.load(name)
    syn, ana, fin = _tc_device_operands(bool(int8), dev)
    window = gl_window(TC_NFFT).to(dev)
    invw = edge_tables(TC_NFFT, TC_NFFT // 4).to(dev)
    BT, bf16 = B * T, torch.bfloat16
    ang = torch.empty(2, BT, TC_NFFT, device=dev, dtype=bf16)   # ping-pong (cos, sin)
    angn = torch.empty(2, BT, device=dev, dtype=bf16)
    reb = torch.empty(BT, TC_NFFT, device=dev)
    rebn = torch.empty(BT, device=dev)
    qm = torch.empty(BT if int8 else 1, TC_NFFT // 2, device=dev, dtype=bf16)
    deq = torch.empty(BT, device=dev)
    audio = torch.empty(B, (TC_NFFT // 4) * (T - 1), device=dev)
    err = lib.spoofsv_gl_tc_run(
        int(bool(int8)), mag.data_ptr(), ang_re.data_ptr(), ang_im.data_ptr(), ang.data_ptr(),
        angn.data_ptr(), reb.data_ptr(), rebn.data_ptr(), qm.data_ptr(), deq.data_ptr(),
        syn.data_ptr(), ana.data_ptr(), (fin if fin is not None else syn).data_ptr(),
        window.data_ptr(), invw.data_ptr(), audio.data_ptr(),
        None if prof is None else prof.data_ptr(), B, T, tf, n_iter,
        ctypes.c_float(momentum / (1.0 + momentum)), _build.stream_ptr(dev))
    _build.check(lib, "gl_tc", err, "griffin_lim_tc kernels")
    gl_tc_kernel.launches += 1
    return audio


def griffin_lim_tc(mag: torch.Tensor, n_fft: int, hop: int,
                   win_length: Optional[int] = None, n_iter: int = 12,
                   momentum: float = 0.99,
                   init_angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   init_mode: str = "spsi", seeds: Optional[torch.Tensor] = None,
                   int8: bool = True) -> torch.Tensor:
    """Griffin-Lim with the TPU kernel's tensor-core arithmetic: ``mag``
    (B, T, F) → audio (B, hop·(T−1)) f32; int8 DFT operands when ``int8``
    (``griffin_lim_int8``), bf16 ones otherwise.

    The init is ``init_angles`` (cos, sin) when given, else
    :func:`gl_init_angles` with ``init_mode``/``seeds``. CPU tensors run
    :func:`griffin_lim_tc_plain`; CUDA tensors run ``csrc/gl_tc.cu``
    (n_fft 1024 only), n_iter + 1 launches.
    """
    win_length = win_length or n_fft
    mag = mag.float().contiguous()
    _check_tc(mag, n_fft, hop, win_length)
    if init_angles is None:
        init_angles = gl_init_angles(mag, n_fft, hop, init_mode, seeds)
    ang_re = init_angles[0].float().expand(mag.shape).contiguous()
    ang_im = init_angles[1].float().expand(mag.shape).contiguous()
    if mag.device.type == "cpu":
        return griffin_lim_tc_plain(mag, ang_re, ang_im, n_fft, hop, n_iter, momentum, int8)
    if n_fft != TC_NFFT:
        raise ValueError(f"griffin_lim_tc: the kernel is built for n_fft={TC_NFFT}, got {n_fft}")
    return _gl_tc_cuda(mag, ang_re, ang_im, n_iter, momentum, int8)
