"""The f32 K3's plan (``csrc/gl.cu``) emulated in plain torch on the CPU.

``gl_kernel.gl_plan`` is the kernels' plan (radix split, lanes and frames a
warp, run lengths); ``stockham_emulate``, ``rfft_emulate``,
``irfft_emulate`` and ``gl_f32_emulate`` follow the kernels pass by pass:
the lanes' butterflies and twiddles, the swizzled exchange, the real/complex
split and merge, the analysis runs with their staged signal (reflect-padded
first and last runs, a short last run). They are held against ``torch.fft``
(1e-12 in float64, 1e-5 in float32), against ``torchdsp.griffin_lim`` where
hop divides n, and against ``gk.gl_reference``, plain Griffin-Lim of any hop
(1e-5 relative in float32, 1e-9 in float64). Small shapes: the whole file
takes a few seconds.
"""

import numpy as np
import pytest
import torch

from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.ops import gl_kernel as gk


def _tab(n: int, dtype=torch.complex128) -> torch.Tensor:
    return torch.from_numpy(np.exp(-2j * np.pi * np.arange(n // 2) / n)).to(dtype)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).flatten()) / torch.linalg.norm(b.flatten()))


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_plan_covers_every_size(n):
    """Radices multiply to n/2 and divide a lane's values, at most two
    exchanges, the frames of a block fill its 8 warps, shared memory within
    a block's 227 KB at hop n/4 and, by shorter analysis runs, at any hop."""
    p = gk.gl_plan(n, n // 4)
    assert int(np.prod(p["radices"])) == p["N2"] == p["E"] * p["P"]
    assert all(p["E"] % r == 0 for r in p["radices"]) and len(p["radices"]) <= 3
    assert p["frames"] == p["frames_max"] == 8 * 32 // p["P"]
    assert max(p["smem_synth"], p["smem_analysis"]) <= gk.SMEM_LIMIT
    wide = gk.gl_plan(n, 50 * n)
    assert 1 <= wide["frames"] < p["frames"] and wide["smem_analysis"] <= gk.SMEM_LIMIT


@pytest.mark.parametrize("n", [1024, 2048])
def test_exchange_is_free_of_bank_conflicts(n):
    """Where one warp holds a frame, every store and load of the exchange
    arrays by its 32 lanes falls in 32 distinct banks."""
    p = gk.gl_plan(n, n // 4)
    N2, E, P, ns = p["N2"], p["E"], p["P"], 1
    for q, R in enumerate(p["radices"]):
        g = np.arange(P)
        for b in range(E // R):
            for r in range(R):
                j = g + P * b
                if q:
                    assert len(set(gk._swz(j + r * (N2 // R)) % 32)) == 32
                if q + 1 < len(p["radices"]):
                    assert len(set(gk._swz((j // ns) * ns * R + j % ns + r * ns) % 32)) == 32
        ns *= R


@pytest.mark.parametrize("n", [16, 256, 1024, 2048])
def test_transforms_match_torch_fft(n):
    """The real transforms through the plan's passes and the split/merge
    against torch.fft, in float64 and float32."""
    p = gk.gl_plan(n, n // 4)
    g = torch.Generator().manual_seed(n)
    x = torch.randn(3, n, generator=g, dtype=torch.float64)
    ref = torch.fft.rfft(x)
    assert _rel(gk.rfft_emulate(x, p, _tab(n)), ref) < 1e-12
    assert _rel(gk.irfft_emulate(ref, p, _tab(n)) / n, torch.fft.irfft(ref, n=n)) < 1e-12
    x32, ref32 = x.float(), ref.to(torch.complex64)
    assert _rel(gk.rfft_emulate(x32, p, _tab(n, torch.complex64)), ref) < 1e-5
    assert _rel(gk.irfft_emulate(ref32, p, _tab(n, torch.complex64)) / n,
                torch.fft.irfft(ref, n=n)) < 1e-5


# (n, hop, T, win_length): hops n/4, n/8 and one that does not divide n;
# T past one analysis run with a short last run, or at the reflect-padding
# minimum hop·(T−1) > n/2
CASES = [(16, 4, 300, 16), (16, 2, 9, 12), (16, 5, 21, 16),
         (256, 64, 40, 256), (256, 32, 37, 200), (256, 75, 4, 256),
         (1024, 256, 19, 1024), (1024, 128, 12, 800), (1024, 300, 11, 1024),
         (1024, 256, 4, 1024), (2048, 512, 11, 2048), (2048, 600, 3, 1600)]


@pytest.mark.parametrize("n,hop,T,win", CASES)
def test_gl_f32_emulate_matches_plain(n, hop, T, win):
    """The kernels' Griffin-Lim step by step (0, 1 and 2 iterations from hash
    phases, momentum 0.99) against plain GL: float64 at 1e-9 (the plan's
    algebra and indices), float32 at 1e-5; where hop divides n also against
    ``torchdsp.griffin_lim``."""
    assert hop * (T - 1) > n // 2
    F = n // 2 + 1
    g = torch.Generator().manual_seed(n + hop + T)
    mag = torch.rand(2, T, F, generator=g, dtype=torch.float64) ** 2
    ang = tuple(a.double() for a in gk.hash_phase_init(torch.tensor([3, 9]), T, F))
    for it in (0, 1, 2):
        ref = gk.gl_reference(mag, ang, n, hop, win, it, 0.99)
        got = gk.gl_f32_emulate(mag, *ang, n, hop, win, n_iter=it, dtype=torch.float64)
        assert _rel(got, ref) < 1e-9, (it, _rel(got, ref))
        got32 = gk.gl_f32_emulate(mag, *ang, n, hop, win, n_iter=it)
        assert _rel(got32, ref.float()) < 1e-5, (it, _rel(got32, ref.float()))
        if n % hop == 0:
            plain = torchdsp.griffin_lim(mag.float(), n, hop, win, n_iter=it, momentum=0.99,
                                         init_angles=tuple(a.float() for a in ang))
            assert _rel(got32, plain) < 1e-5, (it, _rel(got32, plain))
