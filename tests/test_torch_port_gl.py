"""The port's Griffin-Lim path vs the JAX package, f32 on the CPU.

Plain versions (what the K2/K3 wrappers run for CPU tensors) against
``jaxdsp`` and the Pallas kernels in interpret mode. Tolerances: hash bits
equal; SPSI angles 1e-5 vs ``jaxdsp.gl_spsi_angles`` and ≥ 0.99995 cos Δφ vs
the bf16-output Pallas kernel (the gate of test_pallas_gl.py); K2's
segmented SPSI scan (:func:`spsi_segments_emulate`) against all three; 12 GL
iterations rel-L2 ≤ 1e-3 vs ``jaxdsp.griffin_lim`` (both f32 FFT paths); one
iteration < 0.03 vs the bf16 Pallas GL kernel; de-emphasis 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.dsp import jaxdsp
from spoofsv_tpu.ops import pallas_gl
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.ops import gl_kernel

NFFT, HOP = 1024, 256


def _test_mag(B: int, T: int, seed: int = 0) -> np.ndarray:
    """|STFT| of harmonic test signals (GL needs realistic structure)."""
    rng = np.random.default_rng(seed)
    L = HOP * (T - 1)
    t = np.arange(L) / 22050.0
    sigs = [sum(np.sin(2 * np.pi * 110.0 * (1 + b) * k * t + rng.uniform(0, 6)) / k
                for k in range(1, 6)) + 0.1 * rng.normal(size=L) for b in range(B)]
    y = jnp.asarray(np.stack(sigs) * np.hanning(L), jnp.float32)
    re, im = jaxdsp.stft_ri(y, NFFT, HOP, NFFT, use_matmul=False)
    return np.array(jnp.sqrt(re ** 2 + im ** 2)[:, :T, :], np.float32)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("seed", [0, 1, 987654321, 2 ** 31 - 2, -7])
def test_hash_mix_bits_equal(seed):
    tt = np.arange(300)[:, None]
    kk = np.arange(513)[None, :]
    ref = np.asarray(pallas_gl._hash_mix(jnp.asarray(tt, jnp.int32), jnp.asarray(kk, jnp.int32),
                                         jnp.int32(seed))).view(np.uint32)
    got = gl_kernel._hash_mix(torch.from_numpy(tt), torch.from_numpy(kk), torch.tensor(seed))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_hash_phase_init_matches():
    seeds = np.array([3, 99, 2 ** 30], np.int32)
    r0, i0 = pallas_gl.hash_phase_init(jnp.asarray(seeds), 40, 513)
    r1, i1 = gl_kernel.gl_init_angles(torch.zeros(3, 40, 513), NFFT, HOP, "random",
                                      torch.from_numpy(seeds))
    # the JAX mirror casts to bf16; same phases to bf16 rounding
    np.testing.assert_allclose(r1.numpy(), np.asarray(r0, np.float32), atol=4e-3)
    np.testing.assert_allclose(i1.numpy(), np.asarray(i0, np.float32), atol=4e-3)


def test_spsi_and_advance_match_jaxdsp():
    mag = _test_mag(3, 70, seed=21)
    re0, im0 = jaxdsp.gl_spsi_angles(jnp.asarray(mag), NFFT, HOP)
    re1, im1 = gl_kernel.gl_init_angles(torch.from_numpy(mag), NFFT, HOP, "spsi")
    np.testing.assert_allclose(re1.numpy(), np.asarray(re0), atol=1e-5)
    np.testing.assert_allclose(im1.numpy(), np.asarray(im0), atol=1e-5)
    a0, b0 = jaxdsp.gl_advance_angles(70, 513, NFFT, HOP)
    a1, b1 = gl_kernel.gl_init_angles(torch.from_numpy(mag), NFFT, HOP, "advance")
    np.testing.assert_allclose(a1[1].numpy(), np.asarray(a0), atol=1e-5)
    np.testing.assert_allclose(b1[2].numpy(), np.asarray(b0), atol=1e-5)


def test_spsi_matches_pallas_kernel_phase():
    mag = _test_mag(3, 70, seed=21)
    re_k, im_k = pallas_gl.gl_spsi_angles_fused(jnp.asarray(mag), NFFT, HOP, interpret=True)
    re_k, im_k = np.asarray(re_k, np.float32), np.asarray(im_k, np.float32)
    re1, im1 = gl_kernel.gl_init_angles(torch.from_numpy(mag), NFFT, HOP, "spsi")
    cos_dphi = (re_k * re1.numpy() + im_k * im1.numpy()) / np.sqrt(re_k ** 2 + im_k ** 2)
    assert float(cos_dphi.min()) > 0.99995, float(cos_dphi.min())


@pytest.mark.parametrize("T", [1, 33, 59, 70, 300])
def test_spsi_segments_match_plain_jaxdsp_and_pallas(T):
    """K2's decomposition of the SPSI cumsum (32 segments of ⌈T/32⌉ frames,
    their totals scanned, each segment walked again from its prefix) at T
    that is not a multiple of the segment, T=1 (one warp's frame) and the
    main path's F=513. Only the cumsum's association order differs from the
    plain version and jaxdsp, so the angles agree to its f32 rounding: a walk
    of √T roundings of ulp(T/2) (|δ| ≤ 1/2), times 2π·hop/N radians, at
    least 1e-5 (the plain version's gate against jaxdsp); against the
    bf16-output Pallas kernel the gate of test_pallas_gl.py, cos Δφ ≥
    0.99995."""
    mag = _test_mag(2, T, seed=T) if T > 1 else _test_mag(2, 8, seed=1)[:, :1]
    tol = max(1e-5, 2 * np.pi * HOP / NFFT * np.sqrt(T) * float(np.spacing(np.float32(T / 2))))
    re_e, im_e = gl_kernel.spsi_segments_emulate(torch.from_numpy(mag), NFFT, HOP)
    assert re_e.shape == im_e.shape == (2, T, 513)
    re_p, im_p = gl_kernel.init_angles_plain(torch.from_numpy(mag), NFFT, HOP, "spsi")
    np.testing.assert_allclose(re_e.numpy(), re_p.numpy(), atol=tol)
    np.testing.assert_allclose(im_e.numpy(), im_p.numpy(), atol=tol)
    re0, im0 = jaxdsp.gl_spsi_angles(jnp.asarray(mag), NFFT, HOP)
    np.testing.assert_allclose(re_e.numpy(), np.asarray(re0), atol=tol)
    np.testing.assert_allclose(im_e.numpy(), np.asarray(im0), atol=tol)
    re_k, im_k = pallas_gl.gl_spsi_angles_fused(jnp.asarray(mag), NFFT, HOP, interpret=True)
    re_k, im_k = np.asarray(re_k, np.float32), np.asarray(im_k, np.float32)
    cos_dphi = (re_k * re_e.numpy() + im_k * im_e.numpy()) / np.sqrt(re_k ** 2 + im_k ** 2)
    assert float(cos_dphi.min()) > 0.99995, float(cos_dphi.min())


def test_spsi_segments_split_the_frames():
    """The segments partition the frames: with one segment the emulation is
    the sequential cumsum, and with as many segments as frames each prefix
    is the scan of single frames; both give the plain angles."""
    mag = torch.from_numpy(_test_mag(1, 40, seed=5))
    ref = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
    for segments in (1, 7, 40, 64):
        got = gl_kernel.spsi_segments_emulate(mag, NFFT, HOP, segments=segments)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)


def test_stft_istft_match_jaxdsp():
    rng = np.random.default_rng(3)
    y = rng.normal(size=(2, HOP * 30)).astype(np.float32)
    re0, im0 = jaxdsp.stft_ri(jnp.asarray(y), NFFT, HOP, NFFT, use_matmul=False)
    re1, im1 = torchdsp.stft_ri(torch.from_numpy(y), NFFT, HOP)
    np.testing.assert_allclose(re1.numpy(), np.asarray(re0), atol=1e-4)
    np.testing.assert_allclose(im1.numpy(), np.asarray(im0), atol=1e-4)
    y0 = jaxdsp.istft_ri(re0, im0, NFFT, HOP, NFFT, use_matmul=False)
    y1 = torchdsp.istft_ri(re1, im1, NFFT, HOP)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=1e-5)
    np.testing.assert_allclose(y1.numpy(), y, atol=1e-5)


@pytest.mark.parametrize("mode", ["spsi", "advance"])
def test_griffin_lim12_matches_jaxdsp(mode):
    mag = _test_mag(2, 60, seed=4)
    if mode == "spsi":
        init = jaxdsp.gl_spsi_angles(jnp.asarray(mag), NFFT, HOP)
    else:
        init = tuple(jnp.broadcast_to(a, mag.shape)
                     for a in jaxdsp.gl_advance_angles(60, 513, NFFT, HOP))
    ref = jaxdsp.griffin_lim(jnp.asarray(mag), jax.random.PRNGKey(0), NFFT, HOP, NFFT,
                             n_iter=12, use_matmul=False, init_angles=init)
    got = gl_kernel.griffin_lim_fused(torch.from_numpy(mag), NFFT, HOP, n_iter=12,
                                      init_mode=mode)
    assert got.shape == ref.shape == (2, HOP * 59)
    assert _rel_l2(got.numpy(), ref) <= 1e-3


def test_one_iteration_matches_pallas_gl_kernel():
    """One projection (momentum 0) from the hash init vs the bf16 Pallas kernel."""
    mag = _test_mag(2, 20, seed=1)
    seeds = np.array([11, 2024], np.int32)
    _, _, ref = pallas_gl._fused_gl_phase(jnp.asarray(mag, jnp.bfloat16), jnp.asarray(seeds),
                                          NFFT, HOP, 1, 0.0, True, False)
    got = gl_kernel.griffin_lim_fused(torch.from_numpy(mag), NFFT, HOP, n_iter=1,
                                      momentum=0.0, init_mode="random",
                                      seeds=torch.from_numpy(seeds))
    assert _rel_l2(got.numpy(), ref) < 0.03


def test_deemphasis_matches_jaxdsp():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5000)).astype(np.float32)
    ref = np.asarray(jaxdsp.deemphasis(jnp.asarray(x), coeff=0.97))
    got = torchdsp.deemphasis(torch.from_numpy(x), coeff=0.97).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
