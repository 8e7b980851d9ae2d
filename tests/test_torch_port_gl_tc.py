"""The tensor-core K3's host pieces and plain version vs the JAX package, on the CPU.

* The int8 and bf16 DFT operands and the hoisted magnitude scale equal what
  ``pallas_gl._gl_kernel`` computes (``pallas_gl.py:150-222``): int8 and bf16
  exactly, the f32 scales to 1e-6 relative.
* ``griffin_lim_tc_plain`` against ``pallas_gl._fused_gl_phase`` in interpret
  mode from the SPSI init, with ``int8_fwd`` True and False: one projection
  at momentum 0 within rel-L2 0.03 (the gate of test_torch_port_gl.py), GL12
  at momentum 0.99 within 0.02 of its spectral convergence.
* ``gl_tc_emulate`` (the kernel's tiles, halos, signal chunks and buffers,
  step by step) against the plain version: the kernel's index arithmetic.
* The operand stream packing and the A-operand word map against the
  mma.sync fragment layouts.
* The vocoder and decoder routes of every configuration value, and the
  ValueError for values the port does not take.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.dsp import jaxdsp
from spoofsv_tpu.ops import pallas_gl
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.infer import synthesize as syn
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


def _spectral_conv(audio, mag) -> float:
    re, im = torchdsp.stft_ri(torch.as_tensor(np.array(audio, np.float32)), NFFT, HOP)
    return _rel_l2(torch.sqrt(re * re + im * im)[:, :mag.shape[1]].numpy(), mag)


def _pallas_operands():
    """The TPU kernel's one-time constants (pallas_gl.py:150-197), in jnp."""
    N, Fa, f32 = NFFT, NFFT // 2, jnp.float32
    ii = jax.lax.broadcasted_iota(jnp.int32, (N, Fa), 0)
    kk = jax.lax.broadcasted_iota(jnp.int32, (N, Fa), 1)
    th = ((ii * kk) % N).astype(f32) * f32(2.0 * np.pi / N)
    k2 = jax.lax.broadcasted_iota(jnp.int32, (Fa, N), 0)
    n2 = jax.lax.broadcasted_iota(jnp.int32, (Fa, N), 1)
    th2 = ((k2 * n2) % N).astype(f32) * f32(2.0 * np.pi / N)
    wk = jnp.where(k2 == 0, 1.0, 2.0).astype(f32) / N
    q = lambda x: jnp.round(x * 127.0).astype(jnp.int8)   # noqa: E731
    return {"dftc": jnp.cos(th).astype(jnp.bfloat16), "dfts": (-jnp.sin(th)).astype(jnp.bfloat16),
            "invc": (wk * jnp.cos(th2)).astype(jnp.bfloat16),
            "invs": (-wk * jnp.sin(th2)).astype(jnp.bfloat16),
            "dftc8": q(jnp.cos(th)), "dfts8": q(-jnp.sin(th)),
            "inv8c": q(jnp.cos(th2)), "inv8s": q(-jnp.sin(th2))}


def test_dft_operands_equal_pallas_gl():
    ref = _pallas_operands()
    got = gl_kernel.dft_matrices(NFFT)
    for name, r in ref.items():
        g = got[name]
        assert g.dtype == (torch.int8 if "8" in name else torch.bfloat16), name
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                      err_msg=name)


def test_qm_hoist_equals_pallas_gl():
    """qm and its dequantisation (pallas_gl.py:204-222) from the bf16 magnitudes."""
    mag = _test_mag(2, 40, seed=5)
    mag[1, 3] = 0.0                                     # a silent frame: amax = 1e-20
    N, Fa, f32 = NFFT, NFFT // 2, jnp.float32
    m = jnp.asarray(mag).astype(jnp.bfloat16)
    wk = jnp.where(jnp.arange(Fa) == 0, 1.0, 2.0).astype(f32)
    mw = m[..., :Fa].astype(f32) * wk
    amax = jnp.max(mw, axis=-1, keepdims=True) + f32(1e-20)
    qm_ref = (mw * (f32(126.5) / amax)).astype(jnp.bfloat16)
    deq_ref = amax * f32(1.0 / (126.5 * 127.0 * N))
    qm, deq = gl_kernel.hoist_qm(torch.from_numpy(mag), N)
    assert qm.dtype == torch.bfloat16 and deq.shape == (2, 40, 1)
    np.testing.assert_allclose(qm.float().numpy(), np.asarray(qm_ref.astype(f32)), rtol=1e-6)
    np.testing.assert_allclose(deq.numpy(), np.asarray(deq_ref), rtol=1e-6)
    assert float(qm.float().abs().max()) <= 126.5 * (1 + 2 ** -8)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("n_iter,momentum", [(1, 0.0), (12, 0.99)])
def test_plain_matches_pallas_kernel(int8, n_iter, momentum):
    """B=2, T=32 from the SPSI init: the port's f32 init (K2's plain version)
    against the init computed inside the Pallas kernel."""
    mag = _test_mag(2, 32, seed=3)
    _, _, ref = pallas_gl._fused_gl_phase(jnp.asarray(mag), jnp.zeros(2, jnp.int32), NFFT, HOP,
                                          n_iter, momentum, True, int8, init_mode="spsi")
    init = gl_kernel.gl_init_angles(torch.from_numpy(mag), NFFT, HOP, "spsi")
    got = gl_kernel.griffin_lim_tc_plain(torch.from_numpy(mag), *init, NFFT, HOP, n_iter,
                                         momentum, int8)
    assert got.shape == ref.shape == (2, HOP * 31)
    if n_iter == 1:
        assert _rel_l2(got.numpy(), ref) < 0.03
    else:
        sc_got, sc_ref = _spectral_conv(got.numpy(), mag), _spectral_conv(ref, mag)
        assert abs(sc_got - sc_ref) <= 0.02, (sc_got, sc_ref)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("T", [16, 59, 70])
def test_emulation_of_the_kernel_matches_plain(T, int8):
    """One tile (T=16), a last tile of 3 frames (T=59: 56-frame tiles), and
    two tiles with a short last one (T=70). f64 products in the emulation,
    f32 in the plain version: int8 sums are exact in both, bf16 ones differ
    in their last bits."""
    mag = torch.from_numpy(_test_mag(1, T, seed=T))
    init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
    got = gl_kernel.gl_tc_emulate(mag, *init, 2, 0.99, int8)
    ref = gl_kernel.griffin_lim_tc_plain(mag, *init, NFFT, HOP, 2, 0.99, int8)
    assert _rel_l2(got, ref) < (1e-4 if int8 else 3e-3)
    assert bool(torch.isfinite(got).all())


def test_tiles_keep_three_frames_in_the_last():
    for T in range(16, 3001):
        tf = gl_kernel.tc_frames_per_tile(T)
        last = T - tf * (-(-T // tf) - 1)
        assert 3 <= tf <= gl_kernel.TC_MAX_FRAMES and 3 <= last <= tf, (T, tf, last)
    assert gl_kernel.tc_frames_per_tile(1300) == 58


@pytest.mark.parametrize("int8", [True, False])
def test_operand_streams_follow_the_fragment_layout(int8):
    """The packed B operands against the mma.sync B fragment (lane l, n-tile
    row l/4, k bytes 4(l%4)..+3 in b0 and +16 in b1), and the A word map
    against the A fragment (a0/a1 rows l/4 and +8, a2/a3 bytes +16)."""
    for mat in gl_kernel.operand_matrices(NFFT, int8):
        mb = gl_kernel._bytes(mat)
        assert mb.shape == (NFFT, NFFT if int8 else 2 * NFFT)
        st = gl_kernel.pack_operand_stream(mb)
        assert st.size == mb.size and st.size % gl_kernel.TC_STAGE == 0
        np.testing.assert_array_equal(gl_kernel.unpack_operand_stream(st, *mb.shape), mb)
        words = st.view("<u4").reshape(4, -1, 2, 16, 32, 4)
        nc, s, kk, p, lane, j = 1, 3, 1, 5, 13, 3       # one word, by the PTX definition
        row = 256 * nc + 16 * p + 8 * (j // 2) + lane // 4
        kb = (2 * s + kk) * 32 + 4 * (lane % 4) + 16 * (j % 2)
        assert words[nc, s, kk, p, lane, j] == mb[row, kb:kb + 4].view("<u4")[0]
    kb_max = 1024 if int8 else 2048
    rows, kbs = np.meshgrid(np.arange(64), np.arange(0, kb_max, 4), indexing="ij")
    idx = gl_kernel.a_word(rows, kbs).reshape(-1)
    j, lane, mt, u = idx % 4, (idx // 4) % 32, (idx // 128) % 4, idx // 512
    np.testing.assert_array_equal(mt * 16 + lane // 4 + 8 * (j % 2), rows.reshape(-1))
    np.testing.assert_array_equal(u * 32 + 4 * (lane % 4) + 16 * (j // 2), kbs.reshape(-1))
    assert len(np.unique(idx)) == idx.size == 64 * kb_max // 4


def _cfg(tiny_cfg, **tpu):
    return tiny_cfg.replace(tpu=dataclasses.replace(tiny_cfg.tpu, **tpu))


@pytest.mark.parametrize("impl,precision,cpu,card", [
    ("auto", "default", "xla", "tc"),
    ("auto", "highest", "xla", "f32"),
    ("pallas", "default", "tc", "tc"),
    ("pallas", "highest", "tc", "tc"),
    ("xla", "default", "xla", "xla"),
    ("xla", "highest", "xla", "xla"),
])
def test_gl_routes(tiny_cfg, impl, precision, cpu, card):
    cfg = _cfg(tiny_cfg, griffin_lim_impl=impl, griffin_lim_precision=precision)
    assert syn.gl_route(cfg, "cpu") == cpu
    assert syn.gl_route(cfg, torch.device("cuda", 0)) == card


@pytest.mark.parametrize("impl,int8", [("pallas", True), ("pallas", False), ("xla", True),
                                       ("auto", True)])
def test_vocoder_runs_the_route_on_the_cpu(tiny_cfg, impl, int8):
    """On the CPU "pallas" runs the tensor-core K3's plain version (int8 or
    bf16 operands), "xla" and "auto" plain f32 GL from the plain init."""
    cfg = _cfg(tiny_cfg, griffin_lim_impl=impl, griffin_lim_int8=int8, griffin_lim_iters=2)
    lin = torch.rand(2, 20, cfg.lin_bins, generator=torch.Generator().manual_seed(4))
    got = syn.make_vocoder(cfg)(lin)
    spec = torch.pow(lin / lin.amax(dim=(1, 2), keepdim=True),
                     cfg.norm.reconstruction_power / cfg.norm.analysis_power)
    init = gl_kernel.init_angles_plain(spec, NFFT, HOP, "spsi")
    if impl == "pallas":
        audio = gl_kernel.griffin_lim_tc_plain(spec, *init, NFFT, HOP, 2, 0.99, int8)
    else:
        audio = torchdsp.griffin_lim(spec, NFFT, HOP, NFFT, 2, init_angles=init)
    np.testing.assert_allclose(got.numpy(), torchdsp.deemphasis(audio, cfg.preemph).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("impl,route", [("auto", "kernel"), ("pallas", "kernel"),
                                        ("xla", "plain"), ("scan", "plain")])
def test_decode_routes(tiny_cfg, impl, route):
    from spoofsv_torch.models import SSRN, MelSyn

    cfg = _cfg(tiny_cfg, decode_impl=impl)
    assert syn.decode_route(cfg) == route
    m = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, cfg.mel.freq_bins,
               cfg.hidden_dim)
    s = syn.Synthesizer(cfg, m, SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim), n_frames=6)
    assert s.decode_route == route


@pytest.mark.parametrize("field,value", [
    ("griffin_lim_impl", "fused"), ("griffin_lim_precision", "high"),
    ("griffin_lim_int8", 1), ("griffin_lim_int8", "yes"), ("decode_impl", "triton"),
])
def test_unknown_route_values_raise(tiny_cfg, field, value):
    from spoofsv_torch.models import SSRN, MelSyn

    cfg = _cfg(tiny_cfg, **{field: value})
    m = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, cfg.mel.freq_bins,
               cfg.hidden_dim)
    with pytest.raises(ValueError, match=field):
        syn.Synthesizer(cfg, m, SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim), n_frames=6)


def test_tc_wrapper_checks_geometry_and_takes_the_plain_version_on_the_cpu():
    mag = torch.from_numpy(_test_mag(1, 20, seed=2))
    init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "advance")
    got = gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=2, init_angles=init)
    ref = gl_kernel.griffin_lim_tc_plain(mag, *init, NFFT, HOP, 2, 0.99, True)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        gl_kernel.griffin_lim_tc(mag[:, :12], NFFT, HOP, n_iter=1, init_angles=init)
    with pytest.raises(ValueError):
        gl_kernel.griffin_lim_tc(mag, NFFT, 128, n_iter=1, init_angles=init)
    assert gl_kernel.gl_tc_kernel.launches == 0
