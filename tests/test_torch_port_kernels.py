"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one.
The file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_kernels.py

(``--noconftest``: the suite's conftest.py configures jax.)
"""

import ctypes

import numpy as np
import pytest
import torch

from spoofsv_torch import reference_precision
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.infer.decode import make_decoder
from spoofsv_torch.models import MelSyn
from spoofsv_torch.ops import _build, decode_kernel, gate_kernel, gl_kernel, hconv_kernel

NFFT, HOP = 1024, 256
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    reference_precision()
    return torch.device("cuda:0")


def _test_mag(B: int, T: int, seed: int, dev, n_fft: int = NFFT, hop: int = HOP) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    L = hop * (T - 1)
    t = np.arange(L) / 22050.0
    sigs = [sum(np.sin(2 * np.pi * 110.0 * (1 + b) * k * t + rng.uniform(0, 6)) / k
                for k in range(1, 6)) + 0.1 * rng.normal(size=L) for b in range(B)]
    re, im = torchdsp.stft_ri(torch.from_numpy(np.stack(sigs) * np.hanning(L)).float().to(dev),
                              n_fft, hop)
    return torch.sqrt(re * re + im * im)[:, :T].contiguous()


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("B,T", [(2, 300), (3, 59), (1, 1), (2, 33), (2, 1300), (1, 3500)])
def test_init_kernel_matches_plain(dev, B, T):
    """K2, all three init modes, at T that is not a multiple of the 32
    segments (59, 33), one frame, the main path's 1300 frames, and past the
    frames whose δ fits shared memory (3500: δ goes through the output
    plane). SPSI: the gate of
    test_pallas_gl.py (cos Δφ ≥ 0.99995) against the plain version and
    against the segment emulation; hash and advance: max |Δ| < 1e-5 (the
    same cosf/sinf of the same angle)."""
    mag = _test_mag(B, T, 7, dev) if T > 1 else _test_mag(B, 8, 7, dev)[:, :1].contiguous()
    seeds = torch.tensor([5, 77, 2 ** 31 - 2][:B], dtype=torch.int32, device=dev)
    for mode in ("spsi", "advance", "random"):
        before = gl_kernel.init_kernel.launches
        k = gl_kernel.gl_init_angles(mag, NFFT, HOP, mode, seeds)
        torch.cuda.synchronize()
        assert gl_kernel.init_kernel.launches == before + 1
        assert k[0].shape == k[1].shape == (B, T, 513)
        refs = [gl_kernel.init_angles_plain(mag, NFFT, HOP, mode, seeds)]
        if mode == "spsi":
            refs.append(gl_kernel.spsi_segments_emulate(mag, NFFT, HOP))
        for p in refs:
            cos_dphi = (k[0] * p[0] + k[1] * p[1]) / torch.sqrt(k[0] ** 2 + k[1] ** 2)
            assert float(cos_dphi.min()) > 0.99995, mode
            if mode != "spsi":
                err = torch.maximum((k[0] - p[0]).abs(), (k[1] - p[1]).abs())
                assert float(err.max()) < 1e-5, mode


def test_gl_kernel_matches_plain(dev):
    """K3: one projection at momentum 0 (gate 0.03 of test_pallas_gl.py; f32
    FFTs on both sides agree far closer), and GL12 spectral convergence."""
    mag = _test_mag(2, 300, 8, dev)
    init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
    got = gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=1, momentum=0.0, init_angles=init)
    ref = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=1, momentum=0.0, init_angles=init)
    assert _rel_l2(got, ref) < 0.03
    g12 = gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=12, init_angles=init)
    r12 = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=12, init_angles=init)
    sc = []
    for audio in (g12, r12):
        re, im = torchdsp.stft_ri(audio, NFFT, HOP)
        sc.append(_rel_l2(torch.sqrt(re * re + im * im)[:, :300], mag))
    assert abs(sc[0] - sc[1]) <= 0.02, sc


def test_plain_gl_takes_dc_and_nyquist_as_real_on_the_card(dev):
    """ROADMAP C.5: from the hash "random" init (imaginary DC and Nyquist
    bins), the plain inverse STFT on the card equals the CPU's (numpy's and
    the JAX package's rule: those parts dropped), and ``gl.cu`` GL64 stays
    within 1e-3 relative L2 of plain f32 GL from the same angles (before
    the repair: 0.031 at 0 iterations, 0.155 at 64)."""
    g = torch.Generator().manual_seed(0)
    mag = (torch.sigmoid(torch.randn(2, 1300, NFFT // 2 + 1, generator=g) * 2 - 1) ** 2.17).to(dev)
    seeds = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    init = gl_kernel.gl_init_angles(mag, NFFT, HOP, "random", seeds)
    cpu = torchdsp.istft_ri(*(mag.cpu() * a.cpu() for a in init), NFFT, HOP)
    card = torchdsp.istft_ri(*(mag * a for a in init), NFFT, HOP)
    assert _rel_l2(card.cpu(), cpu) <= 1e-5
    got = gl_kernel.griffin_lim_fused(mag, NFFT, HOP, n_iter=64, init_angles=init)
    ref = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=64, init_angles=init)
    assert _rel_l2(got, ref) <= 1e-3


# (n_fft, hop, T, win_length): each size's plan (radix split, frames a warp);
# T at the reflect-padding minimum hop·(T−1) > n/2, T not a multiple of the
# run (8 frames at n 1024 and 2048, 16 at 512, 256 at 16), hop n/8, and a
# window shorter than n_fft
GL_PLANS = [(16, 4, 300, 16), (16, 2, 9, 12), (512, 128, 37, 512), (512, 64, 9, 400),
            (1024, 256, 4, 1024), (1024, 256, 19, 1024), (1024, 128, 27, 800),
            (2048, 512, 11, 2048), (2048, 256, 6, 1600)]


@pytest.mark.parametrize("n_fft,hop,T,win", GL_PLANS)
def test_gl_kernel_plans_match_plain(dev, n_fft, hop, T, win):
    """``gl.cu``'s f32 K3 at every plan against plain f32 GL
    (``torchdsp.griffin_lim``, cuFFT) from the same hash phases: 0 and 1
    iterations within 1e-4 relative L2 (f32 transforms on both sides); at 64,
    where momentum grows f32 rounding, no farther from plain f32 GL nor from
    float64 GL (``gl_kernel.gl_reference``) than 3x plain f32 GL's own
    distance from float64 GL, 1e-3 at least (``chip_smoke.py``'s GL64 rule);
    and ``gl_f32_frames`` counts
    B·T·(2·n_iter + 1) frames a call."""
    from spoofsv_torch.utils import profiling

    B = 3
    mag = _test_mag(B, T, 11, dev, n_fft, hop)
    seeds = torch.tensor([5, 77, 9], dtype=torch.int32, device=dev)
    init = gl_kernel.init_angles_plain(mag, n_fft, hop, "random", seeds)
    for n_iter in (0, 1, 64):
        before = profiling.snapshot()["counters"].get("gl_f32_frames", 0)
        got = gl_kernel.griffin_lim_fused(mag, n_fft, hop, win, n_iter=n_iter, init_angles=init)
        assert profiling.snapshot()["counters"]["gl_f32_frames"] - before == B * T * (2 * n_iter + 1)
        ref = torchdsp.griffin_lim(mag, n_fft, hop, win, n_iter=n_iter, init_angles=init)
        assert got.shape == ref.shape == (B, hop * (T - 1))
        if n_iter < 64:
            assert _rel_l2(got, ref) <= 1e-4, (n_iter, _rel_l2(got, ref))
        else:
            exact = gl_kernel.gl_reference(mag.double(), init, n_fft, hop, win, n_iter)
            bound = max(1e-3, 3.0 * _rel_l2(ref.double(), exact))
            rel = (_rel_l2(got, ref), _rel_l2(got.double(), exact), bound)
            assert rel[0] <= bound and rel[1] <= bound, rel


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("B,T", [(2, 300), (1, 16), (3, 59), (1, 117), (8, 480), (8, 800)])
def test_gl_tc_kernel_matches_plain(dev, B, T, int8):
    """The tensor-core K3 against its plain version (the same quantisation
    and state types): one projection at momentum 0 (gate 0.03 of
    test_pallas_gl.py), GL12 spectral convergence within 0.02 of plain f32 GL,
    and the final synthesis alone (n_iter 0). T covers one tile (16), a last
    tile of 3 frames (59: 56-frame tiles), and several tiles; B=8 at 480 and
    800 lin frames are the server's batch and its 120- and 200-frame
    rollouts."""
    mag = _test_mag(B, T, 9, dev)
    init = gl_kernel.init_angles_plain(mag, NFFT, HOP, "spsi")
    for n_iter in (0, 1):
        before = gl_kernel.gl_tc_kernel.launches
        got = gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=n_iter, momentum=0.0,
                                       init_angles=init, int8=int8)
        assert gl_kernel.gl_tc_kernel.launches == before + 1
        ref = gl_kernel.griffin_lim_tc_plain(mag, *init, NFFT, HOP, n_iter, 0.0, int8)
        assert _rel_l2(got, ref) < 0.03, (n_iter, _rel_l2(got, ref))
    g12 = gl_kernel.griffin_lim_tc(mag, NFFT, HOP, n_iter=12, init_angles=init, int8=int8)
    r12 = torchdsp.griffin_lim(mag, NFFT, HOP, n_iter=12, init_angles=init)
    sc = []
    for audio in (g12, r12):
        re, im = torchdsp.stft_ri(audio, NFFT, HOP)
        sc.append(_rel_l2(torch.sqrt(re * re + im * im)[:, :T], mag))
    assert abs(sc[0] - sc[1]) <= 0.02, sc


def test_gl_tc_kernel_rejects_unsupported_geometry(dev):
    with pytest.raises(ValueError):
        gl_kernel.griffin_lim_tc(torch.rand(1, 20, 257, device=dev), 512, 128, n_iter=1,
                                 init_mode="advance")
    with pytest.raises(ValueError):
        gl_kernel.griffin_lim_tc(torch.rand(1, 12, 513, device=dev), NFFT, HOP, n_iter=1,
                                 init_mode="advance")


def test_gl_kernel_rejects_unsupported_geometry(dev):
    mag = torch.rand(1, 20, 300, device=dev)
    with pytest.raises(ValueError):
        gl_kernel.griffin_lim_fused(mag, 598, 128, n_iter=1, init_mode="advance")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_eager(dev, dtype):
    """K1 vs the eager decode at a small width. f32: 1e-4 (summation order);
    bf16: the kernel keeps f32 activations where the eager path rounds every
    op to bf16, so only the frames before the first argmax flip are held,
    at bf16 resolution."""
    torch.manual_seed(0)
    model = MelSyn(34, True, 10, 16, 16, 64).to(dev, dtype).eval()
    g = torch.Generator().manual_seed(1)
    text = torch.randint(1, 33, (6, 12), generator=g).to(dev)
    spk = torch.randn(6, 10, generator=g).to(dev)
    before = decode_kernel.decode_kernel.launches
    y1, a1, p1 = decode_kernel.make_fused_decoder(model, 12)(text, spk)
    assert decode_kernel.decode_kernel.launches == before + 1
    y0, a0, p0 = make_decoder(model, 12)(text, spk)
    if dtype == torch.float32:
        torch.testing.assert_close(y1, y0, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(a1, a0, atol=1e-4, rtol=1e-4)
        assert torch.equal(p1, p0)
    else:
        assert y1.dtype == a1.dtype == torch.bfloat16
        assert bool(torch.isfinite(y1.float()).all())
        torch.testing.assert_close(y1[:, :1].float(), y0[:, :1].float(), atol=0.05, rtol=0.05)


def _cluster_case(dev, B, N, C, freq, seed, condition=True, dtype=torch.bfloat16):
    torch.manual_seed(seed)
    model = MelSyn(34, condition, 10, 16, freq, C).to(dev, dtype).eval()
    g = torch.Generator().manual_seed(seed + 1)
    text = torch.randint(1, 33, (B, N), generator=g).to(dev)
    spk = torch.randn(B, 10, generator=g).to(dev, dtype)
    with torch.no_grad():
        K, V = model.encode_text(text)
        s1 = s2 = None
        if condition:
            s1, s2 = model.audio_encoder.fc1(spk), model.audio_encoder.fc2(spk)
    return decode_kernel.pack_decode_weights(model), K, V, s1, s2


F32, BF16 = torch.float32, torch.bfloat16
# bf16: the gates of chip_smoke.py over frames 0-1 (mel 0.05, attention
# 0.02); f32 (3xTF32 products against decode_plain's f32 ones, sums in
# another order): 1e-4 on both
CLUSTER_TOL = {BF16: (0.05, 0.02), F32: (1e-4, 1e-4)}


@pytest.mark.parametrize("B,N,C,freq,cluster,rows,condition,dtype", [
    (6, 12, 64, 16, 8, 16, True, BF16), (6, 12, 64, 16, 4, 32, False, BF16),
    (5, 9, 32, 16, 4, 16, True, BF16),
    (3, 4, 32, 80, 2, 64, True, BF16),                  # text shorter than the window's reach
    (64, 100, 256, 80, 16, 16, True, BF16), (64, 100, 256, 80, 8, 64, True, BF16),
    (64, 100, 256, 80, 8, 16, True, BF16), (40, 30, 256, 80, 4, 16, True, BF16),
    (40, 30, 256, 80, 16, 32, True, BF16), (70, 20, 256, 80, 8, 32, True, BF16),   # ragged last tile
    (70, 20, 256, 80, 2, 16, True, BF16),
    # the server's rungs at its padded text length (max_text_len 186)
    (1, 186, 256, 80, 16, 16, True, BF16), (2, 186, 256, 80, 16, 16, True, BF16),
    (8, 186, 256, 80, 16, 16, True, BF16),
    (6, 12, 64, 16, 8, 16, True, F32), (6, 12, 64, 16, 4, 32, False, F32),
    (5, 9, 32, 16, 4, 16, True, F32), (3, 4, 32, 80, 2, 64, True, F32),
    (64, 100, 256, 80, 16, 16, True, F32), (16, 186, 256, 80, 16, 16, True, F32),
    (64, 100, 256, 80, 8, 16, True, F32), (40, 30, 256, 80, 4, 16, True, F32),
    (40, 30, 256, 80, 16, 32, True, F32), (70, 20, 256, 80, 8, 32, True, F32)])
def test_decode_cluster_matches_plain(dev, B, N, C, freq, cluster, rows, condition, dtype):
    """K1 (decode_cluster.cu) in bf16 and in f32 against decode_plain over
    frames 0-1 (CLUSTER_TOL) and against the cluster's emulation (3xTF32
    products in f32) over the same frames, pma in range."""
    packed, K, V, s1, s2 = _cluster_case(dev, B, N, C, freq, seed=B + C, condition=condition,
                                         dtype=dtype)
    plan = decode_kernel.decode_cluster_plan(B, C, freq, cluster=cluster, rows=rows,
                                             elem=dtype.itemsize)
    before = decode_kernel.decode_kernel.launches
    counter = decode_kernel.f32_kernel if dtype == F32 else decode_kernel.cluster_kernel
    own = counter.launches
    y, a, p = decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=12, freq_bins=freq,
                                         condition=condition, plan=plan)
    torch.cuda.synchronize()
    assert decode_kernel.decode_kernel.launches == before + 1 and counter.launches == own + 1
    assert y.shape == (B, 12, freq) and a.shape == (B, N, 12) and y.dtype == dtype
    assert bool(torch.isfinite(y.float()).all()) and bool(((p >= 0) & (p < N)).all())
    yq, aq, _ = decode_kernel.decode_plain(packed, K, V, s1, s2, n_frames=2, freq_bins=freq,
                                           condition=condition)
    mel_tol, att_tol = CLUSTER_TOL[dtype]
    assert float((y[:, :2].float() - yq.float()).abs().max()) <= mel_tol
    assert float((a[:, :, :2].float() - aq.float()).abs().max()) <= att_tol
    ye, ae, _ = decode_kernel.decode_cluster_emulate(packed, K, V, s1, s2, plan, 2,
                                                     condition=condition, tf32x3=dtype == F32)
    assert float((y[:, :2].float() - ye.float()).abs().max()) <= mel_tol
    # each frame's attention is one window of three probabilities summing to 1
    torch.testing.assert_close(a.float().sum(1), torch.ones(B, 12, device=dev), atol=2e-2,
                               rtol=0)


def test_decode_cluster_row_is_batch_invariant(dev):
    """Under one plan (16×16) K1's rows are independent: a row run alone
    (B=1, padded to the 16-row tile) and inside a batch of 8 gives bit-equal
    mel, attention and pma for identical K, V and speaker projections (the
    server's solo and co-batched requests at N=186)."""
    packed, K, V, s1, s2 = _cluster_case(dev, 8, 186, 256, 80, seed=11)
    plan8 = decode_kernel.decode_cluster_plan(8, 256, 80)
    plan1 = decode_kernel.decode_cluster_plan(1, 256, 80)
    assert (plan8.cluster, plan8.rows) == (plan1.cluster, plan1.rows) == (16, 16)
    y8, a8, p8 = decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=120, freq_bins=80)
    for i in (0, 5):
        one = [t[i:i + 1].contiguous() for t in (K, V, s1, s2)]
        y1, a1, p1 = decode_kernel.decode_fused(packed, *one, n_frames=120, freq_bins=80)
        assert torch.equal(y1[0], y8[i]) and torch.equal(a1[0], a8[i]) and torch.equal(p1[0], p8[i])


@pytest.mark.parametrize("B,C,freq,cluster,rows,dtype", [
    (5, 64, 16, 8, 16, BF16), (64, 256, 80, 16, 16, BF16), (70, 256, 80, 8, 64, BF16),
    (70, 256, 80, 2, 16, BF16), (5, 64, 16, 8, 16, F32), (64, 256, 80, 16, 16, F32),
    (70, 256, 80, 8, 32, F32), (70, 256, 80, 4, 16, F32)])
def test_decode_cluster_long_rollout_matches_plain(dev, B, C, freq, cluster, rows, dtype):
    """One text position: the attention window cannot move, so no argmax
    flip parts the rollouts, and K1 is held to decode_plain over 64 frames,
    past the first wrap of every ring (2d ≤ 54): a stale or misplaced cache
    tap moves the mel by more than the gate (bf16 0.05; f32 1e-3, phase 4's
    f32 gate)."""
    packed, K, V, s1, s2 = _cluster_case(dev, B, 1, C, freq, seed=B + C + 1, dtype=dtype)
    plan = decode_kernel.decode_cluster_plan(B, C, freq, cluster=cluster, rows=rows,
                                             elem=dtype.itemsize)
    y, a, p = decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=64, freq_bins=freq,
                                         plan=plan)
    yq, _, _ = decode_kernel.decode_plain(packed, K, V, s1, s2, n_frames=64, freq_bins=freq)
    assert float((y.float() - yq.float()).abs().max()) <= (0.05 if dtype == BF16 else 1e-3)
    assert bool((p == 0).all()) and bool((a.float() == 1.0).all())


@pytest.mark.parametrize("dtype,cases", [
    (BF16, [(256, 16, 16, 64), (256, 16, 32, 4), (256, 8, 64, 768), (64, 8, 16, 4),
            (64, 4, 32, 768), (32, 4, 16, 4), (32, 2, 64, 9)]),
    (F32, [(256, 16, 16, 64), (256, 16, 32, 4), (256, 8, 32, 768), (256, 4, 16, 16),
           (64, 8, 16, 4), (64, 4, 32, 768), (32, 4, 16, 4), (32, 2, 64, 9)])])
def test_decode_cluster_smem_matches_plan(dev, dtype, cases):
    lib = _build.load("decode_cluster")
    for C, cluster, rows, B in cases:
        plan = decode_kernel.decode_cluster_plan(B, C, 80, cluster=cluster, rows=rows,
                                                 elem=dtype.itemsize)
        assert lib.spoofsv_decode_cluster_smem(_build.DTYPE_CODES[dtype], C, plan.fpad, cluster,
                                               rows, plan.chunk_bytes,
                                               plan.stages) == plan.smem_bytes


def test_decode_cluster_launch_refusal(dev):
    """A plan the kernel cannot take raises before any launch, the library
    refuses it too, and the card stays usable: no fallback, no count."""
    packed, K, V, s1, s2 = _cluster_case(dev, 4, 8, 64, 16, seed=9)
    before = decode_kernel.decode_kernel.launches
    bad = decode_kernel.ClusterPlan(4, 64, 16, 128, 16, 16, 1)   # 4 channels a CTA
    with pytest.raises(ValueError, match="cluster decode plan refused"):
        decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=2, freq_bins=16, plan=bad)
    lib = _build.load("decode_cluster")
    ptrs = (ctypes.c_void_p * 18)(*([K.data_ptr()] * 18))
    err = lib.spoofsv_decode_cluster_launch(1, ptrs, 16, 16, 1, 2, 8, 16, 128, 64, 1, 16384, 4,
                                            _build.stream_ptr(dev))
    assert err != 0
    assert decode_kernel.decode_kernel.launches == before
    y, _, _ = decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=2, freq_bins=16)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all())


# ---------------------------------------------------------------------------
# K4/K5/K6: highway kernels vs their plain versions. f32: atol/rtol 1e-4 (sums
# of up to K·C = 1536 products in another order, then LayerNorm); bf16: the
# same f32 arithmetic on bf16 operands, outputs within a few bf16 ulps.
# ---------------------------------------------------------------------------

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _hw_params(C, K, dev, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(2 * C, C, K, generator=g) * (2.0 / (K * C)) ** 0.5).to(dev, dtype)
    b = (torch.randn(2 * C, generator=g) * 0.1).to(dev, dtype)
    lns = [(torch.randn(C, generator=g) * 0.2 + (1.0 if i % 2 == 0 else 0.0)).to(dev, dtype)
           for i in range(4)]
    return [w, b, *lns]


def _x(B, T, C, dev, seed, dtype=torch.float32):
    return torch.randn(B, T, C, generator=torch.Generator().manual_seed(seed)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [32, 256, 512])
def test_gate_kernel_matches_plain(dev, C, dtype):
    """K6 on a ragged row count."""
    h = _x(3, 37, 2 * C, dev, 1, dtype)
    x = _x(3, 37, C, dev, 2, dtype)
    lns = _hw_params(C, 1, dev, 3, dtype)[2:]
    before = gate_kernel.gate_kernel.launches
    got = gate_kernel.fused_highway_gate(h, x, *lns)
    assert gate_kernel.gate_kernel.launches == before + 1
    ref = gate_kernel.highway_gate_plain(h, x, *lns)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype,ln_dtype", [(torch.float32, torch.bfloat16),
                                            (torch.bfloat16, torch.float32)])
def test_gate_kernel_takes_ln_in_its_own_type(dev, dtype, ln_dtype):
    """K6 reads the four LayerNorm vectors in their storage type, whatever
    h's and x's, in one launch; C=1024 and C=64 (two and eight lanes a row
    group), a row count that leaves the last warp's second pass empty."""
    for C in (64, 1024):
        h = _x(1, 29, 2 * C, dev, 23, dtype)
        x = _x(1, 29, C, dev, 24, dtype)
        lns = _hw_params(C, 1, dev, 25, ln_dtype)[2:]
        before = gate_kernel.gate_kernel.launches
        got = gate_kernel.fused_highway_gate(h, x, *lns)
        assert gate_kernel.gate_kernel.launches == before + 1
        ref = gate_kernel.highway_gate_plain(h, x, *lns)
        torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T,dil,causal,K", [
    (64, 37, 3, False, 3), (256, 300, 27, True, 3), (512, 50, 1, False, 1),
    (32, 9, 1, False, 3), (512, 186, 27, False, 3),
    # K4's tile: 128 output frames
    (256, 128, 1, False, 3), (256, 129, 1, True, 3), (512, 1300, 1, False, 3),
    (1024, 70, 9, False, 3)])                                          # a cluster of 8
def test_hconv_kernel_matches_plain(dev, C, T, dil, causal, K, dtype):
    """K4: SAME and causal halos, K=1, a sequence shorter than one tile,
    tile edges (128, 129 frames), SSRN hc3's length."""
    x = _x(2, T, C, dev, 4, dtype)
    p = _hw_params(C, K, dev, 5, dtype)
    before = hconv_kernel.hconv_kernel.launches
    got = hconv_kernel.fused_highway_conv(x, *p, dil, causal)
    assert hconv_kernel.hconv_kernel.launches == before + 1
    ref = hconv_kernel.highway_conv_plain(x, *p, dil, causal)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T,da,db,causal,K,B", [
    (256, 70, 1, 3, False, 3, 2), (256, 300, 9, 27, True, 3, 2), (512, 186, 9, 27, False, 3, 2),
    (512, 37, 1, 1, False, 3, 2), (64, 33, 3, 3, True, 3, 2), (32, 8, 1, 1, False, 3, 2),
    # K5's tile: 126 output frames for a (1, 1) pair, 74 for (9, 27)
    (256, 125, 1, 1, False, 3, 2), (256, 127, 1, 1, False, 3, 2), (512, 253, 1, 1, False, 3, 2),
    (512, 150, 9, 27, False, 3, 2), (256, 149, 9, 27, True, 3, 2),   # halo straddles tiles
    (256, 20, 9, 27, False, 3, 2),                                     # shorter than a tile
    (512, 186, 1, 1, False, 1, 2), (256, 100, 1, 1, True, 1, 2),       # K = 1
    (512, 300, 1, 1, False, 3, 1), (256, 325, 1, 3, False, 3, 64),     # B = 1, B = 64
    (256, 100, 1, 50, False, 3, 2),    # 28 output rows: layer B's second warpgroup idles
    (1024, 64, 9, 27, False, 3, 1)])                                   # a cluster of 8
def test_hconv_pair_kernel_matches_plain_and_chained(dev, C, T, da, db, causal, K, B, dtype):
    """K5 against the chained plain blocks and against two chained K4 launches."""
    x = _x(B, T, C, dev, 6, dtype)
    pa, pb = _hw_params(C, K, dev, 7, dtype), _hw_params(C, K, dev, 8, dtype)
    before = hconv_kernel.hconv_pair_kernel.launches
    got = hconv_kernel.fused_highway_conv_pair(x, *pa, *pb, da, db, causal)
    assert hconv_kernel.hconv_pair_kernel.launches == before + 1
    ref = hconv_kernel.highway_pair_plain(x, *pa, *pb, da, db, causal)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    chained = hconv_kernel.fused_highway_conv(
        hconv_kernel.fused_highway_conv(x, *pa, da, causal), *pb, db, causal)
    torch.testing.assert_close(got.float(), chained.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hconv_pair_smem_matches_plan(dev, dtype):
    """The kernel's shared memory per CTA is the wrapper's tile plan's."""
    lib = _build.load("hconv_pair")
    for C in (32, 64, 128, 256, 512, 1024):
        plan = hconv_kernel.pair_tile_plan(C, 3, 1, 100, dtype)
        assert lib.spoofsv_hconv_smem(_build.DTYPE_CODES[dtype], C) == plan.smem_bytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hconv_smem_matches_plan(dev, dtype):
    """K4's shared memory per CTA is its one-layer tile plan's."""
    lib = _build.load("hconv_pair")
    for C in (32, 64, 128, 256, 512, 1024):
        plan = hconv_kernel.pair_tile_plan(C, 3, 27, 100, dtype, layers=1)
        assert lib.spoofsv_hconv_smem(_build.DTYPE_CODES[dtype], C) == plan.smem_bytes


def test_highway_kernel_grads_match_plain_autograd(dev):
    """Backward through each autograd.Function (the plain version recomputed)
    against autograd of the plain version itself."""
    C, T = 64, 40
    cases = [
        (gate_kernel.fused_highway_gate, gate_kernel.highway_gate_plain,
         [_x(2, T, 2 * C, dev, 9), _x(2, T, C, dev, 10)] + _hw_params(C, 1, dev, 11)[2:], ()),
        (hconv_kernel.fused_highway_conv, hconv_kernel.highway_conv_plain,
         [_x(2, T, C, dev, 12)] + _hw_params(C, 3, dev, 13), (3, True)),
        (hconv_kernel.fused_highway_conv_pair, hconv_kernel.highway_pair_plain,
         [_x(2, T, C, dev, 14)] + _hw_params(C, 3, dev, 15) + _hw_params(C, 3, dev, 16),
         (1, 3, False)),
    ]
    for fused, plain, ins, static in cases:
        grads = []
        for fn in (fused, plain):
            ts = [t.clone().requires_grad_(True) for t in ins]
            (fn(*ts, *static) ** 2).sum().backward()
            grads.append([t.grad for t in ts])
        for g, r in zip(*grads):
            torch.testing.assert_close(g, r, atol=5e-4, rtol=1e-4)


def test_highway_launch_failure_raises(dev):
    """A launch the kernel refuses (K5 with a layer-B halo of 128 rows, d_b = 64,
    which leaves its 128-row tile no output frame) raises: no plain fallback,
    no count. Widths the kernels do not take (K4 and K6 below 32 or not a power
    of two) raise ValueError before any launch."""
    C = 256
    x = _x(1, 64, C, dev, 17)
    pa, pb = _hw_params(C, 3, dev, 18), _hw_params(C, 3, dev, 19)
    before = hconv_kernel.hconv_pair_kernel.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        hconv_kernel.fused_highway_conv_pair(x, *pa, *pb, 1, 64, False)
    assert hconv_kernel.hconv_pair_kernel.launches == before
    before = (hconv_kernel.hconv_kernel.launches, gate_kernel.gate_kernel.launches)
    for c in (16, 48):
        with pytest.raises(ValueError):
            hconv_kernel.fused_highway_conv(_x(1, 8, c, dev, 20), *_hw_params(c, 3, dev, 21),
                                            1, False)
        with pytest.raises(ValueError):
            gate_kernel.fused_highway_gate(_x(1, 8, 2 * c, dev, 20), _x(1, 8, c, dev, 21),
                                           *_hw_params(c, 1, dev, 21)[2:])
    assert (hconv_kernel.hconv_kernel.launches, gate_kernel.gate_kernel.launches) == before
    # the card is still usable after the refused launch
    y = hconv_kernel.fused_highway_conv(x, *_hw_params(C, 3, dev, 22), 1, False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
