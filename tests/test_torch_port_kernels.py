"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one.
The file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_kernels.py

(``--noconftest``: the suite's conftest.py configures jax.)
"""

import numpy as np
import pytest
import torch

from spoofsv_torch import reference_precision
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.infer.decode import make_decoder
from spoofsv_torch.models import MelSyn
from spoofsv_torch.ops import decode_kernel, gate_kernel, gl_kernel, hconv_kernel

NFFT, HOP = 1024, 256
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    reference_precision()
    return torch.device("cuda:0")


def _test_mag(B: int, T: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    L = HOP * (T - 1)
    t = np.arange(L) / 22050.0
    sigs = [sum(np.sin(2 * np.pi * 110.0 * (1 + b) * k * t + rng.uniform(0, 6)) / k
                for k in range(1, 6)) + 0.1 * rng.normal(size=L) for b in range(B)]
    re, im = torchdsp.stft_ri(torch.from_numpy(np.stack(sigs) * np.hanning(L)).float().to(dev),
                              NFFT, HOP)
    return torch.sqrt(re * re + im * im)[:, :T].contiguous()


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def test_init_kernel_matches_plain(dev):
    """K2: all three init modes; the gate of test_pallas_gl.py (cos Δφ)."""
    mag = _test_mag(2, 300, 7, dev)
    seeds = torch.tensor([5, 77], dtype=torch.int32, device=dev)
    for mode in ("spsi", "advance", "random"):
        before = gl_kernel.init_kernel.launches
        k = gl_kernel.gl_init_angles(mag, NFFT, HOP, mode, seeds)
        assert gl_kernel.init_kernel.launches == before + 1
        p = gl_kernel.init_angles_plain(mag, NFFT, HOP, mode, seeds)
        cos_dphi = (k[0] * p[0] + k[1] * p[1]) / torch.sqrt(k[0] ** 2 + k[1] ** 2)
        assert float(cos_dphi.min()) > 0.99995, mode


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


def test_decode_kernel_rows_per_block_bit_identical(dev):
    """1, 2 and 4 batch rows per block give the same bits."""
    torch.manual_seed(2)
    model = MelSyn(34, True, 10, 16, 16, 64).to(dev, torch.bfloat16).eval()
    packed = decode_kernel.pack_decode_weights(model)
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 33, (5, 12), generator=g).to(dev)
    spk = torch.randn(5, 10, generator=g).to(dev, torch.bfloat16)
    with torch.no_grad():
        K, V = model.encode_text(text)
        s1, s2 = model.audio_encoder.fc1(spk), model.audio_encoder.fc2(spk)
    outs = [decode_kernel.decode_fused(packed, K, V, s1, s2, n_frames=20, freq_bins=16,
                                       rows=rows) for rows in (1, 2, 4)]
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], out))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T,dil,causal,K", [
    (64, 37, 3, False, 3), (256, 300, 27, True, 3), (512, 50, 1, False, 1),
    (16, 9, 1, False, 3), (512, 186, 27, False, 3)])
def test_hconv_kernel_matches_plain(dev, C, T, dil, causal, K, dtype):
    """K4: SAME and causal halos, K=1, a sequence shorter than one tile."""
    x = _x(2, T, C, dev, 4, dtype)
    p = _hw_params(C, K, dev, 5, dtype)
    before = hconv_kernel.hconv_kernel.launches
    got = hconv_kernel.fused_highway_conv(x, *p, dil, causal)
    assert hconv_kernel.hconv_kernel.launches == before + 1
    ref = hconv_kernel.highway_conv_plain(x, *p, dil, causal)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T,da,db,causal", [
    (256, 70, 1, 3, False), (256, 300, 9, 27, True), (512, 186, 9, 27, False),
    (512, 37, 1, 1, False), (64, 33, 3, 3, True), (32, 8, 1, 1, False)])
def test_hconv_pair_kernel_matches_plain_and_chained(dev, C, T, da, db, causal, dtype):
    """K5 against the chained plain blocks and against two chained K4 launches."""
    x = _x(2, T, C, dev, 6, dtype)
    pa, pb = _hw_params(C, 3, dev, 7, dtype), _hw_params(C, 3, dev, 8, dtype)
    before = hconv_kernel.hconv_pair_kernel.launches
    got = hconv_kernel.fused_highway_conv_pair(x, *pa, *pb, da, db, causal)
    assert hconv_kernel.hconv_pair_kernel.launches == before + 1
    ref = hconv_kernel.highway_pair_plain(x, *pa, *pb, da, db, causal)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    chained = hconv_kernel.fused_highway_conv(
        hconv_kernel.fused_highway_conv(x, *pa, da, causal), *pb, db, causal)
    torch.testing.assert_close(got.float(), chained.float(), atol=TOL[dtype], rtol=TOL[dtype])


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
    """A launch the card refuses (K5's y1 tile at C=1024 with a 54-frame halo
    needs more than 227 KB of shared memory) raises: no plain fallback, no count."""
    C = 1024
    x = _x(1, 64, C, dev, 17)
    pa, pb = _hw_params(C, 3, dev, 18), _hw_params(C, 3, dev, 19)
    before = hconv_kernel.hconv_pair_kernel.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        hconv_kernel.fused_highway_conv_pair(x, *pa, *pb, 9, 27, False)
    assert hconv_kernel.hconv_pair_kernel.launches == before
    with pytest.raises(ValueError):
        hconv_kernel.fused_highway_conv(_x(1, 8, 48, dev, 20), *_hw_params(48, 3, dev, 21),
                                        1, False)
    # the card is still usable after the refused launch
    y = hconv_kernel.fused_highway_conv(x[..., :512].contiguous(), *_hw_params(512, 3, dev, 22),
                                        1, False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
