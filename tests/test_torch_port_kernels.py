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
from spoofsv_torch.ops import decode_kernel, gl_kernel

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
