"""K4's and K5's host-side pieces on the CPU (one kernel template,
``csrc/hconv_pair.cu``): the TF32 hi/lo split, the kernels' tiling and
operand layout emulated in plain torch with 3xTF32 products, and the tile
plan at every block and pair the models run through them.

The emulations walk the tiles as the kernel does (K5: y1 rows; K4: 128
output frames, each tap's 128 operand rows fetched at their own offset;
cluster column slices, zero fill outside the sequence, output rows per tile)
and form each product as x_lo·w_hi + x_hi·w_lo + x_hi·w_hi of TF32 parts in
f32, which is the kernel's arithmetic up to summation order; they are held
against the plain versions at 1e-4, the card's f32 gate, and K4's also
against the JAX package's ``fused_highway_conv`` in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spoofsv_torch.config import Config
from spoofsv_torch.models import SSRN, MelSyn, layers
from spoofsv_torch.ops import gate_kernel, hconv_kernel
from spoofsv_torch.ops.hconv_kernel import (PAIR_ROWS, highway_conv_plain, highway_pair_plain,
                                            pad_left, pair_tile_plan, pair_weight_operand,
                                            tf32_split)
from spoofsv_tpu.ops import pallas_conv

SMEM_PER_CTA = 232448   # H100: 227 KB of dynamic shared memory per block


def _params(C, K, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(2 * C, C, K)) * (2.0 / (K * C)) ** 0.5
    b = rng.normal(size=(2 * C,)) * 0.1
    lns = [rng.normal(size=(C,)) * 0.2 + (1.0 if i % 2 == 0 else 0.0) for i in range(4)]
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in (w, b, *lns)]


def _x(B, T, C, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(B, T, C)).astype(np.float32))


def _mm_3xtf32(a, w):
    """a (R, K·C) @ w (N, K·C)ᵀ as the kernel forms it: TF32 parts, f32 sums."""
    a_hi, a_lo = tf32_split(a)
    w_hi, w_lo = tf32_split(w)
    return a_lo @ w_hi.T + a_hi @ w_lo.T + a_hi @ w_hi.T


def _block(rows, p, cluster):
    """One highway block over tile rows: ``rows`` (R, K, C) the tap-shifted
    operand, residual rows[:, tap of the frame itself] supplied by the caller.
    Returns h (R, 2C) with bias, each CTA's columns from its weight slice."""
    R, K, C = rows.shape
    ch = C // cluster
    op = pair_weight_operand(p[0], cluster)           # (cluster, 2·ch, K·C)
    a = rows.reshape(R, K * C)
    h = torch.empty(R, 2 * C)
    for r in range(cluster):
        hr = _mm_3xtf32(a, op[r])
        h[:, r * ch:(r + 1) * ch] = hr[:, :ch]
        h[:, C + r * ch:C + (r + 1) * ch] = hr[:, ch:]
    return h + p[1]


def _emulate_k5(x, pa, pb, da, db, causal):
    B, T, C = x.shape
    K = pa[0].shape[-1]
    plan = pair_tile_plan(C, K, db, T, torch.float32)
    pal, pbl = pad_left(K, da, causal), pad_left(K, db, causal)
    out = torch.full_like(x, float("nan"))
    zero = torch.zeros(C)

    def frame(b, f):
        return x[b, f] if 0 <= f < T else zero

    for b in range(B):
        for tile in range(plan.tiles):
            t0 = tile * plan.rows_out
            f1 = [t0 - pbl + j for j in range(plan.rows_a)]      # y1 row j's frame
            rows = torch.stack([torch.stack([frame(b, f - pal + k * da) for k in range(K)])
                                for f in f1])
            res = torch.stack([frame(b, f) for f in f1])
            y1 = gate_kernel.highway_gate_plain(_block(rows, pa, plan.cluster), res, *pa[2:])
            y1[[not 0 <= f < T for f in f1]] = 0.0
            y1 = torch.cat([y1, torch.zeros(plan.rows_b + db * (K - 1), C)])  # zero-filled rows
            rows_b = torch.stack([y1[[r + k * db for r in range(plan.rows_b)]]
                                  for k in range(K)], dim=1)
            y = gate_kernel.highway_gate_plain(_block(rows_b, pb, plan.cluster),
                                               y1[pbl:pbl + plan.rows_b], *pb[2:])
            n = min(plan.rows_out, T - t0)
            out[b, t0:t0 + n] = y[:n]
    return out


def _window(xb, start, n=PAIR_ROWS):
    """Rows start .. start + n of xb (T, C), zeros outside [0, T): one TMA box."""
    idx = torch.arange(start, start + n)
    ok = (idx >= 0) & (idx < xb.shape[0])
    w = torch.zeros(n, xb.shape[1])
    w[ok] = xb[idx[ok]]
    return w


def _emulate_k4(x, p, d, causal):
    B, T, C = x.shape
    K = p[0].shape[-1]
    plan = pair_tile_plan(C, K, d, T, torch.float32, layers=1)
    left = pad_left(K, d, causal)
    out = torch.full_like(x, float("nan"))
    for b in range(B):
        for tile in range(plan.tiles):
            t0 = tile * plan.rows_out
            # tap k's operand: x at frames t0 - left + k·d .. + 127
            rows = torch.stack([_window(x[b], t0 - left + k * d) for k in range(K)], dim=1)
            y = gate_kernel.highway_gate_plain(_block(rows, p, plan.cluster), _window(x[b], t0),
                                               *p[2:])
            n = min(plan.rows_out, T - t0)
            out[b, t0:t0 + n] = y[:n]
    return out


@pytest.mark.parametrize("C,T,d,causal,K", [
    (32, 20, 1, False, 3),      # shorter than one tile
    (64, 128, 1, False, 3),     # exactly one tile
    (64, 129, 3, False, 3),     # one frame into the second tile
    (32, 300, 27, True, 3),     # causal d=27: the 54-frame halo straddles tiles
    (64, 150, 1, False, 1),     # K = 1
    (256, 140, 1, False, 3),    # a cluster of 2
])
def test_k4_tiling_with_3xtf32_matches_plain_and_jax(C, T, d, causal, K):
    x, p = _x(2, T, C, 11), _params(C, K, 12)
    got = _emulate_k4(x, p, d, causal)
    torch.testing.assert_close(got, highway_conv_plain(x, *p, d, causal), atol=1e-4, rtol=1e-4)
    jp = [jnp.asarray(p[0].permute(2, 1, 0).numpy())] + [jnp.asarray(v.numpy()) for v in p[1:]]
    ref = pallas_conv.fused_highway_conv(jnp.asarray(x.numpy()), *jp, dilation=d, causal=causal,
                                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_tf32_split():
    """hi is TF32 (low 13 mantissa bits zero), so is lo, and hi + lo is w to
    2⁻²² relative, over magnitudes from 1e-30 to 1e30 of both signs."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(-30, 30, 4096))
                         .astype(np.float32))
    w[:4] = torch.tensor([0.0, -0.0, 1.0, -3.0])
    hi, lo = tf32_split(w)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - w.double()).abs() / w.double().abs().clamp_min(1e-300))
    assert float(rel.max()) <= 2.0 ** -22
    # hi is the nearest TF32: |w - hi| within half a TF32 ulp of w
    assert bool(((w - hi).abs() <= w.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("C,T,da,db,causal,K", [
    (32, 8, 1, 1, False, 3),        # shorter than one tile
    (64, 126, 1, 1, False, 3),      # one whole tile (rows_out = 126)
    (64, 127, 1, 1, False, 3),      # one frame into the second tile
    (32, 125, 1, 1, False, 3),      # one frame short of a tile
    (256, 150, 9, 27, False, 3),    # a cluster of 2; the (9, 27) halo straddles tiles
    (32, 149, 9, 27, True, 3),      # causal (9, 27)
    (64, 40, 1, 1, False, 1),       # K = 1
    (256, 40, 1, 3, True, 3),       # causal (1, 3), a cluster of 2
])
def test_k5_tiling_with_3xtf32_matches_plain(C, T, da, db, causal, K):
    x, pa, pb = _x(2, T, C, 1), _params(C, K, 2), _params(C, K, 3)
    ref = highway_pair_plain(x, *pa, *pb, da, db, causal)
    got = _emulate_k5(x, pa, pb, da, db, causal)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_pair_weight_operand_layout():
    """CTA r's row j < CH is h1 column r·CH + j, row CH + j is h2 column
    C + r·CH + j; column k·C + i is input channel i of tap k."""
    C, K, n = 8, 3, 2
    w = torch.arange(2 * C * C * K, dtype=torch.float32).reshape(2 * C, C, K)
    op = pair_weight_operand(w, n)
    assert op.shape == (n, 2 * C // n, K * C)
    ch = C // n
    for r in range(n):
        for j in range(ch):
            for k in range(K):
                for i in range(C):
                    assert op[r, j, k * C + i] == w[r * ch + j, i, k]
                    assert op[r, ch + j, k * C + i] == w[C + r * ch + j, i, k]


@pytest.fixture(scope="module")
def model_pairs():
    """(C, K, d_a, d_b, causal) of every pair the shipping-width MelSyn and
    SSRN fuse under "fused_pair" (N=64, T=80: every pair fuses)."""
    cfg = Config()
    seen = set()
    real = layers.fused_highway_conv_pair

    def record(x, wa, *rest):
        seen.add((x.shape[-1], wa.shape[-1], *rest[-3:]))
        return real(x, wa, *rest)

    torch.manual_seed(0)
    melsyn = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                    cfg.mel.freq_bins, cfg.hidden_dim).eval()
    ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim).eval()
    text = torch.randint(1, cfg.vocab_len - 1, (1, 64))
    mel = torch.rand(1, 80, cfg.mel.freq_bins)
    layers.fused_highway_conv_pair = record
    try:
        with layers.gate_impl("fused_pair"), torch.no_grad():
            melsyn(mel, text, torch.randn(1, cfg.spk_emb_dim))
            ssrn(mel)
    finally:
        layers.fused_highway_conv_pair = real
    return sorted(seen)


@pytest.fixture(scope="module")
def model_blocks():
    """(C, K, d, causal) of every block the shipping-width MelSyn and SSRN run
    through K4 under "fused_conv"."""
    cfg = Config()
    seen = set()
    real = layers.fused_highway_conv

    def record(x, w, b, s1, b1, s2, b2, dilation, causal):
        seen.add((x.shape[-1], w.shape[-1], dilation, causal))
        return real(x, w, b, s1, b1, s2, b2, dilation, causal)

    torch.manual_seed(0)
    melsyn = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                    cfg.mel.freq_bins, cfg.hidden_dim).eval()
    ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim).eval()
    text = torch.randint(1, cfg.vocab_len - 1, (1, 64))
    mel = torch.rand(1, 80, cfg.mel.freq_bins)
    layers.fused_highway_conv = record
    try:
        with layers.gate_impl("fused_conv"), torch.no_grad():
            melsyn(mel, text, torch.randn(1, cfg.spk_emb_dim))
            ssrn(mel)
    finally:
        layers.fused_highway_conv = real
    return sorted(seen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hconv_tile_plan_fits_every_model_block(model_blocks, dtype):
    """Every block the models run through K4 fits one CTA's shared memory and
    a portable cluster, with 128 output frames a tile covering the sequence."""
    assert {b[0] for b in model_blocks} == {256, 512}, model_blocks
    assert {b[2] for b in model_blocks} >= {1, 3, 9, 27} and any(b[1] == 1 for b in model_blocks)
    for C, K, d, causal in model_blocks:
        for T in (186, 325, 1300):
            plan = pair_tile_plan(C, K, d, T, dtype, layers=1)
            assert plan.smem_bytes <= SMEM_PER_CTA, (C, K, d, plan)
            assert 1 <= plan.cluster <= 8 and plan.cluster * plan.channels == C
            assert plan.rows_a == plan.rows_out == PAIR_ROWS and plan.rows_b == 0
            assert (plan.tiles - 1) * plan.rows_out < T <= plan.tiles * plan.rows_out
            assert plan.executed_over_useful(T) >= 1.0


def test_hconv_tile_plan_numbers():
    """SSRN hc3 (C=512) at T=1300: 11 tiles of 128 frames (1.083× the useful
    rows), a cluster of 4, K5's ring and shared memory; the audio encoder
    (C=256) at T=325: 3 tiles, a cluster of 2."""
    p = pair_tile_plan(512, 3, 1, 1300, torch.float32, layers=1)
    assert (p.layers, p.rows_out, p.rows_b, p.tiles, p.cluster, p.channels, p.stages) == \
        (1, 128, 0, 11, 4, 128, 5)
    assert p.smem_bytes == pair_tile_plan(512, 3, 1, 1300, torch.float32).smem_bytes
    assert abs(p.executed_over_useful(1300) - 11 * 128 / 1300) < 1e-12
    q = pair_tile_plan(256, 3, 27, 325, torch.bfloat16, layers=1)
    assert (q.rows_out, q.tiles, q.cluster, q.stages) == (128, 3, 2, 8)
    with pytest.raises(ValueError):
        pair_tile_plan(256, 3, 1, 100, torch.float32, layers=3)


def test_k4_wrapper_cpu_takes_plain():
    """On CPU tensors K4's wrapper is the plain block (no build, no count),
    at a width the kernel would refuse too."""
    C, T = 16, 20
    x, p = _x(1, T, C, 13), _params(C, 3, 14)
    before = hconv_kernel.hconv_kernel.launches
    got = hconv_kernel.fused_highway_conv(x, *p, 3, True)
    assert hconv_kernel.hconv_kernel.launches == before
    torch.testing.assert_close(got, highway_conv_plain(x, *p, 3, True), atol=0, rtol=0)


def test_model_pairs_are_the_known_set(model_pairs):
    widths = {p[0] for p in model_pairs}
    assert widths == {256, 512}, model_pairs
    assert {(p[2], p[3]) for p in model_pairs} >= {(1, 3), (9, 27), (1, 1), (3, 3)}
    assert any(p[1] == 1 for p in model_pairs)    # the text encoder's K = 1 pair


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_tile_plan_fits_every_model_pair(model_pairs, dtype):
    """Every pair the models fuse fits one CTA's shared memory, a portable
    cluster, and the 128 y1 rows hold every row layer B reads."""
    for C, K, da, db, causal in model_pairs:
        for T in (186, 325, 1300):
            plan = pair_tile_plan(C, K, db, T, dtype)
            assert plan.smem_bytes <= SMEM_PER_CTA, (C, K, db, plan)
            assert 1 <= plan.cluster <= 8 and plan.cluster * plan.channels == C
            assert plan.rows_a == PAIR_ROWS
            # layer B's output rows and its halo stay within layer A's rows
            assert 1 <= plan.rows_out and plan.rows_out + db * (K - 1) <= plan.rows_a
            assert plan.rows_out <= plan.rows_b <= plan.rows_a and plan.rows_b % 64 == 0
            assert (plan.tiles - 1) * plan.rows_out < T <= plan.tiles * plan.rows_out
            assert plan.executed_over_useful(T) >= 1.0


def test_pair_tile_plan_numbers():
    """hc3→hc4 (C=512, K=3, d_b=1) at T=1300: 126 output rows per tile, 11
    tiles, a cluster of 4; layer A's recompute is the halo alone."""
    p = pair_tile_plan(512, 3, 1, 1300, torch.float32)
    assert (p.rows_out, p.rows_b, p.tiles, p.cluster, p.channels, p.stages) == \
        (126, 128, 11, 4, 128, 5)
    assert p.smem_bytes == 1024 + 5 * (128 * 64 + 2 * 256 * 64) + 8 * 4 * 128 * 2 + 8 * 5
    assert abs(p.executed_over_useful(1300) - 11 * 256 / 2600) < 1e-12
    # the (9, 27) pair: 74 output rows, layer B over both warpgroups' 128
    q = pair_tile_plan(512, 3, 27, 186, torch.bfloat16)
    assert (q.rows_out, q.rows_b, q.tiles, q.stages) == (74, 128, 3, 8)
    # a halo of 100 rows leaves 28: layer B's second warpgroup idles
    assert pair_tile_plan(256, 3, 50, 100, torch.float32).rows_b == 64
    # a halo of 128 rows leaves layer B nothing: the kernel refuses it
    assert pair_tile_plan(256, 3, 64, 100, torch.float32).rows_out == 0


def test_k5_wrapper_cpu_takes_plain():
    """On CPU tensors the wrapper is the plain chain (no build, no count)."""
    C, T = 32, 20
    x, pa, pb = _x(1, T, C, 4), _params(C, 3, 5), _params(C, 3, 6)
    before = hconv_kernel.hconv_pair_kernel.launches
    got = hconv_kernel.fused_highway_conv_pair(x, *pa, *pb, 1, 3, False)
    assert hconv_kernel.hconv_pair_kernel.launches == before
    torch.testing.assert_close(got, highway_pair_plain(x, *pa, *pb, 1, 3, False), atol=0, rtol=0)
