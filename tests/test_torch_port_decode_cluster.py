"""The K1 cluster kernel's host pieces, bf16 and f32, on the CPU.

``csrc/decode_cluster.cu`` runs only on a card; what surrounds it is plain
torch and is held here: the plan (its refusals, tiles covering the batch,
shared memory within the card's limit), the weight stream in mma.sync
fragment order for both dtypes (``unpack(pack(p)) == p`` exactly) and the
cluster's decomposition (:func:`decode_cluster_emulate`, also with the f32
kernel's 3xTF32 products) against ``decode_plain`` in f32 at 1e-5 over 20
frames, and against the JAX package's Pallas decode kernel in interpret
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.ops.pallas_decode import make_fused_decoder as j_make_fused_decoder
from spoofsv_tpu.train.steps import shift_right
from spoofsv_torch.models import MelSyn
from spoofsv_torch.ops import decode_kernel as dk
from spoofsv_torch.weights import load_melsyn_from_jax

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("C", [32, 64, 256, 512])
@pytest.mark.parametrize("B", [1, 16, 64, 768])
def test_plan_covers_batch_and_fits(B, C, elem):
    plan = dk.decode_cluster_plan(B, C, 80, elem=elem)
    assert plan.refusal() is None and plan.elem == elem
    assert plan.bp >= B and (plan.tiles - 1) * plan.rows < B
    assert plan.rows in (16, 32, 64) and plan.C % plan.cluster == 0
    assert plan.ch % 8 == 0 and plan.ft % 8 == 0 and plan.fpad == 128
    assert plan.smem_bytes <= dk.SMEM_LIMIT
    assert plan.cta_elems == sum(K * n * 8 for K, n in plan.layers)
    # every CTA's share of the frame's products, summed, is the whole weight set
    total = 16 * 3 * C * 2 * C + 5 * C * C + 128 * C + 2 * C * C + C * 128
    assert plan.cluster * plan.cta_elems == total
    # every chunk of the stream holds whole k rows of 256·elem bytes a block
    assert all(ncol * plan.block_bytes <= plan.chunk_bytes for _, ncol in plan.layers)
    # no plan the kernel takes runs in fewer waves on the card
    others = []
    for n in (16, 8, 4, 2, 1):
        for rows in (16, 32, 64):
            try:
                others.append(dk.decode_cluster_plan(B, C, 80, cluster=n, rows=rows, elem=elem))
            except ValueError:
                pass
    assert plan in others and plan.waves == min(p.waves for p in others)


def test_plan_defaults_at_the_main_path():
    """B=64 (the main path) and B=768 (the bench batch) run in one wave, and
    the default at C=256 is the plan the card measured fastest (or within
    1.1 % of it at B=768): 16 rows, the cluster shrinking as tiles grow."""
    p64 = dk.decode_cluster_plan(64, 256, 80)
    assert (p64.cluster, p64.rows, p64.tiles, p64.waves) == (16, 16, 4, 1)
    # 0.85 MB of bf16 weights per CTA per frame at a cluster of 16
    assert p64.cta_elems * 2 == 851968
    p768 = dk.decode_cluster_plan(768, 256, 80)
    assert (p768.cluster, p768.rows, p768.tiles, p768.waves) == (2, 16, 48, 1)
    assert p768.bp >= 768 and p768.stages == 4
    picks = {B: (p.cluster, p.rows) for B in (112, 113, 128, 240, 241, 256, 480, 481, 512)
             for p in [dk.decode_cluster_plan(B, 256, 80)]}
    assert picks == {112: (16, 16), 113: (8, 16), 128: (8, 16), 240: (8, 16), 241: (4, 16),
                     256: (4, 16), 480: (4, 16), 481: (2, 16), 512: (2, 16)}


def test_plan_defaults_f32():
    """f32 (the Trainer's validation at B=16, the phase-4 timing at B=64):
    one wave of 16×16 tiles, as in bf16; 1.7 MB of f32 weights per CTA per
    frame, twice the bf16 stream, in twice the chunks."""
    p16 = dk.decode_cluster_plan(16, 256, 80, elem=4)
    assert (p16.cluster, p16.rows, p16.tiles, p16.waves, p16.stages) == (16, 16, 1, 1, 8)
    p64 = dk.decode_cluster_plan(64, 256, 80, elem=4)
    assert (p64.cluster, p64.rows, p64.tiles, p64.waves) == (16, 16, 4, 1)
    assert p64.cta_elems * 4 == 2 * 851968 and p64.block_bytes == 1024
    b64 = dk.decode_cluster_plan(64, 256, 80)
    assert p64.chunks_per_frame == 105 and b64.chunks_per_frame == 56
    assert p64.l2_bytes_per_frame == 2 * b64.l2_bytes_per_frame


@pytest.mark.parametrize("kw,B,C,match", [
    (dict(cluster=16), 4, 64, "channels"),          # 4 channels a CTA: no n8 block
    (dict(cluster=3), 4, 96, "power of two"),
    (dict(rows=48), 4, 256, "rows"),
    (dict(cluster=16, rows=64), 64, 512, "shared memory"),
    (dict(cluster=1, rows=64), 64, 512, "column blocks"),
    ({}, 4, 48, "hidden % 32"),
    ({}, 0, 64, "batch"),
    (dict(cluster=2, elem=4), 64, 256, "whole k row"),   # 32 KB of f32 highway k row
    (dict(cluster=16, rows=64, elem=4), 64, 256, "shared memory"),
    (dict(elem=8), 4, 64, "bytes"),
])
def test_plan_refusals(kw, B, C, match):
    with pytest.raises(ValueError, match=match):
        dk.decode_cluster_plan(B, C, 80, **kw)


def _packed(C=64, freq=16, seed=0, dtype=torch.float32, condition=True):
    torch.manual_seed(seed)
    model = MelSyn(34, condition, 10, 16, freq, C).eval()
    return model, dk.pack_decode_weights(model, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,cluster", [(32, 4), (64, 8), (64, 2), (256, 16), (256, 8)])
def test_stream_round_trip_is_exact(C, cluster, dtype):
    _, packed = _packed(C=C, dtype=dtype)
    plan = dk.decode_cluster_plan(3, C, 16, cluster=cluster, elem=dtype.itemsize)
    stream = dk.pack_decode_stream(packed, plan)
    assert stream.shape == (cluster, plan.cta_elems) and stream.dtype == dtype
    back = dk.unpack_decode_stream(stream, plan)
    for k in dk.MATRIX_NAMES:
        assert torch.equal(back[k], packed[k]), k


@pytest.mark.parametrize("elem", [2, 4])
def test_stream_fragment_order(elem):
    """bf16 (m16n8k16): lane l = 4g + t of block (kp, j) holds column 8j + g
    at k rows 32kp + {2t, 2t+1, 2t+8, 2t+9} and the same 16 further on.
    f32 (m16n8k8 on TF32): the block's first 512 bytes hold k rows 0-15,
    its second 16-31; lane l's four values in each are column 8j + g at k
    rows 4t to 4t + 3 (b0, b1 of one k8 step, then of the next, in the k
    order the kernel gives A too)."""
    C = 64
    plan = dk.decode_cluster_plan(2, C, 16, cluster=2, elem=elem)
    w = torch.arange(128 * C, dtype=torch.float32).reshape(128, C)   # enc_w1: (fpad, C)
    _, packed = _packed(C=C)
    packed = dict(packed, enc_w1=w)
    stream = dk.pack_decode_stream(packed, plan)
    ncol = plan.ch // 8
    for rank in range(2):
        if elem == 2:
            blocks = stream[rank, :128 * plan.ch].reshape(4, ncol, 1, 32, 8)
        else:
            blocks = stream[rank, :128 * plan.ch].reshape(4, ncol, 2, 32, 4)
        for kp, j, lane in [(0, 0, 0), (1, 1, 5), (3, 3, 31), (2, 0, 17)]:
            g, t = lane // 4, lane % 4
            col = rank * plan.ch + 8 * j + g
            if elem == 2:
                ks = [[32 * kp + 16 * h + k for h in (0, 1)
                       for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]]
            else:
                ks = [[32 * kp + 16 * q + 4 * t + e for e in range(4)] for q in (0, 1)]
            for q, kq in enumerate(ks):
                assert blocks[kp, j, q, lane].tolist() == w[kq, col].tolist()


def _inputs(B, N, C, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    K = torch.randn(B, N, C, generator=g).to(dtype)
    V = torch.randn(B, N, C, generator=g).to(dtype)
    s1, s2 = (0.3 * torch.randn(B, C, generator=g)).to(dtype), (0.3 * torch.randn(B, C, generator=g)).to(dtype)
    return K, V, s1, s2


@pytest.mark.parametrize("C,cluster,condition", [(64, 8, True), (64, 4, False), (32, 4, True),
                                                 (256, 16, True)])
def test_emulate_matches_decode_plain_f32(C, cluster, condition):
    """The cluster decomposition is decode_plain's arithmetic in another
    summation order: f32, 20 frames (every ring with d ≤ 9 wraps), 1e-5."""
    model, packed = _packed(C=C, condition=condition)
    B, N, T = 5, 9, 20
    K, V, s1, s2 = _inputs(B, N, C, seed=1)
    if not condition:
        s1 = s2 = None
    plan = dk.decode_cluster_plan(B, C, 16, cluster=cluster)
    got = dk.decode_cluster_emulate(packed, K, V, s1, s2, plan, T, condition=condition)
    ref = dk.decode_plain(packed, K, V, s1, s2, n_frames=T, freq_bins=16, condition=condition)
    assert got[0].shape == ref[0].shape == (B, T, 16) and got[1].shape == ref[1].shape == (B, N, T)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=1e-5)
    assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("C,cluster,condition", [(64, 8, True), (32, 4, False), (256, 16, True)])
def test_emulate_tf32x3_matches_decode_plain_f32(C, cluster, condition):
    """The f32 kernel's arithmetic: each product's operands split into TF32
    hi and lo as the kernel splits its fragments, hi·hi + hi·lo + lo·hi.
    That holds an f32 product to ~2⁻²² relative, so over 20 frames it
    stays within 1e-5 of decode_plain in f32 and picks the same pma."""
    model, packed = _packed(C=C, condition=condition)
    B, N, T = 5, 9, 20
    K, V, s1, s2 = _inputs(B, N, C, seed=4)
    if not condition:
        s1 = s2 = None
    plan = dk.decode_cluster_plan(B, C, 16, cluster=cluster, elem=4)
    got = dk.decode_cluster_emulate(packed, K, V, s1, s2, plan, T, condition=condition,
                                    tf32x3=True)
    ref = dk.decode_plain(packed, K, V, s1, s2, n_frames=T, freq_bins=16, condition=condition)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=1e-5)
    assert torch.equal(got[2], ref[2])
    # the split is not a no-op: TF32 alone (hi·hi) moves the mel by far more
    hi = {k: (dk.tf32_split(v)[0] if k in dk.MATRIX_NAMES else v) for k, v in packed.items()}
    one = dk.decode_plain(hi, K, V, s1, s2, n_frames=T, freq_bins=16, condition=condition)
    assert float((one[0] - ref[0]).abs().max()) > 10 * float((got[0] - ref[0]).abs().max())


def test_emulate_matches_decode_plain_bf16_first_frames():
    """In bf16 the two round the same values; over frames 0-1 they agree within
    the card's gates (mel 0.05, attention 0.02)."""
    C = 64
    _, packed = _packed(C=C, dtype=torch.bfloat16)
    K, V, s1, s2 = _inputs(6, 10, C, seed=2, dtype=torch.bfloat16)
    plan = dk.decode_cluster_plan(6, C, 16)
    y, a, _ = dk.decode_cluster_emulate(packed, K, V, s1, s2, plan, 2)
    yq, aq, _ = dk.decode_plain(packed, K, V, s1, s2, n_frames=2, freq_bins=16)
    assert y.dtype == a.dtype == torch.bfloat16
    assert float((y.float() - yq.float()).abs().max()) <= 0.05
    assert float((a.float() - aq.float()).abs().max()) <= 0.02


@pytest.mark.parametrize("tf32x3", [False, True])
def test_emulate_matches_pallas_decode_interpret(tf32x3):
    """The cluster emulation (f32, and with the f32 kernel's 3xTF32
    products) against the JAX package's fused Pallas decode kernel in f32
    (interpret mode) on the same JAX-initialised weights: the gates of
    tests/test_torch_port_decode.py (2e-5 / 1e-4, pma equal)."""
    rng = np.random.default_rng(3)
    B, N, C, freq, T = 3, 12, 32, 16, 10
    jm = JMelSyn(vocab_len=34, condition=True, spk_emb_dim=10, text_emb_dim=16,
                 freq_bins=freq, hidden_dim=C)
    text = rng.integers(1, 33, (B, N)).astype(np.int32)
    spk = rng.normal(size=(B, 10)).astype(np.float32)
    mel = rng.uniform(0.05, 0.95, (B, 4, freq)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), shift_right(jnp.asarray(mel)), jnp.asarray(text),
                     jnp.asarray(spk))
    y0, a0, p0 = j_make_fused_decoder(jm, T, interpret=True)(params, jnp.asarray(text),
                                                              jnp.asarray(spk))
    tm = load_melsyn_from_jax(MelSyn(34, True, 10, 16, freq, C), params).eval()
    with torch.no_grad():
        K, V = tm.encode_text(torch.from_numpy(text))
        s = torch.from_numpy(spk)
        s1, s2 = tm.audio_encoder.fc1(s), tm.audio_encoder.fc2(s)
    packed = dk.pack_decode_weights(tm)
    plan = dk.decode_cluster_plan(B, C, freq, cluster=4, elem=4 if tf32x3 else 2)
    y1, a1, p1 = dk.decode_cluster_emulate(packed, K, V, s1, s2, plan, T, tf32x3=tf32x3)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a0), atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(p1.numpy(), np.asarray(p0))
