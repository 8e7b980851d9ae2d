"""The bf16 K1 cluster kernel's host pieces, on the CPU.

``csrc/decode_cluster.cu`` runs only on a card; what surrounds it is plain
torch and is held here: the plan (its refusals, tiles covering the batch,
shared memory within the card's limit), the weight stream in mma.sync
fragment order (``unpack(pack(p)) == p`` exactly) and the cluster's
decomposition (:func:`decode_cluster_emulate`) against ``decode_plain`` in
f32 at 1e-5 over 20 frames, and through ``decode_plain`` against the JAX
package's Pallas decode kernel in interpret mode.
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


@pytest.mark.parametrize("C", [32, 64, 256, 512])
@pytest.mark.parametrize("B", [1, 16, 64, 768])
def test_plan_covers_batch_and_fits(B, C):
    plan = dk.decode_cluster_plan(B, C, 80)
    assert plan.refusal() is None
    assert plan.bp >= B and (plan.tiles - 1) * plan.rows < B
    assert plan.rows in (16, 32, 64) and plan.C % plan.cluster == 0
    assert plan.ch % 8 == 0 and plan.ft % 8 == 0 and plan.fpad == 128
    assert plan.smem_bytes <= dk.SMEM_LIMIT
    assert plan.cta_elems == sum(K * n * 8 for K, n in plan.layers)
    # every CTA's share of the frame's products, summed, is the whole weight set
    total = 16 * 3 * C * 2 * C + 5 * C * C + 128 * C + 2 * C * C + C * 128
    assert plan.cluster * plan.cta_elems == total
    # no plan the kernel takes runs in fewer waves on the card
    others = []
    for n in (16, 8, 4, 2, 1):
        for rows in (16, 32, 64):
            try:
                others.append(dk.decode_cluster_plan(B, C, 80, cluster=n, rows=rows))
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


@pytest.mark.parametrize("kw,B,C,match", [
    (dict(cluster=16), 4, 64, "channels"),          # 4 channels a CTA: no n8 block
    (dict(cluster=3), 4, 96, "power of two"),
    (dict(rows=48), 4, 256, "rows"),
    (dict(cluster=16, rows=64), 64, 512, "shared memory"),
    (dict(cluster=1, rows=64), 64, 512, "column blocks"),
    ({}, 4, 48, "hidden % 32"),
    ({}, 0, 64, "batch"),
])
def test_plan_refusals(kw, B, C, match):
    with pytest.raises(ValueError, match=match):
        dk.decode_cluster_plan(B, C, 80, **kw)


def _packed(C=64, freq=16, seed=0, dtype=torch.float32, condition=True):
    torch.manual_seed(seed)
    model = MelSyn(34, condition, 10, 16, freq, C).eval()
    return model, dk.pack_decode_weights(model, dtype)


@pytest.mark.parametrize("C,cluster", [(32, 4), (64, 8), (64, 2), (256, 16), (256, 8)])
def test_stream_round_trip_is_exact(C, cluster):
    _, packed = _packed(C=C, dtype=torch.bfloat16)
    plan = dk.decode_cluster_plan(3, C, 16, cluster=cluster)
    stream = dk.pack_decode_stream(packed, plan)
    assert stream.shape == (cluster, plan.cta_elems) and stream.dtype == torch.bfloat16
    back = dk.unpack_decode_stream(stream, plan)
    for k in dk.MATRIX_NAMES:
        assert torch.equal(back[k], packed[k]), k


def test_stream_fragment_order():
    """Lane l = 4g + t of block (kp, j) holds column 8j + g at k rows
    32kp + {2t, 2t+1, 2t+8, 2t+9} and the same 16 further on."""
    C = 64
    plan = dk.decode_cluster_plan(2, C, 16, cluster=2)
    w = torch.arange(128 * C, dtype=torch.float32).reshape(128, C)   # enc_w1: (fpad, C)
    _, packed = _packed(C=C)
    packed = dict(packed, enc_w1=w)
    stream = dk.pack_decode_stream(packed, plan)
    ncol = plan.ch // 8
    for rank in range(2):
        blocks = stream[rank, :128 * plan.ch].reshape(4, ncol, 32, 8)
        for kp, j, lane in [(0, 0, 0), (1, 1, 5), (3, 3, 31), (2, 0, 17)]:
            g, t = lane // 4, lane % 4
            col = rank * plan.ch + 8 * j + g
            ks = [32 * kp + 16 * h + k for h in (0, 1) for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
            assert blocks[kp, j, lane].tolist() == w[ks, col].tolist()


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


def test_emulate_matches_pallas_decode_interpret():
    """Through decode_plain to the JAX package's fused Pallas decode kernel
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
    plan = dk.decode_cluster_plan(B, C, freq, cluster=4)
    y1, a1, p1 = dk.decode_cluster_emulate(packed, K, V, s1, s2, plan, T)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a0), atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(p1.numpy(), np.asarray(p0))
