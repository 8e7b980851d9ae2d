"""The host pieces of Tacotron 2's rollout kernels (``ops/t2_kernel.py``), on the CPU.

The plan (:func:`t2_kernel.step_plan`) at the published widths over the
batches and text lengths the port runs: within the card's shared memory, every
row served by one cluster, the memory streamed exactly where a row's columns
do not fit whole. The weights' per-CTA layouts (``StepWeights.k_*``) give the
plain products back, slice by slice. The staged-bytes count agrees with the
copies enumerated one by one.
"""

import pytest
import torch
import torch.nn.functional as F

from spoofsv_torch.ops import t2_kernel
from spoofsv_torch.ops.t2_kernel import SMEM_MAX, StepWeights

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

# NVIDIA/tacotron2's hparams with SV2TTS's d-vector: (A, D, M, P, attention, taps, n_mel)
WIDTHS = (1024, 1024, 768, 256, 128, 31, 80)


@pytest.mark.parametrize("N", [8, 49, 186])
@pytest.mark.parametrize("B", [1, 2, 20, 40, 160, 161])
def test_step_plan(B, N):
    att = t2_kernel.step_plan("att", B, N, WIDTHS)
    dec = t2_kernel.step_plan("dec", B, N, WIDTHS)
    for p in (att, dec):
        assert p.ctas == 8
        assert p.smem <= SMEM_MAX
        # every row once: the clusters' rows cover B, the last cluster holds one at least
        assert p.clusters * p.rows >= B > (p.clusters - 1) * p.rows
        # more clusters than the card holds at once only where fewer rows had to fit
        assert (p.clusters <= t2_kernel.RESIDENT_CLUSTERS
                or p.rows < -(-B // t2_kernel.RESIDENT_CLUSTERS))
    assert dec.smem == t2_kernel.dec_smem(dec.rows, dec.ctas, WIDTHS)
    assert att.smem == t2_kernel.att_smem(att.rows, att.ctas, N, att.chunk, WIDTHS)
    whole = t2_kernel.att_smem(att.rows, att.ctas, N, N, WIDTHS)
    # streamed exactly where a row's memory columns do not fit whole
    assert att.streamed == (whole > SMEM_MAX)
    if att.streamed:
        assert t2_kernel.MIN_CHUNK <= att.chunk < N
        assert t2_kernel.att_smem(att.rows, att.ctas, N, att.chunk + 1, WIDTHS) > SMEM_MAX
    else:
        assert att.chunk == N
    if B <= t2_kernel.RESIDENT_CLUSTERS:   # a row a cluster
        assert att.rows == dec.rows == 1


def test_step_plan_spec_cases():
    # the cell's call: eleven rows a cluster of 8, 15 clusters, the memory whole
    p = t2_kernel.step_plan("att", 160, 49, WIDTHS)
    assert (p.rows, p.ctas, p.clusters, p.streamed) == (11, 8, 15, False)
    # sixteen clusters held at once: ten rows each
    assert t2_kernel.step_plan("att", 160, 49, WIDTHS, resident=16).rows == 10
    # fewer clusters held at once: more rows a cluster, as many as fit
    d = t2_kernel.step_plan("dec", 160, 49, WIDTHS, resident=8)
    assert 10 < d.rows < 20 and t2_kernel.dec_smem(d.rows + 1, 8, WIDTHS) > SMEM_MAX
    with pytest.raises(ValueError, match="cluster"):
        t2_kernel.cluster_ctas((1024, 1024, 768, 256, 12, 31, 80))


class _Weights(StepWeights):
    """StepWeights' kernel layouts over random weights at the published widths
    (no model built)."""

    def __init__(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        A, D, M, P, AT, K, NM = WIDTHS
        rnd = lambda *s: torch.randn(*s, generator=g)   # noqa: E731
        self.A, self.D, self.M, self.P, self.att, self.n_mel = A, D, M, P, AT, NM
        self.w_q = rnd(AT, A).bfloat16()
        self.w_loc_t = rnd(2, K, 32)
        self.w_dense_t = rnd(32, AT)
        self.w_proj = rnd(NM + 1, D + M).bfloat16()
        self.b_proj = rnd(NM + 1)
        self.w_pre1 = rnd(P, NM).bfloat16()
        self.w_pre2 = rnd(P, P).bfloat16()
        self.widths = WIDTHS
        self._kernel_layouts()


def test_kernel_layouts_give_the_products_back():
    w = _Weights(3)
    A, D, M, P, AT, K, NM = WIDTHS
    C = w.C
    Au, Aa, Du, Mc, Pu = A // C, AT // C, D // C, M // C, P // C
    g = torch.Generator().manual_seed(4)
    B, N = 3, 11
    h = torch.randn(B, A, generator=g)
    # the query: each CTA's units through its rows of W_q^T, the partials summed
    q = sum(h[:, k * Au:(k + 1) * Au] @ w.k_wq[k, :, :AT].float() for k in range(C))
    torch.testing.assert_close(q, h @ w.w_q.float().t(), rtol=1e-4, atol=1e-4)
    assert not w.k_wq[:, :, AT:].any()
    # the location term: the folded layer over [w, Σw] against conv then dense
    x = torch.rand(B, 2, N, generator=g)
    conv = F.conv1d(x, w.w_loc_t.permute(2, 0, 1), padding=(K - 1) // 2)   # (B, filters, N)
    want = conv.transpose(1, 2) @ w.w_dense_t                                # (B, N, AT)
    xp = F.pad(x, ((K - 1) // 2, (K - 1) // 2))
    win = torch.stack([xp[:, :, k:k + N] for k in range(K)], 2)             # (B, 2, K, N)
    for k in range(C):
        got = torch.einsum("bckn,cka->bna", win, w.k_u[k].reshape(2, K, Aa))
        torch.testing.assert_close(got, want[:, :, k * Aa:(k + 1) * Aa], rtol=1e-4, atol=1e-4)
    # the projection and gate: each CTA's decoder units and context columns
    hd, ctx = torch.randn(B, D, generator=g), torch.randn(B, M, generator=g)
    out = sum(torch.cat([hd[:, k * Du:(k + 1) * Du], ctx[:, k * Mc:(k + 1) * Mc]], 1)
              @ w.k_proj[k].float() for k in range(C)) + w.k_bproj
    ref = torch.cat([hd, ctx], 1) @ w.w_proj.float().t() + w.b_proj
    torch.testing.assert_close(out[:, :NM + 1], ref, rtol=1e-4, atol=1e-3)
    assert not out[:, NM + 1:].any()
    # the prenet: each CTA's units, bit for bit the plain weights
    for k in range(C):
        assert torch.equal(w.k_pre1[k, :, :Pu], w.w_pre1[k * Pu:(k + 1) * Pu].t())
        assert torch.equal(w.k_pre2[k, :, :Pu], w.w_pre2[k * Pu:(k + 1) * Pu].t())
    assert not w.k_pre1[:, :, Pu:].any() and not w.k_pre2[:, :, Pu:].any()
    # every CTA's slice a whole number of 16-byte rows
    for t in (w.k_wq, w.k_proj, w.k_pre1, w.k_pre2):
        assert t.shape[-1] * t.element_size() % 32 == 16


@pytest.mark.parametrize("B,N", [(160, 49), (161, 49), (3, 186)])
def test_staged_bytes_counts_every_copy(B, N):
    A, D, M, P, AT, K, NM = WIDTHS
    att = t2_kernel.step_plan("att", B, N, WIDTHS)
    dec = t2_kernel.step_plan("dec", B, N, WIDTHS)
    C = att.ctas
    Au, Aa, Du, Mc, Pu, OS = A // C, AT // C, D // C, M // C, P // C, 88
    total = 0
    for plan, kernel in ((att, "att"), (dec, "dec")):
        for cluster in range(plan.clusters):
            R = plan.rows
            valid = range(cluster * R, min(B, (cluster + 1) * R))
            for _ in range(C):
                if kernel == "att":
                    # the biases and the weight slices
                    total += 4 * Au * 4 + Au * (AT + 8) * 2 + 2 * K * Aa * 4 + Aa * 4
                    total += R * 4 * Au * 4 + R * Au * 4            # the gate and cell boxes
                    for j in range(0, N, plan.chunk):                  # the memory's boxes
                        total += R * plan.chunk * Mc * 2
                    total += len(valid) * (Aa * N * 2 + 2 * N * 4 + 4)  # pm, [w, Σw], length
                else:
                    total += (4 * Du * 4 + (Du + Mc) * OS * 2 + OS * 4 + NM * (Pu + 8) * 2
                              + P * (Pu + 8) * 2)
                    total += R * (4 * Du * 4 + Du * 4 + Mc * 2) + len(valid) * 4
    assert (t2_kernel.staged_bytes("att", att, B, N, WIDTHS)
            + t2_kernel.staged_bytes("dec", dec, B, N, WIDTHS)) == total
