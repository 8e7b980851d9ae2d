"""Tacotron 2's rollout kernels (``csrc/t2_rollout.cu``) vs their plain versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_t2_kernels.py

One step of each kernel at the published widths from random states, against
``att_step_plain`` / ``dec_step_plain`` on the same bf16 operands, over the
batches and text lengths whose plans differ (a row a cluster, ten, eleven;
the memory whole or streamed): float32 outputs within 1e-4 (sums in another
order), bf16 outputs within two of their units in the last place, the hashed
prenet masks exactly (a flipped unit differs by its whole value). The same at
steps 0, 500 and 975 of a real call (Harvard sentences through the encoder,
the kernels resumed from the rollout's kept states). The captured rollout
against the same steps run eagerly (bit-equal) and replayed twice
(bit-equal), and against the plain steps over bf16 operands for a few steps.
"""

import copy

import pytest
import torch

from spoofsv_torch import reference_precision
from spoofsv_torch.config import Tacotron2Config
from spoofsv_torch.models.tacotron2 import build_tacotron2
from spoofsv_torch.ops import t2_kernel
from spoofsv_torch.ops.t2_kernel import Buffers, StepWeights

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    reference_precision()
    return torch.device("cuda:0")


@pytest.fixture
def weights(dev):
    model = build_tacotron2(Tacotron2Config(weights_seed=5), dev, torch.bfloat16)
    return model, StepWeights(model)


def _state(w: StepWeights, B: int, N: int, T: int, dev, seed: int) -> Buffers:
    g = torch.Generator(device=dev).manual_seed(seed)
    s = Buffers(w, B, N, T, torch.bfloat16, dev)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)   # noqa: E731
    s.memory.copy_(rnd(B, N, w.M) * 0.5)
    s.pm.copy_(rnd(B, w.att, N))
    s.lengths.copy_(torch.randint(1, N + 1, (B,), generator=g, device=dev))
    s.lengths[0] = N
    s.seeds.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g, device=dev))
    s.a_buf.copy_(rnd(*s.a_buf.shape).tanh())
    s.d_buf.copy_(rnd(*s.d_buf.shape).tanh())
    s.c_att.copy_(rnd(B, w.A))
    s.c_dec.copy_(rnd(B, w.D))
    valid = torch.arange(N, device=dev)[None, :] < s.lengths[:, None]
    s.w.copy_(torch.softmax(rnd(B, N).masked_fill(~valid, float("-inf")), 1))
    s.cum.copy_(s.w * 7 + rnd(B, N).abs() * valid)
    return s


def _close_bf16(a: torch.Tensor, b: torch.Tensor) -> None:
    a, b = a.float(), b.float()
    ulps2 = 2.0 ** -6 * torch.maximum(a.abs(), b.abs()) + 1e-6
    assert bool(((a - b).abs() <= ulps2).all()), float((a - b).abs().max())


def _att_step(w, s1, g, t) -> None:
    s2 = copy.deepcopy(s1)
    t2_kernel.att_step_kernel(g, w, s1, t)
    t2_kernel.att_step_plain(g, w, s2, t)
    torch.cuda.synchronize()
    for name in ("c_att", "w", "cum", "att"):
        torch.testing.assert_close(getattr(s1, name), getattr(s2, name), rtol=1e-4, atol=1e-5)
    _close_bf16(s1.a_buf, s2.a_buf)
    _close_bf16(s1.d_buf, s2.d_buf)


def _dec_step(w, s1, g, t) -> None:
    s2 = copy.deepcopy(s1)
    t2_kernel.dec_step_kernel(g, w, s1, t)
    t2_kernel.dec_step_plain(g, w, s2, t)
    torch.cuda.synchronize()
    for name in ("c_dec", "mel", "gate"):
        torch.testing.assert_close(getattr(s1, name), getattr(s2, name), rtol=1e-4, atol=1e-4)
    _close_bf16(s1.d_buf, s2.d_buf)
    # the prenet's output, masks and all
    dropped = s2.a_buf[:, :w.P] == 0
    assert torch.equal(s1.a_buf[:, :w.P] == 0, dropped)
    _close_bf16(s1.a_buf, s2.a_buf)


SHAPES = [(5, 49), (160, 49), (3, 200)] + [(B, N) for B in (1, 2, 20, 40, 160, 161)
                                           for N in (8, 49, 186)]


@pytest.mark.parametrize("B,N", SHAPES)
def test_att_step_matches_plain(dev, weights, B, N):
    _, w = weights
    g = torch.randn(B, 4 * w.A, device=dev) * 2
    _att_step(w, _state(w, B, N, 10, dev, seed=B + N), g, 7)


@pytest.mark.parametrize("B,N", [(5, 49), (160, 49)] + [(B, 49) for B in (1, 2, 20, 40, 161)])
def test_dec_step_matches_plain(dev, weights, B, N):
    _, w = weights
    g = torch.randn(B, 4 * w.D, device=dev) * 2
    _dec_step(w, _state(w, B, N, 10, dev, seed=3 * B), g, 4)


HARVARD = ["The birch canoe slid on the smooth planks.",
           "Glue the sheet to the dark blue background.",
           "It's easy to tell the depth of a well.",
           "These days a chicken leg is a rare dish.",
           "Rice is often served in round bowls."]


def test_steps_of_a_real_call_match_plain(dev, weights):
    """Steps 0, 500 and 975 of a 1000-step rollout of 8 speakers x the
    sentences (B=40), each kernel resumed from the kept state."""
    from spoofsv_torch.data.text import t2_encode_texts

    model, w = weights
    texts = torch.from_numpy(t2_encode_texts(HARVARD * 8)).to(dev)
    B, N = texts.shape
    lengths = (texts != 0).sum(1).cpu()
    g = torch.Generator(device=dev).manual_seed(16)
    spk = torch.nn.functional.normalize(torch.randn(8, 256, generator=g, device=dev), dim=1)
    spk = spk.repeat_interleave(len(HARVARD), 0)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g, device=dev,
                          dtype=torch.int32)
    with torch.no_grad():
        memory, pm = model.encode(texts, lengths, spk)
        mel, _, _, states = t2_kernel.Rollout(model, 1000)(memory, pm, lengths, seeds)
    for t in (0, 500, 975):
        s = Buffers(w, B, N, 1000, torch.bfloat16, dev)
        s.memory.copy_(memory)
        s.pm.copy_(pm.transpose(1, 2))
        s.lengths.copy_(lengths)
        s.seeds.copy_(seeds)
        i = t // t2_kernel.CHECKPOINT_EVERY
        t2_kernel.restore_state(w, s, {k: states[k][i] for k in t2_kernel.STATE},
                                mel[:, t - 1], t)
        _att_step(w, s, torch.mm(s.a_buf, w.w_att.t(), out_dtype=torch.float32), t)
        _dec_step(w, s, torch.mm(s.d_buf, w.w_dec.t(), out_dtype=torch.float32), t)


def test_resident_clusters_and_plans(dev, weights):
    """The card holds the plan's clusters at once (the cell's call in one wave)."""
    _, w = weights
    att, dec = t2_kernel.kernel_plans(w, 160, 49, dev)
    for p in (att, dec):
        assert p.ctas == 8 and p.clusters * p.rows >= 160
    assert att.clusters <= t2_kernel._RESIDENT[(0, w.C)]["att"]
    lib = t2_kernel._lib()
    assert lib.spoofsv_t2_att_smem(att.rows, att.ctas, 49, att.chunk, w.A, w.att, w.M,
                                   w.widths[5]) == att.smem
    assert lib.spoofsv_t2_dec_smem(dec.rows, dec.ctas, w.D, w.M, w.P, w.n_mel) == dec.smem


def test_graph_rollout_is_the_eager_rollout(dev, weights):
    model, w = weights
    B, N, T = 12, 37, 30
    s = _state(w, B, N, T, dev, seed=11)
    roll = t2_kernel.Rollout(model, T)
    args = (s.memory.clone(), s.pm.transpose(1, 2).clone(), s.lengths.cpu(), s.seeds.clone())
    first = roll(*args)
    first = (*first[:3], {k: v.clone() for k, v in first[3].items()})   # valid until the next call
    second = roll(*args)
    eager = Buffers(w, B, N, T, torch.bfloat16, dev)
    for name in ("memory", "pm", "lengths", "seeds"):
        getattr(eager, name).copy_(getattr(s, name))
    t2_kernel.run_steps(w, eager, plain=False)
    plain = copy.deepcopy(eager)
    t2_kernel.run_steps(w, plain, plain=True)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, (eager.mel, eager.gate, eager.att)):
        assert torch.equal(a, b) and torch.equal(a, c)
    for k, v in eager.ckpt.items():
        assert torch.equal(first[3][k], v) and torch.equal(second[3][k], v)
    assert first[3]["step"].tolist() == [0, 25]
    # the states are the graph's buffers, not copies
    assert all(second[3][k].data_ptr() == roll._graphs[(B, N)][1].ckpt[k].data_ptr()
               for k in t2_kernel.STATE)
    # the plain steps over the same bf16 operands, for the first steps
    torch.testing.assert_close(first[0][:, :5], plain.mel[:, :5], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(first[2][..., :5], plain.att[..., :5], rtol=2e-2, atol=2e-3)
    assert len(roll._graphs) == 1
