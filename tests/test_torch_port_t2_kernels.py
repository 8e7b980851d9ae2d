"""Tacotron 2's rollout kernels (``csrc/t2_rollout.cu``) vs their plain versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_t2_kernels.py

One step of each kernel at the published widths from random states, against
``att_step_plain`` / ``dec_step_plain`` on the same bf16 operands: float32
outputs within 1e-4 (sums in another order), bf16 outputs within two of
their units in the last place, the hashed prenet masks exactly (a flipped
unit differs by its whole value). The captured rollout against the same
steps run eagerly (bit-equal) and replayed twice (bit-equal), and against
the plain steps over bf16 operands for a few steps.
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


@pytest.mark.parametrize("B,N", [(5, 49), (160, 49), (3, 200)])
def test_att_step_matches_plain(dev, weights, B, N):
    _, w = weights
    s1 = _state(w, B, N, 10, dev, seed=B + N)
    s2 = copy.deepcopy(s1)
    g = torch.randn(B, 4 * w.A, device=dev) * 2
    t2_kernel.att_step_kernel(g, w, s1, 7)
    t2_kernel.att_step_plain(g, w, s2, 7)
    torch.cuda.synchronize()
    for name in ("c_att", "w", "cum", "att"):
        torch.testing.assert_close(getattr(s1, name), getattr(s2, name), rtol=1e-4, atol=1e-5)
    _close_bf16(s1.a_buf, s2.a_buf)
    _close_bf16(s1.d_buf, s2.d_buf)


@pytest.mark.parametrize("B", [5, 160])
def test_dec_step_matches_plain(dev, weights, B):
    _, w = weights
    s1 = _state(w, B, 49, 10, dev, seed=3 * B)
    s2 = copy.deepcopy(s1)
    g = torch.randn(B, 4 * w.D, device=dev) * 2
    t2_kernel.dec_step_kernel(g, w, s1, 4)
    t2_kernel.dec_step_plain(g, w, s2, 4)
    torch.cuda.synchronize()
    for name in ("c_dec", "mel", "gate"):
        torch.testing.assert_close(getattr(s1, name), getattr(s2, name), rtol=1e-4, atol=1e-4)
    _close_bf16(s1.d_buf, s2.d_buf)
    # the prenet's output, masks and all
    dropped = s2.a_buf[:, :w.P] == 0
    assert torch.equal(s1.a_buf[:, :w.P] == 0, dropped)
    _close_bf16(s1.a_buf, s2.a_buf)


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
