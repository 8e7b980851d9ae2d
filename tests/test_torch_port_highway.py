"""Highway kernels K4/K5/K6 and the highway implementation switch: the port vs
the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_ops.py and tests/test_pallas_conv.py do; the port's
wrappers take their plain versions for CPU tensors. Inputs are seeded numpy
arrays handed to both. Tolerances: forward atol 3e-5 (the JAX kernel tests'
own gate: f32 summation order and the two LayerNorm variance forms);
gradients atol 5e-4, rtol 1e-4 (test_pallas_conv.py's custom_vjp gate).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.models import layers as jlayers
from spoofsv_tpu.ops import pallas_conv, pallas_ops
from spoofsv_tpu.train.steps import shift_right
from spoofsv_torch.models import SSRN, MelSyn, layers
from spoofsv_torch.ops import gate_kernel, hconv_kernel
from spoofsv_torch.weights import load_melsyn_from_jax, load_ssrn_from_jax

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

ATOL = 3e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _conv_params(rng, C, K=3):
    """JAX-layout params (kernel (K, C, 2C)) as numpy, as test_pallas_conv._params."""
    w = (rng.normal(size=(K, C, 2 * C)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(2 * C,)) * 0.1).astype(np.float32)
    lns = [(rng.normal(size=(C,)) * 0.2 + 1.0).astype(np.float32) for _ in range(4)]
    return [w, b, *lns]


def _port_params(p):
    """The same params for the port: the conv weight in the (2C, C, K) reference schema."""
    return [_t(np.transpose(p[0], (2, 1, 0))), *(_t(v) for v in p[1:])]


@pytest.mark.parametrize("lead,c", [((6, 40), 32), ((2, 10, 7), 16), ((13,), 8)])
def test_gate_plain_matches_pallas(lead, c):
    """K6: ragged rows (13 rows in tiles of 8) and 2- and 3-axis inputs."""
    rng = np.random.default_rng(0)
    h = rng.normal(size=(*lead, 2 * c)).astype(np.float32)
    x = rng.normal(size=(*lead, c)).astype(np.float32)
    lns = [rng.normal(1 if i % 2 == 0 else 0, 0.1, (c,)).astype(np.float32) for i in range(4)]
    ref = pallas_ops.fused_highway_gate(jnp.asarray(h), jnp.asarray(x),
                                        *map(jnp.asarray, lns), block_rows=8, interpret=True)
    got = gate_kernel.fused_highway_gate(_t(h), _t(x), *map(_t, lns))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_wrapper_cpu_takes_plain_with_bf16_ln(dtype):
    """K6's wrapper on CPU tensors is the plain gate (no build, no count) and
    takes bf16 LayerNorm vectors as they are, as the kernel does on the card;
    held against the JAX kernel (interpret) on the same bf16-rounded values."""
    rng = np.random.default_rng(4)
    c = 32
    h = _t(rng.normal(size=(3, 7, 2 * c))).to(dtype)
    x = _t(rng.normal(size=(3, 7, c))).to(dtype)
    lns = [_t(rng.normal(1 if i % 2 == 0 else 0, 0.1, (c,))).to(torch.bfloat16)
           for i in range(4)]
    before = gate_kernel.gate_kernel.launches
    got = gate_kernel.fused_highway_gate(h, x, *lns)
    assert gate_kernel.gate_kernel.launches == before and got.dtype == dtype
    torch.testing.assert_close(got, gate_kernel.highway_gate_plain(h, x, *lns), atol=0, rtol=0)
    ref = pallas_ops.fused_highway_gate(*(jnp.asarray(t.float().numpy()) for t in (h, x, *lns)),
                                        block_rows=8, interpret=True)
    # bf16: the output rounded to bf16, half an ulp (2⁻⁸ relative)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref), atol=ATOL,
                               rtol=1e-7 if dtype == torch.float32 else 2 ** -8)


def test_chip_smoke_gate_case_on_cpu():
    """The card's K6 case (``ops/hconv_probe.py``, run by ``chip_smoke.py``
    phase 6) built on the CPU: one input set (no L2 to outrun), the timed
    call computes what the checked call does, and the bound's bytes are h, x
    and y once each plus the LayerNorm vectors."""
    from spoofsv_torch.ops import hconv_probe

    cpu = torch.device("cpu")
    assert set(hconv_probe.cases(cpu)) == set(hconv_probe.KERNEL_NAMES)
    case = hconv_probe.gate_case(325, 256, 30, cpu)
    assert case.work["bytes"] == 4 * 16 * 325 * (2 * 256 + 256 + 256) + 4 * 4 * 256
    ref = case.plain()
    torch.testing.assert_close(case.fused(), ref, atol=0, rtol=0)
    torch.testing.assert_close(case.timed(), ref, atol=0, rtol=0)


@pytest.mark.parametrize("T,dil,causal,K", [
    (37, 1, False, 3),    # ragged tail, SAME
    (37, 3, False, 3),    # dilated SAME
    (64, 1, True, 3),     # causal, block-divisible
    (300, 3, True, 3),    # causal dilated, multi-block ragged
    (8, 1, False, 3),     # shorter than one block
    (17, 1, False, 1),    # K=1: no halo
])
def test_hconv_plain_matches_pallas(T, dil, causal, K):
    """K4 against ``fused_highway_conv`` (interpret) at test_pallas_conv.py's cases."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, T, 64)).astype(np.float32)
    p = _conv_params(rng, 64, K)
    ref = pallas_conv.fused_highway_conv(jnp.asarray(x), *map(jnp.asarray, p), dilation=dil,
                                         causal=causal, block_t=32, interpret=True)
    got = hconv_kernel.fused_highway_conv(_t(x), *_port_params(p), dil, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("T,da,db,causal,bt", [
    (70, 1, 3, False, 64),    # SSRN hc1→hc2 / ups pairs (SAME)
    (257, 1, 1, False, 64),   # hc3→hc4, ragged multi-block
    (300, 9, 27, True, 128),  # causal dilation-stack deep pair (72-frame halo)
    (33, 1, 3, True, 64),     # causal shallow pair, one short block
    (8, 1, 1, False, 64),     # shorter than one block
])
def test_hconv_pair_plain_matches_pallas(T, da, db, causal, bt):
    """K5 against ``fused_highway_conv_pair`` (interpret) at test_pallas_conv.py's cases."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, T, 64)).astype(np.float32)
    pa, pb = _conv_params(rng, 64), _conv_params(rng, 64)
    ref = pallas_conv.fused_highway_conv_pair(
        jnp.asarray(x), *map(jnp.asarray, pa + pb), dilation_a=da, dilation_b=db,
        causal=causal, block_t=bt, interpret=True)
    got = hconv_kernel.fused_highway_conv_pair(_t(x), *_port_params(pa), *_port_params(pb),
                                               da, db, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _port_grads(fn, inputs):
    ts = [_t(a).requires_grad_(True) for a in inputs]
    (fn(*ts) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


def _assert_grads(got, ref, to_jax_layout=None):
    for i, (g, r) in enumerate(zip(got, ref)):
        g = to_jax_layout(i, g) if to_jax_layout else g
        np.testing.assert_allclose(g, np.asarray(r), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"input {i}")


def _kernel_layout(weight_slots):
    """Port conv-weight gradients (2C, C, K) → JAX's (K, C, 2C)."""
    return lambda i, g: np.transpose(g, (2, 1, 0)) if i in weight_slots else g


def test_gate_grads_match_jax():
    rng = np.random.default_rng(5)
    c = 16
    ins = [rng.normal(size=(2, 10, 2 * c)), rng.normal(size=(2, 10, c))]
    ins += [rng.normal(1 if i % 2 == 0 else 0, 0.1, (c,)) for i in range(4)]
    ins = [np.asarray(a, np.float32) for a in ins]
    ref = jax.grad(lambda *a: jnp.sum(pallas_ops.fused_highway_gate_ad(*a) ** 2),
                   argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    _assert_grads(_port_grads(gate_kernel.fused_highway_gate, ins), ref)


def test_hconv_grads_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 37, 32)).astype(np.float32)
    p = _conv_params(rng, 32)
    ref = jax.grad(lambda *a: jnp.sum(pallas_conv.fused_highway_conv_ad(*a, 3, False) ** 2),
                   argnums=tuple(range(7)))(*map(jnp.asarray, [x] + p))
    ins = [x, np.transpose(p[0], (2, 1, 0))] + p[1:]
    got = _port_grads(lambda *a: hconv_kernel.fused_highway_conv(*a, 3, False), ins)
    _assert_grads(got, ref, _kernel_layout({1}))


def test_hconv_pair_grads_match_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 37, 32)).astype(np.float32)
    pa, pb = _conv_params(rng, 32), _conv_params(rng, 32)
    ref = jax.grad(
        lambda *a: jnp.sum(pallas_conv.fused_highway_conv_pair_ad(*a, 1, 3, False) ** 2),
        argnums=tuple(range(13)))(*map(jnp.asarray, [x] + pa + pb))
    ins = ([x, np.transpose(pa[0], (2, 1, 0))] + pa[1:]
           + [np.transpose(pb[0], (2, 1, 0))] + pb[1:])
    got = _port_grads(lambda *a: hconv_kernel.fused_highway_conv_pair(*a, 1, 3, False), ins)
    _assert_grads(got, ref, _kernel_layout({1, 7}))


# ---------------------------------------------------------------------------
# The fusability predicate of highway_pair
# ---------------------------------------------------------------------------

class _StubBlock:
    """Stands in for a bound flax HighwayConv in spoofsv_tpu.models.layers.highway_pair:
    the attributes its predicate reads, and a call that returns its input."""

    def __init__(self, dim, kernel_size, dilation, causal, dropout_rate):
        self.dim, self.kernel_size, self.dilation = dim, kernel_size, dilation
        self.causal, self.dropout_rate = causal, dropout_rate
        self.gate_impl, self.dtype = None, jnp.float32
        params = {"params": {k: jnp.zeros(()) for k in ("kernel", "bias", "scale")}}
        self.conv = self.ln1 = self.ln2 = types.SimpleNamespace(variables=params)

    def is_initializing(self):
        return False

    def make_rng(self, name):
        return jax.random.PRNGKey(0)

    def __call__(self, x, deterministic=True):
        return x


def _jax_fuses(a, b, T, deterministic, monkeypatch) -> bool:
    calls = []
    monkeypatch.setattr(pallas_conv, "fused_highway_conv_pair_ad",
                        lambda x, *args: calls.append(args) or x)
    jlayers.set_default_gate_impl("fused_pair")
    try:
        jlayers.highway_pair(a, b, jnp.zeros((1, T, 1)), deterministic)
    finally:
        jlayers.set_default_gate_impl("xla")
    return bool(calls)


PAIRS = [  # (dim_a, dim_b, K_a, K_b, dil_a, dil_b, causal_a, causal_b)
    *[(8, 8, 3, 3, da, db, c, c) for da, db in [(1, 3), (9, 27), (1, 1), (3, 3)]
      for c in (False, True)],
    (8, 8, 1, 1, 1, 1, False, False),     # text encoder hc3 → hc4
    (8, 16, 3, 3, 1, 3, False, False),    # widths differ
    (8, 8, 3, 3, 1, 3, False, True),      # causality differs
    (8, 8, 3, 1, 1, 1, False, False),     # kernel sizes differ
]


@pytest.mark.parametrize("pair", PAIRS)
def test_pair_fusable_matches_jax(pair, monkeypatch):
    """The port fuses exactly the pairs the JAX package fuses, over T (halo
    against the JAX tile min(256, max(8, T))), dropout rate and train mode."""
    da_dim, db_dim, ka, kb, da, db, ca, cb = pair
    seen = set()
    for rate in (0.0, 0.05):
        ja = _StubBlock(da_dim, ka, da, ca, rate)
        jb = _StubBlock(db_dim, kb, db, cb, rate)
        pa = layers.HighwayConv(da_dim, ka, da, ca, rate)
        pb = layers.HighwayConv(db_dim, kb, db, cb, rate)
        for T in (1, 4, 8, 9, 20, 35, 36, 37, 71, 72, 73, 300):
            for det in (True, False):
                want = _jax_fuses(ja, jb, T, det, monkeypatch)
                assert layers.pair_fusable(pa, pb, T, det) == want, (pair, rate, T, det)
                seen.add(want)
    matched = da_dim == db_dim and ka == kb and ca == cb
    assert seen == ({True, False} if matched else {False})


def test_highway_pair_dispatch(monkeypatch):
    """Under "fused_pair" highway_pair calls K5's wrapper when the pair fuses;
    in train mode with dropout it runs the two blocks one by one."""
    calls = []
    real = layers.fused_highway_conv_pair
    monkeypatch.setattr(layers, "fused_highway_conv_pair",
                        lambda *a: calls.append(a) or real(*a))
    a, b = layers.HighwayConv(8, 3, 1, False, 0.05), layers.HighwayConv(8, 3, 3, False, 0.05)
    x = torch.randn(2, 20, 8)
    with layers.gate_impl("fused_pair"), torch.no_grad():
        a.eval(), b.eval()
        y = layers.highway_pair(a, b, x)
        assert len(calls) == 1
        torch.testing.assert_close(y, b(a(x)), atol=ATOL, rtol=0)
        a.train(), b.train()
        layers.highway_pair(a, b, x)
        assert len(calls) == 1


def test_gate_impl_switch_is_restored():
    assert layers.get_default_gate_impl() == "xla"
    with pytest.raises(RuntimeError):
        with layers.gate_impl("fused_conv"):
            assert layers.get_default_gate_impl() == "fused_conv"
            raise RuntimeError("inside")
    assert layers.get_default_gate_impl() == "xla"
    with pytest.raises(ValueError):
        layers.set_default_gate_impl("triton")


# ---------------------------------------------------------------------------
# Whole models under each implementation, against JAX under "xla"
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_models():
    """Tiny MelSyn (N=40, T=80: both (9, 27) pairs fuse) and SSRN, JAX params
    loaded into the port, with the JAX "xla" outputs."""
    rng = np.random.default_rng(7)
    text = rng.integers(1, 33, (2, 40)).astype(np.int32)
    spk = rng.normal(size=(2, 10)).astype(np.float32)
    mel = rng.uniform(0.05, 0.95, (2, 80, 16)).astype(np.float32)
    jm = JMelSyn(vocab_len=34, condition=True, spk_emb_dim=10, text_emb_dim=8,
                 freq_bins=16, hidden_dim=16)
    pm = jm.init(jax.random.PRNGKey(0), shift_right(jnp.asarray(mel)), jnp.asarray(text),
                 jnp.asarray(spk))
    ym, am = jm.apply(pm, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(spk))
    smel = mel[:, :24]
    js = JSSRN(freq_bins=16, output_bins=33, ssrn_dim=16)
    ps = js.init(jax.random.PRNGKey(1), jnp.asarray(smel))
    ys = js.apply(ps, jnp.asarray(smel))
    tm = load_melsyn_from_jax(MelSyn(34, True, 10, 8, 16, 16), pm).eval()
    ts = load_ssrn_from_jax(SSRN(16, 33, 16), ps).eval()
    return dict(tm=tm, ts=ts, text=text, spk=spk, mel=mel, smel=smel,
                ref=(np.asarray(ym), np.asarray(am), np.asarray(ys)))


@pytest.mark.parametrize("impl,pairs", [("xla", (0, 0)), ("pallas", (0, 0)),
                                        ("fused_conv", (0, 0)), ("fused_pair", (14, 4))])
def test_models_under_each_impl_match_jax_xla(tiny_models, impl, pairs, monkeypatch):
    """MelSyn (teacher-forced) and SSRN forwards under each impl match JAX
    under "xla"; under "fused_pair" 14 MelSyn and 4 SSRN pairs take K5's path."""
    m = tiny_models
    calls = []
    real = layers.fused_highway_conv_pair
    monkeypatch.setattr(layers, "fused_highway_conv_pair",
                        lambda *a: calls.append(a) or real(*a))
    with layers.gate_impl(impl), torch.no_grad():
        y, a = m["tm"](_t(m["mel"]), torch.from_numpy(m["text"]), _t(m["spk"]))
        n_melsyn = len(calls)
        ys = m["ts"](_t(m["smel"]))
    assert (n_melsyn, len(calls) - n_melsyn) == pairs
    ym, am, ys_ref = m["ref"]
    np.testing.assert_allclose(y.numpy(), ym, atol=ATOL)
    np.testing.assert_allclose(a.numpy(), am, atol=ATOL)
    np.testing.assert_allclose(ys.numpy(), ys_ref, atol=ATOL)
