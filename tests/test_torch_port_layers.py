"""spoofsv_torch layers, models, weight bridge and host helpers vs the JAX package.

Same inputs (numpy, seeded) through the JAX function and the port's
counterpart, f32 on the CPU, atol 1e-5 (f32 accumulation-order differences
between XLA and PyTorch's CPU kernels are ~1e-6 at these sizes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.models.layers import HighwayConv as JHighwayConv
from spoofsv_tpu.train.steps import shift_right
from spoofsv_tpu.utils.torch_export import (export_melsyn, export_ssrn,
                                            save_reference_checkpoint)
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.models.layers import HighwayConv, LayerNorm
from spoofsv_torch.weights import (load_melsyn_from_jax, load_reference_checkpoint,
                                   load_ssrn_from_jax, load_state)

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

ATOL = 1e-5


def _melsyn_pair(seed=0, B=2, N=11, T=9, hidden=32, freq=16, condition=True):
    rng = np.random.default_rng(seed)
    jm = JMelSyn(vocab_len=34, condition=condition, spk_emb_dim=10, text_emb_dim=16,
                 freq_bins=freq, hidden_dim=hidden)
    text = rng.integers(1, 33, (B, N)).astype(np.int32)
    spk = rng.normal(size=(B, 10)).astype(np.float32)
    mel = rng.uniform(0.05, 0.95, (B, T, freq)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), shift_right(jnp.asarray(mel)),
                     jnp.asarray(text), jnp.asarray(spk))
    tm = load_melsyn_from_jax(MelSyn(34, condition, 10, 16, freq, hidden), params).eval()
    return jm, params, tm, text, spk, mel


def test_layer_norm_matches_flax():
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, 48)) * 3 + 1.5).astype(np.float32)
    scale = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    ref = nn.LayerNorm(epsilon=1e-5).apply({"params": {"scale": scale, "bias": bias}},
                                           jnp.asarray(x))
    ln = LayerNorm(48)
    load_state(ln, {"weight": scale, "bias": bias})
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal,dilation,kernel_size", [(False, 1, 3), (False, 9, 3),
                                                          (True, 3, 3), (False, 1, 1)])
def test_highway_conv_full_sequence(causal, dilation, kernel_size):
    rng = np.random.default_rng(1)
    C, T = 24, 40
    x = rng.normal(size=(2, T, C)).astype(np.float32)
    jh = JHighwayConv(C, kernel_size, dilation, causal)
    params = jh.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jh.apply(params, jnp.asarray(x)))
    p = params["params"]
    th = HighwayConv(C, kernel_size, dilation, causal)
    load_state(th, {"conv.weight": np.transpose(np.asarray(p["conv"]["kernel"]), (2, 1, 0)),
                    "conv.bias": p["conv"]["bias"],
                    "ln1.weight": p["ln1"]["scale"], "ln1.bias": p["ln1"]["bias"],
                    "ln2.weight": p["ln2"]["scale"], "ln2.bias": p["ln2"]["bias"]})
    with torch.no_grad():
        got = th(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if causal:   # step-by-step with the cache == the full causal sequence
        cache = th.init_cache(2)
        with torch.no_grad():
            for t in range(T):
                y_t, cache = th.step(torch.from_numpy(x[:, t]), cache)
                np.testing.assert_allclose(y_t.numpy(), ref[:, t], atol=ATOL)


def test_text_encoder_matches():
    jm, params, tm, text, _, _ = _melsyn_pair()
    K0, V0 = jm.apply(params, jnp.asarray(text), method=JMelSyn.encode_text)
    with torch.no_grad():
        K1, V1 = tm.encode_text(torch.from_numpy(text))
    np.testing.assert_allclose(K1.numpy(), np.asarray(K0), atol=ATOL)
    np.testing.assert_allclose(V1.numpy(), np.asarray(V0), atol=ATOL)


@pytest.mark.parametrize("condition", [True, False])
def test_teacher_forced_melsyn_matches(condition):
    jm, params, tm, text, spk, mel = _melsyn_pair(condition=condition)
    s = jnp.asarray(spk) if condition else None
    y0, a0 = jm.apply(params, jnp.asarray(mel), jnp.asarray(text), s)
    with torch.no_grad():
        y1, a1 = tm(torch.from_numpy(mel), torch.from_numpy(text),
                    torch.from_numpy(spk) if condition else None)
    assert y1.shape == y0.shape and a1.shape == a0.shape
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=ATOL)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a0), atol=ATOL)


def test_ssrn_matches():
    rng = np.random.default_rng(2)
    mel = rng.uniform(0.05, 0.95, (2, 7, 16)).astype(np.float32)
    js = JSSRN(freq_bins=16, output_bins=33, ssrn_dim=24)
    params = js.init(jax.random.PRNGKey(3), jnp.asarray(mel))
    ts = load_ssrn_from_jax(SSRN(16, 33, 24), params).eval()
    ref = np.asarray(js.apply(params, jnp.asarray(mel)))
    with torch.no_grad():
        got = ts(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 28, 33)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_state_dict_schema_is_the_reference_one():
    """The port's parameter names and shapes are exactly what torch_export emits."""
    jm, params, tm, *_ = _melsyn_pair()
    sd = export_melsyn(params)
    own = tm.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(own[k].shape) == sd[k].shape for k in sd)
    js = JSSRN(freq_bins=16, output_bins=33, ssrn_dim=24)
    ps = js.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16)))
    sd2 = export_ssrn(ps)
    own2 = SSRN(16, 33, 24).state_dict()
    assert set(sd2) == set(own2)
    assert all(tuple(own2[k].shape) == sd2[k].shape for k in sd2)


def test_reference_checkpoint_loads(tmp_path):
    """A reference-schema ``.tar.pth`` goes through the same strict loader."""
    jm, params, tm, text, spk, mel = _melsyn_pair(seed=4)
    path = str(tmp_path / "melsyn.tar.pth")
    save_reference_checkpoint(path, export_melsyn(params))
    tm2 = load_reference_checkpoint(MelSyn(34, True, 10, 16, 16, 32), path).eval()
    with torch.no_grad():
        a = tm(torch.from_numpy(mel), torch.from_numpy(text), torch.from_numpy(spk))[0]
        b = tm2(torch.from_numpy(mel), torch.from_numpy(text), torch.from_numpy(spk))[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(RuntimeError):
        load_state(MelSyn(34, True, 10, 16, 16, 32), {"bogus.weight": np.zeros(3)})


def test_host_helpers_match():
    from spoofsv_tpu.data.text import encode_texts as j_encode
    from spoofsv_tpu.dsp import host as j_host
    from spoofsv_tpu.dsp import primitives as j_prim
    from spoofsv_torch.data.text import encode_texts
    from spoofsv_torch.dsp import host, primitives

    vocab = "PE abcdefghijklmnopqrstuvwxyz-,.?'\""
    texts = ['He said "hello", then left.', "A b c?", "numbers 123 dropped"]
    np.testing.assert_array_equal(encode_texts(texts, vocab), j_encode(texts, vocab))
    np.testing.assert_array_equal(encode_texts(texts, vocab, 12), j_encode(texts, vocab, 12))
    w = primitives.hann_window(1024)
    np.testing.assert_array_equal(w, j_prim.hann_window(1024))
    np.testing.assert_array_equal(primitives.pad_center(w[:800], 1024),
                                  j_prim.pad_center(w[:800], 1024))
    np.testing.assert_array_equal(primitives.window_sumsquare(w, 9, 256, 1024),
                                  j_prim.window_sumsquare(w, 9, 256, 1024))
    rng = np.random.default_rng(5)
    y = np.concatenate([1e-4 * rng.normal(size=5000), rng.normal(size=20000),
                        1e-4 * rng.normal(size=7000)]).astype(np.float32)
    a, ia = host.trim_silence(y, 30.0)
    b, ib = j_host.trim_silence(y, 30.0)
    assert ia == ib
    np.testing.assert_array_equal(a, b)
