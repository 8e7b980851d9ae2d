"""The port's decoders vs the JAX scan decoder and the fused Pallas decode kernel.

Plain eager decode (``infer/decode.py``) and the kernel's plain version on
packed weights (``ops/decode_kernel.py::decode_plain``, what
``decode_fused`` runs for CPU tensors) against ``make_decoder`` (scan) and
``make_fused_decoder(interpret=True)``, f32 on the CPU: mel and attention at
atol 2e-5 / rtol 1e-4 with ``pma`` equal, the gates of
tests/test_pallas_decode.py. The kernel itself runs only on a card
(tests/test_torch_port_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.infer.decode import make_decoder as j_make_decoder
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.ops.pallas_decode import HW_DILATIONS as J_HW_DILATIONS
from spoofsv_tpu.ops.pallas_decode import make_fused_decoder as j_make_fused_decoder
from spoofsv_tpu.ops.pallas_decode import pack_decode_weights as j_pack
from spoofsv_tpu.train.steps import shift_right
from spoofsv_torch.infer.decode import make_decoder
from spoofsv_torch.models import MelSyn
from spoofsv_torch.ops import decode_kernel
from spoofsv_torch.weights import load_melsyn_from_jax

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)


def _setup(B=4, N=12, hidden=32, freq=16, condition=True, seed=0):
    rng = np.random.default_rng(seed)
    jm = JMelSyn(vocab_len=34, condition=condition, spk_emb_dim=10, text_emb_dim=16,
                 freq_bins=freq, hidden_dim=hidden)
    text = rng.integers(1, 33, (B, N)).astype(np.int32)
    spk = rng.normal(size=(B, 10)).astype(np.float32)
    mel = rng.uniform(0.05, 0.95, (B, 4, freq)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), shift_right(jnp.asarray(mel)),
                     jnp.asarray(text), jnp.asarray(spk))
    tm = load_melsyn_from_jax(MelSyn(34, condition, 10, 16, freq, hidden), params).eval()
    return jm, params, tm, text, spk


def _close(got, ref):
    y1, a1, p1 = got
    y0, a0, p0 = ref
    assert y1.shape == y0.shape and a1.shape == a0.shape
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a0), atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(p1.numpy(), np.asarray(p0))


@pytest.mark.parametrize("condition", [True, False])
def test_eager_decode_matches_scan(condition):
    jm, params, tm, text, spk = _setup(condition=condition)
    T = 10
    ref = j_make_decoder(jm, T, unroll=1)(params, jnp.asarray(text),
                                          jnp.asarray(spk) if condition else None)
    got = make_decoder(tm, T)(torch.from_numpy(text),
                              torch.from_numpy(spk) if condition else None)
    _close(got, ref)


@pytest.mark.parametrize("condition", [True, False])
def test_packed_plain_matches_fused_interpret(condition):
    jm, params, tm, text, spk = _setup(condition=condition)
    T = 10
    ref = j_make_fused_decoder(jm, T, interpret=True)(
        params, jnp.asarray(text), jnp.asarray(spk) if condition else None)
    got = decode_kernel.make_fused_decoder(tm, T)(
        torch.from_numpy(text), torch.from_numpy(spk) if condition else None)
    _close(got, ref)


def test_rings_wrap_long_rollout():
    """T > 2·27 so every ring of the packed plain decode wraps at least once."""
    jm, params, tm, text, spk = _setup(B=2, N=10)
    T = 60
    ref = j_make_decoder(jm, T, unroll=1)(params, jnp.asarray(text), jnp.asarray(spk))
    _close(make_decoder(tm, T)(torch.from_numpy(text), torch.from_numpy(spk)), ref)
    _close(decode_kernel.make_fused_decoder(tm, T)(torch.from_numpy(text),
                                                   torch.from_numpy(spk)), ref)


def test_pack_matches_pallas_pack():
    jm, params, tm, *_ = _setup()
    ref = j_pack(params, 32, 16)
    got = decode_kernel.pack_decode_weights(tm)
    assert set(got) == set(ref) == set(decode_kernel.WEIGHT_NAMES)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert decode_kernel.HW_DILATIONS == J_HW_DILATIONS
