"""The port's bf16 models against the JAX package's bf16 compute, on the CPU.

The port casts the parameters themselves to bf16 (``cli.main.build_models``
with ``dtype=torch.bfloat16``); the JAX package keeps f32 parameters and
computes in bf16 (``dtype=jnp.bfloat16`` on the modules, which casts each
parameter at its use). Both round the same f32 weights to the same bf16
values, so what differs is where activations are rounded. Same seeded
weights and inputs, small widths. Gates from ``scripts/parity_tpu.py``:
attention 0.02; mel (and SSRN's linear magnitude, also a sigmoid output)
0.05. At random init the two bf16 paths' mel differs by up to ~0.11 at a
single element, as much as JAX's own bf16 differs from its f32 (up to
~0.09 over 8 draws): the mel gate is 0.05 beyond JAX's own bf16 error on the
same input, and the mean difference must stay under 0.02 (observed
0.005-0.012), with the port's bf16 no further from f32 than 0.05 beyond
JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.train.steps import shift_right
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.weights import load_melsyn_from_jax, load_ssrn_from_jax

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

MEL_TOL, ATT_TOL = 0.05, 0.02


@pytest.mark.parametrize("condition", [True, False])
def test_bf16_teacher_forced_melsyn_matches_jax(condition):
    rng = np.random.default_rng(11)
    B, N, T, hidden, freq = 2, 13, 10, 64, 20
    text = rng.integers(1, 33, (B, N)).astype(np.int32)
    spk = rng.normal(size=(B, 10)).astype(np.float32)
    mel = rng.uniform(0.05, 0.95, (B, T, freq)).astype(np.float32)
    kw = dict(vocab_len=34, condition=condition, spk_emb_dim=10, text_emb_dim=16,
              freq_bins=freq, hidden_dim=hidden)
    params = JMelSyn(**kw).init(jax.random.PRNGKey(3), shift_right(jnp.asarray(mel)),
                                jnp.asarray(text), jnp.asarray(spk))
    s = jnp.asarray(spk) if condition else None
    y0, a0 = JMelSyn(**kw, dtype=jnp.bfloat16).apply(params, jnp.asarray(mel),
                                                     jnp.asarray(text), s)
    y32, _ = JMelSyn(**kw).apply(params, jnp.asarray(mel), jnp.asarray(text), s)
    tm = load_melsyn_from_jax(MelSyn(34, condition, 10, 16, freq, hidden), params)
    tm = tm.to(torch.bfloat16).eval()
    with torch.no_grad():
        y1, a1 = tm(torch.from_numpy(mel).to(torch.bfloat16), torch.from_numpy(text),
                    torch.from_numpy(spk).to(torch.bfloat16) if condition else None)
    assert y1.dtype == torch.bfloat16 and y1.shape == y0.shape and a1.shape == a0.shape
    _check(y1.float().numpy(), np.asarray(y0, np.float32), np.asarray(y32, np.float32))
    att_d = float(np.abs(a1.float().numpy() - np.asarray(a0, np.float32)).max())
    assert att_d <= ATT_TOL, att_d


def _check(port: np.ndarray, jax_bf16: np.ndarray, jax_f32: np.ndarray) -> None:
    """The port's bf16 output against the JAX package's bf16 one, with the
    JAX package's own bf16 error on this input (against its f32) as the
    noise floor."""
    floor = float(np.abs(jax_bf16 - jax_f32).max())
    d = np.abs(port - jax_bf16)
    assert float(d.max()) <= MEL_TOL + floor, (float(d.max()), floor)
    assert float(d.mean()) <= 0.02, float(d.mean())
    assert float(np.abs(port - jax_f32).max()) <= MEL_TOL + floor


def test_bf16_ssrn_matches_jax():
    rng = np.random.default_rng(12)
    mel = rng.uniform(0.05, 0.95, (2, 9, 20)).astype(np.float32)
    params = JSSRN(freq_bins=20, output_bins=65, ssrn_dim=48).init(jax.random.PRNGKey(4),
                                                                  jnp.asarray(mel))
    ref = JSSRN(freq_bins=20, output_bins=65, ssrn_dim=48, dtype=jnp.bfloat16).apply(
        params, jnp.asarray(mel))
    ref32 = JSSRN(freq_bins=20, output_bins=65, ssrn_dim=48).apply(params, jnp.asarray(mel))
    ts = load_ssrn_from_jax(SSRN(20, 65, 48), params).to(torch.bfloat16).eval()
    with torch.no_grad():
        got = ts(torch.from_numpy(mel).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (2, 36, 65)
    _check(got.float().numpy(), np.asarray(ref, np.float32), np.asarray(ref32, np.float32))
