"""The last helpers of the JAX package, ported: held against it on the CPU.

``LNDense`` against flax's (through the bridge), ``Synthesizer.mel_to_audio``
against JAX's, ``torchdsp``'s complex ``stft``/``istft``, ``preemphasis`` and
``mel_project`` against ``jaxdsp``'s, and the profiling hooks (``trace``,
``span``, ``count``, ``snapshot``). f32 on both sides: rtol 1e-5 for one
layer and the DSP (a few hundred terms a sum), the synthesis gates of
``test_torch_port_synth.py`` for audio (rel-L2 ≤ 1e-3).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.dsp import jaxdsp
from spoofsv_tpu.dsp.primitives import mel_filterbank
from spoofsv_tpu.infer.synthesize import Synthesizer as JSynthesizer
from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.models.layers import LNDense as JLNDense
from spoofsv_tpu.train.steps import shift_right
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.infer.synthesize import Synthesizer
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.models.layers import LNDense
from spoofsv_torch.utils.profiling import count, reset, snapshot, span, trace
from spoofsv_torch.weights import load_lndense_from_jax, load_melsyn_from_jax, load_ssrn_from_jax


@pytest.mark.parametrize("use_ln", [True, False])
def test_lndense_matches_flax(use_ln):
    x = np.random.default_rng(0).normal(size=(3, 7, 24)).astype(np.float32)
    jl = JLNDense(features=40, use_ln=use_ln)
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jl.apply(params, jnp.asarray(x)))
    layer = load_lndense_from_jax(LNDense(24, 40, use_ln=use_ln), params)
    assert sorted(layer.state_dict()) == (["dense.bias", "dense.weight", "ln.bias", "ln.weight"]
                                          if use_ln else ["dense.bias", "dense.weight"])
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mel_to_audio_matches_jax(tiny_cfg):
    """SSRN and the vocoder ("advance" init, GL4, plain f32 on both sides) on
    the same coarse mel."""
    cfg = tiny_cfg.replace(tpu=dataclasses.replace(tiny_cfg.tpu, griffin_lim_init="advance",
                                                   griffin_lim_iters=4))
    rng = np.random.default_rng(2)
    mel = rng.uniform(0.05, 0.95, (2, 10, cfg.mel.freq_bins)).astype(np.float32)
    text = rng.integers(1, cfg.vocab_len - 1, (2, 12)).astype(np.int32)
    spk = rng.normal(size=(2, cfg.spk_emb_dim)).astype(np.float32)
    jm = JMelSyn(vocab_len=cfg.vocab_len, condition=True, spk_emb_dim=cfg.spk_emb_dim,
                 text_emb_dim=cfg.text_emb_dim, freq_bins=cfg.mel.freq_bins,
                 hidden_dim=cfg.hidden_dim)
    js = JSSRN(freq_bins=cfg.mel.freq_bins, output_bins=cfg.lin_bins, ssrn_dim=cfg.ssrn_dim)
    pm = jm.init(jax.random.PRNGKey(0), shift_right(jnp.asarray(mel)), jnp.asarray(text),
                 jnp.asarray(spk))
    ps = js.init(jax.random.PRNGKey(1), jnp.asarray(mel))
    want = np.asarray(JSynthesizer(cfg, jm, js, pm, ps).mel_to_audio(jnp.asarray(mel),
                                                                     jax.random.PRNGKey(0)),
                      np.float64)
    tm = load_melsyn_from_jax(MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                                     cfg.mel.freq_bins, cfg.hidden_dim), pm)
    ts = load_ssrn_from_jax(SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim), ps)
    got = Synthesizer(cfg, tm, ts).mel_to_audio(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, cfg.stft.hop_length * (4 * 10 - 1))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("n_fft,hop,win,center", [(1024, 256, None, True),
                                                   (512, 128, 400, False)])
def test_complex_stft_istft_match_jaxdsp(n_fft, hop, win, center):
    y = np.random.default_rng(3).normal(size=(2, 6000)).astype(np.float32)
    want = np.asarray(jaxdsp.stft(jnp.asarray(y), n_fft, hop, win, center))
    got = torchdsp.stft(torch.from_numpy(y), n_fft, hop, win, center)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-4)
    # the inverse with center=True: uncentred edges divide by a window
    # sum-square near its 1e-11 floor, where any rounding is amplified
    want = np.asarray(jaxdsp.stft(jnp.asarray(y), n_fft, hop, win, True))
    back = np.asarray(jaxdsp.istft(jnp.asarray(want), n_fft, hop, win, True))
    got_back = torchdsp.istft(torch.from_numpy(want), n_fft, hop, win, True).numpy()
    assert got_back.shape == back.shape
    np.testing.assert_allclose(got_back, back, rtol=1e-5, atol=1e-5)


def test_preemphasis_and_mel_project_match_jaxdsp():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 500)).astype(np.float32)
    np.testing.assert_allclose(torchdsp.preemphasis(torch.from_numpy(x), 0.97).numpy(),
                               np.asarray(jaxdsp.preemphasis(jnp.asarray(x), 0.97)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(torchdsp.preemphasis(torch.from_numpy(x[0])).numpy()[0], x[0, 0])
    mag = rng.uniform(0, 2, (2, 9, 513)).astype(np.float32)
    fb = mel_filterbank(22050, 1024, 80, 0.0, None).astype(np.float32)
    np.testing.assert_allclose(torchdsp.mel_project(torch.from_numpy(mag),
                                                    torch.from_numpy(fb)).numpy(),
                               np.asarray(jaxdsp.mel_project(jnp.asarray(mag), jnp.asarray(fb))),
                               rtol=1e-5, atol=1e-6)


def test_trace_and_step_timer(tmp_path):
    """``trace`` writes one trace file for its block (nothing for a falsy
    directory), with the program's spans in it; ``span`` and ``count`` add
    to the table ``snapshot`` reads and ``reset`` clears."""
    with trace(None) as prof:
        assert prof is None
    reset()
    with trace(str(tmp_path / "t")) as prof:
        with span("leftovers.mm", rows=64) as s:
            torch.ones(64, 64) @ torch.ones(64, 64)
        with span("leftovers.mm"):
            pass
    assert any("mm" in e.key for e in prof.key_averages())
    assert any(e.key == "spoofsv.leftovers.mm" for e in prof.key_averages())
    assert len(os.listdir(tmp_path / "t")) == 1
    count("leftovers.n")
    count("leftovers.n", 4)
    snap = snapshot()
    row = snap["spans"]["leftovers.mm"]
    assert row["count"] == 2 and row["args"] == {"rows": 64}
    assert 0 < s.seconds <= row["max_s"] <= row["total_s"]
    assert snap["counters"] == {"leftovers.n": 5}
    reset()
    assert snapshot() == {"spans": {}, "counters": {}}
