"""The whole slice: the port's Synthesizer vs the JAX Synthesizer, f32 on the CPU.

JAX runs ``decode_impl="scan"`` and ``griffin_lim_impl="xla"`` (f32 FFT
Griffin-Lim); the port runs the plain versions its kernel wrappers take for
CPU tensors. Same weights (through the bridge), same text and speakers.
Audio rel-L2 ≤ 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spoofsv_tpu.infer.synthesize import Synthesizer as JSynthesizer
from spoofsv_tpu.infer.synthesize import finalize_audio as j_finalize_audio
from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.train.steps import shift_right
from spoofsv_torch.infer.synthesize import (Synthesizer, finalize_audio, host_audio,
                                            make_vocoder)
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.utils import profiling
from spoofsv_torch.weights import load_melsyn_from_jax, load_ssrn_from_jax

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)


def _cfg(tiny_cfg, init, iters=4):
    return tiny_cfg.replace(tpu=dataclasses.replace(
        tiny_cfg.tpu, decode_impl="scan", griffin_lim_impl="xla",
        griffin_lim_init=init, griffin_lim_iters=iters))


def _models(cfg, seed=1, B=2, N=14):
    rng = np.random.default_rng(seed)
    jm = JMelSyn(vocab_len=cfg.vocab_len, condition=True, spk_emb_dim=cfg.spk_emb_dim,
                 text_emb_dim=cfg.text_emb_dim, freq_bins=cfg.mel.freq_bins,
                 hidden_dim=cfg.hidden_dim)
    js = JSSRN(freq_bins=cfg.mel.freq_bins, output_bins=cfg.lin_bins, ssrn_dim=cfg.ssrn_dim)
    text = rng.integers(1, cfg.vocab_len - 1, (B, N)).astype(np.int32)
    spk = rng.normal(size=(B, cfg.spk_emb_dim)).astype(np.float32)
    mel = rng.uniform(0.05, 0.95, (B, 4, cfg.mel.freq_bins)).astype(np.float32)
    pm = jm.init(jax.random.PRNGKey(seed), shift_right(jnp.asarray(mel)),
                 jnp.asarray(text), jnp.asarray(spk))
    ps = js.init(jax.random.PRNGKey(seed + 1), jnp.asarray(mel))
    tm = load_melsyn_from_jax(MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                                     cfg.mel.freq_bins, cfg.hidden_dim), pm)
    ts = load_ssrn_from_jax(SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim), ps)
    return (jm, js, pm, ps), (tm, ts), text, spk


@pytest.mark.parametrize("init", ["spsi", "advance"])
def test_synthesizer_matches_jax(tiny_cfg, init):
    cfg = _cfg(tiny_cfg, init)
    (jm, js, pm, ps), (tm, ts), text, spk = _models(cfg)
    T = 12
    a0, m0, at0 = JSynthesizer(cfg, jm, js, pm, ps, n_frames=T)(
        jnp.asarray(text), jnp.asarray(spk), jax.random.PRNGKey(0))
    a1, m1, at1 = Synthesizer(cfg, tm, ts, n_frames=T)(text, spk)
    assert a1.shape == a0.shape == (2, cfg.stft.hop_length * (4 * T - 1))
    np.testing.assert_allclose(m1.numpy(), np.asarray(m0), atol=2e-5)
    np.testing.assert_allclose(at1.numpy(), np.asarray(at0), atol=2e-5)
    a0 = np.asarray(a0, np.float64)
    rel = np.linalg.norm(a1.numpy() - a0) / np.linalg.norm(a0)
    assert rel <= 1e-3, rel
    for row0, row1 in zip(a0, a1.numpy()):
        np.testing.assert_allclose(finalize_audio(row1, cfg, trim_db=30.0),
                                   j_finalize_audio(row0.astype(np.float32), cfg, trim_db=30.0),
                                   atol=2e-3)


def test_random_init_is_seeded(tiny_cfg):
    """The "random" init is the hash of (frame, bin, seed): same seeds, same audio."""
    cfg = _cfg(tiny_cfg, "random", iters=2)
    voc = make_vocoder(cfg)
    lin = torch.rand(2, 24, cfg.lin_bins, generator=torch.Generator().manual_seed(0))
    s1 = torch.tensor([1, 2], dtype=torch.int32)
    y1, y2 = voc(lin, s1), voc(lin, s1.clone())
    y3 = voc(lin, torch.tensor([3, 4], dtype=torch.int32))
    assert torch.equal(y1, y2)
    assert float((y1 - y3).abs().max()) > 0
    assert bool(torch.isfinite(y1).all())


@pytest.mark.parametrize("init", ["spsi", "random"])
def test_call_returns_the_device_calls_audio_on_the_host(tiny_cfg, init):
    """``__call__`` = ``device_call`` with the audio delivered to the host:
    the same f32 audio bit for bit, the mel and attention on the synthesizer's
    device, and the same seeds give the same rows."""
    cfg = _cfg(tiny_cfg, init, iters=2)
    _, (tm, ts), text, spk = _models(cfg)
    syn = Synthesizer(cfg, tm, ts, n_frames=6)
    seeds = torch.tensor([11, 12], dtype=torch.int32)
    a_dev, m_dev, at_dev = syn.device_call(text, spk, seeds)
    audio, mel, attn = syn(text, spk, seeds)
    assert audio.device.type == "cpu" and audio.dtype == torch.float32
    assert mel.device == attn.device == a_dev.device == syn.device
    assert torch.equal(audio, a_dev) and torch.equal(mel, m_dev) and torch.equal(attn, at_dev)


def test_host_audio_returns_a_host_tensor_itself():
    """A tensor already on the host is returned as it is: no copy, no bytes on
    ``d2h_bytes``, no pinned block; the span is still opened."""
    audio = torch.randn(3, 512)
    profiling.reset()
    out = host_audio(audio)
    assert out is audio
    snap = profiling.snapshot()
    assert snap["spans"]["synth.to_host"]["count"] == 1
    assert "d2h_bytes" not in snap["counters"] and "d2h_pinned_allocs" not in snap["counters"]
