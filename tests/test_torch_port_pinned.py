"""A synthesis call's delivery of its audio to the host, on the card.

``Synthesizer.__call__`` copies the device audio into a page-locked block
of torch's caching host allocator (``infer/synthesize.py::host_audio``).
Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The pipeline runs its plain routes (``decode_impl`` and
``griffin_lim_impl`` "xla") at tiny widths, so no kernel is built: the
delivery is under test, not the kernels. The file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_pinned.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.infer.synthesize import Synthesizer
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.utils import profiling

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

pytestmark = pytest.mark.cuda
TINY = dict(hidden_dim=32, text_emb_dim=16, ssrn_dim=32, spk_emb_dim=10, max_text_len=16,
            max_frame_num=12)


@pytest.fixture(scope="module")
def syn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the delivery copies device audio to pinned memory")
    cfg = Config().replace(**TINY)
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, decode_impl="xla", griffin_lim_impl="xla",
                                              griffin_lim_iters=3))
    torch.manual_seed(0)
    dev = torch.device("cuda:0")
    melsyn = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, cfg.mel.freq_bins,
                    cfg.hidden_dim).to(dev)
    ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim).to(dev)
    return cfg, Synthesizer(cfg, melsyn, ssrn, n_frames=cfg.max_frame_num, gl_iters=3)


def _inputs(cfg, seed: int, B: int = 4):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, cfg.vocab_len - 1, (B, cfg.max_text_len)).astype(np.int32)
    spk = rng.normal(size=(B, cfg.spk_emb_dim)).astype(np.float32)
    return text, spk, torch.arange(seed, seed + B, dtype=torch.int32)


def _counter(name: str) -> int:
    return profiling.snapshot()["counters"].get(name, 0)


def test_call_returns_pinned_audio_equal_to_the_device_audio(syn):
    cfg, s = syn
    args = _inputs(cfg, 1)
    a_dev, mel_dev, _ = s.device_call(*args)
    profiling.reset()
    audio, mel, attn = s(*args)
    assert audio.device.type == "cpu" and audio.is_pinned()
    assert mel.device == attn.device == s.device
    assert torch.equal(audio, a_dev.cpu()) and torch.equal(mel, mel_dev)
    assert audio.cpu() is audio   # a client's own .cpu() copies nothing
    assert _counter("d2h_bytes") == a_dev.numel() * 4


def test_a_held_result_is_not_overwritten_by_later_calls(syn):
    cfg, s = syn
    held, _, _ = s(*_inputs(cfg, 2))
    want = held.clone()
    for seed in (3, 4, 5):
        other, _, _ = s(*_inputs(cfg, seed))
        assert other.data_ptr() != held.data_ptr()
        assert not torch.equal(other, want)
    assert torch.equal(held, want)


def test_a_freed_block_is_reused(syn):
    """Once no result is held, repeated calls pin no new block."""
    cfg, s = syn
    args = _inputs(cfg, 6)
    profiling.reset()
    for _ in range(2):
        s(*args)
    warm = _counter("d2h_pinned_allocs")
    assert warm <= 2
    for _ in range(6):
        s(*args)
    assert _counter("d2h_pinned_allocs") == warm
    assert profiling.snapshot()["spans"]["synth.to_host"]["count"] == 8
