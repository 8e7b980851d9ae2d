"""The evaluation stack's host code in the port against the JAX package's.

``split_nonsilent``, ``mfccs_and_spec`` and ``ge2e_logmel`` (numpy in both,
equal to the bit or, for ``mfccs_and_spec``'s dB values, within 1e-5), the
VAD collector on ``tests/test_spoofkit.py::TestVadCollectorParity``'s flag
sequences, the classifiers, the chunker end to end with every classifier and
the JAX rate rule, and ``create_dvectors`` on a small corpus with the same
weights (embeddings within 1e-5; a (hidden 32, 2 layers, proj 16) embedder
in f32 on the CPU).
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spoofsv_tpu.config import GE2EConfig as JGE2EConfig
from spoofsv_tpu.config import GE2EDataConfig as JGE2EDataConfig
from spoofsv_tpu.dsp import host as jhost
from spoofsv_tpu.models.ge2e import SpeechEmbedder as JSpeechEmbedder
from spoofsv_tpu.spoofkit import dvector as jdvector
from spoofsv_tpu.spoofkit import vad as jvad
from spoofsv_tpu.utils.torch_export import export_ge2e_embedder
from spoofsv_torch.config import GE2EConfig, GE2EDataConfig
from spoofsv_torch.dsp import host
from spoofsv_torch.models.ge2e import SpeechEmbedder
from spoofsv_torch.spoofkit import dvector, vad
from spoofsv_torch.weights import load_state

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)


def _utterance(sr, seed, seconds=2.0):
    """Voiced bursts between silences, with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 + 60 * rng.uniform()
    sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h for h in range(1, 12))
    env = (np.sin(2 * np.pi * (1.2 + rng.uniform()) * t) > -0.2).astype(np.float64)
    y = 0.3 * sig / np.abs(sig).max() * env + 0.003 * rng.normal(size=t.size)
    return y.astype(np.float32)


@pytest.mark.parametrize("top_db", [20.0, 30.0, 60.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_nonsilent_equal(top_db, seed):
    y = _utterance(16000, seed)
    for fl, hl in ((2048, 512), (400, 160)):
        np.testing.assert_array_equal(host.split_nonsilent(y, top_db, fl, hl),
                                      jhost.split_nonsilent(y, top_db, fl, hl))
    for y in (np.zeros(100, np.float32), np.zeros(0, np.float32)):
        np.testing.assert_array_equal(host.split_nonsilent(y), jhost.split_nonsilent(y))


@pytest.mark.parametrize("wav_process,calc_mfccs", [(False, False), (True, True)])
def test_mfccs_and_spec_match_jax(wav_process, calc_mfccs):
    y = _utterance(16000, 2)
    got = host.mfccs_and_spec(y, 16000, 512, 0.025, 0.01, 40, 120, wav_process, calc_mfccs)
    want = jhost.mfccs_and_spec(y, 16000, 512, 0.025, 0.01, 40, 120, wav_process, calc_mfccs)
    assert (got[0] is None) == (want[0] is None) == (not calc_mfccs)
    for g, w in zip(got, want):
        if w is not None:
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sr,n_fft", [(16000, 512), (8000, 256)])
def test_ge2e_logmel_equal(sr, n_fft):
    y = _utterance(sr, 3, seconds=1.3)
    got = host.ge2e_logmel(y, sr, n_fft, 0.025, 0.01, 40)
    want = jhost.ge2e_logmel(y, sr, n_fft, 0.025, 0.01, 40)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# VAD: the collector (TestVadCollectorParity's sequences), classifiers, chunker
# ---------------------------------------------------------------------------

def test_collector_randomized_and_structured_sequences():
    rng = np.random.default_rng(0)
    cases = [(np.asarray(f, bool), 10) for f in (
        [], [True] * 30, [False] * 30, [True] * 12 + [False] * 12,
        [False] * 5 + [True] * 10 + [False] * 12 + [True] * 10)]
    for _ in range(200):
        num_padding = int(rng.integers(2, 14))
        flags = rng.random(int(rng.integers(0, 120))) < rng.uniform(0.2, 0.9)
        cases.append((flags, num_padding))
    for flags, num_padding in cases:
        assert vad.collect_from_flags(flags, 320, num_padding) == \
            jvad.collect_from_flags(flags, 320, num_padding)


def test_frame_generator_and_energy_classifier_equal():
    for n in (0, 319, 320, 321, 16000, 16001):
        y = _utterance(16000, 4)[:n]
        got = [(o, f.tolist()) for o, f in vad.frame_generator(y, 16000)]
        want = [(o, f.tolist()) for o, f in jvad.frame_generator(y, 16000)]
        assert got == want
        for mode in range(4):
            np.testing.assert_array_equal(vad.energy_classifier(y, 16000, 20, mode),
                                          jvad.energy_classifier(y, 16000, 20, mode))
    y = np.concatenate([np.linspace(-1, 1, 999), [-1.2, 1.2, 0.5 / 32768]]).astype(np.float32)
    np.testing.assert_array_equal(vad.float_to_pcm16(y), jvad.float_to_pcm16(y))


@pytest.mark.parametrize("classifier", [None, "webrtc", "energy"])
@pytest.mark.parametrize("sr", [8000, 16000])
def test_vad_chunk_matches_jax(classifier, sr):
    y = np.concatenate([np.zeros(sr // 2, np.float32), _utterance(sr, 5, seconds=3.0),
                        np.zeros(sr // 3, np.float32)])
    for mode in (1, 2, 3):
        got_c, got_s = vad.vad_chunk(y, sr, aggressiveness=mode, classifier=classifier)
        want_c, want_s = jvad.vad_chunk(y, sr, aggressiveness=mode, classifier=classifier)
        assert got_s == want_s
        assert len(got_c) == len(want_c)
        for g, w in zip(got_c, want_c):
            np.testing.assert_array_equal(g, w)


def test_vad_rate_rule_and_callables():
    """Default mode at 22.05 kHz falls back to the energy detector with a
    warning, as in JAX; an explicit "webrtc" raises; a callable is called;
    an unknown name raises."""
    y = np.concatenate([np.zeros(11025, np.float32), _utterance(22050, 6)])
    with pytest.warns(UserWarning, match="falling back"):
        got = vad.vad_collector(y, 22050)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jvad.vad_collector(y, 22050)
    assert got == want == vad.vad_collector(y, 22050, classifier="energy")
    with pytest.raises(ValueError, match="8/16 kHz"):
        vad.vad_collector(y, 22050, classifier="webrtc")

    def alternate(sig, sr, frame_ms):
        return np.arange(len(sig) // int(sr * frame_ms / 1000)) % 7 < 5

    assert vad.vad_collector(y, 22050, classifier=alternate) == \
        jvad.vad_collector(y, 22050, classifier=alternate)
    with pytest.raises(ValueError, match="unknown VAD classifier"):
        vad.vad_chunk(y, 16000, classifier="nope")


# ---------------------------------------------------------------------------
# d-vectors
# ---------------------------------------------------------------------------

def test_dvector_helpers_equal():
    times = [(0.0, 0.4), (0.4, 0.8), (1.0, 1.4), (1.4, 1.6)]
    segs = [np.full(k, float(k), np.float32) for k in (3, 4, 5, 6)]
    got, want = dvector.concat_segs(times, segs), jdvector.concat_segs(times, segs)
    assert got[1] == want[1] and len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert dvector.concat_segs([], []) == ([], [])
    emb = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    for n in (1, 2, 5):
        np.testing.assert_array_equal(dvector.align_embeddings(emb[:n]),
                                      jdvector.align_embeddings(emb[:n]))


def test_create_dvectors_matches_jax(tmp_path):
    sr = 16000
    for spk, seeds in (("p900", (10, 11)), ("p901", (12,))):
        d = tmp_path / "wav" / spk
        d.mkdir(parents=True)
        for k, seed in enumerate(seeds):
            host.write_wav(str(d / f"{spk}_{k:03d}.wav"),
                           np.concatenate([np.zeros(4000, np.float32), _utterance(sr, seed)]), sr)
    (tmp_path / "wav" / "p902").mkdir()
    host.write_wav(str(tmp_path / "wav" / "p902" / "quiet.wav"), np.zeros(sr, np.float32), sr)
    pattern = str(tmp_path / "wav" / "*" / "*.wav")
    data = dict(sr=sr, nfft=512, window=0.025, hop=0.01, nmels=40)
    jge2e = JGE2EConfig(data=JGE2EDataConfig(**data))
    ge2e = GE2EConfig(data=GE2EDataConfig(**data))
    jemb = JSpeechEmbedder(hidden=32, num_layers=2, proj=16)
    params = jemb.init(jax.random.PRNGKey(0), jnp.zeros((1, 24, 40)))
    emb = load_state(SpeechEmbedder(40, 32, 2, 16), export_ge2e_embedder(params))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want_seq, want_ids = jdvector.create_dvectors(jge2e, jemb, params, pattern,
                                                  str(tmp_path / "jax"), verbose=False)
    got_seq, got_ids = dvector.create_dvectors(ge2e, emb, pattern, str(tmp_path / "port"),
                                               verbose=False)
    assert len(want_seq) > 4 and got_seq.shape == want_seq.shape
    np.testing.assert_array_equal(got_ids, want_ids)
    assert set(got_ids) == {"p900", "p901"}            # the silent file is skipped
    np.testing.assert_allclose(got_seq, want_seq, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "train_sequence.npy"), got_seq)
    empty, ids = dvector.create_dvectors(ge2e, emb, str(tmp_path / "none*.wav"),
                                         str(tmp_path / "port"), verbose=False)
    assert empty.shape == (0, 16) and ids.shape == (0,)
    assert emb.training   # restored
