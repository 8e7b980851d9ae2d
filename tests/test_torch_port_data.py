"""The port's data tier vs the JAX package on the CPU.

Host DSP (mel filterbank, STFT, the training features, wav I/O), the VCTK
split, the toy corpus, batching (``pad_batch``, ``BucketedLoader``,
``DeviceReplayLoader`` on the CPU), the feature cache and MCD. Both packages
run numpy on the same inputs: arrays are held to rtol 1e-6 (the features) or
exactly (files, path lists, batches).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

from spoofsv_tpu.config import Config as JConfig
from spoofsv_tpu.data import pipeline as jpipeline
from spoofsv_tpu.data import toy as jtoy
from spoofsv_tpu.data import vctk as jvctk
from spoofsv_tpu.dsp import host as jhost
from spoofsv_tpu.dsp import primitives as jprim
from spoofsv_tpu.spoofkit import mcd as jmcd
from spoofsv_torch.config import Config
from spoofsv_torch.data import pipeline, toy, vctk
from spoofsv_torch.dsp import host, primitives
from spoofsv_torch.spoofkit import mcd

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 3-speaker toy corpus (rich voices, 9 utterances each) prepared by the
    JAX package and a byte-identical copy prepared by the port, plus both
    configs over it (the JAX loader's buckets)."""
    root = tmp_path_factory.mktemp("toy")
    jtoy.generate_toy_corpus(str(root / "jax"), str(root / "jax_emb"), n_speakers=3,
                             utts_per_spk=9, seed=5, rich_speakers=True)
    shutil.copytree(root / "jax" / "wav48", root / "port" / "wav48")
    shutil.copytree(root / "jax" / "txt", root / "port" / "txt")
    jcfg = JConfig().replace(data_root_dir=str(root / "jax"), spk_emb_dir=str(root / "jax_emb"))
    cfg = Config().replace(data_root_dir=str(root / "port"), spk_emb_dir=str(root / "jax_emb"))
    jvctk.prepare_vctk(jcfg, verbose=False)
    vctk.prepare_vctk(cfg, verbose=False)
    return root, jcfg, cfg


def _wav(corpus, i=0):
    root, _, _ = corpus
    path = sorted((root / "jax" / "wav22" / "p900").iterdir())[i]
    return host.load_wav(str(path))


# ---------------------------------------------------------------------------
# Host DSP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sr,n_fft,n_mels,fmax",
                         [(22050, 1024, 80, None), (16000, 512, 40, 7000.0)])
def test_mel_filterbank_matches_jax(sr, n_fft, n_mels, fmax):
    np.testing.assert_array_equal(primitives.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax),
                                  jprim.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax))
    hz = np.array([0.0, 440.0, 999.0, 1000.0, 4000.0, 11025.0])
    np.testing.assert_array_equal(primitives.hz_to_mel(hz), jprim.hz_to_mel(hz))
    np.testing.assert_array_equal(primitives.mel_to_hz(primitives.hz_to_mel(hz)),
                                  jprim.mel_to_hz(jprim.hz_to_mel(hz)))
    for n in (0, 100, 1024, 5000):
        assert primitives.frame_indices(n, 1024, 256) == jprim.frame_indices(n, 1024, 256)


@pytest.mark.parametrize("i", [0, 4])
def test_stft_and_tts_features_match_jax(corpus, i):
    """The features of toy wavs: |STFT|, then the whole pipeline
    (trim, pre-emphasis, mel, max-norm and power, ×4 reduction) in both
    normalisations; rtol 1e-6."""
    _, jcfg, cfg = corpus
    y, sr = _wav(corpus, i)
    jy, jsr = jhost.load_wav(str(sorted((corpus[0] / "jax" / "wav22" / "p900").iterdir())[i]))
    np.testing.assert_array_equal(y, jy)
    assert sr == jsr == 22050
    np.testing.assert_allclose(host.stft_mag(y, 1024, 256), jhost.stft_mag(y, 1024, 256),
                               rtol=1e-6)
    np.testing.assert_allclose(host.stft(y, 512, 128, 400), jhost.stft(y, 512, 128, 400),
                               rtol=1e-6, atol=1e-9)
    for log_feature in (False, True):
        norm = jcfg.norm.__class__(log_feature=log_feature)
        mel, lin = host.tts_features(y, sr, cfg.replace(
            norm=cfg.norm.__class__(log_feature=log_feature)))
        jmel, jlin = jhost.tts_features(y, sr, jcfg.replace(norm=norm))
        assert mel.shape == jmel.shape and lin.shape == jlin.shape == (4 * mel.shape[0], 513)
        np.testing.assert_allclose(mel, jmel, rtol=1e-6)
        np.testing.assert_allclose(lin, jlin, rtol=1e-6)


def test_host_helpers_match_jax(corpus, tmp_path):
    y, sr = _wav(corpus, 1)
    np.testing.assert_array_equal(host.preemphasis(y, 0.97), jhost.preemphasis(y, 0.97))
    np.testing.assert_array_equal(host.deemphasis(y, 0.97), jhost.deemphasis(y, 0.97))
    np.testing.assert_array_equal(host.amplitude_to_db(y), jhost.amplitude_to_db(y))
    np.testing.assert_array_equal(host.resample(y, sr, 16000), jhost.resample(y, sr, 16000))
    path = str(tmp_path / "x.wav")
    host.write_wav(path, y, sr)
    got, got_sr = host.load_wav(path, sr=16000)
    ref, ref_sr = jhost.load_wav(path, sr=16000)
    assert got_sr == ref_sr == 16000
    np.testing.assert_array_equal(got, ref)


def test_load_wav_refuses_flac(tmp_path):
    """Once refused (the port had no FLAC codec); now ``load_wav`` reads a
    ``.FLAC`` the port wrote, to the JAX reader's samples and resampling."""
    y = np.sin(np.arange(8000) * 0.05).astype(np.float32) * 0.5
    path = str(tmp_path / "a.FLAC")
    host.write_flac(path, y, 16000)
    for sr in (None, 22050):
        got, got_sr = host.load_wav(path, sr=sr)
        want, want_sr = jhost.load_wav(path, sr=sr)
        assert got_sr == want_sr
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host.load_wav(path)[0],
                                  (np.clip(y, -1, 1) * 32767.0).astype(np.int32) / 32768.0)


# ---------------------------------------------------------------------------
# Corpora
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 7, 8, 24])
def test_split_speaker_files_matches_jax(n):
    files = [f"p225_{k:03d}.wav" for k in np.random.default_rng(n).permutation(n) + 1]
    assert vctk.split_speaker_files(files) == jvctk.split_speaker_files(files)


def test_prepare_vctk_path_lists_match_jax(corpus):
    """The same path lists (up to the data root) and wav22 files."""
    root, _, _ = corpus
    for kind in ("wav", "txt"):
        for mode in ("train", "validate", "synthesize"):
            name = os.path.join("data_path", "ordinary", f"{kind}.path.{mode}")
            ref = (root / "jax" / name).read_text().replace(str(root / "jax"), "R")
            assert (root / "port" / name).read_text().replace(str(root / "port"), "R") == ref
    a = sorted(p.relative_to(root / "jax") for p in (root / "jax" / "wav22").rglob("*.wav"))
    assert a == sorted(p.relative_to(root / "port")
                       for p in (root / "port" / "wav22").rglob("*.wav"))
    for rel in a:
        assert (root / "jax" / rel).read_bytes() == (root / "port" / rel).read_bytes()
    assert vctk.speaker_id_from_path("/x/p225_001.wav") == "p225"
    assert vctk.utterance_id_from_path("/x/p225_001.wav") == "p225_001"


@pytest.mark.parametrize("rich", [False, True])
def test_generate_toy_corpus_byte_equal(tmp_path, rich):
    kw = dict(n_speakers=2, utts_per_spk=3, seed=11, rich_speakers=rich, min_chars=6,
              max_chars=14)
    spk_j = jtoy.generate_toy_corpus(str(tmp_path / "j"), str(tmp_path / "je"), **kw)
    spk_p = toy.generate_toy_corpus(str(tmp_path / "p"), str(tmp_path / "pe"), **kw)
    assert spk_j == spk_p == ["p900", "p901"]
    for sub_j, sub_p in (("j", "p"), ("je", "pe")):
        files = sorted(p.relative_to(tmp_path / sub_j) for p in (tmp_path / sub_j).rglob("*.*"))
        assert files == sorted(p.relative_to(tmp_path / sub_p)
                               for p in (tmp_path / sub_p).rglob("*.*"))
        assert len(files) in (2 * 3 * 2, 2)
        for rel in files:
            assert (tmp_path / sub_j / rel).read_bytes() == (tmp_path / sub_p / rel).read_bytes()


def test_toy_config_and_attention_monotonicity_match_jax():
    assert (toy.toy_config("d", "e", "w", hidden_dim=32, batch_size=4).to_reference_dict()
            == jtoy.toy_config("d", "e", "w", hidden_dim=32, batch_size=4).to_reference_dict())
    att = np.random.default_rng(0).uniform(size=(12, 30)).astype(np.float32)
    for args in ((12,), (9, 20)):
        assert toy.attention_monotonicity(att, *args) == jtoy.attention_monotonicity(att, *args)


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

def _assert_batches_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            a = g[k].cpu().numpy() if isinstance(g[k], torch.Tensor) else g[k]
            r_k = np.asarray(r[k])
            assert a.dtype == r_k.dtype or (k == "text" and a.dtype.kind == r_k.dtype.kind), k
            np.testing.assert_array_equal(a, r_k, err_msg=k)


@pytest.mark.parametrize("with_lin", [False, True])
def test_pad_batch_matches_jax(corpus, with_lin):
    _, jcfg, cfg = corpus
    src = pipeline.TTSDataSource(cfg, "train", need_lin=with_lin)
    jsrc = jpipeline.TTSDataSource(jcfg, "train", need_lin=with_lin)
    ex = [src[i] for i in (0, 3, 7)]
    jex = [jsrc[i] for i in (0, 3, 7)]
    _assert_batches_equal([pipeline.pad_batch(ex, cfg, with_lin)],
                          [jpipeline.pad_batch(jex, jcfg, with_lin)])


@pytest.mark.parametrize("shuffle,seed,bs", [(True, 3, 4), (False, 0, 5)])
def test_bucketed_loader_matches_jax(corpus, shuffle, seed, bs):
    """Two epochs from one loader each: the same batches in the same order."""
    _, jcfg, cfg = corpus
    jcfg = jcfg.replace(tpu=jcfg.tpu.__class__(bucket_frames=(40, 60, 325)))
    cfg = cfg.replace(tpu=cfg.tpu.__class__(bucket_frames=(40, 60, 325)))
    loader = pipeline.BucketedLoader(pipeline.TTSDataSource(cfg, "train"), bs, with_lin=True,
                                     shuffle=shuffle, seed=seed)
    jloader = jpipeline.BucketedLoader(jpipeline.TTSDataSource(jcfg, "train"), bs,
                                       with_lin=True, shuffle=shuffle, seed=seed)
    for _ in range(2):
        _assert_batches_equal(list(loader), list(jloader))


@pytest.mark.parametrize("with_lin,drop_last", [(False, False), (True, True)])
def test_device_replay_loader_matches_jax(corpus, with_lin, drop_last):
    """The port's loader on the CPU against the JAX one for one seed, over
    three epochs (each re-draws the order), exactly; its resident bytes."""
    _, jcfg, cfg = corpus
    jcfg = jcfg.replace(tpu=jcfg.tpu.__class__(bucket_frames=(40, 60, 325),
                                               bucket_text=(15, 20, 186)))
    cfg = cfg.replace(tpu=cfg.tpu.__class__(bucket_frames=(40, 60, 325),
                                            bucket_text=(15, 20, 186)))
    loader = pipeline.DeviceReplayLoader(pipeline.TTSDataSource(cfg, "train"), 3,
                                         with_lin=with_lin, seed=4, drop_last=drop_last,
                                         device="cpu")
    jloader = jpipeline.DeviceReplayLoader(jpipeline.TTSDataSource(jcfg, "train"), 3,
                                           with_lin=with_lin, seed=4, drop_last=drop_last)
    assert len(loader) == len(jloader) >= 9 and len(loader._groups) > 1
    assert loader.nbytes == sum(np.asarray(v).nbytes for g in jloader._groups for v in g.values())
    for _ in range(3):
        got = list(loader)
        assert all(v.device.type == "cpu" for b in got for v in b.values())
        _assert_batches_equal(got, [jax.device_get(b) for b in jloader])


def test_device_replay_loader_refuses_a_mesh(corpus):
    """A mesh that is not the port's ``Mesh`` is refused (the loader over a
    real mesh: ``tests/test_torch_port_mesh.py``)."""
    _, _, cfg = corpus
    with pytest.raises(TypeError, match="Mesh"):
        pipeline.DeviceReplayLoader(pipeline.TTSDataSource(cfg, "train"), 2, mesh=object(),
                                    device="cpu")


def test_spec_cache_round_trip(corpus, tmp_path, monkeypatch):
    """Features are cached atomically (no temporary file left) under the
    utterance id, and a second source reads them back without the audio."""
    _, _, cfg = corpus
    spec = str(tmp_path / "spec")
    src = pipeline.TTSDataSource(cfg, "validate", spec, need_lin=True)
    src.warm_cache(workers=3)
    names = sorted(os.listdir(spec))
    assert len(names) == 2 * len(src) and all(n.endswith(("_mel.npy", "_lin.npy")) for n in names)
    first = [src[i] for i in range(len(src))]
    monkeypatch.setattr(pipeline.dsp_host, "load_wav",
                        lambda *a, **k: pytest.fail("the cache was not read"))
    again = pipeline.TTSDataSource(cfg, "validate", spec, need_lin=False)
    for e, f in zip(first, (again[i] for i in range(len(again)))):
        np.testing.assert_array_equal(e.mel, f.mel)
        np.testing.assert_array_equal(e.text, f.text)
        assert f.lin is None and e.utt_id == f.utt_id
        ref_mel, ref_lin = jhost.tts_features(*jhost.load_wav(
            next(p for p in src.wav_paths if e.utt_id in p)), JConfig())
        np.testing.assert_allclose(e.mel, ref_mel, rtol=1e-6)
        np.testing.assert_allclose(e.lin, ref_lin, rtol=1e-6)
    assert sorted(os.listdir(spec)) == names


def test_mcd_matches_jax():
    rng = np.random.default_rng(8)
    ref = rng.uniform(0.0, 1.0, (3, 30, 80)).astype(np.float32)
    syn = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1).astype(np.float32)
    lengths = np.array([30, 20, 1])
    for align in ("dtw", "frame"):
        assert mcd.batch_mcd(ref, syn, lengths, align=align) == jmcd.batch_mcd(ref, syn, lengths,
                                                                              align=align)
