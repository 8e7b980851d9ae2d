"""The port's spoof-set synthesis against the JAX package's, on the CPU.

``load_harvard_sentences`` and ``write_wav`` are held equal to the JAX ones;
``generate_spoof_set`` on a temporary layout of 3 speakers × 4 utterances
(the tiny configuration of ``test_torch_port_serve.py``, JAX parameters
carried into the port) writes the same file tree as the JAX one, with
samples within 2e-3 (spsi init). The port's ``generate_test_utterances``
CLI writes the same set with ``--skip_staging`` and refuses a mesh of more
ranks than the host's cores;
``load_generator_params`` round-trips the port's ``CheckpointManager``
checkpoints and refuses any other path.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from spoofsv_tpu.config import Config as JConfig
from spoofsv_tpu.dsp import host as jhost
from spoofsv_tpu.infer.synthesize import Synthesizer as JSynthesizer
from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.spoofkit import spoofgen as jspoofgen
from spoofsv_tpu.train.steps import shift_right
from spoofsv_torch.cli import generate_test_utterances as cli_gen
from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host
from spoofsv_torch.infer.synthesize import Synthesizer
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.spoofkit import spoofgen
from spoofsv_torch.train.loop import CheckpointManager
from spoofsv_torch.train.state import TrainState
from spoofsv_torch.weights import load_generator_params, load_melsyn_from_jax, load_ssrn_from_jax

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "",
    "It's easy to tell the depth of a well.",
    "  These days a chicken leg is a rare dish.  ",
    "Rice is often served in round bowls.",
]
SPEAKERS = ["p225", "p226", "p227"]
TINY = dict(hidden_dim=16, text_emb_dim=8, ssrn_dim=16, spk_emb_dim=10, max_text_len=48,
            max_frame_num=8)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """A data root with wav22/<spk> directories, speaker embeddings and a
    sentence file; the JAX and port configs over it; both models."""
    root = tmp_path_factory.mktemp("spoofgen")
    for spk in SPEAKERS:
        os.makedirs(root / "data" / "wav22" / spk)
    os.makedirs(root / "spk_emb")
    rng = np.random.default_rng(4)
    for spk in SPEAKERS:
        np.save(root / "spk_emb" / f"{spk}.npy", rng.normal(size=TINY["spk_emb_dim"]).astype(
            np.float32))
    (root / "havard.txt").write_text("\n".join(SENTENCES) + "\n")
    paths = dict(data_root_dir=str(root / "data"), spk_emb_dir=str(root / "spk_emb"),
                 tts_texts=str(root / "havard.txt"))

    def make(cls, out):
        cfg = cls().replace(**TINY, **paths, src_root_dir=str(root / out) + "/")
        return cfg.replace(tpu=dataclasses.replace(cfg.tpu, griffin_lim_iters=3))

    jcfg, cfg = make(JConfig, "jax"), make(Config, "port")
    jm = JMelSyn(vocab_len=jcfg.vocab_len, condition=True, spk_emb_dim=jcfg.spk_emb_dim,
                 text_emb_dim=jcfg.text_emb_dim, freq_bins=jcfg.mel.freq_bins,
                 hidden_dim=jcfg.hidden_dim, dtype=jnp.float32)
    js = JSSRN(freq_bins=jcfg.mel.freq_bins, output_bins=jcfg.lin_bins, ssrn_dim=jcfg.ssrn_dim,
               dtype=jnp.float32)
    text = jnp.asarray(rng.integers(1, jcfg.vocab_len - 1, (2, 12)), jnp.int32)
    spk = jnp.asarray(rng.normal(size=(2, jcfg.spk_emb_dim)), jnp.float32)
    mel = jnp.asarray(rng.uniform(0.05, 0.95, (2, 4, jcfg.mel.freq_bins)), jnp.float32)
    p1 = jm.init(jax.random.PRNGKey(1), shift_right(mel), text, spk)
    p2 = js.init(jax.random.PRNGKey(2), mel)
    tm = load_melsyn_from_jax(MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                                     cfg.mel.freq_bins, cfg.hidden_dim), p1)
    ts = load_ssrn_from_jax(SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim), p2)
    return SimpleNamespace(root=root, jcfg=jcfg, cfg=cfg, jsyn=JSynthesizer(jcfg, jm, js, p1, p2),
                           melsyn=tm, ssrn=ts, syn=Synthesizer(cfg, tm, ts))


def _tree(d):
    """{relative path: (sr, int16 samples)} of every wav under ``d``."""
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            path = os.path.join(base, f)
            out[os.path.relpath(path, d)] = wavfile.read(path)
    return out


@pytest.mark.parametrize("n", [1, 4, 20])
def test_load_harvard_sentences_matches_jax(layout, n):
    got = spoofgen.load_harvard_sentences(layout.cfg, n)
    assert got == jspoofgen.load_harvard_sentences(layout.jcfg, n)
    assert got == [s.strip() for s in SENTENCES if s.strip()][:n]


@pytest.mark.parametrize("signal", ["sine", "clipped", "negative"])
def test_write_wav_same_bytes(tmp_path, signal):
    t = np.linspace(0, 40, 2000)
    y = {"sine": 0.5 * np.sin(t), "clipped": 1.5 * np.sin(t),
         "negative": -np.abs(np.sin(t))}[signal].astype(np.float32)
    host.write_wav(str(tmp_path / "port.wav"), y, 22050)
    jhost.write_wav(str(tmp_path / "jax.wav"), y, 22050)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_generate_spoof_set_matches_jax(layout):
    """Two speakers a batch (a batch of 8 and one of 4): the reference
    layout, the same files, samples within 2e-3."""
    s = layout
    jdir = jspoofgen.generate_spoof_set(s.jcfg, "t0", s.jsyn, eval_utt_num=4, speaker_batch=2,
                                        verbose=False)
    tdir = spoofgen.generate_spoof_set(s.cfg, "t0", s.syn, eval_utt_num=4, speaker_batch=2,
                                       verbose=False)
    assert tdir == os.path.join(s.cfg.src_root_dir, "test", "t0", "spoof_data")
    ref, got = _tree(jdir), _tree(tdir)
    assert sorted(got) == sorted(ref) == sorted(
        os.path.join(f"s{spk[1:]}", f"s{spk[1:]}_{k:03d}.wav") for spk in SPEAKERS
        for k in range(1, 5))
    for name, (sr, y) in got.items():
        jsr, jy = ref[name]
        assert sr == jsr == s.cfg.sampling_rate and y.dtype == jy.dtype == np.int16
        assert len(y) == len(jy) and 0 < len(y) <= 9 * sr, (name, len(y), len(jy))
        np.testing.assert_allclose(y / 32767.0, jy / 32767.0, atol=2e-3, err_msg=name)


def test_checkpoint_round_trip_and_refusals(layout, tmp_path):
    """load_generator_params reads what the port's CheckpointManager wrote,
    for both generators, and refuses other paths and a generator's
    checkpoint loaded into the other generator."""
    s = layout
    cfg = s.cfg.replace(src_root_dir=str(tmp_path) + "/")
    for kind, model, fresh in (
            ("text2mel", s.melsyn, MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                                          cfg.mel.freq_bins, cfg.hidden_dim)),
            ("ssrn", s.ssrn, SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim))):
        mgr = CheckpointManager(cfg, "conditional", False, "rt", f"train_{kind}")
        state = TrainState(step=3, model=model,
                           optimizer=torch.optim.Adam(model.parameters(), lr=1e-3))
        path = mgr.save(state, {"epoch": 0, "iteration": 3, "loss_val_log": []})
        assert path.endswith(".tar.pth")
        assert load_generator_params(path, fresh) is fresh
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
    for bad in (str(tmp_path / "orbax_dir"), str(tmp_path / "weights.npz")):
        with pytest.raises(ValueError, match="export"):
            load_generator_params(bad, fresh)
    text2mel = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                      cfg.mel.freq_bins, cfg.hidden_dim)
    with pytest.raises(RuntimeError, match="state_dict"):
        load_generator_params(path, text2mel)     # the SSRN's checkpoint


def test_cli_writes_the_set_and_refuses_staging(layout, tmp_path):
    """The CLI with --skip_staging, from a config.json naming the port's
    checkpoints, writes the same set as generate_spoof_set from the same
    models. It once refused to stage; staging is ported now
    (``tests/test_torch_port_staging.py`` runs it), so what is refused is a
    mesh of more ranks than the host has cores, before any work (a mesh of
    two: ``tests/test_torch_port_mesh.py``); the staging flags are
    taken, and --skip_synthesis with --skip_staging does nothing, as in the
    JAX CLI."""
    s = layout
    ckpt = {}
    for kind, model in (("text2mel", s.melsyn), ("ssrn", s.ssrn)):
        mgr = CheckpointManager(s.cfg.replace(src_root_dir=str(tmp_path / "ck") + "/"),
                                "conditional", False, "cli", f"train_{kind}")
        ckpt[kind] = mgr.save(TrainState(0, model, torch.optim.Adam(model.parameters())),
                              {"epoch": 0, "iteration": 1, "loss_val_log": []})
    cfg = s.cfg.replace(src_root_dir=str(tmp_path / "cli") + "/",
                        inference_text2mel_model=ckpt["text2mel"],
                        inference_ssrn_model=ckpt["ssrn"])
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_reference_dict()))
    argv = ["-C", str(cfg_path), "-T", "c1", "--eval_utt_num", "4", "--speaker_batch", "3"]
    with pytest.raises(ValueError, match="cores"):
        cli_gen.main(argv + ["--mesh", str(os.cpu_count() + 1)], device="cpu")
    cli_gen.main(argv + ["--skip_staging", "--skip_synthesis", "--train_spk_num", "5"],
                 device="cpu")
    assert not (tmp_path / "cli").exists()
    cli_gen.main(argv + ["--skip_staging", "--enroll_utt_num", "2", "--mesh", "all"],
                 device="cpu")
    ref_dir = spoofgen.generate_spoof_set(s.cfg.replace(src_root_dir=str(tmp_path / "ref") + "/"),
                                          "c1", s.syn, eval_utt_num=4, speaker_batch=3,
                                          verbose=False)
    got, ref = _tree(tmp_path / "cli" / "test" / "c1" / "spoof_data"), _tree(ref_dir)
    assert sorted(got) == sorted(ref) and len(got) == 12
    for name in got:
        np.testing.assert_array_equal(got[name][1], ref[name][1])
