"""The port's spoof-set staging against the JAX package's, on the CPU.

On a temporary layout (4 speakers with real wavs and transcripts, a spoof
set, an ASVspoof dev protocol with one bonafide FLAC) the three stagers
write, with the same seed, the same file tree as the JAX ones: the same
names, the same bytes (wavs copied, FLACs encoded by the same codec), the
same transcripts and protocol, the same symlinks. Then the port's
``generate_test_utterances`` CLI synthesizes a small set from random tiny
models and stages it, end to end, and every staged FLAC reads back to the
int16 samples it was written from.
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from spoofsv_tpu.config import Config as JConfig
from spoofsv_tpu.dsp import host as jhost
from spoofsv_tpu.spoofkit import spoofgen as jspoofgen
from spoofsv_torch.cli import generate_test_utterances as cli_gen
from spoofsv_torch.cli.main import build_models
from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host
from spoofsv_torch.spoofkit import flacio, spoofgen
from spoofsv_torch.train.loop import CheckpointManager
from spoofsv_torch.train.state import TrainState

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

SPEAKERS = ["p225", "p226", "p227", "p228"]
SENTENCES = ["The birch canoe slid on the smooth planks.",
             "Glue the sheet to the dark blue background.",
             "It's easy to tell the depth of a well."]


def _make_layout(root, spoof_per_spk=2, real_per_spk=5):
    rng = np.random.default_rng(0)
    for spk in SPEAKERS:
        (root / "data" / "wav22" / spk).mkdir(parents=True)
        (root / "data" / "txt" / spk).mkdir(parents=True)
        for j in range(real_per_spk):
            name = f"{spk}_{j + 1:03d}"
            y = (0.2 * rng.normal(size=int(22050 * rng.uniform(0.2, 0.4)))).astype(np.float32)
            host.write_wav(str(root / "data" / "wav22" / spk / f"{name}.wav"), y, 22050)
            (root / "data" / "txt" / spk / f"{name}.txt").write_text(f"utterance {j} of {spk}\n")
        sdir = root / "spoof" / ("s" + spk[1:])
        sdir.mkdir(parents=True)
        for k in range(spoof_per_spk):
            y = (0.3 * np.sin(np.arange(9000) * (0.02 + 0.01 * k))).astype(np.float32)
            host.write_wav(str(sdir / f"s{spk[1:]}_{k + 1:03d}.wav"), y, 22050)
    (root / "havard.txt").write_text("\n".join(SENTENCES) + "\n")
    proto = root / "protocols"
    proto.mkdir()
    (proto / "ASVspoof2019.LA.cm.dev.trl.txt").write_text(
        "LA_0069 LA_D_1047731 - - bonafide\nLA_0070 LA_D_1111111 - - bonafide\n")
    dev = root / "dev_flac"
    dev.mkdir()
    flacio.encode_flac(str(dev / "LA_D_1047731.flac"), (np.arange(3000) % 200 - 100) * 50, 16000)


def _stage_root(root, pkg, ctime):
    """A copy of the layout's spoof set and protocols under ``<root>/<pkg>``."""
    base = root / pkg
    shutil.copytree(root / "spoof", base / "test" / ctime / "spoof_data")
    shutil.copytree(root / "protocols", base / "cm" / "ASVspoof2019_LA_cm_protocols")
    shutil.copytree(root / "dev_flac", base / "cm" / "ASVspoof2019_LA_dev" / "flac")
    return dict(data_root_dir=str(root / "data"), tts_texts=str(root / "havard.txt"),
                src_root_dir=str(base) + "/", antispoof_dir=str(base / "cm"))


def _tree(base):
    """{relative path: bytes, or ('link', relative target)}."""
    out = {}
    for d, dirs, files in os.walk(base):
        for name in files + [x for x in dirs if os.path.islink(os.path.join(d, x))]:
            p = os.path.join(d, name)
            rel = os.path.relpath(p, base)
            out[rel] = (("link", os.path.relpath(os.path.realpath(p), base))
                        if os.path.islink(p) else open(p, "rb").read())
    return out


@pytest.mark.parametrize("seed,train_spk", [(3, 2), (11, 1)])
def test_stagers_write_the_jax_tree(tmp_path, seed, train_spk):
    _make_layout(tmp_path)
    ctime = "t1"
    jcfg = JConfig().replace(**_stage_root(tmp_path, "jax", ctime))
    cfg = Config().replace(**_stage_root(tmp_path, "port", ctime))
    random.seed(99)
    out = {}
    for pkg, mod, c in (("jax", jspoofgen, jcfg), ("port", spoofgen, cfg)):
        mod.stage_ivector_data(c, ctime, train_spk_num=train_spk, enroll_utt_num=1,
                               eval_utt_num=2, seed=seed, verbose=False)
        mod.stage_ge2e_data(c, ctime)
        mod.stage_antispoof_data(c, ctime, bonafide_per_spk=1, n_speakers=2, verbose=False)
        out[pkg] = _tree(tmp_path / pkg)
    assert sorted(out["port"]) == sorted(out["jax"])
    for rel, v in out["jax"].items():
        assert out["port"][rel] == v, rel
    iv = f"test/{ctime}/ivector_data"
    names = sorted(k for k in out["port"] if k.startswith(f"{iv}/wav/test/"))
    assert len(names) == (4 - train_spk) * (1 + 2 + 2)
    transcript = out["port"][f"{iv}/transcript/VCTK-transcript.txt"].decode()
    assert f"228W005    {SENTENCES[1]}" in transcript
    assert out["port"][f"test/{ctime}/ge2e_data/228"][0] == "link"
    proto = out["port"][f"cm/ASVspoof2019_LA_cm_protocols/customized_data_{ctime}.txt"].decode()
    assert proto.splitlines()[:3] == ["LA_0069 LA_D_0000001 - - bonafide",
                                      "LA_0070 LA_D_0000002 - - bonafide",
                                      "s225 LA_D_0000003 - - spoof"]


def test_stage_ivector_checks_the_speaker_order(tmp_path):
    _make_layout(tmp_path)
    cfg = Config().replace(**_stage_root(tmp_path, "port", "t"))
    os.rename(tmp_path / "port" / "test" / "t" / "spoof_data" / "s228",
              tmp_path / "port" / "test" / "t" / "spoof_data" / "s999")
    with pytest.raises(AssertionError):
        spoofgen.stage_ivector_data(cfg, "t", 1, 1, 2, seed=0, verbose=False)


TINY = dict(hidden_dim=16, text_emb_dim=8, ssrn_dim=16, spk_emb_dim=10, max_text_len=48,
            max_frame_num=8)


def test_generate_test_utterances_end_to_end(tmp_path):
    """Synthesis from random tiny models through reference checkpoints, then
    all three stagings; each staged FLAC holds the int16 samples of the
    16 kHz spoof utterance it was written from, as the JAX reader reads it."""
    _make_layout(tmp_path)
    (tmp_path / "emb").mkdir()
    rng = np.random.default_rng(1)
    for spk in SPEAKERS:
        np.save(tmp_path / "emb" / f"{spk}.npy", rng.normal(size=10).astype(np.float32))
    cfg = Config().replace(**TINY, data_root_dir=str(tmp_path / "data"),
                           spk_emb_dir=str(tmp_path / "emb"),
                           tts_texts=str(tmp_path / "havard.txt"),
                           src_root_dir=str(tmp_path / "run") + "/",
                           antispoof_dir=str(tmp_path / "cm"))
    torch.manual_seed(0)
    melsyn, ssrn, _, _ = build_models(cfg, device="cpu")
    ckpt = {}
    for kind, model in (("text2mel", melsyn), ("ssrn", ssrn)):
        mgr = CheckpointManager(cfg, "conditional", False, "ck", f"train_{kind}")
        ckpt[kind] = mgr.save(TrainState(0, model, torch.optim.Adam(model.parameters())),
                              {"epoch": 0, "iteration": 1, "loss_val_log": []})
    cfg = cfg.replace(inference_text2mel_model=ckpt["text2mel"],
                      inference_ssrn_model=ckpt["ssrn"])
    conf = tmp_path / "config.json"
    conf.write_text(json.dumps(cfg.to_reference_dict()))
    argv = ["-C", str(conf), "-T", "e2e", "--train_spk_num", "2", "--enroll_utt_num", "1",
            "--eval_utt_num", "2", "--speaker_batch", "4"]
    with pytest.raises(ValueError, match="cores"):
        cli_gen.main(argv + ["--mesh", str(os.cpu_count() + 1)], device="cpu")
    cli_gen.main(argv, device="cpu")
    test_root = tmp_path / "run" / "test" / "e2e"
    spoof = sorted(p.relative_to(test_root / "spoof_data").as_posix()
                   for p in (test_root / "spoof_data").rglob("*.wav"))
    assert spoof == [f"s{s[1:]}/s{s[1:]}_{k:03d}.wav" for s in SPEAKERS for k in (1, 2)]
    assert sorted(os.listdir(test_root / "ivector_data" / "wav" / "test" / "227")) == [
        f"227W{k:03d}.wav" for k in range(1, 6)]
    assert sorted(os.listdir(test_root / "ge2e_data")) == ["225", "226", "227", "228"]
    flacs = sorted(os.listdir(tmp_path / "cm" / "e2e" / "flac"))
    assert flacs == [f"LA_D_{i:07d}.flac" for i in range(1, 9)]
    for i, rel in enumerate(spoof):
        y, _ = host.load_wav(str(test_root / "spoof_data" / rel), sr=16000)
        want = (np.clip(y, -1, 1) * 32767.0).astype(np.int32)
        path = str(tmp_path / "cm" / "e2e" / "flac" / flacs[i])
        got, sr = flacio.decode_flac(path)
        assert sr == 16000
        np.testing.assert_array_equal(np.round(got * 32768.0).astype(np.int32), want)
        np.testing.assert_array_equal(host.load_wav(path)[0], jhost.load_wav(path)[0])
