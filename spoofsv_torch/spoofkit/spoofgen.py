"""Spoof test-set synthesis and its staging for the three evaluation systems.

Port of :mod:`spoofsv_tpu.spoofkit.spoofgen`: many speakers' utterances go
through one :class:`Synthesizer` call, where the reference loops speakers on
20-utterance batches (``generate_test_utterances.py:99-139``); the staging
(the i-vector, GE2E and anti-spoofing layouts, transcripts and protocol) is
plain file work (``:141-260``), its shuffles drawn from Python's ``random``
as the JAX package draws them, so a seed stages the same files under the
same names.

Layout (the reference's):
  test/<ctime>/spoof_data/s<spk>/s<spk>_NNN.wav
  test/<ctime>/ivector_data/{wav/{train,dev,test},test_nospoof,transcript/...}
  test/<ctime>/ge2e_data/<spk dirs>                (symlinks)
  <ANTISPOOF_DIR>/<ctime>/flac/LA_D_NNNNNNN.flac + the protocol file
"""

from __future__ import annotations

import os
import random
import shutil
from typing import List, Optional, Sequence

import numpy as np
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.data.text import encode_texts
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.infer.synthesize import Synthesizer, finalize_audio, gl_seeds, to_host
from spoofsv_torch.utils.profiling import span


def load_harvard_sentences(cfg: Config, n: int) -> List[str]:
    """The first ``n`` non-empty lines of ``cfg.tts_texts``, stripped."""
    with open(cfg.tts_texts) as f:
        sentences = [l.strip() for l in f if l.strip()]
    return sentences[:n]


def generate_spoof_set(cfg: Config, ctime: str, synthesizer: Synthesizer,
                       eval_utt_num: int = 20,
                       speakers: Optional[Sequence[str]] = None,
                       speaker_batch: int = 8, seed: int = 0,
                       verbose: bool = True) -> str:
    """Synthesize ``eval_utt_num`` Harvard utterances for every speaker
    (default: every directory of ``<data_root_dir>/wav22``, sorted), each
    trimmed at 30 dB and capped at 9 s as the reference does; returns the
    ``spoof_data`` directory.

    ``speaker_batch`` speakers at a time make one batch of
    ``speaker_batch * eval_utt_num`` utterances, one synthesizer call. The
    Griffin-Lim seeds of each call (used by the "random" init only) are
    drawn from a ``torch.Generator`` seeded with ``seed``.

    With a synthesizer over a mesh (every rank calls this function alike;
    ``synthesizer`` may be any callable of the Synthesizer's signature, which
    runs single-device), the Synthesizer splits each call over the ranks (a
    call that does not divide the data axis is padded and cut back there),
    and only rank 0 writes wavs."""
    save_dir = os.path.join(cfg.src_root_dir, "test", ctime, "spoof_data")
    sentences = load_harvard_sentences(cfg, eval_utt_num)
    text_ids = encode_texts(sentences, cfg.vocabulary)

    if speakers is None:
        speakers = sorted(os.listdir(os.path.join(cfg.data_root_dir, "wav22")))
    gen = torch.Generator().manual_seed(seed)
    mesh = getattr(synthesizer, "mesh", None)

    for s0 in range(0, len(speakers), speaker_batch):
        chunk = speakers[s0: s0 + speaker_batch]
        embs = np.stack([np.load(os.path.join(cfg.spk_emb_dir, spk + ".npy")).astype(np.float32)
                         for spk in chunk])
        text = np.tile(text_ids, (len(chunk), 1))
        spk = np.repeat(embs, eval_utt_num, axis=0)
        audio, _, _ = synthesizer(text, spk, gl_seeds(len(text), gen))
        if mesh is not None and mesh.rank != 0:
            continue
        audio, = to_host(audio)
        with span("spoofset.finalize"):
            wavs = [finalize_audio(a, cfg, trim_db=30.0, max_seconds=9.0) for a in audio]
        with span("spoofset.write"):
            for ci, spk_name in enumerate(chunk):
                out_dir = os.path.join(save_dir, "s" + spk_name[1:])
                os.makedirs(out_dir, exist_ok=True)
                for k in range(eval_utt_num):
                    dsp_host.write_wav(
                        os.path.join(out_dir, f"s{spk_name[1:]}_{str(k + 1).zfill(3)}.wav"),
                        wavs[ci * eval_utt_num + k], cfg.sampling_rate)
                if verbose:
                    print("Generated utterances of speaker", spk_name)
    return save_dir


def stage_ivector_data(cfg: Config, ctime: str, train_spk_num: int = 88,
                       enroll_utt_num: int = 3, eval_utt_num: int = 20,
                       seed: Optional[int] = None, verbose: bool = True) -> str:
    """Stage real and synthetic wavs for the i-vector system
    (``generate_test_utterances.py:141-217``): the first ``train_spk_num``
    speakers (sorted) give all their real utterances as training data
    (speaker 0 also as the dev set); every other speaker gets
    ``enroll + eval`` random real utterances and its ``eval`` synthetic ones,
    renamed ``<spk>W###.wav``, with Kaldi-style transcripts (mixed, and the
    real-only control). ``seed`` seeds Python's ``random`` first."""
    if seed is not None:
        random.seed(seed)
    test_root = os.path.join(cfg.src_root_dir, "test", ctime)
    ivector_root = os.path.join(test_root, "ivector_data")
    spoof_dir = os.path.join(test_root, "spoof_data")
    real_root = os.path.join(cfg.data_root_dir, "wav22")
    txt_root = os.path.join(cfg.data_root_dir, "txt")

    real_list = sorted(os.listdir(real_root))
    syn_list = sorted(os.listdir(spoof_dir))
    sentences = load_harvard_sentences(cfg, eval_utt_num)

    os.makedirs(os.path.join(ivector_root, "transcript"), exist_ok=True)

    def read_txt(spk: str, utt: str) -> str:
        with open(os.path.join(txt_root, spk, utt[:-4] + ".txt")) as f:
            return f.readline().strip()

    with open(os.path.join(ivector_root, "transcript", "VCTK-transcript.txt"), "w") as tr, \
            open(os.path.join(ivector_root, "VCTK-transcript_nospoof.txt"), "w") as tr_ns:
        for i, spk in enumerate(real_list):
            sid = spk[1:]
            assert sid == syn_list[i][1:], (spk, syn_list[i])  # :159
            utts = os.listdir(os.path.join(real_root, spk))
            random.shuffle(utts)
            if i < train_spk_num:
                dst_dir = os.path.join(ivector_root, "wav", "train", sid)
                os.makedirs(dst_dir, exist_ok=True)
                for j, utt in enumerate(utts):
                    name = f"{sid}W{str(j + 1).zfill(3)}"
                    shutil.copy(os.path.join(real_root, spk, utt),
                                os.path.join(dst_dir, name + ".wav"))
                    line = read_txt(spk, utt)
                    tr.write(f"{name}    {line}\n")
                    tr_ns.write(f"{name}    {line}\n")
                if i == 0:   # the dev set: a copy of the first training speaker (:178-181)
                    dev_dir = os.path.join(ivector_root, "wav", "dev")
                    os.makedirs(dev_dir, exist_ok=True)
                    shutil.copytree(dst_dir, os.path.join(dev_dir, sid), dirs_exist_ok=True)
            else:
                test_dir = os.path.join(ivector_root, "wav", "test", sid)
                ns_dir = os.path.join(ivector_root, "test_nospoof", sid)
                os.makedirs(test_dir, exist_ok=True)
                os.makedirs(ns_dir, exist_ok=True)
                for j in range(enroll_utt_num + eval_utt_num):
                    utt = utts[j]
                    name = f"{sid}W{str(j + 1).zfill(3)}"
                    src = os.path.join(real_root, spk, utt)
                    shutil.copy(src, os.path.join(test_dir, name + ".wav"))
                    shutil.copy(src, os.path.join(ns_dir, name + ".wav"))
                    line = read_txt(spk, utt)
                    tr.write(f"{name}    {line}\n")
                    tr_ns.write(f"{name}    {line}\n")
                syn_utts = sorted(os.listdir(os.path.join(spoof_dir, "s" + sid)),
                                  key=lambda x: x[:-4])
                for j in range(eval_utt_num):
                    name = f"{sid}W{str(j + eval_utt_num + enroll_utt_num + 1).zfill(3)}"
                    shutil.copy(os.path.join(spoof_dir, "s" + sid, syn_utts[j]),
                                os.path.join(test_dir, name + ".wav"))
                    tr.write(f"{name}    {sentences[j]}\n")
            if verbose:
                print("i-vector staging:", i, sid)
    return ivector_root


def stage_ge2e_data(cfg: Config, ctime: str) -> str:
    """GE2E's layout: a symlink per speaker onto the i-vector layout
    (``generate_test_utterances.py:219-226``)."""
    test_root = os.path.join(cfg.src_root_dir, "test", ctime)
    ge2e_dir = os.path.join(test_root, "ge2e_data")
    os.makedirs(ge2e_dir, exist_ok=True)
    for sub in ("train", "test"):
        src_root = os.path.join(test_root, "ivector_data", "wav", sub)
        if not os.path.isdir(src_root):
            continue
        for spk in os.listdir(src_root):
            link = os.path.join(ge2e_dir, spk)
            if not os.path.exists(link):
                os.symlink(os.path.abspath(os.path.join(src_root, spk)), link)
    return ge2e_dir


def stage_antispoof_data(cfg: Config, ctime: str, bonafide_per_spk: int = 10,
                         n_speakers: int = 108, verbose: bool = True) -> str:
    """Stage bonafide and spoof audio for the countermeasure
    (``generate_test_utterances.py:228-260``): the ASVspoof2019 dev set's
    first bonafide files when its protocol is present, then every spoof
    utterance resampled to 16 kHz and written as 16-bit FLAC, under the
    reference's ``LA_D_NNNNNNN`` ids, with the protocol file."""
    test_root = os.path.join(cfg.src_root_dir, "test", ctime)
    spoof_dir = os.path.join(test_root, "spoof_data")
    save_dir = os.path.join(cfg.antispoof_dir, ctime, "flac")
    proto_dir = os.path.join(cfg.antispoof_dir, "ASVspoof2019_LA_cm_protocols")
    os.makedirs(save_dir, exist_ok=True)
    os.makedirs(proto_dir, exist_ok=True)

    bonafide_num = bonafide_per_spk * n_speakers
    index = 0
    with open(os.path.join(proto_dir, f"customized_data_{ctime}.txt"), "w") as protocol:
        dev_proto_path = os.path.join(proto_dir, "ASVspoof2019.LA.cm.dev.trl.txt")
        if os.path.exists(dev_proto_path):
            with open(dev_proto_path) as f:
                dev_proto = f.readlines()
            for _ in range(min(bonafide_num, len(dev_proto))):
                info = dev_proto[index].strip().split()
                assert info[-1] == "bonafide"    # :241
                src_flac = os.path.join(cfg.antispoof_dir, "ASVspoof2019_LA_dev", "flac",
                                        info[1] + ".flac")
                if os.path.exists(src_flac):
                    shutil.copy(src_flac,
                                os.path.join(save_dir, f"LA_D_{str(index + 1).zfill(7)}.flac"))
                protocol.write(f"{info[0]} LA_D_{str(index + 1).zfill(7)} - - bonafide\n")
                index += 1
        elif verbose:
            print("no ASVspoof2019 dev protocol found — staging spoof side only")

        for spk in sorted(os.listdir(spoof_dir)):
            for utt in sorted(os.listdir(os.path.join(spoof_dir, spk))):
                y, _ = dsp_host.load_wav(os.path.join(spoof_dir, spk, utt), sr=16000)
                dsp_host.write_flac(os.path.join(save_dir, f"LA_D_{str(index + 1).zfill(7)}.flac"),
                                    y, 16000)
                protocol.write(f"{spk} LA_D_{str(index + 1).zfill(7)} - - spoof\n")
                index += 1
    return save_dir
