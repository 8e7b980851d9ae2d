"""Spoof test-set synthesis.

Port of the synthesis half of :mod:`spoofsv_tpu.spoofkit.spoofgen`
(``load_harvard_sentences``, ``generate_spoof_set``): many speakers'
utterances go through one :class:`Synthesizer` call, where the reference
loops speakers on 20-utterance batches (``generate_test_utterances.py:99-139``).
The staging functions (i-vector, GE2E and anti-spoofing layouts) are not
ported yet: the anti-spoofing layout needs FLAC output.

Layout (the reference's): ``<src_root_dir>/test/<ctime>/spoof_data/s<spk>/s<spk>_NNN.wav``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.data.text import encode_texts
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.infer.synthesize import Synthesizer, finalize_audio, gl_seeds


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
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    save_dir = os.path.join(cfg.src_root_dir, "test", ctime, "spoof_data")
    sentences = load_harvard_sentences(cfg, eval_utt_num)
    text_ids = encode_texts(sentences, cfg.vocabulary)

    if speakers is None:
        speakers = sorted(os.listdir(os.path.join(cfg.data_root_dir, "wav22")))
    gen = torch.Generator().manual_seed(seed)

    for s0 in range(0, len(speakers), speaker_batch):
        chunk = speakers[s0: s0 + speaker_batch]
        embs = np.stack([np.load(os.path.join(cfg.spk_emb_dir, spk + ".npy")).astype(np.float32)
                         for spk in chunk])
        text = np.tile(text_ids, (len(chunk), 1))
        spk = np.repeat(embs, eval_utt_num, axis=0)
        audio, _, _ = synthesizer(text, spk, gl_seeds(len(text), gen))
        audio = audio.cpu().numpy()
        for ci, spk_name in enumerate(chunk):
            out_dir = os.path.join(save_dir, "s" + spk_name[1:])
            os.makedirs(out_dir, exist_ok=True)
            for k in range(eval_utt_num):
                wav = finalize_audio(audio[ci * eval_utt_num + k], cfg, trim_db=30.0,
                                     max_seconds=9.0)
                dsp_host.write_wav(os.path.join(out_dir, f"s{spk_name[1:]}_{str(k + 1).zfill(3)}.wav"),
                                   wav, cfg.sampling_rate)
            if verbose:
                print("Generated utterances of speaker", spk_name)
    return save_dir
