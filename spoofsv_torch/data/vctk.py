"""VCTK corpus preparation, the ``metagen.py`` equivalent.

Copy of :mod:`spoofsv_tpu.data.vctk` (importing it loads jax). The split
semantics are the reference's (``metagen.py:16-53``):

  * speaker p315 and file ``p376_295`` excluded (skipped, not deleted);
  * per speaker, files sorted by stem; validation takes the fractional
    positions {1,2,5}/7 and synthesis {3,4,6}/7 of the speaker's file
    count, training the rest;
  * wavs resampled to ``cfg.sampling_rate`` into ``wav22/``;
  * path lists written to ``<root>/data_path/ordinary/{wav,txt}.path.{mode}``.
"""

from __future__ import annotations

import os
from typing import Dict, List

from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host as dsp_host

DEV_LOC = (1 / 7, 2 / 7, 5 / 7)     # metagen.py:29
TEST_LOC = (3 / 7, 4 / 7, 6 / 7)    # metagen.py:30
EXCLUDED_SPEAKERS = ("p315",)       # metagen.py:16
EXCLUDED_FILES = ("p376_295",)      # metagen.py:18


def split_speaker_files(files: List[str]) -> Dict[str, List[str]]:
    """Assign a speaker's file list to the train/validate/synthesize splits."""
    files = sorted(files, key=lambda x: x[:-4])
    n = len(files)
    dev_idx = {int(n * f) for f in DEV_LOC}
    test_idx = {int(n * f) for f in TEST_LOC}
    out: Dict[str, List[str]] = {"train": [], "validate": [], "synthesize": []}
    for p, f in enumerate(files):
        if p in dev_idx:
            out["validate"].append(f)
        elif p in test_idx:
            out["synthesize"].append(f)
        else:
            out["train"].append(f)
    return out


def prepare_vctk(cfg: Config, resample: bool = True, verbose: bool = True) -> None:
    """Build ``wav22/`` and the ``data_path/ordinary`` path lists from
    ``wav48/`` and ``txt/`` under ``cfg.data_root_dir``."""
    root = cfg.data_root_dir
    wav48 = os.path.join(root, "wav48")
    txt = os.path.join(root, "txt")
    wav22 = os.path.join(root, "wav22")
    out_dir = os.path.join(root, "data_path", "ordinary")
    os.makedirs(out_dir, exist_ok=True)
    handles = {}
    try:
        for mode in ("train", "validate", "synthesize"):
            handles[("wav", mode)] = open(os.path.join(out_dir, f"wav.path.{mode}"), "w")
            handles[("txt", mode)] = open(os.path.join(out_dir, f"txt.path.{mode}"), "w")
        for spk in sorted(os.listdir(wav48)):
            spk_wav_dir = os.path.join(wav48, spk)
            if spk in EXCLUDED_SPEAKERS or not os.path.isdir(spk_wav_dir):
                continue
            files = [f for f in os.listdir(spk_wav_dir)
                     if f.endswith(".wav") and f[:-4] not in EXCLUDED_FILES]
            os.makedirs(os.path.join(wav22, spk), exist_ok=True)
            for mode, flist in split_speaker_files(files).items():
                for f in flist:
                    dst = os.path.join(wav22, spk, f)
                    if resample and not os.path.exists(dst):
                        y, sr = dsp_host.load_wav(os.path.join(spk_wav_dir, f))
                        if sr != cfg.sampling_rate:
                            y = dsp_host.resample(y, sr, cfg.sampling_rate)
                        dsp_host.write_wav(dst, y, cfg.sampling_rate)
                        if verbose:
                            print("Process", f)
                    handles[("wav", mode)].write(dst + "\n")
                    handles[("txt", mode)].write(os.path.join(txt, spk, f[:-4] + ".txt") + "\n")
    finally:
        for h in handles.values():
            h.close()


def speaker_id_from_path(wav_path: str) -> str:
    """Speaker id ('p225') from a wav path's basename."""
    return os.path.basename(wav_path).split("_")[0]


def utterance_id_from_path(wav_path: str) -> str:
    """Utterance id ('p225_001'), the feature cache's key."""
    return os.path.splitext(os.path.basename(wav_path))[0]
