"""d-vectors for diarization consumers (the uis-rnn format).

Port of :mod:`spoofsv_tpu.spoofkit.dvector` (the reference
``GE2E/dvector_create.py:24-122``): VAD chunks → 240 ms sliding log-mel
windows → one embedder call an utterance (on the embedder's device) → the
window pairs averaged into time-aligned segment embeddings, saved as
``train_sequence.npy`` and ``train_cluster_id.npy``.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from spoofsv_torch.config import GE2EConfig
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.models.ge2e import SpeechEmbedder
from spoofsv_torch.spoofkit.vad import vad_chunk


def concat_segs(times: List[Tuple[float, float]], segs: List[np.ndarray]
                ) -> Tuple[List[np.ndarray], List[Tuple[float, float]]]:
    """Adjacent VAD chunks merged into continuous segments (``dvector_create.py:24-39``)."""
    if not segs:
        return [], []
    concat_seg, seg_times = [], []
    cur, cur_t = segs[0], list(times[0])
    for t, s in zip(times[1:], segs[1:]):
        if abs(t[0] - cur_t[1]) < 1e-6:
            cur = np.concatenate([cur, s])
            cur_t[1] = t[1]
        else:
            concat_seg.append(cur)
            seg_times.append(tuple(cur_t))
            cur, cur_t = s, list(t)
    concat_seg.append(cur)
    seg_times.append(tuple(cur_t))
    return concat_seg, seg_times


def get_stfts(segs: List[np.ndarray], ge2e: GE2EConfig, window_s: float = 0.24,
              hop_frac: float = 0.5) -> List[np.ndarray]:
    """Sliding 240 ms log-mel windows of each segment, each (frames, nmels)
    (``dvector_create.py:42-59``)."""
    d = ge2e.data
    out = []
    win = int(window_s * d.sr)
    step = int(win * hop_frac)
    for seg in segs:
        for s in range(0, max(1, len(seg) - win + 1), step):
            piece = seg[s: s + win]
            if len(piece) < win:
                break
            S = dsp_host.ge2e_logmel(piece, d.sr, d.nfft, d.window, d.hop, d.nmels)
            out.append(S.T.astype(np.float32))
    return out


def align_embeddings(embeddings: np.ndarray) -> np.ndarray:
    """Consecutive window pairs averaged into aligned segment embeddings
    (``dvector_create.py:62-85``)."""
    partitions = [(s, s + 2) for s in range(0, len(embeddings) - 1)]
    if not partitions:
        partitions = [(0, len(embeddings))]
    return np.stack([embeddings[s:e].mean(axis=0) for s, e in partitions])


@torch.no_grad()
def create_dvectors(ge2e: GE2EConfig, embedder: SpeechEmbedder, pattern: Optional[str] = None,
                    out_dir: str = ".", min_va: float = 0.05, verbose: bool = True,
                    vad_classifier=None) -> Tuple[np.ndarray, np.ndarray]:
    """The uis-rnn ``(train_sequence, train_cluster_id)`` arrays of every file
    of ``pattern`` (default ``ge2e.unprocessed_data``), sorted; files with
    less than ``min_va`` s of voiced audio are skipped. ``vad_classifier``:
    None (the WebRTC detector the reference uses, ``dvector_create.py:92``),
    ``"energy"`` or a callable."""
    dev = next(embedder.parameters()).device
    was = embedder.training
    embedder.eval()
    sequences, cluster_ids = [], []
    try:
        for path in sorted(glob.glob(pattern or ge2e.unprocessed_data)):
            y, sr = dsp_host.load_wav(path, sr=ge2e.data.sr)
            chunks, spans = vad_chunk(y, sr, classifier=vad_classifier)
            if sum(len(c) for c in chunks) < min_va * sr:
                continue
            segs, _ = concat_segs(spans, chunks)
            windows = get_stfts(segs, ge2e)
            if not windows:
                continue
            emb = embedder(torch.from_numpy(np.stack(windows)).to(dev)).float().cpu().numpy()
            aligned = align_embeddings(emb)
            sequences.append(aligned)
            cluster_ids.append([os.path.basename(os.path.dirname(path))] * len(aligned))
            if verbose:
                print(path, "→", aligned.shape)
    finally:
        embedder.train(was)
    if sequences:
        train_sequence = np.concatenate(sequences, axis=0)
        train_cluster_id = np.asarray([c for ids in cluster_ids for c in ids])
    else:
        train_sequence = np.zeros((0, embedder.proj), np.float32)
        train_cluster_id = np.zeros((0,), dtype="<U16")
    np.save(os.path.join(out_dir, "train_sequence.npy"), train_sequence)
    np.save(os.path.join(out_dir, "train_cluster_id.npy"), train_cluster_id)
    return train_sequence, train_cluster_id
