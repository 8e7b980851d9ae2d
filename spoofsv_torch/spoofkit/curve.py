"""Spoof rate against FRR: the curves of ``curve.py``.

Port of :mod:`spoofsv_tpu.spoofkit.curve`: thresholds swept over (a) the
GE2E similarity matrices that ``spoofkit/ge2e_harness.py`` saves
(``simmat_e*_b*.npy``) and (b) the i-vector PLDA score files, then both
systems' SR-vs-FRR drawn on one figure (matplotlib, imported when drawing).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def ge2e_curve(simmat_path: str, n_speakers: int, eval_num: int = 20,
               n_thresholds: int = 5000) -> Tuple[List[float], List[float]]:
    """(spoof_rate[], gt_frr[]) over thresholds 0.5 + 0.0001·i (``curve.py:15-25``):
    the last 2·eval_num rows of a speaker's block are its spoofs, the first
    2·eval_num its real utterances."""
    sim = np.load(simmat_path) if simmat_path.endswith(".npy") else _load_torch(simmat_path)
    spoof_rates, frrs = [], []
    half = 2 * eval_num
    for i in range(n_thresholds):
        t = sim > 0.5 + 0.0001 * i
        sr = sum(t[j, -half:, j].sum() for j in range(n_speakers)) / half / n_speakers
        frr = sum(half - t[j, :half, j].sum() for j in range(n_speakers)) / half / n_speakers
        spoof_rates.append(float(sr))
        frrs.append(float(frr))
    return spoof_rates, frrs


def _load_torch(path: str) -> np.ndarray:
    import torch

    return torch.load(path, map_location="cpu").numpy()


def ivector_curve(score_path: str, enroll_plus_eval: int = 23,
                  thresholds: Optional[np.ndarray] = None) -> Tuple[List[float], List[float]]:
    """Parse a PLDA score file; target trials whose utterance index exceeds
    ``enroll_plus_eval`` are synthetic (``curve.py:27-49``)."""
    real_score, fake_score = [], []
    with open(score_path) as f:
        for line in f:
            info = line.strip().split()
            if len(info) < 3:
                continue
            if info[0] == info[1][:3]:
                if int(info[1][-3:]) > enroll_plus_eval:
                    fake_score.append(float(info[-1]))
                else:
                    real_score.append(float(info[-1]))
    real = np.asarray(real_score)
    fake = np.asarray(fake_score)
    if thresholds is None:
        thresholds = -50 + 0.01 * np.arange(8000)
    n = max(len(real), 1)
    srs = [float((fake > t).sum() / n) for t in thresholds]
    frrs = [float(1 - (real > t).sum() / n) for t in thresholds]
    return srs, frrs


def plot_curves(ge2e: Optional[Tuple[List[float], List[float]]] = None,
                ivector: Optional[Tuple[List[float], List[float]]] = None,
                out_path: str = "curve.png") -> str:
    """Draw the curves given into a PNG at ``out_path`` and return it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1)
    legend = []
    if ge2e is not None:
        ax.plot(ge2e[0], ge2e[1], "r--", lw=1)
        legend.append("GE2E")
    if ivector is not None:
        ax.plot(ivector[0], ivector[1], "b", lw=1)
        legend.append("i-vectors")
    ax.set_xlabel("Spoof Rate")
    ax.set_ylabel("FRR in real speech")
    ax.legend(legend)
    plt.savefig(out_path, format="png")
    plt.close(fig)
    return out_path
