"""Inputs made from the seed, handed alike to the program and the reference:
the models' weights (on the device, in the checkpoint's schema), the
speaker table, and the text ids of the data files' sentences."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from portbench.harness import BENCH, read_json

SALTS = {"text2mel": 1, "ssrn": 2, "speakers": 3, "traffic": 4, "sample": 5, "batches": 6}


def stream(seed: int, what: str) -> int:
    """A 63-bit seed of one named stream of a run's ``--seed``."""
    return (seed * 8 + SALTS[what]) % (1 << 63)


def seeded_state(schema: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, what: str, device,
                 dtype) -> Dict[str, "torch.Tensor"]:
    """A state dict over ``schema`` drawn in one call on ``device`` in
    ``dtype`` (the type the model runs in), then scaled in place: a weight
    of fan-in f (its input width times its taps; a
    stride-2 deconvolution's output sees one tap) N(0, 2/f); a LayerNorm
    gain 1 + N(0, 0.1²); every bias N(0, 0.1²)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(stream(seed, what))
    total = sum(int(np.prod(s)) for _, s in schema)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    with torch.no_grad():
        for name, shape in schema:
            n = int(np.prod(shape))
            t = flat[at: at + n].view(shape)
            at += n
            if name.endswith("bias"):
                t.mul_(0.1)
            elif len(shape) == 1:   # a LayerNorm's gain
                t.mul_(0.1).add_(1.0)
            else:
                fan_in = shape[0] if ".deconv." in name else int(np.prod(shape[1:]))
                t.mul_(float(np.sqrt(2.0 / fan_in)))
            out[name] = t
    return out


def sentences(n: int) -> List[str]:
    with open(BENCH / "data" / "harvard.txt") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if n > len(lines):
        raise ValueError(f"{n} sentences asked for, the data file has {len(lines)}")
    return lines[:n]


def encode(texts: Sequence[str], vocabulary: str, max_len: int = 0) -> np.ndarray:
    """Lower case, an ``E`` (end of sentence) appended, characters outside
    the vocabulary dropped, ``"`` read as ``'``; zero-padded (id 0, ``P``)
    to the longest, or to ``max_len``. (B, N) int32."""
    ids = {ch: i for i, ch in enumerate(vocabulary)}
    ids['"'] = len(vocabulary) - 2
    rows = [[ids[ch] for ch in t.lower() + "E" if ch in vocabulary] for t in texts]
    n = max_len or max(len(r) for r in rows)
    out = np.zeros((len(rows), n), np.int32)
    for i, r in enumerate(rows):
        out[i, : min(len(r), n)] = r[:n]
    return out


def speaker_table(seed: int) -> Tuple[List[str], np.ndarray]:
    """The speaker table of ``data/speakers.json``: its names, and one
    embedding a speaker drawn from the seed (standard normal, float32)."""
    spec = read_json(BENCH / "data" / "speakers.json")
    rng = np.random.default_rng(stream(seed, "speakers"))
    table = rng.standard_normal((len(spec["names"]), spec["dim"])).astype(np.float32)
    return list(spec["names"]), table
