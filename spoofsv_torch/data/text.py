"""Text frontend: vocabulary, quote-merge, EOS; and Tacotron 2's symbol ids.

Numpy copy of :mod:`spoofsv_tpu.data.text` (importing that module loads jax
through ``spoofsv_tpu/data/__init__.py``).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np


def build_char2idx(vocabulary: str) -> Dict[str, int]:
    """Char→id map with the reference's quote merge: '"' maps onto the id of
    "'" (``len(vocab)-2``), shrinking the effective vocab by one."""
    char2idx = {ch: i for i, ch in enumerate(vocabulary)}
    char2idx['"'] = len(vocabulary) - 2
    return char2idx


def text2id(text: str, vocabulary: str, char2idx: Dict[str, int]) -> np.ndarray:
    """Lowercase, append 'E' EOS, drop OOV chars → int32 ids, shape (L,)."""
    text = text.lower() + "E"
    ids = [char2idx[ch] for ch in text if ch in vocabulary]
    return np.asarray(ids, dtype=np.int32)


def encode_texts(texts: List[str], vocabulary: str, max_len: int | None = None
                 ) -> np.ndarray:
    """Encode + zero-pad a list of sentences to a (B, N) int32 batch.

    Padding id 0 is 'P' by construction of the vocabulary."""
    c2i = build_char2idx(vocabulary)
    encoded = [text2id(t, vocabulary, c2i) for t in texts]
    n = max_len or max(len(e) for e in encoded)
    out = np.zeros((len(encoded), n), dtype=np.int32)
    for i, e in enumerate(encoded):
        out[i, : min(len(e), n)] = e[:n]
    return out


# ---------------------------------------------------------------------------
# Tacotron 2's text (NVIDIA/tacotron2 text/symbols.py, text/cleaners.py)
# ---------------------------------------------------------------------------

# pad, special, punctuation, letters; the 84 ARPAbet symbols (ids 64-147)
# follow and are not read from plain text
T2_SYMBOLS = "_" + "-" + "!'(),.:;? " + "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_T2_IDS = {s: i for i, s in enumerate(T2_SYMBOLS)}
_T2_ABBREVIATIONS = [(re.compile(r"\b%s\." % a, re.IGNORECASE), b) for a, b in [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"), ("co", "company"),
    ("jr", "junior"), ("maj", "major"), ("gen", "general"), ("drs", "doctors"), ("rev", "reverend"),
    ("lt", "lieutenant"), ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort")]]


def english_cleaners(text: str) -> str:
    """NVIDIA's ``english_cleaners`` without number expansion and
    transliteration (no ``inflect``, ``unidecode`` here): lower case, the
    abbreviations spelt out, runs of whitespace as one space."""
    text = text.lower()
    for regex, replacement in _T2_ABBREVIATIONS:
        text = regex.sub(replacement, text)
    return re.sub(r"\s+", " ", text)


def t2_encode_texts(texts: List[str]) -> np.ndarray:
    """``text_to_sequence(t, ["english_cleaners"])`` of each text (no end
    id; symbols outside the table dropped), zero-padded (``_``) to the
    longest: (B, N) int64."""
    rows = [[_T2_IDS[ch] for ch in english_cleaners(t) if ch in _T2_IDS and ch != "_"]
            for t in texts]
    out = np.zeros((len(rows), max(len(r) for r in rows)), dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out
