"""Text frontend: vocabulary, quote-merge, EOS.

Numpy copy of :mod:`spoofsv_tpu.data.text` (importing that module loads jax
through ``spoofsv_tpu/data/__init__.py``).
"""

from __future__ import annotations

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
