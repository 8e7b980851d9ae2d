"""16-bit FLAC in and out through the native codec of ``libspoofkit``.

Port of :mod:`spoofsv_tpu.spoofkit.flacio`: the reference reads and writes
the anti-spoofing corpus's 16 kHz FLAC through libsndfile
(``generate_test_utterances.py:246-255``); ``native/src/flac.cc`` implements
the codec (fixed predictors and Rice residuals when encoding; the LPC
subframes too when decoding), and these wrappers take and give numpy.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from spoofsv_torch.native import load_lib


def decode_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode → (float32 (n,) mono or (n, ch), sample rate), samples scaled
    by 2^-(bits-1). The codec allocates, so a stream whose STREAMINFO gives
    0 total samples (unknown length) decodes whole."""
    lib = load_lib()
    n, sr, ch, bits = ctypes.c_int64(0), ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    h = lib.sk_flac_decode_alloc(path.encode(), ctypes.byref(n), ctypes.byref(sr),
                                 ctypes.byref(ch), ctypes.byref(bits))
    if not h:
        raise ValueError(f"not a decodable FLAC file: {path}")
    try:
        pcm = np.zeros((n.value * ch.value,), np.int32)
        if len(pcm):
            lib.sk_flac_pcm_copy(h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.sk_flac_pcm_free(h)
    y = pcm.astype(np.float32) / float(1 << (bits.value - 1))
    if ch.value > 1:
        y = y.reshape(-1, ch.value)
    return y, sr.value


def encode_flac(path: str, pcm: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Encode integer PCM, (n,) or (n, ch), as a FLAC file."""
    lib = load_lib()
    pcm = np.asarray(pcm, np.int32)
    n, channels = (len(pcm), 1) if pcm.ndim == 1 else pcm.shape
    inter = np.ascontiguousarray(pcm.reshape(-1))
    rc = lib.sk_flac_encode(path.encode(), inter.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            n, channels, sample_rate, bits)
    if rc != 0:
        raise IOError(f"FLAC encode failed: {path}")
