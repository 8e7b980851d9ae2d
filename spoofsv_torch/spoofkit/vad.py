"""Voice activity detection, the host-native stand-in for webrtcvad.

Port of :mod:`spoofsv_tpu.spoofkit.vad`. The reference drives the webrtcvad
C extension (``GE2E/VAD_segments.py``): a frame generator, a collector with
a 90 % ring-buffer trigger, and 0.4 s chunks of the voiced segments. The
collector and chunker are transcribed exactly (``VAD_segments.py:47-150``).
The per-frame classifiers:

* ``"webrtc"`` (the default): ``native/src/webrtc_vad.cc``, the fixed-point
  6-band GMM detector of WebRTC that the reference's ``webrtcvad.Vad(2)``
  runs, at 8 or 16 kHz;
* ``"energy"``: an adaptive energy detector. In default mode it also takes
  any other sample rate, where the WebRTC detector does not run (the JAX
  package's rule); an explicit ``"webrtc"`` at such a rate raises;
* any callable ``(y, sr, frame_ms) -> bool[frames]``.
"""

from __future__ import annotations

import ctypes
import warnings
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

from spoofsv_torch.native import load_lib

Classifier = Callable[[np.ndarray, int, int], np.ndarray]
#: the classifier that ``classifier=None`` means: the reference's detector
DEFAULT_CLASSIFIER = "webrtc"


def frame_generator(y: np.ndarray, sr: int, frame_ms: int = 20):
    """Yield (start sample, frame) of ``frame_ms`` frames, with the
    reference's strict ``offset + n < len`` cut (``VAD_segments.py:47-60``:
    a signal of an exact multiple of frames drops its last frame)."""
    n = int(sr * frame_ms / 1000)
    offset = 0
    while offset + n < len(y):
        yield offset, y[offset: offset + n]
        offset += n


def _num_frames(n_samples: int, n: int) -> int:
    """The frame count under the strict ``offset + n < len`` rule."""
    return max(0, (n_samples - 1) // n)


def energy_classifier(y: np.ndarray, sr: int, frame_ms: int = 20,
                      aggressiveness: int = 2) -> np.ndarray:
    """Voiced decisions per frame from the frame's log energy against an
    adaptive threshold; ``aggressiveness`` 0-3 raises it as webrtcvad's modes
    do."""
    n = int(sr * frame_ms / 1000)
    n_frames = _num_frames(len(y), n)
    if n_frames == 0:
        return np.zeros(0, bool)
    frames = y[: n_frames * n].reshape(n_frames, n)
    e = np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1) + 1e-12)
    log_e = 20 * np.log10(e + 1e-12)
    floor = np.percentile(log_e, 10)
    peak = np.percentile(log_e, 95)
    if peak - floor < 15.0:
        # no silence floor (continuous audio): voiced above an absolute hum floor
        thresh = min(floor, -55.0)
    else:
        thresh = floor + (0.25 + 0.15 * aggressiveness) * (peak - floor)
    return log_e >= thresh


def float_to_pcm16(y: np.ndarray) -> np.ndarray:
    """The int16 samples a wav reader would hand webrtcvad: ``float32 ==
    int16 / 32768`` exactly, so rounding ``y · 32768`` recovers them."""
    return np.clip(np.round(np.asarray(y, np.float64) * 32768.0), -32768, 32767).astype(np.int16)


def webrtc_classifier(y: np.ndarray, sr: int, frame_ms: int = 20,
                      aggressiveness: int = 2) -> np.ndarray:
    """Voiced decisions per frame from the native WebRTC detector: one
    stateful detector an utterance, its frames in stream order, as the
    reference calls ``webrtcvad.Vad(2).is_speech`` (``VAD_segments.py:93``)."""
    if sr not in (8000, 16000):
        raise ValueError(f"webrtc classifier supports 8/16 kHz, got {sr}")
    n = int(sr * frame_ms / 1000)
    n_frames = _num_frames(len(y), n)
    if n_frames == 0:
        return np.zeros(0, bool)
    pcm = float_to_pcm16(y)
    flags = np.zeros(n_frames, np.uint8)
    count = load_lib().sk_vad_frames(int(aggressiveness),
                                     pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                                     len(pcm), n, sr,
                                     flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if count < 0:
        raise ValueError(f"invalid VAD frame config: {frame_ms} ms @ {sr} Hz")
    assert count == n_frames, (count, n_frames)
    return flags.astype(bool)


def resolve_classifier(classifier) -> Optional[Classifier]:
    """The ``classifier=`` knob as a callable: ``"energy"`` → None (the energy
    detector), None → :data:`DEFAULT_CLASSIFIER`, ``"webrtc"`` → the native
    detector, a callable → itself."""
    if classifier is None:
        classifier = DEFAULT_CLASSIFIER
    if classifier == "energy":
        return None
    if classifier == "webrtc":
        return webrtc_classifier
    if callable(classifier):
        return classifier
    raise ValueError(f"unknown VAD classifier {classifier!r}")


def collect_from_flags(flags: np.ndarray, n: int, num_padding: int) -> List[Tuple[int, int]]:
    """The webrtc demo's collector on per-frame decisions
    (``VAD_segments.py:63-130``): (start, end) sample ranges, ``n`` samples
    a frame."""
    ring: deque = deque(maxlen=num_padding)
    triggered = False
    segments: List[Tuple[int, int]] = []
    start = 0
    n_voiced_collected = 0
    i = -1
    for i, voiced in enumerate(map(bool, flags)):
        if not triggered:
            ring.append((i, voiced))
            if sum(1 for _, v in ring if v) > 0.9 * num_padding:
                triggered = True
                start = ring[0][0] * n
                n_voiced_collected += len(ring)
                ring.clear()
        else:
            n_voiced_collected += 1
            ring.append((i, voiced))
            if sum(1 for _, v in ring if not v) > 0.9 * num_padding:
                triggered = False
                segments.append((start, (i + 1) * n))
                ring.clear()
                n_voiced_collected = 0
    if n_voiced_collected:
        segments.append((start, (i + 1) * n))
    return segments


def vad_collector(y: np.ndarray, sr: int, frame_ms: int = 20, padding_ms: int = 200,
                  aggressiveness: int = 2,
                  classifier: "Optional[Classifier | str]" = None) -> List[Tuple[int, int]]:
    """Voiced (start, end) sample ranges with the 90 % ring-buffer
    hysteresis (``VAD_segments.py:63-130``)."""
    n = int(sr * frame_ms / 1000)
    fn = resolve_classifier(classifier)
    if fn is webrtc_classifier and classifier is None and sr not in (8000, 16000):
        warnings.warn(f"webrtc VAD unsupported at {sr} Hz — falling back to the energy "
                      "detector", stacklevel=2)
        fn = None
    if fn is None:
        flags = energy_classifier(y, sr, frame_ms, aggressiveness)
    elif fn is webrtc_classifier:
        flags = webrtc_classifier(y, sr, frame_ms, aggressiveness)
    else:
        flags = fn(y, sr, frame_ms)
    return collect_from_flags(flags, n, int(padding_ms / frame_ms))


def vad_chunk(y: np.ndarray, sr: int, chunk_s: float = 0.4, aggressiveness: int = 2,
              classifier: "Optional[Classifier | str]" = None
              ) -> Tuple[List[np.ndarray], List[Tuple[float, float]]]:
    """The voiced audio in pieces of at most ``chunk_s`` with their time
    spans (``VAD_segments.py:132-150``: times rounded to 2 decimals, fixed
    strides, the while/else tail). Where a segment is an exact multiple of
    ``chunk_s`` the reference emits an empty last chunk; it is dropped here,
    as in the JAX package."""
    chunks, spans = [], []
    for s, e in vad_collector(y, sr, aggressiveness=aggressiveness, classifier=classifier):
        start = float(np.round(s / sr, 2))
        end = float(np.round(e / sr, 2))
        j = start
        while j + chunk_s < end:
            ej = float(np.round(j + chunk_s, 2))
            chunks.append(y[int(j * sr): int(ej * sr)])
            spans.append((j, ej))
            j = ej
        if end - j > 1e-9:
            chunks.append(y[int(j * sr): int(end * sr)])
            spans.append((j, end))
    return chunks, spans
