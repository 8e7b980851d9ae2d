"""The work each stage's algorithm needs, counted from the cell's shapes alone.

Every count is of the algorithm, whatever implements it: floating-point
operations (a multiply-add is two) and the bytes a stage must move at
least (its weights, inputs and outputs, each once, at the stored width).
The Griffin-Lim count is its transforms' arithmetic as real FFTs
(2.5·n·log2 n operations a transform of n real points) and its pointwise
work, not the products of a DFT as matrix, so no implementation can read
above its bound. The peaks are in ``peaks.json``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Tuple

Work = Tuple[float, float]   # (operations, bytes)

DILATED = 4   # blocks in a dilated stack (dilations 1, 3, 9, 27)


def _hw(c: int, k: int) -> float:
    """Multiply-adds a frame of one highway block: a width-c → 2c conv of k taps."""
    return k * c * 2 * c


def k1_decode(C: int, F: int, B: int, N: int, T: int, elem: int) -> Work:
    """The autoregressive decode's products over a rollout (its 16 causal
    highway layers of 3 taps, the audio encoder's and decoder's dense
    layers) and the bytes it must move: the weights, K and V, the speaker
    projections and the outputs, ``elem`` bytes a value."""
    macs_row = 16 * 3 * C * 2 * C + 5 * C * C + 2 * C * C + F * C + C * F
    return (2.0 * macs_row * B * T,
            elem * (macs_row + 2 * B * N * C + 2 * B * C + B * T * F + B * N * T))


def text_encoder(C: int, E: int, S: int, B: int, N: int, elem: int) -> Work:
    """The text encoder at width 2C over B texts of N ids, and the two
    speaker projections (S → C)."""
    d2 = 2 * C
    macs_tok = E * d2 + d2 * d2 + (2 * DILATED + 2) * _hw(d2, 3) + 2 * _hw(d2, 1)
    weights = macs_tok + 2 * S * C
    return (2.0 * (macs_tok * B * N + 2 * S * C * B),
            elem * (weights + B * N + B * S + 2 * B * N * C))


def decode_stage(C: int, E: int, S: int, F: int, B: int, N: int, T: int, elem: int) -> Work:
    """The synthesis call's decode stage: the text encoder, then the rollout."""
    a, b = text_encoder(C, E, S, B, N, elem), k1_decode(C, F, B, N, T, elem)
    return a[0] + b[0], a[1] + b[1]


def ssrn(D: int, F: int, L: int, B: int, T: int, elem: int) -> Work:
    """SSRN over B coarse mels of T frames (output 4T frames of L bins)."""
    at_t = F * D + 2 * _hw(D, 3)                      # conv1, hc1, hc2
    at_2t = D * D + 2 * _hw(D, 3)                     # ups1's deconv (per output frame), its pair
    at_4t = D * D + 2 * _hw(D, 3) + D * 2 * D + 2 * _hw(2 * D, 3) \
        + 2 * D * L + 3 * L * L                       # ups2, conv2, hc3, hc4, conv3-6
    macs = B * (T * at_t + 2 * T * at_2t + 4 * T * at_4t)
    weights = at_t + at_2t + at_4t
    return 2.0 * macs, elem * (weights + B * T * F + B * 4 * T * L)


def fft_ops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def griffin_lim(n_fft: int, B: int, T: int, iters: int, in_elem: int) -> Work:
    """The vocoder over B magnitudes of T frames: the renorm and power, the
    phase init, ``iters`` iterations (an inverse and a forward transform a
    frame, the windows and overlap-add, the momentum update of each bin),
    the final inverse, and de-emphasis. Bytes: the magnitude in
    (``in_elem`` a value), the float32 audio out."""
    bins = n_fft // 2 + 1
    hop = n_fft // 4
    per_iter = 2 * fft_ops(n_fft) + 4 * n_fft + 12 * bins
    frames = B * T
    ops = frames * (iters * per_iter + fft_ops(n_fft) + 2 * n_fft + 35 * bins)
    samples = B * hop * (T - 1)
    return ops + 2.0 * samples, in_elem * frames * bins + 4.0 * samples


def text2mel_step(C: int, E: int, S: int, F: int, B: int, N: int, T: int, params: int) -> Work:
    """One training step of Text2Mel, teacher forced over B utterances of T
    frames and N ids: the forward (text encoder, audio encoder, attention,
    decoder), the backward at twice the forward, Adam at 12 operations a
    parameter. Bytes: the parameters, gradients and both moments read and
    written once (float32), and the batch."""
    fwd = text_encoder(C, E, S, B, N, 4)[0] / 2.0
    enc = F * C + 2 * C * C + 2 * DILATED * _hw(C, 3) + 2 * _hw(C, 3)
    dec = 2 * C * C + DILATED * _hw(C, 3) + 2 * _hw(C, 3) + 3 * C * C + C * F
    fwd += B * T * (enc + dec) + 2 * B * N * T * C
    ops = 2.0 * fwd * 3 + 12.0 * params
    nbytes = 4.0 * (6 * params + B * T * F + B * S) + 4.0 * B * N
    return ops, nbytes


_PEAKS: Optional[dict] = None


def peaks(device_kind: str) -> Optional[Dict[str, float]]:
    """The published dense peaks of a card (``peaks.json``), or None for a
    card the table lacks."""
    global _PEAKS
    if _PEAKS is None:
        with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
            _PEAKS = json.load(f)
    return _PEAKS["devices"].get(device_kind)


def bound_s(work: Work, precision: str, table: Dict[str, float]) -> float:
    """The least time a card could take: the larger of the operations over
    the peak of ``precision`` and the bytes over the memory bandwidth."""
    ops, nbytes = work
    return max(ops / table[precision], nbytes / table["bytes_per_s"])
