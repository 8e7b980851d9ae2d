"""Plain-torch reference of the multi-speaker Tacotron 2 synthesis model.

Tacotron 2 as NVIDIA/tacotron2 writes it (``model.py``: the encoder, the
decoder with location-sensitive attention, the postnet; the widths of
``hparams.py``), over a state dict in that repository's schema, with the
speaker conditioning of SV2TTS (Jia et al., arXiv:1806.04558, sec. 2.2): the
speaker's d-vector is concatenated to every encoder output, so the
attention's memory is ``encoder_embedding_dim + speaker_embedding_dim``
wide and feeds ``memory_layer``, both LSTM cells' inputs through the
context, the projection and the gate. Float32, plain ``torch``, TF32 off;
no cache, graph or batching tricks. It imports nothing of the program.

The hyperparameters are the ``hparams.py`` keys, as a dict (``hp``).

Departures from ``model.py`` (the program makes the same ones):

* Batched text: each row's encoder sees its own ids only (the padding is
  zeroed before every convolution, the BiLSTM runs over the row's own
  length), and its attention energies are -inf on its padding. NVIDIA's
  batch-1 ``inference`` has neither, and needs neither.
* The prenet's dropout stays on at inference (p 0.5, paper sec. 2.2), with
  its masks drawn from a counter-based hash of (row seed, step, layer,
  unit) (:func:`prenet_keep`), not from torch's generator, so that a call
  is reproducible from its seeds.
* The decoder runs the steps it is asked for: the gate is computed at each
  step, not obeyed.
* The paper's zoneout is NVIDIA's training-only dropout, absent at inference.
* Text: ``english_cleaners`` without number expansion (no ``inflect``,
  ``unidecode``): digits are dropped as symbols outside the table.

``Precision`` rounds the operands of every product (weights and the
activations entering a convolution, a dense layer, an LSTM cell's gate
products or the attention's context) for a control: float8 (e4m3,
per-tensor scale) below a bfloat16 configuration.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]
BN_EPS = 1e-5
PRENET_DROPOUT = 0.5   # model.py's Prenet, kept on at inference

# ---------------------------------------------------------------------------
# text (NVIDIA text/symbols.py, text/cleaners.py::english_cleaners)
# ---------------------------------------------------------------------------

# pad, special, punctuation, letters; the 84 ARPAbet symbols follow them
# (ids 64-147) and are not read from plain text
SYMBOLS = "_" + "-" + "!'(),.:;? " + "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_ABBREVIATIONS = [(re.compile(r"\b%s\." % a, re.IGNORECASE), b) for a, b in [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"), ("co", "company"),
    ("jr", "junior"), ("maj", "major"), ("gen", "general"), ("drs", "doctors"), ("rev", "reverend"),
    ("lt", "lieutenant"), ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort")]]


def english_cleaners(text: str) -> str:
    text = text.lower()
    for regex, replacement in _ABBREVIATIONS:
        text = re.sub(regex, replacement, text)
    return re.sub(r"\s+", " ", text)


def text_to_ids(text: str) -> List[int]:
    """``text_to_sequence(text, ["english_cleaners"])``: no end id; symbols
    outside the table (and the pad) dropped."""
    ids = {s: i for i, s in enumerate(SYMBOLS)}
    return [ids[ch] for ch in english_cleaners(text) if ch in ids and ch != "_"]


def encode_texts(texts: Sequence[str]) -> np.ndarray:
    """(B, N) int64 ids, zero-padded (the pad ``_``) to the longest."""
    rows = [text_to_ids(t) for t in texts]
    out = np.zeros((len(rows), max(len(r) for r in rows)), np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def lengths_of(ids: torch.Tensor) -> torch.Tensor:
    """Each row's length: its ids up to the padding (id 0)."""
    return (ids != 0).sum(dim=1)


# ---------------------------------------------------------------------------
# the state dict's schema (NVIDIA model.py's module tree, in its order)
# ---------------------------------------------------------------------------

def _bn(prefix: str, c: int) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(f"{prefix}.{n}", (c,)) for n in ("weight", "bias", "running_mean", "running_var")] \
        + [(f"{prefix}.num_batches_tracked", ())]


def _conv_bn(prefix: str, out: int, inp: int, k: int) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(f"{prefix}.0.conv.weight", (out, inp, k)), (f"{prefix}.0.conv.bias", (out,))] \
        + _bn(f"{prefix}.1", out)


def _lstm(prefix: str, inp: int, hid: int, suffix: str = "") -> List[Tuple[str, Tuple[int, ...]]]:
    return [(f"{prefix}.weight_ih{suffix}", (4 * hid, inp)),
            (f"{prefix}.weight_hh{suffix}", (4 * hid, hid)),
            (f"{prefix}.bias_ih{suffix}", (4 * hid,)), (f"{prefix}.bias_hh{suffix}", (4 * hid,))]


def memory_dim(hp: dict) -> int:
    return hp["encoder_embedding_dim"] + hp["speaker_embedding_dim"]


def schema(hp: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every entry of the model's state dict, in order;
    ``num_batches_tracked`` is a 0-d int64 counter."""
    E, M = hp["encoder_embedding_dim"], memory_dim(hp)
    A, D, P = hp["attention_rnn_dim"], hp["decoder_rnn_dim"], hp["prenet_dim"]
    n_mel, att = hp["n_mel_channels"] * hp["n_frames_per_step"], hp["attention_dim"]
    out = [("embedding.weight", (hp["n_symbols"], hp["symbols_embedding_dim"]))]
    for i in range(hp["encoder_n_convolutions"]):
        out += _conv_bn(f"encoder.convolutions.{i}", E, E, hp["encoder_kernel_size"])
    for suffix in ("_l0", "_l0_reverse"):
        out += _lstm("encoder.lstm", E, E // 2, suffix)
    out += [("decoder.prenet.layers.0.linear_layer.weight", (P, n_mel)),
            ("decoder.prenet.layers.1.linear_layer.weight", (P, P))]
    out += _lstm("decoder.attention_rnn", P + M, A)
    out += [("decoder.attention_layer.query_layer.linear_layer.weight", (att, A)),
            ("decoder.attention_layer.memory_layer.linear_layer.weight", (att, M)),
            ("decoder.attention_layer.v.linear_layer.weight", (1, att)),
            ("decoder.attention_layer.location_layer.location_conv.conv.weight",
             (hp["attention_location_n_filters"], 2, hp["attention_location_kernel_size"])),
            ("decoder.attention_layer.location_layer.location_dense.linear_layer.weight",
             (att, hp["attention_location_n_filters"]))]
    out += _lstm("decoder.decoder_rnn", A + M, D)
    out += [("decoder.linear_projection.linear_layer.weight", (n_mel, D + M)),
            ("decoder.linear_projection.linear_layer.bias", (n_mel,)),
            ("decoder.gate_layer.linear_layer.weight", (1, D + M)),
            ("decoder.gate_layer.linear_layer.bias", (1,))]
    C, k = hp["postnet_embedding_dim"], hp["postnet_kernel_size"]
    n = hp["postnet_n_convolutions"]
    for i in range(n):
        out += _conv_bn(f"postnet.convolutions.{i}", n_mel if i == n - 1 else C,
                        hp["n_mel_channels"] if i == 0 else C, k)
    return out


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------

class Precision:
    """Operand rounding of products: ``"f32"`` (none), ``"bf16"`` or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        if self.kind == "bf16":
            return x.to(torch.bfloat16).float()
        scale = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


F32 = Precision("f32")


def rounded(sd: State, p: Precision) -> State:
    """The float weights of ``sd`` in float32 with ``p``'s operand rounding
    applied once (BatchNorm's statistics and every bias stay exact)."""
    out = {}
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        v = v.float()
        out[k] = p(v) if v.dim() >= 2 else v
    return out


# ---------------------------------------------------------------------------
# the prenet's masks
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def mask_hash(seeds: torch.Tensor, step: int, layer: int, units: int) -> torch.Tensor:
    """(B,) seeds → (B, units) 32-bit hashes of (step, unit, seed, layer): a
    murmur3-style mix in 32-bit arithmetic, like the Griffin-Lim random
    init's hash of (frame, bin, seed)."""
    k = torch.arange(units, dtype=torch.int64, device=seeds.device)[None, :]
    s = seeds.to(torch.int64)[:, None] & _U32
    t = torch.tensor(step & _U32, dtype=torch.int64, device=seeds.device)
    lay = torch.tensor(layer & _U32, dtype=torch.int64, device=seeds.device)
    h = _mul32(t, 73856093) ^ _mul32(k, 19349663) ^ _mul32(s, 83492791) ^ _mul32(lay, 0x27D4EB2F)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_threshold(p: float) -> int:
    """A unit is kept where the low 24 bits of its hash reach this."""
    return int(round(p * (1 << 24)))


def prenet_keep(seeds: torch.Tensor, step: int, layer: int, units: int, p: float) -> torch.Tensor:
    """The dropout mask of prenet layer ``layer`` at decoder step ``step``:
    (B, units) float, 1/(1−p) where kept, 0 where dropped."""
    keep = (mask_hash(seeds, step, layer, units) & 0xFFFFFF) >= keep_threshold(p)
    return keep.float() / (1.0 - p)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _batch_norm(sd: State, prefix: str, x: torch.Tensor) -> torch.Tensor:
    shape = (1, -1, 1)
    mean, var = sd[f"{prefix}.running_mean"].view(shape), sd[f"{prefix}.running_var"].view(shape)
    return (x - mean) / torch.sqrt(var + BN_EPS) * sd[f"{prefix}.weight"].view(shape) \
        + sd[f"{prefix}.bias"].view(shape)


def _conv_bn_apply(sd: State, prefix: str, x: torch.Tensor, p: Precision) -> torch.Tensor:
    w = sd[f"{prefix}.0.conv.weight"]
    y = F.conv1d(p(x), w, sd[f"{prefix}.0.conv.bias"], padding=(w.shape[-1] - 1) // 2)
    return _batch_norm(sd, f"{prefix}.1", y)


def _dense(x: torch.Tensor, w: torch.Tensor, p: Precision, b: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    y = p(x) @ w.t()
    return y if b is None else y + b


def lstm_cell(sd: State, prefix: str, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              p: Precision, suffix: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn.LSTMCell``: gates i, f, g, o."""
    g = _dense(x, sd[f"{prefix}.weight_ih{suffix}"], p, sd[f"{prefix}.bias_ih{suffix}"]) \
        + _dense(h, sd[f"{prefix}.weight_hh{suffix}"], p, sd[f"{prefix}.bias_hh{suffix}"])
    i, f, gg, o = g.chunk(4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm_direction(sd: State, x: torch.Tensor, suffix: str, p: Precision) -> torch.Tensor:
    B, N, _ = x.shape
    hid = sd[f"encoder.lstm.weight_hh{suffix}"].shape[1]
    h = x.new_zeros(B, hid)
    c = x.new_zeros(B, hid)
    out = []
    for t in range(N):
        h, c = lstm_cell(sd, "encoder.lstm", x[:, t], h, c, p, suffix)
        out.append(h)
    return torch.stack(out, dim=1)


def encoder(sd: State, ids: torch.Tensor, dvec: torch.Tensor, hp: dict, p: Precision = F32
            ) -> torch.Tensor:
    """(B, N) ids, (B, S) d-vectors → the attention's memory (B, N, E + S):
    each row's encoder outputs over its own length (zero on its padding),
    the row's d-vector concatenated at every position."""
    sd = rounded(sd, p) if p is not F32 else {k: v.float() for k, v in sd.items()
                                               if v.is_floating_point()}
    lengths = lengths_of(ids)
    B, N = ids.shape
    valid = (torch.arange(N, device=ids.device)[None, :] < lengths[:, None]).float()
    x = sd["embedding.weight"][ids].transpose(1, 2)             # (B, E, N)
    for i in range(hp["encoder_n_convolutions"]):
        x = torch.relu(_conv_bn_apply(sd, f"encoder.convolutions.{i}", x * valid[:, None], p))
    x = x.transpose(1, 2) * valid[:, :, None]                    # (B, N, E)
    fwd = _lstm_direction(sd, x, "_l0", p)
    # the backward direction over each row's own length: reverse its valid part
    pos = torch.arange(N, device=ids.device)[None, :].expand(B, N)
    rev = torch.where(pos < lengths[:, None], lengths[:, None] - 1 - pos, pos)
    flip = lambda t: torch.gather(t, 1, rev[:, :, None].expand_as(t))   # noqa: E731
    bwd = flip(_lstm_direction(sd, flip(x), "_l0_reverse", p))
    enc = torch.cat([fwd, bwd], dim=2) * valid[:, :, None]
    return torch.cat([enc, dvec.float()[:, None, :].expand(B, N, dvec.shape[-1])], dim=2)


STATE = ("h_att", "c_att", "h_dec", "c_dec", "ctx", "w", "cum")


def rollout(sd: State, memory: torch.Tensor, lengths: torch.Tensor, seeds: torch.Tensor,
            steps: int, hp: dict, p: Precision = F32, frames: Optional[torch.Tensor] = None,
            start: int = 0, state: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decoder over ``steps`` steps from the go frame (zeros):
    (mel (B, T, n_mel), gate logits (B, T), attention (B, N, T)).

    Free running, each step's prenet reads the frame the step before
    emitted; with ``frames`` (B, ≥ start + steps, n_mel) (teacher forced) it
    reads ``frames[:, t−1]`` instead, so that each step is worked out again
    from another rollout's own past. With ``start`` and ``state`` (the
    decoder's state before step ``start``: the two cells' h and c, the
    context, the attention weights and their running sum, named as in
    :data:`STATE`, each (B, ·)), the steps ``start`` … ``start + steps − 1``
    run from that state, their prenet's first input ``frames[:, start − 1]``."""
    sd = rounded(sd, p)
    B, N, M = memory.shape
    memory = memory.float()
    A, D, n_mel = hp["attention_rnn_dim"], hp["decoder_rnn_dim"], hp["n_mel_channels"]
    att = "decoder.attention_layer."
    w_loc = sd[att + "location_layer.location_conv.conv.weight"]
    w_dense = sd[att + "location_layer.location_dense.linear_layer.weight"]
    pm = _dense(memory, sd[att + "memory_layer.linear_layer.weight"], p)     # (B, N, att)
    valid = torch.arange(N, device=memory.device)[None, :] < lengths.to(memory.device)[:, None]
    mem_p = p(memory)
    if state is None:
        h_att, c_att = memory.new_zeros(B, A), memory.new_zeros(B, A)
        h_dec, c_dec = memory.new_zeros(B, D), memory.new_zeros(B, D)
        w, cum, ctx = memory.new_zeros(B, N), memory.new_zeros(B, N), memory.new_zeros(B, M)
    else:
        h_att, c_att, h_dec, c_dec, ctx, w, cum = (state[k].float() for k in STATE)
    prev = frames[:, start - 1].float() if start > 0 else memory.new_zeros(B, n_mel)
    mels, gates, atts = [], [], []
    for t in range(start, start + steps):
        x = prev
        for layer in range(2):
            x = torch.relu(_dense(x, sd[f"decoder.prenet.layers.{layer}.linear_layer.weight"], p))
            x = x * prenet_keep(seeds, t, layer, x.shape[1], PRENET_DROPOUT)
        h_att, c_att = lstm_cell(sd, "decoder.attention_rnn", torch.cat([x, ctx], 1), h_att,
                                 c_att, p)
        pq = _dense(h_att, sd[att + "query_layer.linear_layer.weight"], p)
        loc = F.conv1d(p(torch.stack([w, cum], dim=1)), w_loc,
                       padding=(w_loc.shape[-1] - 1) // 2)                  # (B, filters, N)
        pa = _dense(loc.transpose(1, 2), w_dense, p)                         # (B, N, att)
        e = _dense(torch.tanh(pq[:, None, :] + pa + pm), sd[att + "v.linear_layer.weight"], p)
        e = e[..., 0].masked_fill(~valid, float("-inf"))
        w = torch.softmax(e, dim=1)
        cum = cum + w
        ctx = torch.bmm(p(w)[:, None, :], mem_p)[:, 0]
        h_dec, c_dec = lstm_cell(sd, "decoder.decoder_rnn", torch.cat([h_att, ctx], 1), h_dec,
                                 c_dec, p)
        xp = torch.cat([h_dec, ctx], 1)
        mel = _dense(xp, sd["decoder.linear_projection.linear_layer.weight"], p,
                     sd["decoder.linear_projection.linear_layer.bias"])
        gate = _dense(xp, sd["decoder.gate_layer.linear_layer.weight"], p,
                      sd["decoder.gate_layer.linear_layer.bias"])
        mels.append(mel)
        gates.append(gate[:, 0])
        atts.append(w)
        prev = mel if frames is None else frames[:, t].float()
    return torch.stack(mels, 1), torch.stack(gates, 1), torch.stack(atts, 2)


def postnet(sd: State, mel: torch.Tensor, hp: dict, p: Precision = F32) -> torch.Tensor:
    """(B, T, n_mel) → the mel plus the postnet's residual (B, T, n_mel)."""
    sd = rounded(sd, p)
    x = mel.float().transpose(1, 2)
    n = hp["postnet_n_convolutions"]
    for i in range(n):
        x = _conv_bn_apply(sd, f"postnet.convolutions.{i}", x, p)
        if i < n - 1:
            x = torch.tanh(x)
    return mel.float() + x.transpose(1, 2)


def stop_frames(gate: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Each row's length in frames: up to and with the first step whose gate
    probability passes ``threshold`` (every step where none does)."""
    fired = torch.sigmoid(gate.float()) > threshold
    first = torch.where(fired.any(1), fired.float().argmax(1), gate.shape[1] - 1)
    return first + 1


# ---------------------------------------------------------------------------
# mel to linear magnitude (the vocoder's input)
# ---------------------------------------------------------------------------

def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_basis(hp: dict) -> np.ndarray:
    """``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` (Slaney scale
    and area norm), as NVIDIA's ``TacotronSTFT`` builds it: (n_mel, 1 + n_fft/2) float64."""
    sr, n_fft, n_mels = hp["sampling_rate"], hp["filter_length"], hp["n_mel_channels"]
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(hp["mel_fmin"]), _hz_to_mel(hp["mel_fmax"]),
                                 n_mels + 2))
    ramps = pts[:, None] - freqs[None, :]
    fdiff = np.diff(pts)
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    return weights * (2.0 / (pts[2: n_mels + 2] - pts[:n_mels]))[:, None]


def mel_to_linear(mel: torch.Tensor, hp: dict) -> torch.Tensor:
    """A natural-log mel (B, T, n_mel) → linear magnitude (B, T, 1 + n_fft/2):
    exp, the pseudo-inverse of the mel basis, clamped at 0 (power 1)."""
    inv = torch.from_numpy(np.linalg.pinv(mel_basis(hp)).T.copy()).float().to(mel.device)
    return torch.clamp(torch.exp(mel.float()) @ inv, min=0.0)
