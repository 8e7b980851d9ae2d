"""Plain-torch reference of the multi-speaker DCTTS (Text2Mel and SSRN).

A frozen copy of the model's equations, written as functions over a state
dict in the reference checkpoint's schema (the names and shapes of the
published ``models/TTSModel.py``'s ``melSyn`` and ``SSRN``), in float32.
It imports nothing of the program. Layout is time-major ``(B, T, C)``.

``Precision`` rounds the operands of every product (weights and the
activations entering a convolution or a dense layer) to a lower precision:
the identity for the reference itself, float8 (e4m3, per-tensor scale) for
the control of a bfloat16 configuration, TF32 (10 explicit mantissa bits,
products accumulated in float32) for the control of a float32 one.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
ATT_MASK = -2.0 ** 32          # the published model's mask value
DILATIONS = (1, 3, 9, 27)

State = Dict[str, torch.Tensor]


class Precision:
    """Operand rounding of products: ``"f32"`` (none), ``"tf32"`` or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded; its gradient passes through unchanged, so that a
        training step's backward products read the rounded operands."""
        if self.kind == "f32":
            return x
        with torch.no_grad():
            if self.kind == "tf32":   # the 13 dropped mantissa bits rounded half away from 0
                bits = x.detach().contiguous().view(torch.int32)
                r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
            else:
                scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
                r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (r - x).detach() if x.requires_grad else r


F32 = Precision("f32")


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def _conv(out: int, inp: int, k: int) -> List[Tuple[str, Tuple[int, ...]]]:
    return [("weight", (out, inp, k)), ("bias", (out,))]


def _ln(dim: int) -> List[Tuple[str, Tuple[int, ...]]]:
    return [("weight", (dim,)), ("bias", (dim,))]


def _block(prefix: str, dim: int, k: int) -> List[Tuple[str, Tuple[int, ...]]]:
    out = [(f"{prefix}.conv.{n}", s) for n, s in _conv(2 * dim, dim, k)]
    for ln in ("ln1", "ln2"):
        out += [(f"{prefix}.{ln}.{n}", s) for n, s in _ln(dim)]
    return out


def _dense_ln(out: list, prefix: str, i: int, inp: int, width: int) -> None:
    out += [(f"{prefix}conv{i}.{n}", s) for n, s in _conv(width, inp, 1)]
    out += [(f"{prefix}ln{i}.{n}", s) for n, s in _ln(width)]


def melsyn_schema(dims: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every Text2Mel parameter, in the checkpoint's order."""
    h, e, f = dims["hidden_dim"], dims["text_emb_dim"], dims["freq_bins"]
    vocab, spk, d2 = dims["vocab_len"], dims["spk_emb_dim"], 2 * dims["hidden_dim"]
    out: list = [("text_encoder.textemb_layer.W.weight", (e, vocab)),
                 ("text_encoder.textemb_layer.W.bias", (e,))]
    _dense_ln(out, "text_encoder.", 1, e, d2)
    _dense_ln(out, "text_encoder.", 2, d2, d2)
    for stack in ("hci1", "hci2"):
        for j in range(4):
            out += _block(f"text_encoder.{stack}.hc{j + 1}", d2, 3)
    for j, k in ((1, 3), (2, 3), (3, 1), (4, 1)):
        out += _block(f"text_encoder.hc{j}", d2, k)
    out += [("audio_encoder.fc1.weight", (h, spk)), ("audio_encoder.fc1.bias", (h,)),
            ("audio_encoder.fc2.weight", (h, spk)), ("audio_encoder.fc2.bias", (h,))]
    _dense_ln(out, "audio_encoder.", 1, f, h)
    _dense_ln(out, "audio_encoder.", 2, h, h)
    _dense_ln(out, "audio_encoder.", 3, h, h)
    for stack in ("hci1", "hci2"):
        for j in range(4):
            out += _block(f"audio_encoder.{stack}.hc{j + 1}", h, 3)
    out += _block("audio_encoder.hc1", h, 3) + _block("audio_encoder.hc2", h, 3)
    _dense_ln(out, "audio_decoder.", 1, 2 * h, h)
    for j in range(4):
        out += _block(f"audio_decoder.hci.hc{j + 1}", h, 3)
    out += _block("audio_decoder.hc1", h, 3) + _block("audio_decoder.hc2", h, 3)
    for i in (2, 3, 4):
        _dense_ln(out, "audio_decoder.", i, h, h)
    _dense_ln(out, "audio_decoder.", 5, h, f)
    return out


def ssrn_schema(dims: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every SSRN parameter, in the checkpoint's order."""
    d, f, lin = dims["ssrn_dim"], dims["freq_bins"], dims["lin_bins"]
    out: list = []
    widths = [(f, d), (d, 2 * d), (2 * d, lin), (lin, lin), (lin, lin), (lin, lin)]
    for i, (a, b) in enumerate(widths, start=1):
        _dense_ln(out, "", i, a, b)
    out += _block("hc1", d, 3) + _block("hc2", d, 3)
    for up in ("ups1", "ups2"):
        out += [(f"{up}.deconv.weight", (d, d, 2)), (f"{up}.deconv.bias", (d,))]
        out += _block(f"{up}.hc1", d, 3) + _block(f"{up}.hc2", d, 3)
    out += _block("hc3", 2 * d, 3) + _block("hc4", 2 * d, 3)
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * w + b


def dense(sd: State, name: str, x: torch.Tensor, p: Precision) -> torch.Tensor:
    """A ``Conv1d(k=1)`` (or ``Linear``) over the last axis."""
    w = sd[f"{name}.weight"]
    w = w[..., 0] if w.dim() == 3 else w
    return F.linear(p(x), p(w), sd[f"{name}.bias"])


def dense_ln(sd: State, prefix: str, i: int, x: torch.Tensor, p: Precision) -> torch.Tensor:
    return layer_norm(dense(sd, f"{prefix}conv{i}", x, p),
                      sd[f"{prefix}ln{i}.weight"], sd[f"{prefix}ln{i}.bias"])


def highway(sd: State, name: str, x: torch.Tensor, dilation: int, causal: bool,
            p: Precision) -> torch.Tensor:
    """``y = σ(LN1(h1))·LN2(h2) + (1 − σ(LN1(h1)))·x``, ``[h1, h2]`` the
    convolution of ``x`` (zero padding: all of the span before the sequence
    when causal, half of it on each side otherwise)."""
    w = sd[f"{name}.conv.weight"]
    span = dilation * (w.shape[2] - 1)
    left = span if causal else span // 2
    h = F.conv1d(F.pad(p(x).transpose(1, 2), (left, span - left)), p(w),
                 sd[f"{name}.conv.bias"], dilation=dilation).transpose(1, 2)
    h1, h2 = h.chunk(2, dim=-1)
    g = torch.sigmoid(layer_norm(h1, sd[f"{name}.ln1.weight"], sd[f"{name}.ln1.bias"]))
    return g * layer_norm(h2, sd[f"{name}.ln2.weight"], sd[f"{name}.ln2.bias"]) + (1.0 - g) * x


def dilated_stack(sd: State, prefix: str, x: torch.Tensor, causal: bool,
                  p: Precision) -> torch.Tensor:
    for j, d in enumerate(DILATIONS):
        x = highway(sd, f"{prefix}.hc{j + 1}", x, d, causal, p)
    return x


# ---------------------------------------------------------------------------
# Text2Mel
# ---------------------------------------------------------------------------

def text_encoder(sd: State, ids: torch.Tensor, p: Precision = F32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Text ids (B, N) → K, V, each (B, N, hidden)."""
    pre = "text_encoder."
    x = sd[pre + "textemb_layer.W.weight"].t()[ids.long()] + sd[pre + "textemb_layer.W.bias"]
    x = torch.relu(dense_ln(sd, pre, 1, x, p))
    x = dense_ln(sd, pre, 2, x, p)
    x = dilated_stack(sd, pre + "hci1", x, False, p)
    x = dilated_stack(sd, pre + "hci2", x, False, p)
    for j, d in ((1, 1), (2, 1), (3, 1), (4, 1)):
        x = highway(sd, f"{pre}hc{j}", x, d, False, p)
    return x.chunk(2, dim=-1)


def audio_encoder(sd: State, mel_in: torch.Tensor, spk: torch.Tensor,
                  p: Precision = F32) -> torch.Tensor:
    """Causal, speaker-conditioned query Q (B, T, hidden) of the mel frames
    (B, T, 80) that precede each output frame."""
    pre = "audio_encoder."
    x = dense(sd, pre + "conv1", mel_in, p) + dense(sd, pre + "fc1", spk, p)[:, None]
    x = torch.relu(layer_norm(x, sd[pre + "ln1.weight"], sd[pre + "ln1.bias"]))
    x = torch.relu(dense_ln(sd, pre, 2, x, p))
    x = dense(sd, pre + "conv3", x, p) + dense(sd, pre + "fc2", spk, p)[:, None]
    x = layer_norm(x, sd[pre + "ln3.weight"], sd[pre + "ln3.bias"])
    x = dilated_stack(sd, pre + "hci1", x, True, p)
    x = dilated_stack(sd, pre + "hci2", x, True, p)
    x = highway(sd, pre + "hc1", x, 3, True, p)
    return highway(sd, pre + "hc2", x, 3, True, p)


def audio_decoder(sd: State, rq: torch.Tensor, p: Precision = F32) -> torch.Tensor:
    """[R; Q] (B, T, 2·hidden) → mel frames (B, T, 80) in (0, 1)."""
    pre = "audio_decoder."
    x = dense_ln(sd, pre, 1, rq, p)
    x = dilated_stack(sd, pre + "hci", x, True, p)
    x = highway(sd, pre + "hc1", x, 1, True, p)
    x = highway(sd, pre + "hc2", x, 1, True, p)
    for i in (2, 3, 4):
        x = torch.relu(dense_ln(sd, pre, i, x, p))
    return torch.sigmoid(dense_ln(sd, pre, 5, x, p))


def window_candidates(att: torch.Tensor) -> torch.Tensor:
    """The window starts ``pma`` a rollout may have used at each frame,
    (B, 3, T) int64, read from its attention (B, N, T): 0 at frame 0, then
    the argmax of the previous frame's attention. The rollout takes that
    argmax before the attention is rounded to its stored precision, and
    rounding keeps order but can tie: so each of the (at most three)
    positions tied at the stored maximum is a candidate (the first repeated
    where there are fewer)."""
    a = att.float()
    B, N, T = a.shape
    prev = a[:, :, :-1]
    tied = prev == prev.amax(dim=1, keepdim=True)                       # (B, N, T-1)
    pos = torch.arange(N, device=a.device)[None, :, None].expand_as(tied)
    order = torch.where(tied, pos, N + pos).sort(dim=1).values[:, :3]   # tied first, in order
    first = order[:, :1]
    cand = torch.where(order < N, order, first)
    zero = torch.zeros(B, 3, 1, dtype=torch.long, device=a.device)
    return torch.cat([zero, cand], dim=2)


def decode_teacher_forced(sd: State, ids: torch.Tensor, spk: torch.Tensor,
                          mel: torch.Tensor, att: torch.Tensor, p: Precision = F32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each frame of a rollout worked out again from the rollout's own past.

    ``mel`` (B, T, 80) and ``att`` (B, N, T) are what an autoregressive
    decode emitted. Frame t's query reads the emitted frames before t, and
    its attention is held to the window ``[pma, pma+2]`` that the rollout
    used, as the published decode holds it: of the candidate starts
    (:func:`window_candidates`, one but where the stored attention ties),
    the one whose attention is nearest the emitted one. Returns the mel
    frames and the attention (B, N, T) the model gives there.
    """
    K, V = text_encoder(sd, ids, p)
    mel = mel.float()
    mel_in = torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], dim=1)
    Q = audio_encoder(sd, mel_in, spk.float(), p)
    scores = torch.einsum("bnh,bth->bnt", p(K), p(Q)) / math.sqrt(K.shape[-1])
    pos = torch.arange(K.shape[1], device=K.device)[None, :, None]
    best = best_gap = None
    for pma in window_candidates(att).unbind(1):
        pma = pma[:, None, :]
        A = torch.softmax(scores.masked_fill((pos < pma) | (pos > pma + 2), ATT_MASK), dim=1)
        gap = (A - att.float()).abs().amax(dim=1, keepdim=True)
        if best is None:
            best, best_gap = A, gap
        else:
            take = gap < best_gap
            best, best_gap = torch.where(take, A, best), torch.minimum(gap, best_gap)
    R = torch.einsum("bnh,bnt->bth", p(V), p(best))
    return audio_decoder(sd, torch.cat([R, Q], dim=-1), p), best


def text2mel_forward(sd: State, mel_in: torch.Tensor, ids: torch.Tensor, spk: torch.Tensor,
                     p: Precision = F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced training forward: (Y (B, T, 80), A (B, N, T)) with
    attention over the whole text."""
    K, V = text_encoder(sd, ids, p)
    Q = audio_encoder(sd, mel_in, spk, p)
    scores = torch.einsum("bnh,bth->bnt", p(K), p(Q)) / math.sqrt(K.shape[-1])
    A = torch.softmax(scores, dim=1)
    R = torch.einsum("bnh,bnt->bth", p(V), p(A))
    return audio_decoder(sd, torch.cat([R, Q], dim=-1), p), A


# ---------------------------------------------------------------------------
# SSRN
# ---------------------------------------------------------------------------

def ssrn(sd: State, mel: torch.Tensor, p: Precision = F32) -> torch.Tensor:
    """Coarse mel (B, T, 80) → linear magnitude (B, 4T, 513) in (0, 1)."""
    x = dense_ln(sd, "", 1, mel.float(), p)
    x = highway(sd, "hc1", x, 1, False, p)
    x = highway(sd, "hc2", x, 3, False, p)
    for up in ("ups1", "ups2"):
        x = F.conv_transpose1d(p(x).transpose(1, 2), p(sd[f"{up}.deconv.weight"]),
                               sd[f"{up}.deconv.bias"], stride=2).transpose(1, 2)
        x = highway(sd, f"{up}.hc1", x, 1, False, p)
        x = highway(sd, f"{up}.hc2", x, 3, False, p)
    x = dense_ln(sd, "", 2, x, p)
    x = highway(sd, "hc3", x, 1, False, p)
    x = highway(sd, "hc4", x, 1, False, p)
    x = dense_ln(sd, "", 3, x, p)
    x = torch.relu(dense_ln(sd, "", 4, x, p))
    x = torch.relu(dense_ln(sd, "", 5, x, p))
    return torch.sigmoid(dense_ln(sd, "", 6, x, p))


def ssrn_blocks(sd: State, mel: torch.Tensor, rows: int, p: Precision = F32) -> torch.Tensor:
    """:func:`ssrn` ``rows`` utterances at a time (its activations at 4T
    frames and 1026 channels are the reference's largest)."""
    return torch.cat([ssrn(sd, mel[i: i + rows], p) for i in range(0, mel.shape[0], rows)])


def dims_of(conf: dict) -> dict:
    """The widths the schema needs, from a configuration file's reference
    section (the published ``config.json`` keys)."""
    c = conf["config"]
    return {"hidden_dim": c["HIDDEN_DIM"], "text_emb_dim": c["TEXT_EMB_DIM"],
            "ssrn_dim": c["SSRN_DIM"], "spk_emb_dim": c["SPK_EMB_DIM"],
            "freq_bins": c["COARSE_MELSPEC"]["FREQ_BINS"],
            "lin_bins": 1 + c["STFT"]["FFT_LENGTH"] // 2,
            # '"' shares the id of "'": the model has one class fewer
            "vocab_len": len(c["VOCABULARY"]) - 1}
