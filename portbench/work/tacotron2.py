"""The work of each Tacotron 2 synthesis stage, counted from the shapes alone.

As in ``portbench/work``: floating-point operations (a multiply-add is two;
the LSTM cells' and the attention's pointwise functions at a few operations
an element) and the bytes a stage must move at least, each input read once
and each output written once at its stored width. A rollout's steps each
read new gate products and states, so those count a step; its weights, the
memory and the processed memory are read once a call. ``hp`` is the
configuration's ``hparams.py`` dict; ``elem`` the bytes of a stored value.
"""

from __future__ import annotations

from typing import Dict

from portbench import work

Work = work.Work
POINTWISE = 10   # operations an LSTM unit's update takes (4 gates, the cell, h)
ENERGY = 5       # operations an attention energy term takes (adds, tanh, v)


def _dims(hp: dict) -> dict:
    return {"E": hp["encoder_embedding_dim"], "S": hp["speaker_embedding_dim"],
            "M": hp["encoder_embedding_dim"] + hp["speaker_embedding_dim"],
            "A": hp["attention_rnn_dim"], "D": hp["decoder_rnn_dim"], "P": hp["prenet_dim"],
            "AT": hp["attention_dim"], "NF": hp["attention_location_n_filters"],
            "K": hp["attention_location_kernel_size"], "NM": hp["n_mel_channels"]}


def encoder(hp: dict, B: int, N: int, elem: int) -> Work:
    """The embedding, the convolutions, the BiLSTM (float32) and the
    processed memory over B texts of N ids. Bytes: the weights, the ids and
    d-vectors in, the memory and processed memory out."""
    d = _dims(hp)
    E, H = d["E"], d["E"] // 2
    conv = hp["encoder_n_convolutions"] * hp["encoder_kernel_size"] * E * E
    lstm = 2 * 4 * H * (E + H)
    pm = d["M"] * d["AT"]
    ops = 2.0 * B * N * (conv + lstm + pm) + B * N * 2 * H * POINTWISE
    weights = elem * (conv + pm) + 4 * lstm
    return ops, weights + 8.0 * B * N + 4.0 * B * d["S"] + elem * B * N * (E + d["S"] + E + d["AT"])


def step_macs(hp: dict, N: int) -> dict:
    """Multiply-adds a row a decoder step, by where they run."""
    d = _dims(hp)
    A, D, M, P, AT, NM = d["A"], d["D"], d["M"], d["P"], d["AT"], d["NM"]
    return {"gemm": 4 * A * (P + M + A) + 4 * D * (A + M + D),
            "att_step": A * AT + d["NF"] * 2 * d["K"] * N + N * d["NF"] * AT + N * AT + N * M,
            "dec_step": (NM + 1) * (D + M) + NM * P + P * P}


def att_step_kernel(hp: dict, B: int, N: int, T: int) -> Dict[str, float]:
    """``t2_att_step_kernel`` over a call's T steps: the attention cell's
    pointwise update, the query, the location features, the energies, the
    softmax and the context. Operations by the rate they could run at: the
    products whose weights every row shares (the query, the location
    convolution and its dense layer) at the tensor cores' bf16 rate
    (``"bf16"``); the products over a row's own values (the energies' ``v``
    after tanh, the context over the row's memory), tanh, the softmax and the
    cell's update at the CUDA cores' f32 rate (``"f32"``). Bytes a step: the
    gate products in, the cell state in and out, h and the context out
    (bf16), the weights and cumulative weights in and out, the attention
    out; a call: the memory, processed memory and weights in."""
    d = _dims(hp)
    A, M, AT = d["A"], d["M"], d["AT"]
    shared = A * AT + d["NF"] * 2 * d["K"] * N + N * d["NF"] * AT
    own = N * AT + N * M
    f32 = T * B * (2.0 * own + POINTWISE * A + ENERGY * N * AT + 4 * N)
    per_step = B * (4 * 4 * A + 8 * A + 2 * 2 * A + 2 * 2 * M + 4 * 5 * N)
    once = 2 * B * N * (M + AT) + 2 * A * AT + 4 * (d["NF"] * 2 * d["K"] + AT * d["NF"] + AT)
    return {"bf16": T * B * 2.0 * shared, "f32": f32, "bytes": float(T * per_step + once)}


def dec_step_kernel(hp: dict, B: int, T: int) -> Dict[str, float]:
    """``t2_dec_step_kernel`` over a call's T steps: the decoder cell's
    pointwise update, the projection and gate, the next step's prenet.
    Operations: the projection, gate and prenet products (weights every row
    shares) at the bf16 rate, the cell's update and the prenet's masks at
    the f32 rate. Bytes a step: the gate products in, the cell state in and
    out, the context in and h out (bf16), the frame and stop logit out, the
    prenet's output (bf16); a call: the weights in."""
    d = _dims(hp)
    D, M, P, NM = d["D"], d["M"], d["P"], d["NM"]
    macs = (NM + 1) * (D + M) + NM * P + P * P
    per_step = B * (4 * 4 * D + 8 * D + 2 * M + 2 * D + 4 * (NM + 1) + 2 * P)
    return {"bf16": T * B * 2.0 * macs, "f32": T * B * (POINTWISE * D + 2.0 * P),
            "bytes": float(T * per_step + 2 * macs + 4 * (NM + 1 + 4 * D))}


def kernel_bound_s(counted: Dict[str, float], table: Dict[str, float]) -> float:
    """The least time a step kernel's counted work could take on a card: the
    larger of its operations, each part at its rate, and its bytes over the
    memory bandwidth."""
    ops_s = counted["bf16"] / table["bf16"] + counted["f32"] / table["f32"]
    return max(ops_s, counted["bytes"] / table["bytes_per_s"])


def rollout(hp: dict, B: int, N: int, T: int, elem: int) -> Work:
    """The whole rollout: the gate products (``elem`` operands) and both
    kernels. Bytes: the step's weights, the memory and processed memory, the
    mel, stop logits and attention out (float32), once a call."""
    d = _dims(hp)
    macs = step_macs(hp, N)
    kernels = sum(k["bf16"] + k["f32"]
                  for k in (att_step_kernel(hp, B, N, T), dec_step_kernel(hp, B, T)))
    ops = 2.0 * B * T * macs["gemm"] + kernels
    weights = elem * (macs["gemm"] + macs["dec_step"] + d["A"] * d["AT"]) \
        + 4 * (d["NF"] * 2 * d["K"] + d["AT"] * d["NF"] + d["AT"])
    return ops, float(weights + elem * B * N * (d["M"] + d["AT"])
                      + 4 * B * T * (d["NM"] + 1 + N))


def postnet(hp: dict, B: int, T: int, elem: int) -> Work:
    """The postnet's convolutions over B mels of T frames and the residual
    add. Bytes: the weights, the mel in and the result out (float32)."""
    NM, C, k, n = (hp["n_mel_channels"], hp["postnet_embedding_dim"], hp["postnet_kernel_size"],
                   hp["postnet_n_convolutions"])
    macs = k * (NM * C + (n - 2) * C * C + C * NM)
    return 2.0 * B * T * macs + B * T * NM, float(elem * macs + 8 * B * T * NM)


def vocoder(hp: dict, B: int, T: int, iters: int) -> Work:
    """The mel's pseudo-inverse (exp, a product of n_mel by 1 + n_fft/2 a
    frame, the clamp) and Griffin-Lim counted as ``work.griffin_lim``. Bytes:
    the mel in (float32), the audio out."""
    n_fft, NM = hp["filter_length"], hp["n_mel_channels"]
    bins = n_fft // 2 + 1
    gl_ops, gl_bytes = work.griffin_lim(n_fft, B, T, iters, 4)
    ops = gl_ops + B * T * (2.0 * NM * bins + NM + bins)
    return ops, gl_bytes - 4.0 * B * T * bins + 4.0 * B * T * NM
