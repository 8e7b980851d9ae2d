"""K1: the whole autoregressive Text2Mel decode in one CUDA launch.

Port of :mod:`spoofsv_tpu.ops.pallas_decode` (``_decode_kernel``). The kernel
is ``csrc/decode.cu``; :func:`decode_plain` is the same computation in plain
PyTorch on the packed weights, and :func:`spoofsv_torch.infer.decode.make_decoder`
is the module-level eager loop both are held against.

``pma`` is the in-loop f32 argmax (the decode contract of ``make_decoder``);
the TPU kernel instead re-derives it from the attention after its cast to
the kernel dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from spoofsv_torch.models.text2mel import ATT_MASK_VALUE, MelSyn
from spoofsv_torch.ops import _build

LN_EPS = 1e-5
# decode-path highway layers, in execution order: enc.hci1 (d 1/3/9/27),
# enc.hci2 (d 1/3/9/27), enc.hc1 (d3), enc.hc2 (d3), dec.hci (d 1/3/9/27),
# dec.hc1 (d1), dec.hc2 (d1)
HW_DILATIONS = (1, 3, 9, 27, 1, 3, 9, 27, 3, 3, 1, 3, 9, 27, 1, 1)
WEIGHT_NAMES = ("hw_w", "hw_b", "hw_ln", "sq_w", "sq_b", "misc_ln", "enc_w1", "enc_b1",
                "dec_w1", "dec_b1", "tail_w5", "tail_b5", "ln5_s", "ln5_b")
MATRIX_NAMES = ("hw_w", "sq_w", "enc_w1", "dec_w1", "tail_w5")   # in the compute dtype


decode_kernel = _build.LaunchCounter()   # K1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _kernel(dense) -> torch.Tensor:
    """``Conv1d(k=1)`` weight (out, in, 1) → dense kernel (in, out)."""
    return dense.weight[..., 0].t()


@torch.no_grad()
def pack_decode_weights(model: MelSyn, dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, torch.Tensor]:
    """Flatten the decode-path parameters into the kernel's stacked layout,
    as ``pallas_decode.pack_decode_weights``: weights in ``dtype``, LayerNorm
    parameters and biases in f32, the 80-bin axis padded to 128."""
    dtype = dtype or model.dtype
    enc, dec = model.audio_encoder, model.audio_decoder
    c, fb = model.hidden_dim, model.freq_bins
    fpad = _round_up(fb, 128)
    hw = (enc.hci1.blocks + enc.hci2.blocks + [enc.hc1, enc.hc2]
          + dec.hci.blocks + [dec.hc1, dec.hc2])
    f32 = torch.float32

    def ln_pair(m):
        return torch.stack([m.weight, m.bias]).float()

    def fpad_row(v):
        return F.pad(v.float(), (0, fpad - fb))[None, :]

    packed = {
        "hw_w": torch.stack([l.conv.weight.permute(2, 1, 0).reshape(3 * c, 2 * c) for l in hw]),
        "hw_b": torch.stack([l.conv.bias for l in hw]).float(),
        "hw_ln": torch.stack([torch.cat([ln_pair(l.ln1), ln_pair(l.ln2)]) for l in hw]),
        "sq_w": torch.stack([_kernel(m) for m in (enc.conv2, enc.conv3, dec.conv2,
                                                  dec.conv3, dec.conv4)]),
        "sq_b": torch.stack([m.bias for m in (enc.conv2, enc.conv3, dec.conv2,
                                              dec.conv3, dec.conv4)]).float(),
        "misc_ln": torch.stack([ln_pair(m) for m in (enc.ln1, enc.ln2, enc.ln3, dec.ln1,
                                                     dec.ln2, dec.ln3, dec.ln4)]),
        "enc_w1": F.pad(_kernel(enc.conv1), (0, 0, 0, fpad - fb)),
        "enc_b1": enc.conv1.bias.float()[None, :],
        "dec_w1": _kernel(dec.conv1),
        "dec_b1": dec.conv1.bias.float()[None, :],
        "tail_w5": F.pad(_kernel(dec.conv5), (0, fpad - fb)),
        "tail_b5": fpad_row(dec.conv5.bias),
        "ln5_s": fpad_row(dec.ln5.weight),
        "ln5_b": fpad_row(dec.ln5.bias),
    }
    return {k: v.detach().to(dtype if k in MATRIX_NAMES else f32).contiguous()
            for k, v in packed.items()}


def _layer_norm(x32: torch.Tensor, scale, bias) -> torch.Tensor:
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x32 - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


@torch.no_grad()
def decode_plain(packed: Dict[str, torch.Tensor], K: torch.Tensor, V: torch.Tensor,
                 s1: Optional[torch.Tensor], s2: Optional[torch.Tensor], *,
                 n_frames: int, freq_bins: int, condition: bool = True,
                 monotonic: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's computation in plain PyTorch on the packed weights: ring
    caches at slot ``t mod 2d``, f32 activations, LayerNorm and softmax,
    matmul operands rounded to K's dtype and accumulated in f32 (as the
    kernel and ``pallas_decode``'s ``preferred_element_type=f32`` dots)."""
    B, N, C = K.shape
    dt = K.dtype
    p = {k: v.float() for k, v in packed.items()}
    rings = [K.new_zeros(B, 2 * d, C) for d in HW_DILATIONS]
    pos = torch.arange(N, device=K.device)[None, :]
    K32, V32 = K.float(), V.float()
    scale = 1.0 / math.sqrt(C)

    def rnd(x):
        return x.to(dt).float()

    def dense(x, w, b):
        return rnd(x) @ w + b

    def hw(li, t, x):
        d = HW_DILATIONS[li]
        i0, i1 = t % (2 * d), (t + d) % (2 * d)
        ring = rings[li]
        taps = torch.cat([ring[:, i0], ring[:, i1], x.to(dt)], dim=-1).float()
        h = taps @ p["hw_w"][li] + p["hw_b"][li]
        ln = p["hw_ln"][li]
        g = torch.sigmoid(_layer_norm(h[:, :C], ln[0], ln[1]))
        out = g * _layer_norm(h[:, C:], ln[2], ln[3]) + (1.0 - g) * x
        ring[:, i0] = x.to(dt)
        return out

    fpad = p["tail_w5"].shape[1]
    y = K.new_zeros(B, fpad)
    pma = torch.zeros(B, dtype=torch.long, device=K.device)
    ml = p["misc_ln"]
    ys, atts = [], []
    for t in range(n_frames):
        x = dense(y, p["enc_w1"], p["enc_b1"])
        if condition:
            x = x + s1.float()
        x = torch.relu(_layer_norm(x, ml[0, 0], ml[0, 1]))
        x = torch.relu(_layer_norm(dense(x, p["sq_w"][0], p["sq_b"][0]), ml[1, 0], ml[1, 1]))
        x = dense(x, p["sq_w"][1], p["sq_b"][1])
        if condition:
            x = x + s2.float()
        x = _layer_norm(x, ml[2, 0], ml[2, 1])
        for li in range(10):
            x = hw(li, t, x)
        q = x
        scores = torch.einsum("bnc,bc->bn", K32, q) * scale
        if monotonic:
            scores = scores.masked_fill((pos < pma[:, None]) | (pos > pma[:, None] + 2),
                                        ATT_MASK_VALUE)
        a = torch.softmax(scores, dim=-1)
        pma = torch.argmax(a, dim=-1)
        r = torch.einsum("bn,bnc->bc", a, V32)
        x = rnd(r) @ p["dec_w1"][:C] + rnd(q) @ p["dec_w1"][C:] + p["dec_b1"]
        x = _layer_norm(x, ml[3, 0], ml[3, 1])
        for li in range(10, len(HW_DILATIONS)):
            x = hw(li, t, x)
        for i in range(2, 5):
            x = torch.relu(_layer_norm(dense(x, p["sq_w"][i], p["sq_b"][i]),
                                       ml[i + 2, 0], ml[i + 2, 1]))
        x = dense(x, p["tail_w5"], p["tail_b5"])[:, :freq_bins]
        yt = torch.sigmoid(_layer_norm(x, p["ln5_s"][0, :freq_bins],
                                       p["ln5_b"][0, :freq_bins])).to(dt)
        y = F.pad(yt, (0, fpad - freq_bins))
        ys.append(yt)
        atts.append(a.to(dt))
    return torch.stack(ys, dim=1), torch.stack(atts, dim=2), pma


def rows_per_block(batch: int, device: torch.device) -> int:
    """Most rows per block (4, 2, 1) that still gives every SM a block.

    Every block streams all decode weights each frame whatever its row count,
    so fewer rows buy more busy SMs at the price of more L2 traffic: on the
    H100 (132 SMs) 1 row is fastest at B=64 and 4 rows at B=768 (PERF.md)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for rows in (4, 2):
        if -(-batch // rows) >= sms:
            return rows
    return 1


def decode_fused(packed: Dict[str, torch.Tensor], K: torch.Tensor, V: torch.Tensor,
                 s1: Optional[torch.Tensor], s2: Optional[torch.Tensor], *,
                 n_frames: int, freq_bins: int, condition: bool = True,
                 monotonic: bool = True, rows: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the rollout. ``K``/``V``: (B, N, C) in f32 or bf16; ``s1``/``s2``:
    (B, C) speaker projections (None when unconditioned). Returns
    (Y (B, T, freq_bins), A (B, N, T), pma (B,)) in K's dtype.

    CPU tensors run :func:`decode_plain`; CUDA tensors launch the kernel with
    ``rows`` batch rows per block (1, 2 or 4; default :func:`rows_per_block`).
    The row count changes speed only: each row's arithmetic is the same."""
    if K.device.type == "cpu":
        return decode_plain(packed, K, V, s1, s2, n_frames=n_frames, freq_bins=freq_bins,
                            condition=condition, monotonic=monotonic)
    if not monotonic:
        raise ValueError("the decode kernel implements monotonic attention only")
    B, N, C = K.shape
    dt = K.dtype
    if dt not in _build.DTYPE_CODES:
        raise ValueError(f"decode kernel takes float32 or bfloat16, got {dt}")
    if C % 32:
        raise ValueError(f"decode kernel needs hidden % 32 == 0, got {C}")
    lib = _build.load("decode")
    rows = rows or rows_per_block(B, K.device)
    Bp = _round_up(B, rows)
    dev = K.device

    def rowpad(x):
        return F.pad(x.to(dt), (0, 0) * (x.dim() - 1) + (0, Bp - B)).contiguous()

    if s1 is None:
        s1 = s2 = K.new_zeros(B, C)
    ins = [rowpad(K), rowpad(V), rowpad(s1), rowpad(s2)]
    weights = [packed[k].to(dev).contiguous() for k in WEIGHT_NAMES]
    for k, w in zip(WEIGHT_NAMES, weights):
        if w.dtype != (dt if k in MATRIX_NAMES else torch.float32):
            raise ValueError(f"packed weight {k} has dtype {w.dtype}, kernel runs in {dt}")
    rings = torch.zeros(lib.spoofsv_decode_ring_slots(), Bp, C, device=dev, dtype=dt)
    y = torch.empty(Bp, n_frames, freq_bins, device=dev, dtype=dt)
    a = torch.empty(Bp, N, n_frames, device=dev, dtype=dt)
    pma = torch.empty(Bp, device=dev, dtype=torch.int32)
    tensors = ins + weights + [rings, y, a, pma]
    _build.require_cuda(*tensors)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    err = lib.spoofsv_decode_launch(_build.DTYPE_CODES[dt], ptrs, rows, Bp, n_frames, N, freq_bins,
                                    packed["tail_w5"].shape[1], C, int(condition),
                                    _build.stream_ptr(dev))
    _build.check(lib, "decode", err, "decode_kernel")
    decode_kernel.launches += 1
    return y[:B], a[:B], pma[:B].long()


def make_fused_decoder(model: MelSyn, n_frames: int, monotonic: bool = True):
    """Same contract as :func:`spoofsv_torch.infer.decode.make_decoder`,
    backed by :func:`decode_fused`. Weights are packed on the first call."""
    packed: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def decode(text_ids: torch.Tensor, spk_emb: Optional[torch.Tensor],
               text_mask: Optional[torch.Tensor] = None):
        if text_mask is not None:
            raise ValueError("the fused decoder attends over the full text")
        if not packed:
            packed.update(pack_decode_weights(model))
        K, V = model.encode_text(text_ids)
        s1 = s2 = None
        if model.condition:
            spk = spk_emb.to(K.dtype)
            s1 = model.audio_encoder.fc1(spk)
            s2 = model.audio_encoder.fc2(spk)
        return decode_fused(packed, K, V, s1, s2, n_frames=n_frames,
                            freq_bins=model.freq_bins, condition=model.condition,
                            monotonic=monotonic)

    return decode
