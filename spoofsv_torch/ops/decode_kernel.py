"""K1: the whole autoregressive Text2Mel decode in one CUDA launch.

Port of :mod:`spoofsv_tpu.ops.pallas_decode` (``_decode_kernel``). Both
dtypes run ``csrc/decode_cluster.cu`` (a cluster of CTAs per tile of batch
rows, each CTA a column slice of every layer, tensor-core products, a
bulk-copy weight stream): bf16 products on bf16 operands, f32 ones as
3xTF32. :func:`decode_plain` is the same
computation in plain PyTorch on the packed weights,
:func:`decode_cluster_emulate` the cluster kernel's decomposition of it, and
:func:`spoofsv_torch.infer.decode.make_decoder` the module-level eager loop
they are all held against.

``pma`` is the in-loop f32 argmax (the decode contract of ``make_decoder``);
the TPU kernel instead re-derives it from the attention after its cast to
the kernel dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from spoofsv_torch.models.text2mel import ATT_MASK_VALUE, MelSyn
from spoofsv_torch.ops import _build
from spoofsv_torch.ops.hconv_kernel import tf32_split
from spoofsv_torch.utils.profiling import count, span

LN_EPS = 1e-5
# decode-path highway layers, in execution order: enc.hci1 (d 1/3/9/27),
# enc.hci2 (d 1/3/9/27), enc.hc1 (d3), enc.hc2 (d3), dec.hci (d 1/3/9/27),
# dec.hc1 (d1), dec.hc2 (d1)
HW_DILATIONS = (1, 3, 9, 27, 1, 3, 9, 27, 3, 3, 1, 3, 9, 27, 1, 1)
WEIGHT_NAMES = ("hw_w", "hw_b", "hw_ln", "sq_w", "sq_b", "misc_ln", "enc_w1", "enc_b1",
                "dec_w1", "dec_b1", "tail_w5", "tail_b5", "ln5_s", "ln5_b")
MATRIX_NAMES = ("hw_w", "sq_w", "enc_w1", "dec_w1", "tail_w5")   # in the compute dtype


decode_kernel = _build.LaunchCounter()   # K1, both dtypes
cluster_kernel = _build.LaunchCounter()  # K1's bf16 instance alone
f32_kernel = _build.LaunchCounter()      # K1's f32 (3xTF32) instance alone


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


# ---------------------------------------------------------------------------
# K1: the cluster design (csrc/decode_cluster.cu), bf16 and f32. Host pieces:
# the plan, the per-CTA weight stream in mma.sync fragment order, and the
# cluster's decomposition emulated in plain torch (the CPU tests' yardstick).
# ---------------------------------------------------------------------------

CLUSTER_THREADS = 256          # 8 warps a CTA
CLUSTER_CHUNK = 16384          # bytes of weight stream per ring stage
CLUSTER_STAGES = 8            # ring stages (8, else 4 or 2 where memory is short)
SMEM_LIMIT = 232448            # dynamic shared memory one block may use (H100)
# Clusters of each size that one H100 SXM runs at once when every CTA needs
# an SM of its own, as every plan at C = 256 does in either dtype (more than
# half an SM's shared memory): cudaOccupancyMaxActiveClusters on the card for
# 16-2 (python3 -m spoofsv_torch.ops.k1_probe), the 132 SMs for 1. A plan
# whose tiles exceed this runs in more than one wave.
H100_CLUSTERS_PER_WAVE = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}
RING_SLOTS = 256               # Σ 2d over HW_DILATIONS: the ring caches' slots
# the frame's products in execution order: (matrix, index, kind); kind "c" has
# C output columns, "hw" the highway's [h1 | h2] 2C, "f" the fpad-wide tail
CLUSTER_LAYERS = tuple(
    [("enc_w1", None, "c"), ("sq_w", 0, "c"), ("sq_w", 1, "c")]
    + [("hw_w", i, "hw") for i in range(10)]
    + [("dec_w1", None, "c")]
    + [("hw_w", i, "hw") for i in range(10, 16)]
    + [("sq_w", i, "c") for i in (2, 3, 4)]
    + [("tail_w5", None, "f")])
_LAYER_K = {"enc_w1": lambda C, fp: fp, "sq_w": lambda C, fp: C, "hw_w": lambda C, fp: 3 * C,
            "dec_w1": lambda C, fp: 2 * C, "tail_w5": lambda C, fp: C}


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """How ``decode_cluster.cu`` runs a batch: ``tiles`` clusters of
    ``cluster`` CTAs, each cluster ``rows`` batch rows, each CTA ``ch`` =
    C/cluster channels of every C-wide activation (``ft`` columns of the
    tail). The weight stream is read in ``chunk_bytes`` pieces (whole 32-deep
    k rows of a layer) through a ring of ``stages``. ``elem``: bytes of an
    operand, 2 (bf16) or 4 (f32, 3xTF32 products)."""
    batch: int
    C: int
    freq_bins: int
    fpad: int
    cluster: int
    rows: int
    tiles: int
    chunk_bytes: int = CLUSTER_CHUNK
    stages: int = CLUSTER_STAGES
    elem: int = 2

    @property
    def ch(self) -> int:
        return self.C // self.cluster

    @property
    def ft(self) -> int:
        return self.fpad // self.cluster

    @property
    def bp(self) -> int:
        return self.tiles * self.rows

    @property
    def waves(self) -> int:
        """Waves of clusters the grid takes on an H100."""
        return -(-self.tiles // H100_CLUSTERS_PER_WAVE[self.cluster])

    @property
    def layers(self) -> Tuple[Tuple[int, int], ...]:
        """(reduction depth K, n8 column blocks per CTA) of each product."""
        ncol = {"c": self.ch // 8, "hw": 2 * self.ch // 8, "f": self.ft // 8}
        return tuple((_LAYER_K[m](self.C, self.fpad), ncol[kind]) for m, _, kind in CLUSTER_LAYERS)

    def warp_split(self, K: int, ncol: int) -> Tuple[int, int]:
        """(k splits, n8 blocks per warp) of a product of depth ``K`` with
        ``ncol`` blocks: 8/MT warps share each 16-row m tile. bf16: first
        over columns, then over k. f32: first over k, up to the k rows a
        chunk holds and K/32 (a power of two), so that fewer warps split the
        same A fragment into TF32."""
        wpm = CLUSTER_THREADS // 32 // (self.rows // 16)
        S = wpm // ncol if ncol < wpm else 1
        if self.elem == 4:
            most = min(wpm, max(1, self.chunk_bytes // (ncol * self.block_bytes)))
            while most > K // 32:
                most //= 2
            S = max(S, most)
        return S, ncol * S // wpm

    @property
    def block_bytes(self) -> int:
        """Bytes of one 32-deep k row of one n8 column block of the stream."""
        return 256 * self.elem

    @property
    def cta_elems(self) -> int:
        return sum(K * ncol * 8 for K, ncol in self.layers)

    @property
    def chunks_per_frame(self) -> int:
        return sum(-(-(K // 32) // max(1, self.chunk_bytes // (ncol * self.block_bytes)))
                   for K, ncol in self.layers)

    def row_stride(self, w: int) -> int:
        """Elements between operand rows of width ``w`` in shared memory:
        bf16 padded by 16 bytes (ldmatrix), f32 at 16 mod 32 words (the
        16-byte A loads of neighbouring rows in the two halves of the banks)."""
        return w + 8 if self.elem == 2 else w + ((16 - w) & 31)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA (``spoofsv_decode_cluster_smem``)."""
        n, rows = self.cluster, self.rows
        # operand rows: taps (2C), then the gathered x or y slices (one buffer)
        ldt = self.row_stride(2 * self.C)
        ss = max(self.row_stride(self.ch), self.row_stride(self.ft))
        hbuf = max(self.warp_split(K, ncol)[0] * rows * ncol * 8 for K, ncol in self.layers)
        prm = sum(3 * ncol * 8 for _, ncol in self.layers)   # biases and LayerNorm vectors
        return (128 + self.stages * self.chunk_bytes + rows * (ldt + n * ss) * self.elem
                + rows * self.ch * 4 + hbuf * 4 + prm * 4 + 2 * n * rows * 16 + rows * 16
                + rows * 8 + 2 * 16 * 4 + (2 * self.stages + 2) * 8)

    @property
    def l2_bytes_per_frame(self) -> int:
        """Bytes every CTA reads from L2 in a frame, summed over the grid: its
        weight stream and the 16 highways' two full-width ring taps."""
        taps = 16 * self.rows * 2 * self.C * self.elem
        return self.tiles * self.cluster * (self.elem * self.cta_elems + taps)

    def refusal(self) -> Optional[str]:
        """Why the kernel cannot take this plan, or None."""
        n, C = self.cluster, self.C
        if self.elem not in (2, 4):
            return f"operands of {self.elem} bytes (2: bf16, 4: f32)"
        if not _pow2(n) or n > 16:
            return f"cluster {n} is not a power of two ≤ 16"
        if self.rows not in (16, 32, 64):
            return f"rows per tile {self.rows} not in (16, 32, 64)"
        if C % n or not _pow2(self.ch // 8) or self.ch % 8:
            return f"C/cluster = {C}/{n} is not 8·2^k channels"
        if self.fpad % n or self.ft % 8 or not _pow2(self.ft // 8):
            return f"fpad/cluster = {self.fpad}/{n} is not 8·2^k columns"
        if any(self.warp_split(K, ncol)[1] > 4 for K, ncol in self.layers):
            return "more than 4 n8 column blocks per warp"
        if self.stages < 2 or not _pow2(self.stages):
            return f"{self.stages} ring stages (a power of two ≥ 2)"
        if self.chunk_bytes != CLUSTER_CHUNK:
            return f"the kernel's chunk is {CLUSTER_CHUNK} bytes, not {self.chunk_bytes}"
        if self.chunk_bytes < max(ncol * self.block_bytes for _, ncol in self.layers):
            return f"chunk of {self.chunk_bytes} bytes holds no whole k row"
        if self.smem_bytes > SMEM_LIMIT:
            return f"{self.smem_bytes} bytes of shared memory > {SMEM_LIMIT}"
        if self.bp < self.batch:
            return "tiles do not cover the batch"
        return None


@functools.lru_cache(maxsize=None)   # a plain function of its arguments, asked every call
def decode_cluster_plan(batch: int, C: int, freq_bins: int = 80, *,
                        cluster: Optional[int] = None, rows: Optional[int] = None,
                        elem: int = 2) -> ClusterPlan:
    """The cluster kernel's plan for ``batch`` rows of width ``C`` with
    operands of ``elem`` bytes (2: bf16, 4: f32).

    Default: the fewest rows per tile (16, 32, 64), then the largest cluster
    (16, 8, ...), whose tiles run in one wave on an H100; failing that, the
    fewest waves, then the same order. At C=256 in bf16 that is 16×16 up to
    B=112, 8×16 to 240, 4×16 to 480, 2×16 to 1056: on the card each was the
    fastest plan of at most two waves at B = 64, 128, 256, 512, and 2×16
    within 1.1 % of the fastest at 768 (``k1_probe``; ``PERF.md`` §6). In
    f32 a k row of the weight stream is twice the bytes, so clusters of 2
    at C=256 hold no whole highway k row in a chunk and are refused; the
    rule's 16×16 was the fastest f32 plan at B=16 and B=64 (``k1_probe
    --dtype f32``).
    Each plan gets the deepest ring of weight chunks that fits. ``cluster``
    / ``rows`` force a choice. Raises ``ValueError`` when the kernel cannot
    take the shapes."""
    if batch < 1:
        raise ValueError(f"batch must be ≥ 1, got {batch}")
    if C % 32 or C < 32:
        raise ValueError(f"the cluster decode needs hidden % 32 == 0, got {C}")
    if freq_bins % 2 or freq_bins < 2:
        raise ValueError(f"the cluster decode needs an even number of mel bins, got {freq_bins}")
    fpad = _round_up(freq_bins, 128)

    def make(n: int, r: int) -> ClusterPlan:
        """The deepest ring of 8, 4 or 2 stages that fits shared memory."""
        plans = [ClusterPlan(batch, C, freq_bins, fpad, n, r, -(-batch // r), stages=s,
                             elem=elem) for s in (8, 4, 2)]
        return next((p for p in plans if p.refusal() is None), plans[-1])

    cands = [make(n, r) for r in ([rows] if rows else [16, 32, 64])
             for n in ([cluster] if cluster else [16, 8, 4, 2, 1])]
    valid = [p for p in cands if p.refusal() is None]
    if not valid:
        raise ValueError(f"no cluster plan for B={batch} C={C}: {cands[0].refusal()}")
    return min(valid, key=lambda p: p.waves)   # the first of the fewest waves


def _layer_columns(kind: str, rank: int, plan: ClusterPlan) -> torch.Tensor:
    """The output columns that CTA ``rank`` computes in a product of ``kind``."""
    ch, ft = plan.ch, plan.ft
    own = torch.arange(rank * ch, (rank + 1) * ch)
    if kind == "hw":
        return torch.cat([own, plan.C + own])
    return torch.arange(rank * ft, (rank + 1) * ft) if kind == "f" else own


def _matrix(packed, name, idx):
    return packed[name] if idx is None else packed[name][idx]


def pack_decode_stream(packed: Dict[str, torch.Tensor], plan: ClusterPlan) -> torch.Tensor:
    """``packed`` (:func:`pack_decode_weights`) → the per-CTA weight stream
    (cluster, cta_elems) in the matrices' dtype: for each CTA, every product
    of a frame in execution order, each its column slice in mma.sync's B
    fragment order. Within a layer, block (kp, j) (32 k rows × 8 columns)
    follows row-major over (k/32, column block).

    bf16 (m16n8k16, 512-byte blocks): lane l = 4g + t holds columns 8j + g,
    k rows 2t, 2t+1, 2t+8, 2t+9 of the first 16 and the same of the next 16:
    one 16-byte load feeds two products. f32 (m16n8k8 on TF32, 1024-byte
    blocks): the block's first 512 bytes hold k rows 0-15, its second 16-31,
    and in each lane l = 4g + t holds column 8j + g at the four k rows 4t to
    4t + 3: b0, b1 of one k8 step, then of the next (the kernel permutes A's
    k order alike), so two conflict-free 16-byte loads feed four steps."""
    n = plan.cluster
    out = []
    for (name, idx, kind), (K, ncol) in zip(CLUSTER_LAYERS, plan.layers):
        w = _matrix(packed, name, idx)
        cols = torch.stack([_layer_columns(kind, r, plan) for r in range(n)]).to(w.device)
        wr = w[:, cols].permute(1, 0, 2)                 # (n, K, ncol·8)
        if plan.elem == 4:
            # k = 32kp + 16q + 4t + e, column = 8j + g
            wr = wr.reshape(n, K // 32, 2, 4, 4, ncol, 8)   # n kp q t e j g
            out.append(wr.permute(0, 1, 5, 2, 6, 3, 4).reshape(n, -1))
        else:
            # k = 32kp + 16ks + 8kh + 2t + e, column = 8j + g
            wr = wr.reshape(n, K // 32, 2, 2, 4, 2, ncol, 8)   # n kp ks kh t e j g
            out.append(wr.permute(0, 1, 6, 7, 4, 2, 3, 5).reshape(n, -1))
    return torch.cat(out, dim=1).contiguous()


def _layer_slices(stream: torch.Tensor, plan: ClusterPlan) -> List[torch.Tensor]:
    """The stream → per layer the CTAs' column slices (cluster, K, ncol·8)."""
    n, off, out = plan.cluster, 0, []
    for K, ncol in plan.layers:
        size = K * ncol * 8
        if plan.elem == 4:
            blk = stream[:, off:off + size].reshape(n, K // 32, ncol, 2, 8, 4, 4)  # n kp j q g t e
            blk = blk.permute(0, 1, 3, 5, 6, 2, 4)
        else:
            blk = stream[:, off:off + size].reshape(n, K // 32, ncol, 8, 4, 2, 2, 2)  # n kp j g t ks kh e
            blk = blk.permute(0, 1, 5, 6, 4, 7, 2, 3)
        out.append(blk.reshape(n, K, ncol * 8))
        off += size
    return out


def unpack_decode_stream(stream: torch.Tensor, plan: ClusterPlan) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_decode_stream`: the five weight matrices."""
    C, fp = plan.C, plan.fpad
    mats = {"hw_w": stream.new_zeros(16, 3 * C, 2 * C), "sq_w": stream.new_zeros(5, C, C),
            "enc_w1": stream.new_zeros(fp, C), "dec_w1": stream.new_zeros(2 * C, C),
            "tail_w5": stream.new_zeros(C, fp)}
    for (name, idx, kind), sl in zip(CLUSTER_LAYERS, _layer_slices(stream, plan)):
        w = _matrix(mats, name, idx)
        for r in range(plan.cluster):
            w[:, _layer_columns(kind, r, plan).to(w.device)] = sl[r]
    return mats


@torch.no_grad()
def decode_cluster_emulate(packed: Dict[str, torch.Tensor], K: torch.Tensor, V: torch.Tensor,
                           s1: Optional[torch.Tensor], s2: Optional[torch.Tensor],
                           plan: ClusterPlan, n_frames: int, condition: bool = True,
                           tf32x3: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cluster kernel's decomposition of :func:`decode_plain` in plain
    torch: each CTA's products from its slice of the unpacked stream, the
    LayerNorm statistics (Σh, Σh²) summed from per-CTA partials in rank
    order, the all-gather as a concatenation, the attention scores summed
    from per-CTA partial dot products, the 3-wide window's softmax. Same
    outputs as :func:`decode_plain`. ``tf32x3``: each product's operands
    split into TF32 hi and lo as the f32 kernel splits its fragments
    (``cvt.rna``), and the product taken as hi·hi + hi·lo + lo·hi."""
    B, N, C = K.shape
    dt, n, ch, F = K.dtype, plan.cluster, plan.ch, plan.freq_bins
    ws = [w.float() for w in _layer_slices(pack_decode_stream(packed, plan), plan)]
    if tf32x3:   # per layer, per CTA: (hi, lo)
        ws = [list(zip(*tf32_split(w))) for w in ws]

    def mm(op, w):
        if not tf32x3:
            return op @ w
        (ah, al), (wh, wl) = tf32_split(op), w
        return al @ wh + ah @ wl + ah @ wh
    p = {k: v.float() for k, v in packed.items()}
    ml = p["misc_ln"]
    rings = [K.new_zeros(B, 2 * d, C) for d in HW_DILATIONS]
    K32, V32 = K.float(), V.float()
    rows = torch.arange(B, device=K.device)[:, None]
    scale = 1.0 / math.sqrt(C)
    if s1 is None:
        s1 = s2 = K.new_zeros(B, C)
    s1, s2 = s1.float(), s2.float()

    def rnd(x):
        return x.to(dt).float()

    def own(v, r, w=ch):
        return v[..., r * w:(r + 1) * w]

    def rank_sum(parts):
        tot = parts[0]
        for q in parts[1:]:
            tot = tot + q
        return tot

    def norm(h, s, q, width, sc, b):
        mean = s / width
        var = (q / width - mean * mean).clamp_min(0.0)
        return (h - mean[:, None]) * torch.rsqrt(var + LN_EPS)[:, None] * sc + b

    def stats(hs, mask=None):
        m = [h if mask is None else h * mask[r] for r, h in enumerate(hs)]
        return rank_sum([h.sum(-1) for h in m]), rank_sum([(h * h).sum(-1) for h in m])

    def dense(li, op, bias, ln, relu, add=None):
        hs = [mm(op, ws[li][r]) + own(bias, r) + (0.0 if add is None else own(add, r))
              for r in range(n)]
        s, q = stats(hs)
        out = torch.cat([norm(h, s, q, C, own(ln[0], r), own(ln[1], r))
                         for r, h in enumerate(hs)], dim=-1)
        return torch.relu(out) if relu else out

    def highway(li, j, t, x):
        d = HW_DILATIONS[j]
        i0, i1 = t % (2 * d), (t + d) % (2 * d)
        op = torch.cat([rings[j][:, i0], rings[j][:, i1], x.to(dt)], dim=-1).float()
        b, ln = p["hw_b"][j], p["hw_ln"][j]
        hs = [mm(op, ws[li][r]) + torch.cat([own(b[:C], r), own(b[C:], r)]) for r in range(n)]
        s1_, q1_ = stats([h[:, :ch] for h in hs])
        s2_, q2_ = stats([h[:, ch:] for h in hs])
        out = []
        for r, h in enumerate(hs):
            g = torch.sigmoid(norm(h[:, :ch], s1_, q1_, C, own(ln[0], r), own(ln[1], r)))
            nrm = norm(h[:, ch:], s2_, q2_, C, own(ln[2], r), own(ln[3], r))
            out.append(g * nrm + (1.0 - g) * own(x, r))
        rings[j][:, i0] = x.to(dt)
        return torch.cat(out, dim=-1)

    y = K.new_zeros(B, plan.fpad).float()
    pma = torch.zeros(B, dtype=torch.long, device=K.device)
    ys, atts = [], []
    for t in range(n_frames):
        x = dense(0, rnd(y), p["enc_b1"][0], ml[0], True, s1 if condition else None)
        x = dense(1, rnd(x), p["sq_b"][0], ml[1], True)
        x = dense(2, rnd(x), p["sq_b"][1], ml[2], False, s2 if condition else None)
        for j in range(10):
            x = highway(3 + j, j, t, x)
        # monotonic attention over the window [pma, pma + 2]
        pos = pma[:, None] + torch.arange(3, device=K.device)
        valid = pos < N
        posc = pos.clamp(max=N - 1)
        kw = K32[rows, posc]                                     # (B, 3, C)
        sc = rank_sum([(own(kw, r) * own(x, r)[:, None]).sum(-1) for r in range(n)]) * scale
        pw = torch.softmax(sc.masked_fill(~valid, float("-inf")), dim=-1)
        a = torch.zeros(B, N, device=K.device).scatter_add_(1, posc, pw)
        r_vec = (pw[..., None] * V32[rows, posc]).sum(1)
        pma = pma + torch.argmax(pw, dim=-1)
        x = dense(13, torch.cat([rnd(r_vec), rnd(x)], dim=-1), p["dec_b1"][0], ml[3], False)
        for j in range(10, 16):
            x = highway(4 + j, j, t, x)
        for i in range(2, 5):
            x = dense(18 + i, rnd(x), p["sq_b"][i], ml[i + 2], True)
        ft = plan.ft
        hs = [mm(rnd(x), ws[23][r]) + own(p["tail_b5"][0], r, ft) for r in range(n)]
        mask = [(torch.arange(r * ft, (r + 1) * ft, device=K.device) < F).float()
                for r in range(n)]
        s, q = stats(hs, mask)
        y = torch.cat([torch.sigmoid(norm(h, s, q, F, own(p["ln5_s"][0], r, ft),
                                          own(p["ln5_b"][0], r, ft))) * mask[r]
                       for r, h in enumerate(hs)], dim=-1)
        y = rnd(y)
        ys.append(y[:, :F].to(dt))
        atts.append(a.to(dt))
    return torch.stack(ys, dim=1), torch.stack(atts, dim=2), pma


def decode_fused(packed: Dict[str, torch.Tensor], K: torch.Tensor, V: torch.Tensor,
                 s1: Optional[torch.Tensor], s2: Optional[torch.Tensor], *,
                 n_frames: int, freq_bins: int, condition: bool = True,
                 monotonic: bool = True, plan: Optional[ClusterPlan] = None,
                 stream: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the rollout. ``K``/``V``: (B, N, C) in f32 or bf16; ``s1``/``s2``:
    (B, C) speaker projections (None when unconditioned). Returns
    (Y (B, T, freq_bins), A (B, N, T), pma (B,)) in K's dtype.

    CPU tensors run :func:`decode_plain`. CUDA tensors launch
    ``csrc/decode_cluster.cu`` in K's dtype (f32 products as 3xTF32) with
    ``plan`` (default :func:`decode_cluster_plan`) and the weight ``stream``
    of :func:`pack_decode_stream` (built here when not given). The plan
    changes speed only."""
    if K.device.type == "cpu":
        return decode_plain(packed, K, V, s1, s2, n_frames=n_frames, freq_bins=freq_bins,
                            condition=condition, monotonic=monotonic)
    if not monotonic:
        raise ValueError("the decode kernel implements monotonic attention only")
    if K.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode kernel takes float32 or bfloat16, got {K.dtype}")
    lib = _build.load("decode_cluster")
    plan, tensors, (y, a, pma) = cluster_launch_args(packed, K, V, s1, s2, n_frames, freq_bins,
                                                     plan, stream)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    err = lib.spoofsv_decode_cluster_launch(_build.DTYPE_CODES[K.dtype], ptrs, plan.cluster,
                                            plan.rows, plan.tiles, n_frames, K.shape[1],
                                            freq_bins, plan.fpad, K.shape[2], int(condition),
                                            plan.chunk_bytes, plan.stages,
                                            _build.stream_ptr(K.device))
    _build.check(lib, "decode_cluster", err, "decode_cluster_kernel")
    decode_kernel.launches += 1
    (cluster_kernel if K.dtype == torch.bfloat16 else f32_kernel).launches += 1
    return y, a, pma.long()


# the f32 vectors of the packed weights, in decode_cluster.cu's argument order
CLUSTER_VECTORS = ("hw_b", "hw_ln", "sq_b", "misc_ln", "enc_b1", "dec_b1", "tail_b5",
                   "ln5_s", "ln5_b")


def cluster_launch_args(packed, K, V, s1, s2, n_frames, freq_bins, plan, stream):
    """Check the kernel's inputs against ``plan`` (default
    :func:`decode_cluster_plan` for K's dtype) and allocate its outputs:
    returns the plan, the 18 tensors whose pointers
    ``spoofsv_decode_cluster_launch`` takes, and (Y, A, pma) cut to the
    batch."""
    B, N, C = K.shape
    dev, dt = K.device, K.dtype
    plan = plan or decode_cluster_plan(B, C, freq_bins, elem=K.element_size())
    if (plan.batch, plan.C, plan.freq_bins) != (B, C, freq_bins):
        raise ValueError(f"plan for B={plan.batch} C={plan.C} F={plan.freq_bins}, "
                         f"inputs B={B} C={C} F={freq_bins}")
    if plan.elem != K.element_size():
        raise ValueError(f"plan for {plan.elem}-byte operands, inputs {dt}")
    why = plan.refusal()
    if why:
        raise ValueError(f"cluster decode plan refused: {why}")
    if packed["tail_w5"].shape[1] != plan.fpad:
        raise ValueError(f"packed tail width {packed['tail_w5'].shape[1]} != fpad {plan.fpad}")
    if stream is None:
        stream = pack_decode_stream({k: packed[k].to(dev) for k in MATRIX_NAMES}, plan)
    if stream.dtype != dt or tuple(stream.shape) != (plan.cluster, plan.cta_elems):
        raise ValueError(f"weight stream {tuple(stream.shape)} {stream.dtype} does not fit the "
                         f"plan ({plan.cluster}, {plan.cta_elems}) {dt}")
    Bp = plan.bp

    def rowpad(x):
        return F.pad(x.to(dt), (0, 0) * (x.dim() - 1) + (0, Bp - B)).contiguous()

    if s1 is None:
        s1 = s2 = K.new_zeros(B, C)
    vecs = [packed[k].to(dev) for k in CLUSTER_VECTORS]
    if any(v.dtype != torch.float32 for v in vecs):
        raise ValueError("packed biases and LayerNorm parameters must be float32")
    rings = torch.zeros(RING_SLOTS, Bp, C, device=dev, dtype=dt)
    y = torch.empty(Bp, n_frames, freq_bins, device=dev, dtype=dt)
    a = torch.zeros(Bp, N, n_frames, device=dev, dtype=dt)   # the kernel writes the window
    pma = torch.empty(Bp, device=dev, dtype=torch.int32)
    tensors = [rowpad(K), rowpad(V), rowpad(s1), rowpad(s2), stream] + vecs + [rings, y, a, pma]
    _build.require_cuda(*tensors)
    return plan, tensors, (y[:B], a[:B], pma[:B])


def make_fused_decoder(model: MelSyn, n_frames: int, monotonic: bool = True):
    """Same contract as :func:`spoofsv_torch.infer.decode.make_decoder`,
    backed by :func:`decode_fused`. Weights are packed on the first call, and
    the kernel's weight stream once per cluster size and dtype. Its spans:
    ``decode.pack``, ``decode.encode`` (the text encoder and the speaker
    projections) and ``decode.rollout``."""
    packed: Dict[str, torch.Tensor] = {}
    streams: Dict[Tuple[int, torch.dtype, torch.device], torch.Tensor] = {}

    @torch.no_grad()
    def decode(text_ids: torch.Tensor, spk_emb: Optional[torch.Tensor],
               text_mask: Optional[torch.Tensor] = None):
        if text_mask is not None:
            raise ValueError("the fused decoder attends over the full text")
        if not packed:
            with span("decode.pack"):
                packed.update(pack_decode_weights(model))
        with span("decode.encode"):
            K, V = model.encode_text(text_ids)
            s1 = s2 = None
            if model.condition:
                spk = spk_emb.to(K.dtype)
                s1 = model.audio_encoder.fc1(spk)
                s2 = model.audio_encoder.fc2(spk)
        plan = stream = None
        if K.device.type == "cuda":
            plan = decode_cluster_plan(K.shape[0], K.shape[2], model.freq_bins,
                                       elem=K.element_size())
            key = (plan.cluster, K.dtype, K.device)
            if key not in streams:
                with span("decode.pack"):
                    streams[key] = pack_decode_stream(
                        {k: packed[k].to(K.device) for k in MATRIX_NAMES}, plan)
                count("decode_stream_packs")
            stream = streams[key]
        with span("decode.rollout"):
            return decode_fused(packed, K, V, s1, s2, n_frames=n_frames,
                                freq_bins=model.freq_bins, condition=model.condition,
                                monotonic=monotonic, plan=plan, stream=stream)

    return decode
