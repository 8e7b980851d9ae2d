"""The Tacotron 2 decoder's rollout: gate products, two kernels a step, a CUDA graph a call.

Replaces no TPU kernel: the JAX package has no Tacotron 2. A step of the
decoder at batch B is two LSTM cells' gate products (bf16 operands, f32
sums, ``torch.mm(..., out_dtype=torch.float32)``) and what lies between
them, in two hand-written kernels of ``csrc/t2_rollout.cu``:

* ``t2_att_step_kernel``: the attention LSTM cell's pointwise update (cell
  state in f32), the query (``query_layer``), the location term (the 31-tap
  convolution over [weights, cumulative weights] through its dense layer),
  the energies ``v·tanh(query + location + processed memory)``, the masked
  softmax in f32, the cumulative weights' update and the context over the
  memory; it writes h and the context into the next products' operands.
* ``t2_dec_step_kernel``: the decoder LSTM cell's pointwise update, the
  projection and the gate (the mel frame and its stop logit), and the next
  step's prenet (two layers, their inference dropout hashed from the row's
  seed, :func:`mask_hash_plain`).

The operands live in two bf16 rows a batch row: ``a_buf`` = [prenet out |
context | attention h] for the attention cell, ``d_buf`` = [attention h |
decoder h | context] for the decoder cell, whose weights are permuted to
that order; the projection reads ``d_buf``'s last two parts. So a step is
four launches and no copies, and the 1000 steps of a call are captured once
per (B, N, steps) into a CUDA graph (:class:`Rollout`), replayed with no
host work a step.

Each kernel runs as thread-block clusters: a cluster of ``ctas`` CTAs serves
``rows`` batch rows, each CTA a slice of every matrix, its bytes staged into
shared memory by asynchronous copies (tensor-map and bulk copies) issued as
the launch starts, the partial results crossing the cluster through
distributed shared memory.
:func:`step_plan` chooses the rows, the CTAs and the memory's staging from
(B, N) and the widths; :class:`StepWeights` lays the weights out slice by
slice; :func:`staged_bytes` counts what a launch's copies bring in (counter
``t2_step_staged_bytes``).

CPU tensors take :func:`rollout_plain`, the same steps over the same
operand layout in float32 torch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from spoofsv_torch.models.tacotron2 import PRENET_DROPOUT
from spoofsv_torch.ops import _build
from spoofsv_torch.utils.profiling import count

LIB = "t2_rollout"
LAUNCHES: Dict[str, _build.LaunchCounter] = {"t2_att_step": _build.LaunchCounter(),
                                             "t2_dec_step": _build.LaunchCounter()}
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the prenet's dropout masks
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def mask_hash_plain(seeds: torch.Tensor, step: int, layer: int, units: int) -> torch.Tensor:
    """(B,) seeds → (B, units) uint32 hashes (in int64) of (step, unit, seed,
    layer), the kernel's ``mask_hash``: a murmur3-style mix, as the
    Griffin-Lim random init hashes (frame, bin, seed)."""
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
    """A unit is kept where its hash's low 24 bits reach this."""
    return int(round(p * (1 << 24)))


def prenet_mask_plain(seeds: torch.Tensor, step: int, layer: int, units: int, p: float
                      ) -> torch.Tensor:
    """(B, units) float: 1/(1−p) where prenet layer ``layer``'s unit is kept at
    decoder step ``step``, 0 where it is dropped."""
    keep = (mask_hash_plain(seeds, step, layer, units) & 0xFFFFFF) >= keep_threshold(p)
    return keep.float() / (1.0 - p)


# ---------------------------------------------------------------------------
# the kernels' plan: rows and CTAs a cluster, shared memory, the memory's staging
# ---------------------------------------------------------------------------

SMEM_MAX = 232448         # bytes of shared memory a block may use (sm_90)
RESIDENT_CLUSTERS = 15    # clusters of 8 one-CTA-an-SM blocks an H100 SXM holds at once
#                           (cudaOccupancyMaxActiveClusters); the plan's default off the card
MIN_CHUNK = 8             # positions a streamed chunk of the memory holds at least
MAX_BOX = 256             # the most a tensor copy's box spans in a dimension


def _a128(n: int) -> int:
    return (n + 127) & ~127


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _round8(n: int) -> int:
    return (n + 7) & ~7


def cluster_ctas(widths: Tuple[int, ...]) -> int:
    """CTAs a cluster (8, 4, 2 or 1): the most whose slices of the units, the
    attention width, the memory's columns and the prenet's units are whole
    16-byte rows, the attention slice a power of two of 8-unit groups, and
    the slices of the units and columns within one tensor copy's box.
    ``widths`` = (A, D, M, P, attention, K, n_mel)."""
    A, D, M, P, AT, _, _ = widths
    for C in (8, 4, 2, 1):
        ag = AT // C // 8
        if (A % (4 * C) == 0 and D % (4 * C) == 0 and M % (8 * C) == 0 and AT % (8 * C) == 0
                and P % (8 * C) == 0 and ag & (ag - 1) == 0
                and max(A, D, M) // C <= MAX_BOX):
            return C
    raise ValueError(f"t2 rollout kernels: no cluster fits the widths {widths}")


def att_smem(R: int, C: int, N: int, chunk: int, widths: Tuple[int, ...]) -> int:
    """Bytes of shared memory a CTA of ``t2_att_step_kernel`` lays out for R
    rows a cluster of C CTAs, the memory in chunks of ``chunk`` positions (one
    buffer when a chunk holds all N, else two): ``csrc/t2_rollout.cu``'s
    ``att_layout``, part for part."""
    A, _, M, _, AT, K, _ = widths
    Au, Aa, Mc, N4 = A // C, AT // C, M // C, _round4(N)
    nbuf = 1 if chunk >= N else 2
    wcw = _round4(N4 + K - 1)
    erecv = 0 if C * N4 <= 4 * Au else 4 * C * R * N4   # else in the gate sums' place
    parts = (64, 16 * R * Au, 16 * Au, 4 * R * Au, 2 * Au * (AT + 8), 8 * K * Aa, 4 * Aa,
             8 * R * wcw, 2 * R * Aa * N, 4 * C * R * Aa, 4 * R * Aa, 4 * R * N4, erecv,
             4 * R * N4, 4 * R, 4 * R * Mc, 2 * nbuf * R * chunk * Mc)
    return sum(_a128(p) for p in parts)


def dec_smem(R: int, C: int, widths: Tuple[int, ...]) -> int:
    """Bytes of shared memory a CTA of ``t2_dec_step_kernel`` lays out:
    ``dec_layout``, part for part."""
    _, D, M, P, _, _, NM = widths
    Du, Mc, Pu, OS = D // C, M // C, P // C, _round8(NM + 1)
    KP = Du + Mc
    parts = (64, 16 * R * Du, 16 * Du, 4 * R * Du, 2 * R * Mc, 4 * R * KP, 2 * KP * OS, 4 * OS,
             4 * R * OS, 4 * C * R * OS, 4 * R * OS, 2 * NM * (Pu + 8), 2 * P * (Pu + 8),
             4 * R * Pu, 4 * R * P, 4 * R)
    return sum(_a128(p) for p in parts)


class Plan(NamedTuple):
    """How a step kernel covers a batch: ``clusters`` clusters of ``ctas``
    CTAs, ``rows`` batch rows each (the last one's rows past B idle), ``smem``
    bytes of shared memory a CTA; the attention kernel's memory in chunks of
    ``chunk`` positions, ``streamed`` through two buffers where a row's
    columns do not fit whole (``chunk`` is N when they do)."""
    rows: int
    ctas: int
    clusters: int
    smem: int
    chunk: int
    streamed: bool


def step_plan(kernel: str, B: int, N: int, widths: Tuple[int, ...],
              resident: int = RESIDENT_CLUSTERS) -> Plan:
    """The plan of ``kernel`` (``"att"`` or ``"dec"``) for B rows of texts of N
    ids: as many clusters as the card holds at once (``resident``), fewer
    where B is smaller, their rows spread evenly; the memory staged whole where
    it fits in :data:`SMEM_MAX`, else streamed in the longest chunks that
    fit (:data:`MIN_CHUNK` positions at least); fewer rows a cluster (and more
    clusters) only where neither fits."""
    C = cluster_ctas(widths)
    target = min(MAX_BOX, -(-B // max(1, min(resident, B))))
    for R in range(target, 0, -1):
        clusters = -(-B // R)
        if kernel == "dec":
            smem = dec_smem(R, C, widths)
            if smem <= SMEM_MAX:
                return Plan(R, C, clusters, smem, 0, False)
            continue
        smem = att_smem(R, C, N, N, widths)
        if smem <= SMEM_MAX and N <= MAX_BOX:
            return Plan(R, C, clusters, smem, N, False)
        for chunk in range(min(N - 1, MAX_BOX), min(N - 1, MIN_CHUNK) - 1, -1):
            smem = att_smem(R, C, N, chunk, widths)
            if smem <= SMEM_MAX:
                return Plan(R, C, clusters, smem, chunk, True)
    raise ValueError(f"t2 rollout kernels: no plan fits {SMEM_MAX} bytes of shared memory "
                     f"for B={B} N={N} widths={widths}")


def staged_bytes(kernel: str, plan: Plan, B: int, N: int, widths: Tuple[int, ...]) -> int:
    """Bytes one launch of ``kernel`` (``"att"`` or ``"dec"``) of B rows brings
    from device memory into shared memory by asynchronous copies, as it issues
    them: per CTA its biases and weight slices, and boxes of its cluster's
    rows (past B too) of the gate sums and cell state of its units, of the
    memory's columns (the attention kernel, every chunk's) and of the context
    columns (the decoder); per row and CTA the attention kernel's processed
    memory, [w, Σw] and length, the decoder's seed."""
    A, D, M, P, AT, K, NM = widths
    C, ctas = plan.ctas, plan.clusters * plan.ctas
    slots = plan.clusters * plan.rows * C   # (row, CTA) pairs the boxes cover
    Au, Aa, Du, Mc, Pu, OS = A // C, AT // C, D // C, M // C, P // C, _round8(NM + 1)
    if kernel == "att":
        chunks = -(-N // plan.chunk)
        return (slots * (20 * Au + 2 * chunks * plan.chunk * Mc) + B * C * (2 * Aa * N + 8 * N + 4)
                + ctas * (16 * Au + 2 * Au * (AT + 8) + 8 * K * Aa + 4 * Aa))
    return (slots * (20 * Du + 2 * Mc) + B * C * 4
            + ctas * (16 * Du + 2 * (Du + Mc) * OS + 4 * OS + 2 * NM * (Pu + 8) + 2 * P * (Pu + 8)))


# ---------------------------------------------------------------------------
# the step's weights, in the operands' order
# ---------------------------------------------------------------------------

class StepWeights:
    """The decoder's weights as the step reads them, from a
    :class:`~spoofsv_torch.models.tacotron2.Tacotron2` (after loading): the
    gate products' matrices in the model's dtype, permuted to the operand
    buffers' order (attention cell [prenet | context | h], decoder cell
    [attention h | h | context]); the biases summed in f32; the query,
    projection+gate and prenet matrices in the model's dtype; the location
    layer and ``v`` in f32.

    The kernels' copies (``k_*``), laid out by the cluster's CTAs
    (:func:`cluster_ctas`, ``C``) so that a CTA's slice is one block, each
    block's rows padded to an odd multiple of 16 bytes: ``k_wq`` W_q^T
    (C, A/C, att + 8); ``k_u`` the location convolution folded into its dense
    layer, U = dense · conv in float64 stored f32, as (C, 2K, att/C);
    ``k_proj`` the projection and gate transposed, a CTA's rows its decoder
    units then its context columns, (C, D/C + M/C, round8(n_mel + 1));
    ``k_bproj`` their biases padded; ``k_pre1`` / ``k_pre2`` the prenet's
    layers transposed, a CTA's units, (C, inputs, P/C + 8)."""

    def __init__(self, model):
        cfg = model.cfg
        dec = model.decoder
        self.P, self.M = cfg.prenet_dim, cfg.memory_dim
        self.A, self.D = cfg.attention_rnn_dim, cfg.decoder_rnn_dim
        self.n_mel, self.att = cfg.n_mel_channels, cfg.attention_dim
        self.drop = PRENET_DROPOUT
        ar, dr, al = dec.attention_rnn, dec.decoder_rnn, dec.attention_layer
        with torch.no_grad():
            self.w_att = torch.cat([ar.weight_ih, ar.weight_hh], 1)
            self.b_att = ar.bias_ih.float() + ar.bias_hh.float()
            A = self.A
            self.w_dec = torch.cat([dr.weight_ih[:, :A], dr.weight_hh, dr.weight_ih[:, A:]], 1)
            self.b_dec = dr.bias_ih.float() + dr.bias_hh.float()
            self.w_q = al.query_layer.linear_layer.weight.clone()
            # (2, K, filters): the kernel reads a tap's filters as one row
            self.w_loc_t = al.location_layer.location_conv.conv.weight.float().permute(1, 2, 0) \
                .contiguous()
            self.w_dense_t = al.location_layer.location_dense.linear_layer.weight.float().t() \
                .contiguous()
            self.v = al.v.linear_layer.weight.float().reshape(-1).clone()
            self.w_proj = torch.cat([dec.linear_projection.linear_layer.weight,
                                     dec.gate_layer.linear_layer.weight], 0)
            self.b_proj = torch.cat([dec.linear_projection.linear_layer.bias,
                                     dec.gate_layer.linear_layer.bias], 0).float()
            self.w_pre1 = dec.prenet.layers[0].linear_layer.weight.clone()
            self.w_pre2 = dec.prenet.layers[1].linear_layer.weight.clone()
            self.widths = (A, self.D, self.M, self.P, self.att, self.w_loc_t.shape[1],
                           self.n_mel)
            self._kernel_layouts()

    def _kernel_layouts(self) -> None:
        A, D, M, P, AT, K, NM = self.widths
        C = self.C = cluster_ctas(self.widths)
        Au, Aa, Du, Mc, Pu, OS = A // C, AT // C, D // C, M // C, P // C, _round8(NM + 1)
        dt, dev = self.w_q.dtype, self.w_q.device
        self.k_wq = torch.zeros(A, AT + 8, dtype=dt, device=dev)
        self.k_wq[:, :AT] = self.w_q.t()
        self.k_wq = self.k_wq.reshape(C, Au, AT + 8)
        conv = self.w_loc_t.double().permute(2, 0, 1).reshape(-1, 2 * K)   # (filters, 2K)
        u = self.w_dense_t.double().t() @ conv                               # (AT, 2K)
        self.k_u = u.float().reshape(C, Aa, 2 * K).transpose(1, 2).contiguous()
        proj = torch.zeros(D + M, OS, dtype=dt, device=dev)
        proj[:, :NM + 1] = self.w_proj.t()
        self.k_proj = torch.cat([proj[:D].reshape(C, Du, OS), proj[D:].reshape(C, Mc, OS)],
                                1).contiguous()
        self.k_bproj = torch.zeros(OS, dtype=torch.float32, device=dev)
        self.k_bproj[:NM + 1] = self.b_proj

        def units(wl: torch.Tensor) -> torch.Tensor:   # (P, inputs) → (C, inputs, Pu + 8)
            out = torch.zeros(C, wl.shape[1], Pu + 8, dtype=dt, device=dev)
            out[:, :, :Pu] = wl.reshape(C, Pu, wl.shape[1]).transpose(1, 2)
            return out

        self.k_pre1, self.k_pre2 = units(self.w_pre1), units(self.w_pre2)


CHECKPOINT_EVERY = 25   # steps between two kept states (a run of the steps resumes there)
STATE = ("h_att", "c_att", "h_dec", "c_dec", "ctx", "w", "cum")


class Buffers:
    """What a rollout of (B, N, steps) reads and writes: its inputs (memory,
    processed memory as (B, attention, N), lengths, seeds), the operand rows,
    the cell states and attention weights (f32), its outputs, and the
    decoder's state before every :data:`CHECKPOINT_EVERY`-th step
    (:data:`STATE`, float32, ``ckpt``)."""

    def __init__(self, w: StepWeights, B: int, N: int, steps: int, dtype, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.B, self.N, self.T = B, N, steps
        n = -(-steps // CHECKPOINT_EVERY)
        widths = {"h_att": w.A, "c_att": w.A, "h_dec": w.D, "c_dec": w.D, "ctx": w.M, "w": N,
                  "cum": N}
        self.ckpt = {k: torch.zeros(n, B, widths[k], **f32) for k in STATE}
        self.ckpt_steps = torch.arange(0, steps, CHECKPOINT_EVERY)
        self.memory = torch.zeros(B, N, w.M, dtype=dtype, device=device)
        self.pm = torch.zeros(B, w.att, N, dtype=dtype, device=device)   # transposed
        self.lengths = torch.zeros(B, dtype=torch.int32, device=device)
        self.seeds = torch.zeros(B, dtype=torch.int32, device=device)
        self.a_buf = torch.zeros(B, w.P + w.M + w.A, dtype=dtype, device=device)
        self.d_buf = torch.zeros(B, w.A + w.D + w.M, dtype=dtype, device=device)
        self.c_att, self.c_dec = torch.zeros(B, w.A, **f32), torch.zeros(B, w.D, **f32)
        self.w, self.cum = torch.zeros(B, N, **f32), torch.zeros(B, N, **f32)
        self.mel = torch.zeros(B, steps, w.n_mel, **f32)
        self.gate = torch.zeros(B, steps, **f32)
        self.att = torch.zeros(B, N, steps, **f32)

    def reset(self) -> None:
        for t in (self.a_buf, self.d_buf, self.c_att, self.c_dec, self.w, self.cum):
            t.zero_()

    def snapshot(self, i: int, w: StepWeights) -> None:
        """The state before the step ``ckpt_steps[i]`` into ``ckpt``: h and the
        context as the products read them (the operand rows), c, w, Σw."""
        A, D = w.A, w.D
        for k, src in (("h_att", self.d_buf[:, :A]), ("c_att", self.c_att),
                       ("h_dec", self.d_buf[:, A:A + D]), ("c_dec", self.c_dec),
                       ("ctx", self.d_buf[:, A + D:]), ("w", self.w), ("cum", self.cum)):
            self.ckpt[k][i].copy_(src)


# ---------------------------------------------------------------------------
# the plain step (CPU tensors; what the kernels compute)
# ---------------------------------------------------------------------------

def _lstm_pointwise(g: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    i, f, gg, o = (g + b).chunk(4, dim=1)
    c.copy_(torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg))
    return torch.sigmoid(o) * torch.tanh(c)


def att_step_plain(g: torch.Tensor, w: StepWeights, s: Buffers, t: int) -> None:
    """``t2_att_step_kernel`` in torch: ``g`` (B, 4A) f32 the attention
    cell's gate products."""
    P, M, A = w.P, w.M, w.A
    h = _lstm_pointwise(g, w.b_att, s.c_att)
    s.a_buf[:, P + M:] = h.to(s.a_buf.dtype)
    s.d_buf[:, :A] = h.to(s.d_buf.dtype)
    q = h @ w.w_q.float().t()
    w_loc = w.w_loc_t.permute(2, 0, 1)
    loc = F.conv1d(torch.stack([s.w, s.cum], 1), w_loc, padding=(w_loc.shape[-1] - 1) // 2)
    pa = loc.transpose(1, 2) @ w.w_dense_t
    e = torch.tanh(q[:, None, :] + pa + s.pm.float().transpose(1, 2)) @ w.v
    valid = torch.arange(s.N, device=e.device)[None, :] < s.lengths[:, None]
    wn = torch.softmax(e.masked_fill(~valid, float("-inf")), dim=1)
    s.w.copy_(wn)
    s.cum.add_(wn)
    s.att[:, :, t] = wn
    ctx = torch.bmm(wn[:, None, :], s.memory.float())[:, 0]
    s.a_buf[:, P:P + M] = ctx.to(s.a_buf.dtype)
    s.d_buf[:, A + w.D:] = ctx.to(s.d_buf.dtype)


def dec_step_plain(g: torch.Tensor, w: StepWeights, s: Buffers, t: int) -> None:
    """``t2_dec_step_kernel`` in torch: ``g`` (B, 4D) f32 the decoder cell's
    gate products."""
    A, D, n_mel = w.A, w.D, w.n_mel
    h = _lstm_pointwise(g, w.b_dec, s.c_dec)
    s.d_buf[:, A:A + D] = h.to(s.d_buf.dtype)
    out = torch.cat([h, s.d_buf[:, A + D:].float()], 1) @ w.w_proj.float().t() + w.b_proj
    s.mel[:, t] = out[:, :n_mel]
    s.gate[:, t] = out[:, n_mel]
    y = out[:, :n_mel]
    for layer, wl in enumerate((w.w_pre1, w.w_pre2)):
        y = torch.relu(y @ wl.float().t()) * prenet_mask_plain(s.seeds, t + 1, layer, wl.shape[0],
                                                               w.drop)
    s.a_buf[:, :w.P] = y.to(s.a_buf.dtype)


# ---------------------------------------------------------------------------
# the kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    return _build.load(BUILD)


BUILD = LIB   # the library the wrappers launch (t2_probe sets its clocked build)


_RESIDENT: Dict[Tuple[int, int], Dict[str, int]] = {}   # (device, C) → resident clusters a kernel
_PLANS: Dict[tuple, Tuple[Plan, Plan]] = {}              # (device, widths, B, N) → both plans


def kernel_plans(w: StepWeights, B: int, N: int, device: torch.device) -> Tuple[Plan, Plan]:
    """Both kernels' plans for (B, N) on ``device``: :func:`step_plan` with the
    clusters the card holds at once (asked of it once a device)."""
    plan_key = (device.index or 0, w.widths, B, N)
    if plan_key in _PLANS:
        return _PLANS[plan_key]
    key = (device.index or 0, w.C)
    if key not in _RESIDENT:
        lib = _lib()
        got = {}
        for i, name in enumerate(("att", "dec")):
            n = lib.spoofsv_t2_resident_clusters(i, w.C)
            if n < 0:
                _build.check(lib, LIB, -n, f"t2 {name} kernel's resident clusters")
            if n < 1:
                raise RuntimeError(f"t2 {name} kernel: the card holds no cluster of {w.C} CTAs")
            got[name] = n
        _RESIDENT[key] = got
    res = _RESIDENT[key]
    _PLANS[plan_key] = (step_plan("att", B, N, w.widths, res["att"]),
                        step_plan("dec", B, N, w.widths, res["dec"]))
    return _PLANS[plan_key]


def att_step_kernel(g: torch.Tensor, w: StepWeights, s: Buffers, t: int) -> None:
    lib = _lib()
    dev = g.device
    p = kernel_plans(w, s.B, s.N, dev)[0]
    err = lib.spoofsv_t2_att_step(
        g.data_ptr(), w.b_att.data_ptr(), s.c_att.data_ptr(), s.a_buf.data_ptr(),
        s.d_buf.data_ptr(), w.k_wq.data_ptr(), w.k_u.data_ptr(), w.v.data_ptr(),
        s.pm.data_ptr(), s.memory.data_ptr(), s.lengths.data_ptr(), s.w.data_ptr(),
        s.cum.data_ptr(), s.att.data_ptr(),
        s.B, s.N, s.T, t, w.A, w.P, w.M, w.D, w.att, w.w_loc_t.shape[1],
        p.rows, p.ctas, p.chunk, p.smem, _build.stream_ptr(dev))
    _build.check(lib, LIB, err, "t2_att_step_kernel")
    if not torch.cuda.is_current_stream_capturing():   # a replay counts its own
        LAUNCHES["t2_att_step"].launches += 1


def dec_step_kernel(g: torch.Tensor, w: StepWeights, s: Buffers, t: int) -> None:
    lib = _lib()
    dev = g.device
    p = kernel_plans(w, s.B, s.N, dev)[1]
    err = lib.spoofsv_t2_dec_step(
        g.data_ptr(), w.b_dec.data_ptr(), s.c_dec.data_ptr(), s.d_buf.data_ptr(),
        s.a_buf.data_ptr(), w.k_proj.data_ptr(), w.k_bproj.data_ptr(), w.k_pre1.data_ptr(),
        w.k_pre2.data_ptr(), s.seeds.data_ptr(), s.mel.data_ptr(), s.gate.data_ptr(),
        s.B, s.T, t, w.A, w.P, w.M, w.D, w.n_mel, keep_threshold(w.drop),
        p.rows, p.ctas, p.smem, 1.0 / (1.0 - w.drop), _build.stream_ptr(dev))
    _build.check(lib, LIB, err, "t2_dec_step_kernel")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["t2_dec_step"].launches += 1


def _check(w: StepWeights, B: int, N: int, dtype: torch.dtype) -> None:
    if dtype != torch.bfloat16 or w.w_att.dtype != torch.bfloat16:
        raise ValueError(f"t2 rollout kernels: bf16 operands only, got {dtype}")
    A, D, M, P, AT, K, NM = w.widths
    if any(x % 8 for x in (A, D, M, P, NM)) or AT % 16 or K % 2 == 0 or N < 1:
        raise ValueError(f"t2 rollout kernels: unsupported widths A={A} D={D} M={M} P={P} "
                         f"n_mel={NM} attention={AT} taps={K} N={N} (multiples of 8, the "
                         f"attention width of 16, an odd number of taps)")
    step_plan("att", B, N, w.widths)   # raises where no plan fits


def run_steps(w: StepWeights, s: Buffers, plain: bool) -> None:
    """The whole rollout on the buffers: reset, then ``s.T`` steps."""
    s.reset()
    for t in range(s.T):
        if t % CHECKPOINT_EVERY == 0:
            s.snapshot(t // CHECKPOINT_EVERY, w)
        if plain:
            att_step_plain(s.a_buf.float() @ w.w_att.float().t(), w, s, t)
            dec_step_plain(s.d_buf.float() @ w.w_dec.float().t(), w, s, t)
        else:
            att_step_kernel(torch.mm(s.a_buf, w.w_att.t(), out_dtype=torch.float32), w, s, t)
            dec_step_kernel(torch.mm(s.d_buf, w.w_dec.t(), out_dtype=torch.float32), w, s, t)


def restore_state(w: StepWeights, s: Buffers, state: dict, mel_prev: torch.Tensor, t: int
                  ) -> None:
    """The decoder's state kept before step ``t`` (one entry of the rollout's
    ``states``) into the buffers ``s``: the operand rows, c, w, Σw, and the
    prenet's output for step ``t`` from the frame emitted before it
    (``mel_prev``; the go frame's prenet is 0), its masks hashed as the
    kernel hashes them."""
    A, D, P, M = w.A, w.D, w.P, w.M
    for k in ("c_att", "c_dec", "w", "cum"):
        getattr(s, k).copy_(state[k])
    s.d_buf[:, :A] = state["h_att"]
    s.d_buf[:, A:A + D] = state["h_dec"]
    s.d_buf[:, A + D:] = state["ctx"]
    s.a_buf[:, P:P + M] = state["ctx"]
    s.a_buf[:, P + M:] = state["h_att"]
    y = mel_prev.float() if t else torch.zeros_like(mel_prev, dtype=torch.float32)
    for layer, wl in enumerate((w.w_pre1, w.w_pre2)):
        y = torch.relu(y @ wl.float().t()) * prenet_mask_plain(s.seeds, t, layer, wl.shape[0],
                                                               w.drop)
    s.a_buf[:, :P] = y.to(s.a_buf.dtype)


def rollout_plain(w: StepWeights, memory, pm, lengths, seeds, steps: int):
    """The rollout in float32 torch: :class:`Rollout`'s outputs."""
    B, N, _ = memory.shape
    s = Buffers(w, B, N, steps, torch.float32, memory.device)
    s.memory.copy_(memory)
    s.pm.copy_(pm.transpose(1, 2))
    s.lengths.copy_(lengths)
    s.seeds.copy_(seeds)
    run_steps(w, s, plain=True)
    return s.mel, s.gate, s.att, dict(s.ckpt, step=s.ckpt_steps)


class Rollout:
    """``rollout(memory (B, N, M), pm (B, N, att), lengths (B,), seeds (B,)) ->
    (mel (B, T, n_mel) f32, gate logits (B, T) f32, attention (B, N, T) f32,
    states)`` over ``steps`` decoder steps from the go frame, every step run
    (the gate is recorded, not obeyed). ``states`` holds the decoder's state
    before every :data:`CHECKPOINT_EVERY`-th step (``step``: those steps;
    each name of :data:`STATE`: (n, B, ·) float32), from which a later run of
    the steps can resume.

    On a card, the first call of each (B, N) runs the steps once eagerly,
    then captures them into a CUDA graph (counter ``t2_graph_captures``);
    each call copies its inputs into the graph's buffers, replays it and
    returns copies of mel, gate and attention (counter ``t2_rollout_steps``;
    counter ``t2_step_staged_bytes``: what the kernels' bulk copies bring in
    over the call's steps, :func:`staged_bytes`; each kernel's
    :data:`LAUNCHES` grows by ``steps`` a replay). ``states``
    are the graph's own buffers, valid until the next call of the same (B,
    N): a caller that keeps them clones them. CPU tensors run
    :func:`rollout_plain`."""

    def __init__(self, model, steps: int):
        self.weights = StepWeights(model)
        self.steps = steps
        self._graphs: Dict[Tuple[int, int], Tuple[torch.cuda.CUDAGraph, Buffers]] = {}

    def _capture(self, B: int, N: int, dtype, device) -> Tuple[torch.cuda.CUDAGraph, Buffers]:
        w = self.weights
        _check(w, B, N, dtype)
        s = Buffers(w, B, N, self.steps, dtype, device)
        run_steps(w, s, plain=False)      # cuBLAS and the kernels loaded, outside the capture
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run_steps(w, s, plain=False)
        count("t2_graph_captures")
        return graph, s

    @torch.no_grad()
    def __call__(self, memory: torch.Tensor, pm: torch.Tensor, lengths: torch.Tensor,
                 seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if int(lengths.min()) < 1:
            raise ValueError("t2 rollout: every row needs at least one id")
        count("t2_rollout_steps", self.steps)
        if memory.device.type == "cpu":
            return rollout_plain(self.weights, memory, pm, lengths, seeds, self.steps)
        B, N, _ = memory.shape
        key = (B, N)
        if key not in self._graphs:
            self._graphs[key] = self._capture(B, N, memory.dtype, memory.device)
        graph, s = self._graphs[key]
        s.memory.copy_(memory)
        s.pm.copy_(pm.transpose(1, 2))
        s.lengths.copy_(lengths)
        s.seeds.copy_(seeds)
        graph.replay()
        for k in LAUNCHES.values():
            k.launches += self.steps
        count("t2_step_staged_bytes", self.steps * sum(
            staged_bytes(k, p, B, N, self.weights.widths)
            for k, p in zip(("att", "dec"), kernel_plans(self.weights, B, N, memory.device))))
        states = dict(s.ckpt, step=s.ckpt_steps)
        return s.mel.clone(), s.gate.clone(), s.att.clone(), states
