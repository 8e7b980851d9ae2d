"""The Tacotron 2 decoder's rollout: gate products, two kernels a step, a CUDA graph a call.

Replaces no TPU kernel: the JAX package has no Tacotron 2. A step of the
decoder at batch B is two LSTM cells' gate products (bf16 operands, f32
sums, ``torch.mm(..., out_dtype=torch.float32)``) and what lies between
them, in two hand-written kernels of ``csrc/t2_rollout.cu``:

* ``t2_att_step_kernel``: the attention LSTM cell's pointwise update (cell
  state in f32), the query (``query_layer``), the location features (the
  31-tap convolution over [weights, cumulative weights] and its dense layer),
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
host work a step. The step's weights (20.3 M parameters, 40.6 MB in bf16)
stay in the 50 MB L2 at best; the rollout is bound by the latency of its
4000 dependent launches and by L2 bandwidth, not by its 6.6 GFLOP a step.

CPU tensors take :func:`rollout_plain`, the same steps over the same
operand layout in float32 torch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

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
# the step's weights, in the operands' order
# ---------------------------------------------------------------------------

class StepWeights:
    """The decoder's weights as the step reads them, from a
    :class:`~spoofsv_torch.models.tacotron2.Tacotron2` (after loading): the
    gate products' matrices in the model's dtype, permuted to the operand
    buffers' order (attention cell [prenet | context | h], decoder cell
    [attention h | h | context]); the biases summed in f32; the query,
    projection+gate and prenet matrices in the model's dtype; the location
    layer and ``v`` in f32."""

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


def att_step_kernel(g: torch.Tensor, w: StepWeights, s: Buffers, t: int) -> None:
    lib = _lib()
    dev = g.device
    err = lib.spoofsv_t2_att_step(
        g.data_ptr(), w.b_att.data_ptr(), s.c_att.data_ptr(), s.a_buf.data_ptr(),
        s.d_buf.data_ptr(), w.w_q.data_ptr(), w.w_loc_t.data_ptr(), w.w_dense_t.data_ptr(),
        w.v.data_ptr(), s.pm.data_ptr(), s.memory.data_ptr(), s.lengths.data_ptr(),
        s.w.data_ptr(), s.cum.data_ptr(), s.att.data_ptr(),
        s.B, s.N, s.T, t, w.A, w.P, w.M, w.D, w.att, w.w_loc_t.shape[2], w.w_loc_t.shape[1],
        _build.stream_ptr(dev))
    _build.check(lib, LIB, err, "t2_att_step_kernel")
    if not torch.cuda.is_current_stream_capturing():   # a replay counts its own
        LAUNCHES["t2_att_step"].launches += 1


def dec_step_kernel(g: torch.Tensor, w: StepWeights, s: Buffers, t: int) -> None:
    lib = _lib()
    dev = g.device
    err = lib.spoofsv_t2_dec_step(
        g.data_ptr(), w.b_dec.data_ptr(), s.c_dec.data_ptr(), s.d_buf.data_ptr(),
        s.a_buf.data_ptr(), w.w_proj.data_ptr(), w.b_proj.data_ptr(), w.w_pre1.data_ptr(),
        w.w_pre2.data_ptr(), s.seeds.data_ptr(), s.mel.data_ptr(), s.gate.data_ptr(),
        s.B, s.T, t, w.A, w.P, w.M, w.D, w.n_mel, keep_threshold(w.drop),
        1.0 / (1.0 - w.drop), _build.stream_ptr(dev))
    _build.check(lib, LIB, err, "t2_dec_step_kernel")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["t2_dec_step"].launches += 1


def _check(w: StepWeights, N: int, dtype: torch.dtype) -> None:
    if dtype != torch.bfloat16 or w.w_att.dtype != torch.bfloat16:
        raise ValueError(f"t2 rollout kernels: bf16 operands only, got {dtype}")
    filters = w.w_loc_t.shape[2]
    widths = (w.A, w.D, w.M, w.P, w.n_mel, filters)
    if (any(x % 8 for x in widths) or w.att % 16 or w.A > 1024 or w.M > 1024
            or w.D + w.M > 2048 or w.P > 256 or w.n_mel > 256 or filters != 32 or N < 1):
        raise ValueError(f"t2 rollout kernels: unsupported widths A={w.A} D={w.D} M={w.M} "
                         f"P={w.P} n_mel={w.n_mel} attention={w.att} filters={filters} N={N} "
                         f"(multiples of 8, the attention width of 16; A, M <= 1024, D + M <= "
                         f"2048, P and n_mel <= 256, 32 filters)")


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
    each kernel's :data:`LAUNCHES` grows by ``steps`` a replay). ``states``
    are the graph's own buffers, valid until the next call of the same (B,
    N): a caller that keeps them clones them. CPU tensors run
    :func:`rollout_plain`."""

    def __init__(self, model, steps: int):
        self.weights = StepWeights(model)
        self.steps = steps
        self._graphs: Dict[Tuple[int, int], Tuple[torch.cuda.CUDAGraph, Buffers]] = {}

    def _capture(self, B: int, N: int, dtype, device) -> Tuple[torch.cuda.CUDAGraph, Buffers]:
        w = self.weights
        _check(w, N, dtype)
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
        states = dict(s.ckpt, step=s.ckpt_steps)
        return s.mel.clone(), s.gate.clone(), s.att.clone(), states
