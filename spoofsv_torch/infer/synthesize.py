"""Batched synthesis pipeline: Text2Mel decode → SSRN → Griffin-Lim → wav.

Port of :mod:`spoofsv_tpu.infer.synthesize` (``make_vocoder``,
``finalize_audio``, ``Synthesizer``). Tensors on a CUDA device go through
the hand-written kernels (decode K1, GL init K2, Griffin-Lim K3); tensors on
the CPU go through their plain PyTorch versions. The routes follow the
configuration as the JAX package's do (:func:`gl_route`,
:func:`decode_route`); a value the port does not take raises
``ValueError``. With a :class:`~spoofsv_torch.parallel.mesh.Mesh` of
several ranks, :class:`Synthesizer` splits the batch by rows over the ranks
and all-gathers the outputs, as the JAX package's ``shard_map`` path does.
A call brings its audio to the host through page-locked memory
(:func:`host_audio`); :meth:`Synthesizer.device_call` leaves it on the device.

:class:`Tacotron2Synthesizer` runs the multi-speaker Tacotron 2
(:mod:`spoofsv_torch.models.tacotron2`) through the same call: encoder,
the decoder's rollout (:class:`spoofsv_torch.ops.t2_kernel.Rollout`),
postnet, and the same vocoder fed from the mel (``make_vocoder(...,
source="mel")``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spoofsv_torch.config import Config, Tacotron2Config
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.dsp.primitives import mel_filterbank
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.models.ssrn import SSRN
from spoofsv_torch.models.text2mel import MelSyn
from spoofsv_torch.infer.decode import make_decoder
from spoofsv_torch.ops.decode_kernel import make_fused_decoder
from spoofsv_torch.ops.gl_kernel import griffin_lim_fused, griffin_lim_tc, init_angles_plain
from spoofsv_torch.ops.t2_kernel import Rollout
from spoofsv_torch.parallel.mesh import active, batch_sharding, replicate_tree
from spoofsv_torch.utils.profiling import count, nbytes, span

GL_IMPLS = ("auto", "pallas", "xla")
GL_PRECISIONS = ("default", "highest")
# "scan" is the JAX package's documented name of its plain decode
DECODE_IMPLS = {"auto": "kernel", "pallas": "kernel", "xla": "plain", "scan": "plain"}


def _field(cfg: Config, name: str, allowed) -> object:
    value = getattr(cfg.tpu, name)
    if value not in allowed or not isinstance(value, type(next(iter(allowed)))):
        raise ValueError(f"cfg.tpu.{name}={value!r} is not one the port takes: {tuple(allowed)}")
    return value


def gl_route(cfg: Config, device) -> str:
    """The Griffin-Lim route for tensors on ``device``, from
    ``cfg.tpu.griffin_lim_impl`` and ``griffin_lim_precision`` (as
    ``spoofsv_tpu.infer.synthesize.make_vocoder`` routes, with the card in
    the TPU's place):

    * "tc": :func:`griffin_lim_tc`, the tensor-core K3 (int8 operands if
      ``griffin_lim_int8``, else bf16); its plain version for CPU tensors.
      "pallas" on any device, "auto" with "default" precision on a card.
    * "f32": :func:`griffin_lim_fused`, the f32 K3 (``csrc/gl.cu``):
      "auto" with "highest" precision on a card.
    * "xla": :func:`spoofsv_torch.dsp.torchdsp.griffin_lim` from the plain
      init: "xla" on any device, "auto" on the CPU.
    """
    impl = _field(cfg, "griffin_lim_impl", GL_IMPLS)
    precision = _field(cfg, "griffin_lim_precision", GL_PRECISIONS)
    _field(cfg, "griffin_lim_int8", (True, False))
    if impl != "auto":
        return "tc" if impl == "pallas" else "xla"
    if torch.device(device).type == "cpu":
        return "xla"
    return "f32" if precision == "highest" else "tc"


def decode_route(cfg: Config) -> str:
    """``cfg.tpu.decode_impl``: "kernel" (:func:`make_fused_decoder`, K1 on a
    card, its plain version for CPU tensors) for "auto"/"pallas", "plain"
    (:func:`spoofsv_torch.infer.decode.make_decoder`) for "xla"/"scan"."""
    return DECODE_IMPLS[_field(cfg, "decode_impl", DECODE_IMPLS)]


def gl_seeds(batch: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B,) int32 phase-init seeds for the "random" (hash) GL init."""
    return torch.randint(0, np.iinfo(np.int32).max, (batch,), generator=generator,
                         dtype=torch.int32)


def mel_pseudo_inverse(cfg: Tacotron2Config) -> torch.Tensor:
    """(n_mel, 1 + n_fft/2) float32: the pseudo-inverse (transposed) of the
    Slaney mel basis that NVIDIA's ``TacotronSTFT`` projects with
    (``mel_fmin``..``mel_fmax``), computed in float64."""
    basis = mel_filterbank(cfg.sampling_rate, cfg.filter_length, cfg.n_mel_channels,
                           cfg.mel_fmin, cfg.mel_fmax).astype(np.float64)
    return torch.from_numpy(np.linalg.pinv(basis).T.astype(np.float32))


def mel_to_linear(mel: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """A natural-log mel (B, T, n_mel) → linear magnitude (B, T, F): exp,
    the mel basis's pseudo-inverse, clamped at 0 (power 1), in float32."""
    return torch.clamp(torch.exp(mel.float()) @ inverse, min=0.0)


def make_vocoder(cfg, n_iter: Optional[int] = None, source: str = "linear"):
    """``vocode(x, seeds=None) -> audio (B, hop·(T−1))``.

    ``source="linear"`` (DCTTS): ``x`` the linear magnitude (B, T, F),
    per-utterance peak renorm (non-log mode), power ``(·)^(1.3/0.6)``,
    Griffin-Lim, de-emphasis. ``source="mel"`` (Tacotron 2): ``x`` the
    natural-log mel (B, T, n_mel), :func:`mel_to_linear` (power 1), Griffin-Lim,
    no de-emphasis. Griffin-Lim runs from ``cfg.tpu.griffin_lim_init``
    (random hash init uses ``seeds``, (B,) int) on the route
    :func:`gl_route` picks for the tensor's device.
    """
    if source not in ("linear", "mel"):
        raise ValueError(f"make_vocoder: unknown source {source!r}")
    n_iter = n_iter or cfg.tpu.griffin_lim_iters
    n_fft, hop = cfg.stft.fft_length, cfg.stft.hop_length
    power = cfg.norm.reconstruction_power / cfg.norm.analysis_power
    init_mode = cfg.tpu.griffin_lim_init
    gl_route(cfg, "cpu")   # unknown values raise here, not at the first call
    inverse = {"cpu": mel_pseudo_inverse(cfg)} if source == "mel" else None

    @torch.no_grad()
    def vocode(lin_pred: torch.Tensor, seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("vocode.prep"):
            if source == "mel":
                key = str(lin_pred.device)
                if key not in inverse:
                    inverse[key] = inverse["cpu"].to(lin_pred.device)
                spec = mel_to_linear(lin_pred, inverse[key])
            else:
                x = lin_pred.float()
                if cfg.norm.log_feature:
                    db = x * cfg.norm.max_db - cfg.norm.max_db + cfg.norm.ref_db
                    x = torch.pow(10.0, 0.05 * db)
                else:
                    peak = x.amax(dim=(1, 2), keepdim=True)
                    x = x / peak.clamp_min(1e-8)
                spec = torch.pow(x, power)
            if init_mode == "random" and seeds is None:
                seeds = gl_seeds(spec.shape[0])
        with span("vocode.gl"):
            route = gl_route(cfg, spec.device)
            if route == "xla":
                init = init_angles_plain(spec, n_fft, hop, init_mode, seeds)
                audio = torchdsp.griffin_lim(spec, n_fft, hop, n_fft, n_iter, init_angles=init)
            elif route == "f32":
                audio = griffin_lim_fused(spec, n_fft, hop, n_fft, n_iter=n_iter,
                                          init_mode=init_mode, seeds=seeds)
            else:
                audio = griffin_lim_tc(spec, n_fft, hop, n_fft, n_iter=n_iter,
                                       init_mode=init_mode, seeds=seeds,
                                       int8=cfg.tpu.griffin_lim_int8)
        if source == "mel":
            return audio
        with span("vocode.deemph"):
            return torchdsp.deemphasis(audio, coeff=cfg.preemph)

    return vocode


def finalize_audio(audio: np.ndarray, cfg: Config, trim_db: Optional[float] = None,
                   max_seconds: Optional[float] = None) -> np.ndarray:
    """Host-side tail: optional trim, duration cap, peak scale ×0.75 (the
    reference divides by ``max``, not ``|max|`` — preserved)."""
    y = np.asarray(audio, dtype=np.float32)
    if trim_db is not None:
        y, _ = dsp_host.trim_silence(y, trim_db)
        if len(y) == 0:
            y = np.asarray(audio, dtype=np.float32)
    if max_seconds is not None and len(y) > int(max_seconds * cfg.sampling_rate):
        y = y[: int(max_seconds * cfg.sampling_rate)]
    if not cfg.norm.log_feature:
        y = y / np.max(y) * 0.75
    return y


def _pinned_allocs() -> int:
    """Blocks the caching host allocator has pinned in this process so far."""
    return int(torch.cuda.host_memory_stats()["num_host_alloc"])


def host_audio(*tensors: Optional[torch.Tensor], count_host: bool = False):
    """``tensors`` on the host, in the span ``synth.to_host``: one tensor
    gives one, several a tuple; None stays None.

    Each device tensor is copied into a block of page-locked memory from
    torch's caching host allocator, on the current stream, and the host waits
    on those copies alone, with one event; their bytes go on ``d2h_bytes``,
    and ``d2h_pinned_allocs`` counts the copies for which the allocator pinned
    a new block instead of reusing a free one. A block is the caller's: the
    allocator hands it out again only after the last reference to the result
    is gone, so a result held across later calls is never overwritten. A host
    tensor is returned as it is, its bytes counted only under ``count_host``
    (serving counts a batch's results wherever they are)."""
    with span("synth.to_host"):
        out = list(tensors)
        dev = [i for i, t in enumerate(tensors) if t is not None and t.device.type != "cpu"]
        counted = [t for t in tensors if t is not None and (count_host or t.device.type != "cpu")]
        if counted:
            count("d2h_bytes", nbytes(*counted))
        if dev:
            allocs = _pinned_allocs()
            for i in dev:
                out[i] = torch.empty(tensors[i].shape, dtype=tensors[i].dtype,
                                     pin_memory=True).copy_(tensors[i], non_blocking=True)
            count("d2h_pinned_allocs", _pinned_allocs() - allocs)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(tensors[dev[0]].device))
            copied.synchronize()
        return out[0] if len(out) == 1 else tuple(out)


class Synthesizer:
    """End-to-end batched TTS: (text_ids, spk_emb) → waveforms.

    The models' parameters fix the device and compute dtype; inputs are moved
    there. A call returns its audio on the host, copied through page-locked
    memory at the call's end (:func:`host_audio`), and the mel and attention
    on the device; :meth:`device_call`, for callers that use the audio on the
    device (serving's PCM16 epilogue) or not at all, returns all three on the
    device. Stages are exposed separately (:attr:`decode`, :meth:`ssrn_apply`,
    :attr:`vocode`) so callers can time them. The text encoder and SSRN run
    the process-wide highway implementation, which
    ``spoofsv_torch.cli.main.apply_runtime_knobs(cfg, infer=True)`` sets from
    ``cfg.tpu.highway_infer_impl`` ("xla" by default). The decoder follows
    ``cfg.tpu.decode_impl`` (:func:`decode_route`), the vocoder the
    Griffin-Lim fields (:func:`gl_route`).

    ``mesh``: a :class:`~spoofsv_torch.parallel.mesh.Mesh` for data-parallel
    synthesis. Every rank calls with the same global batch; the modules are
    broadcast from rank 0 here; each rank runs its rows (:meth:`call_local`)
    and the outputs are all-gathered on the device, so every rank returns the
    global result (a call delivers the gathered audio to the host). A batch
    that does not divide the data axis is padded up to its multiple with
    copies of its last row, cut off again after the gather. The "random"
    init's seeds are drawn for the global batch (on rank 0, when the caller passes none) and
    sliced, so sharded audio is single-device audio row by row.
    """

    def __init__(self, cfg: Config, melsyn: MelSyn, ssrn: SSRN,
                 n_frames: Optional[int] = None, gl_iters: Optional[int] = None, mesh=None):
        self.cfg = cfg
        self.melsyn = melsyn.eval()
        self.ssrn = ssrn.eval()
        self.mesh = active(mesh)
        if self.mesh is not None:
            replicate_tree([self.melsyn, self.ssrn], self.mesh)
        self.n_frames = n_frames or cfg.max_frame_num
        self.device = next(melsyn.parameters()).device
        self.decode_route = decode_route(cfg)
        self.decode = (make_fused_decoder(self.melsyn, self.n_frames)
                       if self.decode_route == "kernel"
                       else make_decoder(self.melsyn, self.n_frames))
        self.vocode = make_vocoder(cfg, gl_iters)

    @torch.no_grad()
    def ssrn_apply(self, mel: torch.Tensor) -> torch.Tensor:
        with span("ssrn"):
            return self.ssrn(mel.to(next(self.ssrn.parameters()).dtype))

    @torch.no_grad()
    def call_local(self, text_ids, spk_emb, seeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The pipeline on this process's device alone, on the rows given."""
        with span("synth.call"):
            return self._pipeline(text_ids, spk_emb, seeds)

    def _pipeline(self, text_ids, spk_emb, seeds: Optional[torch.Tensor]):
        with span("synth.inputs"):
            text_ids = torch.as_tensor(text_ids)
            spk_emb = torch.as_tensor(spk_emb, dtype=torch.float32)
            count("h2d_bytes", nbytes(*(t for t in (text_ids, spk_emb, seeds)
                                        if t is not None and t.device.type == "cpu")))
            text_ids, spk_emb = text_ids.to(self.device), spk_emb.to(self.device)
            seeds = None if seeds is None else seeds.to(self.device)
        mel, attn, _ = self.decode(text_ids, spk_emb)
        audio = self.vocode(self.ssrn_apply(mel), seeds)
        return audio, mel, attn

    def _global_seeds(self, batch: int, seeds: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The "random" init's seeds for the global batch, rank 0's on every rank."""
        if seeds is None and self.cfg.tpu.griffin_lim_init == "random":
            seeds = self.mesh.broadcast_(gl_seeds(batch))
        return seeds

    def _sharded(self, fn, batch: int, seeds, *rows):
        """``fn`` on this rank's rows of the global batch (padded to the data
        axis's multiple), its outputs gathered and cut back to ``batch`` rows."""
        padded = -(-batch // self.mesh.size) * self.mesh.size
        seeds = self._global_seeds(batch, seeds)

        def mine(x) -> torch.Tensor:
            x = torch.as_tensor(x)
            if padded > batch:
                x = torch.cat([x, x[-1:].expand(padded - batch, *x.shape[1:])])
            return x[batch_sharding(self.mesh, padded)]

        out = fn(*(mine(r) for r in rows), None if seeds is None else mine(seeds))
        gather = lambda o: self.mesh.all_gather(o)[:batch]   # noqa: E731
        with span("synth.gather"):
            return tuple(gather(o) for o in out) if isinstance(out, tuple) else gather(out)

    @torch.no_grad()
    def mel_to_audio(self, mel: torch.Tensor, seeds: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """SSRN and the vocoder on a coarse mel (B, T, 80) → audio (B, L)."""
        def run(m, s):
            return self.vocode(self.ssrn_apply(m.to(self.device)),
                               None if s is None else s.to(self.device))

        if self.mesh is None:
            return run(torch.as_tensor(mel), seeds)
        return self._sharded(run, mel.shape[0], seeds, mel)

    def _device_outputs(self, text_ids, spk_emb, seeds: Optional[torch.Tensor]):
        if self.mesh is None:
            return self._pipeline(text_ids, spk_emb, seeds)
        return self._sharded(self._pipeline, len(text_ids), seeds, text_ids, spk_emb)

    @torch.no_grad()
    def device_call(self, text_ids, spk_emb, seeds: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(audio (B, L) f32, coarse mel (B, T, 80), attention (B, N, T)), all
        on the device."""
        with span("synth.call"):
            return self._device_outputs(text_ids, spk_emb, seeds)

    @torch.no_grad()
    def __call__(self, text_ids, spk_emb, seeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (audio (B, L) f32 on the host, through pinned memory; coarse
        mel (B, T, 80) and attention (B, N, T) on the device)."""
        with span("synth.call"):
            audio, mel, attn = self._device_outputs(text_ids, spk_emb, seeds)
            return host_audio(audio), mel, attn


class Tacotron2Synthesizer(Synthesizer):
    """End-to-end batched multi-speaker Tacotron 2: (text ids, d-vectors,
    seeds) → waveforms, through :class:`Synthesizer`'s call (its input
    handling, mesh split and :func:`host_audio`).

    ``text_ids`` (B, N) are NVIDIA symbol ids (``data.text.t2_encode_texts``),
    zero-padded on the right; ``spk_emb`` (B, S) the speakers' d-vectors.
    ``seeds`` (B,) int drive the prenet's inference dropout (and a "random"
    Griffin-Lim init): the same seeds give the same call. Without seeds a
    call draws them.

    Stages, instance attributes so that callers can time them:
    :meth:`encode` (span ``t2.encode``: memory and processed memory),
    :attr:`rollout` (span ``t2.rollout``: the decoder over ``n_frames``
    steps, every step run, its gate recorded not obeyed, its state kept every
    25 steps; counters ``t2_rollout_steps``, ``t2_graph_captures``),
    :meth:`postnet_apply` (span ``t2.postnet``), :attr:`vocode` (the mel through its basis's
    pseudo-inverse, span ``vocode.prep``, then the configured Griffin-Lim).
    A call returns (audio, postnet mel (B, T, n_mel) f32, attention (B, N,
    T) f32) and keeps the gate logits (B, T) as :attr:`gate`;
    :meth:`stop_frames` reads each row's length from them.
    """

    def __init__(self, cfg: Tacotron2Config, model, n_frames: Optional[int] = None,
                 gl_iters: Optional[int] = None, mesh=None):
        self.cfg = cfg
        self.model = model.eval()
        self.mesh = active(mesh)
        if self.mesh is not None:
            replicate_tree([self.model], self.mesh)
        self.n_frames = n_frames or cfg.max_decoder_steps
        self.device = next(model.parameters()).device
        self.rollout = Rollout(self.model, self.n_frames)
        self.vocode = make_vocoder(cfg, gl_iters, source="mel")
        self.gate: Optional[torch.Tensor] = None

    @torch.no_grad()
    def encode(self, text_ids: torch.Tensor, lengths: torch.Tensor, spk_emb: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("t2.encode"):
            return self.model.encode(text_ids, lengths, spk_emb)

    @torch.no_grad()
    def postnet_apply(self, mel: torch.Tensor) -> torch.Tensor:
        with span("t2.postnet"):
            return self.model.postnet_apply(mel)

    def _global_seeds(self, batch: int, seeds: Optional[torch.Tensor]) -> torch.Tensor:
        return self.mesh.broadcast_(gl_seeds(batch)) if seeds is None else seeds

    def _pipeline(self, text_ids, spk_emb, seeds: Optional[torch.Tensor]):
        with span("synth.inputs"):
            text_ids = torch.as_tensor(text_ids).long()
            spk_emb = torch.as_tensor(spk_emb, dtype=torch.float32)
            seeds = gl_seeds(len(text_ids)) if seeds is None else torch.as_tensor(seeds)
            lengths = (text_ids != 0).sum(1).cpu()
            count("h2d_bytes", nbytes(*(t for t in (text_ids, spk_emb, seeds)
                                        if t.device.type == "cpu")))
            text_ids, spk_emb = text_ids.to(self.device), spk_emb.to(self.device)
            seeds = seeds.to(self.device, torch.int32)
        memory, pm = self.encode(text_ids, lengths, spk_emb)
        with span("t2.rollout"):
            mel, gate, attn, _ = self.rollout(memory, pm, lengths, seeds)
        mel = self.postnet_apply(mel)
        return self.vocode(mel, seeds), mel, attn, gate

    def _device_outputs(self, text_ids, spk_emb, seeds: Optional[torch.Tensor]):
        audio, mel, attn, self.gate = super()._device_outputs(text_ids, spk_emb, seeds)
        return audio, mel, attn

    def stop_frames(self) -> torch.Tensor:
        """Each row of the last call's length in frames, on the host: up to and
        with the first step whose gate probability passes ``gate_threshold``
        (every step where none does)."""
        fired = (torch.sigmoid(self.gate.float()) > self.cfg.gate_threshold).cpu()
        return torch.where(fired.any(1), fired.float().argmax(1), fired.shape[1] - 1) + 1
