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
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.models.ssrn import SSRN
from spoofsv_torch.models.text2mel import MelSyn
from spoofsv_torch.infer.decode import make_decoder
from spoofsv_torch.ops.decode_kernel import make_fused_decoder
from spoofsv_torch.ops.gl_kernel import griffin_lim_fused, griffin_lim_tc, init_angles_plain
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


def make_vocoder(cfg: Config, n_iter: Optional[int] = None):
    """``vocode(lin_mag (B, T, F), seeds=None) -> audio (B, hop·(T−1))``.

    Per-utterance peak renorm (non-log mode), power ``(·)^(1.3/0.6)``,
    Griffin-Lim from ``cfg.tpu.griffin_lim_init`` (random hash init uses
    ``seeds``, (B,) int) on the route :func:`gl_route` picks for the
    tensor's device, and de-emphasis.
    """
    n_iter = n_iter or cfg.tpu.griffin_lim_iters
    n_fft, hop = cfg.stft.fft_length, cfg.stft.hop_length
    power = cfg.norm.reconstruction_power / cfg.norm.analysis_power
    init_mode = cfg.tpu.griffin_lim_init
    gl_route(cfg, "cpu")   # unknown values raise here, not at the first call

    @torch.no_grad()
    def vocode(lin_pred: torch.Tensor, seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("vocode.prep"):
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


def to_host(*tensors: Optional[torch.Tensor]) -> tuple:
    """The tensors as host numpy arrays (None stays None), copied in the
    span ``synth.to_host`` with their bytes on the ``d2h_bytes`` counter."""
    with span("synth.to_host"):
        count("d2h_bytes", nbytes(*tensors))
        return tuple(None if t is None else t.cpu().numpy() for t in tensors)


def _pinned_allocs() -> int:
    """Blocks the caching host allocator has pinned in this process so far."""
    return int(torch.cuda.host_memory_stats()["num_host_alloc"])


def host_audio(audio: torch.Tensor) -> torch.Tensor:
    """``audio`` on the host, in the span ``synth.to_host``.

    A device tensor is copied into a block of page-locked memory from torch's
    caching host allocator, on the current stream, and the host waits on that
    copy alone; its bytes go on ``d2h_bytes``, and ``d2h_pinned_allocs``
    counts the copies for which the allocator pinned a new block instead of
    reusing a free one. The block is the caller's: the allocator hands it out
    again only after the last reference to the result is gone, so a result
    held across later calls is never overwritten. A host tensor is returned
    as it is."""
    with span("synth.to_host"):
        if audio.device.type == "cpu":
            return audio
        count("d2h_bytes", nbytes(audio))
        allocs = _pinned_allocs()
        host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
        count("d2h_pinned_allocs", _pinned_allocs() - allocs)
        host.copy_(audio, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(audio.device))
        copied.synchronize()
        return host


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
