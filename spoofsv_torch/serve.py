"""Synthesis serving: a micro-batching TTS server on one CUDA device or over ranks.

Port of :mod:`spoofsv_tpu.serve`: an HTTP front-end over a micro-batching
scheduler that aggregates concurrent requests into batches for the
decode → SSRN → Griffin-Lim pipeline
(:class:`spoofsv_torch.infer.synthesize.Synthesizer`: K1, K2 and K3 on a
card, their plain versions for CPU models).

* **Fixed shapes**: text is always padded to ``cfg.max_text_len`` and the
  batch up to the next rung of a power-of-two ladder (1, 2, 4, …,
  ``max_batch``), so the kernels see at most ``log2(max_batch)+1`` batch
  sizes a rollout length, all of which :meth:`BatchingSynthesizer.warmup`
  runs before traffic arrives. Batch padding rows repeat a real row.
* **Micro-batching**: requests are aggregated until ``max_batch`` or
  ``batch_wait_ms`` after the first queued request.
* **One device thread**: every tensor operation runs in the worker thread;
  the HTTP threads only validate and enqueue. A failure in the worker (a
  kernel error included) reaches each request of its batch as an error.
* **Batch invariance, and its limit on a card**: the decode kernel's rows
  are independent, and with the deterministic Griffin-Lim inits ("spsi",
  "advance") nothing else mixes the rows of a batch; under "random" the
  per-batch GL seeds make audio batch-dependent. But cuDNN chooses its
  convolution algorithm by batch size, so a request's K and V can differ
  between ladder rungs by bf16 roundings (up to 0.047 between B=1 and B=8
  on an H100 with random weights; bit-equal with cuDNN off), and the decode's
  attention can then take another path. On a card in bf16 a request's
  audio depends on the rung it runs at, not on its neighbours' content.
* **Data-parallel serving**: with a synthesizer over a mesh of several
  ranks, rank 0 runs the HTTP front end and the batcher; every batch it
  runs is announced to the other ranks first (frames, padded rows, text,
  speaker, seeds, one ``broadcast_object``), which run the same sharded
  call in :func:`serve_follower` until rank 0's :meth:`BatchingSynthesizer.close`
  tells them to stop. The ladder's base rung is the rank count and every
  rung a multiple of it.
* **No extra dependencies**: the HTTP layer is stdlib
  ``http.server.ThreadingHTTPServer``; audio is returned as RIFF/WAV bytes
  (16-bit PCM) or JSON float samples.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.data.text import encode_texts
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.infer.synthesize import Synthesizer, finalize_audio, gl_seeds, to_host
from spoofsv_torch.utils.profiling import snapshot, span


class BadRequest(ValueError):
    """Client-input error (wrong types/dims/lengths): HTTP 400, never 500."""


class ServerOverloaded(RuntimeError):
    """The request queue is full: HTTP 503 with ``Retry-After``.

    Raised by :meth:`BatchingSynthesizer.synthesize` when admission would
    push the queue past ``max_queue``: shedding load at the door keeps the
    latency of admitted requests bounded."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed before it reached the device: HTTP 504.
    The worker fails expired requests at batch-assembly time instead of
    synthesizing audio the caller has already given up on."""


def wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    """Encode a float waveform as 16-bit PCM RIFF/WAV bytes (in memory)."""
    buf = io.BytesIO()
    dsp_host.write_wav(buf, audio, sr)
    return buf.getvalue()


class SpeakerTable:
    """Named speaker-embedding lookup over the reference's ``spk_emb/``
    layout (one 200-dim ``<name>.npy`` per speaker)."""

    def __init__(self, spk_emb_dir: str):
        self.dir = spk_emb_dir
        self._cache: Dict[str, np.ndarray] = {}

    def names(self) -> List[str]:
        if not self.dir or not os.path.isdir(self.dir):
            return []
        return sorted(f[:-4] for f in os.listdir(self.dir) if f.endswith(".npy"))

    def __call__(self, name: str) -> np.ndarray:
        if name not in self._cache:
            path = os.path.join(self.dir, name + ".npy")
            if not os.path.isfile(path):
                raise KeyError(f"unknown speaker {name!r}")
            self._cache[name] = np.load(path).astype(np.float32).reshape(-1)
        return self._cache[name]


@dataclass
class _Pending:
    text_ids: np.ndarray           # (N,) int32, already padded to max_text_len
    spk_emb: np.ndarray            # (spk_emb_dim,) f32
    frames: int = 0                # assigned frames bucket (0 = max)
    t_enq: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event)
    audio: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    # set by the enqueuing thread when its wait times out: the worker then
    # skips the request instead of spending device time on it
    abandoned: bool = False
    # absolute perf_counter() deadline; the worker completes requests already
    # past it with DeadlineExceeded at batch-assembly time
    deadline: Optional[float] = None
    # number of non-pad text ids: the completion checks compare the decode's
    # attended position against it
    n_valid: int = 0


@dataclass
class ServeStats:
    n_requests: int = 0
    n_batches: int = 0
    n_errors: int = 0
    n_rejected: int = 0            # shed at admission (queue full → 503)
    n_abandoned: int = 0           # client timed out before the batch ran
    n_expired: int = 0             # deadline passed while queued → 504
    n_escalated: int = 0           # speculative rollout too short, retried
    max_batch_seen: int = 0
    audio_seconds: float = 0.0
    device_seconds: float = 0.0    # host seconds in the serve.device_call spans
    latencies_ms: List[float] = field(default_factory=list)  # bounded

    def as_dict(self) -> dict:
        lat = sorted(self.latencies_ms)

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 1) if lat else None

        return {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "n_errors": self.n_errors,
            "n_rejected": self.n_rejected,
            "n_abandoned": self.n_abandoned,
            "n_expired": self.n_expired,
            "n_escalated": self.n_escalated,
            "mean_batch": round(self.n_requests / self.n_batches, 2) if self.n_batches else None,
            "max_batch_seen": self.max_batch_seen,
            "audio_seconds": round(self.audio_seconds, 1),
            "device_seconds": round(self.device_seconds, 2),
            "realtime_factor": round(self.audio_seconds / self.device_seconds, 1)
            if self.device_seconds > 0 else None,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
        }


@torch.no_grad()
def pcm16(audio: torch.Tensor) -> torch.Tensor:
    """(B, L) float audio → int16 PCM on the audio's device, scaled by each
    row's |max| to ±0.75. Range protection only: the reference's signed-max
    peak normalization runs on the host over the final trim/cap window
    (:func:`finalize_audio`). ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    peak = audio.abs().amax(dim=1, keepdim=True)
    y = audio / peak.clamp_min(1e-8) * 0.75
    return torch.round(y.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


class BatchingSynthesizer:
    """Thread-safe micro-batching front of a :class:`Synthesizer`.

    ``synthesize()`` may be called from any number of threads; one worker
    thread drains the queue, aggregates up to ``max_batch`` requests
    (waiting at most ``batch_wait_ms`` after the first), pads the batch up
    the power-of-two ladder, runs the pipeline once, and completes each
    request with its trimmed, peak-normalized waveform.

    Every tensor operation runs in the worker thread (and in :meth:`warmup`
    on the caller's), on that thread's current stream, under
    ``torch.no_grad()``. The highway switch
    (``spoofsv_torch.models.layers.gate_impl``) is process-wide: do not
    change it while the worker runs.
    """

    def __init__(self, cfg: Config, synthesizer: Synthesizer,
                 max_batch: int = 8, batch_wait_ms: float = 10.0,
                 trim_db: Optional[float] = 30.0,
                 max_seconds: Optional[float] = None,
                 device_pcm: Optional[bool] = None,
                 frames_buckets: Optional[List[int]] = None,
                 frames_per_char: float = 3.0,
                 min_frames: int = 96,
                 max_queue: Optional[int] = None,
                 speculative: bool = False,
                 spec_margin: int = 1,
                 attn_trim: Optional[int] = None):
        """``frames_buckets``: optional ascending rollout-length ladder (each
        entry ≤ the synthesizer's ``n_frames``): a request decodes the
        smallest bucket holding ``frames_per_char · len(text)`` (at least
        ``min_frames``) instead of the full rollout. None: one full-length
        bucket, the reference's behaviour.

        ``max_queue``: at most this many requests may wait for a batch;
        further ``synthesize()`` calls raise :class:`ServerOverloaded`
        (HTTP 503). Default ``16 * max_batch``; ``0`` is unbounded.

        ``speculative``: after each batch of a bucket below the largest, the
        worker reads the decode's last attended text position (monotonic
        attention: the furthest reached) and re-enqueues each request whose
        decode did not reach its text's end (within ``spec_margin`` ids)
        into the next bucket up, instead of returning truncated speech.
        Escalations count in ``n_escalated``.

        ``attn_trim``: attention-gated end trim (a pad in decoder frames):
        each waveform is cut ``attn_trim`` frames after its completion frame
        (the first whose attended position reaches the text's end) before
        the host trim, cap and normalize; a decode that never completes
        keeps its full rollout.

        ``device_pcm``: quantize to int16 on the device and fetch 2-byte
        samples (default: on unless ``cfg.norm.log_feature``)."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.cfg = cfg
        self.syn = synthesizer
        self.max_batch = max_batch
        mf = synthesizer.n_frames
        if frames_buckets:
            fb = sorted(set(min(int(b), mf) for b in frames_buckets))
            if fb[-1] != mf:
                fb.append(mf)
        else:
            fb = [mf]
        self.frames_buckets = fb
        self.frames_per_char = frames_per_char
        self.min_frames = min_frames
        self.speculative = speculative and len(fb) > 1
        self.spec_margin = spec_margin
        if attn_trim is not None and attn_trim < 0:
            raise ValueError(f"attn_trim must be >= 0, got {attn_trim}")
        self.attn_trim = attn_trim
        self._syn_by_frames = {mf: synthesizer}
        self.batch_wait_s = batch_wait_ms / 1e3
        self.trim_db = trim_db
        self.max_seconds = max_seconds
        self.device_pcm = (not cfg.norm.log_feature) if device_pcm is None \
            else (device_pcm and not cfg.norm.log_feature)
        self.stats = ServeStats()
        self._stats_lock = threading.Lock()
        self.max_queue = 16 * max_batch if max_queue is None else max_queue
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._batch_counter = 0
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="spoofsv-serve-batcher")
        self._worker.start()

    # ----------------------------------------------------------- public API
    def synthesize(self, text: str, spk_emb: np.ndarray,
                   timeout: Optional[float] = None,
                   deadline_s: Optional[float] = None) -> np.ndarray:
        """Encode and enqueue one utterance; block until its audio is ready.

        ``timeout`` bounds this caller's wait (on expiry the request is
        marked abandoned and the worker skips it). ``deadline_s`` is the
        server-side deadline: if it passes while the request is queued, the
        worker completes it with :class:`DeadlineExceeded`; a batch already
        on the device always finishes. A non-positive deadline fails at the
        door without queue side effects."""
        if self._closed:
            raise RuntimeError("server is shut down")
        if deadline_s is not None and deadline_s <= 0:
            with self._stats_lock:
                self.stats.n_expired += 1
            raise DeadlineExceeded(f"deadline_s={deadline_s} already expired")
        if not isinstance(text, str):
            raise BadRequest(f"text must be a string, got {type(text).__name__}")
        # encode unbounded first: truncating (and dropping the EOS the
        # attention ends on) would return audio of a prefix with 200
        raw = encode_texts([text], self.cfg.vocabulary)[0]
        if len(raw) > self.cfg.max_text_len:
            raise BadRequest(
                f"text encodes to {len(raw)} ids; the limit is "
                f"MAX_TEXT_LEN={self.cfg.max_text_len} (reference config.json MAX_TEXT_LEN)")
        ids = encode_texts([text], self.cfg.vocabulary, max_len=self.cfg.max_text_len)[0]
        try:
            spk = np.asarray(spk_emb, np.float32).reshape(-1)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"spk_emb is not a float vector: {e}") from e
        if spk.shape[0] != self.cfg.spk_emb_dim:
            raise BadRequest(f"spk_emb must have dim {self.cfg.spk_emb_dim}, got {spk.shape[0]}")
        n_valid = int((ids > 0).sum())
        req = _Pending(text_ids=ids, spk_emb=spk, frames=self._frames_bucket(n_valid),
                       n_valid=n_valid,
                       deadline=None if deadline_s is None else time.perf_counter() + deadline_s)
        # admission control (qsize is approximate under concurrency: the
        # bound keeps the backlog O(max_queue), not exact)
        if self.max_queue and self._q.qsize() >= self.max_queue:
            with self._stats_lock:
                self.stats.n_rejected += 1
            raise ServerOverloaded(f"request queue full ({self.max_queue} pending)",
                                   retry_after_s=self._retry_after_s())
        self._q.put(req)
        if not req.done.wait(timeout):
            req.abandoned = True   # the worker skips it if not yet batched
            raise TimeoutError("synthesis timed out")
        if req.error is not None:
            raise req.error
        return req.audio

    def warmup(self, buckets: Optional[List[int]] = None) -> None:
        """Run every (batch rung × frames bucket) once on the calling thread,
        with the PCM epilogue: the kernels are built and loaded here, not in
        the worker, and each bucket's weights are packed before traffic."""
        for frames in self.frames_buckets:
            for b in buckets or self._ladder():
                text = np.zeros((b, self.cfg.max_text_len), np.int32)
                text[:, 0] = 1
                spk = np.zeros((b, self.cfg.spk_emb_dim), np.float32)
                audio, _, _ = self._call(frames, text, spk,
                                         gl_seeds(b, torch.Generator().manual_seed(0)))
                (pcm16(audio) if self.device_pcm else audio)[:1, :8].cpu()

    def close(self) -> None:
        """Stop the worker and fail every still-queued request.

        The ``_closed`` check in ``synthesize`` is advisory (a request can be
        enqueued concurrently with the sentinel), so after the worker exits
        the queue is drained and the stragglers completed with an error."""
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout=30)
        if self.syn.mesh is not None:
            self.syn.mesh.broadcast_object(("stop",))   # end the followers' loops
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.done.is_set():
                req.error = RuntimeError("server is shut down")
                req.done.set()

    def stats_dict(self) -> dict:
        with self._stats_lock:
            return self.stats.as_dict()

    # ------------------------------------------------------------ internals
    def _retry_after_s(self) -> float:
        """Backlog-proportional retry hint: queued batches × mean batch
        latency (1 s floor, before any batch has completed)."""
        s = self.stats
        if s.n_batches == 0 or s.device_seconds <= 0:
            return 1.0
        per_batch = s.device_seconds / s.n_batches
        return max(1.0, round(self._q.qsize() / self.max_batch * per_batch, 1))

    def _frames_bucket(self, n_chars: int) -> int:
        est = max(self.min_frames, int(np.ceil(self.frames_per_char * n_chars)))
        for b in self.frames_buckets:
            if est <= b:
                return b
        return self.frames_buckets[-1]

    def _syn_for(self, frames: int) -> Synthesizer:
        return _syn_for(self._syn_by_frames, self.cfg, self.syn, frames)

    def _call(self, frames: int, text: np.ndarray, spk: np.ndarray, seeds: torch.Tensor):
        """One synthesizer call; over a mesh, announced to the followers first."""
        if self.syn.mesh is not None:
            self.syn.mesh.broadcast_object(("call", frames, text, spk, seeds.numpy()))
        return self._syn_for(frames)(text, spk, seeds)

    def _ladder(self) -> List[int]:
        # over a mesh every batch must divide the rank count, so the base
        # rung is the rank count and every rung a multiple of it
        base = 1 if self.syn.mesh is None else self.syn.mesh.size
        out, b = [], base
        top = max(self.max_batch, base)
        while b < top:
            out.append(b)
            b *= 2
        return out + [-(-top // base) * base]

    def _bucket(self, n: int) -> int:
        for b in self._ladder():
            if n <= b:
                return b
        return self.max_batch

    def _collect(self) -> Optional[List[_Pending]]:
        """Block for the first request, then aggregate for batch_wait_s (the
        span ``serve.collect``)."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        with span("serve.collect"):
            deadline = time.perf_counter() + self.batch_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)   # re-post the shutdown sentinel
                    break
                batch.append(nxt)
        return batch

    def _run(self) -> None:
        if self.syn.device.type == "cuda":
            torch.cuda.set_device(self.syn.device)   # the current device is per thread
        while True:
            collected = self._collect()
            if collected is None:
                return
            # skip requests whose client already gave up
            live = [r for r in collected if not r.abandoned]
            if len(live) < len(collected):
                with self._stats_lock:
                    self.stats.n_abandoned += len(collected) - len(live)
            # requests whose deadline passed while queued fail fast (504);
            # anything admitted into a batch below runs to completion
            now = time.perf_counter()
            expired = [r for r in live if r.deadline and r.deadline < now]
            if expired:
                for r in expired:
                    r.error = DeadlineExceeded(
                        f"deadline passed {now - r.deadline:.2f}s before the request "
                        "reached the device")
                    r.done.set()
                with self._stats_lock:
                    self.stats.n_expired += len(expired)
                dead = set(map(id, expired))
                live = [r for r in live if id(r) not in dead]
            # one rollout length per group
            groups: Dict[int, List[_Pending]] = {}
            for r in live:
                groups.setdefault(r.frames or self.frames_buckets[-1], []).append(r)

            # groups of one collection run in turn: earliest deadline first,
            # deadlineless groups shortest rollout first
            def _urgency(frames: int):
                return (min((r.deadline for r in groups[frames] if r.deadline),
                            default=float("inf")), frames)

            for frames in sorted(groups, key=_urgency):
                self._process(groups[frames], frames)

    @torch.no_grad()
    def _device_call(self, batch: List[_Pending], frames: int, bsz: int):
        """Run the padded batch; returns host arrays (audio, completed at the
        last frame or None, kept frames or None). The completion checks run
        on the device; the results come back in one ``synth.to_host``."""
        n = len(batch)
        text = np.stack([r.text_ids for r in batch] + [batch[0].text_ids] * (bsz - n))
        spk = np.stack([r.spk_emb for r in batch] + [batch[0].spk_emb] * (bsz - n))
        seeds = gl_seeds(bsz, torch.Generator().manual_seed(self._batch_counter))
        audio, _, attn = self._call(frames, text, spk, seeds)
        audio = pcm16(audio[:n]) if self.device_pcm else audio[:n]
        last = keep = None
        want_check = self.speculative and frames < self.frames_buckets[-1]
        if want_check or self.attn_trim is not None:
            # monotonic attention: done[i, f] = request i's decode had reached
            # its text's end (within spec_margin ids) by frame f
            targets = torch.tensor([r.n_valid - 1 - self.spec_margin for r in batch],
                                   device=attn.device)
            done = attn[:n].argmax(dim=1) >= targets[:, None]
            if want_check:
                last = done[:, -1]
            if self.attn_trim is not None:
                first = done.to(torch.int32).argmax(dim=1) + 1 + self.attn_trim
                keep = first.masked_fill(~done.any(dim=1), done.shape[1])
        return to_host(audio, last, keep)

    def _process(self, batch: List[_Pending], frames: int) -> None:
        n = len(batch)
        bsz = self._bucket(n)
        self._batch_counter += 1
        bid = self._batch_counter
        try:
            with span("serve.device_call", batch=bid, rows=n, rung=bsz) as call:
                audio, last, keep = self._device_call(batch, frames, bsz)
        except Exception as e:  # noqa: BLE001 - forwarded to each request
            with self._stats_lock:
                self.stats.n_errors += n
            for r in batch:
                r.error = e
                r.done.set()
            return
        # not at the text's end by the last frame: this rollout cut the
        # decode off, so retry one bucket up
        escalate = set() if last is None else {i for i in range(n) if not last[i]}
        if escalate:
            nxt = next(b for b in self.frames_buckets if b > frames)
            for i in sorted(escalate):
                batch[i].frames = nxt
                self._q.put(batch[i])   # already admitted: bypasses max_queue
            with self._stats_lock:
                self.stats.n_escalated += len(escalate)
        now = time.perf_counter()
        with span("serve.finalize", batch=bid):
            for i, r in enumerate(batch):
                if i in escalate:
                    continue
                try:
                    raw = audio[i]
                    if keep is not None:
                        # cut at the completion frame (+pad) before the host trim
                        raw = raw[: int(keep[i]) * (raw.shape[-1] // frames)]
                    if self.device_pcm:
                        raw = raw.astype(np.float32) / 32767.0
                    y = finalize_audio(raw, self.cfg, trim_db=self.trim_db,
                                       max_seconds=self.max_seconds)
                    if not np.all(np.isfinite(y)):
                        raise ValueError("synthesis produced non-finite audio")
                    r.audio = y
                except Exception as e:  # noqa: BLE001 - forwarded to the request
                    r.error = e
        with self._stats_lock:
            s = self.stats
            # escalated requests are counted when their retry completes
            s.n_requests += n - len(escalate)
            s.n_batches += 1
            s.max_batch_seen = max(s.max_batch_seen, n)
            s.audio_seconds += sum(len(r.audio) for r in batch
                                   if r.audio is not None) / self.cfg.sampling_rate
            s.device_seconds += call.seconds
            s.latencies_ms.extend((now - r.t_enq) * 1e3 for i, r in enumerate(batch)
                                  if i not in escalate)
            del s.latencies_ms[:-1000]   # bound the window
        # released after the stats count them: a caller's reply is in /healthz
        for i, r in enumerate(batch):
            if i not in escalate:
                r.done.set()


def _syn_for(cache: Dict[int, Synthesizer], cfg: Config, base: Synthesizer,
             frames: int) -> Synthesizer:
    """The pipeline of ``base``'s models (and mesh) for a rollout of ``frames``."""
    if frames not in cache:
        cache[frames] = Synthesizer(cfg, base.melsyn, base.ssrn, n_frames=frames, mesh=base.mesh)
    return cache[frames]


def serve_follower(cfg: Config, synthesizer: Synthesizer) -> int:
    """Rank r > 0 of data-parallel serving: run each call rank 0's batcher
    announces, with ``synthesizer``'s models over its mesh, until rank 0
    says stop; returns the number of calls run."""
    cache = {synthesizer.n_frames: synthesizer}
    calls = 0
    while True:
        msg = synthesizer.mesh.broadcast_object()
        if msg[0] == "stop":
            return calls
        _, frames, text, spk, seeds = msg
        _syn_for(cache, cfg, synthesizer, frames)(text, spk, torch.from_numpy(seeds))
        calls += 1


#: POST body admission cap: a /synthesize request is a short text plus at
#: most a spk_emb vector (~200 floats, ~4 kB as JSON); 1 MB is generous.
MAX_BODY_BYTES = 1 << 20


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 resets connections when a burst of
    # clients connects while the accept loop waits for the interpreter (32
    # at once did); shedding load is the admission bound's job (503)
    request_queue_size = 128


def make_http_server(batcher: BatchingSynthesizer, speakers: SpeakerTable,
                     host: str = "127.0.0.1", port: int = 0,
                     request_timeout: float = 600.0) -> ThreadingHTTPServer:
    """HTTP front-end. Endpoints:

    * ``POST /synthesize``: JSON body ``{"text": "...", "speaker": "p225"}``
      or ``{"text": "...", "spk_emb": [200 floats]}``; optional
      ``"format": "wav" | "json"`` (default wav) and ``"deadline_ms": N``
      (requests that expire while queued return 504 without device time).
      Returns ``audio/wav`` bytes, or ``{"sr": ..., "samples": [...]}``.
    * ``GET /speakers``: available speaker names.
    * ``GET /healthz``: liveness, serving stats and the program's spans and
      counters (:func:`spoofsv_torch.utils.profiling.snapshot`).

    A request's spans: ``serve.parse``, ``serve.wait`` (blocked in
    :meth:`BatchingSynthesizer.synthesize`), ``serve.encode`` (WAV or JSON)
    and ``serve.send``.
    """
    cfg = batcher.cfg

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet access log
            pass

        def _send(self, code: int, kind: str, body: bytes,
                  headers: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj: dict, headers: Optional[dict] = None) -> None:
            self._send(code, "application/json", json.dumps(obj).encode(), headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "stats": batcher.stats_dict(),
                                 "trace": snapshot()})
            elif self.path == "/speakers":
                self._json(200, {"speakers": speakers.names()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/synthesize":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length < 0:   # rfile.read(-1) would block until EOF
                    raise ValueError
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return
            if length > MAX_BODY_BYTES:
                # discard the body in bounded chunks so the client can read
                # the 413 instead of a reset; beyond the drain bound, close
                remaining = min(length, 8 * MAX_BODY_BYTES)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 65536))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.close_connection = True
                self._json(413, {"error": f"request body {length} B exceeds the "
                                          f"{MAX_BODY_BYTES} B limit"})
                return
            try:
                with span("serve.parse"):
                    req = json.loads(self.rfile.read(length) or b"{}")
                    text = req["text"]
                    if "spk_emb" in req:
                        spk = np.asarray(req["spk_emb"], np.float32)
                    else:
                        spk = speakers(req["speaker"])
                    deadline_s = (float(req["deadline_ms"]) / 1e3 if "deadline_ms" in req
                                  else None)
            except Exception as e:  # noqa: BLE001 - malformed request body
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                with span("serve.wait"):
                    audio = batcher.synthesize(text, spk, timeout=request_timeout,
                                               deadline_s=deadline_s)
            except BadRequest as e:
                self._json(400, {"error": str(e)})
                return
            except DeadlineExceeded as e:
                self._json(504, {"error": str(e)})
                return
            except ServerOverloaded as e:
                self._json(503, {"error": str(e)},
                           headers={"Retry-After": str(int(np.ceil(e.retry_after_s)))})
                return
            except Exception as e:  # noqa: BLE001 - report, don't crash
                self._json(500, {"error": str(e)})
                return
            with span("serve.encode"):
                if req.get("format", "wav") == "json":
                    kind = "application/json"
                    body = json.dumps({"sr": cfg.sampling_rate, "samples": np.asarray(
                        audio, np.float64).round(6).tolist()}).encode()
                else:
                    kind, body = "audio/wav", wav_bytes(audio, cfg.sampling_rate)
            with span("serve.send"):
                self._send(200, kind, body)

    return _Server((host, port), Handler)
