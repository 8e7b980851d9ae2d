"""Open-loop serving: the port's HTTP server under Poisson arrivals.

The server is built from the same objects as ``cli/serve.py::_serve``: a
``BatchingSynthesizer`` at the mix's batching settings (the CLI's defaults:
``max_batch`` 8, ``batch_wait_ms`` 10, one full-length frames bucket, trim
30 dB, WAV replies), warmed as the CLI warms it, behind
``make_http_server`` on 127.0.0.1 at a free port, with a ``SpeakerTable``
of the seed's speaker embeddings written as ``<name>.npy`` under
``TMPDIR``. The load generator (``serve_client.py``) is a child process: an
open loop at ``rate_per_s``, each request's text drawn uniformly from the
mix's sentences and its speaker from the table. Every seed sends the same
gaps between arrivals (drawn once from ``arrivals_seed``), rotated to
start elsewhere, so the bursts, and the work, do not move with the seed.

End to end, on the client's clock from each request's due time to the last
byte of its reply, over every request due in the window: ``serve_p50_ms``
and ``serve_p95_ms``; a request that failed or was refused counts as never
answered. ``correct``: a sample of the batches the server ran (drawn from
the seed) stage by stage against the reference, every row of them, and
each of their rows' replies, as the reference finalizes and encodes that
row's audio, found among the replies the client received for the row's
text and speaker (``reply_mismatch``, exact). As for any served model,
``correct`` judges the requests that finished; one that failed or was
refused counts in ``failed`` and in the latency, as never answered.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

from portbench import inputs, program
from portbench.traffic.bulk import FAULTS as BULK_FAULTS

CLIENT = Path(__file__).resolve().parent / "serve_client.py"


def arrival_gaps(rate: float, seconds: float, arrivals_seed: int) -> np.ndarray:
    """The gaps of a Poisson process of ``rate`` over ``seconds``, drawn from
    a stream of their own, normalized to end at ``seconds``."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(arrivals_seed).exponential(1.0 / rate, n)
    return gaps * (seconds / gaps.sum())


def schedule(seed: int, mix: dict, rate: float, seconds: float, names, texts):
    """[(due s, text, speaker)]: the mix's gaps, the same bursts for every
    seed, rotated to start at a point the seed draws; each request's text
    and speaker drawn from the seed."""
    rng = np.random.default_rng(inputs.stream(seed, "traffic"))
    gaps = np.roll(arrival_gaps(rate, seconds, mix["arrivals_seed"]),
                   -int(rng.integers(0, max(1, int(round(rate * seconds))))))
    due = np.cumsum(gaps) - gaps[0]
    t_i = rng.integers(0, len(texts), len(due))
    s_i = rng.integers(0, len(names), len(due))
    return [(float(d), texts[a], names[b]) for d, a, b in zip(due, t_i, s_i)]


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class Kind:
    def __init__(self, ctx, hooks):
        self.ctx = ctx
        self.hooks = hooks
        self.rate = ctx.mix["rate_per_s"]

    def setup(self) -> None:
        from spoofsv_torch.serve import BatchingSynthesizer, SpeakerTable, make_http_server

        ctx, mix = self.ctx, self.ctx.mix
        self.cfg, self.syn, sd_t2m, sd_ssrn = program.build_synthesizer(ctx.conf, ctx.seed,
                                                                        ctx.device)
        self.ref_t2m = {k: v.float() for k, v in sd_t2m.items()}
        self.ref_ssrn = {k: v.float() for k, v in sd_ssrn.items()}
        self.voc = program.vocoder_params(ctx.conf)
        self.names, table = inputs.speaker_table(ctx.seed)
        self.table = dict(zip(self.names, table))
        self.spk_dir = tempfile.mkdtemp(prefix="portbench_spk_")
        for name, emb in self.table.items():
            np.save(os.path.join(self.spk_dir, name + ".npy"), emb)
        self.texts = inputs.sentences(mix["sentences"])
        self.tap = program.StageTap(self.syn, ctx.tracer, False, self.hooks)
        if "finalize" in self.hooks:   # a test's fault in the replies' host tail
            import spoofsv_torch.serve as served

            finalize, alter = served.finalize_audio, self.hooks["finalize"]
            served.finalize_audio = lambda *a, **kw: alter(finalize(*a, **kw))
            self._restore = lambda: setattr(served, "finalize_audio", finalize)
        self.batcher = BatchingSynthesizer(
            self.cfg, self.syn, max_batch=mix["max_batch"], batch_wait_ms=mix["batch_wait_ms"],
            trim_db=mix["trim_db"], frames_buckets=None)
        self.batcher.warmup()
        self.httpd = make_http_server(self.batcher, SpeakerTable(self.spk_dir), host="127.0.0.1",
                                      port=0)
        self.port = self.httpd.server_address[1]
        self.server = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.server.start()
        self._warm_served_path()
        # the open loop's first seconds run slower than the rest (measured):
        # a stretch of the same traffic warms the server before the window
        self._drive(schedule(inputs.stream(ctx.seed, "sample"), mix, self.rate,
                             mix["warmup_seconds"], self.names, self.texts))
        self._sampler()

    def _warm_served_path(self) -> None:
        """The batcher's worker thread makes its first calls (and the
        library handles of that thread) before the window: 1, 2, 4, ...
        ``max_batch`` requests at once through the server."""
        from concurrent.futures import ThreadPoolExecutor

        body = json.dumps({"text": self.texts[0], "speaker": self.names[0]}).encode()

        def post(_):
            req = urllib.request.Request(f"http://127.0.0.1:{self.port}/synthesize", data=body,
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    r.read()
            except urllib.error.HTTPError as e:   # the window's replies judge the server
                e.read()

        n = 1
        with ThreadPoolExecutor(self.ctx.mix["max_batch"]) as pool:
            while n <= self.ctx.mix["max_batch"]:
                list(pool.map(post, range(n)))
                n *= 2

    def _sampler(self) -> None:
        """Keep a seeded sample of the batches the server runs (every stage's
        inputs and outputs), drawn as the vocoder stage of each ends."""
        rng = random.Random(inputs.stream(self.ctx.seed, "sample"))
        size = self.ctx.mix["sampled_batches"]
        self.sampled, self._seen = [], [0]
        seen = self._seen
        vocode = self.syn.vocode

        def sampling_vocode(lin, seeds=None):
            audio = vocode(lin, seeds)
            last = self.tap.last
            ids, spk = last["decode_in"]
            mel, att, _ = last["decode"]
            rec = {"ids": ids, "spk": spk, "mel": mel, "att": att, "lin": lin, "audio": audio,
                   "seeds": None if seeds is None else seeds.cpu()}
            seen[0] += 1
            if len(self.sampled) < size:
                self.sampled.append(rec)
            else:
                j = rng.randrange(seen[0])
                if j < size:
                    self.sampled[j] = rec
            return audio

        decode = self.syn.decode

        def recording_decode(text_ids, spk_emb, *a, **kw):
            self.tap.last["decode_in"] = (text_ids, spk_emb)
            return decode(text_ids, spk_emb, *a, **kw)

        self.syn.decode = recording_decode
        self.syn.vocode = sampling_vocode

    def _healthz(self) -> dict:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/healthz", timeout=30) as r:
            return json.loads(r.read())["stats"]

    def _drive(self, reqs, trace_seconds=None):
        """Run the load generator over ``reqs``; returns its records and the
        wall seconds from its start to its last reply."""
        child = subprocess.Popen([sys.executable, str(CLIENT), str(self.port)],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            span = max((r[0] for r in reqs), default=0.0)
            child.stdin.write(json.dumps({"requests": reqs, "timeout_s": span + 60.0}) + "\n")
            child.stdin.flush()
            if child.stdout.readline().strip() != "ready":
                raise RuntimeError("the load generator did not start")
            child.stdin.write("go\n")
            child.stdin.flush()
            t0 = time.perf_counter()
            if trace_seconds is not None:
                time.sleep(trace_seconds)
                self.ctx.tracer.stop()
            recs = []
            for line in child.stdout:
                rec = json.loads(line)
                if rec.get("end"):
                    break
                recs.append(rec)
            wall = time.perf_counter() - t0
            child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        return recs, wall

    def window(self) -> dict:
        ctx, mix = self.ctx, self.ctx.mix
        reqs = schedule(ctx.seed, mix, self.rate, ctx.seconds, self.names, self.texts)
        self.sampled.clear()
        self._seen[0] = 0
        before = self._healthz()
        recs, self.wall_s = self._drive(
            reqs, min(mix["trace_seconds"], ctx.seconds) if ctx.trace else None)
        after = self._healthz()
        self.stats = {k: after[k] - before[k] for k in ("n_requests", "n_batches",
                                                       "device_seconds", "n_errors",
                                                       "n_rejected")}
        self.stats["latency_ms_p95"] = after["latency_ms_p95"]
        self.recs, self.reqs = recs, reqs
        ok = [r for r in recs if r.get("status") == 200]
        lat = [1e3 * (r["done"] - r["due"]) if r.get("status") == 200 else float("inf")
               for r in recs]
        self.late_ms = max((1e3 * (r["sent"] - r["due"]) for r in recs), default=0.0)
        self.failed = len(recs) - len(ok) + (len(reqs) - len(recs))
        lat += [float("inf")] * (len(reqs) - len(recs))
        return {"serve_p50_ms": percentile(lat, 50), "serve_p95_ms": percentile(lat, 95)}

    def release(self) -> dict:
        import torch

        self.httpd.shutdown()
        self.httpd.server_close()
        self.server.join(timeout=30)
        self.batcher.close()
        shutil.rmtree(self.spk_dir, ignore_errors=True)
        getattr(self, "_restore", lambda: None)()
        del self.syn, self.tap, self.batcher, self.httpd
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"attempted": len(self.reqs), "failed": self.failed,
                "trace": {"serve": self.stats, "generator_late_ms": self.late_ms}}

    def _calls(self):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for rec in self.sampled:
            yield dict(rec, audio=rec["audio"].cpu().numpy(), audio_dev=rec["audio"])

    def check(self) -> dict:
        import torch

        from portbench.reference import compare, vocoder

        out = {}
        by_key = {}
        for r in self.recs:
            if r.get("status") == 200:
                req = self.reqs[r["i"]]
                by_key.setdefault((req[1], req[2]), []).append(r["sha256"])
        vocab = self.ctx.conf["config"]["VOCABULARY"]
        text_of = {tuple(inputs.encode([t], vocab, self.cfg.max_text_len)[0]): t
                   for t in self.texts}
        name_of = {emb.tobytes(): n for n, emb in self.table.items()}
        mismatch = 0
        with torch.no_grad():
            for call in self._calls():
                for k, v in compare.synthesis_readings(self.ref_t2m, self.ref_ssrn, self.voc,
                                                       call).items():
                    out[k] = max(out.get(k, 0.0), v)
                replies = vocoder.pcm16_wav_samples(call["audio_dev"], self.ctx.mix["trim_db"])
                for row, want in enumerate(replies):
                    key = (text_of.get(tuple(call["ids"][row].cpu().numpy())),
                           name_of.get(call["spk"][row].float().cpu().numpy().tobytes()))
                    digest = hashlib.sha256(want.astype("<i2").tobytes()).hexdigest()
                    mismatch += digest not in by_key.get(key, [])
        out["reply_mismatch"] = float(mismatch)
        out["requests_failed"] = float(self.failed)
        out["sampled_batches"] = float(len(self.sampled))
        return out

    def control(self) -> dict:
        import torch

        from portbench.reference import compare

        ctl, out = self.ctx.conf["control"], {}
        with torch.no_grad():
            for call in self._calls():
                for k, v in compare.control_readings(self.ref_t2m, self.ref_ssrn, self.voc, call,
                                                     ctl["model"], ctl["vocoder"]).items():
                    out[k] = max(out.get(k, 0.0), v)
        return out


def _altered_reply(y):
    """One answer altered where it is produced: a sample of a reply."""
    y = y.copy()
    y[len(y) // 2] = -y[len(y) // 2] if y[len(y) // 2] else 0.5
    return y


FAULTS = {"half_batch": BULK_FAULTS["half_batch"], "stale_state": BULK_FAULTS["stale_state"],
          "altered_frame": BULK_FAULTS["altered_frame"],
          "altered_audio": BULK_FAULTS["altered_audio"], "altered_reply": {"finalize": _altered_reply}}
