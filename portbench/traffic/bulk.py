"""Bulk synthesis, as a spoof-set job runs it: back-to-back calls of
``Synthesizer.__call__``, each of ``speakers_per_call`` speakers drawn from
the speaker table times the first ``sentences`` Harvard sentences (the
rows of ``spoofkit/spoofgen.py::generate_spoof_set``'s call), the text
padded to the call's longest sentence, each call's audio brought to the
host with ``.cpu()``.

Every seed makes the same calls in another order: the speaker table is
shuffled and cut into calls of ``speakers_per_call``, an epoch after
another. End to end: ``synth_audio_s_per_s``, the audio seconds of every
call that finished over the wall seconds from the window's start to the
end of its last call (the last call started before ``--seconds`` ran out).
``correct`` compares one call of the window, drawn from the seed, every
row of it, stage by stage (``reference/compare.py``).
"""

from __future__ import annotations

import random
import time

import numpy as np

from portbench import inputs, program, work


class Kind:
    def __init__(self, ctx, hooks):
        self.ctx = ctx
        self.hooks = hooks

    # ---- set-up -----------------------------------------------------------------
    def setup(self) -> None:
        import torch

        ctx, mix = self.ctx, self.ctx.mix
        _, self.syn, sd_t2m, sd_ssrn = program.build_synthesizer(ctx.conf, ctx.seed, ctx.device)
        # the reference reads the same values in float32
        self.ref_t2m = {k: v.float() for k, v in sd_t2m.items()}
        self.ref_ssrn = {k: v.float() for k, v in sd_ssrn.items()}
        self.voc = program.vocoder_params(ctx.conf)
        names, table = inputs.speaker_table(ctx.seed)
        self.table = table
        k, n = mix["speakers_per_call"], mix["sentences"]
        self.text = np.tile(inputs.encode(inputs.sentences(n), ctx.conf["config"]["VOCABULARY"]),
                            (k, 1))
        rng = np.random.default_rng(inputs.stream(ctx.seed, "traffic"))
        self.rng = rng
        self.order: list = []
        self.tap = program.StageTap(self.syn, ctx.tracer, ctx.trace and ctx.device.type == "cuda",
                                    self.hooks)
        for _ in range(mix["warmup_calls"]):
            self.syn(*self._next_call())[0].cpu()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        self.tap.events = {name: [] for name in self.tap.events}   # the window's calls only

    def _next_call(self):
        """(text ids, speaker embeddings, Griffin-Lim seeds) of the next call."""
        import torch

        k, n = self.ctx.mix["speakers_per_call"], self.ctx.mix["sentences"]
        if len(self.order) < k:
            self.order = list(self.rng.permutation(len(self.table)))
        spk_ids, self.order = self.order[:k], self.order[k:]
        spk = np.repeat(self.table[spk_ids], n, axis=0)
        seeds = torch.from_numpy(self.rng.integers(0, 2 ** 31 - 1, k * n, dtype=np.int64)
                                 .astype(np.int32))
        return self.text, spk, seeds

    # ---- the window -----------------------------------------------------------------
    def window(self) -> dict:
        ctx = self.ctx
        keep_rng = random.Random(inputs.stream(ctx.seed, "sample"))
        sr = self.voc["sr"]
        calls, audio_s, self.kept, self.calls_traced = 0, 0.0, None, None
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while True:
            text, spk, seeds = self._next_call()
            with ctx.tracer.span("call"):
                audio, mel, att = self.syn(text, spk, seeds)
                with ctx.tracer.span("to_host"):
                    host = audio.cpu()
            calls += 1
            audio_s += host.numel() / sr
            if keep_rng.random() * calls < 1.0:   # a uniform draw over the calls
                self.kept = {"ids": text, "spk": spk, "seeds": seeds, "mel": mel, "att": att,
                             "lin": self.tap.last["ssrn"], "audio": host.numpy()}
            now = time.perf_counter()
            if ctx.trace and self.calls_traced is None and now >= t0 + ctx.mix["trace_seconds"]:
                ctx.tracer.stop()
                self.calls_traced = calls
            if now >= deadline:
                break
        self.wall_s = time.perf_counter() - t0
        self.calls = calls
        return {"synth_audio_s_per_s": audio_s / self.wall_s}

    # ---- after the window ----------------------------------------------------------
    def release(self) -> dict:
        import torch

        stage_ms = self.tap.stage_ms() if self.tap.timed else {}
        B, N = self.text.shape
        c = self.ctx.conf["config"]
        prec = self.ctx.conf["precision"]
        elem = 2 if prec["decode"] == "bf16" else 4
        T = c["MAX_FRAME_NUM"]
        L = T * c["COARSE_MELSPEC"]["REDUCTION"]
        stage_work = {
            "decode": (work.decode_stage(c["HIDDEN_DIM"], c["TEXT_EMB_DIM"], c["SPK_EMB_DIM"],
                                         c["COARSE_MELSPEC"]["FREQ_BINS"], B, N, T, elem),
                       prec["decode"]),
            "ssrn": (work.ssrn(c["SSRN_DIM"], c["COARSE_MELSPEC"]["FREQ_BINS"],
                               1 + c["STFT"]["FFT_LENGTH"] // 2, B, T, elem), prec["ssrn"]),
            "vocode": (work.griffin_lim(c["STFT"]["FFT_LENGTH"], B, L, self.voc["iters"], elem),
                       prec["vocoder"]),
        }
        del self.syn, self.tap
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"attempted": self.calls, "failed": 0,
                "trace": {"calls": self.calls, "calls_traced": self.calls_traced or self.calls,
                          "wall_s": self.wall_s, "stage_ms": stage_ms,
                          "stage_work": stage_work}}

    def _kept_call(self) -> dict:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev, k = self.ctx.device, self.kept
        return {"ids": torch.from_numpy(k["ids"]).to(dev), "spk": torch.from_numpy(k["spk"]).to(dev),
                "seeds": k["seeds"], "mel": k["mel"], "att": k["att"], "lin": k["lin"],
                "audio": k["audio"]}

    def check(self) -> dict:
        import torch

        from portbench.reference import compare

        with torch.no_grad():
            return compare.synthesis_readings(self.ref_t2m, self.ref_ssrn, self.voc,
                                              self._kept_call())

    def control(self) -> dict:
        """The readings of the configuration's control (``calibrate.py``)."""
        import torch

        from portbench.reference import compare

        ctl = self.ctx.conf["control"]
        with torch.no_grad():
            return compare.control_readings(self.ref_t2m, self.ref_ssrn, self.voc,
                                            self._kept_call(), ctl["model"], ctl["vocoder"])


# ---- faults planted in the timed path (tests and calibrate.py) ------------------

def _half_batch(out):
    """Half of the batch left out: its rows are copies of the other half's."""
    mel, att, pma = out
    h = mel.shape[0] // 2
    mel, att = mel.clone(), att.clone()
    mel[h:], att[h:] = mel[: mel.shape[0] - h], att[: att.shape[0] - h]
    return mel, att, pma


def _stale_state(out):
    """The rollout's state never advances: every frame is the first."""
    mel, att, pma = out
    return mel[:, :1].expand_as(mel).contiguous(), att[:, :, :1].expand_as(att).contiguous(), pma


def _altered_frame(out):
    """One answer altered where it is produced: a frame of one row."""
    mel, att, pma = out
    mel = mel.clone()
    t = mel.shape[1] // 2
    mel[0, t] = (mel[0, t].float() + 0.25).clamp(0.0, 1.0).to(mel.dtype)
    return mel, att, pma


def _altered_audio(audio):
    """One answer altered where it is produced: a row of audio lost."""
    audio = audio.clone()
    audio[-1] = 0.0
    return audio


FAULTS = {"half_batch": {"decode": _half_batch}, "stale_state": {"decode": _stale_state},
          "altered_frame": {"decode": _altered_frame}, "altered_audio": {"vocode": _altered_audio}}
