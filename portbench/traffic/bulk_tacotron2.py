"""Bulk synthesis on Tacotron 2, as a spoof-set job runs it: back-to-back
calls of ``Tacotron2Synthesizer.__call__``, each of ``speakers_per_call``
speakers drawn from the speaker table (unit-norm d-vectors of
``speaker_dim``) times the first ``sentences`` Harvard sentences, the text
padded to the call's longest sentence, ``frames`` decoder steps a call
(every step run, the gate recorded), each call's audio on the host.

The calls, their order and the end-to-end metric are ``bulk.py``'s (this
kind is its subclass): ``synth_audio_s_per_s`` over the window. The
program's stages (``encode``, ``rollout``, ``postnet_apply``, ``vocode``)
run in the benchmark's spans ``encode``, ``rollout``, ``postnet``,
``vocode``, timed by CUDA events when traced; the vocoder's linear
magnitude is kept by wrapping ``infer.synthesize.mel_to_linear``. ``correct`` compares one call
of the window, drawn from the seed, every row of it, stage by stage
(``reference/t2_compare.py``).
"""

from __future__ import annotations

import random
import time

import numpy as np

from portbench import harness, inputs, program
from portbench.reference import t2_compare, tacotron2 as t2
from portbench.work import tacotron2 as t2work

bulk = harness.kind_module("bulk")


class Tap(program.StageTap):
    STAGES = (("encode", "encode"), ("rollout", "rollout"), ("postnet_apply", "postnet"),
              ("vocode", "vocode"))


def speaker_table(seed: int, dim: int):
    """``data/speakers.json``'s names, and a unit-norm ``dim``-wide d-vector
    a speaker drawn from the seed (float32)."""
    names, _ = inputs.speaker_table(seed)
    rng = np.random.default_rng(inputs.stream(seed, "speakers"))
    table = rng.standard_normal((len(names), dim))
    return names, (table / np.linalg.norm(table, axis=1, keepdims=True)).astype(np.float32)


class Kind(bulk.Kind):
    # ---- set-up -----------------------------------------------------------------
    def setup(self) -> None:
        import torch
        from spoofsv_torch import reference_precision
        from spoofsv_torch.cli.main import inference_dtype
        from spoofsv_torch.config import Tacotron2Config
        from spoofsv_torch.infer.synthesize import Tacotron2Synthesizer
        from spoofsv_torch.models.tacotron2 import Tacotron2

        ctx, mix = self.ctx, self.ctx.mix
        self.hp = ctx.conf["config"]
        cfg = Tacotron2Config.from_hparams(self.hp)
        if mix["frames"] > cfg.max_decoder_steps:
            raise ValueError(f"{mix['frames']} frames a call, max_decoder_steps is "
                             f"{cfg.max_decoder_steps}")
        if ctx.device.type == "cuda":
            reference_precision()
        program.load_kernels(ctx.device)
        dtype = inference_dtype(cfg, ctx.device)
        schema = t2.schema(self.hp)
        sd = inputs.seeded_state([(k, s) for k, s in schema if s != ()], ctx.seed, "text2mel",
                                 ctx.device, dtype)
        sd.update({k: torch.zeros((), dtype=torch.int64, device=ctx.device)
                   for k, s in schema if s == ()})
        with torch.device(ctx.device):
            model = Tacotron2(cfg)
        model.to(dtype).load_state_dict(sd, strict=True)
        self.ref_sd = {k: v.float() for k, v in sd.items() if v.is_floating_point()}
        self.syn = Tacotron2Synthesizer(cfg, model, n_frames=mix["frames"],
                                        gl_iters=cfg.tpu.griffin_lim_iters)
        self.voc = t2_compare.vocoder_params(ctx.conf)
        self.sr = self.voc["sr"]
        _, self.table = speaker_table(ctx.seed, cfg.speaker_embedding_dim)
        k, n = mix["speakers_per_call"], mix["sentences"]
        self.text = np.tile(t2.encode_texts(inputs.sentences(n)), (k, 1))
        self.rng = np.random.default_rng(inputs.stream(ctx.seed, "traffic"))
        self.order: list = []
        self.tap = Tap(self.syn, ctx.tracer, ctx.trace and ctx.device.type == "cuda", self.hooks)
        self._tap_prep()
        for _ in range(mix["warmup_calls"]):
            self.syn(*self._next_call())[0].cpu()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        self.tap.events = {name: [] for name in self.tap.events}   # the window's calls only

    def _tap_prep(self) -> None:
        """Keep the vocoder's linear magnitude (``infer.synthesize.mel_to_linear``,
        which the vocoder looks up at each call) of the latest call."""
        from spoofsv_torch.infer import synthesize

        self._mel_to_linear = prep = synthesize.mel_to_linear

        def kept(mel, inverse):
            self.tap.last["prep"] = out = prep(mel, inverse)
            return out

        synthesize.mel_to_linear = kept

    # ---- the window -----------------------------------------------------------------
    def window(self) -> dict:
        from spoofsv_torch.utils import profiling

        ctx = self.ctx
        keep_rng = random.Random(inputs.stream(ctx.seed, "sample"))
        calls, audio_s, self.kept, self.calls_traced = 0, 0.0, None, None
        before = profiling.snapshot()["counters"]
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while True:
            text, spk, seeds = self._next_call()
            with ctx.tracer.span("call"):
                audio, _, _ = self.syn(text, spk, seeds)
                with ctx.tracer.span("to_host"):
                    host = audio.cpu()
            calls += 1
            audio_s += host.numel() / self.sr
            if keep_rng.random() * calls < 1.0:   # a uniform draw over the calls
                frames, gate, att, states = self.tap.last["rollout"]
                # the states are the rollout's buffers until its next call
                states = {k: v.clone() for k, v in states.items()}
                self.kept = {"ids": text, "spk": spk, "seeds": seeds, "frames": frames,
                             "gate": gate, "att": att, "states": states,
                             "post": self.tap.last["postnet"], "spec": self.tap.last["prep"],
                             "audio": host.numpy()}
            now = time.perf_counter()
            if ctx.trace and self.calls_traced is None and now >= t0 + ctx.mix["trace_seconds"]:
                ctx.tracer.stop()
                self.calls_traced = calls
            if now >= deadline:
                break
        self.wall_s = time.perf_counter() - t0
        self.calls = calls
        after = profiling.snapshot()["counters"]
        self.counters = {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("t2_rollout_steps", "t2_graph_captures")}
        return {"synth_audio_s_per_s": audio_s / self.wall_s}

    # ---- after the window ----------------------------------------------------------
    def release(self) -> dict:
        import torch

        stage_ms = self.tap.stage_ms() if self.tap.timed else {}
        B, N = self.text.shape
        T = self.ctx.mix["frames"]
        hp, prec = self.hp, self.ctx.conf["precision"]
        elem = 2 if prec["rollout"] == "bf16" else 4
        stage_work = {
            "encode": (t2work.encoder(hp, B, N, elem), prec["rollout"]),
            "rollout": (t2work.rollout(hp, B, N, T, elem), prec["rollout"]),
            "postnet": (t2work.postnet(hp, B, T, elem), prec["postnet"]),
            "vocode": (t2work.vocoder(hp, B, T, self.voc["iters"]), prec["vocoder"]),
        }
        kernel_work = {"t2_att_step_kernel": t2work.att_step_kernel(hp, B, N, T),
                       "t2_dec_step_kernel": t2work.dec_step_kernel(hp, B, T)}
        from spoofsv_torch.infer import synthesize

        synthesize.mel_to_linear = self._mel_to_linear
        del self.syn, self.tap
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"attempted": self.calls, "failed": 0,
                "trace": {"calls": self.calls, "calls_traced": self.calls_traced or self.calls,
                          "wall_s": self.wall_s, "stage_ms": stage_ms, "stage_work": stage_work,
                          "kernel_work": kernel_work, "counters": self.counters}}

    def _kept_call(self) -> dict:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev, k = self.ctx.device, self.kept
        return {"ids": torch.from_numpy(k["ids"]).to(dev),
                "spk": torch.from_numpy(k["spk"]).to(dev),
                "seeds": k["seeds"].to(dev), "frames": k["frames"], "gate": k["gate"],
                "att": k["att"], "states": k["states"], "post": k["post"], "spec": k["spec"],
                "audio": k["audio"]}

    def check(self) -> dict:
        import torch

        with torch.no_grad():
            return t2_compare.synthesis_readings(self.ref_sd, self.hp, self.voc, self._kept_call())

    def control(self) -> dict:
        """The readings of the configuration's control (``calibrate.py``)."""
        import torch

        with torch.no_grad():
            return t2_compare.control_readings(self.ref_sd, self.hp, self.voc, self._kept_call(),
                                               self.ctx.conf["control"])


# ---- faults planted in the timed path (tests and calibrate.py) ------------------

def _copy_half(x, dim: int = 0):
    x = x.clone()
    h = x.shape[dim] // 2
    x.narrow(dim, h, x.shape[dim] - h).copy_(x.narrow(dim, 0, x.shape[dim] - h))
    return x


def _half_batch(out):
    """Half of the batch left out: its rows (and their states) are copies of
    the other half's."""
    mel, gate, att, states = out
    states = {k: v if k == "step" else _copy_half(v, 1) for k, v in states.items()}
    return _copy_half(mel), _copy_half(gate), _copy_half(att), states


def _stale_state(out):
    """The rollout's state never advances: every step is the first."""
    mel, gate, att, states = out
    return (mel[:, :1].expand_as(mel).contiguous(), gate[:, :1].expand_as(gate).contiguous(),
            att[:, :, :1].expand_as(att).contiguous(), states)


def _altered_frame(out):
    """One answer altered where it is produced: a frame of one row, by one
    (the mel's standard deviation is about one)."""
    mel, gate, att, states = out
    mel = mel.clone()
    mel[0, mel.shape[1] // 2] += 1.0
    return mel, gate, att, states


FAULTS = {"half_batch": {"rollout": _half_batch}, "stale_state": {"rollout": _stale_state},
          "altered_frame": {"rollout": _altered_frame},
          "altered_audio": {"vocode": bulk._altered_audio}}
