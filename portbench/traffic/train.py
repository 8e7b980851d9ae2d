"""Ordinary Text2Mel training, as ``cli/main.py train_text2mel`` runs it.

The ``Trainer`` is built as the CLI builds it (the highway implementation
for training, TF32 off, f32 steps, ``metrics_every`` 1, no masked loss,
its checkpoint root under ``TMPDIR``), over the seed's f32 weights, and
driven through ``Trainer.train_iteration`` on batches kept on the device,
as the CLI's device-resident loader keeps them.

The batches: ``pool_batches`` batches of ``batch`` utterances whose lengths
are drawn once from ``lengths_seed`` (each utterance's speech log-normal
around ``median_s`` seconds, cut at the rollout's frames; ``chars_per_s``
characters a second of speech, cut at the longest text), each batch
padded to the configuration's frame and text buckets as
``data/pipeline.py`` pads; every seed runs the same batches in another
order, with contents (mel frames, text ids, speakers) drawn from the seed.
Set-up runs the seed's first three batches as the first three steps (the
comparison's), then one step of every other shape of the pool.

End to end: ``train_step_ms``, the window's wall time over the steps
completed in it, closed by a synchronize (not declared in
``BENCHMARK.json``: the step is bound by the host's launches and follows
the host's speed from run to run). ``correct``: the first three
steps against the reference (``reference/train.py``): each step's loss,
the first gradient as Adam got it, the parameters' change after three.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

from portbench import inputs, program, work


def pool_shapes(mix: dict, conf: dict) -> list:
    """Each pool batch's padded (frames, text) shape and its utterances'
    (frames, characters), from ``lengths_seed`` alone."""
    c = conf["config"]
    fps = c["SAMPLING_RATE"] / c["STFT"]["HOP_LENGTH"] / c["COARSE_MELSPEC"]["REDUCTION"]
    t_max, n_max = c["MAX_FRAME_NUM"], c["MAX_TEXT_LEN"]
    rng = np.random.default_rng(mix["lengths_seed"])
    out = []
    for _ in range(mix["pool_batches"]):
        secs = np.exp(rng.normal(np.log(mix["median_s"]), mix["sigma"], mix["batch"]))
        frames = np.clip(np.round(secs * fps), 1, t_max).astype(int)
        chars = np.clip(np.round(secs * mix["chars_per_s"]) + 1, 2, n_max).astype(int)
        t_b = next(b for b in c["TPU"]["bucket_frames"] if b >= frames.max())
        n_b = next(b for b in c["TPU"]["bucket_text"] if b >= chars.max())
        out.append(((t_b, n_b), frames, chars))
    return out


class Kind:
    def __init__(self, ctx, hooks):
        self.ctx = ctx
        self.hooks = hooks

    def _batch(self, rng, shape, frames, chars, device) -> dict:
        import torch

        c = self.ctx.conf["config"]
        (t_b, n_b), B, F = shape, len(frames), c["COARSE_MELSPEC"]["FREQ_BINS"]
        mel = np.zeros((B, t_b, F), np.float32)
        text = np.zeros((B, n_b), np.int32)
        for i, (t, n) in enumerate(zip(frames, chars)):
            mel[i, :t] = rng.random((t, F), dtype=np.float32)
            text[i, : n - 1] = rng.integers(2, len(c["VOCABULARY"]) - 1, n - 1)
            text[i, n - 1] = 1   # the end-of-sentence id
        spk = self.table[rng.integers(0, len(self.table), B)]
        return {k: torch.from_numpy(v).to(device) for k, v in
                (("mel", mel), ("text", text), ("spk", spk))}

    def setup(self) -> None:
        import torch
        from spoofsv_torch import reference_precision
        from spoofsv_torch.cli.main import apply_runtime_knobs, training_dtype
        from spoofsv_torch.train.loop import Trainer

        ctx, mix, dev = self.ctx, self.ctx.mix, self.ctx.device
        self.root = tempfile.mkdtemp(prefix="portbench_train_")
        cfg = program.port_config(ctx.conf).replace(src_root_dir=self.root)
        apply_runtime_knobs(cfg, infer=False)
        if dev.type == "cuda":
            reference_precision()
        program.load_kernels(dev)
        self.model, sd = program.build_generators(ctx.conf, ctx.seed, dev, torch.float32,
                                                  train=True)
        self.sd0 = {k: v.detach().clone() for k, v in sd.items()}
        self.trainer = Trainer(cfg, self.model, "train_text2mel", pattern="conditional",
                               ctime="portbench", metrics_every=1,
                               compute_dtype=training_dtype(cfg, dev))
        self.trainer.init()
        if "step" in self.hooks:   # a test's fault in the step
            self.trainer.step_fn = self.hooks["step"](self.trainer.step_fn)
        _, self.table = inputs.speaker_table(ctx.seed)
        rng = np.random.default_rng(inputs.stream(ctx.seed, "batches"))
        pool = pool_shapes(mix, ctx.conf)
        order = rng.permutation(len(pool))
        self.batches = [self._batch(rng, *pool[i], dev) for i in order]
        self.shapes = [pool[i][0] for i in order]
        self.adam = {"alpha": cfg.adam.alpha, "beta_1": cfg.adam.beta_1,
                     "beta_2": cfg.adam.beta_2, "epsilon": cfg.adam.epsilon}
        # the first three steps, read for the comparison
        names = dict((p, k) for k, p in self.model.named_parameters())
        losses = []
        for step in range(3):
            losses.append(self.trainer.train_iteration(self.batches[step])["loss"])
            if step == 0:
                st = self.trainer.state.optimizer.state
                grad = {names[p]: s["exp_avg"].detach() / (1.0 - self.adam["beta_1"])
                        for p, s in st.items()}
        params = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        self.first = {"losses": losses, "grad": grad, "params": params}
        # then one step of each other shape of the pool
        seen = set(self.shapes[:3])
        for b, shape in zip(self.batches[3:], self.shapes[3:]):
            if shape not in seen:
                self.trainer.train_iteration(b)
                seen.add(shape)
        self.next = 3
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window(self) -> dict:
        import torch

        ctx = self.ctx
        steps = 0
        self.steps_traced = None
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while True:
            batch = self.batches[self.next % len(self.batches)]
            self.next += 1
            with ctx.tracer.span("step"):
                self.trainer.train_iteration(batch)
            steps += 1
            now = time.perf_counter()
            if ctx.trace and self.steps_traced is None and now >= t0 + ctx.mix["trace_seconds"]:
                ctx.tracer.stop()
                self.steps_traced = steps
            if now >= deadline:
                break
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        self.wall_s = time.perf_counter() - t0
        self.steps = steps
        return {"train_step_ms": 1e3 * self.wall_s / steps}

    def release(self) -> dict:
        import torch

        c = self.ctx.conf["config"]
        n_params = sum(v.numel() for v in self.sd0.values())
        counted = [work.text2mel_step(c["HIDDEN_DIM"], c["TEXT_EMB_DIM"], c["SPK_EMB_DIM"],
                                      c["COARSE_MELSPEC"]["FREQ_BINS"], b["mel"].shape[0],
                                      b["text"].shape[1], b["mel"].shape[1], n_params)
                   for b in self.batches]
        # the window ran the pool in turn from its fourth batch
        ops = sum(counted[i % len(counted)][0] for i in range(3, 3 + self.steps))
        self.trainer.close()
        shutil.rmtree(self.root, ignore_errors=True)
        del self.trainer, self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"attempted": self.steps, "failed": 0,
                "trace": {"steps": self.steps, "steps_traced": self.steps_traced or self.steps,
                          "wall_s": self.wall_s, "train_ops": ops,
                          "precision": self.ctx.conf["precision"]["train"]}}

    def _reference(self):
        import torch

        from portbench.reference import train as ref_train

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.ctx.conf["config"]
        gaw = torch.from_numpy(ref_train.guided_attention(c["MAX_TEXT_LEN"],
                                                          c["MAX_FRAME_NUM"])).to(self.ctx.device)
        batches = [{k: (v.float() if k != "text" else v) for k, v in b.items()}
                   for b in self.batches[:3]]
        return ref_train, gaw, batches

    def check(self) -> dict:
        ref_train, gaw, batches = self._reference()
        return ref_train.step_readings(self.sd0, batches, self.adam, gaw, self.first)

    def control(self) -> dict:
        """The reference with TF32 products (``conf["control"]["train"]``) in
        the program's place."""
        from portbench.reference import dctts

        ref_train, gaw, batches = self._reference()
        p = dctts.Precision(self.ctx.conf["control"]["train"])
        losses, grad, params = ref_train.run_steps(self.sd0, batches, self.adam, gaw, p)
        return ref_train.step_readings(self.sd0, batches, self.adam, gaw,
                                       {"losses": losses, "grad": grad, "params": params})


def _half_batch(step_fn):
    """Half of the batch left out, the mean taken over the rest."""
    def step(state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step_fn(state, half)
    return step


def _unchanged(step_fn):
    """A step that returns its state unchanged."""
    import torch

    def step(state, batch):
        saved = [p.detach().clone() for p in state.model.parameters()]
        new, metrics = step_fn(state, batch)
        with torch.no_grad():
            for p, w in zip(state.model.parameters(), saved):
                p.copy_(w)
        return new, metrics
    return step


FAULTS = {"half_batch": {"step": _half_batch}, "unchanged_state": {"step": _unchanged}}
