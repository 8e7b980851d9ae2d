"""Training orchestration, ordinary path: validation, checkpoint/resume, metrics.

Port of :mod:`spoofsv_tpu.train.loop` for ordinary (non-adversarial)
training:

  * validation every ``val_every_iter`` iterations runs the real
    autoregressive decode (the decode kernel K1 on a card) for Text2Mel, the
    forward pass for SSRN, on the validation batches plus one train batch;
  * checkpoints keep the directory contract
    ``<src_root>/checkpoints/<pattern>/not_adversarial/<ctime>/<tag>.tar.pth``
    (tag ``{text2mel|ssrn}_iteration_N`` or ``*_best_model``) and the
    reference ``.tar.pth`` schema that
    ``spoofsv_tpu.utils.torch_export.save_reference_checkpoint`` writes:
    ``model_state_dict``, ``optimizer_state_dict`` (here with the real Adam
    moments), ``iteration``, ``epoch``, ``loss_val_log``;
  * JSONL metrics.

Not ported here: data-parallel training over a mesh, adversarial training,
and the PNG plots.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from spoofsv_torch.config import Config
from spoofsv_torch.ops.decode_kernel import make_fused_decoder
from spoofsv_torch.train.losses import binary_divergence, guided_attention_loss, l1_loss
from spoofsv_torch.train.state import TrainState
from spoofsv_torch.train.steps import eval_mode, guided_attention_table, make_ordinary_step
from spoofsv_torch.weights import load_state

Batch = Dict[str, torch.Tensor]


class MetricsLogger:
    """Appends one JSON object per record to ``path`` (nothing when ``path`` is None)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a") if path else None

    def log(self, record: Dict[str, Any]) -> None:
        record = {k: (float(v) if isinstance(v, (torch.Tensor, np.floating, np.integer)) else v)
                  for k, v in record.items()}
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class CheckpointManager:
    """Reference-schema ``.tar.pth`` checkpoints in the reference's directory layout."""

    def __init__(self, cfg: Config, pattern: str, adversarial: bool, ctime: str,
                 train_kind: str):
        self.base = os.path.join(cfg.src_root_dir, "checkpoints", pattern,
                                 "adversarial" if adversarial else "not_adversarial", ctime)
        os.makedirs(self.base, exist_ok=True)
        self.prefix = train_kind[6:]   # 'text2mel' | 'ssrn'

    def _path(self, tag: str) -> str:
        return os.path.abspath(os.path.join(self.base, f"{tag}.tar.pth"))

    def save(self, state: TrainState, host_meta: Dict[str, Any], best: bool = False) -> str:
        tag = (f"{self.prefix}_best_model" if best
               else f"{self.prefix}_iteration_{host_meta['iteration']}")
        path = self._path(tag)
        ckpt = {
            "epoch": host_meta["epoch"],
            "iteration": host_meta["iteration"],
            "model_state_dict": {k: v.detach().cpu()
                                 for k, v in state.model.state_dict().items()},
            "optimizer_state_dict": state.optimizer.state_dict(),
            "loss_val_log": list(host_meta["loss_val_log"]),
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)   # a reader never sees a half-written file
        return path

    def latest(self) -> Optional[str]:
        """The highest ``*_iteration_N`` checkpoint of this run directory."""
        pat = re.compile(rf"{re.escape(self.prefix)}_iteration_(\d+)\.tar\.pth$")
        found = [(int(m.group(1)), e) for e in os.listdir(self.base) if (m := pat.match(e))]
        return os.path.join(os.path.abspath(self.base), max(found)[1]) if found else None

    @staticmethod
    def restore(path: str) -> Dict[str, Any]:
        return torch.load(path, map_location="cpu", weights_only=True)


def make_ar_validator(melsyn: nn.Module, cfg: Config):
    """Decode a batch autoregressively to its mel length and score L1 + BD +
    guided attention against it. The decoder is
    :func:`spoofsv_torch.ops.decode_kernel.make_fused_decoder`, built anew
    each call so it packs the current weights: kernel K1 for CUDA tensors,
    its plain version for CPU tensors."""
    gaw = guided_attention_table(cfg)

    def validate_batch(batch: Batch) -> Dict[str, float]:
        with eval_mode(melsyn):
            y, a, _ = make_fused_decoder(melsyn, batch["mel"].shape[1])(batch["text"],
                                                                       batch["spk"])
        y, a = y.float(), a.float()
        l1 = l1_loss(batch["mel"], y)
        bd = binary_divergence(batch["mel"], y)
        att = guided_attention_loss(a, gaw(a.device))
        return {"l1": float(l1), "bd": float(bd), "att": float(att),
                "loss": float(l1 + bd + att)}

    return validate_batch


def make_ssrn_validator(ssrn: nn.Module, cfg: Config):
    """L1 + BD of the SSRN forward against the batch's linear magnitudes."""

    def validate_batch(batch: Batch) -> Dict[str, float]:
        with eval_mode(ssrn):
            y = ssrn(batch["mel"].to(next(ssrn.parameters()).dtype)).float()
        l1 = l1_loss(batch["lin"], y)
        bd = binary_divergence(batch["lin"], y)
        return {"l1": float(l1), "bd": float(bd), "loss": float(l1 + bd)}

    return validate_batch


class Trainer:
    """Ordinary training with the reference's cadence: an optimizer step per
    batch, validation and checkpoints every ``cfg.val_every_iter`` iterations.
    The model's parameters fix the device; batches are moved there."""

    def __init__(self, cfg: Config, gen_model: nn.Module, train_kind: str,
                 pattern: str = "conditional", ctime: str = "dev", use_masks: bool = False,
                 validate_with_decode: bool = True, metrics_every: int = 1):
        self.cfg = cfg
        self.gen_model = gen_model
        self.train_kind = train_kind
        self.metrics_every = max(1, metrics_every)
        self.device = next(gen_model.parameters()).device
        self.ckpt = CheckpointManager(cfg, pattern, False, ctime, train_kind)
        self.metrics = MetricsLogger(os.path.join(self.ckpt.base, "metrics.jsonl"))
        self.loss_val_log: List[float] = []
        self.init_fn, self.step_fn = make_ordinary_step(gen_model, cfg, train_kind, use_masks)
        if train_kind == "train_text2mel" and validate_with_decode:
            self.validator = make_ar_validator(gen_model, cfg)
        elif train_kind == "train_ssrn":
            self.validator = make_ssrn_validator(gen_model, cfg)
        else:
            self.validator = None
        self.state: Optional[TrainState] = None
        self.iteration = 0
        self.epoch = 0

    # -- lifecycle ----------------------------------------------------------
    def init(self) -> TrainState:
        self.state = self.init_fn()
        return self.state

    def resume(self, path: str) -> None:
        """Model weights, Adam moments, iteration, epoch and validation log
        from a checkpoint this trainer (or the reference) wrote."""
        ckpt = self.ckpt.restore(path)
        load_state(self.gen_model, ckpt["model_state_dict"])
        self.state = self.init_fn()
        self.state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        self.iteration = int(ckpt.get("iteration", 0))
        self.epoch = int(ckpt.get("epoch", 0))
        self.loss_val_log = [float(v) for v in ckpt.get("loss_val_log", [])]
        self.state.step = self.iteration

    def close(self) -> None:
        self.metrics.close()

    def _host_meta(self) -> Dict[str, Any]:
        return {"iteration": self.iteration, "epoch": self.epoch,
                "loss_val_log": self.loss_val_log}

    def _place_batch(self, batch) -> Batch:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    # -- one iteration ------------------------------------------------------
    def train_iteration(self, batch: Batch) -> Dict[str, float]:
        """One optimizer step. Metrics are read back (a device sync) every
        ``metrics_every`` iterations and returned; ``{}`` otherwise."""
        self.state, m = self.step_fn(self.state, batch)
        self.iteration += 1
        if self.iteration % self.metrics_every:
            return {}
        return {k: float(v) for k, v in m.items()}

    # -- validation + checkpoint cadence ------------------------------------
    def maybe_validate_and_checkpoint(self, val_batches: Iterable[Batch],
                                      train_batch: Optional[Batch] = None) -> Optional[float]:
        if self.iteration % self.cfg.val_every_iter != 0 or self.iteration == 0:
            return None
        losses = []
        for vb in val_batches:
            r = self.validator(vb)
            self.metrics.log(dict(r, split="validate", iteration=self.iteration))
            losses.append(r["loss"])
        if train_batch is not None and self.validator is not None:
            r = self.validator(train_batch)
            self.metrics.log(dict(r, split="train_probe", iteration=self.iteration))
        loss_val = float(np.mean(losses)) if losses else float("nan")
        self.loss_val_log.append(loss_val)
        meta = self._host_meta()
        if losses and self.loss_val_log.index(min(self.loss_val_log)) == len(self.loss_val_log) - 1:
            self.ckpt.save(self.state, meta, best=True)
        self.ckpt.save(self.state, meta)
        return loss_val

    # -- full loop ----------------------------------------------------------
    def fit(self, train_loader_factory: Callable[[], Iterable],
            val_loader_factory: Optional[Callable[[], Iterable]] = None,
            max_epochs: Optional[int] = None,
            max_iterations: Optional[int] = None) -> TrainState:
        """``train_loader_factory()`` → the batches of one epoch (numpy or torch)."""
        max_epochs = max_epochs or self.cfg.max_epochs
        last_batch = None
        window_t0 = time.perf_counter()
        while self.epoch < max_epochs:
            for batch in train_loader_factory():
                batch = self._place_batch(batch)
                if self.state is None:
                    self.init()
                    window_t0 = time.perf_counter()
                m = self.train_iteration(batch)
                if m:   # read back on this iteration: the sync closes the window
                    now = time.perf_counter()
                    m["sec_per_iter"] = (now - window_t0) / self.metrics_every
                    window_t0 = now
                    self.metrics.log(dict(m, split="train", iteration=self.iteration,
                                          epoch=self.epoch))
                last_batch = batch
                # the validation loader is touched only on validation iterations
                if (self.validator is not None and val_loader_factory is not None
                        and self.iteration > 0
                        and self.iteration % self.cfg.val_every_iter == 0):
                    vb = (self._place_batch(b) for b in val_loader_factory())
                    self.maybe_validate_and_checkpoint(vb, last_batch)
                    window_t0 = time.perf_counter()
                if max_iterations and self.iteration >= max_iterations:
                    return self.state
            self.epoch += 1
        return self.state
