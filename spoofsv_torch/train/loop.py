"""Training orchestration: validation, checkpoint/resume, metrics, plots.

Port of :mod:`spoofsv_tpu.train.loop`:

  * ordinary training, or adversarial training with the G/D alternation by
    global iteration (G when ``iteration % (ratio+1) == 0``, D otherwise)
    and the loss logs ``t_s``, ``t_s_o`` (G steps) and ``t_d``, ``wd`` (D
    steps);
  * validation every ``val_every_iter`` iterations runs the real
    autoregressive decode (the decode kernel K1 on a card) for Text2Mel, the
    forward pass for SSRN, on the validation batches plus one train batch;
  * checkpoints keep the directory contract
    ``<src_root>/checkpoints/<pattern>/<adversarial|not_adversarial>/<ctime>/<tag>.tar.pth``
    (tag ``{text2mel|ssrn}_iteration_N`` or ``*_best_model``) and the
    reference ``.tar.pth`` schema (``train/ordinary.py:271-284`` of the
    reference, written here by the port's own code): ``model_state_dict``
    (the generator), ``optimizer_state_dict`` (here with the real Adam
    moments), ``iteration``, ``epoch``, ``loss_val_log``; an adversarial
    checkpoint adds ``disc_state_dict`` (the critic),
    ``disc_optimizer_state_dict`` (the critic's Adam) and ``loss_logs``;
  * JSONL metrics and, when matplotlib is importable, the attention and
    loss-curve PNGs;
  * data-parallel training over a :class:`~spoofsv_torch.parallel.mesh.Mesh`
    of ranks (``mesh=``): the state broadcast from rank 0 at ``init`` and
    ``resume``, each rank stepping on its rows of every global batch, the
    gradients all-reduced in the steps; only rank 0 writes metrics,
    checkpoints and figures.
"""

from __future__ import annotations

import copy
import json
import os
import re
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
from torch import nn

from spoofsv_torch.config import Config
from spoofsv_torch.ops.decode_kernel import make_fused_decoder
from spoofsv_torch.parallel.mesh import LocalRows, active, batch_sharding, replicate_tree
from spoofsv_torch.parallel.multihost import global_batch_from_local
from spoofsv_torch.train.losses import binary_divergence, guided_attention_loss, l1_loss
from spoofsv_torch.train.state import AdvTrainState, TrainState
from spoofsv_torch.train.steps import (autocast_to, eval_mode, guided_attention_table, is_g_step,
                                       make_fused_adversarial_step, make_ordinary_step)
from spoofsv_torch.utils.plot import pyplot
from spoofsv_torch.utils.profiling import span
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


def plot_attention(att: np.ndarray, iters: int, fig_dir: str) -> None:
    """Attention heatmap PNG (``train/ordinary.py:30-44``)."""
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(fig_dir, exist_ok=True)
    fig, ax = plt.subplots()
    img = ax.imshow(np.asarray(att))
    fig.colorbar(img)
    plt.title(f"{iters} iterations")
    plt.savefig(os.path.join(fig_dir, f"att_iteration_{iters}.png"), format="png")
    plt.close(fig)


def plot_losses(losses: Dict[str, List[float]], iters: int, fig_dir: str) -> None:
    """GAN loss curves (``train/adversarial_wasserstein_gp.py:45-63``)."""
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(fig_dir, exist_ok=True)
    fig1, ax1 = plt.subplots(2, 1)
    fig1.tight_layout()
    ax1[0].set_title("Discriminator Train Loss")
    ax1[1].set_title("Wasserstein Distance")
    ax1[0].plot(losses.get("t_d", []), color="green")
    ax1[1].plot(losses.get("wd", []), color="purple")
    plt.savefig(os.path.join(fig_dir, f"DiscriminatorTrainLoss_iteration_{iters}.png"))
    plt.close(fig1)
    fig2, ax2 = plt.subplots(2, 1)
    fig2.tight_layout()
    ax2[0].set_title("Generator Train Loss")
    ax2[1].set_title("Generator Train Loss (From Discriminator)")
    ax2[0].plot(losses.get("t_s", []), color="blue")
    ax2[1].plot(losses.get("t_s_o", []), color="orange")
    plt.savefig(os.path.join(fig_dir, f"GeneratorTrainLoss_iteration_{iters}.png"))
    plt.close(fig2)


def _state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def latest_checkpoint(base: str, prefix: str) -> Optional[str]:
    """The highest ``{prefix}_iteration_N.tar.pth`` in the run directory
    ``base`` (absolute), or None."""
    pat = re.compile(rf"{re.escape(prefix)}_iteration_(\d+)\.tar\.pth$")
    found = [(int(m.group(1)), e) for e in os.listdir(base) if (m := pat.match(e))]
    return os.path.join(os.path.abspath(base), max(found)[1]) if found else None


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

    def save(self, state: Union[TrainState, AdvTrainState], host_meta: Dict[str, Any],
             best: bool = False) -> str:
        """Write ``state`` and ``host_meta`` (``epoch``, ``iteration``,
        ``loss_val_log``, and ``loss_logs`` for an :class:`AdvTrainState`)."""
        tag = (f"{self.prefix}_best_model" if best
               else f"{self.prefix}_iteration_{host_meta['iteration']}")
        path = self._path(tag)
        ckpt = {"epoch": host_meta["epoch"], "iteration": host_meta["iteration"],
                "loss_val_log": list(host_meta["loss_val_log"])}
        if isinstance(state, AdvTrainState):
            ckpt.update(model_state_dict=_state_dict(state.gen),
                        optimizer_state_dict=state.gen_optimizer.state_dict(),
                        disc_state_dict=_state_dict(state.disc),
                        disc_optimizer_state_dict=state.disc_optimizer.state_dict(),
                        loss_logs={k: list(v) for k, v in host_meta["loss_logs"].items()})
        else:
            ckpt.update(model_state_dict=_state_dict(state.model),
                        optimizer_state_dict=state.optimizer.state_dict())
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)   # a reader never sees a half-written file
        return path

    def latest(self) -> Optional[str]:
        """The highest ``*_iteration_N`` checkpoint of this run directory."""
        return latest_checkpoint(self.base, self.prefix)

    @staticmethod
    def restore(path: str) -> Dict[str, Any]:
        return torch.load(path, map_location="cpu", weights_only=True)


def make_ar_validator(melsyn: nn.Module, cfg: Config,
                      compute_dtype: torch.dtype = torch.float32):
    """Returns ``begin``: ``begin()``, once per validation call, gives the
    function that decodes a batch autoregressively to its mel length and
    scores L1 + BD + guided attention against it. The decoder is
    :func:`spoofsv_torch.ops.decode_kernel.make_fused_decoder`, built for
    each batch so it packs the current weights: kernel K1 for CUDA tensors,
    its plain version for CPU tensors. Under a bf16 ``compute_dtype`` it
    decodes a bf16 copy of the model, made once per call, as the JAX
    Trainer's validation decodes with its bf16 module (bf16 K1 on the
    card)."""
    gaw = guided_attention_table(cfg)

    def begin() -> Callable[[Batch], Dict[str, float]]:
        model = melsyn if compute_dtype == torch.float32 else copy.deepcopy(melsyn).to(
            compute_dtype)

        def validate_batch(batch: Batch) -> Dict[str, float]:
            with eval_mode(model):
                y, a, _ = make_fused_decoder(model, batch["mel"].shape[1])(batch["text"],
                                                                          batch["spk"])
            y, a = y.float(), a.float()
            l1 = l1_loss(batch["mel"], y)
            bd = binary_divergence(batch["mel"], y)
            att = guided_attention_loss(a, gaw(a.device))
            return {"l1": float(l1), "bd": float(bd), "att": float(att),
                    "loss": float(l1 + bd + att)}

        return validate_batch

    return begin


def make_ssrn_validator(ssrn: nn.Module, cfg: Config,
                        compute_dtype: torch.dtype = torch.float32):
    """Returns ``begin``: ``begin()`` gives the function that scores L1 + BD
    of the SSRN forward (under :func:`autocast_to` ``compute_dtype``)
    against a batch's linear magnitudes."""

    def validate_batch(batch: Batch) -> Dict[str, float]:
        with eval_mode(ssrn), autocast_to(batch["mel"].device, compute_dtype):
            y = ssrn(batch["mel"].to(next(ssrn.parameters()).dtype)).float()
        l1 = l1_loss(batch["lin"], y)
        bd = binary_divergence(batch["lin"], y)
        return {"l1": float(l1), "bd": float(bd), "loss": float(l1 + bd)}

    return lambda: validate_batch


class Trainer:
    """Ordinary or adversarial training with the reference's cadence: an
    optimizer step per batch (adversarial: the fused step of
    :func:`spoofsv_torch.train.steps.make_fused_adversarial_step`, a G step
    when ``iteration % (ratio+1) == 0``, a D step otherwise, its metrics
    padded to :data:`~spoofsv_torch.train.steps.FUSED_METRICS`), validation
    and checkpoints every ``cfg.val_every_iter`` iterations. The generator's
    parameters fix the device; batches are moved there. The WGAN-GP
    penalty's mixing draws come from a ``torch.Generator`` on that device,
    seeded by ``fit(rng_seed=...)``. ``compute_dtype`` is the steps' and the
    validation's autocast dtype (``train_compute_dtype``); the parameters
    and optimizer state stay f32.

    ``mesh``: data-parallel training over its ranks, every rank running this
    trainer on the same loader. A global batch is trimmed to a multiple of
    the rank count (printed once) and each rank steps on its rows; a
    :class:`~spoofsv_torch.parallel.mesh.LocalRows` batch (a mesh-aware
    loader's) is this rank's rows already. Validation runs the whole
    validation batches on every rank. With ``cfg.apply_dropout`` each rank
    seeds PyTorch's generator with ``rng_seed + rank``."""

    def __init__(self, cfg: Config, gen_model: nn.Module, train_kind: str,
                 pattern: str = "conditional", adversarial: bool = False,
                 gan_type: str = "wgan-gp", disc_model: Optional[nn.Module] = None,
                 ctime: str = "dev", use_masks: bool = False, validate_with_decode: bool = True,
                 metrics_every: int = 1, compute_dtype: torch.dtype = torch.float32,
                 mesh=None):
        self.cfg = cfg
        self.mesh = active(mesh)
        self.primary = self.mesh is None or self.mesh.rank == 0
        self._warned_uneven = False
        self.gen_model = gen_model
        self.disc_model = disc_model
        self.train_kind = train_kind
        self.adversarial = adversarial
        self.metrics_every = max(1, metrics_every)
        self.device = next(gen_model.parameters()).device
        self.ckpt = CheckpointManager(cfg, pattern, adversarial, ctime, train_kind)
        self.fig_dir = os.path.join(self.ckpt.base, "fig")
        self.metrics = MetricsLogger(os.path.join(self.ckpt.base, "metrics.jsonl")
                                     if self.primary else None)
        self.loss_val_log: List[float] = []
        self.loss_logs: Dict[str, list] = {"wd": [], "t_s": [], "t_s_o": [], "t_d": []}
        if adversarial:
            if disc_model is None:
                raise ValueError("adversarial training needs a disc_model")
            self.init_fn, self.adv_step = make_fused_adversarial_step(
                gen_model, disc_model, cfg, train_kind, gan_type, use_masks, compute_dtype,
                self.mesh)
        else:
            self.init_fn, self.step_fn = make_ordinary_step(gen_model, cfg, train_kind, use_masks,
                                                            compute_dtype, self.mesh)
        if train_kind == "train_text2mel" and validate_with_decode:
            self.validator = make_ar_validator(gen_model, cfg, compute_dtype)
        elif train_kind == "train_ssrn":
            self.validator = make_ssrn_validator(gen_model, cfg, compute_dtype)
        else:
            self.validator = None
        self.mix_generator = torch.Generator(device=self.device).manual_seed(0)
        self.state: Optional[Union[TrainState, AdvTrainState]] = None
        self.iteration = 0
        self.epoch = 0

    # -- lifecycle ----------------------------------------------------------
    def init(self) -> Union[TrainState, AdvTrainState]:
        self.state = self.init_fn()
        if self.mesh is not None:
            replicate_tree(self.state, self.mesh)
        return self.state

    def resume(self, path: str) -> None:
        """Weights, Adam moments, iteration, epoch, validation log (and, when
        adversarial, the critic, its Adam and the loss logs) from a
        checkpoint this trainer (or the reference) wrote."""
        ckpt = self.ckpt.restore(path)
        load_state(self.gen_model, ckpt["model_state_dict"])
        if self.adversarial:
            load_state(self.disc_model, ckpt["disc_state_dict"])
        self.state = self.init_fn()
        if self.adversarial:
            self.state.gen_optimizer.load_state_dict(ckpt["optimizer_state_dict"])
            self.state.disc_optimizer.load_state_dict(ckpt["disc_optimizer_state_dict"])
            self.loss_logs = {k: [float(v) for v in vs] for k, vs in ckpt["loss_logs"].items()}
        else:
            self.state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        self.iteration = int(ckpt.get("iteration", 0))
        self.epoch = int(ckpt.get("epoch", 0))
        self.loss_val_log = [float(v) for v in ckpt.get("loss_val_log", [])]
        self.state.step = self.iteration
        if self.mesh is not None:
            replicate_tree(self.state, self.mesh)

    def close(self) -> None:
        self.metrics.close()

    def _flush_loss_logs(self) -> None:
        """The loss logs as host floats, one device read per log."""
        def host(vs: list) -> List[float]:
            if not any(isinstance(v, torch.Tensor) for v in vs):
                return [float(v) for v in vs]
            return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device)
                                for v in vs]).tolist()

        self.loss_logs = {k: host(vs) for k, vs in self.loss_logs.items()}

    def _host_meta(self) -> Dict[str, Any]:
        meta = {"iteration": self.iteration, "epoch": self.epoch,
                "loss_val_log": self.loss_val_log}
        if self.adversarial:
            self._flush_loss_logs()
            meta["loss_logs"] = self.loss_logs
        return meta

    def _place_whole(self, batch) -> Batch:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _place_batch(self, batch) -> Optional[Batch]:
        """A batch on this rank's device: the whole batch without a mesh;
        over a mesh, this rank's rows of the global batch after trimming it
        to a multiple of the rank count (None when fewer rows than ranks),
        or a :class:`LocalRows` batch as it is."""
        if self.mesh is None:
            return self._place_whole(batch)
        if isinstance(batch, LocalRows):
            return global_batch_from_local(batch, self.mesh)
        n = self.mesh.size
        rows = next(iter(batch.values())).shape[0]
        keep = rows // n * n
        if keep == 0:
            return None
        if keep != rows and not self._warned_uneven:
            print(f"[mesh] trimming uneven batch {rows} -> {keep} ({n} data shards)")
            self._warned_uneven = True
        sl = batch_sharding(self.mesh, keep)
        return {k: torch.as_tensor(v)[sl].to(self.device) for k, v in batch.items()}

    # -- one iteration ------------------------------------------------------
    def train_iteration(self, batch: Batch) -> Dict[str, float]:
        """One optimizer step (the span ``train.step``). Metrics are read back
        (a device sync, the span ``train.metrics_sync``) every
        ``metrics_every`` iterations and returned; ``{}`` otherwise. The loss
        logs keep the device values of the other iterations."""
        with span("train.step"):
            if not self.adversarial:
                self.state, m = self.step_fn(self.state, batch)
            else:
                g = is_g_step(self.state.step, self.cfg.ratio)   # the branch the step takes
                self.state, m = self.adv_step(self.state, batch, self.mix_generator)
                for name, key in ((("t_s", "loss"), ("t_s_o", "loss_disc")) if g
                                  else (("t_d", "loss_d"), ("wd", "wd"))):
                    self.loss_logs[name].append(m[key])
        self.iteration += 1
        if self.iteration % self.metrics_every:
            return {}
        with span("train.metrics_sync"):
            return {k: float(v) for k, v in m.items()}

    # -- validation + checkpoint cadence ------------------------------------
    def maybe_validate_and_checkpoint(self, val_batches: Iterable[Batch],
                                      train_batch: Optional[Batch] = None) -> Optional[float]:
        if self.iteration % self.cfg.val_every_iter != 0 or self.iteration == 0:
            return None
        losses = []
        validate = self.validator() if self.validator is not None else None
        for vb in val_batches:
            r = validate(vb)
            self.metrics.log(dict(r, split="validate", iteration=self.iteration))
            losses.append(r["loss"])
        if train_batch is not None and validate is not None:
            r = validate(train_batch)
            self.metrics.log(dict(r, split="train_probe", iteration=self.iteration))
        loss_val = float(np.mean(losses)) if losses else float("nan")
        self.loss_val_log.append(loss_val)
        meta = self._host_meta()
        if self.primary:
            if losses and (self.loss_val_log.index(min(self.loss_val_log))
                           == len(self.loss_val_log) - 1):
                self.ckpt.save(self.state, meta, best=True)
            self.ckpt.save(self.state, meta)
        return loss_val

    # -- full loop ----------------------------------------------------------
    def fit(self, train_loader_factory: Callable[[], Iterable],
            val_loader_factory: Optional[Callable[[], Iterable]] = None,
            max_epochs: Optional[int] = None, max_iterations: Optional[int] = None,
            rng_seed: int = 0, plot: bool = False) -> Union[TrainState, AdvTrainState]:
        """``train_loader_factory()`` → the batches of one epoch (numpy or
        torch). ``plot``: the loss-curve PNGs after each validation."""
        self.mix_generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        if self.mesh is not None and self.cfg.apply_dropout:
            torch.manual_seed(rng_seed + self.mesh.rank)   # each rank its own dropout masks
        max_epochs = max_epochs or self.cfg.max_epochs
        last_batch = None
        window_t0 = time.perf_counter()
        while self.epoch < max_epochs:
            for batch in train_loader_factory():
                with span("train.place"):
                    batch = self._place_batch(batch)
                if batch is None:   # fewer rows than ranks
                    continue
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
                    vb = (self._place_whole(b) for b in val_loader_factory())
                    lv = self.maybe_validate_and_checkpoint(vb, last_batch)
                    if lv is not None and plot and self.primary:
                        self._flush_loss_logs()
                        plot_losses(self.loss_logs, self.iteration, self.fig_dir)
                    window_t0 = time.perf_counter()
                if max_iterations and self.iteration >= max_iterations:
                    return self.state
            self.epoch += 1
        return self.state
