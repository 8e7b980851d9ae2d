"""The anti-spoofing countermeasure (CM): its data, training step and scoring.

Port of :mod:`spoofsv_tpu.spoofkit.antispoof` (the reference's
``anti_spoofing/spoof_conv1d.py`` and ``main_spoof_conv1d.py``): bonafide
against spoof classification on the TTS mel (or linear) features with a
sigmoid-output :class:`~spoofsv_torch.models.discriminator.Critic1D`,
trained with BCE and AMSGrad (β = (0.9, 0.98), ε = 1e-9, weight decay 1e-4),
scored into an ASVspoof-format file.

The optimizer is :class:`AMSGrad`, written out on tensors: optax's
``amsgrad`` keeps the running maximum of the *bias-corrected* second moment,
``torch.optim.Adam(amsgrad=True)`` the maximum of the raw one divided by
the current step's correction, and the two part whenever the maximum was
set at an earlier step. The loss clips the prediction to [0, 1] and floors
each log argument at 1e-6 (``F.binary_cross_entropy`` clamps the log at −100
instead). Dropout draws from the step's own ``torch.Generator``.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import hashlib
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.dsp.primitives import mel_filterbank


class ASVspoofSource:
    """Bonafide and spoof utterances with TTS-style features at 16 kHz
    (``anti_spoofing/spoof_conv1d.py:9-68``).

    train: the first ``bonafide_cap`` utterances of the TTS train list
    (bonafide) and the ASVspoof2019 LA train spoofs; dev: the remaining
    bonafide and the generated ``customized_data_<ctime>.txt`` spoof protocol.
    """

    def __init__(self, cfg: Config, step: str, ctime: str, bonafide_cap: int = 20000,
                 cache_dir: Optional[str] = "auto"):
        """``cache_dir``: the feature cache directory (``"auto"`` →
        ``<src_root>/cm_spec``, ``None`` → none), written atomically one
        ``.npy`` per utterance and feature kind (the reference recomputes
        load → trim → STFT → mel every epoch)."""
        self.cfg = cfg
        if cache_dir == "auto":
            cache_dir = os.path.join(cfg.src_root_dir, "cm_spec")
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        proto_fn = os.path.join(cfg.data_root_dir, "data_path", "ordinary", "wav.path.train")
        with open(proto_fn) as f:
            audio_fn = [ln.strip() for ln in f if ln.strip()]
        if step == "train":
            self.files = audio_fn[:bonafide_cap]
            suffix = "ASVspoof2019.LA.cm.train.trn.txt"
            mid = "ASVspoof2019_LA_train"
        else:
            self.files = audio_fn[bonafide_cap:]
            suffix = f"customized_data_{ctime}.txt"
            mid = ctime
        n_real = len(self.files)

        spoof_fn = os.path.join(cfg.antispoof_dir, "ASVspoof2019_LA_cm_protocols", suffix)
        n_spoof = 0
        if os.path.exists(spoof_fn):
            with open(spoof_fn) as f:
                for proto in f:
                    parts = proto.strip().split()
                    if parts and parts[-1] == "spoof":
                        base = os.path.join(cfg.antispoof_dir, mid, "flac", parts[1])
                        # the staging writes .flac (the reference's) or .wav
                        for ext in (".flac", ".wav"):
                            if os.path.exists(base + ext):
                                self.files.append(base + ext)
                                n_spoof += 1
                                break
        self.labels = np.concatenate([np.ones(n_real, np.float32),
                                      np.zeros(n_spoof, np.float32)])

    def __len__(self):
        return len(self.files)

    def _compute(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        y, sr = dsp_host.load_wav(self.files[idx], sr=16000)
        y, _ = dsp_host.trim_silence(y, 22.0)
        y = dsp_host.preemphasis(y, cfg.preemph)
        lin = dsp_host.stft_mag(y, cfg.stft.fft_length, cfg.stft.hop_length)
        mel = mel_filterbank(sr, cfg.stft.fft_length, cfg.mel.freq_bins) @ lin
        lin_n = (lin / max(lin.max(), 1e-8)) ** cfg.norm.analysis_power
        mel_n = (mel / max(mel.max(), 1e-8)) ** cfg.norm.analysis_power
        r = cfg.mel.reduction
        tr = mel.shape[1] // r
        return (mel_n[:, : tr * r: r].T.astype(np.float32),
                lin_n[:, : tr * r].T.astype(np.float32))

    def _cache_path(self, idx: int, feat: str) -> str:
        key = hashlib.sha1(self.files[idx].encode()).hexdigest()[:20]
        return os.path.join(self.cache_dir, f"{key}.{feat}.npy")

    def get(self, idx: int, feat: str = "mel") -> Tuple[np.ndarray, float]:
        """One feature kind (``"mel"`` or ``"lin"``) of one utterance, through the cache."""
        if feat not in ("mel", "lin"):
            raise ValueError(f"feat must be 'mel' or 'lin', got {feat!r}")
        label = float(self.labels[idx])
        if self.cache_dir:
            p = self._cache_path(idx, feat)
            if os.path.exists(p):
                return np.load(p), label
        mel, lin = self._compute(idx)
        out = mel if feat == "mel" else lin
        if self.cache_dir:
            # only the requested kind: lin is ~25x mel's size and a run uses one kind
            path = self._cache_path(idx, feat)
            tmp = f"{path}.tmp.{os.getpid()}"
            np.save(tmp, out)
            os.replace(tmp + ".npy", path)
        return out, label

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, float]:
        mel, label = self.get(idx, "mel")
        lin, _ = self.get(idx, "lin")
        return mel, lin, label

    def warm_cache(self, feat: str = "mel", workers: int = 8) -> None:
        """Compute every utterance's features into the cache (threads)."""
        if not self.cache_dir:
            return
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            list(ex.map(lambda i: self.get(i, feat), range(len(self))))


def batches(source: ASVspoofSource, batch_size: int, bucket_frames, shuffle: bool,
            seed: int = 0, feat: str = "mel") -> Iterator[Dict[str, np.ndarray]]:
    """Static-bucket batches of ``{"x", "label", "mask", "idx"}`` (numpy):
    utterances fill per-bucket pools in (shuffled) order, a full pool is a
    batch, and the partial pools follow at the end."""
    order = np.arange(len(source))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    pool: Dict[int, List] = {}
    buckets = sorted(bucket_frames)

    def emit(items):
        t = max(x[0].shape[0] for x in items)
        tb = buckets[min(bisect.bisect_left(buckets, t), len(buckets) - 1)]
        f_dim = items[0][0].shape[1]
        x = np.zeros((len(items), tb, f_dim), np.float32)
        mask = np.zeros((len(items), tb), bool)
        lab = np.zeros((len(items),), np.float32)
        for j, (m, lbl, _) in enumerate(items):
            tt = min(m.shape[0], tb)
            x[j, :tt] = m[:tt]
            mask[j, :tt] = True
            lab[j] = lbl
        return {"x": x, "label": lab, "mask": mask,
                "idx": np.asarray([it[2] for it in items], np.int64)}

    for idx in order:
        m, label = source.get(int(idx), feat)
        b = buckets[min(bisect.bisect_left(buckets, m.shape[0]), len(buckets) - 1)]
        pool.setdefault(b, []).append((m, label, int(idx)))
        if len(pool[b]) == batch_size:
            yield emit(pool[b])
            pool[b] = []
    for items in pool.values():
        if items:
            yield emit(items)


class AMSGrad:
    """optax's ``chain(add_decayed_weights(weight_decay), amsgrad(lr, b1, b2,
    eps))`` on a module's parameters: g ← ∇ + wd·θ; μ ← b1·μ + (1−b1)·g;
    ν ← b2·ν + (1−b2)·g²; ν̂max ← max(ν̂max, ν/(1−b2ᵗ)); θ ← θ − lr·(μ/(1−b1ᵗ))
    / (√ν̂max + eps)."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-9, weight_decay: float = 1e-4):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, mu, nu, nu_max in zip(self.params, self.mu, self.nu, self.nu_max):
            g = p.grad + self.wd * p
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            torch.maximum(nu_max, nu / c2, out=nu_max)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu_max) + self.eps))


def cm_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """BCE of the clipped prediction with each log argument floored at 1e-6
    (``spoofsv_tpu/spoofkit/antispoof.py:205-209``)."""
    pred = pred.clamp(0.0, 1.0)
    return torch.mean(-label * torch.log(torch.clamp_min(pred, 1e-6))
                      - (1 - label) * torch.log(torch.clamp_min(1 - pred, 1e-6)))


def make_cm_train_step(model, lr: float = 1e-3, weight_decay: float = 1e-4,
                       generator: Optional[torch.Generator] = None):
    """BCE + AMSGrad (β = (0.9, 0.98), ε = 1e-9, weight decay 1e-4,
    ``anti_spoofing/main_spoof_conv1d.py:52,87``) on ``model``'s parameters
    in place. Returns ``(step_fn, score_fn, optimizer)``: ``step_fn(x,
    label)`` takes one step, its dropout drawn from ``generator``, and
    returns the loss (a 0-d tensor, not synchronized); ``score_fn(x)`` is
    the deterministic forward."""
    opt = AMSGrad(model.parameters(), lr=lr, weight_decay=weight_decay)

    def step_fn(x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        for p in opt.params:
            p.grad = None
        loss = cm_loss(model(x, deterministic=False, generator=generator), label)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def score_fn(x: torch.Tensor) -> torch.Tensor:
        return model(x, deterministic=True)

    return step_fn, score_fn, opt


def write_cm_scores(scores: List[Tuple[int, float, float]], ctime: str,
                    out_dir: str = "./cm_scores") -> str:
    """ASVspoof-format score file (``anti_spoofing/main_spoof_conv1d.py:109-129``)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"scores_{ctime}.txt")
    with open(path, "w") as f:
        for idx, label, score in scores:
            gt = "bonafide" if label == 1 else "spoof"
            f.write(f"LA_D_{str(idx).zfill(7)} - {gt} {score}\n")
    return path


def cm_eer(labels: np.ndarray, scores: np.ndarray) -> Tuple[float, float]:
    """Equal error rate of CM scores (bonafide = 1 scores high): (eer, threshold)."""
    order = np.argsort(scores)
    labels = np.asarray(labels)[order]
    scores = np.asarray(scores)[order]
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    fn = np.cumsum(labels)               # positives below the threshold (rejected)
    tn = np.cumsum(1 - labels)           # negatives below the threshold (correct)
    frr = fn / max(n_pos, 1)
    far = (n_neg - tn) / max(n_neg, 1)
    k = int(np.argmin(np.abs(far - frr)))
    return float((far[k] + frr[k]) / 2), float(scores[k])
