"""Host-side data pipeline: feature extraction, caching, bucketed batching.

Port of :mod:`spoofsv_tpu.data.pipeline`:

  * features are extracted once per utterance (threaded) into an ``.npy``
    cache written atomically (tmp + rename), so concurrent writers never
    leave a half-written file;
  * batches are padded to a few static bucket shapes
    (``cfg.tpu.bucket_frames`` × ``bucket_text``);
  * every batch carries validity masks (``mel_mask``, ``text_mask``,
    ``att_mask``, ``lin_mask``) so losses can ignore padding.

:class:`TTSDataSource`, :func:`pad_batch` and :class:`BucketedLoader` are
numpy; :class:`DeviceReplayLoader` keeps the padded bucket groups on a
torch device and gathers each batch there.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spoofsv_torch import resolve_device
from spoofsv_torch.config import Config
from spoofsv_torch.data.text import build_char2idx, text2id
from spoofsv_torch.data.vctk import speaker_id_from_path, utterance_id_from_path
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.parallel.mesh import LocalRows, Mesh, active, batch_sharding


def _atomic_save(path: str, arr: np.ndarray) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


class TTSExample:
    __slots__ = ("mel", "lin", "text", "spk", "utt_id")

    def __init__(self, mel, lin, text, spk, utt_id):
        self.mel, self.lin, self.text, self.spk, self.utt_id = mel, lin, text, spk, utt_id


class TTSDataSource:
    """Reads the reference path lists and produces per-utterance features:
    path lists from ``data_path/ordinary/{wav,txt}.path.<mode>`` (or the
    ``ubm-finetune`` stage lists), a feature cache keyed by utterance id in
    ``spec_dir``, per-speaker embeddings from ``cfg.spk_emb_dir``."""

    def __init__(self, cfg: Config, mode: str = "train", spec_dir: Optional[str] = None,
                 need_lin: bool = True, pattern: str = "conditional",
                 stage: Optional[str] = None):
        self.cfg = cfg
        self.mode = mode
        self.spec_dir = spec_dir
        self.need_lin = need_lin
        if pattern == "ubm-finetune":
            if stage not in ("ubm", "finetune"):
                raise ValueError(f"the ubm-finetune pattern needs a stage (ubm|finetune), "
                                 f"got {stage!r}")
            base = os.path.join(cfg.data_root_dir, "data_path", "ubm-finetune")
            wav_name, txt_name = f"wav.path.{stage}.{mode}", f"txt.path.{stage}.{mode}"
        else:
            base = os.path.join(cfg.data_root_dir, "data_path", "ordinary")
            wav_name, txt_name = f"wav.path.{mode}", f"txt.path.{mode}"
        with open(os.path.join(base, wav_name)) as f:
            self.wav_paths = [ln.strip() for ln in f if ln.strip()]
        with open(os.path.join(base, txt_name)) as f:
            self.txt_paths = [ln.strip() for ln in f if ln.strip()]
        if len(self.wav_paths) != len(self.txt_paths):
            raise ValueError(f"{base}: {len(self.wav_paths)} wav paths but "
                             f"{len(self.txt_paths)} txt paths")
        self.char2idx = build_char2idx(cfg.vocabulary)
        self._spk_cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.wav_paths)

    def speaker_embedding(self, spk: str) -> np.ndarray:
        if spk not in self._spk_cache:
            self._spk_cache[spk] = np.load(
                os.path.join(self.cfg.spk_emb_dir, spk + ".npy")).astype(np.float32)
        return self._spk_cache[spk]

    def _features(self, wav_path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        utt = utterance_id_from_path(wav_path)
        if self.spec_dir:
            mel_p = os.path.join(self.spec_dir, utt + "_mel.npy")
            lin_p = os.path.join(self.spec_dir, utt + "_lin.npy")
            if os.path.exists(mel_p) and (not self.need_lin or os.path.exists(lin_p)):
                return np.load(mel_p), (np.load(lin_p) if self.need_lin else None)
        y, sr = dsp_host.load_wav(wav_path)
        mel, lin = dsp_host.tts_features(y, sr, self.cfg)
        if self.spec_dir:
            os.makedirs(self.spec_dir, exist_ok=True)
            _atomic_save(os.path.join(self.spec_dir, utt + "_mel.npy"), mel)
            _atomic_save(os.path.join(self.spec_dir, utt + "_lin.npy"), lin)
        return mel, (lin if self.need_lin else None)

    def __getitem__(self, idx: int) -> TTSExample:
        wav_path = self.wav_paths[idx]
        mel, lin = self._features(wav_path)
        with open(self.txt_paths[idx]) as f:
            raw = f.readline().strip()
        text = text2id(raw, self.cfg.vocabulary, self.char2idx)
        spk = self.speaker_embedding(speaker_id_from_path(wav_path))
        return TTSExample(mel, lin, text, spk, utterance_id_from_path(wav_path))

    def warm_cache(self, workers: int = 8) -> None:
        """Precompute every utterance's features into the cache."""
        if not self.spec_dir:
            return
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            list(ex.map(self._features, self.wav_paths))


def _bucket_for(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ value; the largest when none is (content truncated)."""
    i = bisect.bisect_left(buckets, value)
    return buckets[min(i, len(buckets) - 1)]


def pad_batch(examples: List[TTSExample], cfg: Config,
              with_lin: bool = False) -> Dict[str, np.ndarray]:
    """Pad a list of examples to static bucket shapes, with masks."""
    r = cfg.mel.reduction
    t_bucket = _bucket_for(max(e.mel.shape[0] for e in examples), cfg.tpu.bucket_frames)
    n_bucket = _bucket_for(max(len(e.text) for e in examples), cfg.tpu.bucket_text)
    b = len(examples)
    mel = np.zeros((b, t_bucket, cfg.mel.freq_bins), np.float32)
    text = np.zeros((b, n_bucket), np.int32)
    spk = np.zeros((b, cfg.spk_emb_dim), np.float32)
    mel_mask = np.zeros((b, t_bucket), bool)
    text_mask = np.zeros((b, n_bucket), bool)
    if with_lin:
        lin = np.zeros((b, t_bucket * r, cfg.lin_bins), np.float32)
        lin_mask = np.zeros((b, t_bucket * r), bool)
    for i, e in enumerate(examples):
        t = min(e.mel.shape[0], t_bucket)
        n = min(len(e.text), n_bucket)
        mel[i, :t] = e.mel[:t]
        text[i, :n] = e.text[:n]
        spk[i] = e.spk
        mel_mask[i, :t] = True
        text_mask[i, :n] = True
        if with_lin and e.lin is not None:
            tl = min(e.lin.shape[0], t_bucket * r)
            lin[i, :tl] = e.lin[:tl]
            lin_mask[i, :tl] = True
    batch = {"mel": mel, "text": text, "spk": spk, "mel_mask": mel_mask,
             "text_mask": text_mask, "att_mask": text_mask[:, :, None] & mel_mask[:, None, :]}
    if with_lin:
        batch["lin"] = lin
        batch["lin_mask"] = lin_mask
    return batch


class BucketedLoader:
    """Shuffling batch iterator grouped by mel-length bucket, so each batch
    pads to one of a few static shapes. Leftovers are flushed per bucket."""

    def __init__(self, source: TTSDataSource, batch_size: int, with_lin: bool = False,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.source = source
        self.batch_size = batch_size
        self.with_lin = with_lin
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.source))
        if self.shuffle:
            self._rng.shuffle(order)
        cfg = self.source.cfg
        pools: Dict[int, List[TTSExample]] = {}
        for idx in order:
            e = self.source[int(idx)]
            bucket = _bucket_for(e.mel.shape[0], cfg.tpu.bucket_frames)
            pool = pools.setdefault(bucket, [])
            pool.append(e)
            if len(pool) == self.batch_size:
                yield pad_batch(pool, cfg, self.with_lin)
                pools[bucket] = []
        if not self.drop_last:
            for bucket in sorted(pools):
                pool = pools[bucket]
                for i in range(0, len(pool), self.batch_size):
                    chunk = pool[i: i + self.batch_size]
                    if chunk:
                        yield pad_batch(chunk, cfg, self.with_lin)


class DeviceReplayLoader:
    """The bucket-padded dataset resident on ``device`` (the card unless the
    caller passes ``device="cpu"``), batches gathered there.

    Every example is padded to its (frames, text) bucket once, each bucket
    group is stacked and moved to the device in one copy, and each batch is
    an ``index_select`` of its group: no per-step host→device feature
    traffic. The epoch order (the permutation within each group, then the
    order of the batches) comes from ``np.random.default_rng(seed)`` as in
    the JAX loader, so for a seed both yield the same batches; it advances
    on every ``__iter__``, so build the loader once and reuse it.
    :attr:`nbytes` is the resident size.

    ``mesh``: a :class:`~spoofsv_torch.parallel.mesh.Mesh` for data-parallel
    training; every rank builds the loader alike. The bucket groups are
    replicated on every rank's device (``mesh.device``), every rank draws
    the same epoch order from the same seed, each chunk is trimmed to a
    multiple of the rank count (a chunk of fewer rows is skipped), and each
    rank gathers its rows of it: the batches are
    :class:`~spoofsv_torch.parallel.mesh.LocalRows`.
    """

    def __init__(self, source: TTSDataSource, batch_size: int, with_lin: bool = False,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False, mesh=None,
                 device=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a spoofsv_torch.parallel.mesh.Mesh, got {mesh!r}")
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = active(mesh)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        cfg = source.cfg
        groups: Dict[Tuple[int, int], List[TTSExample]] = {}
        for i in range(len(source)):
            e = source[i]
            key = (_bucket_for(e.mel.shape[0], cfg.tpu.bucket_frames),
                   _bucket_for(len(e.text), cfg.tpu.bucket_text))
            groups.setdefault(key, []).append(e)
        self._groups = [{k: torch.from_numpy(v).to(self.device)
                         for k, v in pad_batch(groups[key], cfg, with_lin).items()}
                        for key in sorted(groups)]
        self.nbytes = sum(t.numel() * t.element_size() for g in self._groups for t in g.values())

    def __len__(self) -> int:
        return sum(g["mel"].shape[0] for g in self._groups)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        descs = []
        for gi, g in enumerate(self._groups):
            n = g["mel"].shape[0]
            perm = self._rng.permutation(n) if self.shuffle else np.arange(n)
            for s in range(0, n, self.batch_size):
                chunk = perm[s: s + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                if self.mesh is not None:
                    chunk = chunk[: len(chunk) // self.mesh.size * self.mesh.size]
                    if not len(chunk):
                        continue
                descs.append((gi, chunk))
        if self.shuffle and len(descs) > 1:
            descs = [descs[int(i)] for i in self._rng.permutation(len(descs))]
        for gi, chunk in descs:
            if self.mesh is not None:
                chunk = chunk[batch_sharding(self.mesh, len(chunk))]
            idx = torch.from_numpy(np.asarray(chunk, np.int64)).to(self.device)
            rows = {k: v.index_select(0, idx) for k, v in self._groups[gi].items()}
            yield rows if self.mesh is None else LocalRows(rows)
