"""GE2E speaker verification: preprocess, train, test, spoof rate.

Port of :mod:`spoofsv_tpu.spoofkit.ge2e_harness` (the reference
``GE2E/data_preprocess.py`` and ``GE2E/train_speech_embedder.py``):

  * TI-SV preprocessing with the reference's staging rules: log10 mel power,
    the first and last 120-frame crops of each utterance, train speakers
    capped at 100 utterances, test speakers laid out as 2·(enroll+eval)
    crops, enroll first, padded by random duplication (numpy
    ``default_rng(seed)``) when short (``GE2E/data_preprocess.py:36-93``);
  * the training step: the LSTM embedder, the GE2E loss, a gradient clip per
    group (3.0 for the embedder, 1.0 for ``(w, b)``,
    ``train_speech_embedder.py:84-85``) and SGD;
  * the test harness: the EER sweep over thresholds 0.5 + 0.01·i, FAR, FRR,
    gt-FRR and the spoof rate at the EER threshold, the clean threshold of
    the real-only set, and the average spoof rate at it (``:113-322``).

Batches are drawn from the same numpy streams as the JAX package's, so the
same seed gives the same crops. Training and embedding run on ``device``
(the card unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from spoofsv_torch import resolve_device
from spoofsv_torch.config import GE2EConfig
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.models.ge2e import GE2ELoss, SpeechEmbedder, get_centroids, get_cossim
from spoofsv_torch.weights import load_ge2e_params, save_ge2e_checkpoint

# ----------------------------------------------------------------------
# Preprocessing (TI-SV crops)
# ----------------------------------------------------------------------


def save_spectrogram_tisv(ge2e: GE2EConfig, train_spk_num: int, enroll_num: int,
                          eval_num: int, seed: Optional[int] = None,
                          verbose: bool = True) -> None:
    """Crop and save each speaker's feature arrays (``GE2E/data_preprocess.py:15-93``):
    ``<train_path>/speaker<i>.npy`` for the first ``train_spk_num`` speaker
    directories (sorted on their last three characters), ``<test_path>/
    speaker<i>.npy`` of 2·(enroll_num + eval_num) crops for the others.

    The reference passes ``enroll_num = enroll + eval`` here (``:102``), so
    "enroll" means all the real crops."""
    rng = np.random.default_rng(seed)
    audio_dirs = sorted(glob.glob(os.path.dirname(ge2e.unprocessed_data)), key=lambda x: x[-3:])
    os.makedirs(ge2e.data.train_path, exist_ok=True)
    os.makedirs(ge2e.data.test_path, exist_ok=True)
    d = ge2e.data
    utter_min_len = (d.tisv_frame * d.hop + d.window) * d.sr

    for i, folder in enumerate(audio_dirs):
        utterances: List[np.ndarray] = []
        eval_spec: List[np.ndarray] = []
        if i < train_spk_num:
            utts_list = os.listdir(folder)[:100]
        else:
            utts_list = sorted(os.listdir(folder), key=lambda x: x[:-4])
        for k, utter_name in enumerate(utts_list):
            if not utter_name.endswith(".wav"):
                continue
            y, _ = dsp_host.load_wav(os.path.join(folder, utter_name), sr=d.sr)
            y, _ = dsp_host.trim_silence(y, 30.0)
            if len(y) > utter_min_len:
                S = dsp_host.ge2e_logmel(y, d.sr, d.nfft, d.window, d.hop, d.nmels)
                crops = [S[:, : d.tisv_frame], S[:, -d.tisv_frame:]]
                if i >= train_spk_num and k >= enroll_num:
                    eval_spec += crops
                else:
                    utterances += crops

        if i >= train_spk_num:
            # the reference's duplication rules (:66-83)
            n_enroll = len(utterances)
            if 2 * enroll_num - n_enroll > 0:
                for _ in range(enroll_num - n_enroll // 2):
                    utterances.append(utterances[rng.integers(0, n_enroll // 2)])
                    utterances.append(utterances[rng.integers(0, n_enroll // 2)])
            n_eval = len(eval_spec)
            if 2 * eval_num - n_eval > 0:
                for _ in range(eval_num - n_eval // 2):
                    eval_spec.append(eval_spec[rng.integers(0, n_eval // 2)])
                    eval_spec.append(eval_spec[rng.integers(0, n_eval // 2)])
            utterances = utterances + eval_spec
            arr = np.array(utterances)
            assert arr.shape[0] == 2 * (enroll_num + eval_num)   # :88
            np.save(os.path.join(d.test_path, f"speaker{i - train_spk_num}.npy"), arr)
        else:
            np.save(os.path.join(d.train_path, f"speaker{i}.npy"), np.array(utterances))
        if verbose:
            print(f"speaker {i} ({'train' if i < train_spk_num else 'test'}): "
                  f"{len(utterances)} crops")


def save_spectrogram_tisv_generic(ge2e: GE2EConfig, verbose: bool = True) -> None:
    """The generic preprocessor for plain corpora
    (``GE2E/synthetic_data_preprocess.py:13-52``): the first and last
    ``tisv_frame`` frames of every long enough non-silent interval; speakers
    split ``(total // 10) * 8`` train, the rest test."""
    audio_dirs = sorted(glob.glob(os.path.dirname(ge2e.unprocessed_data)))
    os.makedirs(ge2e.data.train_path, exist_ok=True)
    os.makedirs(ge2e.data.test_path, exist_ok=True)
    d = ge2e.data
    utter_min_len = (d.tisv_frame * d.hop + d.window) * d.sr
    train_speaker_num = (len(audio_dirs) // 10) * 8
    for i, folder in enumerate(audio_dirs):
        utterances = []
        for utter_name in os.listdir(folder):
            if not utter_name.endswith(".wav"):
                continue
            y, _ = dsp_host.load_wav(os.path.join(folder, utter_name), sr=d.sr)
            for a, b in dsp_host.split_nonsilent(y, top_db=30.0):
                if b - a > utter_min_len:
                    S = dsp_host.ge2e_logmel(y[a:b], d.sr, d.nfft, d.window, d.hop, d.nmels)
                    utterances += [S[:, : d.tisv_frame], S[:, -d.tisv_frame:]]
        if i < train_speaker_num:
            path = os.path.join(d.train_path, f"speaker{i}.npy")
        else:
            path = os.path.join(d.test_path, f"speaker{i - train_speaker_num}.npy")
        np.save(path, np.array(utterances))
        if verbose:
            print(f"speaker {i}: {len(utterances)} crops")


# ----------------------------------------------------------------------
# Batching
# ----------------------------------------------------------------------

def _speaker_files(path: str) -> List[str]:
    return sorted(os.listdir(path), key=lambda x: int(x[7:-4]) if x[7:-4].isdigit() else 0)


class OnTheFlySpeakerBatcher:
    """Features computed per speaker directory as batches are drawn (the
    reference's ``SpeakerDatasetTIMIT``, ``GE2E/data_load.py:19-46``)."""

    def __init__(self, ge2e: GE2EConfig, m: int, seed: int = 0):
        self.ge2e = ge2e
        self.m = m
        pattern = (ge2e.data.train_path_unprocessed if ge2e.training
                   else ge2e.data.test_path_unprocessed) or ge2e.unprocessed_data
        self.speakers = sorted(glob.glob(os.path.dirname(pattern)))
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.speakers)

    def sample_batch(self, n: int) -> np.ndarray:
        """(N, M, tisv_frame + 1, nmels)."""
        d = self.ge2e.data
        out = []
        for i in self.rng.choice(len(self.speakers), size=n, replace=False):
            folder = self.speakers[int(i)]
            wavs = [f for f in os.listdir(folder) if f.lower().endswith(".wav")]
            self.rng.shuffle(wavs)
            feats = []
            for w in wavs[: self.m]:
                y, _ = dsp_host.load_wav(os.path.join(folder, w), sr=d.sr)
                _, mel_db, _ = dsp_host.mfccs_and_spec(y, d.sr, d.nfft, d.window, d.hop,
                                                       d.nmels, d.tisv_frame, wav_process=True)
                feats.append(mel_db[: d.tisv_frame + 1])
            out.append(np.stack(feats))
        return np.stack(out)


class SpeakerBatcher:
    """Preprocessed speaker arrays → (N, M, frames, nmels) batches
    (``GE2E/data_load.py:48-86``)."""

    def __init__(self, path: str, m: int, shuffle: bool = True, seed: int = 0):
        self.path = path
        self.files = _speaker_files(path)
        self.m = m
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, fname: str) -> np.ndarray:
        if fname not in self._cache:
            self._cache[fname] = np.load(os.path.join(self.path, fname))
        return self._cache[fname]

    def sample_batch(self, n: int) -> np.ndarray:
        """(N, M, frames, nmels), time-major per utterance."""
        idx = (self.rng.choice(len(self.files), size=n, replace=False) if self.shuffle
               else np.arange(n))
        out = []
        for i in idx:
            utters = self._load(self.files[int(i)])      # (U, nmels, frames)
            sel = (self.rng.integers(0, utters.shape[0], self.m) if self.shuffle
                   else np.arange(self.m))
            out.append(np.transpose(utters[sel], (0, 2, 1)))
        return np.stack(out)

    def ordered_batches(self, n: int):
        """Consecutive groups of ``n`` speakers in order, the last partial
        group dropped."""
        for s in range(0, (len(self.files) // n) * n, n):
            yield np.stack([np.transpose(self._load(self.files[i])[: self.m], (0, 2, 1))
                            for i in range(s, s + n)])


class DeviceSpeakerBank:
    """Every speaker's crops on the device at once, (total, frames, nmels)
    f32; a step ships only its N·M gather indices. The indices come from the
    same numpy stream as :class:`SpeakerBatcher`'s (the speakers' ``choice``,
    then ``integers`` per speaker), so the batches are the host path's."""

    def __init__(self, path: str, m: int, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.files = _speaker_files(path)
        self.m = m
        self.rng = np.random.default_rng(seed)
        arrays = [np.load(os.path.join(path, f)) for f in self.files]
        self.counts = np.array([a.shape[0] for a in arrays])
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)[:-1]])
        flat = np.concatenate([np.transpose(a, (0, 2, 1)) for a in arrays])
        self.flat = torch.from_numpy(np.ascontiguousarray(flat, np.float32)).to(self.device)

    def __len__(self) -> int:
        return len(self.files)

    @property
    def nbytes(self) -> int:
        return self.flat.numel() * self.flat.element_size()

    def sample_indices(self, n: int) -> np.ndarray:
        """The (N·M,) rows of the next batch."""
        spk = self.rng.choice(len(self.files), size=n, replace=False)
        idx = np.empty((n, self.m), np.int64)
        for i, s in enumerate(spk):
            idx[i] = self.offsets[s] + self.rng.integers(0, self.counts[s], self.m)
        return idx.reshape(-1)

    def sample_batch(self, n: int) -> torch.Tensor:
        """The next batch on the device, flat: (N·M, frames, nmels)."""
        idx = torch.from_numpy(self.sample_indices(n)).to(self.device, non_blocking=True)
        return self.flat.index_select(0, idx)


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------

def build_ge2e(ge2e: GE2EConfig, device=None, seed: int = 0):
    """The embedder (the configuration's widths, initialised from ``seed``)
    and the ``(w, b)`` loss module, on ``device``."""
    device = resolve_device(device)
    emb = SpeechEmbedder(ge2e.data.nmels, ge2e.model.hidden, ge2e.model.num_layer,
                         ge2e.model.proj, generator=torch.Generator().manual_seed(seed))
    return emb.to(device), GE2ELoss().to(device)


def make_ge2e_train_step(embedder: SpeechEmbedder, loss_mod: GE2ELoss, lr: float,
                         n_speakers: Optional[int] = None):
    """Returns ``step(batch) -> loss`` (a 0-d tensor on the device): the
    embedder on the (N, M, frames, nmels) batch, or a flat (N·M, ...) one of
    :class:`DeviceSpeakerBank` when ``n_speakers`` is set; the GE2E loss;
    the per-group clip; one SGD update of both modules in place.

    flax's LSTM cell has one bias a gate, which the bridge puts in
    ``bias_ih`` (``bias_hh`` zero). Training both torch biases would move
    that sum by twice the step and count its gradient twice in the clip, so
    ``bias_hh`` stays where it is, as in the JAX package."""
    emb_params = [p for name, p in embedder.named_parameters() if ".bias_hh" not in name]
    loss_params = list(loss_mod.parameters())
    opt = torch.optim.SGD(emb_params + loss_params, lr=lr)

    def step(batch) -> torch.Tensor:
        dev = next(embedder.parameters()).device
        batch = torch.as_tensor(batch).to(dev)
        if batch.ndim == 3:
            assert n_speakers, "flat batches need n_speakers at factory time"
            batch = batch.reshape(n_speakers, -1, *batch.shape[1:])
        n, m = batch.shape[:2]
        embedder.train()
        e = embedder(batch.reshape(n * m, *batch.shape[2:])).reshape(n, m, -1)
        loss = loss_mod(e)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        # per group, scale min(1, max / (norm + 1e-6)), as the JAX harness clips
        torch.nn.utils.clip_grad_norm_(emb_params, 3.0)
        torch.nn.utils.clip_grad_norm_(loss_params, 1.0)
        opt.step()
        return loss.detach()

    return step


def train_ge2e(ge2e: GE2EConfig, max_epochs: Optional[int] = None, seed: int = 0,
               verbose: bool = True, device_data: bool = True, device=None):
    """The GE2E training loop (``GE2E/train_speech_embedder.py:40-111``):
    ``len(speakers) // N`` steps an epoch, the losses read back every
    ``log_interval`` steps, ``ckpt_epoch_<e>.npz`` every
    ``checkpoint_interval`` epochs and ``final_epoch_<epochs>.npz`` at the
    end. ``device_data`` keeps the crops on the device
    (:class:`DeviceSpeakerBank`); either way the batches are those of
    :class:`SpeakerBatcher` with ``seed``. Returns ``(embedder, loss_mod)``."""
    device = resolve_device(device)
    embedder, loss_mod = build_ge2e(ge2e, device, seed)
    n = ge2e.train.N
    if device_data:
        batcher = DeviceSpeakerBank(ge2e.data.train_path, ge2e.train.M, seed=seed, device=device)
    else:
        batcher = SpeakerBatcher(ge2e.data.train_path, ge2e.train.M, shuffle=True, seed=seed)
    step = make_ge2e_train_step(embedder, loss_mod, ge2e.train.lr, n_speakers=n)
    # the JAX loop draws one batch for its parameter init first: keep the stream
    batcher.sample_batch(n)
    os.makedirs(ge2e.train.checkpoint_dir, exist_ok=True)
    epochs = max_epochs or ge2e.train.epochs
    iteration = 0
    batches_per_epoch = max(1, len(batcher) // n)

    def log(msg: str) -> None:
        print(msg)
        if ge2e.train.log_file:
            os.makedirs(os.path.dirname(ge2e.train.log_file) or ".", exist_ok=True)
            with open(ge2e.train.log_file, "a") as f:
                f.write(msg + "\n")

    for e in range(epochs):
        total, fetched = 0.0, 0
        pending: List[torch.Tensor] = []   # losses since the last read-back
        for b in range(batches_per_epoch):
            pending.append(step(batcher.sample_batch(n)))
            iteration += 1
            if verbose and (b + 1) % ge2e.train.log_interval == 0:
                vals = torch.stack(pending).cpu().numpy()   # one read-back
                total += float(vals.sum())
                fetched += len(vals)
                pending = []
                log(f"Epoch:{e + 1}[{b + 1}/{batches_per_epoch}],Iteration:{iteration}\t"
                    f"Loss:{float(vals[-1]):.4f}\tTLoss:{total / fetched:.4f}")
        if (e + 1) % ge2e.train.checkpoint_interval == 0:
            save_ge2e_checkpoint(os.path.join(ge2e.train.checkpoint_dir,
                                              f"ckpt_epoch_{e + 1}.npz"), embedder, loss_mod)
    save_ge2e_checkpoint(os.path.join(ge2e.train.checkpoint_dir, f"final_epoch_{epochs}.npz"),
                         embedder, loss_mod)
    return embedder, loss_mod


# ----------------------------------------------------------------------
# Test harness: EER and spoof rate
# ----------------------------------------------------------------------

@torch.no_grad()
def embed_test_batch(embedder: SpeechEmbedder, batch: np.ndarray, enroll_num: int):
    """(N, M, frames, nmels) test batch → (e_enroll (N, 2e, D), e_verif
    (N, M-2e, D)) on the embedder's device (the embedding passes of
    ``GE2E/train_speech_embedder.py:131-160``)."""
    dev = next(embedder.parameters()).device
    was = embedder.training
    embedder.eval()
    n, m = batch.shape[:2]
    es1 = 2 * enroll_num
    batch = torch.as_tensor(np.ascontiguousarray(batch, np.float32)).to(dev)
    try:
        e_enroll = embedder(batch[:, :es1].reshape(n * es1, *batch.shape[2:])).reshape(n, es1, -1)
        e_verif = embedder(batch[:, es1:].reshape(n * (m - es1), *batch.shape[2:])
                           ).reshape(n, m - es1, -1)
    finally:
        embedder.train(was)
    return e_enroll, e_verif


@torch.no_grad()
def sim_from_embeddings(e_verif: torch.Tensor, e_enroll: torch.Tensor) -> np.ndarray:
    """(N, V, D) verification and (N, 2e, D) enrollment embeddings → the
    (N, V, N) similarity matrix (``train_speech_embedder.py:161-165``). The
    own-speaker diagonal is the reference's ``get_cossim`` quirk: the cosine
    against the leave-one-out mean of speaker j's *verification* embeddings,
    so it depends on which verification rows are passed in (see
    :func:`run_ge2e_evaluation`)."""
    return get_cossim(e_verif, get_centroids(e_enroll)).float().cpu().numpy()


def build_sim_matrix(embedder: SpeechEmbedder, batch: np.ndarray, enroll_num: int
                     ) -> np.ndarray:
    """(N, M, frames, nmels) test batch → the (N, M-2e, N) similarity matrix."""
    e_enroll, e_verif = embed_test_batch(embedder, batch, enroll_num)
    return sim_from_embeddings(e_verif, e_enroll)


def eer_sweep(sim: np.ndarray, enroll_num: int, with_spoof: bool = True) -> Dict[str, float]:
    """The threshold sweep 0.5 + 0.01·i (``train_speech_embedder.py:176-196``):
    EER, threshold, FAR, FRR and, ``with_spoof`` (verification rows = [real |
    spoof], each half 2·eval crops), the gt-FRR and spoof rate at the EER
    threshold."""
    n, n_verif, _ = sim.shape
    best = {"diff": 1.0, "EER": 0.0, "thresh": 0.0, "FAR": 0.0, "FRR": 0.0,
            "gt_FRR": 0.0, "spoof_rate": 0.0}
    half = n_verif // 2
    for i in range(50):
        thres = 0.5 + 0.01 * i
        t = sim > thres
        far = sum(t[j].sum() - t[j, :, j].sum() for j in range(n)) / (n - 1) / n_verif / n
        frr = sum(n_verif - t[j, :, j].sum() for j in range(n)) / n_verif / n
        if with_spoof:
            gtfrr = sum(half - t[j, :half, j].sum() for j in range(n)) / half / n
            sr = sum(t[j, -half:, j].sum() for j in range(n)) / half / n
        else:
            gtfrr, sr = frr, 0.0
        diff = abs(far - frr)
        if diff < best["diff"]:
            best = {"diff": diff, "EER": (far + frr) / 2, "thresh": thres, "FAR": float(far),
                    "FRR": float(frr), "gt_FRR": float(gtfrr), "spoof_rate": float(sr)}
    return best


def spoof_rate_at_threshold(sim: np.ndarray, threshold: float, eval_num: int) -> float:
    """The mixed matrix's spoof rate at an outside (the clean EER's) threshold
    (``train_speech_embedder.py:313-322``)."""
    n = sim.shape[0]
    t = sim > threshold
    return float(sum(t[j, -2 * eval_num:, j].sum() for j in range(n)) / (2 * eval_num) / n)


def preprocess_nospoof_tisv(ge2e: GE2EConfig, nospoof_glob: str, enroll_num: int,
                            eval_num: int, out_path: Optional[str] = None,
                            seed: Optional[int] = None, verbose: bool = True) -> str:
    """Preprocess the staged real-only ``test_nospoof`` copy into its own
    TI-SV directory (the reference's second preprocessing pass,
    ``train_speech_embedder.py:205-298``): every speaker a test speaker of
    2·(enroll+eval) real crops in sorted-name order."""
    out = out_path or (ge2e.data.test_path.rstrip("/") + "_nospoof")
    ns_cfg = dataclasses.replace(ge2e, unprocessed_data=nospoof_glob,
                                 data=dataclasses.replace(ge2e.data, test_path=out))
    save_spectrogram_tisv(ns_cfg, train_spk_num=0, enroll_num=enroll_num + eval_num,
                          eval_num=0, seed=seed, verbose=verbose)
    return out


def run_ge2e_evaluation(ge2e: GE2EConfig, enroll_num: int = 3, eval_num: int = 20,
                        model_path: Optional[str] = None, epochs: Optional[int] = None,
                        verbose: bool = True, nospoof_data: Optional[str] = None,
                        nospoof_test_path: Optional[str] = None, seed: Optional[int] = None,
                        device=None) -> Dict[str, float]:
    """The reference's evaluation (``train_speech_embedder.py:300-322``): the
    mixed test (EER, spoof rate at its threshold), the clean threshold, then
    the mixed matrices' average spoof rate at the clean threshold. Each
    matrix is saved as ``<save_simmat_dir>/simmat_e<e>_b<b>.npy``.

    The clean threshold comes from the staged real-only copy when
    ``nospoof_data`` (a glob over ``ivector_data/test_nospoof/*/*.wav``) is
    given, else from the slice formulation: the cossim again on the first
    2·eval verification *embeddings* only (the staging puts the real crops
    first). The slice is taken on the embeddings before the cossim, never on
    the mixed matrix, whose own-speaker diagonal is averaged over the spoof
    rows too."""
    device = resolve_device(device)
    embedder, _ = build_ge2e(ge2e, device)
    load_ge2e_params(model_path or ge2e.model.model_path, embedder)
    batcher = SpeakerBatcher(ge2e.data.test_path, ge2e.test.M, shuffle=False)
    os.makedirs(ge2e.save_simmat_dir, exist_ok=True)

    n_epochs = epochs or ge2e.test.epochs
    simmats, mixed_results, slice_thresholds = [], [], []
    for e in range(n_epochs):
        for bi, batch in enumerate(batcher.ordered_batches(ge2e.test.N)):
            e_enroll, e_verif = embed_test_batch(embedder, batch, enroll_num)
            sim = sim_from_embeddings(e_verif, e_enroll)
            np.save(os.path.join(ge2e.save_simmat_dir, f"simmat_e{e + 1}_b{bi + 1}.npy"), sim)
            simmats.append(sim)
            r = eer_sweep(sim, enroll_num, with_spoof=True)
            mixed_results.append(r)
            r_ns = eer_sweep(sim_from_embeddings(e_verif[:, : 2 * eval_num], e_enroll),
                             enroll_num, with_spoof=False)
            slice_thresholds.append(r_ns["thresh"])
            if verbose:
                print(f"epoch {e + 1} batch {bi + 1}: EER={r['EER']:.4f} "
                      f"(thres {r['thresh']:.2f}) clean-thres {r_ns['thresh']:.2f}")

    staged_thresholds: List[float] = []
    if nospoof_data is not None:
        ns_path = preprocess_nospoof_tisv(ge2e, nospoof_data, enroll_num, eval_num,
                                          out_path=nospoof_test_path, seed=seed, verbose=verbose)
        ns_batcher = SpeakerBatcher(ns_path, 2 * (enroll_num + eval_num), shuffle=False)
        for e in range(n_epochs):
            for bi, batch in enumerate(ns_batcher.ordered_batches(ge2e.test.N)):
                r_ns = eer_sweep(build_sim_matrix(embedder, batch, enroll_num), enroll_num,
                                 with_spoof=False)
                staged_thresholds.append(r_ns["thresh"])
                if verbose:
                    print(f"nospoof epoch {e + 1} batch {bi + 1}: EER={r_ns['EER']:.4f} "
                          f"thres {r_ns['thresh']:.2f}")

    clean_thres = float(np.mean(staged_thresholds or slice_thresholds))
    result = {"EER": float(np.mean([r["EER"] for r in mixed_results])),
              "clean_threshold": clean_thres,
              "clean_threshold_slice": float(np.mean(slice_thresholds)),
              "spoof_rate": float(np.mean([spoof_rate_at_threshold(s, clean_thres, eval_num)
                                           for s in simmats])),
              "spoof_rate_at_eer": float(np.mean([r["spoof_rate"] for r in mixed_results])),
              "gt_FRR": float(np.mean([r["gt_FRR"] for r in mixed_results]))}
    if verbose:
        print(json.dumps(result, indent=2))
    return result
