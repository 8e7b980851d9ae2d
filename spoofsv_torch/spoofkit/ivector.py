"""i-vector + PLDA speaker verification: the native backend and the pipeline.

Port of :mod:`spoofsv_tpu.spoofkit.ivector`: Python orchestration of the
port's own ``libspoofkit`` (:func:`spoofsv_torch.native.load_lib`) in place of
the reference's external Kaldi scripts (``kaldi_ivectors/run.sh``): MFCC,
energy VAD and sliding CMVN → diag UBM → i-vector extractor (T-matrix EM)
→ PLDA → trial scoring → EER and spoof rate. The stages follow run.sh:

  1. feature extraction over the staged ``ivector_data`` wavs (:92-103);
  2. UBM / extractor / PLDA training on the train speakers (:105-129);
  3. the enroll/eval split (the first ``enroll_num`` utterances enroll,
     ``local/split_data_enroll_eval.py``) and all-vs-all trials;
  4. PLDA scoring and the EER of the mixed set, then of the no-spoof copy for
     the clean threshold, then the spoof rate at that threshold
     (:141-218 and ``ivector_spoofrate.py``).

Two backends compute the EM sweeps, the Baum-Welch stats and the extraction:
``"native"`` (the C++ scalar loops) and ``"torch"``
(:mod:`spoofsv_torch.spoofkit.ivector_torch`, on ``device``: the card unless
the caller asks for the CPU). ``"jax"`` names ``"torch"``, so a command line
written for the JAX package runs unchanged. PLDA, the EER and the per-file
scoring are native in both, as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spoofsv_torch import native
from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.native import load_lib
from spoofsv_torch.spoofkit import ivector_torch

_HANDLE_LOCK = threading.Lock()  # guards lazy native-handle creation

c_double_p = ctypes.POINTER(ctypes.c_double)
c_float_p = ctypes.POINTER(ctypes.c_float)

BACKENDS = ("native", "torch")


def _dp(a: np.ndarray):
    return a.ctypes.data_as(c_double_p)


def _free(name: str, handle) -> None:
    """Free a native handle from ``__del__``, if the library is loaded. At
    interpreter exit the module's globals may already be gone."""
    try:
        lib = native._LIB
        if handle is not None and lib is not None:
            getattr(lib, name)(handle)
    except (AttributeError, TypeError):
        pass


def resolve_backend(backend: str = "auto") -> str:
    """``"native"`` (C++ scalar loops) or ``"torch"`` (the device EM of
    :mod:`.ivector_torch`). ``"auto"`` is ``"torch"``: the sweeps are dense
    matmuls. ``"jax"``, the JAX package's name for its device backend, is
    ``"torch"`` here. Anything else raises ``ValueError``."""
    if backend in ("auto", "jax"):
        return "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown i-vector backend {backend!r}: auto, torch, jax or native")
    return backend


# ----------------------------------------------------------------------
# Feature extraction
# ----------------------------------------------------------------------

def add_deltas(feats: np.ndarray, order: int = 2, window: int = 3) -> np.ndarray:
    """Kaldi ``add-deltas``: append order-1..``order`` regression deltas
    (±``window`` context, clamped edges) → (T, D*(order+1)).

    The reference's sid/ scripts apply it with Kaldi's defaults
    --delta-order=2 --delta-window=3 before CMVN and voiced-frame selection
    (``kaldi_ivectors/run.sh:108-118``): 60-dim features from 20 cepstra."""
    feats = np.ascontiguousarray(feats, np.float64)
    T, D = feats.shape
    if T == 0:
        return np.zeros((0, D * (order + 1)), np.float64)
    out = np.zeros((T, D * (order + 1)), np.float64)
    load_lib().sk_add_deltas(_dp(feats), T, D, order, window, _dp(out))
    return out


def mfcc_vad_features(wav_path: str, sr: int = 16000, num_mel: int = 40,
                      num_ceps: int = 20, cmvn_window: int = 300,
                      use_deltas: bool = True, delta_order: int = 2,
                      delta_window: int = 3) -> np.ndarray:
    """MFCC → add-deltas → sliding CMVN → the voiced frames.

    Returns (T_voiced, num_ceps*(delta_order+1)) with deltas (Kaldi's sid/
    order: deltas on the raw cepstra, CMVN over the whole vector, then the
    energy VAD's frames), or (T_voiced, num_ceps) with ``use_deltas=False``."""
    lib = load_lib()
    y, _ = dsp_host.load_wav(wav_path, sr=sr)
    # Kaldi's convention: samples in the int16 range, which the energy VAD's
    # thresholds (vad.conf: energy-threshold 5.5) assume
    y = np.ascontiguousarray(y * 32768.0, np.float32)
    h = lib.sk_mfcc_new(sr, num_mel, num_ceps)
    out_dim = num_ceps * (delta_order + 1 if use_deltas else 1)
    try:
        T = lib.sk_mfcc_num_frames(h, len(y))
        if T <= 0:
            return np.zeros((0, out_dim), np.float64)
        feats = np.zeros((T, num_ceps), np.float64)
        log_e = np.zeros((T,), np.float64)
        lib.sk_mfcc_compute(h, y.ctypes.data_as(c_float_p), len(y), _dp(feats), _dp(log_e))
    finally:
        lib.sk_mfcc_free(h)
    voiced = np.zeros((T,), np.uint8)
    # Kaldi vad.conf defaults: energy-threshold 5.5, mean-scale 0.5
    lib.sk_energy_vad(_dp(log_e), T, 5.5, 0.5, 2, 0.6,
                      voiced.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if use_deltas:
        feats = add_deltas(feats, delta_order, delta_window)
    lib.sk_cmvn_sliding(_dp(feats), T, feats.shape[1], cmvn_window)
    return feats[voiced.astype(bool)]


def _thread_map(fn, items, workers: int) -> list:
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


class UBM:
    def __init__(self, weights: np.ndarray, means: np.ndarray, vars_: np.ndarray):
        self.weights = weights
        self.means = means
        self.vars = vars_
        self._handle = None

    @classmethod
    def train(cls, frames: np.ndarray, num_comp: int, iters: int = 4, seed: int = 0,
              verbose: bool = False, backend: str = "native", device=None) -> "UBM":
        if resolve_backend(backend) == "torch":
            return cls(*ivector_torch.train_diag_ubm(
                frames, num_comp, iters=iters, seed=seed, verbose=verbose, device=device))
        lib = load_lib()
        frames = np.ascontiguousarray(frames, np.float64)
        n, d = frames.shape
        h = lib.sk_train_diag_ubm(_dp(frames), n, d, num_comp, iters, seed, int(verbose))
        w = np.zeros((num_comp,), np.float64)
        m = np.zeros((num_comp, d), np.float64)
        v = np.zeros((num_comp, d), np.float64)
        lib.sk_diag_ubm_get(h, _dp(w), _dp(m), _dp(v))
        lib.sk_diag_ubm_free(h)
        return cls(w, m, v)

    def handle(self):
        with _HANDLE_LOCK:  # acc_stats runs from thread pools; ctypes drops the GIL
            if self._handle is None:
                c, d = self.means.shape
                self._handle = load_lib().sk_diag_ubm_from(
                    _dp(np.ascontiguousarray(self.weights)),
                    _dp(np.ascontiguousarray(self.means)),
                    _dp(np.ascontiguousarray(self.vars)), c, d)
        return self._handle

    def __del__(self, _free=_free):   # bound now: module globals go at exit
        _free("sk_diag_ubm_free", self._handle)

    def acc_stats(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        c, d = self.means.shape
        feats = np.ascontiguousarray(feats, np.float64)
        N = np.zeros((c,), np.float64)
        F = np.zeros((c, d), np.float64)
        load_lib().sk_acc_stats(self.handle(), _dp(feats), feats.shape[0], d, _dp(N), _dp(F))
        return N, F

    def acc_stats_batch(self, feats_list, backend: str = "native", workers: int = 8,
                        device=None):
        """Baum-Welch stats for many utterances: batched on the device on the
        torch backend, a thread pool over the native kernel otherwise."""
        if resolve_backend(backend) == "torch":
            return ivector_torch.acc_stats_diag_batch(
                self.weights, self.means, self.vars, feats_list, device=device)
        return _thread_map(self.acc_stats, feats_list, workers)

    def save(self, path: str) -> None:
        np.savez(path, weights=self.weights, means=self.means, vars=self.vars)

    @classmethod
    def load(cls, path: str) -> "UBM":
        z = np.load(path)
        return cls(z["weights"], z["means"], z["vars"])


class FullUBM:
    """Full-covariance UBM re-estimated from the diag UBM's posteriors
    (``kaldi_ivectors/run.sh:110-118``: gmm-global-to-fgmm + fgmm re-est)."""

    def __init__(self, weights: np.ndarray, means: np.ndarray, covs: np.ndarray):
        self.weights = weights
        self.means = means
        self.covs = covs               # (C, D, D)
        self._handle = None

    @classmethod
    def train(cls, diag: UBM, frames: np.ndarray, iters: int = 3, verbose: bool = False,
              backend: str = "native", device=None) -> "FullUBM":
        if resolve_backend(backend) == "torch":
            return cls(*ivector_torch.train_full_ubm(
                diag.weights, diag.means, diag.vars, frames, iters=iters, verbose=verbose,
                device=device))
        lib = load_lib()
        frames = np.ascontiguousarray(frames, np.float64)
        n, d = frames.shape
        c = diag.means.shape[0]
        h = lib.sk_train_full_ubm(diag.handle(), _dp(frames), n, d, iters, int(verbose))
        w = np.zeros((c,), np.float64)
        m = np.zeros((c, d), np.float64)
        cv = np.zeros((c, d, d), np.float64)
        lib.sk_full_ubm_get(h, _dp(w), _dp(m), _dp(cv))
        lib.sk_full_ubm_free(h)
        return cls(w, m, cv)

    def handle(self):
        with _HANDLE_LOCK:  # acc_stats runs from thread pools; ctypes drops the GIL
            if self._handle is None:
                c, d = self.means.shape
                self._handle = load_lib().sk_full_ubm_from(
                    _dp(np.ascontiguousarray(self.weights)),
                    _dp(np.ascontiguousarray(self.means)),
                    _dp(np.ascontiguousarray(self.covs)), c, d)
        return self._handle

    def __del__(self, _free=_free):   # bound now: module globals go at exit
        _free("sk_full_ubm_free", self._handle)

    def acc_stats(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        c, d = self.means.shape
        feats = np.ascontiguousarray(feats, np.float64)
        N = np.zeros((c,), np.float64)
        F = np.zeros((c, d), np.float64)
        load_lib().sk_full_acc_stats(self.handle(), _dp(feats), feats.shape[0], d, _dp(N),
                                     _dp(F))
        return N, F

    def acc_stats_batch(self, feats_list, backend: str = "native", workers: int = 8,
                        device=None):
        """Batched Baum-Welch stats (see :meth:`UBM.acc_stats_batch`)."""
        if resolve_backend(backend) == "torch":
            return ivector_torch.acc_stats_full_batch(
                self.weights, self.means, self.covs, feats_list, device=device)
        return _thread_map(self.acc_stats, feats_list, workers)

    def save(self, path: str) -> None:
        np.savez(path, weights=self.weights, means=self.means, covs=self.covs)

    @classmethod
    def load(cls, path: str) -> "FullUBM":
        z = np.load(path)
        return cls(z["weights"], z["means"], z["covs"])


def _repair_nonfinite_rows(extract_fn, out: np.ndarray, stats) -> np.ndarray:
    """Re-solve any non-finite rows of a batched f32 extraction with the f64
    native solver (pathological stats on degenerate UBM components)."""
    bad = np.flatnonzero(~np.isfinite(out).all(axis=1))
    for i in bad:
        out[i] = extract_fn(*stats[i])
    if len(bad):
        print(f"[ivector] re-solved {len(bad)} utterances natively "
              f"(f32 posterior underflow)")
    return out


class _Extractor:
    """The T-matrix extractor over a native handle; the subclasses name the
    native functions and the precision array (full or diagonal)."""

    _FREE = _GET = _FROM = _EXTRACT = ""
    _PRECISION = ""

    def __init__(self, handle, ivec_dim: int, num_comp: int = 0, dim: int = 0, arrays=None):
        self._handle = handle
        self.ivec_dim = ivec_dim
        self.num_comp = num_comp
        self.dim = dim
        self._arrays = arrays          # (T (C,D,R), means (C,D), precision)

    def __del__(self, _free=_free):   # bound now: module globals go at exit
        _free(self._FREE, self._handle)

    @classmethod
    def _from_arrays(cls, T: np.ndarray, means: np.ndarray, precision: np.ndarray):
        T, means, precision = (np.ascontiguousarray(a, np.float64) for a in (T, means, precision))
        c, d, r = T.shape
        h = getattr(load_lib(), cls._FROM)(_dp(T), _dp(means), _dp(precision), c, d, r)
        return cls(h, r, c, d, arrays=(T, means, precision))

    def _precision_shape(self) -> tuple:
        return ((self.num_comp, self.dim, self.dim) if self._PRECISION == "inv_covs"
                else (self.num_comp, self.dim))

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(T, ubm_means, precision), fetched from the native handle once."""
        if self._arrays is None:
            c, d, r = self.num_comp, self.dim, self.ivec_dim
            T = np.zeros((c, d, r), np.float64)
            means = np.zeros((c, d), np.float64)
            precision = np.zeros(self._precision_shape(), np.float64)
            getattr(load_lib(), self._GET)(self._handle, _dp(T), _dp(means), _dp(precision))
            self._arrays = (T, means, precision)
        return self._arrays

    def extract(self, N: np.ndarray, F: np.ndarray) -> np.ndarray:
        out = np.zeros((self.ivec_dim,), np.float64)
        getattr(load_lib(), self._EXTRACT)(
            self._handle, _dp(np.ascontiguousarray(N, np.float64)),
            _dp(np.ascontiguousarray(F, np.float64)), _dp(out))
        return out

    def extract_batch(self, stats: Sequence[Tuple[np.ndarray, np.ndarray]],
                      backend: str = "native", workers: int = 8, device=None) -> np.ndarray:
        """(U, R) i-vectors for many utterances: one batched E-step on the
        device on the torch backend (non-finite rows re-solved natively), a
        thread pool over the native solver otherwise."""
        if resolve_backend(backend) == "torch":
            T, means, precision = self.arrays()
            allN = np.stack([s[0] for s in stats])
            allF = np.stack([s[1] for s in stats])
            out = ivector_torch.extract_ivectors(T, precision, means, allN, allF,
                                                    device=device)
            return _repair_nonfinite_rows(self.extract, out, stats)
        return np.stack(_thread_map(lambda s: self.extract(*s), stats, workers))

    def save(self, path: str) -> None:
        T, means, precision = self.arrays()
        np.savez(path, T=T, means=means, **{self._PRECISION: precision})

    @classmethod
    def load(cls, path: str):
        z = np.load(path)
        return cls._from_arrays(z["T"], z["means"], z[cls._PRECISION])


class IvectorExtractorFull(_Extractor):
    """T-matrix extractor on the full-covariance UBM (the configuration the
    reference's Kaldi pipeline runs, ``run.sh:119-129``)."""

    _FREE, _GET, _FROM, _EXTRACT = ("sk_ivector_full_free", "sk_ivector_full_get",
                                    "sk_ivector_full_from", "sk_extract_ivector_full")
    _PRECISION = "inv_covs"

    @classmethod
    def train(cls, fubm: FullUBM, stats: Sequence[Tuple[np.ndarray, np.ndarray]],
              ivec_dim: int = 100, iters: int = 5, seed: int = 0, verbose: bool = False,
              backend: str = "native", device=None) -> "IvectorExtractorFull":
        allN = np.ascontiguousarray(np.stack([s[0] for s in stats]), np.float64)
        allF = np.ascontiguousarray(np.stack([s[1] for s in stats]), np.float64)
        c, d = fubm.means.shape
        if resolve_backend(backend) == "torch":
            inv_covs = np.ascontiguousarray(np.linalg.inv(fubm.covs))
            T = ivector_torch.train_extractor(fubm.means, inv_covs, allN, allF, ivec_dim,
                                                 iters=iters, seed=seed, verbose=verbose,
                                                 device=device)
            return cls._from_arrays(T, fubm.means, inv_covs)
        h = load_lib().sk_train_ivector_full(fubm.handle(), ivec_dim, _dp(allN), _dp(allF),
                                             len(stats), iters, seed, int(verbose))
        return cls(h, ivec_dim, c, d)


class IvectorExtractor(_Extractor):
    """T-matrix extractor on the diagonal UBM."""

    _FREE, _GET, _FROM, _EXTRACT = ("sk_ivector_free", "sk_ivector_get", "sk_ivector_from",
                                    "sk_extract_ivector")
    _PRECISION = "inv_vars"

    @classmethod
    def train(cls, ubm: UBM, stats: Sequence[Tuple[np.ndarray, np.ndarray]],
              ivec_dim: int = 100, iters: int = 5, seed: int = 0, verbose: bool = False,
              backend: str = "native", device=None) -> "IvectorExtractor":
        c, d = ubm.means.shape
        allN = np.ascontiguousarray(np.stack([s[0] for s in stats]), np.float64)
        allF = np.ascontiguousarray(np.stack([s[1] for s in stats]), np.float64)
        if resolve_backend(backend) == "torch":
            # the native scorer floors vars at 1e-6 (ivector.cc:67)
            inv_vars = np.ascontiguousarray(1.0 / np.maximum(ubm.vars, 1e-6), np.float64)
            T = ivector_torch.train_extractor(ubm.means, inv_vars, allN, allF, ivec_dim,
                                                 iters=iters, seed=seed, verbose=verbose,
                                                 device=device)
            return cls._from_arrays(T, ubm.means, inv_vars)
        h = load_lib().sk_train_ivector(
            _dp(np.ascontiguousarray(ubm.means)), _dp(np.ascontiguousarray(ubm.vars)), c, d,
            ivec_dim, _dp(allN), _dp(allF), len(stats), iters, seed, int(verbose))
        return cls(h, ivec_dim, c, d)


class PLDA:
    def __init__(self, handle, dim: int):
        self._handle = handle
        self.dim = dim

    def __del__(self, _free=_free):   # bound now: module globals go at exit
        _free("sk_plda_free", self._handle)

    @classmethod
    def train(cls, ivecs: np.ndarray, labels: np.ndarray, verbose: bool = False) -> "PLDA":
        ivecs = np.ascontiguousarray(ivecs, np.float64)
        labels = np.ascontiguousarray(labels, np.int32)
        n, d = ivecs.shape
        h = load_lib().sk_train_plda(_dp(ivecs), n, d,
                                     labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                                     int(labels.max()) + 1, int(verbose))
        return cls(h, d)

    def transform(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros((self.dim,), np.float64)
        load_lib().sk_plda_transform(self._handle, _dp(np.ascontiguousarray(x, np.float64)),
                                     _dp(out))
        return out

    def llr(self, enroll_mean_t: np.ndarray, n_enroll: int, test_t: np.ndarray) -> float:
        return float(load_lib().sk_plda_llr(
            self._handle, _dp(np.ascontiguousarray(enroll_mean_t, np.float64)), n_enroll,
            _dp(np.ascontiguousarray(test_t, np.float64))))

    def save(self, path: str) -> None:
        d = self.dim
        mean = np.zeros((d,), np.float64)
        transform = np.zeros((d, d), np.float64)
        psi = np.zeros((d,), np.float64)
        load_lib().sk_plda_get(self._handle, _dp(mean), _dp(transform), _dp(psi))
        np.savez(path, mean=mean, transform=transform, psi=psi)

    @classmethod
    def load(cls, path: str) -> "PLDA":
        z = np.load(path)
        mean = np.ascontiguousarray(z["mean"], np.float64)
        transform = np.ascontiguousarray(z["transform"], np.float64)
        psi = np.ascontiguousarray(z["psi"], np.float64)
        d = len(mean)
        return cls(load_lib().sk_plda_from(_dp(mean), _dp(transform), _dp(psi), d), d)


def compute_eer(target: np.ndarray, nontarget: np.ndarray) -> Tuple[float, float]:
    thr = ctypes.c_double(0.0)
    eer = load_lib().sk_compute_eer(
        _dp(np.ascontiguousarray(target, np.float64)), len(target),
        _dp(np.ascontiguousarray(nontarget, np.float64)), len(nontarget), ctypes.byref(thr))
    return float(eer), float(thr.value)


def length_normalize(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x)
    return x * (np.sqrt(len(x)) / n) if n > 0 else x


# ----------------------------------------------------------------------
# Pipeline (run.sh equivalent)
# ----------------------------------------------------------------------

def _models_complete(models_dir: str) -> bool:
    need = ["ivector_models_meta.json", "extractor.npz", "plda.npz", "mean_ivec.npy"]
    return all(os.path.exists(os.path.join(models_dir, f)) for f in need)


def load_ivector_models(models_dir: str):
    """Load (stats_model, extractor, plda, mean_ivec) saved by a previous
    ``run_ivector_pipeline(models_dir=...)`` run: the reference's
    first-run-only training (``run.sh [0|1]``, run.sh:105-129)."""
    with open(os.path.join(models_dir, "ivector_models_meta.json")) as f:
        meta = json.load(f)
    if meta["use_full_ubm"]:
        stats_model = FullUBM.load(os.path.join(models_dir, "fubm.npz"))
        extractor = IvectorExtractorFull.load(os.path.join(models_dir, "extractor.npz"))
    else:
        stats_model = UBM.load(os.path.join(models_dir, "ubm.npz"))
        extractor = IvectorExtractor.load(os.path.join(models_dir, "extractor.npz"))
    plda = PLDA.load(os.path.join(models_dir, "plda.npz"))
    mean_ivec = np.load(os.path.join(models_dir, "mean_ivec.npy"))
    return stats_model, extractor, plda, mean_ivec


def _listing(d: str) -> List[Tuple[str, List[str]]]:
    return [(spk, sorted(os.listdir(os.path.join(d, spk)))) for spk in sorted(os.listdir(d))]


def _hash_of(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha1(fh.read()).hexdigest()


def run_ivector_pipeline(cfg: Config, ctime: str, enroll_num: int = 3,
                         eval_num: int = 20, num_gauss: int = 1024,
                         ivec_dim: int = 400, max_train_utts_per_spk: int = 40,
                         ubm_frames_cap: int = 200_000, seed: int = 0,
                         workers: int = 8, verbose: bool = True,
                         use_full_ubm: bool = True, full_ubm_iters: int = 3,
                         models_dir: Optional[str] = None,
                         backend: str = "auto",
                         use_deltas: bool = True, device=None) -> Dict[str, float]:
    """The whole evaluation: train the UBM, T and PLDA on the staged train
    speakers, score the mixed and no-spoof trials, report the EER, the clean
    threshold and the spoof rate.

    The defaults are Kaldi aishell v1's as the reference drives it (1024
    Gaussians, 400-dim i-vectors, run.sh:105-129); ``use_full_ubm`` is
    Kaldi's diag→full UBM upgrade (run.sh:110-118); ``use_deltas`` applies
    Kaldi ``add-deltas`` before CMVN and is recorded in the models' meta and
    honoured when saved models are reused.

    ``models_dir``: when it holds a complete model set from a prior run, the
    training is skipped and the saved models score (run.sh's first-run-only
    training); otherwise the models trained here are saved there.

    ``backend``: ``"torch"`` (or ``"jax"``) runs the EM sweeps, the stats and
    the extraction on ``device`` (the card unless the caller passes
    ``device="cpu"``); ``"native"`` is the scalar C++; ``"auto"`` is native
    below 512 Gaussians, where the scalar C++ finishes first, and the device
    backend from there on (the JAX package's size rule).
    """
    if backend == "auto" and num_gauss < 512:
        backend = "native"
    backend = resolve_backend(backend)
    if verbose:
        print(f"[ivector] backend: {backend}")
    dev = dict(backend=backend, device=device)

    root = os.path.join(cfg.src_root_dir, "test", ctime, "ivector_data")
    train_dir = os.path.join(root, "wav", "train")
    test_dir = os.path.join(root, "wav", "test")
    ns_dir = os.path.join(root, "test_nospoof")

    rng = np.random.default_rng(seed)

    if models_dir and _models_complete(models_dir):
        if verbose:
            print(f"[ivector] reusing trained models from {models_dir}")
        with open(os.path.join(models_dir, "ivector_models_meta.json")) as f:
            meta = json.load(f)
        # scoring features must be those the models were trained on,
        # whatever this call's knob says
        use_deltas = bool(meta.get("use_deltas", False))
        stats_model, extractor, plda, mean_ivec = load_ivector_models(models_dir)
    else:
        # ---- 1. features for the train speakers
        train_items: List[Tuple[str, str]] = []
        for spk, utts in _listing(train_dir):
            if max_train_utts_per_spk:
                utts = utts[:max_train_utts_per_spk]
            train_items += [(spk, os.path.join(train_dir, spk, u)) for u in utts]
        if verbose:
            print(f"[ivector] extracting features for {len(train_items)} train utts")
        train_feats = _thread_map(lambda it: mfcc_vad_features(it[1], use_deltas=use_deltas),
                                  train_items, workers)

        # ---- 2. the UBM on pooled (subsampled) frames
        pool = np.concatenate([f for f in train_feats if len(f)], axis=0)
        if len(pool) > ubm_frames_cap:
            pool = pool[rng.choice(len(pool), ubm_frames_cap, replace=False)]
        if verbose:
            print(f"[ivector] training {num_gauss}-comp diag UBM on {len(pool)} frames")
        ubm = UBM.train(pool, num_gauss, iters=4, seed=seed, verbose=verbose, **dev)
        if use_full_ubm:
            if verbose:
                print(f"[ivector] re-estimating full-covariance UBM ({full_ubm_iters} iters)")
            stats_model = FullUBM.train(ubm, pool, iters=full_ubm_iters, verbose=verbose, **dev)
        else:
            stats_model = ubm

        # ---- 3. stats and the T matrix
        if verbose:
            print("[ivector] accumulating stats + training T matrix")
        stats = stats_model.acc_stats_batch([f for f in train_feats if len(f) > 0],
                                            workers=workers, **dev)
        kept = [i for i, f in enumerate(train_feats) if len(f) > 0]
        ext_cls = IvectorExtractorFull if use_full_ubm else IvectorExtractor
        extractor = ext_cls.train(stats_model, stats, ivec_dim=ivec_dim, iters=5, seed=seed,
                                  verbose=verbose, **dev)

        # ---- 4. train i-vectors and PLDA
        train_ivecs = extractor.extract_batch(stats, workers=workers, **dev)
        spk_names = sorted({train_items[i][0] for i in kept})
        spk_idx = {s: i for i, s in enumerate(spk_names)}
        labels = np.asarray([spk_idx[train_items[i][0]] for i in kept], np.int32)
        mean_ivec = train_ivecs.mean(axis=0)
        normed = np.stack([length_normalize(v - mean_ivec) for v in train_ivecs])
        if verbose:
            print(f"[ivector] training PLDA on {len(normed)} ivecs / {len(spk_names)} spk")
        plda = PLDA.train(normed, labels, verbose=verbose)

        if models_dir:
            os.makedirs(models_dir, exist_ok=True)
            ubm.save(os.path.join(models_dir, "ubm.npz"))
            if use_full_ubm:
                stats_model.save(os.path.join(models_dir, "fubm.npz"))
            extractor.save(os.path.join(models_dir, "extractor.npz"))
            plda.save(os.path.join(models_dir, "plda.npz"))
            np.save(os.path.join(models_dir, "mean_ivec.npy"), mean_ivec)
            with open(os.path.join(models_dir, "ivector_models_meta.json"), "w") as f:
                json.dump({"use_full_ubm": use_full_ubm, "num_gauss": num_gauss,
                           "ivec_dim": ivec_dim, "use_deltas": use_deltas}, f)
            if verbose:
                print(f"[ivector] models saved to {models_dir}")

    # The mixed and no-spoof test dirs stage the SAME real utterances as
    # separate file copies (generate_test_utterances.py:141-217): transformed
    # i-vectors are cached by content hash, so each real file pays
    # MFCC+VAD+stats+extract once across both scoring passes.
    ivec_cache: Dict[str, Optional[np.ndarray]] = {}

    def utterance_ivector(path: str) -> Optional[np.ndarray]:
        key = _hash_of(path)
        if key in ivec_cache:
            return ivec_cache[key]
        f = mfcc_vad_features(path, use_deltas=use_deltas)
        if len(f) == 0:
            vec = None
        else:
            iv = extractor.extract(*stats_model.acc_stats(f))
            vec = plda.transform(length_normalize(iv - mean_ivec))
        ivec_cache[key] = vec
        return vec

    def prime_ivector_cache(dirs: List[str]) -> None:
        """The device backend: the whole scoring set's stats and extraction
        in batches instead of per-file native solves."""
        fresh: List[Tuple[str, str]] = []
        seen = set()
        for d in dirs:
            for spk, utts in _listing(d):
                for u in utts:
                    p = os.path.join(d, spk, u)
                    k = _hash_of(p)
                    if k not in ivec_cache and k not in seen:
                        fresh.append((k, p))
                        seen.add(k)
        if not fresh:
            return
        if verbose:
            print(f"[ivector] batch-extracting {len(fresh)} unique test utts")
        feats = _thread_map(lambda kp: mfcc_vad_features(kp[1], use_deltas=use_deltas),
                            fresh, workers)
        keep = [i for i, f in enumerate(feats) if len(f) > 0]
        for i, (k, _) in enumerate(fresh):
            if len(feats[i]) == 0:
                ivec_cache[k] = None
        if not keep:
            return
        st = stats_model.acc_stats_batch([feats[i] for i in keep], workers=workers, **dev)
        ivecs = extractor.extract_batch(st, workers=workers, **dev)
        for j, i in enumerate(keep):
            ivec_cache[fresh[i][0]] = plda.transform(length_normalize(ivecs[j] - mean_ivec))

    if backend == "torch":
        prime_ivector_cache([test_dir, ns_dir])

    def score_testdir(d: str):
        """Enroll = the first enroll_num utterances a speaker
        (split_data_enroll_eval.py); every eval utterance is scored against
        every enrolled speaker: (enroll_spk, test_spk, utt_index, llr)."""
        scores = []
        enroll: Dict[str, Tuple[np.ndarray, int]] = {}
        evals: Dict[str, List[Tuple[int, np.ndarray]]] = {}
        for spk, utts in _listing(d):
            e_vecs = []
            evals[spk] = []
            for u in utts:
                idx = int(u[-7:-4])
                vec = utterance_ivector(os.path.join(d, spk, u))
                if vec is None:
                    continue
                if idx <= enroll_num:
                    e_vecs.append(vec)
                else:
                    evals[spk].append((idx, vec))
            if e_vecs:
                enroll[spk] = (np.mean(e_vecs, axis=0), len(e_vecs))
        for espk, (emean, n) in enroll.items():
            for tspk, lst in evals.items():
                for idx, vec in lst:
                    scores.append((espk, tspk, idx, plda.llr(emean, n, vec)))
        return scores

    if verbose:
        print("[ivector] scoring mixed test set")
    mixed_scores = score_testdir(test_dir)
    if verbose:
        print("[ivector] scoring no-spoof test set")
    ns_scores = score_testdir(ns_dir)

    mixed_eer, _ = _eer_of(mixed_scores)
    clean_eer, clean_thr = _eer_of(ns_scores)
    spoof_target = _spoof_targets(mixed_scores, enroll_num, eval_num)
    spoof_rate = (float(np.mean(np.asarray(spoof_target) > clean_thr))
                  if spoof_target else 0.0)

    # score files in the Kaldi format curve.py parses (trial "<espk> <tspk>W<idx>")
    score_dir = os.path.join(root, "scores")
    os.makedirs(score_dir, exist_ok=True)
    for name, scores in (("mixed", mixed_scores), ("nospoof", ns_scores)):
        with open(os.path.join(score_dir, f"plda_scores_{name}.txt"), "w") as f:
            for e, t, i, s in scores:
                f.write(f"{e} {t}W{str(i).zfill(3)} {s}\n")

    result = {"mixed_eer": mixed_eer, "clean_eer": clean_eer,
              "clean_threshold": clean_thr, "spoof_rate": spoof_rate,
              "n_mixed_trials": len(mixed_scores),
              "n_spoof_targets": len(spoof_target)}
    if verbose:
        print(json.dumps(result, indent=2))
    with open(os.path.join(score_dir, "result.json"), "w") as f:
        json.dump(result, f)
    return result


def _eer_of(scores) -> Tuple[float, float]:
    tgt = np.asarray([s for e, t, i, s in scores if e == t])
    non = np.asarray([s for e, t, i, s in scores if e != t])
    return compute_eer(tgt, non)


def _spoof_targets(scores, enroll_num: int, eval_num: int) -> List[float]:
    """Target trials whose utterance index exceeds enroll + eval: the
    synthetic ones (``ivector_spoofrate.py:12-24``)."""
    return [s for e, t, i, s in scores if e == t and i > enroll_num + eval_num]


# ----------------------------------------------------------------------
# Standalone score-file recompute (ivector_eer.sh:30 / ivector_spoofrate.py)
# ----------------------------------------------------------------------

def read_score_file(path: str) -> List[Tuple[str, str, int, float]]:
    """Parse ``<espk> <tspk>W<idx> <llr>`` lines (the format
    ``run_ivector_pipeline`` writes and ``curve.py:27-49`` parses)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            espk, trial, s = parts
            out.append((espk, trial[:-4], int(trial[-3:]), float(s)))
    return out


def recompute_eer_from_scores(path: str) -> Tuple[float, float]:
    """EER and threshold from a saved score file: the reference's
    ``ivector_eer.sh:30`` (compute-eer on the stored PLDA scores)."""
    return _eer_of(read_score_file(path))


def spoof_rate_from_scores(path: str, threshold: float, enroll_num: int = 3,
                           eval_num: int = 20) -> Tuple[float, int]:
    """The spoof rate at a threshold from a saved mixed score file
    (``ivector_spoofrate.py:12-24``). Returns (rate, n_spoof_targets)."""
    spoof = _spoof_targets(read_score_file(path), enroll_num, eval_num)
    if not spoof:
        return 0.0, 0
    return float(np.mean(np.asarray(spoof) > threshold)), len(spoof)
