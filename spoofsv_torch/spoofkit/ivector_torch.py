"""The device backend of the i-vector pipeline: UBM and T-matrix EM, Baum-Welch
stats and extraction as torch matmuls and batched Cholesky solves.

Port of :mod:`spoofsv_tpu.spoofkit.ivector_jax`. At the reference's Kaldi
configuration (1024 Gaussians, 400-dim i-vectors, ``kaldi_ivectors/run.sh:105-129``)
the sweeps of the native scalar loops (``native/src/{gmm,ivector}.cc``) are
dense linear algebra:

* diag-UBM posteriors: ``gconst + X @ (mu/var)ᵀ − ½ X² @ (1/var)ᵀ``;
* full-covariance quadratic forms: ``⟨x xᵀ, Σ_c⁻¹⟩``, one (frames × D²)·(D² × C) GEMM;
* Baum-Welch stats: ``postsᵀ @ X``;
* the T-matrix E-step: batched (R × R) Gram assembly and Cholesky solves;
  the M-step: batched per-component (R × R) solves.

Numerics are the JAX module's: f32 everywhere (its contractions run at
``precision="highest"``; here TF32 must be off, :func:`check_f32`), frames
and means in centered coordinates, and every floor of the C++ mirrored
(posterior cutoffs 1e-8 / 1e-6, variance floors 1e-6 / 1e-4, occupancy
floor 1e-10, the M-step's 1e-8 ridge), both Cholesky solves Jacobi
equilibrated. Component seeding and the T init draw from numpy's
``default_rng(seed)`` exactly as the JAX module does, so the same seed gives
the same draws in both packages.

A factorization that fails (``torch.linalg.cholesky_ex``'s ``info`` non-zero)
gives NaN in its batch entry, as ``jnp.linalg.cholesky`` does: the extractor
re-solves such rows natively (``ivector._repair_nonfinite_rows``), and the EM
paths raise on non-finite models. The UBM sweeps loop over device-resident
chunks of frames with device accumulators, synchronizing once a sweep.
Every function takes ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spoofsv_torch import resolve_device

_CHUNK = 8192          # frames a step of the UBM sweeps
_STATS_BATCH = 32      # utterances a batched Baum-Welch stats call

_LOG_2PI = float(np.log(2.0 * np.pi))


def check_f32(device: torch.device) -> None:
    """Raise unless f32 matmuls on ``device`` are full f32: with TF32 the
    E-step Gram keeps ~3 fewer digits than the JAX backend's ``"highest"``."""
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the i-vector device backend needs f32 matmuls without TF32 "
                           "(torch.backends.cuda.matmul.allow_tf32 = False, "
                           "torch.set_float32_matmul_precision('highest'))")


def _device(device) -> torch.device:
    dev = resolve_device(device)
    check_f32(dev)
    return dev


def _t(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)


def _np64(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a batch, NaN where a factorization fails
    (``jnp.linalg.cholesky``'s result for a matrix that is not PD)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], torch.nan, chol)


def _check_finite(name: str, *arrays: np.ndarray) -> None:
    for a in arrays:
        if not np.isfinite(a).all():
            raise RuntimeError(
                f"ivector_torch: non-finite values in {name}: numerical failure in the "
                f"device EM path (rerun with backend='native' and report)")


# ----------------------------------------------------------------------
# Diagonal UBM
# ----------------------------------------------------------------------

def _chunk_frames(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pad to a multiple of _CHUNK → ((K, CH, D) frames, (K, CH) weights)."""
    n, d = frames.shape
    k = -(-n // _CHUNK)
    pad = k * _CHUNK - n
    f = np.pad(frames.astype(np.float32), ((0, pad), (0, 0)))
    w = np.pad(np.ones((n,), np.float32), ((0, pad),))
    return f.reshape(k, _CHUNK, d), w.reshape(k, _CHUNK)


def _repair_spd(covs: np.ndarray, max_cond: float = 1e6) -> np.ndarray:
    """Floor each (D, D) slice's eigenvalues so its condition number stays
    within what an f32 Cholesky handles with margin (~1e6).

    Low-occupancy components can re-estimate to (near-)singular covariances;
    the f64 C++ copes (its jitter ladder, common.h:95-127, and 15 digits),
    but a 1e10-conditioned slice NaNs an f32 sweep. The floor only perturbs
    such degenerate components (host numpy, as in the JAX module)."""
    out = np.asarray(covs, np.float64).copy()
    for c in range(out.shape[0]):
        w = np.linalg.eigvalsh(out[c])
        floor = max(w[-1], 1e-8) / max_cond
        if w[0] < floor:
            out[c][np.diag_indices(out.shape[1])] += floor - min(w[0], 0.0)
    return out


def _diag_tables(weights, means, vars_):
    v = torch.clamp_min(vars_, 1e-6)                 # scorer floor (gmm.cc:30)
    inv_v = 1.0 / v
    miv = means * inv_v
    gconst = (torch.log(torch.clamp_min(weights, 1e-20))
              - 0.5 * means.shape[1] * _LOG_2PI
              - 0.5 * torch.log(v).sum(1)
              - 0.5 * (means * miv).sum(1))
    return gconst, miv, inv_v


def _diag_em_sweep(fchunks, wchunks, weights, means, vars_, n_frames: int):
    """One EM sweep over all frames (gmm.cc ``em_iterations`` body):
    (new_weights, new_means, new_vars, total_loglike), on the device."""
    gconst, miv, inv_v = _diag_tables(weights, means, vars_)
    c, d = means.shape
    occ = fchunks.new_zeros(c)
    am = fchunks.new_zeros(c, d)
    av = fchunks.new_zeros(c, d)
    ll_tot = fchunks.new_zeros(())
    for x, w in zip(fchunks, wchunks):               # (CH, D), (CH,)
        xx = x * x
        ll = gconst[None] + x @ miv.T - 0.5 * (xx @ inv_v.T)
        lse = torch.logsumexp(ll, 1)
        post = torch.exp(ll - lse[:, None])
        post = torch.where(post < 1e-8, 0.0, post) * w[:, None]   # gmm.cc:98 skip
        occ += post.sum(0)
        am += post.T @ x
        av += post.T @ xx
        ll_tot += (lse * w).sum()
    o = torch.clamp_min(occ, 1e-10)
    new_m = am / o[:, None]
    new_v = torch.clamp_min(av / o[:, None] - new_m * new_m, 1e-4)
    return o / n_frames, new_m, new_v, ll_tot


def train_diag_ubm(frames: np.ndarray, num_comp: int, iters: int = 4, seed: int = 0,
                   verbose: bool = False, device=None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary-split + EM diag-UBM training (gmm.cc ``train_diag_ubm``) with the
    EM sweeps on ``device``. Returns (weights, means, vars) in f64.

    The split schedule, per-stage EM counts, farthest-of-8 seeding of new
    components and every floor mirror the C++; the seeding RNG is numpy's,
    drawn as the JAX backend draws it."""
    dev = _device(device)
    # Centered coordinates (EM is translation-equivariant): raw Kaldi-scale
    # MFCCs reach |x| ~ 200, where f32 expansions such as E[x²]−μ² lose 3-4
    # digits to cancellation.
    shift = np.asarray(frames, np.float64).mean(axis=0)
    frames = np.ascontiguousarray(np.asarray(frames, np.float64) - shift, np.float32)
    n, d = frames.shape
    rng = np.random.default_rng(seed)
    fc, wc = _chunk_frames(frames)
    fchunks, wchunks = _t(fc, dev), _t(wc, dev)

    mean0 = frames.mean(axis=0) if n else np.zeros((d,), np.float32)
    var0 = (np.maximum(np.mean((frames - mean0) ** 2, axis=0), 1e-4)
            if n else np.full((d,), 1e-4, np.float32))
    w = np.ones((1,), np.float32)
    m = mean0[None, :].astype(np.float32)
    v = var0[None, :].astype(np.float32)

    def em(w, m, v, k):
        for it in range(k):
            wj, mj, vj, ll = _diag_em_sweep(fchunks, wchunks, _t(w, dev), _t(m, dev),
                                            _t(v, dev), n_frames=n)
            w, m, v = (x.cpu().numpy() for x in (wj, mj, vj))
            if verbose:
                print(f"[diag-ubm/torch] comps={len(w)} iter={it} "
                      f"avg loglike {float(ll) / max(n, 1):.4f}")
        return w, m, v

    while len(w) < num_comp:
        target = min(num_comp, len(w) * 2)
        cur = len(w)
        ws = np.zeros((target,), np.float32)
        ms = np.zeros((target, d), np.float32)
        vs = np.zeros((target, d), np.float32)
        denom = (target + cur - 1) // cur            # gmm.cc:145
        for c in range(target):
            src = c % cur
            ws[c] = w[src] / denom
            if c >= cur:
                # farthest-of-8 seeding among random frames (gmm.cc:150-159)
                cand = rng.integers(0, n, size=9)
                d2 = ((frames[cand][:, None, :] - ms[None, :c, :]) ** 2
                      ).sum(-1).min(axis=1) if c else np.full(9, np.inf)
                ms[c] = frames[cand[int(np.argmax(d2))]]
                vs[c] = v[src]
            else:
                ms[c] = m[src]
                vs[c] = v[src]
        w, m, v = ws / ws.sum(), ms, vs
        w, m, v = em(w, m, v, 2)
    w, m, v = em(w, m, v, iters)
    w, m, v = w.astype(np.float64), m.astype(np.float64) + shift, v.astype(np.float64)
    _check_finite("diag UBM", w, m, v)
    return w, m, v


# ----------------------------------------------------------------------
# Full-covariance UBM
# ----------------------------------------------------------------------

def _full_scorer_tables(weights, means, covs):
    """(logconst (C,), A_flat (C, D²), b (C, D), k (C,)) for
    ll = logconst + x@bᵀ − ½ (x⊗x)@A_flatᵀ − ½ k, with b = Σ⁻¹μ folded."""
    chol = _cholesky(covs)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    inv = torch.cholesky_inverse(chol)
    b = torch.einsum("cde,ce->cd", inv, means)
    k = (means * b).sum(1)
    c, d = means.shape
    logconst = torch.log(torch.clamp_min(weights, 1e-20)) - 0.5 * (d * _LOG_2PI + logdet)
    return logconst, inv.reshape(c, d * d), b, k


def _full_loglike(x, tables):
    """(..., D) frames → ((..., C) log-likelihoods, (..., D²) x⊗x)."""
    logconst, a_flat, bvec, kvec = tables
    d = x.shape[-1]
    p = (x[..., :, None] * x[..., None, :]).reshape(*x.shape[:-1], d * d)
    q = p @ a_flat.T - 2.0 * (x @ bvec.T) + kvec
    return logconst - 0.5 * q, p


def _full_em_sweep(fchunks, wchunks, weights, means, covs):
    """One full-covariance EM sweep (gmm.cc ``train_full_ubm`` loop body)."""
    c, d = means.shape
    tables = _full_scorer_tables(weights, means, covs)
    occ = fchunks.new_zeros(c)
    am = fchunks.new_zeros(c, d)
    as_ = fchunks.new_zeros(c, d * d)
    for x, w in zip(fchunks, wchunks):
        ll, p = _full_loglike(x, tables)
        lse = torch.logsumexp(ll, 1)
        post = torch.exp(ll - lse[:, None])
        post = torch.where(post < 1e-8, 0.0, post) * w[:, None]   # gmm.cc:241 skip
        occ += post.sum(0)
        am += post.T @ x
        as_ += post.T @ p
    o = torch.clamp_min(occ, 1e-10)
    new_m = am / o[:, None]
    s = as_.reshape(c, d, d) / o[:, None, None] - new_m[:, :, None] * new_m[:, None, :]
    diag = torch.diagonal(s, dim1=-2, dim2=-1)
    s = s + torch.diag_embed(torch.clamp_min(diag, 1e-4) - diag)
    return o / o.sum(), new_m, s                      # gmm.cc:261


def train_full_ubm(weights: np.ndarray, means: np.ndarray, vars_: np.ndarray,
                   frames: np.ndarray, iters: int = 3, verbose: bool = False, device=None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full-covariance re-estimation from a diag UBM (gmm.cc
    ``train_full_ubm``). Returns (weights, means, covs) in f64."""
    dev = _device(device)
    # centered coordinates and an SPD repair before each sweep (the C++
    # copes with indefinite accumulators through its jitter ladder,
    # gmm.cc:218 / common.h:95-127)
    shift = np.asarray(frames, np.float64).mean(axis=0)
    frames = np.ascontiguousarray(np.asarray(frames, np.float64) - shift, np.float32)
    fc, wc = _chunk_frames(frames)
    fchunks, wchunks = _t(fc, dev), _t(wc, dev)
    c, d = means.shape
    s = np.zeros((c, d, d), np.float64)
    s[:, np.arange(d), np.arange(d)] = vars_
    w = np.asarray(weights, np.float64)
    m = np.asarray(means, np.float64) - shift
    for it in range(iters):
        s = _repair_spd(s)
        out = _full_em_sweep(fchunks, wchunks, _t(w, dev), _t(m, dev), _t(s, dev))
        w, m, s = (_np64(x) for x in out)
        if verbose:
            print(f"[full-ubm/torch] iter {it} done")
    s = _repair_spd(s)
    m = m + shift
    _check_finite("full UBM", w, m, s)
    return w, m, s


# ----------------------------------------------------------------------
# Baum-Welch stats (diag and full), batched over utterances
# ----------------------------------------------------------------------

def _stats_from_loglike(ll, feats, mask):
    lse = torch.logsumexp(ll, 2)
    post = torch.exp(ll - lse[..., None])
    post = torch.where(post < 1e-6, 0.0, post) * mask[..., None]   # gmm.cc:310/330 skip
    return post.sum(1), post.transpose(1, 2) @ feats


def _batched_stats(feats_list: Sequence[np.ndarray], loglike, means, dev: torch.device
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Pad and bucket utterances (frame counts padded to a power of two, at
    least 256, as in the JAX module) and run the batched stats.

    Runs in UBM-mean-centered coordinates (log-likelihoods and posteriors are
    shift-invariant when frames and means shift together) and un-shifts the
    first-order stats on the way out: F = F_centered + N·shift. ``loglike``
    maps a (U, T, D) batch of centered frames to (U, T, C)."""
    means = np.asarray(means, np.float64)
    shift = means.mean(axis=0)
    order = sorted(range(len(feats_list)), key=lambda i: len(feats_list[i]))
    out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * len(feats_list)
    for start in range(0, len(order), _STATS_BATCH):
        idx = order[start:start + _STATS_BATCH]
        tmax = max(len(feats_list[i]) for i in idx)
        tpad = max(256, 1 << (int(tmax - 1).bit_length()))
        fb = np.zeros((_STATS_BATCH, tpad, means.shape[1]), np.float32)
        mb = np.zeros((_STATS_BATCH, tpad), np.float32)
        for j, i in enumerate(idx):
            fi = feats_list[i]
            fb[j, :len(fi)] = np.asarray(fi, np.float64) - shift
            mb[j, :len(fi)] = 1.0
        feats = _t(fb, dev)
        n, f = _stats_from_loglike(loglike(feats), feats, _t(mb, dev))
        n, f = _np64(n), _np64(f)
        f = f + n[:, :, None] * shift[None, None, :]
        for j, i in enumerate(idx):
            out[i] = (n[j], f[j])
    return out  # type: ignore[return-value]


def acc_stats_diag_batch(weights, means, vars_, feats_list, device=None):
    """Batched diag-UBM Baum-Welch stats: a list of (N_c, F_c) per utterance
    (gmm.cc ``accumulate_stats``)."""
    dev = _device(device)
    shift = np.asarray(means, np.float64).mean(axis=0)
    gconst, miv, inv_v = _diag_tables(_t(weights, dev), _t(np.asarray(means) - shift, dev),
                                      _t(vars_, dev))
    return _batched_stats(
        feats_list, lambda x: gconst + x @ miv.T - 0.5 * ((x * x) @ inv_v.T), means, dev)


def acc_stats_full_batch(weights, means, covs, feats_list, device=None):
    """Batched full-UBM Baum-Welch stats (gmm.cc ``accumulate_stats_full``).
    Covariances are SPD-repaired for the f32 Cholesky."""
    dev = _device(device)
    shift = np.asarray(means, np.float64).mean(axis=0)
    tables = _full_scorer_tables(_t(weights, dev), _t(np.asarray(means) - shift, dev),
                                 _t(_repair_spd(covs), dev))
    return _batched_stats(feats_list, lambda x: _full_loglike(x, tables)[0], means, dev)


# ----------------------------------------------------------------------
# T-matrix (total variability) EM and extraction
# ----------------------------------------------------------------------

def _precision_tables(t_mat, precision):
    """SinvT (C,D,R) and the Gram G = T_cᵀ Σ_c⁻¹ T_c (C,R,R) from a diagonal
    precision (C,D) or full inverse covariances (C,D,D)
    (ivector.cc ``IvectorExtractorFull::refresh``)."""
    sinv_t = precision[:, :, None] * t_mat if precision.ndim == 2 else precision @ t_mat
    return sinv_t, t_mat.transpose(1, 2) @ sinv_t


def _estep_posteriors(t_mat, precision, all_n, fres, with_linv: bool):
    """Batched posterior of w per utterance: (w_mean (U,R), Linv (U,R,R) or
    None, fres, N) — ``ivector_posterior_full`` (ivector.cc:167-193), where
    components with N_c < 1e-8 are dropped from the precision and the rhs.
    ``fres`` is F_c − N_c·μ_c, centered on the host in f64."""
    r = t_mat.shape[2]
    sinv_t, g = _precision_tables(t_mat, precision)
    skip = all_n < 1e-8
    nm = torch.where(skip, 0.0, all_n)                             # (U, C)
    fres = torch.where(skip[:, :, None], 0.0, fres)
    eye = torch.eye(r, dtype=t_mat.dtype, device=t_mat.device)
    lmat = eye + (nm @ g.reshape(g.shape[0], r * r)).reshape(-1, r, r)
    rhs = torch.einsum("cdr,ucd->ur", sinv_t, fres)
    # Jacobi equilibration: degenerate UBM components can put ~1e10 into
    # Σ⁻¹, and an f32 factorization of the ~1e13-conditioned L then fails;
    # scaling L to a unit diagonal (exact in exact arithmetic) removes the
    # row/column scale disparity.
    s = torch.rsqrt(torch.diagonal(lmat, dim1=-2, dim2=-1))        # (U, R)
    chol = _cholesky(lmat * s[:, :, None] * s[:, None, :])
    w_mean = s * torch.cholesky_solve((rhs * s)[:, :, None], chol)[:, :, 0]
    linv = (torch.cholesky_inverse(chol) * s[:, :, None] * s[:, None, :]
            if with_linv else None)
    return w_mean, linv, fres, nm


def _em_accumulate_and_update(t_mat, precision, all_n, fres):
    """One T-matrix EM iteration (E over all utterances, then the M-step),
    ivector.cc ``train_ivector_extractor_full``'s loop body."""
    w_mean, linv, fres, nm = _estep_posteriors(t_mat, precision, all_n, fres, True)
    c, _, r = t_mat.shape
    eww = linv + w_mean[:, :, None] * w_mean[:, None, :]
    a = (nm.T @ eww.reshape(-1, r * r)).reshape(c, r, r)           # (C, R, R)
    b = torch.einsum("ucd,ui->cdi", fres, w_mean)
    # M-step: T_c = B_c A_c⁻¹ (ivector.cc:243-252). The ridge plays the C++
    # jitter ladder's role for empty components (common.h:95-101); the same
    # Jacobi equilibration as the E-step (A⁻¹ = S·As⁻¹·S, S = diag(A)^-½).
    a = a + 1e-8 * torch.eye(r, dtype=a.dtype, device=a.device)
    sa = torch.rsqrt(torch.diagonal(a, dim1=-2, dim2=-1))          # (C, R)
    chol = _cholesky(a * sa[:, :, None] * sa[:, None, :])
    sol = torch.cholesky_solve(b.transpose(1, 2) * sa[:, :, None], chol) * sa[:, :, None]
    return sol.transpose(1, 2).contiguous()


def _host_fres(ubm_means, all_n, all_f) -> np.ndarray:
    """Centered first-order stats F_c − N_c μ_c in f64 on the host → f32 (the
    raw F is O(N·|x|), the residual O(N·σ))."""
    fres = (np.asarray(all_f, np.float64)
            - np.asarray(all_n, np.float64)[:, :, None] * np.asarray(ubm_means, np.float64)[None])
    return fres.astype(np.float32)


def init_t_matrix(precision: np.ndarray, ivec_dim: int, seed: int) -> np.ndarray:
    """The T init, the C++'s ``0.1·σ·gauss`` drawn from numpy's
    ``default_rng(seed)`` as the JAX backend draws it: (C, D, R) f32."""
    c, d = precision.shape[:2]
    rng = np.random.default_rng(seed)
    diag = precision if precision.ndim == 2 else np.diagonal(precision, axis1=-2, axis2=-1)
    sigma = np.sqrt(np.maximum(1.0 / np.maximum(diag, 1e-8), 1e-6))
    return (0.1 * sigma[:, :, None] * rng.standard_normal((c, d, ivec_dim))).astype(np.float32)


def train_extractor(ubm_means: np.ndarray, precision: np.ndarray, all_n: np.ndarray,
                    all_f: np.ndarray, ivec_dim: int, iters: int = 5, seed: int = 0,
                    verbose: bool = False, device=None) -> np.ndarray:
    """EM-train the total-variability matrix T (C, D, R) on ``device``.

    ``precision``: (C, D) diagonal precisions (ivector.cc
    ``train_ivector_extractor``) or (C, D, D) full inverse covariances
    (``train_ivector_extractor_full``)."""
    dev = _device(device)
    tj = _t(init_t_matrix(np.asarray(precision), ivec_dim, seed), dev)
    pj = _t(precision, dev)
    nj = _t(all_n, dev)
    fj = _t(_host_fres(ubm_means, all_n, all_f), dev)
    for it in range(iters):
        tj = _em_accumulate_and_update(tj, pj, nj, fj)
        if verbose:
            print(f"[ivector/torch] EM iter {it + 1}/{iters} done")
    t_out = _np64(tj)
    _check_finite("T matrix", t_out)
    return t_out


def extract_ivectors(t_mat: np.ndarray, precision: np.ndarray, ubm_means: np.ndarray,
                     all_n: np.ndarray, all_f: np.ndarray, device=None) -> np.ndarray:
    """Batched i-vector posterior means (U, R), the E-step mean alone
    (ivector.cc ``extract_ivector`` / ``extract_ivector_full``). Rows can
    come out non-finite for pathological stats; ``extract_batch`` re-solves
    those with the f64 native solver rather than failing the batch."""
    dev = _device(device)
    w_mean, _, _, _ = _estep_posteriors(_t(t_mat, dev), _t(precision, dev), _t(all_n, dev),
                                        _t(_host_fres(ubm_means, all_n, all_f), dev), False)
    return _np64(w_mean)
