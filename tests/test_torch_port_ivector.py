"""The port's i-vector/PLDA pipeline against the JAX package's, on the CPU.

Mirrors ``tests/test_ivector_jax.py`` with the port's ``torch`` backend
(``device="cpu"``) in place of the JAX one, and holds it to both the native
C++ and the JAX device backend on the same seeded numpy inputs:

* Baum-Welch stats: rtol 2e-4 (diag) and 3e-4 (full) against native, as
  the JAX tests hold the JAX backend to native; rtol 2e-4 against
  ``ivector_jax``;
* extraction: 2e-3 against native and against ``ivector_jax``;
* EM training with the same seed: the same numpy split draws and T init as
  ``ivector_jax``, so the models agree, not only their likelihoods. Measured
  here: diag UBM ≤ 3.5e-5, full UBM ≤ 1.2e-5, T ≤ 6e-6 (absolute, on values
  of order 1-4); the bounds below are 1e-3 absolute;
* a pathological stats row: ``cholesky_ex`` fails, the row comes out
  non-finite and is re-solved natively, as the JAX backend's is;
* ``run_ivector_pipeline`` on a small staged tree in both packages: native
  score files byte-equal (both build ``libspoofkit`` from byte-equal
  sources); the device backends at the metric level: the same EERs, spoof
  rate and trials, the clean threshold within 1e-2 and every PLDA score
  within 5e-2 relative. The toy features' full covariances are
  ill-conditioned (the extractors' ``inv(covs)`` reach 1.3e4), so the UBMs'
  f32-level differences (3.4e-5) become inverse-covariance differences of
  830 and PLDA scores 3 % apart (measured: 0.074 on scores up to 90);
* the CLI, ``--recompute_eer`` and ``--spoof_threshold`` included.
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

from spoofsv_tpu.cli import ivector as jcli
from spoofsv_tpu.config import Config as JConfig
from spoofsv_tpu.spoofkit import ivector as jiv
from spoofsv_tpu.spoofkit import ivector_jax
from spoofsv_torch.cli import ivector as cli
from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host
from spoofsv_torch.spoofkit import ivector as iv
from spoofsv_torch.spoofkit import ivector_torch as it

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

CPU = dict(backend="torch", device="cpu")


def _gmm_frames(rng, n=3000, d=6):
    """3 well-separated diagonal-gaussian clusters."""
    centers = np.asarray([[4.0] * d, [-4.0] * d, [0.0] * d])
    scales = np.asarray([0.7, 1.2, 0.5])
    comp = rng.integers(0, 3, size=n)
    return (centers[comp] + scales[comp, None] * rng.normal(size=(n, d))).astype(np.float64)


def _loglike_diag(frames, w, m, v):
    v = np.maximum(v, 1e-6)
    ll = (np.log(np.maximum(w, 1e-20))[None]
          - 0.5 * frames.shape[1] * np.log(2 * np.pi)
          - 0.5 * np.sum(np.log(v), axis=1)[None]
          - 0.5 * np.sum((frames[:, None, :] - m[None]) ** 2 / v[None], axis=2))
    mx = ll.max(axis=1)
    return float(np.mean(mx + np.log(np.exp(ll - mx[:, None]).sum(axis=1))))


def _loglike_full(frames, w, m, covs):
    from scipy.stats import multivariate_normal
    comp = np.stack([multivariate_normal.logpdf(frames, m[c], covs[c], allow_singular=True)
                     for c in range(len(w))], axis=1)
    comp = comp + np.log(np.maximum(w, 1e-20))[None]
    mx = comp.max(axis=1)
    return float(np.mean(mx + np.log(np.exp(comp - mx[:, None]).sum(axis=1))))


def _close_stats(got, want, rtol):
    for (n0, f0), (n1, f1) in zip(want, got):
        np.testing.assert_allclose(n1, n0, rtol=rtol, atol=1e-5)
        np.testing.assert_allclose(f1, f0, rtol=rtol, atol=rtol)


# ----------------------------------------------------------------------
# stats and extraction
# ----------------------------------------------------------------------

def test_diag_stats_match_native_and_jax():
    rng = np.random.default_rng(11)
    c, d = 8, 6
    w = rng.dirichlet(np.ones(c))
    m = rng.normal(size=(c, d)) * 3
    v = rng.uniform(0.5, 2.0, size=(c, d))
    ubm = iv.UBM(w, m, v)
    feats = [rng.normal(size=(t, d)) * 2 for t in (37, 120, 260)]
    got = ubm.acc_stats_batch(feats, **CPU)
    _close_stats(got, [ubm.acc_stats(f) for f in feats], 2e-4)
    _close_stats(got, ivector_jax.acc_stats_diag_batch(w, m, v, feats), 2e-4)


def test_full_stats_match_native_and_jax():
    rng = np.random.default_rng(12)
    c, d = 5, 4
    w = rng.dirichlet(np.ones(c))
    m = rng.normal(size=(c, d)) * 2
    a = rng.normal(size=(c, d, d)) * 0.3
    covs = a @ a.transpose(0, 2, 1) + np.eye(d)[None]
    fubm = iv.FullUBM(w, m, covs)
    feats = [rng.normal(size=(t, d)) * 2 for t in (50, 140)]
    got = fubm.acc_stats_batch(feats, **CPU)
    _close_stats(got, [fubm.acc_stats(f) for f in feats], 3e-4)
    _close_stats(got, ivector_jax.acc_stats_full_batch(w, m, covs, feats), 2e-4)


def _full_extractor(tmp_path, rng, c=6, d=4, r=5):
    T = rng.normal(size=(c, d, r)) * 0.3
    means = rng.normal(size=(c, d))
    a = rng.normal(size=(c, d, d)) * 0.2
    inv_covs = a @ a.transpose(0, 2, 1) + np.eye(d)[None]
    p = str(tmp_path / "ext.npz")
    np.savez(p, T=T, means=means, inv_covs=inv_covs)
    return iv.IvectorExtractorFull.load(p), (T, means, inv_covs)


def test_full_extraction_matches_native_and_jax(tmp_path):
    rng = np.random.default_rng(13)
    ext, (T, means, inv_covs) = _full_extractor(tmp_path, rng)
    u = 7
    allN = rng.uniform(0.0, 50.0, size=(u, 6))
    allN[0, :3] = 0.0              # the N_c < 1e-8 skip
    allF = rng.normal(size=(u, 6, 4)) * 10
    stats = [(allN[i], allF[i]) for i in range(u)]
    got = ext.extract_batch(stats, **CPU)
    np.testing.assert_allclose(got, np.stack([ext.extract(*s) for s in stats]),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, ivector_jax.extract_ivectors(T, inv_covs, means, allN, allF),
                               rtol=2e-3, atol=2e-3)


def test_diag_extraction_matches_native_and_jax(tmp_path):
    rng = np.random.default_rng(14)
    c, d, r, u = 6, 4, 3, 5
    T = rng.normal(size=(c, d, r)) * 0.3
    means = rng.normal(size=(c, d))
    inv_vars = rng.uniform(0.4, 2.5, size=(c, d))
    p = str(tmp_path / "dext.npz")
    np.savez(p, T=T, means=means, inv_vars=inv_vars)
    ext = iv.IvectorExtractor.load(p)
    allN = rng.uniform(0.0, 40.0, size=(u, c))
    allF = rng.normal(size=(u, c, d)) * 8
    stats = [(allN[i], allF[i]) for i in range(u)]
    got = ext.extract_batch(stats, **CPU)
    np.testing.assert_allclose(got, np.stack([ext.extract(*s) for s in stats]),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, ivector_jax.extract_ivectors(T, inv_vars, means, allN, allF),
                               rtol=2e-3, atol=2e-3)


def test_failed_cholesky_row_is_resolved_natively(tmp_path, capsys):
    """A component whose inverse covariance is indefinite (eigenvalues 3 and
    -1) with a large count makes the row's precision indefinite though its
    diagonal stays positive: ``cholesky_ex`` fails, the row is NaN (where
    ``jnp.linalg.cholesky`` gives NaN), and ``extract_batch`` re-solves it
    with the f64 native solver, printing the count, as the JAX backend does."""
    T = np.tile(np.eye(2)[None], (2, 1, 1)) * 0.5
    means = np.zeros((2, 2))
    inv_covs = np.stack([np.asarray([[1.0, 2.0], [2.0, 1.0]]), np.eye(2)])
    p = str(tmp_path / "bad.npz")
    np.savez(p, T=T, means=means, inv_covs=inv_covs)
    ext = iv.IvectorExtractorFull.load(p)
    allN = np.asarray([[0.0, 20.0], [400.0, 5.0], [0.0, 9.0]])
    allF = np.random.default_rng(0).normal(size=(3, 2, 2)) * 4
    raw = it.extract_ivectors(T, inv_covs, means, allN, allF, device="cpu")
    assert np.isfinite(raw[[0, 2]]).all() and not np.isfinite(raw[1]).any()
    assert not np.isfinite(ivector_jax.extract_ivectors(T, inv_covs, means, allN, allF)[1]).any()
    stats = [(allN[i], allF[i]) for i in range(3)]
    capsys.readouterr()
    got = ext.extract_batch(stats, **CPU)
    assert "re-solved 1 utterances natively" in capsys.readouterr().out
    np.testing.assert_array_equal(got[1], ext.extract(*stats[1]))
    want = jiv.IvectorExtractorFull.load(p).extract_batch(stats, backend="jax")
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


# ----------------------------------------------------------------------
# EM training
# ----------------------------------------------------------------------

def test_diag_ubm_em_matches_jax_and_native_quality():
    rng = np.random.default_rng(15)
    frames = _gmm_frames(rng)
    got = iv.UBM.train(frames, 4, iters=4, seed=1, **CPU)
    for a, b in zip((got.weights, got.means, got.vars),
                    ivector_jax.train_diag_ubm(frames, 4, iters=4, seed=1)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    nat = iv.UBM.train(frames, 4, iters=4, seed=1, backend="native")
    ll_n = _loglike_diag(frames, nat.weights, nat.means, nat.vars)
    assert _loglike_diag(frames, got.weights, got.means, got.vars) > ll_n - 0.05


def test_full_ubm_em_matches_jax_and_native_quality():
    rng = np.random.default_rng(16)
    frames = _gmm_frames(rng, n=2000)
    diag = iv.UBM.train(frames, 3, iters=3, seed=2, backend="native")
    got = iv.FullUBM.train(diag, frames, iters=2, **CPU)
    for a, b in zip((got.weights, got.means, got.covs),
                    ivector_jax.train_full_ubm(diag.weights, diag.means, diag.vars, frames,
                                               iters=2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    nat = iv.FullUBM.train(diag, frames, iters=2, backend="native")
    ll_n = _loglike_full(frames, nat.weights, nat.means, nat.covs)
    assert _loglike_full(frames, got.weights, got.means, got.covs) > ll_n - 0.05
    np.testing.assert_allclose(got.weights, nat.weights, atol=2e-3)


def test_t_matrix_em_matches_jax_and_learns_natives_subspace():
    """The same seed gives the same T init as ``ivector_jax``, so the trained
    T agrees with JAX's; against native (another RNG) the leading canonical
    correlations of the i-vector sets are ≈1 and both separate speakers."""
    rng = np.random.default_rng(17)
    d, n_spk, utts, t = 5, 4, 8, 400
    spk_shift = rng.normal(size=(n_spk, d)) * 4.0
    feats, labels = [], []
    for s in range(n_spk):
        for _ in range(utts):
            feats.append(spk_shift[s] + rng.normal(size=(t, d)))
            labels.append(s)
    pool = np.concatenate(feats)
    diag = iv.UBM.train(pool, 6, iters=3, seed=3, backend="native")
    full = iv.FullUBM.train(diag, pool, iters=2, backend="native")
    stats = full.acc_stats_batch(feats, **CPU)

    inv_covs = np.linalg.inv(full.covs)
    allN = np.stack([s[0] for s in stats])
    allF = np.stack([s[1] for s in stats])
    np.testing.assert_allclose(
        it.train_extractor(full.means, inv_covs, allN, allF, 6, iters=5, seed=4, device="cpu"),
        ivector_jax.train_extractor(full.means, inv_covs, allN, allF, 6, iters=5, seed=4),
        rtol=0, atol=1e-3)
    np.testing.assert_array_equal(it.init_t_matrix(inv_covs, 6, 4),
                                  it.init_t_matrix(np.diagonal(inv_covs, 0, 1, 2).copy(), 6, 4))

    ivs = {}

    def sep(backend):
        ext = iv.IvectorExtractorFull.train(full, stats, ivec_dim=6, iters=5, seed=4,
                                            backend=backend, device="cpu")
        iv_all = ext.extract_batch(stats, **CPU)
        ivs[backend] = iv_all
        iv_all = iv_all - iv_all.mean(axis=0)
        iv_all = iv_all / np.linalg.norm(iv_all, axis=1, keepdims=True)
        sim = iv_all @ iv_all.T
        lab = np.asarray(labels)
        return float(sim[lab[:, None] == lab[None, :]].mean()
                     - sim[lab[:, None] != lab[None, :]].mean())

    s_native, s_torch = sep("native"), sep("torch")
    assert s_native > 0.0 and s_torch > 0.5 * s_native, (s_torch, s_native)

    def _orthobasis(x):
        return np.linalg.svd(x - x.mean(axis=0), full_matrices=False)[0]

    ccs = np.linalg.svd(_orthobasis(ivs["native"]).T @ _orthobasis(ivs["torch"]),
                        compute_uv=False)
    assert float(np.mean(ccs[:4])) > 0.9, ccs


def test_backend_resolution():
    assert iv.resolve_backend("auto") == "torch"
    assert iv.resolve_backend("jax") == "torch"
    assert iv.resolve_backend("torch") == "torch"
    assert iv.resolve_backend("native") == "native"
    with pytest.raises(ValueError):
        iv.resolve_backend("cuda")


def test_device_backend_defaults_to_the_card():
    """Without ``device`` the torch backend asks for the card; with no card
    that raises instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        it.train_diag_ubm(np.zeros((10, 2)), 2)
    with pytest.raises(RuntimeError):
        iv.UBM(np.ones(1), np.zeros((1, 2)), np.ones((1, 2))).acc_stats_batch(
            [np.zeros((4, 2))], backend="torch")


# ----------------------------------------------------------------------
# the pipeline and the CLI on a staged tree
# ----------------------------------------------------------------------

SR = 16000


def _utterance(rng, pitch: float, seconds: float = 1.2) -> np.ndarray:
    """Voiced-looking audio: harmonics of a speaker's pitch with a syllable
    envelope, over a little noise (so the energy VAD keeps most frames)."""
    t = np.arange(int(SR * seconds)) / SR
    y = sum(np.sin(2 * np.pi * pitch * k * t + rng.uniform(0, 6)) / k for k in range(1, 8))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t))
    return (0.2 * y * env / 3.0 + 0.005 * rng.normal(size=t.size)).astype(np.float32)


def _stage_tree(root: str, ctime: str = "t") -> None:
    """``test/<ctime>/ivector_data`` as the stager lays it out: 3 train
    speakers of 4 utterances; 2 test speakers of 2 enroll + 2 eval real
    utterances (indices 1-4) and 2 spoofs (5-6, past enroll + eval = 4);
    ``test_nospoof`` the real utterances' byte-equal copies."""
    rng = np.random.default_rng(0)
    base = os.path.join(root, "test", ctime, "ivector_data")
    for i, spk in enumerate(("225", "226", "227")):
        d = os.path.join(base, "wav", "train", spk)
        os.makedirs(d)
        for u in range(1, 5):
            host.write_wav(os.path.join(d, f"{spk}W{u:03d}.wav"), _utterance(rng, 110 + 40 * i),
                           SR)
    for i, spk in enumerate(("301", "302")):
        d = os.path.join(base, "wav", "test", spk)
        ns = os.path.join(base, "test_nospoof", spk)
        os.makedirs(d)
        os.makedirs(ns)
        for u in range(1, 7):
            pitch = 130 + 50 * i if u <= 4 else 150 + 20 * i
            name = f"{spk}W{u:03d}.wav"
            host.write_wav(os.path.join(d, name), _utterance(rng, pitch), SR)
            if u <= 4:
                shutil.copyfile(os.path.join(d, name), os.path.join(ns, name))


PIPE = dict(enroll_num=2, eval_num=2, num_gauss=4, ivec_dim=3, workers=2, verbose=False)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ivec"))
    _stage_tree(root)
    return root


def _scores(root: str) -> dict:
    out = {}
    for name in ("mixed", "nospoof"):
        path = os.path.join(root, "test", "t", "ivector_data", "scores", f"plda_scores_{name}.txt")
        out[name] = iv.read_score_file(path)
    return out


def test_native_pipeline_writes_the_jax_packages_score_files(staged, tmp_path):
    cfg, jcfg = Config(src_root_dir=staged + "/"), JConfig(src_root_dir=staged + "/")
    score_dir = os.path.join(staged, "test", "t", "ivector_data", "scores")
    want = jiv.run_ivector_pipeline(jcfg, "t", backend="native", **PIPE)
    os.rename(score_dir, str(tmp_path / "jax_scores"))
    got = iv.run_ivector_pipeline(cfg, "t", backend="native", **PIPE)
    assert got == want
    for name in ("plda_scores_mixed.txt", "plda_scores_nospoof.txt", "result.json"):
        assert filecmp.cmp(os.path.join(score_dir, name), str(tmp_path / "jax_scores" / name),
                           shallow=False), name
    assert got["n_spoof_targets"] == 2 * 2 * 1 and got["n_mixed_trials"] == 2 * 2 * 4


@pytest.fixture
def eight_threads():
    """Eight intra-op threads, whatever ``port_threads`` gives the process: the
    torch backend's f32 reductions follow the thread count, and the toy
    covariances' ill-conditioning carries the difference to the clean
    threshold. At 8 threads it lies within 1e-2 of the JAX backend's; at 1, 2
    or 4 it reads -9.6527 against -9.6257 (ROADMAP C.8)."""
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_device_pipeline_matches_the_jax_backend(staged, tmp_path, eight_threads):
    """``backend="torch"`` on the CPU against the JAX package's
    ``backend="jax"``, full-covariance UBM, models saved and then reused: the
    same EERs and spoof rate (the module docstring gives the tolerances)."""
    cfg, jcfg = Config(src_root_dir=staged + "/"), JConfig(src_root_dir=staged + "/")
    want = jiv.run_ivector_pipeline(jcfg, "t", backend="jax", **PIPE)
    want_scores = _scores(staged)
    models = str(tmp_path / "models")
    got = iv.run_ivector_pipeline(cfg, "t", backend="torch", device="cpu", models_dir=models,
                                  **PIPE)
    got_scores = _scores(staged)
    for name in ("mixed", "nospoof"):
        assert [s[:3] for s in got_scores[name]] == [s[:3] for s in want_scores[name]]
        np.testing.assert_allclose([s[3] for s in got_scores[name]],
                                   [s[3] for s in want_scores[name]], rtol=5e-2, atol=0)
    for k in ("mixed_eer", "clean_eer", "spoof_rate", "n_mixed_trials", "n_spoof_targets"):
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert got["clean_threshold"] == pytest.approx(want["clean_threshold"], abs=1e-2)
    assert sorted(os.listdir(models)) == ["extractor.npz", "fubm.npz", "ivector_models_meta.json",
                                         "mean_ivec.npy", "plda.npz", "ubm.npz"]
    again = iv.run_ivector_pipeline(cfg, "t", backend="torch", device="cpu", models_dir=models,
                                    **PIPE)
    for k in ("mixed_eer", "clean_eer", "clean_threshold", "spoof_rate"):
        assert again[k] == pytest.approx(got[k], rel=1e-9), k


def test_cli_matches_the_jax_cli(staged, tmp_path, capsys):
    """``main`` with the JAX CLI's flags (``--backend jax`` included) and
    ``--device cpu``; ``--recompute_eer`` and ``--spoof_threshold`` print
    what the JAX CLI prints for the same score file."""
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        json.dump(Config(src_root_dir=staged + "/").to_reference_dict(), f)
    flags = ["-C", conf, "-T", "t", "--enroll_num", "2", "--eval_num", "2", "--num_gauss", "4",
             "--ivec_dim", "3", "--workers", "2", "--diag_ubm", "--backend", "jax"]
    res = cli.main(flags + ["--device", "cpu"])
    capsys.readouterr()
    assert all(np.isfinite(res[k]) for k in ("mixed_eer", "clean_eer", "spoof_rate"))
    path = os.path.join(staged, "test", "t", "ivector_data", "scores", "plda_scores_mixed.txt")
    extra = ["--enroll_num", "2", "--eval_num", "2", "--spoof_threshold",
             str(res["clean_threshold"])]
    out = cli.main(["--recompute_eer", path] + extra)
    printed = capsys.readouterr().out
    jcli.main(["--recompute_eer", path] + extra)
    assert printed == capsys.readouterr().out
    assert out["eer"] == pytest.approx(res["mixed_eer"], abs=1e-12)
    assert out["spoof_rate"] == pytest.approx(res["spoof_rate"], abs=1e-12)
    with pytest.raises(SystemExit):
        cli.main(["--backend", "native"])
