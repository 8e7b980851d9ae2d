"""The port's SR-vs-FRR curves against the JAX package's, on the CPU: both
curves equal on the same files (the same numpy arithmetic), the i-vector
curve's parsing on a hand-written score file, and the CLI writes a PNG."""

import os

import numpy as np
import pytest

from spoofsv_tpu.spoofkit import curve as jcurve
from spoofsv_torch.cli import curve as cli
from spoofsv_torch.spoofkit import curve


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A GE2E similarity matrix of 3 test speakers (2·(3+5) real rows, then
    2·5 spoof rows per speaker: ``eval_num`` 5) as ``simmat_e*_b*.npy``, and
    a PLDA score file in the pipeline's format."""
    root = tmp_path_factory.mktemp("curve")
    rng = np.random.default_rng(0)
    sim = rng.uniform(0.3, 1.0, size=(3, 26, 3)).astype(np.float32)
    simmat = str(root / "simmat_e0_b0.npy")
    np.save(simmat, sim)
    lines = []
    for e in ("301", "302"):
        for t in ("301", "302"):
            for i in range(4, 30):
                s = rng.normal(2.0 if e == t else -2.0, 3.0)
                lines.append(f"{e} {t}W{i:03d} {s}\n")
    scores = str(root / "plda_scores_mixed.txt")
    with open(scores, "w") as f:
        f.writelines(lines)
    return root, simmat, scores


def test_curves_equal_jax(files):
    _, simmat, scores = files
    assert curve.ge2e_curve(simmat, 3, 5) == jcurve.ge2e_curve(simmat, 3, 5)
    assert curve.ivector_curve(scores) == jcurve.ivector_curve(scores)
    thr = np.asarray([-1.0, 0.0, 2.5])
    assert curve.ivector_curve(scores, 23, thr) == jcurve.ivector_curve(scores, 23, thr)


def test_ivector_curve_counts(tmp_path):
    """Targets with index > 23 are spoofs; rates are over the real count."""
    p = tmp_path / "s.txt"
    p.write_text("301 301W004 5.0\n301 301W005 -1.0\n301 301W024 3.0\n301 302W024 9.0\n"
                 "bad line\n")
    srs, frrs = curve.ivector_curve(str(p), thresholds=np.asarray([0.0, 4.0]))
    assert srs == [0.5, 0.0] and frrs == [0.5, 0.5]


def test_cli_writes_png(files, capsys):
    root, simmat, scores = files
    out = str(root / "curve.png")
    got = cli.main(["--simmat", simmat, "--ivector_score", scores, "--n_speakers", "3",
                    "--eval_num", "5", "--out", out])
    assert got == out and os.path.getsize(out) > 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert "wrote" in capsys.readouterr().out
