"""``python -m spoofsv_torch.cli.curve``: SR-vs-FRR curves for GE2E and i-vectors.

Port of :mod:`spoofsv_tpu.cli.curve`, the reference's ``curve.py`` with its
flags (``curve.py:7-10``: ``--simmat``, ``--ivector_score``), the GE2E test
speakers' count given explicitly (``--n_speakers``). Besides the PNG (drawn
only where matplotlib is installed) it always writes the curves' points to
the PNG's ``.json`` twin (:func:`spoofsv_torch.spoofkit.curve.points_path`).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Compute the curves asked for, write their points, draw them and return
    the PNG's path (None where matplotlib is not installed)."""
    ps = argparse.ArgumentParser(description="spoof rate vs FRR curves")
    ps.add_argument("--simmat", type=str, default=None)
    ps.add_argument("--ivector_score", type=str, default=None)
    ps.add_argument("--n_speakers", type=int, default=20)
    ps.add_argument("--eval_num", type=int, default=20)
    ps.add_argument("--out", type=str, default="curve.png")
    args = ps.parse_args(argv)

    from spoofsv_torch.spoofkit import curve

    ge2e = curve.ge2e_curve(args.simmat, args.n_speakers, args.eval_num) if args.simmat else None
    ivec = curve.ivector_curve(args.ivector_score) if args.ivector_score else None
    print("wrote", curve.save_points(ge2e, ivec, curve.points_path(args.out)))
    out = curve.plot_curves(ge2e, ivec, args.out)
    if out:
        print("wrote", out)
    return out


if __name__ == "__main__":
    main()
