"""``python -m spoofsv_torch.cli.curve``: SR-vs-FRR curves for GE2E and i-vectors.

Port of :mod:`spoofsv_tpu.cli.curve`, the reference's ``curve.py`` with its
flags (``curve.py:7-10``: ``--simmat``, ``--ivector_score``), the GE2E test
speakers' count given explicitly (``--n_speakers``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Compute the curves asked for, draw them and return the PNG's path."""
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
    out = curve.plot_curves(ge2e, ivec, args.out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
