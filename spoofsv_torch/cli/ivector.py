"""``python -m spoofsv_torch.cli.ivector``: the i-vector + PLDA evaluation.

Port of :mod:`spoofsv_tpu.cli.ivector`, the ``kaldi_ivectors/run.sh``
equivalent, with the same flags: ``-C config.json -T <ctime>`` runs feature
extraction (MFCC, deltas, sliding CMVN, energy VAD), UBM / T-matrix / PLDA
training at the reference's Kaldi scale (1024 Gaussians, 400-dim i-vectors,
run.sh:105-129; ``--num_gauss/--ivec_dim`` scale it down), the mixed and
no-spoof scoring, the EER and the spoof rate.

``--models_dir <dir>`` keeps UBM/T/PLDA between invocations (run.sh's
first-run-only training). ``--recompute_eer <scores.txt>`` recomputes the EER
and threshold of a saved score file (``ivector_eer.sh:30``); with
``--spoof_threshold`` it also reports the spoof rate at that threshold
(``ivector_spoofrate.py``). ``--backend`` takes ``auto``, ``torch``,
``native`` and, for command lines written for the JAX package, ``jax`` (the
torch backend). The torch backend runs on ``--device`` (default: the card,
or :func:`main`'s ``device``).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None, device=None):
    """Run the evaluation and return its result dict (or, with
    ``--recompute_eer``, the recomputed numbers)."""
    ps = argparse.ArgumentParser(description="i-vector + PLDA evaluation (PyTorch/CUDA)")
    ps.add_argument("-C", "--configuration", type=str)
    ps.add_argument("-T", "--current_time", type=str)
    ps.add_argument("--enroll_num", type=int, default=3)
    ps.add_argument("--eval_num", type=int, default=20)
    ps.add_argument("--num_gauss", type=int, default=1024)
    ps.add_argument("--ivec_dim", type=int, default=400)
    ps.add_argument("--no_deltas", action="store_true",
                    help="disable Kaldi add-deltas (order 2, window 3) in the MFCC front-end; "
                         "default on, as the sid/ scripts' 60-dim features")
    ps.add_argument("--max_train_utts_per_spk", type=int, default=40)
    ps.add_argument("--workers", type=int, default=8)
    ps.add_argument("--diag_ubm", action="store_true",
                    help="skip the full-covariance UBM upgrade (run.sh:110-118)")
    ps.add_argument("--full_ubm_iters", type=int, default=3)
    ps.add_argument("--models_dir", type=str, default=None,
                    help="keep the trained UBM/T/PLDA here and reuse them on later runs "
                         "(run.sh first-run-only training)")
    ps.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "torch", "jax", "native"],
                    help="EM/stats/extraction backend: batched torch on --device (jax is "
                         "another name for it) or the scalar C++ (native)")
    ps.add_argument("--device", type=str, default=device,
                    help="device of the torch backend (default: the card)")
    ps.add_argument("--recompute_eer", type=str, default=None, metavar="SCORES",
                    help="recompute the EER of a saved score file and exit (ivector_eer.sh)")
    ps.add_argument("--spoof_threshold", type=float, default=None,
                    help="with --recompute_eer: also report the spoof rate at this threshold "
                         "(ivector_spoofrate.py)")
    args = ps.parse_args(argv)

    from spoofsv_torch.spoofkit import ivector

    if args.recompute_eer:
        eer, thr = ivector.recompute_eer_from_scores(args.recompute_eer)
        out = {"eer": eer, "threshold": thr}
        if args.spoof_threshold is not None:
            rate, n = ivector.spoof_rate_from_scores(args.recompute_eer, args.spoof_threshold,
                                                     args.enroll_num, args.eval_num)
            out.update({"spoof_rate": rate, "n_spoof_targets": n,
                        "spoof_threshold": args.spoof_threshold})
        print(json.dumps(out))
        return out

    if not args.configuration or not args.current_time:
        ps.error("-C and -T are required unless --recompute_eer is given")

    from spoofsv_torch.config import load_config

    cfg = load_config(args.configuration)
    return ivector.run_ivector_pipeline(
        cfg, args.current_time, args.enroll_num, args.eval_num, args.num_gauss, args.ivec_dim,
        args.max_train_utts_per_spk, workers=args.workers, use_full_ubm=not args.diag_ubm,
        full_ubm_iters=args.full_ubm_iters, models_dir=args.models_dir, backend=args.backend,
        use_deltas=not args.no_deltas, device=args.device)


if __name__ == "__main__":
    main()
