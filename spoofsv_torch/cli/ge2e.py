"""``python -m spoofsv_torch.cli.ge2e {preprocess|train|test|dvector}``: GE2E verification.

Port of :mod:`spoofsv_tpu.cli.ge2e`, one dispatcher for the reference's
``GE2E/data_preprocess.py`` (``preprocess``),
``GE2E/train_speech_embedder.py`` (``train`` and ``test``) and
``GE2E/dvector_create.py`` (``dvector``), with the same flags. The
configuration is the reference's ``config.yaml``
(:meth:`spoofsv_torch.config.GE2EConfig.from_yaml`). Training, testing and
the d-vectors run on the card unless :func:`main` is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse


def main(argv=None, device=None):
    """Run the command; ``train`` returns ``(embedder, loss)``, ``test`` the
    result dict, ``dvector`` the ``(train_sequence, train_cluster_id)`` arrays."""
    ps = argparse.ArgumentParser(description="GE2E speaker verification (PyTorch/CUDA)")
    ps.add_argument("command", choices=["preprocess", "train", "test", "dvector"])
    ps.add_argument("--config", type=str, default=None,
                    help="GE2E config.yaml (reference schema)")
    ps.add_argument("--train_spk_num", type=int, default=88)
    ps.add_argument("--enroll_num", type=int, default=3)
    ps.add_argument("--eval_num", type=int, default=20)
    ps.add_argument("--model_path", type=str, default=None)
    ps.add_argument("--epochs", type=int, default=None)
    ps.add_argument("--out_dir", type=str, default=".")
    ps.add_argument("--nospoof_data", type=str, default=None,
                    help="glob over the staged real-only test_nospoof copy "
                         "(e.g. <test_root>/ivector_data/test_nospoof/*/*.wav); "
                         "runs the reference's second test_nospoof pass for "
                         "the clean threshold instead of the slice formulation")
    args = ps.parse_args(argv)

    from spoofsv_torch.config import GE2EConfig
    from spoofsv_torch.spoofkit import ge2e_harness

    ge2e = GE2EConfig.from_yaml(args.config) if args.config else GE2EConfig()
    if args.command == "preprocess":
        # the reference passes enroll_num + eval_num as the real-crop count
        # (GE2E/data_preprocess.py:102)
        return ge2e_harness.save_spectrogram_tisv(ge2e, args.train_spk_num,
                                                  args.enroll_num + args.eval_num,
                                                  args.eval_num)
    if args.command == "train":
        return ge2e_harness.train_ge2e(ge2e, max_epochs=args.epochs, device=device)
    if args.command == "test":
        return ge2e_harness.run_ge2e_evaluation(ge2e, args.enroll_num, args.eval_num,
                                                model_path=args.model_path, epochs=args.epochs,
                                                nospoof_data=args.nospoof_data, device=device)
    from spoofsv_torch.spoofkit.dvector import create_dvectors
    from spoofsv_torch.weights import load_ge2e_params

    embedder, _ = ge2e_harness.build_ge2e(ge2e, device)
    load_ge2e_params(args.model_path or ge2e.model.model_path, embedder)
    return create_dvectors(ge2e, embedder, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
