"""``python -m spoofsv_torch.cli.generate_test_utterances``: the spoof set.

Port of :mod:`spoofsv_tpu.cli.generate_test_utterances` with the same flags
(``generate_test_utterances.py:44-51``: ``-C``, ``--train_spk_num``,
``--enroll_utt_num``, ``--eval_utt_num``, ``-T``; and ``--speaker_batch``,
``--skip_synthesis``, ``--skip_staging``), on one card. The staging of the
evaluation systems' layouts is not ported yet (ROADMAP A.10), so a run must
pass ``--skip_staging``; without it the command raises
``NotImplementedError`` before any work. Until then the staging-only flags
(``--train_spk_num``, ``--enroll_utt_num``) and ``--skip_synthesis`` with
``--skip_staging`` (a run that would do nothing) are usage errors.
Data-parallel synthesis (``--mesh``) is not ported yet.
"""

from __future__ import annotations

import argparse


def main(argv=None, device=None) -> None:
    """Synthesize the spoof set on the card unless ``device`` says otherwise."""
    ps = argparse.ArgumentParser(description="Adversarial Conditional Text-to-speech (spoof set)")
    ps.add_argument("-C", "--configuration", type=str, required=True)
    ps.add_argument("--train_spk_num", type=int, default=None,
                    help="staging only (88 in the reference); not ported yet")
    ps.add_argument("--enroll_utt_num", type=int, default=None,
                    help="staging only (3 in the reference); not ported yet")
    ps.add_argument("--eval_utt_num", type=int, default=20)
    ps.add_argument("-T", "--current_time", type=str, required=True)
    ps.add_argument("--speaker_batch", type=int, default=8,
                    help="speakers synthesized per device batch")
    ps.add_argument("--skip_synthesis", action="store_true")
    ps.add_argument("--skip_staging", action="store_true")
    args = ps.parse_args(argv)
    if not args.skip_staging:
        raise NotImplementedError(
            "staging the i-vector, GE2E and anti-spoofing layouts is not ported yet "
            "(ROADMAP A.10); pass --skip_staging, or stage with the JAX package's "
            "spoofsv_tpu.cli.generate_test_utterances --skip_synthesis")
    if args.train_spk_num is not None or args.enroll_utt_num is not None:
        ps.error("--train_spk_num and --enroll_utt_num configure the staging, which is "
                 "not ported yet (ROADMAP A.10)")
    if args.skip_synthesis:
        ps.error("--skip_synthesis with --skip_staging leaves nothing to do")

    from spoofsv_torch import resolve_device
    from spoofsv_torch.cli.main import apply_runtime_knobs, build_models, inference_dtype
    from spoofsv_torch.config import load_config
    from spoofsv_torch.infer.synthesize import Synthesizer
    from spoofsv_torch.spoofkit import spoofgen
    from spoofsv_torch.weights import load_generator_params

    cfg = load_config(args.configuration)
    apply_runtime_knobs(cfg, infer=True)
    dev = resolve_device(device)
    melsyn, ssrn, _, _ = build_models(cfg, "conditional", dtype=inference_dtype(cfg, dev),
                                      device=dev)
    load_generator_params(cfg.inference_text2mel_model, melsyn)
    load_generator_params(cfg.inference_ssrn_model, ssrn)
    syn = Synthesizer(cfg, melsyn, ssrn, n_frames=cfg.max_frame_num)
    spoofgen.generate_spoof_set(cfg, args.current_time, syn, eval_utt_num=args.eval_utt_num,
                                speaker_batch=args.speaker_batch)


if __name__ == "__main__":
    main()
