"""``python -m spoofsv_torch.cli.generate_test_utterances``: the spoof set and its staging.

Port of :mod:`spoofsv_tpu.cli.generate_test_utterances` with the same flags
(``generate_test_utterances.py:44-51``: ``-C``, ``--train_spk_num``,
``--enroll_utt_num``, ``--eval_utt_num``, ``-T``; and ``--speaker_batch``,
``--skip_synthesis``, ``--skip_staging``), on one card: the spoof set's
synthesis, then the i-vector, GE2E and anti-spoofing layouts.
Data-parallel synthesis (``--mesh`` over more than one device) waits for
the port's mesh layer (ROADMAP A.9).
"""

from __future__ import annotations

import argparse


def main(argv=None, device=None) -> None:
    """Synthesize (on the card unless ``device`` says otherwise) and stage."""
    ps = argparse.ArgumentParser(description="Adversarial Conditional Text-to-speech (spoof set)")
    ps.add_argument("-C", "--configuration", type=str, required=True)
    ps.add_argument("--train_spk_num", type=int, default=88)
    ps.add_argument("--enroll_utt_num", type=int, default=3)
    ps.add_argument("--eval_utt_num", type=int, default=20)
    ps.add_argument("-T", "--current_time", type=str, required=True)
    ps.add_argument("--speaker_batch", type=int, default=8,
                    help="speakers synthesized per device batch")
    ps.add_argument("--skip_synthesis", action="store_true")
    ps.add_argument("--skip_staging", action="store_true")
    ps.add_argument("--mesh", type=str, default=None, metavar="N|all",
                    help="data-parallel synthesis over N devices: one device only yet")
    args = ps.parse_args(argv)

    from spoofsv_torch.cli.main import check_mesh
    from spoofsv_torch.config import load_config
    from spoofsv_torch.spoofkit import spoofgen

    cfg = load_config(args.configuration)
    if not args.skip_synthesis:
        from spoofsv_torch import resolve_device
        from spoofsv_torch.cli.main import apply_runtime_knobs, build_models, inference_dtype
        from spoofsv_torch.infer.synthesize import Synthesizer
        from spoofsv_torch.weights import load_generator_params

        apply_runtime_knobs(cfg, infer=True)
        dev = resolve_device(device)
        check_mesh(args, cfg, dev)
        melsyn, ssrn, _, _ = build_models(cfg, "conditional", dtype=inference_dtype(cfg, dev),
                                          device=dev)
        load_generator_params(cfg.inference_text2mel_model, melsyn)
        load_generator_params(cfg.inference_ssrn_model, ssrn)
        syn = Synthesizer(cfg, melsyn, ssrn, n_frames=cfg.max_frame_num)
        spoofgen.generate_spoof_set(cfg, args.current_time, syn, eval_utt_num=args.eval_utt_num,
                                    speaker_batch=args.speaker_batch)

    if not args.skip_staging:
        print("I-VECTORs test data generation")
        spoofgen.stage_ivector_data(cfg, args.current_time, args.train_spk_num,
                                    args.enroll_utt_num, args.eval_utt_num)
        print("GE2E test data generation")
        spoofgen.stage_ge2e_data(cfg, args.current_time)
        print("Anti-spoofing test data generation")
        spoofgen.stage_antispoof_data(cfg, args.current_time)


if __name__ == "__main__":
    main()
