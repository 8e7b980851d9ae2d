"""``python -m spoofsv_torch.cli.generate_test_utterances``: the spoof set and its staging.

Port of :mod:`spoofsv_tpu.cli.generate_test_utterances` with the same flags
(``generate_test_utterances.py:44-51``: ``-C``, ``--train_spk_num``,
``--enroll_utt_num``, ``--eval_utt_num``, ``-T``; and ``--speaker_batch``,
``--skip_synthesis``, ``--skip_staging``, ``--mesh``): the spoof set's
synthesis (data-parallel over the ``--mesh`` ranks, each call padded to the
rank multiple, :func:`spoofsv_torch.cli.main.data_parallel`), then, on rank
0, the i-vector, GE2E and anti-spoofing layouts. A Tacotron 2 configuration
synthesizes through ``Tacotron2Synthesizer``.
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
    from spoofsv_torch.cli.main import add_mesh_args

    add_mesh_args(ps, "data-parallel spoof-set synthesis")
    args = ps.parse_args(argv)

    from spoofsv_torch.config import Tacotron2Config, load_config
    from spoofsv_torch.spoofkit import spoofgen

    cfg = load_config(args.configuration)
    primary = True
    if not args.skip_synthesis:
        from spoofsv_torch import resolve_device
        from spoofsv_torch.cli.main import (apply_runtime_knobs, build_models,
                                            build_tacotron2_synthesizer, data_parallel,
                                            inference_dtype)
        from spoofsv_torch.infer.synthesize import Synthesizer
        from spoofsv_torch.weights import load_generator_params

        apply_runtime_knobs(cfg, infer=True)
        dev = resolve_device(device)
        with data_parallel(args, cfg, dev, "spoofsv_torch.cli.generate_test_utterances",
                           argv) as mesh:
            dev = dev if mesh is None else mesh.device
            primary = mesh is None or mesh.rank == 0
            if isinstance(cfg, Tacotron2Config):
                syn = build_tacotron2_synthesizer(cfg, dev, mesh)
            else:
                melsyn, ssrn, _, _ = build_models(cfg, "conditional",
                                                  dtype=inference_dtype(cfg, dev), device=dev)
                load_generator_params(cfg.inference_text2mel_model, melsyn)
                load_generator_params(cfg.inference_ssrn_model, ssrn)
                syn = Synthesizer(cfg, melsyn, ssrn, n_frames=cfg.max_frame_num, mesh=mesh)
            spoofgen.generate_spoof_set(cfg, args.current_time, syn,
                                        eval_utt_num=args.eval_utt_num,
                                        speaker_batch=args.speaker_batch, verbose=primary)

    if not args.skip_staging and primary:
        print("I-VECTORs test data generation")
        spoofgen.stage_ivector_data(cfg, args.current_time, args.train_spk_num,
                                    args.enroll_utt_num, args.eval_utt_num)
        print("GE2E test data generation")
        spoofgen.stage_ge2e_data(cfg, args.current_time)
        print("Anti-spoofing test data generation")
        spoofgen.stage_antispoof_data(cfg, args.current_time)


if __name__ == "__main__":
    main()
