"""``python -m spoofsv_torch.cli.antispoof {train,dev} -C config.json -T <ctime>``.

Port of :mod:`spoofsv_tpu.cli.antispoof`, the reference's
``anti_spoofing/main_spoof_conv1d.py``, with the same flags: ``train``
fits the countermeasure on the bonafide TTS list and the ASVspoof2019 LA
train spoofs (batch 64 over ``cfg.tpu.bucket_frames``) and writes
``./checkpoints/<ctime>/<it>_iteration.npz`` every ``--save_interval``
iterations and ``final.npz`` at ``--max_iterations``; ``dev -R <ckpt>``
scores the dev bonafide and the staged ``customized_data_<ctime>.txt``
spoofs into ``./cm_scores/scores_<ctime>.txt`` and prints the CM EER.
``--variant`` v1/v2 and ``--feat mel|lin`` pick the critic as the JAX CLI
does. Checkpoints are the JAX CLI's flat ``.npz`` keyed by flax paths, so
either package reads the other's. Runs on ``--device`` (default: the card,
or :func:`main`'s ``device``).
"""

from __future__ import annotations

import argparse
import os


def build_cm(cfg, variant, feat: str):
    """The countermeasure critic of ``--variant`` and ``--feat``
    (``spoofsv_tpu/cli/antispoof.py:43-54``): v1 pools lighter (pool1 2, no
    second pool), v2 adds the extra conv/pool stage (the reference's
    ``melDisc_v1/v2``, ``anti_spoofing/discriminator.py:134-306``)."""
    from spoofsv_torch.models.discriminator import Critic1D

    pool2 = None if variant == "v1" else (2 if feat == "mel" else 4)
    pool1 = 2 if variant == "v1" else (4 if feat == "mel" else 8)
    in_dim = cfg.mel.freq_bins if feat == "mel" else cfg.lin_bins
    return Critic1D(in_dim, disc_dim=cfg.disc_dim, pool1=pool1, pool2=pool2,
                    mid_dim=4 if feat == "mel" else 8, extra_stage=(variant == "v2"),
                    sigmoid_out=True)


def main(argv=None, device=None):
    """Run the step; ``train`` returns the trained critic, ``dev`` the
    ``(score_path, eer, threshold)``."""
    ps = argparse.ArgumentParser(description="Anti-spoofing countermeasure (PyTorch/CUDA)")
    ps.add_argument("step", choices=["train", "dev"], metavar="s")
    ps.add_argument("-T", "--time", type=str, required=True)
    ps.add_argument("-R", "--resume", type=str, default=None)
    ps.add_argument("-C", "--configuration", type=str, required=True)
    ps.add_argument("--variant", type=str, default=None)
    ps.add_argument("--feat", choices=["mel", "lin"], default="mel")
    ps.add_argument("--max_iterations", type=int, default=None)
    ps.add_argument("--save_interval", type=int, default=1000)
    ps.add_argument("--bonafide_cap", type=int, default=20000,
                    help="TTS-train-list utterances used as train bonafide; the remainder "
                         "becomes the dev bonafide side (anti_spoofing/spoof_conv1d.py:9-68 "
                         "uses 20k)")
    ps.add_argument("--device", type=str, default=device,
                    help="device to train and score on (default: the card)")
    args = ps.parse_args(argv)

    import numpy as np
    import torch

    from spoofsv_torch import resolve_device
    from spoofsv_torch.config import load_config
    from spoofsv_torch.spoofkit.antispoof import (ASVspoofSource, batches, cm_eer,
                                                  make_cm_train_step, write_cm_scores)
    from spoofsv_torch.weights import load_critic_params, save_critic_params

    dev = resolve_device(args.device)
    cfg = load_config(args.configuration)
    torch.manual_seed(0)
    model = build_cm(cfg, args.variant, args.feat).to(dev)
    source = ASVspoofSource(cfg, args.step, args.time, bonafide_cap=args.bonafide_cap)
    print(f"{args.step}: {len(source)} utterances ({int(source.labels.sum())} bonafide)")
    step_fn, score_fn, _ = make_cm_train_step(
        model, generator=torch.Generator(device=dev).manual_seed(0))

    if args.step == "train":
        save_dir = os.path.join("./checkpoints", args.time)
        os.makedirs(save_dir, exist_ok=True)
        it = 0
        for epoch in range(20000):
            for batch in batches(source, 64, cfg.tpu.bucket_frames, True, seed=epoch,
                                 feat=args.feat):
                loss = step_fn(torch.from_numpy(batch["x"]).to(dev),
                               torch.from_numpy(batch["label"]).to(dev))
                it += 1
                if it % 50 == 0:
                    print(f"iter {it} loss {float(loss):.4f}")
                if it % args.save_interval == 0:
                    save_critic_params(os.path.join(save_dir, f"{it}_iteration.npz"), model)
                if args.max_iterations and it >= args.max_iterations:
                    save_critic_params(os.path.join(save_dir, "final.npz"), model)
                    return model
        return model

    load_critic_params(args.resume, model)
    scores = []
    for batch in batches(source, 64, cfg.tpu.bucket_frames, False, feat=args.feat):
        pred = score_fn(torch.from_numpy(batch["x"]).to(dev)).cpu().numpy()
        for i in range(len(pred)):
            scores.append((int(batch["idx"][i]), float(batch["label"][i]), float(pred[i])))
    path = write_cm_scores(scores, args.time)
    eer, thr = cm_eer(np.asarray([s[1] for s in scores]), np.asarray([s[2] for s in scores]))
    print(f"wrote {path}; CM EER {eer:.4f} @ {thr:.4f}")
    return path, eer, thr


if __name__ == "__main__":
    main()
