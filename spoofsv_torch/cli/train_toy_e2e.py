"""``python -m spoofsv_torch.cli.train_toy_e2e [steps] [--adversarial]``: learning dynamics.

Port of ``scripts/train_toy_e2e.py``: the real stack (``prepare_vctk``
splits → ``TTSDataSource`` features → ``BucketedLoader`` → ``Trainer``,
ordinary with guided attention, or WGAN-GP with ``--adversarial``) on the
synthetic char→tone corpus (4 speakers × 40 utterances, ``toy_config``'s
hidden 64), then an autoregressive decode of the first validation batch
through the configuration's decode route (kernel K1 in f32 on the card)
and a JSON summary with the JAX script's keys: whether attention became
monotonic (``attention_monotonicity``), the loss at the start and the end,
the last Wasserstein distances and the seconds an iteration.

Runs on the card unless :func:`main` is given ``device="cpu"``. The corpus
goes to a fresh temporary directory (printed). ``SPOOFSV_TOY_METRICS_EVERY=k``
sets the metric read-back cadence (default every iteration).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def main(argv=None, device=None) -> dict:
    """Train for ``steps`` iterations, decode, print and return the summary."""
    ps = argparse.ArgumentParser(description="toy-corpus learning dynamics")
    ps.add_argument("steps", type=int, nargs="?", default=2000)
    ps.add_argument("--adversarial", action="store_true",
                    help="WGAN-GP regime (RATIO D:G alternation)")
    cli = ps.parse_args(argv)

    import torch

    from spoofsv_torch import reference_precision, resolve_device
    from spoofsv_torch.cli.main import apply_runtime_knobs
    from spoofsv_torch.data.pipeline import BucketedLoader, TTSDataSource
    from spoofsv_torch.data.toy import attention_monotonicity, generate_toy_corpus, toy_config
    from spoofsv_torch.data.vctk import prepare_vctk
    from spoofsv_torch.infer.decode import make_decoder
    from spoofsv_torch.infer.synthesize import decode_route
    from spoofsv_torch.models import MelDisc, MelSyn
    from spoofsv_torch.ops.decode_kernel import make_fused_decoder
    from spoofsv_torch.train import Trainer

    device = resolve_device(device)
    if device.type == "cuda":
        reference_precision()   # f32 means f32: no TF32 convs or matmuls
    adversarial, steps = cli.adversarial, cli.steps
    work = tempfile.mkdtemp(prefix="toy_e2e_")
    data_root = os.path.join(work, "corpus")
    spk_emb = os.path.join(work, "spk_emb")
    print(f"[toy-e2e] workdir {work}", flush=True)

    generate_toy_corpus(data_root, spk_emb, n_speakers=4, utts_per_spk=40)
    cfg = toy_config(data_root, spk_emb, work)
    prepare_vctk(cfg, verbose=False)
    apply_runtime_knobs(cfg)

    # Text2Mel trains on the mel alone: the sources read no linear spectrogram
    # (the training CLI's rule; the same batches)
    source = TTSDataSource(cfg, mode="train", spec_dir=os.path.join(work, "spec"),
                           need_lin=False)
    source.warm_cache()
    loader = BucketedLoader(source, cfg.batch_size, seed=0)

    torch.manual_seed(0)
    model = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, cfg.mel.freq_bins,
                   cfg.hidden_dim).to(device)
    disc = MelDisc(cfg.disc_dim, freq_bins=cfg.mel.freq_bins).to(device) if adversarial else None
    trainer = Trainer(cfg, model, "train_text2mel", ctime="toy", adversarial=adversarial,
                      disc_model=disc, validate_with_decode=False,
                      metrics_every=int(os.environ.get("SPOOFSV_TOY_METRICS_EVERY", "1")))

    it = 0
    t0 = time.time()
    fetched = []              # (iteration, loss) whenever metrics were fetched
    while it < steps:
        for batch in loader:
            batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
            if trainer.state is None:
                trainer.init()
            m = trainer.train_iteration(batch)
            if m and "loss" in m:
                fetched.append((it, m["loss"]))
            it += 1
            if it % 200 == 0 and m:
                shown = " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())
                                 if k in ("loss", "att", "loss_d", "wd", "gp"))
                print(f"[toy-e2e] iter {it} {shown} "
                      f"({(time.time() - t0) / it * 1000:.0f} ms/it)", flush=True)
            if it >= steps:
                break
    first_losses = [v for _, v in fetched[:3]] or [float("nan")]
    last_losses = [v for _, v in fetched[-3:]] or [float("nan")]

    # AR decode on held-out sentences; measure attention monotonicity
    val = TTSDataSource(cfg, mode="validate", spec_dir=os.path.join(work, "spec"), need_lin=False)
    vb = next(iter(BucketedLoader(val, 8, seed=0, shuffle=False)))
    n_frames = int(vb["mel"].shape[1])
    model.eval()
    make = make_fused_decoder if decode_route(cfg) == "kernel" else make_decoder
    with torch.no_grad():
        _, att, _ = make(model, n_frames)(torch.as_tensor(vb["text"]).to(device),
                                          torch.as_tensor(vb["spk"]).to(device))
    att = att.float().cpu().numpy()

    mets = []
    for b in range(att.shape[0]):
        tl = int(np.asarray(vb["text_mask"][b]).sum())
        fl = int(np.asarray(vb["mel_mask"][b]).sum())
        mets.append(attention_monotonicity(att[b], tl, fl))
    summary = {
        "steps": steps,
        "adversarial": adversarial,
        "wd_tail": [round(float(v), 4) for v in trainer.loss_logs["wd"][-5:]],
        "loss_first": float(np.mean(first_losses)),
        "loss_last": float(np.mean(last_losses)),
        "forward_frac": float(np.mean([m["forward_frac"] for m in mets])),
        "coverage": float(np.mean([m["coverage"] for m in mets])),
        "confidence": float(np.mean([m["confidence"] for m in mets])),
        "sec_per_iter": (time.time() - t0) / max(1, it),
    }
    trainer.close()
    print(json.dumps(summary, indent=2), flush=True)
    return summary


if __name__ == "__main__":
    main()
