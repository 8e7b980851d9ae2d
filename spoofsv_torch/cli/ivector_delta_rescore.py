"""``python -m spoofsv_torch.cli.ivector_delta_rescore [--root DIR]``: the deltas front-end shift.

Port of ``scripts/ivector_delta_rescore.py``: re-score the campaign's
staging (``<root>/test/<tag>``) at reference scale (1024 Gaussians /
400-dim i-vectors, at most 20 training utterances a speaker, 400,000 UBM
frames) both ways:

  a. ``no_deltas_cached_r3``: the models cached in
     ``<root>/ivector_models_ref``, scoring only (run.sh [1] semantics);
  b. ``deltas_fresh``: models trained afresh on 60-dim delta features into
     ``<root>/ivector_models_ref_deltas``;

and write the EER / threshold / spoof-rate shift to
``<root>/state/IVECTOR_DELTAS.json`` (the JAX script writes ``docs/``).

Cached models pin ``use_deltas`` from their meta. The JAX script's "before"
leg expects round-3 models without deltas there; on a tree that the port's
campaign made, ``ivector_models_ref`` holds its ``ivector_ref`` stage's
models, which use deltas, so both legs use deltas and the shift checks that
training afresh reproduces the cached models' scores. The behaviour is the
JAX script's, kept as it is. At 1024 Gaussians the EM, stats and extraction
run on the card unless :func:`main` is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from spoofsv_torch.cli import checklib
from spoofsv_torch.cli.campaign import REPO

KEYS = ("mixed_eer", "clean_eer", "clean_threshold", "spoof_rate")


def main(argv=None, device=None) -> dict:
    """Run both legs on ``device`` (the card unless ``device="cpu"``);
    returns what it writes to ``state/IVECTOR_DELTAS.json``."""
    ps = argparse.ArgumentParser(description="i-vector deltas front-end rescore")
    ps.add_argument("--root", default=os.path.join(REPO, "_campaign"))
    ps.add_argument("--tag", default="campaign")
    ps.add_argument("--enroll", type=int, default=3)
    ps.add_argument("--eval_num", type=int, default=20)
    args = ps.parse_args(argv)
    device = checklib.check_device(device)

    from spoofsv_torch.config import load_config
    from spoofsv_torch.spoofkit.ivector import run_ivector_pipeline

    cfg = load_config(os.path.join(args.root, "config.json"))
    common = dict(enroll_num=args.enroll, eval_num=args.eval_num, num_gauss=1024, ivec_dim=400,
                  workers=8, max_train_utts_per_spk=20, ubm_frames_cap=400_000, verbose=True,
                  device=device)

    results = {}
    # (a) before: the cached models (their meta pins use_deltas)
    t0 = time.perf_counter()
    results["no_deltas_cached_r3"] = run_ivector_pipeline(
        cfg, args.tag, models_dir=os.path.join(args.root, "ivector_models_ref"), **common)
    results["no_deltas_cached_r3"]["_wall_s"] = round(time.perf_counter() - t0, 1)

    # (b) after: fresh reference-scale training on 60-dim delta features
    t0 = time.perf_counter()
    results["deltas_fresh"] = run_ivector_pipeline(
        cfg, args.tag, use_deltas=True,
        models_dir=os.path.join(args.root, "ivector_models_ref_deltas"), **common)
    results["deltas_fresh"]["_wall_s"] = round(time.perf_counter() - t0, 1)

    for k in KEYS:
        a = results["no_deltas_cached_r3"].get(k)
        b = results["deltas_fresh"].get(k)
        if a is not None and b is not None:
            results.setdefault("shift", {})[k] = round(b - a, 5)

    art = {"scale": "1024 Gaussians / 400-dim (run.sh:105-129)",
           "staging": os.path.join(args.root, "test", args.tag),
           "feature_front_end": {
               "before": "MFCC20 + sliding CMVN + energy VAD (r3)",
               "after": "MFCC20 + add-deltas(order2,window3) -> 60-dim + "
                        "sliding CMVN + energy VAD (Kaldi sid/ parity)"},
           "results": results}
    out = os.path.join(args.root, "state", "IVECTOR_DELTAS.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(art, f, indent=1, default=float)
    print(json.dumps(art, indent=1, default=float))
    print(f"[ivector_delta_rescore] wrote {out}", flush=True)
    return art


if __name__ == "__main__":
    main()
