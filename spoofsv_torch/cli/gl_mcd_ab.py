"""``python -m spoofsv_torch.cli.gl_mcd_ab [--root DIR] [--batches 3]``: the GL default by MCD.

Port of ``scripts/gl_mcd_ab.py``: judge the Griffin-Lim candidates on the
task metric by analysis-by-synthesis MCD: vocode → audio → re-extract the
coarse mel with the reference feature pipeline (``dsp/host.py::tts_features``)
→ DTW-MCD against the ground-truth mel (``spoofkit/mcd.py::batch_mcd``).
Two legs a candidate, over ``--batches`` batches of the ``synthesize``
split (``BucketedLoader``, no shuffle):

* ``copy_synthesis``: the ground-truth linear magnitudes through the
  vocoder, GL quality alone;
* ``tts``: the trained campaign TTS's magnitudes (``Synthesizer``, the fused
  decode K1 in the inference dtype, then ``ssrn_apply``), end to end.

Candidates (:data:`CANDIDATES`): the reference mode random@64, and the
shipping vocoder at spsi@12/16/24 and advance@24. The reference mode must be
reference-faithful: the JAX script asks for ``griffin_lim_impl="xla"`` with
``"highest"`` precision, its f32 XLA loop. The port's counterpart of that
loop on the card is the f32 Griffin-Lim kernel ``csrc/gl.cu`` (the "f32"
route), while its ``"xla"`` route is plain torch on any device; so the
reference mode here is ``"auto"`` with ``"highest"``: ``gl.cu`` on the card,
plain f32 GL on the CPU. The other candidates take the configuration's
route: K2 and K3 int8 (``csrc/gl_tc.cu``) on the card. The "random" init is
the hash init, seeded from ``torch.Generator().manual_seed(0)``.

The table is merged into ``<root>/state/GL_SPSI_CHECK.json`` under
``"mcd_ab"`` (the JAX script writes ``docs/``). Runs on the card unless
:func:`main` is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from spoofsv_torch.cli import checklib
from spoofsv_torch.cli.campaign import BASE_TAG, REPO, resolve_checkpoint

CANDIDATES = [("random", 64), ("spsi", 16), ("spsi", 24), ("advance", 24), ("spsi", 12)]


def candidate_config(cfg, init: str, iters: int):
    """The configuration a candidate vocodes with: the reference mode
    (random@64) on the f32 route ("auto" + "highest"), the others on the
    configuration's own route."""
    tpu = dataclasses.replace(cfg.tpu, griffin_lim_init=init, griffin_lim_iters=iters)
    if (init, iters) == ("random", 64):
        tpu = dataclasses.replace(tpu, griffin_lim_impl="auto", griffin_lim_precision="highest")
    return cfg.replace(tpu=tpu)


def audio_to_mel(a: np.ndarray, cfg) -> np.ndarray:
    from spoofsv_torch.dsp import host as dsp_host

    m, _ = dsp_host.tts_features(np.asarray(a, np.float32), cfg.sampling_rate, cfg)
    return m


def main(argv=None, device=None) -> dict:
    """Run the A/B on ``device`` (the card unless ``device="cpu"``); returns
    the ``"mcd_ab"`` section it merged into ``GL_SPSI_CHECK.json``."""
    ps = argparse.ArgumentParser(description="GL candidates by analysis-by-synthesis MCD")
    ps.add_argument("--root", default=os.path.join(REPO, "_campaign_r5"))
    ps.add_argument("--batches", type=int, default=3)
    ps.add_argument("--batch_size", type=int, default=16)
    args = ps.parse_args(argv)
    device = checklib.check_device(device)

    from spoofsv_torch.cli.main import build_models, inference_dtype
    from spoofsv_torch.config import load_config
    from spoofsv_torch.data.pipeline import BucketedLoader, TTSDataSource
    from spoofsv_torch.infer.synthesize import Synthesizer, gl_seeds, make_vocoder
    from spoofsv_torch.spoofkit.mcd import batch_mcd
    from spoofsv_torch.weights import load_generator_params

    cfg = load_config(os.path.join(args.root, "config.json"))
    melsyn, ssrn, _, _ = build_models(cfg, "conditional", dtype=inference_dtype(cfg, device),
                                      device=device)
    load_generator_params(resolve_checkpoint(args.root, BASE_TAG, "text2mel"), melsyn)
    load_generator_params(resolve_checkpoint(args.root, BASE_TAG, "ssrn"), ssrn)

    src = TTSDataSource(cfg, "synthesize", os.path.join(args.root, "spec"), need_lin=True)
    loader = BucketedLoader(src, args.batch_size, with_lin=True, shuffle=False)
    vocoders = {c: make_vocoder(candidate_config(cfg, *c), c[1]) for c in CANDIDATES}

    results = {f"{i}@{n}": {"copy_synthesis": [], "tts": []} for i, n in CANDIDATES}
    syns = {}
    gen = torch.Generator().manual_seed(0)   # the "random" init's seeds, a call each
    for bi, batch in enumerate(loader):
        if bi >= args.batches:
            break
        t = batch["mel"].shape[1]
        if t not in syns:
            syns[t] = Synthesizer(cfg, melsyn, ssrn, n_frames=t)
        B = batch["text"].shape[0]
        _, mel_pred, _ = syns[t].device_call(batch["text"], batch["spk"], gl_seeds(B, gen))
        lin_pred = syns[t].ssrn_apply(mel_pred)
        mel_gt = np.asarray(batch["mel"])
        lin_gt = torch.from_numpy(np.asarray(batch["lin"])).to(device)
        lengths = np.asarray(batch["mel_mask"]).sum(1).astype(int)
        for (init, iters), voc in vocoders.items():
            name = f"{init}@{iters}"
            for leg, lin in (("copy_synthesis", lin_gt), ("tts", lin_pred)):
                audio = voc(lin, gl_seeds(B, gen).to(device)).cpu().numpy()
                mels = [audio_to_mel(audio[b], cfg) for b in range(audio.shape[0])]
                v = batch_mcd(mel_gt, mels, lengths, analysis_power=cfg.norm.analysis_power)
                results[name][leg].append(v)
                print(f"[gl_mcd_ab] batch {bi} {name:12s} {leg:14s} {v:.3f} dB", flush=True)

    summary = {name: {leg: round(float(np.mean(vs)), 3) for leg, vs in legs.items()}
               for name, legs in results.items()}
    print(json.dumps(summary, indent=1))
    section = {
        "note": ("analysis-by-synthesis MCD (vocode -> audio -> re-extract "
                 "mel -> DTW-MCD vs GT mel); copy_synthesis feeds GT linear "
                 "mags (pure GL quality), tts feeds the trained TTS's "
                 "prediction (end-to-end task metric). Lower is better. "
                 "random@64 is the reference-faithful f32 GL (csrc/gl.cu on "
                 "the card, plain f32 GL on the CPU); the other candidates "
                 "run the configuration's route (K2 + K3 int8 on the card) - "
                 "what ships."),
        "batches": args.batches, "batch_size": args.batch_size,
        "backend": device.type,
        "results_db": summary,
    }
    out = os.path.join(args.root, "state", "GL_SPSI_CHECK.json")
    checklib.merge_json(out, {"mcd_ab": section})
    print(f"[gl_mcd_ab] merged into {out}")
    return section


if __name__ == "__main__":
    main()
