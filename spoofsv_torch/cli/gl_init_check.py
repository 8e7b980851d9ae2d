"""``python -m spoofsv_torch.cli.gl_init_check [B] [--root DIR]``: GL init on trained magnitudes.

Port of ``scripts/gl_init_check.py``: does the SPSI instantaneous-frequency
init reach the reference's spectral convergence in fewer iterations on the
magnitudes the trained TTS really produces? Short, median and long corpus
sentences (:func:`spoofsv_torch.cli.checklib.campaign_setup`) go through the
trained Text2Mel (the fused decode, kernel K1 in the configuration's
inference dtype: bf16 on the card), SSRN and the vocoder's non-log
magnitude transform (max-norm, power 1.3/0.6). Then the spectral
convergence of each (init, iterations) combo of :data:`COMBOS` on the f32
route (K2's init, then the f32 Griffin-Lim of ``csrc/gl.cu``), and of the
shipping candidates on the tensor-core route (K2's SPSI init, then K3 in
int8 and in bf16, ``csrc/gl_tc.cu``). CPU tensors take the plain versions.

Needs the campaign's ``synthesize`` stage done (``config.json`` names the
trained checkpoints). The root is ``--root``, which defaults to the JAX
script's ``$SPOOFSV_CAMPAIGN_ROOT`` or ``<repo>/_campaign``. The result is
merged into ``<root>/state/GL_SPSI_CHECK.json`` (the JAX script writes
``docs/``; ``cli/gl_mcd_ab.py`` merges its table into the same file).
The "random" init is the hash init seeded from
``torch.Generator().manual_seed(0)``, not jax's PRNG.

Runs on the card unless :func:`main` is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from spoofsv_torch.cli import checklib
from spoofsv_torch.cli.campaign import REPO

OUT_NAME = "GL_SPSI_CHECK.json"

COMBOS = [("random", 64),       # the reference's librosa call
          ("advance", 32), ("advance", 24), ("advance", 16),
          ("spsi", 24), ("spsi", 16), ("spsi", 12), ("spsi", 8)]
FUSED = [(16, "bf16"), (16, "int8"), (12, "bf16"), (12, "int8")]


def trained_mags(B: int, device, root: str):
    """(cfg, name -> (B, 4·T, 513) GL input magnitudes on ``device``) from
    the trained checkpoints: fused decode → SSRN → max-norm → power 1.3/0.6
    (``make_vocoder``'s non-log branch)."""
    from spoofsv_torch.cli.main import build_models, inference_dtype
    from spoofsv_torch.ops.decode_kernel import make_fused_decoder
    from spoofsv_torch.weights import load_generator_params

    cfg, text_dists, spk = checklib.campaign_setup(B, root)
    melsyn, ssrn, _, _ = build_models(cfg, "conditional", dtype=inference_dtype(cfg, device),
                                      device=device)
    load_generator_params(cfg.inference_text2mel_model, melsyn)
    load_generator_params(cfg.inference_ssrn_model, ssrn)
    melsyn.eval()
    ssrn.eval()
    dec = make_fused_decoder(melsyn, cfg.max_frame_num)
    power = cfg.norm.reconstruction_power / cfg.norm.analysis_power
    spk_d = torch.from_numpy(spk).to(device)
    out = {}
    with torch.no_grad():
        for name, text_np in text_dists.items():
            mel, _, _ = dec(torch.from_numpy(text_np).to(device), spk_d)
            lin = ssrn(mel).float()
            peak = lin.amax(dim=(1, 2), keepdim=True)
            out[name] = torch.pow(lin / peak.clamp_min(1e-8), power)
            print(f"[mags:{name}] shape={tuple(out[name].shape)} "
                  f"max={float(out[name].max()):.3f}", flush=True)
    return cfg, out


def combo_audio(mag: torch.Tensor, init: str, iters: int, n_fft: int, hop: int) -> torch.Tensor:
    """One combo on the f32 route: K2's ``init`` ("random": hash seeds from
    ``torch.Generator().manual_seed(0)``), then ``iters`` iterations of the
    f32 Griffin-Lim."""
    from spoofsv_torch.infer.synthesize import gl_seeds
    from spoofsv_torch.ops import gl_kernel

    seeds = (gl_seeds(mag.shape[0], torch.Generator().manual_seed(0)).to(mag.device)
             if init == "random" else None)
    ang = gl_kernel.gl_init_angles(mag, n_fft, hop, init, seeds)
    return gl_kernel.griffin_lim_fused(mag, n_fft, hop, n_fft, n_iter=iters, init_angles=ang)


def fused_audio(mag: torch.Tensor, iters: int, tag: str, n_fft: int, hop: int) -> torch.Tensor:
    """A shipping candidate: K2's SPSI init, then K3 on the tensor cores
    (``tag`` "int8" or "bf16" DFT products)."""
    from spoofsv_torch.ops import gl_kernel

    return gl_kernel.griffin_lim_tc(mag, n_fft, hop, n_fft, n_iter=iters, init_mode="spsi",
                                    int8=tag == "int8")


def main(argv=None, device=None) -> dict:
    """Run the check on ``device`` (the card unless ``device="cpu"``);
    returns the artifact this run merged into ``GL_SPSI_CHECK.json``."""
    ps = argparse.ArgumentParser(description="GL init/iterations on trained magnitudes")
    ps.add_argument("B", type=int, nargs="?", default=16)
    ps.add_argument("--root", default=os.environ.get("SPOOFSV_CAMPAIGN_ROOT",
                                                     os.path.join(REPO, "_campaign")))
    args = ps.parse_args(argv)
    device = checklib.check_device(device)
    cfg, mags = trained_mags(args.B, device, args.root)
    n_fft, hop = cfg.stft.fft_length, cfg.stft.hop_length

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    art = {"backend": device.type, "device": name, "batch": args.B,
           "combos": {}, "fused_candidate": {}}
    for dname, mag in mags.items():
        for init, iters in COMBOS:
            key = f"{init}@{iters}"
            t0 = time.perf_counter()
            y = combo_audio(mag, init, iters, n_fft, hop)
            sc = checklib.spectral_convergence(y, mag, n_fft, hop)
            art["combos"].setdefault(key, {})[dname] = round(sc, 5)
            print(f"[{dname}] {key}: sc={sc:.5f} ({time.perf_counter() - t0:.1f}s)", flush=True)

    # the tensor-core K3 (what ships) at the candidate configurations
    for dname, mag in mags.items():
        for iters, tag in FUSED:
            y = fused_audio(mag, iters, tag, n_fft, hop)
            sc = checklib.spectral_convergence(y, mag, n_fft, hop)
            art["fused_candidate"].setdefault(f"spsi{iters}_{tag}", {})[dname] = round(sc, 5)
            print(f"[{dname}] fused spsi{iters} {tag}: sc={sc:.5f}", flush=True)

    # merge (not overwrite): the file also carries gl_mcd_ab's table
    out = os.path.join(args.root, "state", OUT_NAME)
    checklib.merge_json(out, art)
    print(f"[gl_init_check] wrote {out}", flush=True)
    return art


if __name__ == "__main__":
    main()
