"""One data-parallel adversarial step and one sharded synthesis call over N ranks.

Port of ``dryrun_multichip`` (the JAX package's ``__graft_entry__.py``): a
WGAN-GP G step and D step of Text2Mel at the reference's widths (hidden
256, text embedding 128, speaker 200, critic 128; only the lengths are
short: N=64, T=80, two rows a rank) through the fused adversarial step,
the batch split over the ranks and the gradients all-reduced; then one
``Synthesizer`` call over the mesh (SSRN at width 16, ``gl_iters=3``).
Run: ``python -m spoofsv_torch.parallel.dryrun [N] [--device cpu] [--share]``
(default 2 ranks on the cards, rank r on ``cuda:r`` over NCCL; ``--share``
puts all ranks on one card over gloo; ``--device cpu`` runs gloo ranks on
the CPU).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from spoofsv_torch import resolve_device
from spoofsv_torch.config import Config
from spoofsv_torch.infer.synthesize import Synthesizer
from spoofsv_torch.models import SSRN, MelDisc, MelSyn
from spoofsv_torch.parallel import multihost
from spoofsv_torch.parallel.mesh import Mesh, replicate_tree, shard_batch
from spoofsv_torch.train.steps import make_fused_adversarial_step


def dryrun_rank(mesh: Mesh) -> dict:
    """One rank's dryrun; returns the G/D metrics and the audio's shape."""
    n = mesh.size
    cfg = Config().replace(max_text_len=64, max_frame_num=80)
    torch.manual_seed(0)   # rank 0's draw is broadcast below; the seed keeps runs alike
    model = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, cfg.mel.freq_bins,
                   cfg.hidden_dim).to(mesh.device)
    disc = MelDisc(cfg.disc_dim, freq_bins=cfg.mel.freq_bins).to(mesh.device)
    rng = np.random.default_rng(0)
    B, T, N = 2 * n, 80, 64
    batch = {"mel": rng.uniform(0.05, 0.95, (B, T, cfg.mel.freq_bins)).astype(np.float32),
             "text": rng.integers(1, cfg.vocab_len - 1, (B, N)).astype(np.int32),
             "spk": rng.normal(size=(B, cfg.spk_emb_dim)).astype(np.float32)}
    init_fn, step = make_fused_adversarial_step(model, disc, cfg, "train_text2mel", mesh=mesh)
    state = replicate_tree(init_fn(), mesh)
    local = shard_batch(batch, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(1)
    state, m_g = step(state, local, gen)   # step 0: the G step
    state, m_d = step(state, local, gen)   # step 1: a D step
    for m in (m_g, m_d):
        for k, v in m.items():
            assert bool(torch.isfinite(v).all()), (k, v)
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): OK — G loss={float(m_g['loss']):.4f}, "
              f"D wd={float(m_d['wd']):.4f}", flush=True)

    ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, 16).to(mesh.device)
    syn = Synthesizer(cfg, model, ssrn, n_frames=cfg.max_frame_num, gl_iters=3, mesh=mesh)
    audio, _, _ = syn(batch["text"], batch["spk"])
    assert audio.shape[0] == B and bool(torch.isfinite(audio).all())
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): inference OK — sharded synthesis B={B} -> "
              f"{audio.shape[1]} samples/row", flush=True)
    return {"g_loss": float(m_g["loss"]), "d_wd": float(m_d["wd"]),
            "audio_shape": tuple(audio.shape)}


def dryrun_multichip(n_devices: int = 2, device=None, share: bool = False,
                     run_dir: Optional[str] = None) -> list:
    """Run :func:`dryrun_rank` on ``n_devices`` ranks (this process is rank
    0) and return every rank's result. ``device`` None means the cards (raises
    without one); the CPU only when asked for. Raises if a rank fails or the
    ranks' metrics differ (they are the global batch's on every rank)."""
    devices = multihost.rank_devices(n_devices, resolve_device(device), share=share)
    out = multihost.spawn(n_devices, dryrun_rank, devices=devices,
                          backend="gloo" if share else None, run_dir=run_dir)
    if any(r != out[0] for r in out):
        raise RuntimeError(f"the ranks' dryrun results differ: {out}")
    return out


def main(argv=None) -> None:
    ps = argparse.ArgumentParser(description="data-parallel dryrun over N ranks")
    ps.add_argument("n", type=int, nargs="?", default=2)
    ps.add_argument("--device", default=None, help="cuda (default) or cpu")
    ps.add_argument("--share", action="store_true",
                    help="all ranks time-share the one device, over gloo")
    args = ps.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.share)


if __name__ == "__main__":
    main()
