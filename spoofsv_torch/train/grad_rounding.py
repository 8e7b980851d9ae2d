"""Why a G step's gradients part from the plain step's far more than its outputs do.

Under the highway kernels, the Text2Mel G step's outputs part from the plain
PyTorch step's by rounding (at most 3.1e-5 on the card), its gradients by
about 2e-3 (relative, all parameters as one vector). This tool separates
the cause on the CPU, in f32, with the plain highway blocks only. It takes
the G step's two gradients apart, ∇recon (L1 + binary divergence + guided
attention) and ∇loss_disc (the critic's term), and measures how far they
move when

* the generator's outputs get noise of the kernels' size (``OUT_NOISE``),
  with L1 as it is and replaced by a smooth loss;
* each highway block's output gets noise (``BLOCK_NOISE``, relative to
  its largest value), with the ReLU masks free and frozen at the
  unperturbed pass's.

Run: ``python -m spoofsv_torch.train.grad_rounding`` (the card's G-step
shape, ``CARD_SHAPE``, at full width, random weights from seed 0). It
prints one JSON object.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spoofsv_torch.cli.main import build_models
from spoofsv_torch.config import Config
from spoofsv_torch.models import layers
from spoofsv_torch.train import losses, steps

OUT_NOISE = 3.1e-5    # the largest gap of the kernels' G-step outputs on the card
BLOCK_NOISE = 1e-6    # relative to each highway block's largest output
CARD_SHAPE = dict(batch=16, text=186, frames=325)


class _ReluMasks(torch.overrides.TorchFunctionMode):
    """While active, ``torch.relu`` records its masks into ``record`` and,
    given ``masks``, applies those in turn instead of its own."""

    def __init__(self, masks: Optional[List[torch.Tensor]],
                 record: Optional[List[torch.Tensor]]):
        super().__init__()
        self.replay = iter(masks) if masks is not None else None
        self.record = record

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.relu:
            return func(*args, **kwargs)
        x, = args
        if self.record is not None:
            self.record.append(x.detach() > 0)
        return x * next(self.replay) if self.replay is not None else func(x)


def relative_gap(g: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> float:
    """‖g − ref‖ / ‖ref‖ over all parameters as one vector."""
    d = sum(float(torch.linalg.norm(a - b)) ** 2 for a, b in zip(g, ref))
    return (d / sum(float(torch.linalg.norm(b)) ** 2 for b in ref)) ** 0.5


def g_step_gradients(melsyn, critic, batch: Dict[str, torch.Tensor], gaw: torch.Tensor,
                     out_noise=None, block_noise: bool = False, smooth: bool = False,
                     masks: Optional[List[torch.Tensor]] = None,
                     record: Optional[List[torch.Tensor]] = None):
    """(∇recon, ∇loss_disc, mel) of one teacher-forced G step. ``out_noise``:
    (mel, attention) noise added to the outputs; ``block_noise``: uniform
    noise of ``BLOCK_NOISE`` relative to each highway block's largest
    output (drawn from a generator seeded 5); ``smooth``: L1 replaced by
    ``mean(r²) / 0.02``; ``masks``: the ReLU masks to apply instead of the
    ReLUs' own; ``record``: a list the ReLU masks of this pass go into."""
    gen = torch.Generator().manual_seed(5)

    def perturb(mod, inputs, out):
        return out + BLOCK_NOISE * out.detach().abs().max() * (
            2 * torch.rand(out.shape, generator=gen) - 1)

    hooks = [m.register_forward_hook(perturb) for m in melsyn.modules()
             if block_noise and isinstance(m, layers.HighwayConv)]
    try:
        with _ReluMasks(masks, record):   # Text2Mel's forward only: the critic has no ReLU
            y, a = melsyn(steps.shift_right(batch["mel"]), batch["text"], batch["spk"])
    finally:
        for h in hooks:
            h.remove()
    if out_noise is not None:
        y, a = y + out_noise[0], a + out_noise[1]
    mel = batch["mel"]
    first = ((mel - y) ** 2).mean() / 0.02 if smooth else losses.l1_loss(mel, y)
    recon = first + losses.binary_divergence(mel, y) + losses.guided_attention_loss(a, gaw)
    loss_disc = torch.mean(-critic(y))
    params = list(melsyn.parameters())
    return (*(torch.autograd.grad(loss, params, retain_graph=True)
              for loss in (recon, loss_disc)), y.detach())


def separate(batch: int, text: int, frames: int, hidden: int = 256,
             seed: int = 0) -> Dict[str, float]:
    """Every gap, with random weights from ``seed``, at the shipping widths
    but Text2Mel's ``hidden`` (its text embedding half of it)."""
    torch.manual_seed(seed)
    cfg = Config().replace(hidden_dim=hidden, text_emb_dim=hidden // 2)
    melsyn, _, critic, _ = build_models(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    b = {"mel": torch.from_numpy(rng.uniform(0.05, 0.95, (batch, frames, cfg.mel.freq_bins))
                                 .astype(np.float32)),
         "text": torch.from_numpy(rng.integers(1, cfg.vocab_len - 1, (batch, text))),
         "spk": torch.from_numpy(rng.normal(size=(batch, cfg.spk_emb_dim)).astype(np.float32))}
    gaw = steps.guided_attention_table(cfg)(torch.device("cpu"))

    def grads(**kw):
        return g_step_gradients(melsyn, critic, b, gaw, **kw)

    masks: List[torch.Tensor] = []
    g_recon, g_disc, y0 = grads(record=masks)
    gen = torch.Generator().manual_seed(seed + 1)
    noise = [OUT_NOISE * (2 * torch.rand(s, generator=gen) - 1)
             for s in (y0.shape, (batch, text, frames))]
    n_recon, n_disc, _ = grads(out_noise=noise)
    s_recon, s_disc, _ = grads(smooth=True)
    sn_recon, sn_disc, _ = grads(out_noise=noise, smooth=True)
    seen: List[torch.Tensor] = []
    b_recon, b_disc, yb = grads(block_noise=True, record=seen)
    f_recon, f_disc, _ = grads(block_noise=True, masks=masks)
    fs_recon0, fs_disc0, _ = grads(smooth=True, masks=masks)
    fs_recon, fs_disc, _ = grads(block_noise=True, masks=masks, smooth=True)
    residual = b["mel"] - y0
    return {
        "shape": [batch, text, frames],
        "hidden": hidden,
        "out_noise": OUT_NOISE,
        "l1_signs_flipped": int((residual.sign() != (residual - noise[0]).sign()).sum()),
        "out_noise_recon": relative_gap(n_recon, g_recon),
        "out_noise_disc": relative_gap(n_disc, g_disc),
        "out_noise_smooth_recon": relative_gap(sn_recon, s_recon),
        "out_noise_smooth_disc": relative_gap(sn_disc, s_disc),
        "block_noise": BLOCK_NOISE,
        "block_noise_out_max_abs": float((yb - y0).abs().max()),
        "relu_masks_flipped": sum(int((m0 != m1).sum()) for m0, m1 in zip(masks, seen)),
        "relu_units": sum(m.numel() for m in masks),
        "block_noise_recon": relative_gap(b_recon, g_recon),
        "block_noise_disc": relative_gap(b_disc, g_disc),
        "block_noise_frozen_recon": relative_gap(f_recon, g_recon),
        "block_noise_frozen_disc": relative_gap(f_disc, g_disc),
        "block_noise_frozen_smooth_recon": relative_gap(fs_recon, fs_recon0),
        "block_noise_frozen_smooth_disc": relative_gap(fs_disc, fs_disc0),
    }


def main() -> Dict[str, float]:
    out = separate(**CARD_SHAPE)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
