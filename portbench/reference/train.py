"""Plain-torch reference of a Text2Mel training step: the teacher-forced
forward (:func:`dctts.text2mel_forward`), the published losses (L1, binary
divergence and guided attention, averaged over the padded batch as the
reference averages them), autograd, and Adam written out. It imports
nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import dctts


def guided_attention(max_n: int, max_t: int, g: float = 0.2) -> np.ndarray:
    """W[n, t] = 1 − exp(−(t/T − n/N)² / (2g²)) over the model's largest text and rollout."""
    n = np.arange(max_n)[:, None] / max_n
    t = np.arange(max_t)[None, :] / max_t
    return (1.0 - np.exp(-((t - n) ** 2) / (2.0 * g * g))).astype(np.float32)


def losses(batch: dict, y: torch.Tensor, a: torch.Tensor, gaw: torch.Tensor) -> torch.Tensor:
    target = batch["mel"]
    l1 = (target - y).abs().mean()
    p = y.clamp(0.0, 1.0)
    bd = (-target * torch.log(p.clamp_min(1e-8))
          - (1.0 - target) * torch.log((1.0 - p).clamp_min(1e-8))).mean()
    _, n, t = a.shape
    att = (a * gaw[:n, :t][None]).sum() / a.numel()
    return l1 + bd + att


def shift_right(mel: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], dim=1)


def run_steps(sd: Dict[str, torch.Tensor], batches: List[dict], adam: dict, gaw: torch.Tensor,
              p: dctts.Precision = dctts.F32
              ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Adam steps from ``sd``, one a batch: returns each step's loss, the
    first step's gradient and the parameters after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()}
    m = {k: torch.zeros_like(v) for k, v in sd.items()}
    v2 = {k: torch.zeros_like(v) for k, v in sd.items()}
    b1, b2, lr, eps = adam["beta_1"], adam["beta_2"], adam["alpha"], adam["epsilon"]
    out_losses, first_grad = [], None
    for step, batch in enumerate(batches, start=1):
        y, a = dctts.text2mel_forward(params, shift_right(batch["mel"]), batch["text"],
                                      batch["spk"], p)
        loss = losses(batch, y, a, gaw)
        grads = torch.autograd.grad(loss, list(params.values()))
        out_losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, w), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** step)
                v_hat = v2[k] / (1 - b2 ** step)
                w.sub_(lr * m_hat / (v_hat.sqrt() + eps))
    return out_losses, first_grad, {k: w.detach() for k, w in params.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in keep}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].norm()) - norms[k]) / max(norms[k], median, 1e-30)
            for k in keep}


def step_readings(sd0: Dict[str, torch.Tensor], batches: List[dict], adam: dict,
                  gaw: torch.Tensor, prog: dict, p: dctts.Precision = dctts.F32) -> dict:
    """The program's first steps against the reference's from the same
    parameters and batches. ``prog`` holds the program's ``losses`` (one a
    step), its first ``grad`` (a dict of leaves) and its ``params`` after
    the steps. Leaves whose reference gradient is under a thousandth of
    the median leaf's move by round-off alone and are left out."""
    ref_losses, g_ref, w_ref = run_steps(sd0, batches, adam, gaw, p)
    g_norm = {k: float(v.norm()) for k, v in g_ref.items()}
    floor = 1e-3 * float(np.median(list(g_norm.values())))
    keep = [k for k in g_ref if g_norm[k] >= floor]
    grad = leaf_gaps(prog["grad"], g_ref, keep)
    change = leaf_gaps({k: prog["params"][k] - sd0[k] for k in keep},
                       {k: w_ref[k] - sd0[k] for k in keep}, keep)
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref_losses)]
    return {"loss_gap": max(loss), "loss_gap_first": loss[0],
            "grad_gap": max(grad.values()), "change_gap": max(change.values()),
            "change_gap_median": float(np.median(list(change.values()))),
            "leaves_left_out": float(len(g_ref) - len(keep)),
            "worst_grad_leaf": max(grad, key=grad.get), "worst_change_leaf": max(change, key=change.get)}
