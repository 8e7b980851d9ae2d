"""Why the G step's gradients part from "xla" far more than its outputs do.

On the card, the highway kernels' G-step outputs differ from the plain
PyTorch step's by at most 3.1e-5, while the gradient of the reconstruction
loss differs by 2.2e-3 (relative, all parameters as one vector) and that of
the critic's term by 1.1e-3. ``spoofsv_torch.train.grad_rounding``
separates the cause on the CPU, in f32, with the plain highway blocks only;
here on a Text2Mel of hidden 64 at B=16, N=60, T=100 (``python -m
spoofsv_torch.train.grad_rounding`` runs it at full width and the card's
step shape):

* noise of ±3.1e-5 on the generator's outputs alone moves ∇recon by more
  than 1e-3: L1's gradient is the residual's sign, and the noise flips the
  sign of the residuals within 3.1e-5 of 0. With L1 replaced by a smooth
  loss the same noise moves ∇recon by under 2e-4, and the critic's term,
  whose loss is smooth in the outputs, by under 1e-4;
* noise inside the network (on each highway block's output) flips a few
  ReLU masks, and the flips move ∇loss_disc by more than ten times what it
  moves with the masks frozen; with the masks frozen and the smooth loss,
  both gradients move by about the outputs' own change.

So the gap is rounding amplified by L1's sign and the ReLU masks, not a
fault of the kernels' backwards (which recompute the plain gradient, held
equal to autograd's in ``tests/test_torch_port_highway.py``).
"""

from spoofsv_torch.train.grad_rounding import separate

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)


def test_l1_sign_and_relu_masks_amplify_rounding():
    r = separate(batch=16, text=60, frames=100, hidden=64)
    assert r["l1_signs_flipped"] >= 1
    assert r["out_noise_recon"] > 1e-3, r
    assert r["out_noise_smooth_recon"] < 2e-4 and r["out_noise_disc"] < 1e-4, r
    assert r["relu_masks_flipped"] >= 1 and r["block_noise_out_max_abs"] < 1e-3, r
    assert r["block_noise_disc"] > 10 * r["block_noise_frozen_disc"], r
    assert max(r["block_noise_frozen_smooth_recon"],
               r["block_noise_frozen_smooth_disc"]) < 2 * r["block_noise_out_max_abs"], r
