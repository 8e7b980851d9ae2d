"""spoofsv_torch: the PyTorch/CUDA port of :mod:`spoofsv_tpu`.

Same layout and names as the JAX package (``models/``, ``infer/``, ``train/``,
``dsp/``, ``ops/``, ``data/``, ``cli/``), so each module's counterpart is easy
to find. Public functions keep the JAX layouts: time-major ``(B, T, C)``,
attention ``(B, N, T)``, audio ``(B, hop·(T-1))``.

The port imports ``torch`` and never ``jax``, and nothing of the JAX package:
what it needs from there (the configuration dataclasses, the parameter-tree
export) it keeps as its own copies (``config.py``, ``export.py``).

Kernels (``ops/``) are hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built
with ``nvcc`` at first use. Each wrapper runs its plain PyTorch version only
for CPU tensors; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (str, ``torch.device`` or None → the card) as a ``torch.device``.

    The port's entry points run on the card unless the caller passes
    ``device="cpu"``. Raises ``RuntimeError`` when a CUDA device is asked for
    (or implied by None) and no card is present: there is no silent CPU
    fallback.
    """
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def reference_precision() -> None:
    """Disable TF32 for f32 convolutions and matmuls (cuDNN convs default to
    TF32, and SSRN is convs). Call wherever f32 is the reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


__all__ = ["resolve_device", "reference_precision"]
