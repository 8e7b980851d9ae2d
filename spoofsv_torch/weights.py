"""Weight bridge: JAX params or reference checkpoints → the port's modules.

JAX parameter trees go through :mod:`spoofsv_torch.export` (numpy) →
``load_state_dict(strict=True)``; a reference ``*.tar.pth`` goes through the
same loader, so both sources must match the reference schema exactly.
:func:`load_generator_params` is the entry points' loader of a configured
checkpoint path.
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch
from torch import nn

from spoofsv_torch.export import export_critic, export_melsyn, export_ssrn

StateLike = Mapping[str, Union[np.ndarray, torch.Tensor]]


def load_state(module: nn.Module, state: StateLike) -> nn.Module:
    """Load a reference-schema state dict (numpy or torch values) strictly,
    casting each value to the parameter's dtype and device."""
    own = module.state_dict()
    sd = {}
    for k, v in state.items():
        t = torch.as_tensor(np.array(v, np.float32) if isinstance(v, np.ndarray) else v)
        sd[k] = t.to(own[k].device, own[k].dtype) if k in own else t
    module.load_state_dict(sd, strict=True)
    return module


def load_melsyn_from_jax(module: nn.Module, params) -> nn.Module:
    """flax ``MelSyn`` params → the port's :class:`MelSyn`."""
    return load_state(module, export_melsyn(params))


def load_ssrn_from_jax(module: nn.Module, params) -> nn.Module:
    """flax ``SSRN`` params → the port's :class:`SSRN`."""
    return load_state(module, export_ssrn(params))


def load_critic_from_jax(module: nn.Module, params) -> nn.Module:
    """flax ``Critic1D`` params → the port's :class:`Critic1D` (``MelDisc``/``LinDisc``)."""
    return load_state(module, export_critic(params))


def load_reference_checkpoint(module: nn.Module, path: str,
                              key: str = "model_state_dict") -> nn.Module:
    """Load a reference ``*.tar.pth`` (the dict ``torch.save`` wrote, with the
    state dict under ``key``: ``"model_state_dict"`` for a generator,
    ``"disc_state_dict"`` for an adversarial checkpoint's critic)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return load_state(module, ckpt[key])


#: the suffixes of the reference's ``torch.save`` checkpoints (``config.json``
#: ``INFERENCE_TEXT2MEL_MODEL`` / ``INFERENCE_SSRN_MODEL``)
CHECKPOINT_SUFFIXES = (".tar.pth", ".pth", ".pt", ".tar")


def load_generator_params(path: str, module: nn.Module) -> nn.Module:
    """Load a generator's weights into ``module`` (a ``MelSyn`` or an
    ``SSRN``, whose strict load names what the checkpoint must hold) from a
    reference-schema checkpoint (``*.tar.pth``, ``.pth``, ``.pt`` or
    ``.tar``, as the port's ``CheckpointManager`` writes and the reference
    saves). Any other path raises ``ValueError``: an orbax checkpoint of the
    JAX package reaches the port through that package's ``cli/export.py``,
    which writes a ``.tar.pth``."""
    if not str(path).endswith(CHECKPOINT_SUFFIXES):
        raise ValueError(
            f"{path!r} is not a reference checkpoint ({', '.join(CHECKPOINT_SUFFIXES)}); "
            "convert an orbax checkpoint with the JAX package's cli/export.py first")
    return load_reference_checkpoint(module, path)
