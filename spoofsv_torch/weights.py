"""Weight bridge: JAX params or reference checkpoints → the port's modules.

JAX parameter trees go through :mod:`spoofsv_torch.export` (numpy) →
``load_state_dict(strict=True)``; a reference ``*.tar.pth`` goes through the
same loader, so both sources must match the reference schema exactly.
:func:`load_generator_params` is the entry points' loader of a configured
checkpoint path; :func:`load_ge2e_params` and :func:`save_ge2e_checkpoint`
read and write the GE2E embedder's (``.npz`` in the JAX harness's layout, or
a reference ``.model``/``.pth`` state dict); :func:`load_critic_params` and
:func:`save_critic_params` the anti-spoofing countermeasure's (the JAX CLI's
flat ``.npz`` keyed by flax paths, ``spoofsv_tpu/cli/antispoof.py:102-122``);
:func:`load_drs_from_jax` carries flax ``DRS`` variables over.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from spoofsv_torch.export import (export_critic, export_drs, export_ge2e_embedder,
                                  export_melsyn, export_ssrn)

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


def load_drs_from_jax(module: nn.Module, variables) -> nn.Module:
    """flax ``DRS`` variables (``params`` and ``batch_stats``) → the port's :class:`DRS`."""
    return load_state(module, export_drs(variables))


def critic_flax_arrays(module: nn.Module) -> Dict[str, np.ndarray]:
    """A :class:`Critic1D` as the flat ``"params/<layer>/<leaf>"`` arrays of
    the flax critic (the inverse of ``export_critic``): Dense kernels (in,
    out), the highway conv's kernel (k, in, out), LayerNorm scale/bias."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()}
    out: Dict[str, np.ndarray] = {}
    for name in sorted({k.split(".")[0] for k in sd}):
        if name == "hc":
            out["params/hc/conv/kernel"] = np.ascontiguousarray(
                np.transpose(sd["hc.conv.weight"], (2, 1, 0)))
            out["params/hc/conv/bias"] = sd["hc.conv.bias"]
            for ln in ("ln1", "ln2"):
                out[f"params/hc/{ln}/scale"] = sd[f"hc.{ln}.weight"]
                out[f"params/hc/{ln}/bias"] = sd[f"hc.{ln}.bias"]
        elif name.startswith("conv"):
            out[f"params/{name}/kernel"] = np.ascontiguousarray(sd[f"{name}.weight"][..., 0].T)
            out[f"params/{name}/bias"] = sd[f"{name}.bias"]
        else:
            out[f"params/{name}/scale"] = sd[f"{name}.weight"]
            out[f"params/{name}/bias"] = sd[f"{name}.bias"]
    return out


def save_critic_params(path: str, module: nn.Module) -> None:
    """Write a countermeasure checkpoint as the JAX CLI's ``_save`` does."""
    np.savez(path, **critic_flax_arrays(module))


def load_critic_params(path: str, module: nn.Module) -> nn.Module:
    """Load a countermeasure ``.npz`` (the JAX CLI's or :func:`save_critic_params`'s)
    into ``module`` strictly."""
    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    return load_state(module, export_critic(tree))


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


GE2E_TORCH_SUFFIXES = (".model", ".pth", ".pt")


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def load_ge2e_params(path: str, embedder: nn.Module, loss: Optional[nn.Module] = None
                     ) -> nn.Module:
    """Load a GE2E checkpoint into ``embedder`` (strictly) and, when given and
    present, ``(w, b)`` into ``loss``: a reference state dict
    (``.model``/``.pth``/``.pt``, bare or under ``"model_state_dict"``) or
    an ``.npz`` of the JAX harness's layout (``"<group>/params/..."`` keys,
    ``spoofsv_tpu/spoofkit/ge2e_harness.py:406-441``), as
    :func:`save_ge2e_checkpoint` also writes it."""
    if path.endswith(GE2E_TORCH_SUFFIXES):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
        return load_state(embedder, sd)
    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    if loss is not None and "loss" in tree:
        p = tree["loss"]["params"]
        load_state(loss, {"w": np.asarray(p["w"]), "b": np.asarray(p["b"])})
    return load_state(embedder, export_ge2e_embedder(tree.get("embedder", tree)))


def ge2e_flax_arrays(embedder: nn.Module, loss: Optional[nn.Module] = None
                     ) -> Dict[str, np.ndarray]:
    """The embedder (and ``(w, b)``) as the JAX harness's flat ``.npz``
    arrays: per layer and gate, flax's input kernel ``i<g>`` (in, H) and
    recurrent kernel ``h<g>`` (H, H) with the summed bias."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in embedder.state_dict().items()}
    out: Dict[str, np.ndarray] = {}
    k = 0
    while f"LSTM_stack.weight_ih_l{k}" in sd:
        wih, whh = sd[f"LSTM_stack.weight_ih_l{k}"], sd[f"LSTM_stack.weight_hh_l{k}"]
        b = sd[f"LSTM_stack.bias_ih_l{k}"] + sd[f"LSTM_stack.bias_hh_l{k}"]
        h = whh.shape[1]
        base = f"embedder/params/lstm{k}"
        for gi, g in enumerate("ifgo"):
            out[f"{base}/i{g}/kernel"] = np.ascontiguousarray(wih[gi * h:(gi + 1) * h].T)
            out[f"{base}/h{g}/kernel"] = np.ascontiguousarray(whh[gi * h:(gi + 1) * h].T)
            out[f"{base}/h{g}/bias"] = b[gi * h:(gi + 1) * h]
        k += 1
    out["embedder/params/projection/kernel"] = np.ascontiguousarray(sd["projection.weight"].T)
    out["embedder/params/projection/bias"] = sd["projection.bias"]
    if loss is not None:
        out["loss/params/w"] = loss.w.detach().float().cpu().numpy()
        out["loss/params/b"] = loss.b.detach().float().cpu().numpy()
    return out


def save_ge2e_checkpoint(path: str, embedder: nn.Module, loss: Optional[nn.Module] = None
                         ) -> None:
    """Write ``.npz`` in the JAX harness's layout (which its
    ``load_ge2e_params`` reads), or a reference state dict for a
    ``.model``/``.pth``/``.pt`` path."""
    if path.endswith(GE2E_TORCH_SUFFIXES):
        torch.save({k: v.detach().cpu() for k, v in embedder.state_dict().items()}, path)
    else:
        np.savez(path, **ge2e_flax_arrays(embedder, loss))
