"""JAX parameter trees → reference ``state_dict`` arrays (numpy).

The port's own copy of the JAX package's ``export_melsyn`` / ``export_ssrn``.
A parameter tree is nested mappings of arrays (a flax ``params`` dict, with
or without its top-level ``"params"`` key); the result uses the reference
repo's parameter names and layouts:

  * Dense kernel (in, out)        → ``Conv1d(k=1)`` weight (out, in, 1), or a
    ``Linear`` weight (out, in) where the reference layer is a Linear
  * Conv kernel (k, in, out)      → ``Conv1d`` weight (out, in, k)
  * ConvTranspose kernel (k, in, out), stored k-flipped → ``ConvTranspose1d``
    weight (in, out, k)
  * LayerNorm scale/bias          → weight/bias
  * Embed.embedding (vocab, emb) + bias → text ``Linear(vocab→emb)``
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x))


def _undense(out: Dict[str, np.ndarray], p: Mapping, name: str,
             conv1d: bool = True) -> None:
    w = _np(p["kernel"]).T                     # (out, in)
    out[f"{name}.weight"] = w[..., None] if conv1d else w
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _unconv(out, p, name) -> None:
    out[f"{name}.weight"] = _np(np.transpose(_np(p["kernel"]), (2, 1, 0)))
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _undeconv(out, p, name) -> None:
    k = _np(p["kernel"])[::-1]                 # un-flip the spatial axis
    out[f"{name}.weight"] = _np(np.transpose(k, (1, 2, 0)))
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _unln(out, p, name) -> None:
    out[f"{name}.weight"] = _np(p["scale"])
    out[f"{name}.bias"] = _np(p["bias"])


def _unhighway(out, p, name) -> None:
    _unconv(out, p["conv"], f"{name}.conv")
    _unln(out, p["ln1"], f"{name}.ln1")
    _unln(out, p["ln2"], f"{name}.ln2")


def _unhci(out, p, name) -> None:
    for i in range(1, 5):
        _unhighway(out, p[f"hc{i}"], f"{name}.hc{i}")


def _params(tree) -> Mapping:
    return tree["params"] if "params" in tree else tree


def export_melsyn(params) -> Dict[str, np.ndarray]:
    """MelSyn parameter tree → reference ``melSyn`` state_dict arrays."""
    p = _params(params)
    sd: Dict[str, np.ndarray] = {}
    te, pe = p["text_encoder"], "text_encoder"
    sd[f"{pe}.textemb_layer.W.weight"] = _np(te["embed"]["embedding"]).T.copy()
    sd[f"{pe}.textemb_layer.W.bias"] = _np(te["embed_bias"])
    for i in (1, 2):
        _undense(sd, te[f"conv{i}"], f"{pe}.conv{i}")
        _unln(sd, te[f"ln{i}"], f"{pe}.ln{i}")
        _unhci(sd, te[f"hci{i}"], f"{pe}.hci{i}")
    for i in (1, 2, 3, 4):
        _unhighway(sd, te[f"hc{i}"], f"{pe}.hc{i}")

    ae, pa = p["audio_encoder"], "audio_encoder"
    for i in (1, 2, 3):
        _undense(sd, ae[f"conv{i}"], f"{pa}.conv{i}")
        _unln(sd, ae[f"ln{i}"], f"{pa}.ln{i}")
    for i in (1, 2):
        _unhci(sd, ae[f"hci{i}"], f"{pa}.hci{i}")
        _unhighway(sd, ae[f"hc{i}"], f"{pa}.hc{i}")
    if "fc1" in ae:   # speaker conditioning: Linear
        _undense(sd, ae["fc1"], f"{pa}.fc1", conv1d=False)
        _undense(sd, ae["fc2"], f"{pa}.fc2", conv1d=False)

    ad, pd = p["audio_decoder"], "audio_decoder"
    for i in (1, 2, 3, 4, 5):
        _undense(sd, ad[f"conv{i}"], f"{pd}.conv{i}")
        _unln(sd, ad[f"ln{i}"], f"{pd}.ln{i}")
    _unhci(sd, ad["hci"], f"{pd}.hci")
    for i in (1, 2):
        _unhighway(sd, ad[f"hc{i}"], f"{pd}.hc{i}")
    return sd


def export_ssrn(params) -> Dict[str, np.ndarray]:
    """SSRN parameter tree → reference ``SSRN`` state_dict arrays."""
    p = _params(params)
    sd: Dict[str, np.ndarray] = {}
    for i in range(1, 7):
        _undense(sd, p[f"conv{i}_dense"], f"conv{i}")
        _unln(sd, p[f"conv{i}_ln"], f"ln{i}")
    for i in range(1, 5):
        _unhighway(sd, p[f"hc{i}"], f"hc{i}")
    for u in (1, 2):
        _undeconv(sd, p[f"ups{u}"]["deconv"], f"ups{u}.deconv")
        _unhighway(sd, p[f"ups{u}"]["hc1"], f"ups{u}.hc1")
        _unhighway(sd, p[f"ups{u}"]["hc2"], f"ups{u}.hc2")
    return sd
