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

``export_melsyn``, ``export_ssrn``, ``export_critic`` and
``export_ge2e_embedder`` are copies of the
JAX package's (``spoofsv_tpu/utils/torch_export.py``); ``export_critic`` also
carries the countermeasure's v2 stage (``conv3_2``/``ln3_2``), which the
JAX exporter drops. ``export_drs`` is the port's own: flax ``DRS`` variables
(``params`` and ``batch_stats``) → the port's :class:`DRS` state dict, 2-D
conv kernels (kh, kw, in, out) → (out, in, kh, kw).
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


def export_lndense(params) -> Dict[str, np.ndarray]:
    """``LNDense`` parameter tree → ``dense.*`` and ``ln.*`` state_dict arrays."""
    p = _params(params)
    sd: Dict[str, np.ndarray] = {}
    _undense(sd, p["dense"], "dense")
    if "ln" in p:
        _unln(sd, p["ln"], "ln")
    return sd


def export_critic(params) -> Dict[str, np.ndarray]:
    """Critic1D parameter tree → reference ``melDisc``/``linDisc`` state_dict arrays."""
    p = _params(params)
    sd: Dict[str, np.ndarray] = {}
    for i in range(1, 6):
        _undense(sd, p[f"conv{i}"], f"conv{i}")
    for i in range(1, 5):
        _unln(sd, p[f"ln{i}"], f"ln{i}")
    _unhighway(sd, p["hc"], "hc")
    if "conv3_2" in p:       # the countermeasure's v2 stage
        _undense(sd, p["conv3_2"], "conv3_2")
        _unln(sd, p["ln3_2"], "ln3_2")
    return sd


def _unconv2d(out, p, name) -> None:
    out[f"{name}.weight"] = _np(np.transpose(_np(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _unbn(out, p, stats, name) -> None:
    out[f"{name}.weight"] = _np(p["scale"])
    out[f"{name}.bias"] = _np(p["bias"])
    out[f"{name}.running_mean"] = _np(stats["mean"])
    out[f"{name}.running_var"] = _np(stats["var"])
    out[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)


def export_drs(variables) -> Dict[str, np.ndarray]:
    """flax ``DRS`` variables (``{"params": ..., "batch_stats": ...}``) → the
    port's ``DRS`` state dict."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _unconv2d(sd, p["expansion"], "expansion")
    for name in sorted(k for k in p if k.startswith("block")):
        for bn in ("bn1", "bn2"):
            _unbn(sd, p[name][bn], stats[name][bn], f"{name}.{bn}")
        for conv in ("cnn1", "cnn2"):
            _unconv2d(sd, p[name][conv], f"{name}.{conv}")
    for i in range(1, 5):
        _unconv2d(sd, p[f"cnn{i}"], f"cnn{i}")
    _undense(sd, p["fc"], "fc", conv1d=False)
    _unbn(sd, p["bn"], stats["bn"], "bn")
    _undense(sd, p["fc_out"], "fc_out", conv1d=False)
    return sd


def export_ge2e_embedder(params) -> Dict[str, np.ndarray]:
    """flax ``SpeechEmbedder`` params → the reference ``SpeechEmbedder``
    state dict. flax's ``OptimizedLSTMCell`` keeps one dense kernel a gate
    (i, f, g, o), the bias on the recurrent side; the stacked torch matrices
    take them in the same gate order, the bias as ``bias_ih`` with
    ``bias_hh`` zero."""
    p = _params(params)
    sd: Dict[str, np.ndarray] = {}
    k = 0
    while f"lstm{k}" in p:
        g = p[f"lstm{k}"]
        gates = ("i", "f", "g", "o")
        b = np.concatenate([_np(g[f"h{x}"]["bias"]) for x in gates], axis=0)
        sd[f"LSTM_stack.weight_ih_l{k}"] = np.concatenate(
            [_np(g[f"i{x}"]["kernel"]).T for x in gates], axis=0)
        sd[f"LSTM_stack.weight_hh_l{k}"] = np.concatenate(
            [_np(g[f"h{x}"]["kernel"]).T for x in gates], axis=0)
        sd[f"LSTM_stack.bias_ih_l{k}"] = b
        sd[f"LSTM_stack.bias_hh_l{k}"] = np.zeros_like(b)
        k += 1
    _undense(sd, p["projection"], "projection", conv1d=False)
    return sd
