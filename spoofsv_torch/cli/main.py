"""Start-up helpers of the CLI entry point.

Port of the helpers in :mod:`spoofsv_tpu.cli.main`: the compute dtypes, the
process-wide runtime knobs and the model builder. The command-line parser
itself is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spoofsv_torch import resolve_device
from spoofsv_torch.config import Config
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.models.layers import set_default_gate_impl


def inference_dtype(cfg: Config, device) -> torch.dtype:
    """``cfg.tpu.compute_dtype`` (bf16 by default) on a CUDA device, f32
    elsewhere (the JAX package's rule, with the card in the TPU's place)."""
    if torch.device(device).type == "cuda" and cfg.tpu.compute_dtype == "bfloat16":
        return torch.bfloat16
    return torch.float32


def training_dtype(cfg: Config, device) -> torch.dtype:
    """``cfg.tpu.train_compute_dtype`` (f32 by default) on a CUDA device, f32
    elsewhere."""
    if torch.device(device).type == "cuda" and cfg.tpu.train_compute_dtype == "bfloat16":
        return torch.bfloat16
    return torch.float32


def apply_runtime_knobs(cfg: Config, infer: bool = False) -> None:
    """Set the process-wide highway implementation: ``cfg.tpu.highway_gate_impl``
    for training, ``cfg.tpu.highway_infer_impl`` with ``infer=True``, which
    is then what :class:`spoofsv_torch.infer.synthesize.Synthesizer`'s text
    encoder and SSRN run. Unlike the JAX package, a CPU run keeps the
    selected name: CPU tensors take the kernels' plain versions anyway."""
    set_default_gate_impl(cfg.tpu.highway_infer_impl if infer else cfg.tpu.highway_gate_impl)


def build_models(cfg: Config, pattern: str = "conditional", dtype: Optional[torch.dtype] = None,
                 device=None) -> Tuple[MelSyn, SSRN]:
    """Text2Mel and SSRN with the configuration's widths (dropout 0.05 when
    ``cfg.apply_dropout``) on ``device``: the card unless the caller passes
    ``device="cpu"`` (:func:`spoofsv_torch.resolve_device`, which raises
    without a card). The discriminators are not ported yet."""
    device = resolve_device(device)
    dropout = 0.05 if cfg.apply_dropout else 0.0
    melsyn = MelSyn(cfg.vocab_len, pattern == "conditional", cfg.spk_emb_dim, cfg.text_emb_dim,
                    cfg.mel.freq_bins, cfg.hidden_dim, dropout)
    ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim, dropout)
    return melsyn.to(device, dtype or torch.float32), ssrn.to(device, dtype or torch.float32)
