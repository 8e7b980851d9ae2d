"""Batched synthesis pipeline: Text2Mel decode → SSRN → Griffin-Lim → wav.

Port of :mod:`spoofsv_tpu.infer.synthesize` (``make_vocoder``,
``finalize_audio``, ``Synthesizer``). Tensors on a CUDA device go through
the hand-written kernels (decode K1, GL init K2, Griffin-Lim K3); tensors on
the CPU go through their plain PyTorch versions. Data-parallel synthesis over
several devices is not part of this module.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spoofsv_torch.config import Config
from spoofsv_torch.dsp import host as dsp_host
from spoofsv_torch.dsp import torchdsp
from spoofsv_torch.models.ssrn import SSRN
from spoofsv_torch.models.text2mel import MelSyn
from spoofsv_torch.ops.decode_kernel import make_fused_decoder
from spoofsv_torch.ops.gl_kernel import griffin_lim_fused


def gl_seeds(batch: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B,) int32 phase-init seeds for the "random" (hash) GL init."""
    return torch.randint(0, np.iinfo(np.int32).max, (batch,), generator=generator,
                         dtype=torch.int32)


def make_vocoder(cfg: Config, n_iter: Optional[int] = None):
    """``vocode(lin_mag (B, T, F), seeds=None) -> audio (B, hop·(T−1))``.

    Per-utterance peak renorm (non-log mode), power ``(·)^(1.3/0.6)``,
    Griffin-Lim from ``cfg.tpu.griffin_lim_init`` (random hash init uses
    ``seeds``, (B,) int), and de-emphasis.
    """
    n_iter = n_iter or cfg.tpu.griffin_lim_iters
    n_fft, hop = cfg.stft.fft_length, cfg.stft.hop_length
    power = cfg.norm.reconstruction_power / cfg.norm.analysis_power
    init_mode = cfg.tpu.griffin_lim_init

    @torch.no_grad()
    def vocode(lin_pred: torch.Tensor, seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = lin_pred.float()
        if cfg.norm.log_feature:
            db = x * cfg.norm.max_db - cfg.norm.max_db + cfg.norm.ref_db
            x = torch.pow(10.0, 0.05 * db)
        else:
            peak = x.amax(dim=(1, 2), keepdim=True)
            x = x / peak.clamp_min(1e-8)
        spec = torch.pow(x, power)
        if init_mode == "random" and seeds is None:
            seeds = gl_seeds(spec.shape[0])
        audio = griffin_lim_fused(spec, n_fft, hop, n_fft, n_iter=n_iter,
                                  init_mode=init_mode, seeds=seeds)
        return torchdsp.deemphasis(audio, coeff=cfg.preemph)

    return vocode


def finalize_audio(audio: np.ndarray, cfg: Config, trim_db: Optional[float] = None,
                   max_seconds: Optional[float] = None) -> np.ndarray:
    """Host-side tail: optional trim, duration cap, peak scale ×0.75 (the
    reference divides by ``max``, not ``|max|`` — preserved)."""
    y = np.asarray(audio, dtype=np.float32)
    if trim_db is not None:
        y, _ = dsp_host.trim_silence(y, trim_db)
        if len(y) == 0:
            y = np.asarray(audio, dtype=np.float32)
    if max_seconds is not None and len(y) > int(max_seconds * cfg.sampling_rate):
        y = y[: int(max_seconds * cfg.sampling_rate)]
    if not cfg.norm.log_feature:
        y = y / np.max(y) * 0.75
    return y


class Synthesizer:
    """End-to-end batched TTS: (text_ids, spk_emb) → waveforms.

    The models' parameters fix the device and compute dtype; inputs are moved
    there. Stages are exposed separately (:attr:`decode`, :meth:`ssrn_apply`,
    :attr:`vocode`) so callers can time them. The text encoder and SSRN run
    the process-wide highway implementation, which
    ``spoofsv_torch.cli.main.apply_runtime_knobs(cfg, infer=True)`` sets from
    ``cfg.tpu.highway_infer_impl`` ("xla" by default).
    """

    def __init__(self, cfg: Config, melsyn: MelSyn, ssrn: SSRN,
                 n_frames: Optional[int] = None, gl_iters: Optional[int] = None):
        self.cfg = cfg
        self.melsyn = melsyn.eval()
        self.ssrn = ssrn.eval()
        self.n_frames = n_frames or cfg.max_frame_num
        self.device = next(melsyn.parameters()).device
        self.decode = make_fused_decoder(self.melsyn, self.n_frames)
        self.vocode = make_vocoder(cfg, gl_iters)

    @torch.no_grad()
    def ssrn_apply(self, mel: torch.Tensor) -> torch.Tensor:
        return self.ssrn(mel.to(next(self.ssrn.parameters()).dtype))

    @torch.no_grad()
    def __call__(self, text_ids, spk_emb, seeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (audio (B, L) f32, coarse mel (B, T, 80), attention (B, N, T))."""
        text_ids = torch.as_tensor(text_ids).to(self.device)
        spk_emb = torch.as_tensor(spk_emb, dtype=torch.float32).to(self.device)
        mel, attn, _ = self.decode(text_ids, spk_emb)
        audio = self.vocode(self.ssrn_apply(mel),
                            None if seeds is None else seeds.to(self.device))
        return audio, mel, attn
