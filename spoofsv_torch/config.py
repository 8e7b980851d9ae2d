"""Typed configuration of the port.

The port's own copy of the JAX package's configuration dataclasses, with the
same fields, defaults and JSON handling: the reference's flat ``config.json``
schema (``config.json:1-54``) read into one frozen, typed object, plus the
``"TPU"`` extension section (``TPUConfig``), whose knobs pick the kernels
and dtypes. The GE2E configs are not here yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    fft_length: int = 1024
    hop_length: int = 256

    @property
    def lin_bins(self) -> int:
        return 1 + self.fft_length // 2


@dataclasses.dataclass(frozen=True)
class MelConfig:
    reduction: int = 4      # time reduction of the coarse mel (config.json:23)
    freq_bins: int = 80


@dataclasses.dataclass(frozen=True)
class NormConfig:
    analysis_power: float = 0.6        # config.json:27
    reconstruction_power: float = 1.3  # config.json:28
    log_feature: bool = False
    max_db: float = 100.0
    ref_db: float = 20.0


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    alpha: float = 2e-4
    beta_1: float = 0.5
    beta_2: float = 0.9
    epsilon: float = 1e-6


@dataclasses.dataclass(frozen=True)
class TPUConfig:
    """Knobs with no reference counterpart (the ``"TPU"`` section of the JSON)."""
    compute_dtype: str = "bfloat16"    # inference compute dtype
    param_dtype: str = "float32"
    train_compute_dtype: str = "float32"
    mesh_data_axis: str = "data"
    bucket_frames: Tuple[int, ...] = (80, 120, 160, 200, 240, 325)
    bucket_text: Tuple[int, ...] = (60, 100, 140, 186)
    decode_frames: int = 325           # fixed AR rollout length (MAX_FRAME_NUM)
    # Griffin-Lim: 12 iterations from the SPSI init (the reference runs 64
    # from random phases: {"TPU": {"griffin_lim_iters": 64,
    # "griffin_lim_init": "random"}})
    griffin_lim_iters: int = 12
    griffin_lim_precision: str = "default"
    griffin_lim_impl: str = "auto"
    griffin_lim_int8: bool = True
    griffin_lim_init: str = "spsi"     # "random", "advance" or "spsi"
    decode_impl: str = "auto"
    # highway implementation for training ("xla", "pallas", "fused_conv",
    # "fused_pair") and for the inference subcommands
    highway_gate_impl: str = "xla"
    highway_infer_impl: str = "xla"
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level config mirroring reference ``config.json`` (config.json:1-54)."""

    # Paths
    data_root_dir: str = ""
    spk_emb_dir: str = ""
    src_root_dir: str = "./"
    antispoof_dir: str = ""

    # Model dims
    spk_emb_dim: int = 200
    hidden_dim: int = 256
    text_emb_dim: int = 128
    ssrn_dim: int = 256
    disc_dim: int = 128

    # Text frontend
    vocabulary: str = "PE abcdefghijklmnopqrstuvwxyz-,.?'\""
    max_text_len: int = 186
    max_frame_num: int = 325

    # DSP
    sampling_rate: int = 22050
    preemph: float = 0.97
    stft: STFTConfig = dataclasses.field(default_factory=STFTConfig)
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)
    norm: NormConfig = dataclasses.field(default_factory=NormConfig)

    # Train
    multi_gpu: bool = False
    plot_curve: bool = True
    apply_dropout: bool = False
    batch_size: int = 16
    max_epochs: int = 500
    val_every_iter: int = 1000
    adam: AdamConfig = dataclasses.field(default_factory=AdamConfig)

    # GAN
    ratio: int = 5                     # D:G step ratio (config.json:48)
    gp_lambda: float = 10.0            # gradient-penalty weight (config.json:49)

    # Inference assets
    inference_text2mel_model: str = ""
    inference_ssrn_model: str = ""
    tts_texts: str = "./havard.txt"

    # extension knobs
    tpu: TPUConfig = dataclasses.field(default_factory=TPUConfig)

    @property
    def vocab_len(self) -> int:
        """Model vocab size: the reference merges '"' onto "'" and builds the
        model with ``len(VOCABULARY)-1`` classes."""
        return len(self.vocabulary) - 1

    @property
    def lin_bins(self) -> int:
        return self.stft.lin_bins

    @classmethod
    def from_reference_dict(cls, d: Mapping[str, Any], **overrides: Any) -> "Config":
        """Build from a dict using the reference ``config.json`` key schema."""
        def g(key: str, default: Any) -> Any:
            return d.get(key, default)

        cfg = cls(
            data_root_dir=g("DATA_ROOT_DIR", ""),
            spk_emb_dir=g("SPK_EMB_DIR", ""),
            src_root_dir=g("SRC_ROOT_DIR", "./"),
            antispoof_dir=g("ANTISPOOF_DIR", ""),
            spk_emb_dim=g("SPK_EMB_DIM", 200),
            hidden_dim=g("HIDDEN_DIM", 256),
            text_emb_dim=g("TEXT_EMB_DIM", 128),
            ssrn_dim=g("SSRN_DIM", 256),
            disc_dim=g("DISC_DIM", 128),
            vocabulary=g("VOCABULARY", cls.vocabulary),
            max_text_len=g("MAX_TEXT_LEN", 186),
            max_frame_num=g("MAX_FRAME_NUM", 325),
            sampling_rate=g("SAMPLING_RATE", 22050),
            preemph=g("PREEMPH", 0.97),
            stft=STFTConfig(
                fft_length=d.get("STFT", {}).get("FFT_LENGTH", 1024),
                hop_length=d.get("STFT", {}).get("HOP_LENGTH", 256),
            ),
            mel=MelConfig(
                reduction=d.get("COARSE_MELSPEC", {}).get("REDUCTION", 4),
                freq_bins=d.get("COARSE_MELSPEC", {}).get("FREQ_BINS", 80),
            ),
            norm=NormConfig(
                analysis_power=d.get("NORM_POWER", {}).get("ANALYSIS", 0.6),
                reconstruction_power=d.get("NORM_POWER", {}).get("RECONSTRUCTION", 1.3),
                log_feature=g("LOG_FEATURE", False),
                max_db=g("MAX_DB", 100.0),
                ref_db=g("REF_DB", 20.0),
            ),
            multi_gpu=g("MULTI_GPU", False),
            plot_curve=g("PLOT_CURVE", True),
            apply_dropout=g("APPLY_DROPOUT", False),
            batch_size=g("BATCH_SIZE", 16),
            max_epochs=g("MAX_EPOCHS", 500),
            val_every_iter=g("VAL_EVERY_ITER", 1000),
            adam=AdamConfig(
                alpha=d.get("ADAM", {}).get("ALPHA", 2e-4),
                beta_1=d.get("ADAM", {}).get("BETA_1", 0.5),
                beta_2=d.get("ADAM", {}).get("BETA_2", 0.9),
                epsilon=d.get("ADAM", {}).get("EPSILON", 1e-6),
            ),
            ratio=g("RATIO", 5),
            gp_lambda=g("LAMBDA", 10.0),
            inference_text2mel_model=g("INFERENCE_TEXT2MEL_MODEL", ""),
            inference_ssrn_model=g("INFERENCE_SSRN_MODEL", ""),
            tts_texts=g("TTS_TEXTS", "./havard.txt"),
            # the "TPU" extension section: any TPUConfig field by name
            tpu=TPUConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                             for k, v in d.get("TPU", {}).items()}),
        )
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return cfg

    def to_reference_dict(self) -> dict:
        """Export back to the reference ``config.json`` schema."""
        return {
            "DATA_ROOT_DIR": self.data_root_dir,
            "SPK_EMB_DIR": self.spk_emb_dir,
            "SRC_ROOT_DIR": self.src_root_dir,
            "ANTISPOOF_DIR": self.antispoof_dir,
            "SPK_EMB_DIM": self.spk_emb_dim,
            "HIDDEN_DIM": self.hidden_dim,
            "TEXT_EMB_DIM": self.text_emb_dim,
            "SSRN_DIM": self.ssrn_dim,
            "DISC_DIM": self.disc_dim,
            "VOCABULARY": self.vocabulary,
            "MAX_TEXT_LEN": self.max_text_len,
            "MAX_FRAME_NUM": self.max_frame_num,
            "SAMPLING_RATE": self.sampling_rate,
            "PREEMPH": self.preemph,
            "STFT": {"FFT_LENGTH": self.stft.fft_length, "HOP_LENGTH": self.stft.hop_length},
            "COARSE_MELSPEC": {"REDUCTION": self.mel.reduction, "FREQ_BINS": self.mel.freq_bins},
            "NORM_POWER": {"ANALYSIS": self.norm.analysis_power,
                           "RECONSTRUCTION": self.norm.reconstruction_power},
            "LOG_FEATURE": self.norm.log_feature,
            "MAX_DB": self.norm.max_db,
            "REF_DB": self.norm.ref_db,
            "MULTI_GPU": self.multi_gpu,
            "PLOT_CURVE": self.plot_curve,
            "APPLY_DROPOUT": self.apply_dropout,
            "BATCH_SIZE": self.batch_size,
            "MAX_EPOCHS": self.max_epochs,
            "VAL_EVERY_ITER": self.val_every_iter,
            "ADAM": {"ALPHA": self.adam.alpha, "BETA_1": self.adam.beta_1,
                     "BETA_2": self.adam.beta_2, "EPSILON": self.adam.epsilon},
            "RATIO": self.ratio,
            "LAMBDA": self.gp_lambda,
            "INFERENCE_TEXT2MEL_MODEL": self.inference_text2mel_model,
            "INFERENCE_SSRN_MODEL": self.inference_ssrn_model,
            "TTS_TEXTS": self.tts_texts,
            # the extension section, only where it deviates from the defaults
            # (an untouched config exports the reference schema exactly)
            **({"TPU": {
                f.name: getattr(self.tpu, f.name)
                for f in dataclasses.fields(TPUConfig)
                if getattr(self.tpu, f.name) != getattr(TPUConfig(), f.name)
            }} if self.tpu != TPUConfig() else {}),
        }

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def load_config(path: str, **overrides: Any) -> Config:
    """Load a reference-schema ``config.json`` file (main.py:19-20)."""
    with open(path, "r") as f:
        d = json.load(f)
    return Config.from_reference_dict(d, **overrides)


__all__ = ["AdamConfig", "Config", "MelConfig", "NormConfig", "STFTConfig", "TPUConfig",
           "load_config"]
