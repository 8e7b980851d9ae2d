"""Typed configuration of the port.

The port's own copy of the JAX package's configuration dataclasses, with the
same fields, defaults and JSON handling: the reference's flat ``config.json``
schema (``config.json:1-54``) read into one frozen, typed object, plus the
``"TPU"`` extension section (``TPUConfig``), whose knobs pick the kernels
and dtypes; the GE2E configuration; and the port's own
``Tacotron2Config`` (NVIDIA ``hparams.py`` keys), which ``load_config``
picks for such a file.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple


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


@dataclasses.dataclass(frozen=True)
class Tacotron2Config:
    """Multi-speaker Tacotron 2: the keys of NVIDIA/tacotron2's ``hparams.py``
    that synthesis reads (their published values as defaults), the SV2TTS
    d-vector width (``speaker_embedding_dim``), the spoof set's paths in
    SpoofSV's names, the weights (``checkpoint``: a state dict in NVIDIA's
    schema; without one, seeded random weights from ``weights_seed``) and the
    ``"TPU"`` section. ``hparams.py``'s other keys (training, data loading,
    the training-only dropouts) are read and kept in ``training``."""

    # audio (hparams.py "Audio Parameters")
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    # model
    n_symbols: int = 148
    symbols_embedding_dim: int = 512
    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 512
    n_frames_per_step: int = 1
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    max_decoder_steps: int = 1000
    gate_threshold: float = 0.5
    attention_rnn_dim: int = 1024
    attention_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    # SV2TTS and the port
    speaker_embedding_dim: int = 256
    checkpoint: str = ""
    weights_seed: int = 0
    src_root_dir: str = "./"
    data_root_dir: str = ""
    spk_emb_dir: str = ""
    antispoof_dir: str = ""
    tts_texts: str = "./havard.txt"
    multi_gpu: bool = False
    training: Tuple[Tuple[str, Any], ...] = ()
    tpu: TPUConfig = dataclasses.field(default_factory=TPUConfig)

    # hparams.py's keys that synthesis does not read: read, kept, not used here
    TRAINING_KEYS = ("epochs", "iters_per_checkpoint", "seed", "dynamic_loss_scaling",
                     "fp16_run", "distributed_run", "dist_backend", "dist_url", "cudnn_enabled",
                     "cudnn_benchmark", "ignore_layers", "load_mel_from_disk", "training_files",
                     "validation_files", "use_saved_learning_rate", "learning_rate",
                     "weight_decay", "grad_clip_thresh", "batch_size", "mask_padding",
                     "max_wav_value", "p_attention_dropout", "p_decoder_dropout")
    # hparams.py's keys with the one value the port implements
    FIXED = {"text_cleaners": ["english_cleaners"], "n_frames_per_step": 1}

    @classmethod
    def from_hparams(cls, d: Mapping[str, Any], **overrides: Any) -> "Tacotron2Config":
        """Build from a dict of ``hparams.py`` keys plus the port's; an unknown
        key, or a value the port does not implement (a cleaner other than
        ``english_cleaners``, several frames a step, a window other than the
        FFT's), raises ``ValueError``."""
        fields = {f.name for f in dataclasses.fields(cls)} - {"training", "tpu"}
        known = fields | set(cls.TRAINING_KEYS) | {"TPU", "text_cleaners", "win_length"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown Tacotron 2 configuration keys: {sorted(unknown)}")
        fixed = dict(cls.FIXED, win_length=d.get("filter_length", cls.filter_length))
        for key, value in fixed.items():
            if d.get(key, value) != value:
                raise ValueError(f"the port's Tacotron 2 takes {key}={value!r}, got {d[key]!r}")
        kw = {k: v for k, v in d.items() if k in fields}
        kw["training"] = tuple((k, tuple(d[k]) if isinstance(d[k], list) else d[k])
                               for k in cls.TRAINING_KEYS if k in d)
        kw["tpu"] = TPUConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                 for k, v in d.get("TPU", {}).items()})
        cfg = cls(**kw)
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    # the names the shared synthesis, spoof-set and CLI code reads
    @property
    def stft(self) -> STFTConfig:
        return STFTConfig(fft_length=self.filter_length, hop_length=self.hop_length)

    @property
    def norm(self) -> NormConfig:
        """Linear magnitudes at power 1, audio peak-scaled by ``finalize_audio``."""
        return NormConfig(analysis_power=1.0, reconstruction_power=1.0, log_feature=False)

    @property
    def max_frame_num(self) -> int:
        return self.max_decoder_steps

    @property
    def spk_emb_dim(self) -> int:
        return self.speaker_embedding_dim

    @property
    def memory_dim(self) -> int:
        """The attention's memory: encoder outputs and the d-vector."""
        return self.encoder_embedding_dim + self.speaker_embedding_dim

    def replace(self, **kw: Any) -> "Tacotron2Config":
        return dataclasses.replace(self, **kw)


def config_from_dict(d: Mapping[str, Any], **overrides: Any):
    """The configuration of a JSON document: a Tacotron 2 one for a document
    of ``hparams.py`` keys (it has ``attention_location_n_filters``), else the
    SpoofSV DCTTS ``Config``."""
    if "attention_location_n_filters" in d:
        return Tacotron2Config.from_hparams(d, **overrides)
    return Config.from_reference_dict(d, **overrides)


def load_config(path: str, **overrides: Any):
    """Load a configuration file: the reference-schema ``config.json``
    (main.py:19-20), or a Tacotron 2 one (:func:`config_from_dict`)."""
    with open(path, "r") as f:
        d = json.load(f)
    return config_from_dict(d, **overrides)


# ----------------------------------------------------------------------
# GE2E subsystem config (reference: GE2E/config/config.yaml, GE2E/hparam.py)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GE2EDataConfig:
    train_path: str = "./train_tisv"
    train_path_unprocessed: str = ""
    test_path: str = "./test_tisv"
    test_path_unprocessed: str = ""
    data_preprocessed: bool = True
    sr: int = 16000
    nfft: int = 512
    window: float = 0.025
    hop: float = 0.01
    nmels: int = 40
    tisv_frame: int = 120


@dataclasses.dataclass(frozen=True)
class GE2EModelConfig:
    hidden: int = 768
    num_layer: int = 3
    proj: int = 256
    model_path: str = ""


@dataclasses.dataclass(frozen=True)
class GE2ETrainConfig:
    N: int = 6
    M: int = 50
    num_workers: int = 0
    lr: float = 0.01
    epochs: int = 950
    log_interval: int = 5
    log_file: str = ""
    checkpoint_interval: int = 120
    checkpoint_dir: str = "./speech_id_checkpoint"
    restore: bool = False


@dataclasses.dataclass(frozen=True)
class GE2ETestConfig:
    N: int = 20
    M: int = 86
    num_workers: int = 0
    epochs: int = 10


@dataclasses.dataclass(frozen=True)
class GE2EConfig:
    training: bool = False
    device: str = "tpu"
    unprocessed_data: str = ""
    save_simmat_dir: str = "./simmat"
    data: GE2EDataConfig = dataclasses.field(default_factory=GE2EDataConfig)
    model: GE2EModelConfig = dataclasses.field(default_factory=GE2EModelConfig)
    train: GE2ETrainConfig = dataclasses.field(default_factory=GE2ETrainConfig)
    test: GE2ETestConfig = dataclasses.field(default_factory=GE2ETestConfig)

    @classmethod
    def from_yaml(cls, path: str) -> "GE2EConfig":
        """Parse the reference's multi-document YAML (``GE2E/hparam.py:7-14``)
        with :func:`parse_reference_yaml`; later documents update earlier ones."""
        merged: dict = {}
        with open(path, "r") as stream:
            for doc in parse_reference_yaml(stream.read()):
                merged.update(doc)

        def sub(name: str, klass):
            known = {f.name for f in dataclasses.fields(klass)}
            return klass(**{k: v for k, v in (merged.get(name) or {}).items() if k in known})

        return cls(
            training=bool(merged.get("training", False)),
            device=str(merged.get("device", "tpu")),
            unprocessed_data=str(merged.get("unprocessed_data", "")),
            save_simmat_dir=str(merged.get("save_simmat_dir", "./simmat")),
            data=sub("data", GE2EDataConfig),
            model=sub("model", GE2EModelConfig),
            train=sub("train", GE2ETrainConfig),
            test=sub("test", GE2ETestConfig),
        )

    def replace(self, **kw: Any) -> "GE2EConfig":
        return dataclasses.replace(self, **kw)


# PyYAML's (YAML 1.1) implicit scalars, the forms the reference config uses
_YAML_BOOL = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
              **dict.fromkeys("no No NO false False FALSE off Off OFF".split(), False)}
_YAML_NULL = {"", "~", "null", "Null", "NULL"}
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                         r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_YAML_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
                       "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
                       "+.inf": float("inf"), ".nan": float("nan"), ".NaN": float("nan"),
                       ".NAN": float("nan")}
# other implicit scalars (hex, octal, binary, sexagesimal, timestamps): not read here
_YAML_UNREAD = re.compile(r"[-+]?(?:0[xXbBoO0-7]|[0-9][0-9_]*:[0-5]?[0-9])"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")


def _yaml_scalar(text: str, where: str):
    """One scalar: a quoted string, a ``!!bool``/``!!int``/``!!float``/``!!str``
    tag, or an implicit bool, null, int, float or plain string."""
    tag = None
    if text.startswith("!"):
        tag, _, text = text.partition(" ")
        text = text.strip()
        if tag not in ("!!bool", "!!int", "!!float", "!!str"):
            raise ValueError(f"{where}: unsupported YAML tag {tag!r}")
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        quoted = text[1:-1]
        if text[0] == "'":
            quoted = quoted.replace("''", "'")
        elif "\\" in quoted:
            raise ValueError(f"{where}: escapes in double-quoted YAML strings are not read")
        if tag is None or tag == "!!str":
            return quoted
        text = quoted
    elif text[:1] in "'\"[]{}&*|>%@`" and text:
        raise ValueError(f"{where}: unsupported YAML scalar {text!r}")
    if tag == "!!str":
        return text
    if tag == "!!bool" or (tag is None and text in _YAML_BOOL):
        if text not in _YAML_BOOL:
            raise ValueError(f"{where}: not a YAML bool: {text!r}")
        return _YAML_BOOL[text]
    if tag is None and text in _YAML_NULL:
        return None
    if tag in (None, "!!int") and _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if tag in (None, "!!float") and (_YAML_FLOAT.match(text) or text in _YAML_SPECIAL_FLOAT
                                     or (tag and _YAML_INT.match(text))):
        return _YAML_SPECIAL_FLOAT.get(text) or float(text.replace("_", ""))
    if tag is not None or _YAML_UNREAD.match(text):
        raise ValueError(f"{where}: YAML scalar {text!r} is not read here")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a blank,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_reference_yaml(text: str) -> List[Dict[str, Any]]:
    """The documents of a multi-document YAML in the reference GE2E config's
    schema: ``---`` separators, ``key: value`` pairs at two levels (a key
    with no value opens an indented block of scalars), comments, quoted and
    tagged scalars. Anything else (lists, flow collections, anchors,
    multi-line scalars, deeper nesting) raises ``ValueError``. What it reads,
    it reads as ``yaml.safe_load_all`` would."""
    docs: List[Dict[str, Any]] = []
    doc: Optional[Dict[str, Any]] = None
    block: Optional[Dict[str, Any]] = None
    block_indent: Optional[int] = None
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        if raw.startswith("---"):
            if _strip_comment(raw) != "---":
                raise ValueError(f"{where}: content after '---' is not read")
            if doc is not None:
                docs.append(doc)
            doc, block, block_indent = {}, None, None
            continue
        if raw.startswith("...") and not raw[3:].strip():
            continue
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: tabs in YAML indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith(("- ", "-\t")) or body == "-" or body.startswith("%"):
            raise ValueError(f"{where}: only mappings of scalars are read, got {body!r}")
        key, sep, value = body.partition(":")
        if not sep or (value and value[0] not in " \t"):
            raise ValueError(f"{where}: expected 'key: value', got {body!r}")
        key, value = key.strip(), value.strip()
        if not key or key[0] in "'\"?&*!{[":
            raise ValueError(f"{where}: unsupported YAML key {key!r}")
        if doc is None:
            doc = {}
        if indent == 0:
            block, block_indent = None, None
            if key in doc:
                raise ValueError(f"{where}: duplicate key {key!r}")
            if value:
                doc[key] = _yaml_scalar(value, where)
            else:
                block = doc[key] = {}
        else:
            if block is None:
                raise ValueError(f"{where}: indented line outside a block")
            if block_indent is None:
                block_indent = indent
            if indent != block_indent:
                raise ValueError(f"{where}: only two levels of nesting are read")
            if not value:
                raise ValueError(f"{where}: only two levels of nesting are read")
            if key in block:
                raise ValueError(f"{where}: duplicate key {key!r}")
            block[key] = _yaml_scalar(value, where)
    if doc is not None:
        docs.append(doc)
    # an opened block that received nothing is null, as in YAML
    return [{k: (None if v == {} else v) for k, v in d.items()} for d in docs if d]


__all__ = ["AdamConfig", "Config", "GE2EConfig", "GE2EDataConfig", "GE2EModelConfig",
           "GE2ETestConfig", "GE2ETrainConfig", "MelConfig", "NormConfig", "STFTConfig",
           "TPUConfig", "Tacotron2Config", "config_from_dict", "load_config",
           "parse_reference_yaml"]
