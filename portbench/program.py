"""The system under test, built as its entry points build it, from the
seed's weights; and each synthesis stage wrapped from outside for the
benchmark's spans, CUDA-event stage times and the stage outputs the
comparison reads."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from portbench import inputs
from portbench.reference import dctts


def port_config(conf: dict):
    """The port's ``Config`` of a configuration file."""
    from spoofsv_torch.config import Config

    return Config.from_reference_dict(conf["config"])


def vocoder_params(conf: dict) -> dict:
    c = conf["config"]
    return {"n_fft": c["STFT"]["FFT_LENGTH"], "hop": c["STFT"]["HOP_LENGTH"],
            "power": c["NORM_POWER"]["RECONSTRUCTION"] / c["NORM_POWER"]["ANALYSIS"],
            "init": c["TPU"]["griffin_lim_init"], "iters": c["TPU"]["griffin_lim_iters"],
            "preemph": c["PREEMPH"], "sr": c["SAMPLING_RATE"]}


def load_kernels(device) -> None:
    """The port's CUDA kernels, built into (or loaded from) the checkout's
    build directory."""
    if device.type == "cuda":
        from spoofsv_torch.ops import _build

        _build.build_all()


def build_generators(conf: dict, seed: int, device, dtype, train: bool = False):
    """Text2Mel and SSRN of the configuration's widths on ``device`` in
    ``dtype``, loaded (``strict=True``) from the seed's weights; returns the
    modules and the weights in the checkpoint's schema."""
    import torch
    from spoofsv_torch.models import SSRN, MelSyn

    cfg = port_config(conf)
    dims = dctts.dims_of(conf)
    sd_t2m = inputs.seeded_state(dctts.melsyn_schema(dims), seed, "text2mel", device, dtype)
    with torch.device(device):
        melsyn = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                        cfg.mel.freq_bins, cfg.hidden_dim)
    melsyn.to(dtype).load_state_dict(sd_t2m, strict=True)
    if train:
        return melsyn, sd_t2m
    sd_ssrn = inputs.seeded_state(dctts.ssrn_schema(dims), seed, "ssrn", device, dtype)
    with torch.device(device):
        ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim)
    ssrn.to(dtype).load_state_dict(sd_ssrn, strict=True)
    return melsyn, ssrn, sd_t2m, sd_ssrn


def build_synthesizer(conf: dict, seed: int, device):
    """The synthesis pipeline as the port's entry points build it: the
    highway implementation and TF32 setting of ``cli/main.py``, the
    inference dtype, ``Synthesizer`` at the configuration's rollout and
    Griffin-Lim iterations. Returns (cfg, synthesizer, text2mel weights,
    SSRN weights)."""
    from spoofsv_torch import reference_precision
    from spoofsv_torch.cli.main import apply_runtime_knobs, inference_dtype
    from spoofsv_torch.infer.synthesize import Synthesizer

    cfg = port_config(conf)
    apply_runtime_knobs(cfg, infer=True)
    if device.type == "cuda":
        reference_precision()
    load_kernels(device)
    melsyn, ssrn, sd_t2m, sd_ssrn = build_generators(conf, seed, device,
                                                     inference_dtype(cfg, device))
    syn = Synthesizer(cfg, melsyn, ssrn, n_frames=cfg.max_frame_num,
                      gl_iters=cfg.tpu.griffin_lim_iters)
    return cfg, syn, sd_t2m, sd_ssrn


class StageTap:
    """Wraps a ``Synthesizer``'s stages (``decode``, ``ssrn_apply``,
    ``vocode``) on the instance: each call runs in a span of the benchmark,
    with CUDA events around it when ``timed``; the latest outputs of each
    stage are kept for the comparison; ``hooks`` (tests only) may replace a
    stage's output, to break the timed path on purpose."""

    STAGES = (("decode", "decode"), ("ssrn_apply", "ssrn"), ("vocode", "vocode"))

    def __init__(self, syn, tracer, timed: bool, hooks: Optional[Dict[str, Callable]] = None):
        self.last: Dict[str, object] = {}
        self.events: Dict[str, List[tuple]] = {name: [] for _, name in self.STAGES}
        self.timed = timed
        for attr, name in self.STAGES:
            setattr(syn, attr, self._wrap(getattr(syn, attr), name, tracer, (hooks or {}).get(name)))

    def _wrap(self, fn, name, tracer, hook):
        import torch

        def stage(*args, **kw):
            with tracer.span(name):
                if self.timed:
                    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                out = fn(*args, **kw)
                if hook is not None:
                    out = hook(out)
                if self.timed:
                    ev[1].record()
                    self.events[name].append(ev)
            self.last[name] = out
            return out

        return stage

    def stage_ms(self) -> Dict[str, List[float]]:
        """Each stage's CUDA-event milliseconds, call by call (after a synchronize)."""
        return {name: [a.elapsed_time(b) for a, b in evs] for name, evs in self.events.items()}
