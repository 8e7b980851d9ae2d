"""One stage of a Tacotron 2 bulk call: the postnet and its residual,
``Tacotron2Synthesizer.postnet_apply``.

Source: the benchmark's CUDA events around the stage (``program.StageTap``),
each call of the traced window; the mean over the calls, in ms."""


def read(view):
    ms = view.extra.get("stage_ms", {}).get("postnet")
    return sum(ms) / len(ms) if ms else None
