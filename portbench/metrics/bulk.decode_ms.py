"""The decode stage of a bulk call: the text encoder and the autoregressive
rollout (K1), ``Synthesizer.decode``.

Source: the benchmark's CUDA events around the stage (``program.StageTap``),
each call of the traced window; the mean over the calls, in ms."""


def read(view):
    ms = view.extra.get("stage_ms", {}).get("decode")
    return sum(ms) / len(ms) if ms else None
