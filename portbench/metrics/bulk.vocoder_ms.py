"""The vocoder stage of a bulk call (renorm, power, the phase init K2,
Griffin-Lim K3 or ``gl.cu``, de-emphasis), ``Synthesizer.vocode``.

Source: the benchmark's CUDA events around the stage (``program.StageTap``),
each call of the traced window; the mean over the calls, in ms."""


def read(view):
    ms = view.extra.get("stage_ms", {}).get("vocode")
    return sum(ms) / len(ms) if ms else None
