"""The SSRN stage of a bulk call, ``Synthesizer.ssrn_apply``.

Source: the benchmark's CUDA events around the stage (``program.StageTap``),
each call of the traced window; the mean over the calls, in ms."""


def read(view):
    ms = view.extra.get("stage_ms", {}).get("ssrn")
    return sum(ms) / len(ms) if ms else None
