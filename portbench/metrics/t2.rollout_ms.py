"""One stage of a Tacotron 2 bulk call: the decoder's rollout over the call's frames (one CUDA
graph of the cuBLAS gate products and the two step kernels),
``Tacotron2Synthesizer.rollout``.

Source: the benchmark's CUDA events around the stage (``program.StageTap``),
each call of the traced window; the mean over the calls, in ms."""


def read(view):
    ms = view.extra.get("stage_ms", {}).get("rollout")
    return sum(ms) / len(ms) if ms else None
