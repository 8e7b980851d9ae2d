"""One stage of a Tacotron 2 bulk call: the text encoder (the embedding, the convolutions with their
BatchNorms folded in, the packed BiLSTM) and the processed memory,
``Tacotron2Synthesizer.encode``.

Source: the benchmark's CUDA events around the stage (``program.StageTap``),
each call of the traced window; the mean over the calls, in ms."""


def read(view):
    ms = view.extra.get("stage_ms", {}).get("encode")
    return sum(ms) / len(ms) if ms else None
