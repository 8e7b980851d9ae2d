"""The Tacotron 2 rollout (its gate products and both step kernels) against
its roofline, %.

Source: the device time of the operations launched inside the stage's span
(``torch.profiler``; the CUDA graph's kernels carry its launch's span) over
the calls of the traced part of the window, against the least time the card
could take for the stage's counted work (``portbench/work/tacotron2.py``)
at the bf16 peak and the memory bandwidth. None on a card the table of
peaks lacks."""

from portbench import work


def read(view):
    stage = view.extra.get("stage_work", {}).get("rollout")
    device_s = view.span_device_s.get("rollout")
    table = work.peaks(view.extra.get("device_kind", ""))
    if not stage or not device_s or table is None:
        return None
    counted, precision = stage
    return 100.0 * view.extra["calls_traced"] * work.bound_s(counted, precision, table) / device_s
