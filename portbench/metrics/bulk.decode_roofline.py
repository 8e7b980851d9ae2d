"""The decode stage's kernels (the text encoder's and K1) against their roofline, %.

Source: the device time of the operations launched inside the stage's span
(``torch.profiler``) over the calls of the traced part of the window, against the least time
the card could take for the stage's counted work (``portbench/work``) at
the configuration's precision. None on a card the table of peaks lacks."""

from portbench import work


def read(view):
    stage = view.extra.get("stage_work", {}).get("decode")
    device_s = view.span_device_s.get("decode")
    table = work.peaks(view.extra.get("device_kind", ""))
    if not stage or not device_s or table is None:
        return None
    counted, precision = stage
    return 100.0 * view.extra["calls_traced"] * work.bound_s(counted, precision, table) / device_s
