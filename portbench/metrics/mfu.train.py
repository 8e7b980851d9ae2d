"""The whole training step's share of the card's peak at the
configuration's training precision (float32 outside the tensor cores,
TF32 being off), %: the counted forward, backward and Adam work of every
step of the window (``portbench/work``) over the window's wall seconds
times that peak. None on a card the table of peaks lacks."""

from portbench import work


def read(view):
    table = work.peaks(view.extra.get("device_kind", ""))
    ops, wall = view.extra.get("train_ops"), view.extra.get("wall_s")
    if table is None or not ops or not wall:
        return None
    return 100.0 * ops / (wall * table[view.extra["precision"]])
