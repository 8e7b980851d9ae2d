"""The whole synthesis call's share of the card's bf16 dense peak, %.

Source: the counted work of every stage (``portbench/work``) of the traced
window's calls over the window's wall seconds times the bf16 peak. None on
a card the table of peaks lacks."""

from portbench import work


def read(view):
    stages = view.extra.get("stage_work")
    table = work.peaks(view.extra.get("device_kind", ""))
    if not stages or table is None or not view.extra.get("wall_s"):
        return None
    ops = sum(counted[0] for counted, _ in stages.values())
    return 100.0 * view.extra["calls"] * ops / (view.extra["wall_s"] * table["bf16"])
