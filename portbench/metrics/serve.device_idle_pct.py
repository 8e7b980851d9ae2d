"""The share of the traced window in which no operation ran on the device, %.

Source: the union of the kernels, copies and sets in the profiler's trace
over the window (the traced run)."""


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
