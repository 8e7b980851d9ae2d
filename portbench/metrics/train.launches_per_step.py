"""Kernel launches a training step: the kernels in the profiler's trace of
the traced part of the window over the steps completed in it."""


def read(view):
    steps = view.extra.get("steps_traced")
    return view.launches / steps if steps and view.launches else None
