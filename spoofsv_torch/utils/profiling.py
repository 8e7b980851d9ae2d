"""Profiling hooks: a ``torch.profiler`` trace around a block, and a step timer.

Port of :mod:`spoofsv_tpu.utils.profiling` (which wraps ``jax.profiler``):
they replace the reference's wall-clock prints (``train/ordinary.py:218,
289-291``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Capture a ``torch.profiler`` trace of the enclosed block (host, and
    the card when CUDA is available) into ``log_dir`` as a Chrome/TensorBoard
    trace file; yields the profiler (``key_averages()`` reads it after the
    block). No-op, yielding None, when ``log_dir`` is falsy."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                                    log_dir)) as prof:
        yield prof


class StepTimer:
    """EMA step timer with compile-step exclusion: the first ``skip_first``
    steps (the kernels' build and first launch) set :attr:`last` but not
    :attr:`ema`. Time on the host clock; synchronize the card inside the
    block for device work."""

    def __init__(self, alpha: float = 0.1, skip_first: int = 1):
        self.alpha = alpha
        self.skip = skip_first
        self.ema: Optional[float] = None
        self.last: Optional[float] = None
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        self._count += 1
        self.last = dt
        if self._count > self.skip:
            self.ema = dt if self.ema is None else self.alpha * dt + (1 - self.alpha) * self.ema
        return False
