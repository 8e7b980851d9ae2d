"""The program's spans and counters, and a ``torch.profiler`` trace around a block.

Port of :mod:`spoofsv_tpu.utils.profiling` (which wraps ``jax.profiler``):
it replaces the reference's wall-clock prints (``train/ordinary.py:218,
289-291``).

:func:`span` opens ``torch.profiler.record_function("spoofsv." + name)``,
so each span lands in any running profiler's trace on the device trace's
clock, and adds its host duration to an in-process table (count, total and
longest seconds per name). :func:`count` adds to a counter of the same
table. The table is process-wide, under a lock (the serving batcher and the
HTTP handlers are threads); :func:`snapshot` reads it and :func:`reset`
clears it. With no profiler running a span costs one ``record_function``
enter and exit and two clock reads. ``PERF.md`` names every span and
counter and what reads it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional

import torch

PREFIX = "spoofsv."


class _Table:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans: Dict[str, dict] = {}
        self.counters: Dict[str, int] = {}


_TABLE = _Table()


class span:
    """``with span("decode.encode"): ...``: the enclosed block as the span
    ``spoofsv.decode.encode``. ``args`` are identifiers of this instance
    (a serving batch's id, rows and rung): they go to ``record_function``
    and the table keeps the latest instance's. After the block,
    :attr:`seconds` holds its host duration."""

    __slots__ = ("name", "args", "seconds", "_rf", "_t0")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args
        self.seconds = 0.0

    def __enter__(self) -> "span":
        text = ",".join(f"{k}={v}" for k, v in self.args.items()) or None
        self._rf = torch.profiler.record_function(PREFIX + self.name, text)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = (time.perf_counter_ns() - self._t0) / 1e9
        self._rf.__exit__(*exc)
        with _TABLE.lock:
            row = _TABLE.spans.get(self.name)
            if row is None:
                row = _TABLE.spans[self.name] = {"count": 0, "total_s": 0.0, "max_s": 0.0}
            row["count"] += 1
            row["total_s"] += self.seconds
            row["max_s"] = max(row["max_s"], self.seconds)
            if self.args:
                row["args"] = dict(self.args)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _TABLE.lock:
        _TABLE.counters[name] = _TABLE.counters.get(name, 0) + int(n)


def snapshot() -> dict:
    """A copy of the table: ``{"spans": {name: {"count", "total_s", "max_s"[,
    "args"]}}, "counters": {name: n}}``."""
    with _TABLE.lock:
        return {"spans": {k: dict(v) for k, v in _TABLE.spans.items()},
                "counters": dict(_TABLE.counters)}


def reset() -> None:
    """Clear every span and counter."""
    with _TABLE.lock:
        _TABLE.spans.clear()
        _TABLE.counters.clear()


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    """The bytes of the tensors given (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Capture a ``torch.profiler`` trace of the enclosed block (host, every
    thread's spans and operations, and the card when CUDA is available) into
    ``log_dir`` as a Chrome/TensorBoard trace file; yields the profiler
    (``key_averages()`` reads it after the block). No-op, yielding None,
    when ``log_dir`` is falsy."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
