"""The program's own spans in a profiler trace, by what the device did under them.

``spoofsv_torch`` opens ``torch.profiler.record_function("spoofsv.<name>")``
around each layer of a call (``spoofsv_torch/utils/profiling.py``; the
names are listed in ``PERF.md``). This reads them from a Chrome trace
(``torch.profiler``'s ``export_chrome_trace``) over a window: the
benchmark's ``portbench.window`` span where the trace has one, else the
whole trace. For each span name, over its instances that start in the
window:

* ``device_s``: the device time of the operations (kernels, copies, sets)
  launched while the launching thread was inside the span, linked to their
  launch by the trace's correlation ids (a launch the trace did not link
  takes the spans of the operation before it);
* ``launches``: the kernels among those operations;
* ``syncs``: the host's waits on the device inside the span
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
  ``cudaEventSynchronize`` runtime calls);
* ``idle_s``: the time inside the span in which no operation ran on the
  device, over every gap of the window.

Nested spans count toward each span around them, so ``synth.call`` holds
its stages' work and a span with none inside holds only its own. ``gaps``
labels each idle gap of the window by the innermost program span at its
middle.

No metric of ``BENCHMARK.json`` reads this yet: ``harness.TraceView`` does
not call it (``PERF.md``, Open questions). To read a trace by hand::

    python3 -m portbench.program_spans TRACE.json
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.harness import DEVICE_CATS, SPAN

PROGRAM = "spoofsv."
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


class _Stacks:
    """The program's spans on each host thread, for the stack at a time."""

    def __init__(self, spans: List[tuple]):
        self.by_tid: Dict[object, tuple] = {}
        for tid in {s[3] for s in spans}:
            mine = sorted((s for s in spans if s[3] == tid), key=lambda s: s[0])
            self.by_tid[tid] = (np.array([s[0] for s in mine]), np.array([s[1] for s in mine]),
                                [s[2] for s in mine])

    def at(self, tid, t: float) -> Tuple[str, ...]:
        """The names of the spans of thread ``tid`` covering ``t``, outermost first."""
        if tid not in self.by_tid:
            return ()
        s, e, names = self.by_tid[tid]
        return tuple(names[i] for i in np.flatnonzero((s <= t) & (e >= t)))


class ProgramSpans:
    def __init__(self):
        self.count: Dict[str, int] = {}
        self.device_s: Dict[str, float] = {}
        self.launches: Dict[str, int] = {}
        self.syncs: Dict[str, int] = {}
        self.idle_s: Dict[str, float] = {}
        self.gaps: List[tuple] = []       # (label, seconds), longest first

    @staticmethod
    def _add(table: dict, names, value) -> None:
        for n in set(names):
            table[n] = table.get(n, 0) + value

    @classmethod
    def from_chrome(cls, trace: dict) -> "ProgramSpans":
        v = cls()
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e["name"][len(PROGRAM):], e.get("tid"))
                 for e in events
                 if e.get("cat") == "user_annotation" and e["name"].startswith(PROGRAM)]
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e["name"] == SPAN + "window"]
        if window:
            w0 = float(window[0]["ts"])
            w1 = w0 + float(window[0].get("dur", 0))
        else:
            times = [float(e["ts"]) for e in events] + [float(e["ts"]) + float(e.get("dur", 0))
                                                        for e in events]
            if not times:
                return v
            w0, w1 = min(times), max(times)
        spans = [s for s in spans if w0 <= s[0] <= w1]
        for s in spans:
            v.count[s[2]] = v.count.get(s[2], 0) + 1
        stacks = _Stacks(spans)
        runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        launch_at = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid"))
                     for e in runtime if "correlation" in e.get("args", {})}
        dev = sorted((float(e["ts"]), float(e.get("dur", 0)), e.get("cat"),
                      e.get("args", {}).get("correlation"))
                     for e in events if e.get("cat") in DEVICE_CATS)
        busy: List[tuple] = []
        held: Tuple[str, ...] = ()
        for ts, dur, cat, corr in dev:
            if ts + dur < w0 or ts > w1:
                continue
            at = launch_at.get(corr)
            held = stacks.at(at[1], at[0]) if at is not None else held
            cls._add(v.device_s, held, dur / 1e6)
            cls._add(v.launches, held, int(cat == "kernel"))
            busy.append((max(ts, w0), min(ts + dur, w1)))
        for e in runtime:
            t = float(e["ts"])
            if e["name"] in SYNCS and w0 <= t <= w1:
                cls._add(v.syncs, stacks.at(e.get("tid"), t), 1)
        gaps = _gaps(busy, w0, w1)
        if gaps:
            gs, ge = np.array([g[0] for g in gaps]), np.array([g[1] for g in gaps])
            for s, e, name, _ in spans:
                idle = np.clip(np.minimum(e, ge) - np.maximum(s, gs), 0.0, None).sum()
                v.idle_s[name] = v.idle_s.get(name, 0.0) + idle / 1e6
        by_label: Dict[str, float] = {}
        starts = sorted(spans, key=lambda s: s[0])
        for s, e in gaps:
            label = _innermost(starts, 0.5 * (s + e)) or "none"
            by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e6
        v.gaps = sorted(by_label.items(), key=lambda kv: -kv[1])
        return v

    def summary(self, per: Optional[str] = None) -> Dict[str, dict]:
        """Each span's totals, and, with ``per``, each divided by that span's
        instances (``per="synth.call"``: per synthesis call)."""
        n = self.count.get(per, 0) if per else 1
        out = {}
        for name in sorted(self.count):
            out[name] = {"count": self.count[name],
                         "device_ms": 1e3 * self.device_s.get(name, 0.0) / max(n, 1),
                         "launches": self.launches.get(name, 0) / max(n, 1),
                         "syncs": self.syncs.get(name, 0) / max(n, 1),
                         "idle_ms": 1e3 * self.idle_s.get(name, 0.0) / max(n, 1)}
        return out


def _gaps(busy: List[tuple], w0: float, w1: float) -> List[tuple]:
    """The stretches of [w0, w1] that no interval of ``busy`` covers."""
    gaps, cur = [], w0
    for s, e in sorted(busy):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    return gaps


def _innermost(spans: List[tuple], t: float) -> Optional[str]:
    """The latest-starting span (of any thread) covering ``t``."""
    best = None
    for s, e, name, _ in spans:
        if s > t:
            break
        if e >= t:
            best = name
    return best


def main(argv) -> int:
    with open(argv[0]) as f:
        v = ProgramSpans.from_chrome(json.load(f))
    per = "synth.call" if "synth.call" in v.count else None
    print(json.dumps({"per": per, "spans": v.summary(per), "idle_gaps": v.gaps[:10]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
