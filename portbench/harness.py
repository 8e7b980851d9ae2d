"""The general part of the benchmark: a run of one cell from its files.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``),
whose ``kind`` names the generator that drives the program
(``traffic/<kind>.py``, a class ``Kind``). Each per-layer metric is a reader
of its own (``metrics/<metric>.py``, ``read(view)``). So a new cell,
configuration, mix or metric is a new file, found by its name.

A run: the kind's set-up (weights from the seed, the program built, its
shapes warmed), the measured window, the device's memory peak, the check
that no JAX module was loaded, the program freed, then the kind's
comparison against the plain reference (``reference/``), each reading
held to its limit in the cell's file.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spoofsv_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return read_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return read_json(BENCH / "traffic" / f"{name}.json")


def load_file(path: Path, name: str):
    """Import the module in ``path`` under ``name`` (file names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    return load_file(BENCH / "traffic" / f"{kind}.py", f"portbench_kind_{kind}")


def metric_module(name: str):
    return load_file(BENCH / "metrics" / f"{name}.py", f"portbench_metric_{name.replace('.', '_')}")


def forbidden_modules() -> List[str]:
    """The JAX modules (and the JAX package) this process has loaded, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def per_layer_for(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])]


def end_to_end_for(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "portbench."


class Tracer:
    """Spans of the benchmark's own around the calls into each layer, and,
    when on, the profiler over the window."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self._window_span = None
        self.view: Optional["TraceView"] = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN + name)

    @contextlib.contextmanager
    def window(self):
        """The measured window; under the profiler when tracing (a kind may
        end the traced part early with :meth:`stop`)."""
        if not self.on:
            yield
            return
        self.start()
        try:
            yield
        finally:
            self.stop()
            self.finish()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._window_span = record_function(SPAN + "window")
        self._window_span.__enter__()

    def stop(self) -> None:
        """End the traced window (once); :meth:`finish` reads its trace."""
        if self.prof is None or self._window_span is None:
            return
        self._window_span.__exit__(None, None, None)
        self._window_span = None
        self.prof.__exit__(None, None, None)

    def finish(self) -> None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.view = TraceView.from_chrome(read_json(Path(path)))
        finally:
            os.unlink(path)
            self.prof = None


class TraceView:
    """What the metric readers read: the device's activity in the traced
    window, each operation's span (the benchmark's innermost span around
    the host call that launched it), and what the kind adds (``extra``)."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.device_ops: List[tuple] = []          # (name, start us, dur us, span)
        self.span_device_s: Dict[str, float] = {}
        self.launches = 0
        self.gaps: List[tuple] = []                # (label, seconds)
        self.extra: dict = {}

    @staticmethod
    def _innermost(spans: List[tuple], starts: List[float], t: float) -> Optional[str]:
        """The innermost (latest-starting) span covering host time ``t``."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 64, -1), -1):
            s, e, name = spans[j]
            if s <= t <= e:
                return name
        return None

    @classmethod
    def from_chrome(cls, trace: dict) -> "TraceView":
        v = cls()
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                        e["name"][len(SPAN):]) for e in events
                       if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN))
        window = [s for s in spans if s[2] == "window"]
        if not window:
            return v
        w0, w1 = window[0][0], window[0][1]
        inner = [s for s in spans if s[2] != "window"]
        starts = [s[0] for s in inner]
        launch_at = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                launch_at[e["args"]["correlation"]] = float(e["ts"])
        dev = sorted((float(e["ts"]), float(e.get("dur", 0)), e["name"],
                      e.get("args", {}).get("correlation"), e.get("cat"))
                     for e in events if e.get("cat") in DEVICE_CATS)
        last_span = "host"
        for ts, dur, name, corr, cat in dev:
            if ts + dur < w0 or ts > w1:
                continue
            at = launch_at.get(corr)
            span = cls._innermost(inner, starts, at) if at is not None else None
            # a launch the trace did not link: the span of the work before it
            span = span or last_span
            last_span = span
            v.device_ops.append((name, ts, dur, span))
            v.span_device_s[span] = v.span_device_s.get(span, 0.0) + dur / 1e6
            v.launches += cat == "kernel"
        v.window_s = (w1 - w0) / 1e6
        # busy: the union of the device's operations in the window
        busy, cur_s, cur_e, gaps = 0.0, None, None, []
        for _, ts, dur, _ in sorted(v.device_ops, key=lambda o: o[1]):
            s, e = max(ts, w0), min(ts + dur, w1)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                gaps.append((w0 if cur_e is None else cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            gaps.append((cur_e, w1))
        v.busy_s = busy / 1e6
        # idle gaps by what the host was doing: the benchmark's innermost
        # span at the gap's middle, else the longest host operation there
        cpu = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
               for e in events if e.get("cat") == "cpu_op"]
        c_s = np.array([c[0] for c in cpu]) if cpu else np.zeros(0)
        c_e = np.array([c[1] for c in cpu]) if cpu else np.zeros(0)
        by_label: Dict[str, float] = {}
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:400]:
            mid = 0.5 * (s + e)
            label = cls._innermost(inner, starts, mid)
            if label is None:
                hit = np.flatnonzero((c_s <= mid) & (c_e >= mid))
                label = ("host:" + cpu[hit[np.argmax(c_e[hit] - c_s[hit])]][2][:60]
                         if len(hit) else "host:none")
            by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e6
        v.gaps = sorted(by_label.items(), key=lambda kv: -kv[1])
        return v

    def breakdown(self) -> dict:
        per_op: Dict[str, float] = {}
        for name, _, dur, _ in self.device_ops:
            per_op[name[:100]] = per_op.get(name[:100], 0.0) + dur / 1e6
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

class Context:
    """What a kind needs: the cell's files, the run's arguments, the device."""

    def __init__(self, args, cell: dict, conf: dict, mix: dict, tracer: Tracer):
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.cell, self.conf, self.mix = cell, conf, mix
        self.tracer = tracer
        self.device = None


def parse(argv) -> argparse.Namespace:
    ps = argparse.ArgumentParser(description="one run of one benchmark cell")
    ps.add_argument("--workload", required=True)
    ps.add_argument("--seed", type=int, required=True)
    ps.add_argument("--seconds", type=float, required=True)
    ps.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ps.parse_args(argv)


def held(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared reading beside its limit, in the limits' order."""
    return {k: {"value": readings.get(k), "limit": lim} for k, lim in limits.items()}


def is_correct(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                                for c in checks.values())


def run_cell(args, start: float, device_check: bool = True, device=None,
             hooks: Optional[Dict[str, Callable]] = None) -> tuple:
    """One run: returns the result object and every reading of the
    comparison (those the limits hold, and the rest). ``device_check=False`` and
    ``device`` run it on another device than the cards (the tests' CPU
    runs); ``hooks`` lets a test break the timed path (``kind.hooks``)."""
    import torch

    cell = workload(args.workload)
    if device_check:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise SystemExit(f"portbench: the cell asks for {cell['chips']} CUDA device(s), "
                             f"this machine has {n}")
        device = torch.device("cuda:0")
    tracer = Tracer(bool(args.trace))
    ctx = Context(args, cell, config(cell["config"]), traffic(cell["traffic"]), tracer)
    ctx.device = torch.device(device)
    kind = kind_module(ctx.mix["kind"]).Kind(ctx, hooks or {})
    kind.setup()
    setup_s = time.perf_counter() - start
    with tracer.window():
        e2e = kind.window()
    on_card = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: the run loaded {', '.join(found)}")
    info = kind.release()
    readings = kind.check()
    checks = held(readings, cell["limits"])
    bench = benchmark()
    result = {"correct": is_correct(checks), "attempted": info["attempted"],
              "failed": info["failed"]}
    device_info = {"platform": "gpu" if on_card else ctx.device.type,
                   "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    metrics = {}
    if args.trace:
        view = tracer.view or TraceView()
        view.extra.update(info.get("trace", {}))
        view.extra["device_kind"] = device_info["kind"]
        for m in per_layer_for(bench, args.workload):
            value = metric_module(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = view.busy_s
        device_info["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    else:
        for m in end_to_end_for(bench, args.workload):
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["limits"] = checks
    return result, readings


def main(argv, start: float) -> int:
    args = parse(argv)
    try:
        result, readings = run_cell(args, start)
    except SystemExit as e:
        print(str(e), file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 2
    print("readings " + json.dumps(readings), file=sys.stderr)
    for name, c in result["limits"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
