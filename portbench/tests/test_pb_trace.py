"""The trace readers on a synthetic Chrome trace with both kinds of span.

One synthesis call of the benchmark's spans (``portbench.``) with the
program's own (``spoofsv.``) inside them, as ``spoofsv_torch`` opens them:
kernels (one the trace did not link to its launch), copies each way,
runtime synchronizes and idle gaps, plus a kernel and a span outside the
window. Every value below is worked out by hand from the events (times in
microseconds). The harness's ``TraceView``, and so every reader in
``portbench/metrics/``, reads exactly what it reads without the program's
spans; ``program_spans.ProgramSpans`` reads what the program's spans hold.
"""

import pytest

from portbench import harness, program_spans, work

HOST, DEV = 1, 7


def _span(prefix, name, ts, end, tid=HOST):
    return {"ph": "X", "cat": "user_annotation", "name": prefix + name, "pid": 1, "tid": tid,
            "ts": ts, "dur": end - ts}


def _runtime(name, ts, dur, corr=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": HOST, "ts": ts,
            "dur": dur, "args": args}


def _device(cat, name, ts, end, corr=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": DEV, "ts": ts,
            "dur": end - ts, "args": args}


BENCH_SPANS = [("window", 0, 1000), ("call", 100, 800), ("decode", 124, 400),
               ("vocode", 410, 690), ("to_host", 710, 800)]
PROGRAM_SPANS = [("synth.call", 102, 700), ("synth.inputs", 104, 120),
                 ("decode.encode", 130, 200), ("decode.rollout", 210, 230),
                 ("vocode.gl", 420, 440), ("vocode.deemph", 445, 690),
                 ("synth.call", 1100, 1200)]          # after the window
OPS = [
    _runtime("cudaLaunchKernel", -60, 2, corr=9), _device("kernel", "before", -50, -40, corr=9),
    _runtime("cudaMemcpyAsync", 105, 3, corr=1), _device("gpu_memcpy", "HtoD", 106, 110, corr=1),
    _runtime("cudaStreamSynchronize", 111, 8),
    _runtime("cudaLaunchKernel", 135, 2, corr=2), _device("kernel", "enc", 140, 190, corr=2),
    _runtime("cudaLaunchKernel", 150, 2, corr=3), _device("kernel", "proj", 195, 215, corr=3),
    _runtime("cudaLaunchKernelExC", 215, 2, corr=4), _device("kernel", "k1", 220, 380, corr=4),
    _runtime("cudaLaunchKernel", 425, 2, corr=5), _device("kernel", "gl", 450, 600, corr=5),
    _device("kernel", "gl_tail", 600, 610),            # no link to its launch
    _runtime("cudaMemcpyAsync", 446, 1, corr=6), _device("gpu_memcpy", "HtoD", 650, 652, corr=6),
    _runtime("cudaStreamSynchronize", 447, 205),
    _runtime("cudaLaunchKernel", 660, 2, corr=7), _device("kernel", "deemph", 662, 670, corr=7),
    _runtime("cudaMemcpyAsync", 712, 1, corr=8), _device("gpu_memcpy", "DtoH", 715, 790, corr=8),
    _runtime("cudaStreamSynchronize", 713, 78),
]


def _trace(with_program: bool) -> dict:
    events = [_span(harness.SPAN, *s) for s in BENCH_SPANS] + list(OPS)
    if with_program:
        events += [_span(program_spans.PROGRAM, *s) for s in PROGRAM_SPANS]
        # the device-side copy of a span that kineto adds: not a device operation
        events.append({"ph": "X", "cat": "gpu_user_annotation", "name": "spoofsv.synth.call",
                       "pid": 0, "tid": DEV, "ts": 106, "dur": 564})
    return {"traceEvents": events}


def _state(v: harness.TraceView) -> dict:
    return {k: getattr(v, k) for k in ("window_s", "busy_s", "device_ops", "span_device_s",
                                       "launches", "gaps")}


def test_harness_view_reads_the_same_with_the_programs_spans():
    with_program = harness.TraceView.from_chrome(_trace(True))
    assert _state(with_program) == _state(harness.TraceView.from_chrome(_trace(False)))
    v = with_program
    assert v.window_s == pytest.approx(1000e-6)
    assert v.busy_s == pytest.approx(479e-6)
    assert v.launches == 6
    assert [(n, s) for n, _, _, s in v.device_ops] == [
        ("HtoD", "call"), ("enc", "decode"), ("proj", "decode"), ("k1", "decode"),
        ("gl", "vocode"), ("gl_tail", "vocode"), ("HtoD", "vocode"), ("deemph", "vocode"),
        ("DtoH", "to_host")]
    assert v.span_device_s == pytest.approx({"call": 4e-6, "decode": 230e-6, "vocode": 170e-6,
                                             "to_host": 75e-6})
    assert [k for k, _ in v.gaps] == ["host:none", "vocode", "call", "decode"]
    assert [s for _, s in v.gaps] == pytest.approx([316e-6, 120e-6, 45e-6, 40e-6])


def test_existing_readers_read_the_same_values():
    stage = (work.decode_stage(512, 256, 200, 80, 160, 50, 325, 2), "bf16")
    extra = {"stage_ms": {"decode": [46.0, 48.0], "ssrn": [58.0], "vocode": [38.0, 40.0]},
             "stage_work": {"decode": stage, "vocode": stage, "ssrn": stage},
             "calls": 1, "calls_traced": 1, "wall_s": 1e-3,
             "device_kind": "NVIDIA H100 80GB HBM3"}
    reads = []
    for with_program in (True, False):
        v = harness.TraceView.from_chrome(_trace(with_program))
        v.extra.update(extra)
        reads.append({m["name"]: harness.metric_module(m["name"]).read(v)
                      for m in harness.benchmark()["per_layer"]})
    assert reads[0] == reads[1]
    got = reads[0]
    assert got["bulk.device_idle_pct"] == pytest.approx(52.1)
    assert got["bulk.decode_ms"] == 47.0 and got["bulk.vocoder_ms"] == 39.0
    assert got["bulk.ssrn_ms"] == 58.0
    table = work.peaks("NVIDIA H100 80GB HBM3")
    bound = work.bound_s(stage[0], "bf16", table)
    assert got["bulk.decode_roofline"] == pytest.approx(100.0 * bound / 230e-6)
    assert got["bulk.vocoder_roofline"] == pytest.approx(100.0 * bound / 170e-6)


def test_program_spans_read_what_the_trace_holds():
    p = program_spans.ProgramSpans.from_chrome(_trace(True))
    names = ["synth.call", "synth.inputs", "decode.encode", "decode.rollout", "vocode.gl",
             "vocode.deemph"]
    assert p.count == {n: 1 for n in names}
    assert p.device_s == pytest.approx({"synth.call": 404e-6, "synth.inputs": 4e-6,
                                        "decode.encode": 70e-6, "decode.rollout": 160e-6,
                                        "vocode.gl": 160e-6, "vocode.deemph": 10e-6})
    assert p.launches == {"synth.call": 6, "synth.inputs": 0, "decode.encode": 2,
                          "decode.rollout": 1, "vocode.gl": 2, "vocode.deemph": 1}
    assert p.syncs == {"synth.call": 2, "synth.inputs": 1, "vocode.deemph": 1}
    assert p.idle_s == pytest.approx({"synth.call": 194e-6, "synth.inputs": 12e-6,
                                      "decode.encode": 15e-6, "decode.rollout": 5e-6,
                                      "vocode.gl": 20e-6, "vocode.deemph": 75e-6})
    assert [k for k, _ in p.gaps] == ["none", "synth.call", "vocode.deemph", "decode.encode",
                                      "decode.rollout"]
    assert [s for _, s in p.gaps] == pytest.approx([316e-6, 145e-6, 50e-6, 5e-6, 5e-6])
    call = p.summary("synth.call")["synth.call"]
    assert call == pytest.approx({"count": 1, "device_ms": 0.404, "launches": 6, "syncs": 2,
                                  "idle_ms": 0.194})
    # no program span: nothing to read, and no error
    assert program_spans.ProgramSpans.from_chrome(_trace(False)).count == {}
