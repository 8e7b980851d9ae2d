"""The benchmark's data files: they load, name things as the contract
allows, agree with ``BENCHMARK.json``, and the open loop's schedule and
latency are what the serving kind says they are."""

import http.server
import io
import json
import re
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import pytest

from portbench import harness, inputs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_benchmark_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "traffic"])
def test_data_files_load(kind):
    files = sorted((harness.BENCH / kind).glob("*.json"))
    assert files
    for f in files:
        assert isinstance(harness.read_json(f), dict), f


def test_metric_readers_load():
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer") + (("source",) if group == "configs" else ()):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[g]]
    assert len(names) == len(set(names))


def test_cells_agree_with_their_files():
    for w in BENCH["workloads"]:
        f = harness.workload(w["name"])
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert f["limits"] and all(v >= 0 for v in f["limits"].values())
        harness.config(w["config"])
        kind = harness.traffic(w["traffic"])["kind"]
        assert (harness.BENCH / "traffic" / f"{kind}.py").exists()
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert harness.config(c["name"])["source"] == c["source"]


def test_every_cell_reports_enough_and_moves_point_at_its_metrics():
    for cell in [w["name"] for w in BENCH["workloads"]]:
        e2e = {m["name"] for m in harness.end_to_end_for(BENCH, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_for(BENCH, cell)
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in harness.end_to_end_for(BENCH, cell)}
            assert m["moves"] in reported, (m["name"], cell)


def _serve():
    return harness.kind_module("serve")


def test_open_loop_schedule_comes_from_the_seed():
    serve = _serve()
    mix = harness.traffic("serve-poisson")
    names = [f"p{i}" for i in range(10)]
    texts = inputs.sentences(5)
    a = serve.schedule(2 ** 31 + 7, mix, 20.0, 5.0, names, texts)
    assert a == serve.schedule(2 ** 31 + 7, mix, 20.0, 5.0, names, texts)
    b = serve.schedule(8, mix, 20.0, 5.0, names, texts)
    gaps = lambda s: np.sort(np.diff([r[0] for r in s]))   # noqa: E731
    # the same arrivals in another place: all but one gap are shared
    assert len(a) == len(b) == 100 and a != b
    shared = np.intersect1d(np.round(gaps(a), 12), np.round(gaps(b), 12))
    assert len(shared) >= len(a) - 2
    assert a[0][0] == 0.0 and max(r[0] for r in a) <= 5.0 + 1e-9


class _Slow(http.server.BaseHTTPRequestHandler):
    """Replies a short WAV 0.3 s after each request, one at a time."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.3)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(22050)
            w.writeframes(np.arange(100, dtype="<i2").tobytes())
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_latency_runs_from_the_due_time():
    """Three requests due at once on a server that answers one at a time:
    the third's latency holds the wait behind the first two."""
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Slow)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        child = subprocess.Popen([sys.executable, str(_serve().CLIENT), str(srv.server_address[1])],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        child.stdin.write(json.dumps({"requests": [[0.0, "a", "p1"], [0.01, "b", "p2"],
                                                   [0.02, "c", "p3"]], "timeout_s": 30}) + "\n")
        child.stdin.flush()
        assert child.stdout.readline().strip() == "ready"
        child.stdin.write("go\n")
        child.stdin.flush()
        recs = [json.loads(line) for line in child.stdout]
        child.wait(timeout=30)
    finally:
        srv.shutdown()
        srv.server_close()
    assert recs[-1] == {"end": True}
    lat = sorted(r["done"] - r["due"] for r in recs[:-1])
    assert all(r["status"] == 200 and r["samples"] == 100 for r in recs[:-1])
    assert lat[0] >= 0.29 and lat[2] >= 0.85
