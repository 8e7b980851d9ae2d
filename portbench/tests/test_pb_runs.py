"""A run of every cell on the CPU at a tiny size, through the harness's own
path but for the look for a card: a sound run is correct, and a run with
its timed path broken on purpose (each fault its kind can have) and the
cell's control (the reference in the precision below the
configuration's) are not."""

import json

import pytest

from portbench import harness
from portbench.tests.conftest import cells, kind_of

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "limits"}


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(tiny, cell):
    r, _ = tiny.run(cell)
    assert r["correct"], r["limits"]
    assert set(r) == CONTRACT_KEYS
    assert list(r)[-1] == "limits"
    assert r["attempted"] >= 1 and r["failed"] == 0
    e2e = {m["name"] for m in harness.end_to_end_for(harness.benchmark(), cell)}
    assert set(r["metrics"]) == e2e
    json.dumps(r)


def _faults():
    return [(c, f) for c in cells() for f in kind_of(c).FAULTS]


@pytest.mark.parametrize("cell,fault", _faults())
def test_broken_timed_path_is_not_correct(tiny, cell, fault):
    # serving: arrivals close enough that batches hold several requests
    serve = kind_of(cell).__name__.endswith("serve")
    extra = {"rate_per_s": 40.0} if serve else {}
    r, readings = tiny.run(cell, seconds=0.5 if serve else 0.0, hooks=kind_of(cell).FAULTS[fault],
                           **extra)
    assert not r["correct"], readings


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(tiny, cell):
    """The configuration's control in the program's place fails a limit."""
    checks = harness.held(tiny.control(cell), harness.workload(cell)["limits"])
    assert not harness.is_correct(checks), checks


def test_traced_run_reports_per_layer_metrics_only(tiny):
    cell = cells()[0]
    r, _ = tiny.run(cell, seconds=0.2, trace=1)
    assert set(r) == CONTRACT_KEYS | {"breakdown"}
    per_layer = {m["name"] for m in harness.per_layer_for(harness.benchmark(), cell)}
    assert set(r["metrics"]) <= per_layer   # a CPU run reads no device metric
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
