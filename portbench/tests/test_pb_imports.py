"""What the benchmark loads: no JAX, no JAX package, and a reference that
loads nothing of the program; and no run that falls back to the CPU."""

import json
import os
import subprocess
import sys
import types

import pytest

from portbench import harness
from portbench.tests.conftest import cells

ROOT = str(harness.ROOT)

RUN_ALL = r"""
import sys, json, time, argparse
sys.path.insert(0, %(root)r)
import torch
from portbench import harness, calibrate, sweep
from portbench.tests import conftest
for kind in ("bulk", "serve", "train"):
    harness.kind_module(kind)
for path in (harness.BENCH / "metrics").glob("*.py"):
    harness.metric_module(path.name[:-3])
import portbench.reference.dctts, portbench.reference.vocoder, portbench.reference.compare
import portbench.reference.train
# a whole run of a cell on the CPU, so that what the program loads counts too
cfg, mix = harness.config, harness.traffic
def config(n):
    c = cfg(n); c["config"].update(conftest.TINY); c["config"]["TPU"]["griffin_lim_iters"] = 2
    return c
def traffic(n):
    t = mix(n); t.update(conftest.TINY_MIX[t["kind"]]); return t
harness.config, harness.traffic = config, traffic
args = argparse.Namespace(workload=%(cell)r, seed=1, seconds=0.0, trace=0)
harness.run_cell(args, time.perf_counter(), device_check=False, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = r"""
import sys, json
sys.path.insert(0, %(root)r)
import portbench.reference.dctts, portbench.reference.vocoder, portbench.reference.compare
import portbench.reference.train
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", [cells()[0]])
def test_harness_kinds_metrics_and_a_run_load_no_jax(cell):
    loaded = _top_level(RUN_ALL % {"root": ROOT, "cell": cell})
    assert "spoofsv_torch" in loaded   # the run did reach the program
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY % {"root": ROOT})
    assert not loaded & ({"spoofsv_torch"} | set(harness.FORBIDDEN))


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("spoofsv_torch.models", "jaxtyping", "flaxish", "spoofsv_tpu_notes"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "spoofsv_tpu.ops", types.ModuleType("spoofsv_tpu.ops"))
    assert harness.forbidden_modules() == ["jax", "spoofsv_tpu"]


@pytest.mark.parametrize("cell", cells())
def test_no_card_no_result(cell):
    """Without CUDA devices the command exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
