"""The cells on the card at their own sizes, in short windows: a run is
correct, and the configuration's control is not. Each test looks for a
card itself and skips without one; on the card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests/test_pb_card.py``
(``--noconftest`` keeps the repository's JAX test set-up out)."""

import argparse
import time

import pytest
import torch

from portbench import harness


def cells():
    return [w["name"] for w in harness.benchmark()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_is_correct_on_the_card(cell):
    _card()
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 77, seconds=2.0, trace=0)
    result, readings = harness.run_cell(args, time.perf_counter())
    assert result["correct"], readings
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct_on_the_card(cell):
    _card()
    cell_file = harness.workload(cell)
    ctx = harness.Context(argparse.Namespace(workload=cell, seed=78, seconds=0.0, trace=0),
                          cell_file, harness.config(cell_file["config"]),
                          harness.traffic(cell_file["traffic"]), harness.Tracer(False))
    ctx.device = torch.device("cuda:0")
    kind = harness.kind_module(ctx.mix["kind"]).Kind(ctx, {})
    kind.setup()
    kind.window()
    kind.release()
    assert not harness.is_correct(harness.held(kind.control(), cell_file["limits"]))
