"""Tiny sizes for the benchmark's CPU tests: the cells' configurations at
small widths, and their traffic cut down, read through the harness's own
loaders so that every other part of a run is the one the card runs."""

import argparse
import time

import pytest
import torch

from portbench import harness

TINY = {"HIDDEN_DIM": 32, "TEXT_EMB_DIM": 16, "SSRN_DIM": 16}
SHORT_ROLLOUT = {"MAX_FRAME_NUM": 24}   # synthesis only: training keeps its buckets' frames
TINY_MIX = {"bulk": {"speakers_per_call": 2, "sentences": 3, "warmup_calls": 1},
            "serve": {"rate_per_s": 4.0, "sampled_batches": 3, "trace_seconds": 0.5,
                      "warmup_seconds": 0.5},
            "train": {"batch": 4, "pool_batches": 4, "median_s": 1.0, "trace_seconds": 0.5}}


class Tiny:
    """Runs a cell on the CPU at a tiny size (no look for a card)."""

    def __init__(self, monkeypatch):
        self.real_config, self.real_traffic = harness.config, harness.traffic
        self.kind, self.mix = None, {}
        monkeypatch.setattr(harness, "config", self.config)
        monkeypatch.setattr(harness, "traffic", self.traffic)
        torch.set_num_threads(2)

    def config(self, name):
        c = self.real_config(name)
        c["config"].update(TINY)
        if self.kind != "train":
            c["config"].update(SHORT_ROLLOUT)
        c["config"]["TPU"]["griffin_lim_iters"] = 3
        return c

    def traffic(self, name):
        t = self.real_traffic(name)
        t.update(TINY_MIX[t["kind"]], **self.mix)
        return t

    def _select(self, cell, mix):
        self.kind = self.real_traffic(harness.workload(cell)["traffic"])["kind"]
        self.mix = mix

    def run(self, cell, seed=3, seconds=0.0, trace=0, hooks=None, **mix):
        """A whole run: (result, readings)."""
        self._select(cell, mix)
        args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
        return harness.run_cell(args, time.perf_counter(), device_check=False, device="cpu",
                                hooks=hooks)

    def control(self, cell, seed=5):
        """The readings of the cell's control over a one-call (or step) window."""
        self._select(cell, {})
        w = harness.workload(cell)
        ctx = harness.Context(argparse.Namespace(workload=cell, seed=seed, seconds=0.0, trace=0),
                              w, harness.config(w["config"]), harness.traffic(w["traffic"]),
                              harness.Tracer(False))
        ctx.device = torch.device("cpu")
        kind = harness.kind_module(ctx.mix["kind"]).Kind(ctx, {})
        kind.setup()
        kind.window()
        kind.release()
        return kind.control()


@pytest.fixture
def tiny(monkeypatch):
    return Tiny(monkeypatch)


def kind_of(cell: str):
    return harness.kind_module(harness.read_json(
        harness.BENCH / "traffic" / f"{harness.workload(cell)['traffic']}.json")["kind"])


def cells():
    """Every cell with a file in ``workloads/``: those ``BENCHMARK.json``
    declares, and the serving and training cells, kept measured but not
    declared."""
    return sorted(p.name[:-5] for p in (harness.BENCH / "workloads").glob("*.json"))
