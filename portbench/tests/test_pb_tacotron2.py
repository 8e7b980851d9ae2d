"""The Tacotron 2 cell on the CPU at a tiny size, through the harness's own
path but for the look for a card: a sound run is correct; each fault its
kind plants in the timed path, and the configuration's fp8 control, are
not. Its counted work, by hand; its reference, the byte copy of
``plainref/tacotron2.py``.

The cell's tiny widths and its kind's tiny mix are added to
``conftest.py``'s tables by ``portbench/conftest.py``'s session fixture."""

import sys

import pytest

from portbench import harness
from portbench.tests.conftest import kind_of

CELL = "tacotron2-sv2tts.bulk160-ar1000"
CONFIG = "tacotron2-sv2tts"


def test_sound_run_is_correct(tiny):
    r, readings = tiny.run(CELL, seed=2 ** 31 + 11)
    assert r["correct"], r["limits"]
    assert set(r["limits"]) == set(harness.workload(CELL)["limits"])
    # the port's plain path is the reference's arithmetic in another order
    assert readings["rollout_mel_gap"] < 1e-4 and readings["postnet_rel"] < 1e-5, readings
    assert {"rollout_mel_gap_first100", "rollout_mel_gap_last100", "vocoder_rel"} <= set(readings)
    e2e = {m["name"] for m in harness.end_to_end_for(harness.benchmark(), CELL)}
    assert set(r["metrics"]) == e2e


@pytest.mark.parametrize("fault", sorted(kind_of(CELL).FAULTS))
def test_broken_timed_path_is_not_correct(tiny, fault):
    r, readings = tiny.run(CELL, hooks=kind_of(CELL).FAULTS[fault])
    assert not r["correct"], readings


def test_control_is_not_correct(tiny):
    checks = harness.held(tiny.control(CELL), harness.workload(CELL)["limits"])
    assert not harness.is_correct(checks), checks


def test_traced_run_reports_per_layer_metrics_only(tiny):
    r, _ = tiny.run(CELL, seconds=0.2, trace=1)
    per_layer = {m["name"] for m in harness.per_layer_for(harness.benchmark(), CELL)}
    assert {"t2.encode_ms", "t2.rollout_ms", "t2.postnet_ms", "t2.rollout_roofline",
            "t2.att_step_roofline", "t2.dec_step_roofline", "mfu.bulk"} <= per_layer
    assert set(r["metrics"]) <= per_layer   # a CPU run reads no device metric
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_reference_is_the_plain_reference_byte_for_byte():
    copy = harness.BENCH / "reference" / "tacotron2.py"
    assert copy.read_bytes() == (harness.ROOT / "plainref" / "tacotron2.py").read_bytes()


def test_counted_work_by_hand():
    from portbench.work import tacotron2 as t2work

    hp = harness.config(CONFIG)["config"]
    macs = t2work.step_macs(hp, 49)
    # the two cells' gate products: [prenet, context, h] and [h_att, context, h]
    assert macs["gemm"] == 4 * 1024 * (256 + 768 + 1024) + 4 * 1024 * (1024 + 768 + 1024)
    # 20.31 M parameters a step: the products', the query's, the location
    # layer's, v's and the biases (the memory layer runs once a call)
    params = macs["gemm"] + macs["dec_step"] + 1024 * 128 + 32 * 128 + 128 + 32 * 2 * 31 \
        + 2 * 2 * 4 * 1024 + 81
    assert round(params / 1e6, 2) == 20.31
    ops, nbytes = t2work.rollout(hp, 160, 49, 1000, 2)
    assert 6.5e12 < ops < 6.9e12 and nbytes < 0.2e9


def test_reference_loads_nothing_of_the_program():
    import json
    import subprocess

    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import portbench.reference.t2_compare, portbench.work.tacotron2\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & ({"spoofsv_torch"} | set(harness.FORBIDDEN))
