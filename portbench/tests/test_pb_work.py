"""The counted work of each stage, against counts written out by hand."""

import importlib.util
import inspect
import math

import pytest

from portbench import harness, work


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", harness.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decode_count_is_chip_smokes():
    ops, nbytes = work.k1_decode(256, 80, 64, 100, 325, 2)
    assert (ops, nbytes) == _chip_smoke().decode_work(256, 80, 64, 100, 325, 2)
    assert round(ops / 1e9, 1) == 282.5


def test_text_encoder_by_hand():
    C, E, S, B, N = 8, 4, 3, 2, 5
    d2 = 16
    macs = B * N * (E * d2 + d2 * d2)              # conv1, conv2
    macs += B * N * 10 * (3 * d2 * 2 * d2)         # 8 dilated blocks, hc1, hc2 (3 taps)
    macs += B * N * 2 * (d2 * 2 * d2)              # hc3, hc4 (1 tap)
    macs += 2 * B * S * C                          # fc1, fc2
    assert work.text_encoder(C, E, S, B, N, 2)[0] == 2 * macs


def test_ssrn_by_hand():
    D, F, L, B, T = 4, 3, 5, 2, 6
    hw = lambda c, t: 3 * c * 2 * c * t   # noqa: E731 - one 3-tap highway block over t frames
    macs = F * D * T + 2 * hw(D, T)                    # conv1 and the first pair at T
    macs += D * D * 2 * T + 2 * hw(D, 2 * T)           # ups1: deconv to 2T, its pair
    macs += D * D * 4 * T + 2 * hw(D, 4 * T)           # ups2: deconv to 4T, its pair
    macs += D * 2 * D * 4 * T + 2 * hw(2 * D, 4 * T)   # conv2, hc3, hc4
    macs += 2 * D * L * 4 * T + 3 * L * L * 4 * T      # conv3, conv4-6
    ops, nbytes = work.ssrn(D, F, L, B, T, 2)
    assert ops == 2 * B * macs
    assert nbytes > 2 * B * (T * F + 4 * T * L)


def test_griffin_lim_by_hand():
    n, B, T, iters = 16, 2, 5, 3
    fft = 2.5 * n * math.log2(n)
    bins = n // 2 + 1
    per_frame = iters * (2 * fft + 4 * n + 12 * bins) + fft + 2 * n + 35 * bins
    samples = B * (n // 4) * (T - 1)
    ops, nbytes = work.griffin_lim(n, B, T, iters, 2)
    assert ops == B * T * per_frame + 2 * samples
    assert nbytes == 2 * B * T * bins + 4 * samples


def test_training_step_by_hand():
    C, E, S, F, B, N, T, P = 8, 4, 3, 2, 2, 5, 7, 1000
    te = work.text_encoder(C, E, S, B, N, 4)[0] / 2
    enc = F * C + 2 * C * C + 10 * (3 * C * 2 * C)
    dec = 2 * C * C + 6 * (3 * C * 2 * C) + 3 * C * C + C * F
    fwd = te + B * T * (enc + dec) + 2 * B * N * T * C
    assert work.text2mel_step(C, E, S, F, B, N, T, P)[0] == 6 * fwd + 12 * P


def test_counts_take_shapes_alone():
    for fn in (work.k1_decode, work.text_encoder, work.decode_stage, work.ssrn,
               work.griffin_lim, work.text2mel_step):
        assert all(p.annotation in (int, "int") for p in inspect.signature(fn).parameters.values())
        args = [3] * len(inspect.signature(fn).parameters)
        args[0] = 16 if fn is work.griffin_lim else 3
        assert fn(*args) == fn(*args)


@pytest.mark.parametrize("precision", ["bf16", "int8", "f32", "tf32", "fp8"])
def test_bound_is_the_larger_of_operations_and_bytes(precision):
    table = work.peaks("NVIDIA H100 80GB HBM3")
    assert work.bound_s((table[precision], 0.0), precision, table) == pytest.approx(1.0)
    assert work.bound_s((0.0, table["bytes_per_s"]), precision, table) == pytest.approx(1.0)
    assert work.peaks("a card the table lacks") is None
