"""The port's native tier (``spoofsv_torch/native``) against the JAX package's.

The sources and Makefile are byte-equal copies; the port builds its own
``libspoofkit`` into ``spoofsv_torch/_build/`` and never loads or writes the
JAX package's. FLAC: the same encoded bytes and decoded samples as the JAX
codec on ``tests/test_native.py::TestFlacCodec``'s and
``TestFlacLpcDecode``'s signals and hand-made frames. WebRTC VAD: the same
flags, bit for bit, on ``TestWebrtcVad``'s signals at every mode.
"""

import ctypes
import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from spoofsv_tpu.dsp import host as jhost
from spoofsv_tpu.spoofkit import flacio as jflacio
from spoofsv_tpu.spoofkit import vad as jvad
from spoofsv_torch import native
from spoofsv_torch.dsp import host
from spoofsv_torch.spoofkit import flacio, vad

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "spoofsv_tpu", "native")


def test_sources_and_makefile_are_byte_equal_copies():
    names = sorted(os.listdir(os.path.join(JAX_NATIVE, "src")))
    assert names == sorted(os.listdir(native.SRC_DIR))
    match, mismatch, errors = filecmp.cmpfiles(os.path.join(JAX_NATIVE, "src"), native.SRC_DIR,
                                               names, shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == 8
    assert filecmp.cmp(os.path.join(JAX_NATIVE, "Makefile"), native.NATIVE_DIR / "Makefile",
                       shallow=False)


@pytest.mark.skipif(shutil.which("make") is None, reason="needs make")
def test_build_command_is_the_makefiles_recipe(tmp_path):
    """The loader's command is what ``make`` would run from the Makefile
    (dry run, the compiler and flags at the Makefile's defaults)."""
    out = tmp_path / "lib.so"
    env = {k: v for k, v in os.environ.items() if k not in ("CXX", "CXXFLAGS", "LDFLAGS")}
    dry = subprocess.run(["make", "-n", "--no-print-directory", "-C", str(native.NATIVE_DIR),
                          f"OUT={out}"], capture_output=True, text=True, env=env, check=True)
    assert dry.stdout.split() == native.build_command(out)
    assert not out.exists()


def test_library_builds_and_loads_from_the_port_only():
    """In a fresh process: the FLAC codec and the VAD load the port's
    library, from ``spoofsv_torch/_build``; no file of the JAX package's
    native directory is mapped, added or touched."""
    code = f"""
import os, numpy as np
jax_dir = {JAX_NATIVE!r}
before = {{f: os.stat(os.path.join(jax_dir, f)).st_mtime_ns for f in os.listdir(jax_dir)}}
from spoofsv_torch import native
from spoofsv_torch.spoofkit import flacio, vad
import tempfile
p = os.path.join(tempfile.mkdtemp(), "a.flac")
flacio.encode_flac(p, (np.arange(4000) % 97).astype(np.int32), 16000)
flacio.decode_flac(p)
vad.webrtc_classifier(np.zeros(16000, np.float32), 16000)
maps = open("/proc/self/maps").read()
assert "spoofsv_tpu/native" not in maps, "the JAX library is mapped"
lib = native.load_lib()._name
assert lib.startswith(str(native.BUILD_DIR)) and lib in maps, lib
after = {{f: os.stat(os.path.join(jax_dir, f)).st_mtime_ns for f in os.listdir(jax_dir)}}
assert before == after, (before, after)
assert "spoofsv_tpu" not in " ".join(__import__("sys").modules)
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


def test_every_bound_symbol_is_exported():
    lib = native.load_lib()
    for name in native.SIGNATURES:
        assert getattr(lib, name).argtypes is not None, name


# ---------------------------------------------------------------------------
# FLAC (TestFlacCodec, TestFlacLpcDecode)
# ---------------------------------------------------------------------------

def _tone(n=32000, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t) \
        + 0.01 * rng.normal(size=n)
    return (np.clip(y, -1, 1) * 32767).astype(np.int32)


def _pcm_cases():
    rng = np.random.default_rng(3)
    yield "tone", _tone(), 16000, 16
    yield "stereo_noise", rng.integers(-32768, 32767, (5000, 2)).astype(np.int32), 22050, 16
    for n in (1, 2, 3, 4095, 4096, 4097):
        yield f"n{n}", (np.arange(n) % 251 - 125).astype(np.int32) * 100, 16000, 16
    yield "24bit", (np.arange(5000) % 1000 - 500).astype(np.int32) * 4000, 16000, 24


@pytest.mark.parametrize("name,pcm,sr,bits", list(_pcm_cases()), ids=lambda v: v
                         if isinstance(v, str) else None)
def test_flac_bytes_and_samples_equal_jax(tmp_path, name, pcm, sr, bits):
    mine, ref = str(tmp_path / "port.flac"), str(tmp_path / "jax.flac")
    flacio.encode_flac(mine, pcm, sr, bits=bits)
    jflacio.encode_flac(ref, pcm, sr, bits=bits)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    got, got_sr = flacio.decode_flac(ref)
    want, want_sr = jflacio.decode_flac(ref)
    assert got_sr == want_sr == sr and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.round(got * (1 << (bits - 1))).astype(np.int32), pcm)


def test_flac_unknown_length_and_bad_file(tmp_path):
    pcm = (np.arange(9000) % 251 - 125).astype(np.int32) * 100
    p = str(tmp_path / "u.flac")
    flacio.encode_flac(p, pcm, 16000)
    raw = bytearray(open(p, "rb").read())
    raw[8 + 13] &= 0xF0                 # zero STREAMINFO's 36-bit total_samples
    raw[8 + 14:8 + 18] = b"\0\0\0\0"
    open(p, "wb").write(bytes(raw))
    np.testing.assert_array_equal(flacio.decode_flac(p)[0], jflacio.decode_flac(p)[0])
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"RIFF0000")
    with pytest.raises(ValueError, match="not a decodable FLAC"):
        flacio.decode_flac(str(bad))


class _BitWriter:
    """MSB-first bit writer for hand-made FLAC frames."""

    def __init__(self):
        self.bytes, self.cur, self.n = bytearray(), 0, 0

    def bits(self, v, width):
        for i in range(width - 1, -1, -1):
            self.cur = (self.cur << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.bytes.append(self.cur)
                self.cur, self.n = 0, 0

    def align(self):
        if self.n:
            self.bits(0, 8 - self.n)


def _header(w, bs, channels_code, assignment):
    w.bytes += b"fLaC"
    w.bits(1, 1); w.bits(0, 7); w.bits(34, 24)
    w.bits(bs, 16); w.bits(bs, 16); w.bits(0, 24); w.bits(0, 24)
    w.bits(16000, 20); w.bits(channels_code, 3); w.bits(15, 5)
    w.bits(bs, 36)
    for _ in range(16):
        w.bits(0, 8)
    w.bits(0x3FFE, 14); w.bits(0, 1); w.bits(0, 1)
    w.bits(6, 4); w.bits(5, 4)
    w.bits(assignment, 4); w.bits(4, 3); w.bits(0, 1)
    w.bits(0, 8); w.bits(bs - 1, 8); w.bits(0, 8)


def _lpc_frame() -> bytes:
    """TestFlacLpcDecode's order-2 LPC subframe: the path real ASVspoof
    FLACs take, which the encoder never writes."""
    order, prec, shift, coefs, warmup = 2, 12, 10, [900, -300], [1000, 1010]
    residuals = [3, -2, 0, 5, -7, 1, 2, -1, 0, 4, -3, 2, 1, 0]
    w = _BitWriter()
    _header(w, 16, 0, 0)
    w.bits(0, 1); w.bits(0x20 | (order - 1), 6); w.bits(0, 1)
    for v in warmup:
        w.bits(v & 0xFFFF, 16)
    w.bits(prec - 1, 4); w.bits(shift, 5)
    for c in coefs:
        w.bits(c & ((1 << prec) - 1), prec)
    w.bits(0, 2); w.bits(0, 4); w.bits(4, 4)
    for r in residuals:
        zz = (-2 * r - 1) if r < 0 else 2 * r
        for _ in range(zz >> 4):
            w.bits(0, 1)
        w.bits(1, 1)
        w.bits(zz & 15, 4)
    w.align()
    w.bits(0, 16)
    return bytes(w.bytes)


def _left_side_frame() -> bytes:
    """TestFlacLpcDecode's left/side stereo frame of constant subframes."""
    w = _BitWriter()
    _header(w, 8, 1, 8)
    w.bits(0, 1); w.bits(0, 6); w.bits(0, 1); w.bits(1200 & 0xFFFF, 16)
    w.bits(0, 1); w.bits(0, 6); w.bits(0, 1); w.bits(300 & 0x1FFFF, 17)
    w.align()
    w.bits(0, 16)
    return bytes(w.bytes)


@pytest.mark.parametrize("frame", [_lpc_frame, _left_side_frame])
def test_hand_made_frames_decode_as_jax(tmp_path, frame):
    p = tmp_path / "f.flac"
    p.write_bytes(frame())
    got, sr = flacio.decode_flac(str(p))
    want, jsr = jflacio.decode_flac(str(p))
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)


def test_host_flac_round_trip_and_dispatch(tmp_path):
    """``write_flac`` writes the JAX bytes, ``load_wav`` dispatches ``.flac``
    (and ``.FLAC``) to the codec with resampling, as the JAX reader does."""
    y = _tone(n=16000).astype(np.float32) / 32767.0
    mine, ref = str(tmp_path / "a.FLAC"), str(tmp_path / "b.flac")
    host.write_flac(mine, y, 16000)
    jhost.write_flac(ref, y, 16000)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    for sr in (None, 22050):
        got, got_sr = host.load_wav(mine, sr=sr)
        want, want_sr = jhost.load_wav(mine, sr=sr)
        assert got_sr == want_sr and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# WebRTC VAD (TestWebrtcVad)
# ---------------------------------------------------------------------------

def _speechy(sr, seconds=2.0, pitch=150.0, amp=0.4):
    t = np.arange(int(sr * seconds)) / sr
    sig = sum(np.sin(2 * np.pi * pitch * h * t) / h for h in range(1, 20))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    return (amp * sig / np.abs(sig).max() * env).astype(np.float32)


def _vad_signals(sr):
    rng = np.random.default_rng(0)
    speech = _speechy(sr, seconds=1.0)
    yield "silence", np.zeros(sr, np.float32)
    yield "speech", _speechy(sr)
    yield "quiet_noise", (0.002 * rng.normal(size=2 * sr)).astype(np.float32)
    yield "weak_in_noise", (0.5 * _speechy(sr, amp=0.02)
                            + (0.01 * rng.normal(size=2 * sr)).astype(np.float32))
    yield "gap", np.concatenate([speech, np.zeros(int(0.06 * sr), np.float32), speech])
    yield "padded", np.concatenate([np.zeros(sr // 2, np.float32), _speechy(sr, seconds=1.5),
                                    np.zeros(sr // 2, np.float32)])


@pytest.mark.parametrize("sr", [8000, 16000])
@pytest.mark.parametrize("frame_ms", [10, 20, 30])
def test_webrtc_flags_bit_equal(sr, frame_ms):
    for name, y in _vad_signals(sr):
        for mode in range(4):
            got = vad.webrtc_classifier(y, sr, frame_ms, aggressiveness=mode)
            want = jvad.webrtc_classifier(y, sr, frame_ms, aggressiveness=mode)
            assert got.dtype == bool
            np.testing.assert_array_equal(got, want, err_msg=f"{name} mode {mode}")


def test_webrtc_refusals_and_raw_calls():
    with pytest.raises(ValueError, match="8/16 kHz"):
        vad.webrtc_classifier(np.zeros(100, np.float32), 22050)
    with pytest.raises(ValueError, match="invalid VAD frame"):
        vad.webrtc_classifier(np.zeros(16000, np.float32), 16000, frame_ms=25)
    lib = native.load_lib()
    h = lib.sk_vad_new(2)
    buf = np.zeros(1000, np.int16)
    p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
    try:
        assert lib.sk_vad_process(h, p, 320, 16000) >= 0
        assert lib.sk_vad_process(h, p, 321, 16000) == -1
        assert lib.sk_vad_process(h, p, 320, 44100) == -1
    finally:
        lib.sk_vad_free(h)
    assert lib.sk_vad_new(7) in (None, 0)
