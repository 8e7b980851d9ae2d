"""The port's serving path (:mod:`spoofsv_torch.serve`) against the JAX one, on the CPU.

The tiny configuration of ``tests/test_serve.py`` (hidden 16, text-emb 8,
SSRN 16, speaker 10, ``max_text_len`` 16, ``max_frame_num`` 8, GL3) with the
JAX parameters carried into the port's modules. The same requests go to the
JAX ``BatchingSynthesizer`` and to the port's; the finalized audio must
agree to rel-L2 ≤ 1e-3 and atol 2e-3 (the whole-slice gates of
``test_torch_port_synth.py``), escalations and attention cuts must be the
same, ``wav_bytes`` the same bytes, and the HTTP status codes the same.
The behaviour classes of ``tests/test_serve.py`` are mirrored against the
port; its ``TestMeshServing`` has its counterpart over two ranks in
``tests/test_torch_port_mesh.py``.
"""

import contextlib
import dataclasses
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spoofsv_tpu import serve as jserve
from spoofsv_tpu.config import Config as JConfig
from spoofsv_tpu.infer.synthesize import Synthesizer as JSynthesizer
from spoofsv_tpu.models import SSRN as JSSRN
from spoofsv_tpu.models import MelSyn as JMelSyn
from spoofsv_tpu.train.steps import shift_right
from spoofsv_torch import serve as tserve
from spoofsv_torch.config import Config
from spoofsv_torch.infer.synthesize import Synthesizer, finalize_audio
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.weights import load_melsyn_from_jax, load_ssrn_from_jax

import port_threads  # noqa: F401 - this process's CPU threads (tests/port_threads.py)

TINY = dict(hidden_dim=16, text_emb_dim=8, ssrn_dim=16, spk_emb_dim=10, max_text_len=16,
            max_frame_num=8)


def _tiny(cfg):
    cfg = cfg.replace(**TINY)
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, griffin_lim_iters=3))


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _tiny(JConfig()), _tiny(Config())
    jm = JMelSyn(vocab_len=jcfg.vocab_len, condition=True, spk_emb_dim=jcfg.spk_emb_dim,
                 text_emb_dim=jcfg.text_emb_dim, freq_bins=jcfg.mel.freq_bins,
                 hidden_dim=jcfg.hidden_dim, dtype=jnp.float32)
    js = JSSRN(freq_bins=jcfg.mel.freq_bins, output_bins=jcfg.lin_bins, ssrn_dim=jcfg.ssrn_dim,
               dtype=jnp.float32)
    rng = np.random.default_rng(0)
    text = jnp.asarray(rng.integers(1, jcfg.vocab_len - 1, (2, jcfg.max_text_len)), jnp.int32)
    spk = jnp.asarray(rng.normal(size=(2, jcfg.spk_emb_dim)), jnp.float32)
    mel = jnp.asarray(rng.uniform(0.05, 0.95, (2, 4, jcfg.mel.freq_bins)), jnp.float32)
    key = jax.random.PRNGKey(0)
    p1 = jm.init(key, shift_right(mel), text, spk)
    p2 = js.init(key, mel)
    tm = load_melsyn_from_jax(MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim,
                                     cfg.mel.freq_bins, cfg.hidden_dim), p1)
    ts = load_ssrn_from_jax(SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim), p2)
    return SimpleNamespace(
        jcfg=jcfg, cfg=cfg,
        jsyn=JSynthesizer(jcfg, jm, js, p1, p2, n_frames=jcfg.max_frame_num, gl_iters=3),
        syn=Synthesizer(cfg, tm, ts, n_frames=cfg.max_frame_num, gl_iters=3))


def _batchers(s, **kw):
    """A JAX and a port batcher with the same settings (test_serve.py's defaults)."""
    kw.setdefault("max_batch", 4)
    kw.setdefault("batch_wait_ms", 60.0)
    kw.setdefault("trim_db", None)   # random-param audio may trim to nothing
    return (jserve.BatchingSynthesizer(s.jcfg, s.jsyn, **kw),
            tserve.BatchingSynthesizer(s.cfg, s.syn, **kw))


@contextlib.contextmanager
def _closing(*batchers):
    try:
        yield batchers
    finally:
        for b in batchers:
            b.close()


def _spk(s, v=0.0):
    return np.full(s.cfg.spk_emb_dim, v, np.float32)


def _assert_audio_close(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 1e-3, rel
    np.testing.assert_allclose(got, ref, atol=2e-3)


def _fire(b, requests, gap_s=0.02):
    """Submit (name, text, spk) requests from threads ``gap_s`` apart; returns
    {name: audio or the exception}."""
    out = {}

    def call(name, text, spk):
        try:
            out[name] = b.synthesize(text, spk, timeout=120)
        except BaseException as e:  # noqa: BLE001
            out[name] = e

    threads = [threading.Thread(target=call, args=r) for r in requests]
    for t in threads:
        t.start()
        time.sleep(gap_s)
    for t in threads:
        t.join()
    return out


# ------------------------------------------------------------ audio vs JAX
@pytest.mark.parametrize("device_pcm", [False, True])
def test_requests_match_jax(setup, device_pcm):
    """Solo requests, then three co-batched (padded to the 4 rung), through
    both batchers: the same finalized audio, with and without device PCM."""
    s = setup
    reqs = [("a", "hello world", _spk(s)), ("b", "another one", _spk(s, 0.3)),
            ("c", "third here", _spk(s, 0.3))]
    with _closing(*_batchers(s, batch_wait_ms=0.0, device_pcm=device_pcm)) as (jb, tb):
        assert jb.device_pcm == tb.device_pcm == device_pcm
        for name, text, spk in reqs[:2]:
            _assert_audio_close(tb.synthesize(text, spk, timeout=120),
                                jb.synthesize(text, spk, timeout=120))
    with _closing(*_batchers(s, batch_wait_ms=400.0, device_pcm=device_pcm)) as (jb, tb):
        ref, got = _fire(jb, reqs), _fire(tb, reqs)
        for name, _, _ in reqs:
            _assert_audio_close(got[name], ref[name])
        assert tb.stats_dict()["max_batch_seen"] >= 2 and jb.stats_dict()["max_batch_seen"] >= 2


def test_escalation_and_cut_frames_match_jax(setup):
    """frames_buckets [4, 8] with speculative escalation and the attention
    cut on the real models: the same escalations, the same cut lengths and
    the same audio."""
    s = setup
    kw = dict(max_batch=4, batch_wait_ms=0.0, frames_buckets=[4, 8], frames_per_char=0.5,
              min_frames=2, speculative=True, attn_trim=1, device_pcm=False)
    texts = ["ab", "abcd", "a" * 14]
    hop = s.cfg.stft.hop_length
    with _closing(*_batchers(s, **kw)) as (jb, tb):
        lengths = []
        for text in texts:
            got = tb.synthesize(text, _spk(s), timeout=120)
            _assert_audio_close(got, jb.synthesize(text, _spk(s), timeout=120))
            lengths.append(len(got))
        js, ts = jb.stats_dict(), tb.stats_dict()
        for k in ("n_escalated", "n_requests", "n_batches"):
            assert ts[k] == js[k], (k, ts, js)
        # neither path is vacuous here: "abcd" escalates, "ab" is cut short
        assert ts["n_escalated"] >= 1 and min(lengths) < hop * (4 * 4 - 1), (ts, lengths)


def _fake(kind, N, hop, calls, as_torch):
    """Synthesizer stand-ins of test_serve.py's TestSpeculative/TestAttnTrim:
    constant audio and an attention that reaches the text's end (row N-1)
    at a chosen frame, or never."""
    def syn_for(frames):
        def run(text, spk, key_or_seeds):
            bsz = text.shape[0]
            calls.append(frames)
            audio = np.full((bsz, frames * hop), 0.1, np.float32)
            attn = np.zeros((bsz, N, frames), np.float32)
            if kind == "short_misses_end":
                attn[:, N - 1 if frames >= 8 else 1, -1] = 1.0
            elif kind == "short_reaches_end":
                attn[:, N - 1, -1] = 1.0
            elif kind == "never":
                attn[:, 1, -1] = 1.0
            elif kind == "at_5":
                attn[:, N - 1, 5:] = 1.0
            elif kind == "at_5_of_8":
                if frames >= 8:
                    attn[:, N - 1, 5:] = 1.0
            if as_torch:
                return torch.from_numpy(audio), None, torch.from_numpy(attn)
            return audio, None, attn

        return run

    return syn_for


SPEC = dict(frames_buckets=[4, 8], frames_per_char=0.5, min_frames=2, speculative=True)


@pytest.mark.parametrize("kind,text,kw,calls,frames_out,escalated", [
    ("short_misses_end", "abcd", SPEC, [4, 8], 8, 1),          # incomplete → escalates
    ("short_reaches_end", "abcd", SPEC, [4], 4, 0),
    ("never", "a" * 14, SPEC, [8], 8, 0),                      # the largest bucket never does
    ("at_5", "abcd", dict(attn_trim=1), [8], 7, 0),            # (5+1) + pad 1 of 8
    ("at_5", "abcd", dict(attn_trim=1, device_pcm=True), [8], 7, 0),
    ("never", "abcd", dict(attn_trim=0), [8], 8, 0),           # never completed: full rollout
    ("at_5_of_8", "abcd", dict(SPEC, attn_trim=0), [4, 8], 6, 1),   # escalation, then the cut
])
def test_speculative_and_attn_trim_match_jax(setup, kind, text, kw, calls, frames_out,
                                             escalated):
    s = setup
    hop, N = s.cfg.stft.hop_length, s.cfg.max_text_len
    kw = dict(dict(max_batch=4, batch_wait_ms=0.0, device_pcm=False), **kw)
    with _closing(*_batchers(s, **kw)) as (jb, tb):
        seen = {}
        for b, as_torch in ((jb, False), (tb, True)):
            seen[as_torch] = []
            b._syn_for = _fake(kind, N, hop, seen[as_torch], as_torch)
        ref = jb.synthesize(text, _spk(s), timeout=60)
        got = tb.synthesize(text, _spk(s), timeout=60)
        assert seen[True] == seen[False] == calls
        assert len(got) == len(ref) == frames_out * hop
        np.testing.assert_array_equal(got, ref)
        js, ts = jb.stats_dict(), tb.stats_dict()
        assert ts["n_escalated"] == js["n_escalated"] == escalated
        assert ts["n_requests"] == js["n_requests"] == 1
        assert ts["n_batches"] == js["n_batches"] == len(calls)


@pytest.mark.parametrize("signal", ["sine", "clipped", "negative", "empty"])
def test_wav_bytes_same_bytes(signal):
    t = np.linspace(0, 40, 1000)
    y = {"sine": 0.5 * np.sin(t), "clipped": 1.7 * np.sin(t), "negative": -np.abs(np.sin(t)),
         "empty": np.zeros(0)}[signal].astype(np.float32)
    assert tserve.wav_bytes(y, 22050) == jserve.wav_bytes(y, 22050)
    from scipy.io import wavfile

    sr, decoded = wavfile.read(io.BytesIO(tserve.wav_bytes(y, 22050)))
    assert sr == 22050 and len(decoded) == len(y)


def test_pcm16_matches_jax_pcm(setup):
    """The device PCM epilogue: int16 equal to the JAX one, and
    negative-dominant audio unclipped; its rounding is half to even, as
    jnp.round's."""
    s = setup
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(ties)).numpy(),
                                  np.asarray(jnp.round(ties)))
    y = np.random.default_rng(3).normal(scale=0.3, size=(3, 500)).astype(np.float32)
    y[1] = np.full(500, -0.05, np.float32)
    y[1, 30], y[1, 60] = 0.1, -0.8                 # |min| >> signed max
    jb, tb = _batchers(s, device_pcm=True)
    with _closing(jb, tb):
        ref = np.asarray(jb._pcm(jnp.asarray(y)))
        got = tserve.pcm16(torch.from_numpy(y)).numpy()
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got[1].astype(np.float32) / 32767.0, y[1] / 0.8 * 0.75,
                                   atol=1.01 / 32767.0)


def test_device_pcm_peak_past_duration_cap(setup):
    """test_serve.py's composition case: device PCM then the host finalize
    over the trim/cap window equals the host path when the true peak lies
    past the raw cap."""
    s = setup
    cfg, max_s = s.cfg, 0.01
    cap = int(max_s * cfg.sampling_rate)

    def compose(y, trim_db):
        pcm = tserve.pcm16(torch.from_numpy(y[None])).numpy()[0]
        return finalize_audio(pcm.astype(np.float32) / 32767.0, cfg, trim_db=trim_db,
                              max_seconds=max_s)

    y = np.full(500, 0.1, np.float32)
    y[10], y[400] = 0.5, 0.9
    host, got = finalize_audio(y, cfg, max_seconds=max_s), compose(y, None)
    assert len(host) == len(got) == cap
    np.testing.assert_allclose(got, host, atol=2.1 / 32767.0)
    y = np.zeros(900, np.float32)
    y[150:800] = 0.1 * np.random.default_rng(7).standard_normal(650).astype(np.float32)
    y[160], y[390] = 0.2, 0.45
    host, got = finalize_audio(y, cfg, trim_db=30.0, max_seconds=max_s), compose(y, 30.0)
    assert len(host) == len(got)
    np.testing.assert_allclose(got, host, atol=1.5e-4)


# ------------------------------------------------------------------ HTTP
@contextlib.contextmanager
def _http(batcher, make, speakers):
    httpd = make(batcher, speakers, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield httpd
    finally:
        httpd.shutdown()
        batcher.close()


def _request(url, path, payload=None, raw=None):
    """(status, headers, body) of a GET (no payload) or a POST."""
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _http_cases(cfg):
    dim = cfg.spk_emb_dim
    return [
        ("GET /speakers", "/speakers", None, None),
        ("GET /healthz", "/healthz", None, None),
        ("GET unknown path", "/nothing", None, None),
        ("POST unknown path", "/other", {"text": "x"}, None),
        ("wav by speaker", "/synthesize", {"text": "hello", "speaker": "p225"}, None),
        ("json by speaker", "/synthesize", {"text": "hello", "speaker": "p225",
                                            "format": "json"}, None),
        ("spk_emb vector", "/synthesize", {"text": "vec", "spk_emb": [0.0] * dim}, None),
        ("missing text", "/synthesize", {"speaker": "p225"}, None),
        ("unknown speaker", "/synthesize", {"text": "x", "speaker": "nope"}, None),
        ("wrong dim", "/synthesize", {"text": "x", "spk_emb": [0.1, 0.2]}, None),
        ("text too long", "/synthesize", {"text": "y" * (cfg.max_text_len + 5),
                                          "spk_emb": [0.0] * dim}, None),
        ("not json", "/synthesize", None, b"{not json"),
        ("expired deadline", "/synthesize", {"text": "x", "deadline_ms": 0,
                                             "spk_emb": [0.0] * dim}, None),
        ("oversized body", "/synthesize", None,
         json.dumps({"text": "x", "pad": "a" * (tserve.MAX_BODY_BYTES + 10)}).encode()),
    ]


def _negative_length_status(httpd) -> bytes:
    host, port = httpd.server_address[:2]
    with socket.create_connection((host, port), timeout=30) as sock:
        sock.sendall(b"POST /synthesize HTTP/1.1\r\nHost: x\r\nContent-Length: -1\r\n\r\n")
        sock.settimeout(30)
        return sock.recv(4096).split(b"\r\n", 1)[0]


def test_http_status_codes_match_jax(setup, tmp_path):
    """The same requests to a JAX and a port server: the same status codes
    (200, 400, 404, 413, 504) and error texts' subjects; the same speakers,
    WAV bytes within the audio gate and JSON samples."""
    s = setup
    np.save(tmp_path / "p225.npy", np.zeros(s.cfg.spk_emb_dim, np.float32))
    out = {}
    jb, tb = _batchers(s)
    for name, b, mod in (("jax", jb, jserve), ("port", tb, tserve)):
        with _http(b, mod.make_http_server, mod.SpeakerTable(str(tmp_path))) as httpd:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            out[name] = [_request(url, path, payload, raw)
                         for _, path, payload, raw in _http_cases(s.cfg)]
            out[name].append((_negative_length_status(httpd), None, None))
    labels = [c[0] for c in _http_cases(s.cfg)] + ["negative Content-Length"]
    codes = {k: [r[0] for r in v] for k, v in out.items()}
    assert codes["port"][:-1] == codes["jax"][:-1], list(zip(labels, codes["port"], codes["jax"]))
    assert codes["port"][:-1] == [200, 200, 404, 404, 200, 200, 200, 400, 400, 400, 400, 400,
                                  504, 413]
    assert b"400" in codes["port"][-1] and b"400" in codes["jax"][-1]
    (_, jh, jwav), (_, th, twav) = out["jax"][4], out["port"][4]
    assert th["Content-Type"] == jh["Content-Type"] == "audio/wav"
    from scipy.io import wavfile

    (jsr, jy), (tsr, ty) = (wavfile.read(io.BytesIO(w)) for w in (jwav, twav))
    assert tsr == jsr == 22050
    _assert_audio_close(ty / 32767.0, jy / 32767.0)
    jj, tj = json.loads(out["jax"][5][2]), json.loads(out["port"][5][2])
    assert tj["sr"] == jj["sr"]
    _assert_audio_close(np.asarray(tj["samples"]), np.asarray(jj["samples"]))
    assert json.loads(out["port"][0][2]) == json.loads(out["jax"][0][2]) == {"speakers": ["p225"]}
    for i, frag in ((9, "dim"), (10, "MAX_TEXT_LEN"), (12, "expired")):
        assert frag in json.loads(out["port"][i][2])["error"]
        assert frag in json.loads(out["jax"][i][2])["error"]


def test_http_takes_a_burst_of_connections(setup):
    """32 clients connecting at once all get their reply: the listen backlog
    holds the burst while the accept loop waits for the interpreter (the
    stdlib default of 5 reset connections here)."""
    s = setup
    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=8, batch_wait_ms=10.0,
                                   device_pcm=False, trim_db=None)
    hop, N = s.cfg.stft.hop_length, s.cfg.max_text_len
    b._syn_for = _fake("at_5", N, hop, [], True)
    payload = {"text": "burst", "spk_emb": [0.0] * s.cfg.spk_emb_dim}
    with _http(b, tserve.make_http_server, tserve.SpeakerTable("")) as httpd:
        assert httpd.request_queue_size >= 32
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        codes = []
        threads = [threading.Thread(target=lambda: codes.append(
            _request(url, "/synthesize", payload)[0])) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert codes == [200] * 32, codes


def _stall_process(b):
    """Hold the worker inside ``b._process`` until the returned ``release``
    is set; ``stalled`` is set once it is held there."""
    orig = b._process
    release, stalled = threading.Event(), threading.Event()

    def slow(batch, frames):
        stalled.set()
        release.wait(30)
        orig(batch, frames)

    b._process = slow
    return release, stalled


def test_http_overload_and_expiry_codes_match_jax(setup):
    """With the worker held: a queued request and a third that finds the
    queue full (503 with Retry-After ≥ 1), then a request whose deadline
    passes while queued (504); the same codes from both servers."""
    s = setup
    payload = {"text": "x", "spk_emb": [0.0] * s.cfg.spk_emb_dim}
    codes = {}
    jb, tb = _batchers(s, max_batch=1, batch_wait_ms=0.0, max_queue=1)
    for name, b, mod in (("jax", jb, jserve), ("port", tb, tserve)):
        release, stalled = _stall_process(b)
        got = {}
        with _http(b, mod.make_http_server, mod.SpeakerTable("")) as httpd:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"

            def post(key, body):
                got[key] = _request(url, "/synthesize", body)

            first = threading.Thread(target=post, args=("first", payload))
            first.start()
            assert stalled.wait(30)
            queued = threading.Thread(target=post, args=("queued", payload))
            queued.start()
            for _ in range(300):
                if b._q.qsize() >= 1:
                    break
                time.sleep(0.01)
            status, headers, _ = _request(url, "/synthesize", payload)
            got["shed"] = (status, headers, None)
            release.set()
            first.join()
            queued.join()
            # a request expiring in the queue behind a held batch
            release.clear()
            stalled.clear()
            hold = threading.Thread(target=post, args=("hold", payload))
            hold.start()
            assert stalled.wait(30)
            late = threading.Thread(target=post, args=("late", dict(payload, deadline_ms=200)))
            late.start()
            time.sleep(0.5)           # its deadline passes while queued
            release.set()
            hold.join()
            late.join()
        codes[name] = {k: v[0] for k, v in got.items()}
        assert int(got["shed"][1]["Retry-After"]) >= 1
    assert codes["port"] == codes["jax"] == {"first": 200, "queued": 200, "shed": 503,
                                             "hold": 200, "late": 504}
    assert tb.stats_dict()["n_rejected"] == 1 and tb.stats_dict()["n_expired"] == 1


# ------------------------------------------- the behaviours of test_serve.py
def test_solo_roundtrip_and_batch_invariance(setup):
    """A solo request completes with its stats; the same request co-batched
    with two others (rung 4) gives the same audio (spsi init)."""
    s = setup
    assert s.cfg.tpu.griffin_lim_init in ("advance", "spsi")
    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=4, batch_wait_ms=0.0, trim_db=None,
                                   device_pcm=False)
    with _closing(b):
        solo = b.synthesize("invariance", _spk(s), timeout=120)
        assert solo.ndim == 1 and len(solo) > 0 and np.all(np.isfinite(solo))
        st = b.stats_dict()
        assert st["n_requests"] == 1 and st["n_batches"] == 1
    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=4, batch_wait_ms=400.0,
                                   trim_db=None, device_pcm=False)
    with _closing(b):
        out = _fire(b, [("a", "invariance", _spk(s)), ("b", "another one", _spk(s, 0.3)),
                        ("c", "third here", _spk(s, 0.3))])
        assert b.stats_dict()["max_batch_seen"] >= 2
        np.testing.assert_allclose(out["a"], solo, atol=1e-5, rtol=0)


def test_bucket_ladder_and_frames_estimator(setup):
    s = setup
    jb, tb = _batchers(s, max_batch=8, frames_buckets=[4, 8], frames_per_char=0.5,
                       min_frames=2)
    with _closing(jb, tb):
        assert tb._ladder() == jb._ladder() == [1, 2, 4, 8]
        assert [tb._bucket(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
        assert tb.frames_buckets == jb.frames_buckets == [4, 8]
        assert [tb._frames_bucket(n) for n in (3, 9, 100)] == [4, 8, 8]
        assert [jb._frames_bucket(n) for n in (3, 9, 100)] == [4, 8, 8]
    jb, tb = _batchers(s, max_batch=6)
    with _closing(jb, tb):
        assert tb._ladder() == jb._ladder() == [1, 2, 4, 6]


def test_mixed_length_requests(setup):
    """Short and long texts queued together run as two frames groups, each
    with audio of its rollout's length."""
    s = setup
    hop = s.cfg.stft.hop_length
    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=4, batch_wait_ms=300.0, trim_db=None,
                                   frames_buckets=[4, 8], frames_per_char=0.5, min_frames=2)
    with _closing(b):
        out = _fire(b, [("short", "ab", _spk(s)), ("long", "a" * 14, _spk(s))])
        assert len(out["short"]) == hop * (4 * 4 - 1)
        assert len(out["long"]) == hop * (4 * 8 - 1)
        st = b.stats_dict()
        assert st["n_batches"] == 2 and st["n_requests"] == 2


def test_bad_inputs_and_error_isolation(setup):
    """Client errors raise BadRequest at the door as in JAX; a failing
    synthesizer call (a kernel error on a card) reaches each request of its
    batch as that error, and the worker goes on serving."""
    s = setup
    jb, tb = _batchers(s)
    with _closing(jb, tb):
        for text, spk, frag in ((42, _spk(s), "string"),
                                ("x" * (s.cfg.max_text_len + 5), _spk(s), "MAX_TEXT_LEN"),
                                ("ok", {"not": "a vector"}, "float vector"),
                                ("x", np.zeros(3, np.float32), "spk_emb")):
            for b, mod in ((jb, jserve), (tb, tserve)):
                with pytest.raises(mod.BadRequest, match=frag):
                    b.synthesize(text, spk, timeout=30)
        orig = tb._syn_for

        def failing(frames):
            def run(*args):
                raise RuntimeError("decode_cluster_kernel: CUDA error 700")
            return run

        tb._syn_for = failing
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            tb.synthesize("boom", _spk(s), timeout=60)
        assert tb.stats_dict()["n_errors"] == 1
        tb._syn_for = orig
        assert len(tb.synthesize("still alive", _spk(s), timeout=120)) > 0


def test_queue_full_sheds_and_abandoned_are_skipped(setup):
    """With the worker held, admissions beyond max_queue raise
    ServerOverloaded (admitted requests still complete), and a request whose
    caller timed out is skipped."""
    s = setup
    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=1, batch_wait_ms=0.0, trim_db=None,
                                   max_queue=2)
    release, stalled = _stall_process(b)
    outcome = {"ok": 0, "shed": 0}
    lock = threading.Lock()

    def fire():
        try:
            b.synthesize("load", _spk(s), timeout=120)
            key = "ok"
        except tserve.ServerOverloaded as e:
            assert e.retry_after_s >= 1.0
            key = "shed"
        with lock:
            outcome[key] += 1

    with _closing(b):
        threads = [threading.Thread(target=fire) for _ in range(8)]
        for t in threads:
            t.start()
            time.sleep(0.03)
        release.set()
        for t in threads:
            t.join()
        assert outcome["shed"] >= 3 and outcome["ok"] >= 3, outcome
        assert outcome["ok"] + outcome["shed"] == 8
        st = b.stats_dict()
        assert st["n_rejected"] == outcome["shed"] and st["n_requests"] == outcome["ok"]
        # abandoned: the worker is held on a blocker while the impatient times out
        release.clear()
        stalled.clear()
        blocker = threading.Thread(target=lambda: b.synthesize("blocker", _spk(s), timeout=120))
        blocker.start()
        assert stalled.wait(30)
        with pytest.raises(TimeoutError):
            b.synthesize("impatient", _spk(s), timeout=0.05)
        release.set()
        blocker.join()
        assert len(b.synthesize("after", _spk(s), timeout=120)) > 0
        st = b.stats_dict()
        assert st["n_abandoned"] == 1 and st["n_requests"] == outcome["ok"] + 2


def test_close_drains_stragglers(setup):
    s = setup
    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=1, batch_wait_ms=0.0)
    straggler = tserve._Pending(text_ids=np.zeros(s.cfg.max_text_len, np.int32),
                                spk_emb=_spk(s), frames=0)
    b._q.put(None)        # close()'s sentinel wins the race
    b._q.put(straggler)   # enqueued concurrently with shutdown
    b.close()
    assert straggler.done.is_set() and isinstance(straggler.error, RuntimeError)
    with pytest.raises(RuntimeError, match="shut down"):
        b.synthesize("late", _spk(s), timeout=5)


def test_deadlines(setup):
    """A non-positive deadline fails at the door with no queue side effect;
    one that passes while queued fails with DeadlineExceeded and one
    generous enough completes; when a collection spans two frames groups,
    the one holding a deadline runs first (EDF)."""
    s = setup
    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=1, batch_wait_ms=0.0, trim_db=None)
    release, stalled = _stall_process(b)
    with _closing(b):
        with pytest.raises(tserve.DeadlineExceeded):
            b.synthesize("too late", _spk(s), deadline_s=0)
        assert b.stats_dict()["n_expired"] == 1 and b._q.qsize() == 0
        results = {}

        def call(name, **kw):
            try:
                results[name] = b.synthesize(f"req {name}", _spk(s), timeout=120, **kw)
            except BaseException as e:  # noqa: BLE001
                results[name] = e

        ta = threading.Thread(target=call, args=("a",))
        ta.start()
        assert stalled.wait(30)
        tb_ = threading.Thread(target=call, args=("b",), kwargs={"deadline_s": 0.2})
        tc = threading.Thread(target=call, args=("c",), kwargs={"deadline_s": 120.0})
        tb_.start()
        tc.start()
        time.sleep(0.5)          # b's deadline passes while queued
        release.set()
        for t in (ta, tb_, tc):
            t.join()
        assert isinstance(results["b"], tserve.DeadlineExceeded), results["b"]
        assert isinstance(results["a"], np.ndarray) and isinstance(results["c"], np.ndarray)
        assert b.stats_dict()["n_expired"] == 2

    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=4, batch_wait_ms=250.0,
                                   trim_db=None, frames_buckets=[4, 8], frames_per_char=0.5,
                                   min_frames=2)
    order, orig = [], b._process
    release, stalled = threading.Event(), threading.Event()

    def wrapped(batch, frames):
        if not stalled.is_set():
            stalled.set()
            release.wait(30)
        else:
            order.append(frames)
        orig(batch, frames)

    b._process = wrapped
    results = {}

    def call(name, text, **kw):
        try:
            results[name] = b.synthesize(text, _spk(s), timeout=120, **kw)
        except BaseException as e:  # noqa: BLE001
            results[name] = e

    with _closing(b):
        t0 = threading.Thread(target=call, args=("stall", "xx"))
        t0.start()
        assert stalled.wait(30)
        ts = [threading.Thread(target=call, args=("short", "ab")),
              threading.Thread(target=call, args=("long", "a" * 14),
                               kwargs={"deadline_s": 60.0})]
        for t in ts:
            t.start()
            time.sleep(0.02)
        time.sleep(0.2)
        release.set()
        for t in [t0, *ts]:
            t.join()
        assert order == [8, 4], order
        assert all(isinstance(v, np.ndarray) for v in results.values()), results


def test_warmup_runs_every_bucket(setup):
    """warmup() runs each ladder rung at each frames bucket on the calling
    thread: one Synthesizer per bucket, each called once per rung."""
    s = setup
    b = tserve.BatchingSynthesizer(s.cfg, s.syn, max_batch=2, frames_buckets=[4, 8])
    seen = []
    orig = b._syn_for

    def counting(frames):
        syn = orig(frames)

        def run(text, spk, seeds):
            seen.append((frames, text.shape[0], threading.current_thread().name))
            return syn(text, spk, seeds)
        return run

    b._syn_for = counting
    with _closing(b):
        b.warmup()
    me = threading.current_thread().name
    assert seen == [(4, 1, me), (4, 2, me), (8, 1, me), (8, 2, me)]
