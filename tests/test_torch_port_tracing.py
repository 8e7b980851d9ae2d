"""The program's spans and counters (:mod:`spoofsv_torch.utils.profiling`) on the CPU.

A tiny ``Synthesizer`` call, a tiny served request and a tiny training
iteration run under ``trace()``; the spans are read back from the Chrome
trace it writes (each ``spoofsv.<name>`` span with its host start and end)
and from the in-process table (``snapshot()``). The models are those of
``tests/test_torch_port_serve.py``'s tiny configuration (hidden 16,
text-emb 8, SSRN 16, speaker 10, ``max_text_len`` 16, ``max_frame_num`` 8,
GL3), with random weights: only the program's structure is under test.
"""

import dataclasses
import glob
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from spoofsv_torch import serve as tserve
from spoofsv_torch.config import Config
from spoofsv_torch.infer.synthesize import Synthesizer
from spoofsv_torch.models import SSRN, MelSyn
from spoofsv_torch.train.loop import Trainer
from spoofsv_torch.utils import profiling

TINY = dict(hidden_dim=16, text_emb_dim=8, ssrn_dim=16, spk_emb_dim=10, max_text_len=16,
            max_frame_num=8)
SYNTH_SPANS = ("synth.inputs", "decode.encode", "decode.rollout", "ssrn", "vocode.prep",
               "vocode.gl", "vocode.deemph")


@pytest.fixture(scope="module")
def tiny():
    cfg = Config().replace(**TINY)
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, griffin_lim_iters=3))
    torch.manual_seed(0)
    melsyn = MelSyn(cfg.vocab_len, True, cfg.spk_emb_dim, cfg.text_emb_dim, cfg.mel.freq_bins,
                    cfg.hidden_dim)
    ssrn = SSRN(cfg.mel.freq_bins, cfg.lin_bins, cfg.ssrn_dim)
    return cfg, melsyn, ssrn


def _spans(trace_dir) -> list:
    """(name, start us, end us, thread) of every ``spoofsv.`` span in the
    one trace file under ``trace_dir``, by start."""
    path, = glob.glob(os.path.join(str(trace_dir), "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"][len(profiling.PREFIX):], e["ts"], e["ts"] + e["dur"], e["tid"])
                  for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(profiling.PREFIX))


def _inside(spans, outer: str) -> list:
    """The names of the spans inside the first ``outer`` span, by start."""
    _, s0, e0, tid = next(s for s in spans if s[0] == outer)
    return [n for n, s, e, t in sorted(spans, key=lambda s: s[1])
            if t == tid and s0 <= s and e <= e0 and n != outer]


def test_synthesizer_call_nests_its_stage_spans_in_order(tiny, tmp_path):
    cfg, melsyn, ssrn = tiny
    syn = Synthesizer(cfg, melsyn, ssrn, n_frames=cfg.max_frame_num, gl_iters=3)
    rng = np.random.default_rng(0)
    text = rng.integers(1, cfg.vocab_len - 1, (3, cfg.max_text_len)).astype(np.int32)
    spk = rng.normal(size=(3, cfg.spk_emb_dim)).astype(np.float32)
    seeds = torch.arange(3, dtype=torch.int32)
    syn(text, spk, seeds)          # the first call packs the decode weights
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        audio, _, _ = syn(text, spk, seeds)
    assert audio.shape[0] == 3
    spans = _spans(tmp_path)
    assert _inside(spans, "synth.call") == list(SYNTH_SPANS)
    snap = profiling.snapshot()
    assert snap["counters"]["h2d_bytes"] == text.nbytes + spk.nbytes + seeds.numel() * 4
    assert "decode.pack" not in snap["spans"]
    assert all(snap["spans"][n]["count"] == 1 for n in ("synth.call",) + SYNTH_SPANS)


def test_served_request_spans_share_one_batch_id(tiny, tmp_path):
    cfg, melsyn, ssrn = tiny
    syn = Synthesizer(cfg, melsyn, ssrn, n_frames=cfg.max_frame_num, gl_iters=3)
    batcher = tserve.BatchingSynthesizer(cfg, syn, max_batch=2, batch_wait_ms=1.0,
                                         trim_db=None)
    httpd = tserve.make_http_server(batcher, tserve.SpeakerTable(""))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = json.dumps({"text": "a short one", "spk_emb": [0.1] * cfg.spk_emb_dim}).encode()
    profiling.reset()
    try:
        # the batcher's thread and the handler's start before the trace
        with profiling.trace(str(tmp_path)):
            with urllib.request.urlopen(url + "/synthesize", body, timeout=60) as r:
                assert r.status == 200 and r.read(4) == b"RIFF"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    server.join(timeout=10)
    assert not server.is_alive()
    names = {n for n, _, _, _ in _spans(tmp_path)}
    assert {"serve.parse", "serve.wait", "serve.encode", "serve.send", "serve.collect",
            "serve.device_call", "serve.finalize", "synth.call", "synth.to_host"} <= names
    snap = profiling.snapshot()["spans"]
    assert snap["serve.device_call"]["args"] == {"batch": 1, "rows": 1, "rung": 1}
    assert snap["serve.finalize"]["args"] == {"batch": 1}
    assert batcher.stats.device_seconds == snap["serve.device_call"]["total_s"] > 0
    assert health["trace"]["spans"]["serve.device_call"]["count"] == 1
    assert health["trace"]["counters"]["d2h_bytes"] > 0


@pytest.mark.parametrize("adversarial", [False, True])
def test_train_iteration_nests_its_phase_spans(tiny, tmp_path, adversarial):
    cfg, _, _ = tiny
    cfg = cfg.replace(src_root_dir=str(tmp_path) + "/")
    from spoofsv_torch.cli.main import build_models

    torch.manual_seed(0)
    melsyn, _, mel_disc, _ = build_models(cfg, device="cpu")
    trainer = Trainer(cfg, melsyn, "train_text2mel", adversarial=adversarial,
                      disc_model=mel_disc if adversarial else None, validate_with_decode=False,
                      ctime="t")
    rng = np.random.default_rng(0)
    batch = {"mel": rng.uniform(0.05, 0.95, (2, 8, cfg.mel.freq_bins)).astype(np.float32),
             "text": rng.integers(1, cfg.vocab_len - 1, (2, 16)).astype(np.int32),
             "spk": rng.normal(size=(2, cfg.spk_emb_dim)).astype(np.float32)}
    with profiling.trace(str(tmp_path / "trace")):
        trainer.fit(lambda: iter([batch]), max_iterations=1)
    trainer.close()
    spans = _spans(tmp_path / "trace")
    assert _inside(spans, "train.step") == ["train.forward", "train.backward", "train.optimizer"]
    assert [n for n, _, _, _ in sorted(spans, key=lambda s: s[1])
            if n in ("train.place", "train.step", "train.metrics_sync")] == \
        ["train.place", "train.step", "train.metrics_sync"]
