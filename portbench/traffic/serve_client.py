"""The open-loop load generator of the ``serve`` kind, a child process.

    python3 serve_client.py PORT < schedule.json

The schedule (standard input, JSON): ``{"requests": [[due_s, text, speaker],
...], "timeout_s": T}``, ``due_s`` counted from the generator's start. Each
request is sent at its due time whatever the earlier ones are doing (an
open loop: independent users), on a connection of its own, as ``POST
/synthesize`` ``{"text", "speaker"}``; its latency runs from its due time
to the last byte of the reply. It prints ``ready``, waits for ``go`` on
standard input, then one JSON line a request (``i``, ``due``, ``sent``,
``done``, ``status``, and for a WAV reply its rate, sample count and the
SHA-256 of its 16-bit samples) and a last line ``{"end": true}``.
Standard library only.
"""

import hashlib
import http.client
import io
import json
import sys
import threading
import time
import wave
from concurrent.futures import ThreadPoolExecutor


def one(port: int, i: int, due: float, text: str, speaker: str, t0: float, timeout: float):
    sent = time.perf_counter() - t0
    rec = {"i": i, "due": due, "sent": sent, "status": None}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        body = json.dumps({"text": text, "speaker": speaker})
        conn.request("POST", "/synthesize", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        rec["done"] = time.perf_counter() - t0
        rec["status"] = resp.status
        conn.close()
        if resp.status == 200:
            with wave.open(io.BytesIO(data)) as w:
                pcm = w.readframes(w.getnframes())
                rec.update(sr=w.getframerate(), width=w.getsampwidth(),
                           channels=w.getnchannels(), samples=w.getnframes(),
                           sha256=hashlib.sha256(pcm).hexdigest())
    except Exception as e:   # noqa: BLE001 - a failed request is recorded, not raised
        rec["done"] = time.perf_counter() - t0
        rec["error"] = f"{type(e).__name__}: {e}"
    return rec


def main() -> int:
    port = int(sys.argv[1])
    spec = json.loads(sys.stdin.readline())
    reqs, timeout = spec["requests"], spec["timeout_s"]
    lock = threading.Lock()
    out = []
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    pool = ThreadPoolExecutor(max_workers=512)
    futures = []
    t0 = time.perf_counter()
    for i, (due, text, speaker) in enumerate(reqs):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futures.append(pool.submit(one, port, i, due, text, speaker, t0, timeout))
    for f in futures:
        rec = f.result()
        with lock:
            out.append(rec)
    pool.shutdown(wait=True)
    for rec in sorted(out, key=lambda r: r["i"]):
        print(json.dumps(rec))
    print(json.dumps({"end": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
