"""The micro-batcher's 95th-percentile latency, ms: ``ServeStats``'
enqueue-to-done times (``GET /healthz``'s ``latency_ms_p95``, over the
batcher's latest 1000 requests), at the end of the window. What the
client sees beyond it is the HTTP front end's and the connection's."""


def read(view):
    stats = view.extra.get("serve")
    return None if not stats or stats.get("latency_ms_p95") is None else stats["latency_ms_p95"]
