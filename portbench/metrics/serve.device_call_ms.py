"""The batcher's device call (``BatchingSynthesizer._device_call``: the
``Synthesizer`` call, the PCM epilogue, the copy to the host), ms a batch:
the difference of ``ServeStats``' ``device_seconds`` over that of
``n_batches`` (``GET /healthz``) across the window."""


def read(view):
    stats = view.extra.get("serve")
    return 1e3 * stats["device_seconds"] / stats["n_batches"] if stats and stats["n_batches"] else None
