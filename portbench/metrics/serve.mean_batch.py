"""Requests a batch in the window: the difference of ``ServeStats``'
``n_requests`` over that of ``n_batches`` (``GET /healthz``) across the
window."""


def read(view):
    stats = view.extra.get("serve")
    return stats["n_requests"] / stats["n_batches"] if stats and stats["n_batches"] else None
