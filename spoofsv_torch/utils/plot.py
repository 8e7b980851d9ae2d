"""matplotlib, where it is installed (the card's machine has none)."""

from __future__ import annotations


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None (printing that the PNG
    is skipped) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print("[plot] matplotlib is not installed: PNG skipped")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
