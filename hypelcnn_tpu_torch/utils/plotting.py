"""matplotlib for the utilities' figures, where it is installed.

The card's machine has no matplotlib; a utility there says which figure it
did not write and goes on, as ``gan/validation.py``'s ``plot_overall_info``
does.
"""

from __future__ import annotations


def pyplot(path: str):
    """``matplotlib.pyplot`` on the Agg backend, or ``None`` after one line
    naming the figure ``path`` that is not written."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {path} not written")
        return None
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt
