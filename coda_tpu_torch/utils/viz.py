"""Debug visualization: bar charts of P(best) and regret curves
(counterpart of ``coda_tpu/utils/viz.py``).

Host-side only: figures are rendered after a run, from host arrays. The
CLI's ``--debug-viz`` logs them as PNG artifacts of the tracking store.
matplotlib is imported when a figure is drawn (Agg backend, headless);
where it is not installed, drawing raises ``ImportError`` naming it.
"""

from __future__ import annotations

import io

import numpy as np


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend; ``ImportError`` naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "--debug-viz draws its figures with matplotlib, which is not "
            "installed here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_bar(values, title: str = "", highlight: int | None = None,
             xlabel: str = "", ylabel: str = ""):
    """Bar chart of a 1-D score vector -> matplotlib Figure.

    ``highlight`` draws one bar (e.g. the argmax / chosen model) in a
    distinct color, like the reference's chosen-bar styling.
    """
    plt = _pyplot()

    values = np.asarray(values)
    colors = ["tab:blue"] * len(values)
    if highlight is not None:
        colors[int(highlight)] = "tab:orange"
    fig, ax = plt.subplots(figsize=(max(4, len(values) * 0.35), 3))
    ax.bar(np.arange(len(values)), values, color=colors)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    return fig


def plot_series(series, title: str = "", xlabel: str = "step",
                ylabel: str = "", labels=None):
    """Line plot of one or more per-step traces (e.g. regret curves)."""
    plt = _pyplot()

    arr = np.atleast_2d(np.asarray(series))
    fig, ax = plt.subplots(figsize=(5, 3))
    for i, row in enumerate(arr):
        ax.plot(np.arange(1, len(row) + 1), row,
                label=None if labels is None else labels[i])
    if labels is not None:
        ax.legend(fontsize=8)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    return fig


def fig_to_png(fig) -> bytes:
    """Rasterize a figure to PNG bytes (for artifact logging)."""
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=120)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return buf.getvalue()
