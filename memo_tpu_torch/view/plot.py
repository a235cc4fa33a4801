"""Conservation visualization (``memo view``).

Reimplements the reference's plotnine stacked-bar conservation plot
(reference plot_conservation.py) with matplotlib, preserving the exact
binning math and visual design:

- ``n_bins+1`` integer linspace edges over positions
  (plot_conservation.py:48-52); per-bin value counts normalized to
  proportions (:55-58); fully-conserved positions (value == n) dropped (:65).
- Stacked bars of width 1, y in [0,1], fill gradient #000000 -> #c6dbef with
  limits (1, n-1) (:80-84), Tufte-like minimal theme (:21-37), default
  500 bins / 600 dpi (view.sh:9-10).

The port's own copy of :mod:`memo_tpu.view.plot`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

import numpy as np

_LOW = np.array([0x00, 0x00, 0x00], dtype=float) / 255.0
_HIGH = np.array([0xC6, 0xDB, 0xEF], dtype=float) / 255.0


def bin_conservation(values: np.ndarray, n_docs: int, n_bins: int) -> np.ndarray:
    """Per-bin proportion of positions at each conservation value.

    Returns float array ``[n_bins, n_docs+1]`` — row b = normalized counts of
    values 0..n in bin b (the reference's per-bin Counter,
    plot_conservation.py:46-58). Bin edges are ``int(linspace(0, P, n_bins+1))``
    exactly as the reference computes them.
    """
    values = np.asarray(values, np.int64)
    P = values.shape[0]
    edges = np.linspace(0, P, n_bins + 1).astype(np.int64)
    # One flat bincount over (bin, value) pairs instead of a Python loop per
    # bin: bin index per position comes from repeating each bin's length.
    lens = np.diff(edges)
    bin_idx = np.repeat(np.arange(n_bins, dtype=np.int64), lens)
    width = n_docs + 1
    clipped = np.minimum(values, width - 1)  # guard flat-index overflow
    if np.any(clipped != values) or np.any(values < 0):
        raise ValueError(f"conservation values outside 0..{n_docs}")
    counts = np.bincount(bin_idx * width + clipped, minlength=n_bins * width)
    counts = counts.reshape(n_bins, width).astype(float)
    totals = counts.sum(axis=1, keepdims=True)
    # Empty bins stay 0 (the reference would divide by zero there).
    return np.divide(counts, totals, out=np.zeros_like(counts), where=totals > 0)


def _gradient_color(order: int, n_docs: int) -> np.ndarray:
    """Linear #000000 -> #c6dbef over limits (1, n-1)
    (plot_conservation.py:80-84)."""
    lo, hi = 1, max(n_docs - 1, 1)
    t = 0.0 if hi == lo else (np.clip(order, lo, hi) - lo) / (hi - lo)
    return _LOW + t * (_HIGH - _LOW)


def _gradient_colors(n_docs: int) -> np.ndarray:
    """float[n_docs, 3] gradient row per order 0..n_docs-1."""
    return np.stack([_gradient_color(o, n_docs) for o in range(n_docs)])


def plot_conservation(values: np.ndarray, n_docs: int, n_bins: int):
    """Build the figure; returns (fig, ax)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    props = bin_conservation(values, n_docs, n_bins)
    x = np.arange(n_bins)

    fig, ax = plt.subplots(figsize=(20, 4))
    # Stack orders descending so high conservation sits at the bottom; the
    # fully-conserved value n is not drawn (plot_conservation.py:65). All
    # segments render as ONE PolyCollection — identical geometry to per-order
    # ax.bar patches (width-1 rectangles on the same stack boundaries), but
    # one artist instead of n_bins*n_docs Rectangle patches, which dominated
    # render time (~10 s -> <1 s at the 500-bin default).
    drawn = props[:, :n_docs]
    tops = np.cumsum(drawn[:, ::-1], axis=1)[:, ::-1]  # stack bottom-up from high orders
    bottoms = tops - drawn
    bi, oi = np.nonzero(drawn > 0)  # skip zero-height segments like bar() drew them
    if bi.size:
        x0, x1 = x[bi] - 0.5, x[bi] + 0.5
        y0, y1 = bottoms[bi, oi], tops[bi, oi]
        verts = np.stack(
            [
                np.stack([x0, y0], axis=1),
                np.stack([x1, y0], axis=1),
                np.stack([x1, y1], axis=1),
                np.stack([x0, y1], axis=1),
            ],
            axis=1,
        )
        from matplotlib.collections import PolyCollection

        colors = _gradient_colors(n_docs)[oi]
        ax.add_collection(
            PolyCollection(verts, facecolors=colors, edgecolors="none", linewidths=0)
        )

    ax.set_title("K-mer Conservation", fontsize=18)
    ax.set_xlabel(f"Genomic bin (n ={n_bins})", fontsize=18)
    ax.set_ylabel("Proportion of\nconserved k-mers", fontsize=18)
    ax.set_ylim(0, 1)
    ax.set_xlim(-0.5, n_bins - 0.5)
    ax.set_yticks(np.linspace(0, 1, 5), labels=["0", "0.25", "0.50", "0.75", "1"])
    from matplotlib.ticker import MaxNLocator

    ax.xaxis.set_major_locator(MaxNLocator(integer=True))  # bins are integers
    # Tufte-like theme: no grid, no panel, black axis lines
    # (plot_conservation.py:21-37).
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color("black")
        ax.spines[side].set_linewidth(1)
    ax.tick_params(colors="black", labelsize=14)
    ax.set_facecolor("white")
    fig.patch.set_facecolor("white")

    # Colorbar standing in for plotnine's gradient legend.
    from matplotlib.cm import ScalarMappable
    from matplotlib.colors import LinearSegmentedColormap, Normalize

    cmap = LinearSegmentedColormap.from_list("memo", [_LOW, _HIGH])
    sm = ScalarMappable(norm=Normalize(1, max(n_docs - 1, 2)), cmap=cmap)
    cbar = fig.colorbar(sm, ax=ax, fraction=0.03, pad=0.01)
    cbar.set_label("No. Genomes", fontsize=14)
    fig.tight_layout()
    return fig, ax


def save_conservation_plot(
    in_path: str, out_path: str, n_docs: int, n_bins: int = 500, dpi: int = 600
) -> None:
    """File-to-file view command (defaults from reference view.sh:9-10)."""
    try:
        import pandas as pd  # C parser: ~20x np.loadtxt on Mbp-scale inputs

        values = pd.read_csv(in_path, header=None, dtype=np.int64).to_numpy().ravel()
    except Exception:  # empty file or exotic whitespace: keep loadtxt semantics
        values = np.loadtxt(in_path, dtype=np.int64, ndmin=1)
    fig, _ = plot_conservation(values, n_docs, n_bins)
    fig.savefig(out_path, dpi=dpi)
    import matplotlib.pyplot as plt

    plt.close(fig)
