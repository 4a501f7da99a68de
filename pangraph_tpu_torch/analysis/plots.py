"""Plotting helpers (reference: pypangraph/plots/dotplot.py,
linear_junction_plot.py). Matplotlib is optional; functions raise a clear
error if it is unavailable."""
from __future__ import annotations

import numpy as np

from pangraph_tpu_torch.graph.seq import to_str


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("plotting requires matplotlib, which is not installed") from e


def block_dotplot(an_graph, strain_x: str, strain_y: str, ax=None):
    """Dot plot of shared blocks between two strains, colored by strand
    agreement."""
    plt = _plt()
    g = an_graph.graph
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))

    def occurrences(strain):
        path = an_graph.path_by_name(strain)
        out = {}
        for nid in path.nodes:
            n = g.nodes[nid]
            out.setdefault(n.block_id, []).append(n)
        return out

    occ_x = occurrences(strain_x)
    occ_y = occurrences(strain_y)
    for bid in occ_x.keys() & occ_y.keys():
        for nx in occ_x[bid]:
            for ny in occ_y[bid]:
                xs, xe = nx.position
                ys, ye = ny.position
                same = nx.strand == ny.strand
                if not same:
                    ys, ye = ye, ys
                ax.plot([xs, xe], [ys, ye], color="C0" if same else "C3", lw=1.2)
    ax.set_xlabel(strain_x)
    ax.set_ylabel(strain_y)
    ax.set_title("block dotplot")
    return ax


def linear_junction_plot(bj, edge_str: str, ax=None):
    """Linear layout of one junction across isolates: core flanks and
    accessory blocks as colored segments."""
    plt = _plt()
    self_g = bj.g.graph
    lens = bj._bdf["len"]
    iso_map = bj[edge_str]
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 0.5 * len(iso_map) + 1))
    color_of = {}

    def color(bid):
        if bid not in color_of:
            color_of[bid] = f"C{len(color_of) % 10}"
        return color_of[bid]

    for row, (iso, j) in enumerate(sorted(iso_map.items())):
        cj = j.to_canonical()
        x = 0
        for ob in [cj.left, *cj.center.oriented_blocks, cj.right]:
            L = int(lens[ob.id])
            is_flank = ob in (cj.left, cj.right)
            ax.barh(
                row,
                L,
                left=x,
                height=0.6,
                color="lightgray" if is_flank else color(ob.id),
                edgecolor="black",
                linewidth=0.3,
            )
            x += L
    ax.set_yticks(range(len(iso_map)))
    ax.set_yticklabels(sorted(iso_map))
    ax.set_xlabel("position (bp)")
    ax.set_title(f"junction {edge_str}")
    return ax
