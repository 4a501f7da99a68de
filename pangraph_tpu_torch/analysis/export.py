"""pypangraph-compatible `export` package surface.

Reference: pypangraph/export/__init__.py re-exports GFA (export/gfa.py — a
minimal, graph-agnostic in-memory GFA1 representation) and
junction_context_gfa (export/junctions_to_gfa.py). This module mirrors that
surface over our analysis layer: `junction_context_gfa` is the existing
junction-bubble builder (analysis/junctions_gfa.py), and `GFA` is the plain
segments+links container with optional per-segment depths and a write-time
length transform for visualization.
"""
from __future__ import annotations


def _orient(strand) -> str:
    """Strand to GFA orientation: truthy/'+' -> '+', else '-'."""
    return "+" if strand in (True, "+") else "-"


class GFA:
    """In-memory GFA1 graph: segments, links, optional per-segment depths.

    segments: {name: length_bp}; links: iterable of (from_name, from_strand,
    to_name, to_strand) with boolean or '+'/'-' strands; depths: optional
    {name: coverage} emitted as a DP:f: tag (Bandage reads it as node depth).
    Sequences are not stored — S lines carry '*' plus an LN:i: length tag
    (reference export/gfa.py semantics).
    """

    def __init__(self, segments: dict, links, depths: dict = None):
        self.segments = segments
        self.links = links
        self.depths = depths or {}

    def write(self, filepath, length_transform=None) -> None:
        """Serialize as minimal GFA1. length_transform optionally rescales
        each emitted LN:i: value (block lengths span orders of magnitude;
        e.g. lambda l: 100 * math.log(l) for visualization); the result is
        rounded and clamped to >= 1. None emits true lengths."""
        from pangraph_tpu_torch.io.files import create_maybe_compressed

        with create_maybe_compressed(filepath, "wt") as f:
            f.write("H\tVN:Z:1.0\n")
            for name, length in self.segments.items():
                ln = int(length) if length_transform is None else max(1, round(length_transform(length)))
                line = f"S\t{name}\t*\tLN:i:{ln}"
                if name in self.depths:
                    line += f"\tDP:f:{self.depths[name]}"
                f.write(line + "\n")
            for from_name, from_strand, to_name, to_strand in self.links:
                f.write(
                    f"L\t{from_name}\t{_orient(from_strand)}"
                    f"\t{to_name}\t{_orient(to_strand)}\t0M\n"
                )


from pangraph_tpu_torch.analysis.junctions_gfa import junction_context_gfa  # noqa: E402

__all__ = ["GFA", "junction_context_gfa"]
