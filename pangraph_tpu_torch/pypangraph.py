"""pypangraph-compatible facade over the analysis layer.

Lets code written against the reference's Python package
(`import pypangraph; pan = pypangraph.Pangraph.from_json(path)`) run with a
one-line change (`from pangraph_tpu_torch import pypangraph`). The underlying
objects are the pangraph_tpu_torch analysis classes; graph JSON files are
interchangeable (tests/test_schema_compat.py pins schema equality).

Reference surface: pypangraph/__init__.py (Pangraph, PangraphLoadError,
minimal_synteny_units, dotplot, junctions, export).
"""
from __future__ import annotations

from pangraph_tpu_torch.analysis.graph import AnalysisGraph
from pangraph_tpu_torch.analysis.msu import minimal_synteny_units
from pangraph_tpu_torch.analysis.plots import block_dotplot as dotplot
from pangraph_tpu_torch.analysis import junctions
# export mirrors the reference package surface: GFA (plain in-memory GFA1,
# reference pypangraph/export/gfa.py) + junction_context_gfa
from pangraph_tpu_torch.analysis import export


class PangraphLoadError(Exception):
    pass


class Pangraph(AnalysisGraph):
    """AnalysisGraph with the pypangraph classmethod/naming conventions."""

    @staticmethod
    def from_json(filename, validate: bool = True) -> "Pangraph":
        name = str(filename)
        if not (name.endswith(".json") or name.endswith(".json.gz")):
            raise PangraphLoadError(f"the input file {filename} should be in .json or .json.gz format")
        try:
            g = AnalysisGraph.load_json(filename, validate=validate)
        except PangraphLoadError:
            raise
        except Exception as ex:  # noqa: BLE001 - mirror reference error wrapping
            raise PangraphLoadError(f"failed to load pangraph from {filename}: {ex}") from ex
        out = Pangraph.__new__(Pangraph)
        out.__dict__.update(g.__dict__)
        return out


__all__ = [
    "Pangraph",
    "PangraphLoadError",
    "minimal_synteny_units",
    "dotplot",
    "junctions",
    "export",
]
