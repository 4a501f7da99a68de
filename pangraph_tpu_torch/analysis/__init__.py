"""Analysis layer: the pypangraph-equivalent API over graph JSON files.

Reference: packages/pypangraph (class_graph.py, topology_utils.py, junctions/,
minimal_synteny_units.py). Load a graph with `AnalysisGraph.load_json`, then
use dataframes, walks, junction decomposition and minimal synteny units.
"""
from pangraph_tpu_torch.analysis.graph import AnalysisGraph
from pangraph_tpu_torch.analysis.topology import Edge, OrientedBlock, Walk, pangraph_to_walks
from pangraph_tpu_torch.analysis.junctions import BackboneJunctions, Junction, path_junction_split
from pangraph_tpu_torch.analysis.msu import minimal_synteny_units

__all__ = [
    "AnalysisGraph",
    "OrientedBlock",
    "Walk",
    "Edge",
    "pangraph_to_walks",
    "Junction",
    "path_junction_split",
    "BackboneJunctions",
    "minimal_synteny_units",
]
