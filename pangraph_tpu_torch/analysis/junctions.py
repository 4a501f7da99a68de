"""Junction decomposition: accessory segments between backbone anchors.

Reference: pypangraph/junctions/ (junction.py, backbone.py, stats.py,
positions.py, sequences.py). Backbone = core blocks with consensus length >=
L_thr; each path splits into junctions flanked by backbone blocks (circular
wrap merges the trailing segment into the first junction).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

from pangraph_tpu_torch.analysis.topology import Edge, OrientedBlock, Walk
from pangraph_tpu_torch.graph.seq import revcomp, to_str


class JunctionNode(OrientedBlock):
    """OrientedBlock carrying its node id (equality on block+strand only)."""

    def __new__(cls, bid, strand, node_id):
        return super().__new__(cls)

    def __init__(self, bid, strand, node_id):
        object.__setattr__(self, "id", bid)
        object.__setattr__(self, "strand", strand)
        object.__setattr__(self, "node_id", node_id)

    def invert(self):
        return JunctionNode(self.id, not self.strand, self.node_id)


@dataclass
class Junction:
    """Accessory segment `center` flanked by backbone blocks `left`/`right`
    (None flanks for terminal junctions on linear paths)."""

    left: OrientedBlock
    center: Walk
    right: OrientedBlock

    def invert(self) -> "Junction":
        return Junction(
            self.right.invert() if self.right is not None else None,
            self.center.invert(),
            self.left.invert() if self.left is not None else None,
        )

    def flanking_edge(self):
        if self.left is None or self.right is None:
            return None
        return Edge(self.left, self.right)

    def oriented_blocks(self) -> list:
        """left + center + right flattened, skipping None flanks
        (junction.py oriented_blocks)."""
        out = []
        if self.left is not None:
            out.append(self.left)
        out.extend(self.center.oriented_blocks)
        if self.right is not None:
            out.append(self.right)
        return out

    def is_canonical(self) -> bool:
        e = self.flanking_edge()
        if e is None:
            raise ValueError("Terminal junction has no flanking edge")
        return e.is_canonical()

    def to_canonical(self) -> "Junction":
        return self if self.is_canonical() else self.invert()

    def __eq__(self, o):
        if not isinstance(o, Junction):
            return NotImplemented
        inv = o.invert()
        return (self.left == o.left and self.center == o.center and self.right == o.right) or (
            self.left == inv.left and self.center == inv.center and self.right == inv.right
        )

    def __hash__(self):
        inv = self.invert()
        return hash((self.left, self.center, self.right)) ^ hash((inv.left, inv.center, inv.right))


def path_junction_split(path: Walk, is_core) -> list:
    """Split a walk into junctions at core boundaries (junction.py:140-176)."""
    n_core = sum(1 for ob in path.oriented_blocks if is_core(ob.id))
    if n_core < 2:
        raise ValueError(f"path has {n_core} core block(s); at least 2 required")
    junctions = []
    current = []
    left = None
    for ob in path.oriented_blocks:
        if is_core(ob.id):
            junctions.append(Junction(left, Walk(current, circular=False), ob))
            left = ob
            current = []
        else:
            current.append(ob)
    if path.circular:
        j0 = junctions[0]
        j0.left = left
        j0.center = Walk(current + j0.center.oriented_blocks, circular=False)
    elif current or left is not None:
        junctions.append(Junction(left, Walk(current, circular=False), None))
    return junctions


class BackboneJunctions:
    """Per-edge junction analysis (backbone.py)."""

    def __init__(self, an_graph, L_thr: int = 500):
        self.g = an_graph
        self.L_thr = L_thr
        self._bdf = an_graph.to_blockstats_df()
        self._junctions = None
        self._edge_map = None

    def _is_backbone(self, bid) -> bool:
        row = self._bdf.loc[bid]
        return bool(row["core"]) and int(row["len"]) >= self.L_thr

    def _ensure_split(self):
        if self._junctions is not None:
            return
        self._junctions = {}
        self._edge_map = {}
        core = self.g.graph
        for path in core.paths.values():
            name = path.name if path.name is not None else path.id
            obs = [
                JunctionNode(core.nodes[nid].block_id, core.nodes[nid].strand == "+", nid)
                for nid in path.nodes
            ]
            juncs = path_junction_split(Walk(obs, path.circular), self._is_backbone)
            self._junctions[name] = juncs
            for j in juncs:
                e = j.flanking_edge()
                if e is None:
                    continue
                self._edge_map.setdefault(e.to_str_id(), {})[name] = j

    def edges(self) -> list:
        self._ensure_split()
        return list(self._edge_map)

    def __getitem__(self, edge_str):
        self._ensure_split()
        return self._edge_map[edge_str]

    def __contains__(self, edge_str):
        self._ensure_split()
        return edge_str in self._edge_map

    def junctions_by_isolate(self) -> dict:
        self._ensure_split()
        return self._junctions

    def stats(self):
        """Per-edge stats dataframe (stats.py): counts, category diversity,
        core flank lengths, accessory length."""
        import pandas as pd

        self._ensure_split()
        rows = {}
        lens = self._bdf["len"]
        for edge_str, iso_map in self._edge_map.items():
            centers = [
                (j.to_canonical().center if j.flanking_edge() is not None else j.center) for j in iso_map.values()
            ]
            cats = Counter(tuple(c.oriented_blocks) for c in centers)
            non_empty = sum(1 for c in centers if len(c))
            # unique accessory content across isolates (stats.py:57-63 — a
            # block traversed by many isolates or duplicated in one counts
            # its length once)
            acc_len = sum(int(lens[bid]) for bid in {ob.id for c in centers for ob in c.oriented_blocks})
            n_majority = max(cats.values()) if cats else 0
            e = Edge.from_str_id(edge_str)
            rows[edge_str] = {
                "n_isolates": len(iso_map),
                "n_non_empty": non_empty,
                "n_categories": len(cats),
                "n_majority_category": n_majority,
                # stats.py:50-51: transitive = a single (possibly non-empty)
                # category; singleton = exactly one isolate deviates
                "is_transitive": len(cats) == 1,
                "is_singleton": len(iso_map) > 1 and n_majority == len(iso_map) - 1,
                "left_core_length": int(lens[e.left.id]),
                "right_core_length": int(lens[e.right.id]),
                "accessory_length": acc_len,
            }
        df = pd.DataFrame.from_dict(rows, orient="index")
        return df.sort_values("n_isolates", ascending=False)

    def positions(self):
        """MultiIndex (edge, iso) frame of flank genomic positions + strand
        (positions.py)."""
        import pandas as pd

        self._ensure_split()
        core = self.g.graph
        rows = []
        for edge_str, iso_map in self._edge_map.items():
            for iso, j in iso_map.items():
                # left/right follow each genome's OWN path order; `strand`
                # records whether that order matches the canonical edge
                # orientation (positions.py:10-14)
                ln = core.nodes[j.left.node_id]
                rn = core.nodes[j.right.node_id]
                rows.append(
                    {
                        "edge": edge_str,
                        "iso": iso,
                        "left_start": ln.position[0],
                        "left_end": ln.position[1],
                        "right_start": rn.position[0],
                        "right_end": rn.position[1],
                        "strand": j.is_canonical(),
                    }
                )
        df = pd.DataFrame(rows)
        if df.empty:
            return df  # no edges (e.g. an empty graph) — positions.py:44-45
        return df.set_index(["edge", "iso"])

    def sequences(self, edge_str: str) -> dict:
        """{isolate -> co-oriented sequence string} spanning left flank start
        to right flank end (sequences.py)."""
        self._ensure_split()
        core = self.g.graph
        out = {}
        if edge_str not in self._edge_map:
            return out  # unknown edge: empty, like the reference's []
        for iso, j in self._edge_map[edge_str].items():
            cj = j.to_canonical()
            parts = []
            for ob in [cj.left, *cj.center.oriented_blocks, cj.right]:
                node = core.nodes[ob.node_id]
                block = core.blocks[node.block_id]
                seq = block.alignments[ob.node_id].apply(block.consensus)
                # bring into junction orientation
                if not ob.strand:
                    seq = revcomp(seq)
                parts.append(to_str(seq))
            out[iso] = "".join(parts)
        return out
