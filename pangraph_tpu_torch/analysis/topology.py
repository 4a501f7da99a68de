"""Block-graph topology utilities (reference: pypangraph/topology_utils.py)."""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass


@dataclass(frozen=True)
class OrientedBlock:
    """Block id + strandedness (strand True == '+')."""

    id: object
    strand: bool

    def invert(self) -> "OrientedBlock":
        return OrientedBlock(self.id, not self.strand)

    def __invert__(self):
        return self.invert()

    def to_str_id(self) -> str:
        return f"{self.id}_{'f' if self.strand else 'r'}"

    @staticmethod
    def from_str_id(t: str) -> "OrientedBlock":
        bid, s = t.rsplit("_", 1)
        try:
            bid = int(bid)
        except ValueError:
            pass
        return OrientedBlock(bid, s == "f")


class Walk:
    """Ordered traversal of oriented blocks."""

    def __init__(self, oriented_blocks=None, circular=None):
        self.oriented_blocks = list(oriented_blocks or [])
        self.circular = circular

    def invert(self) -> "Walk":
        return Walk([ob.invert() for ob in reversed(self.oriented_blocks)], self.circular)

    def __invert__(self):
        return self.invert()

    def __eq__(self, o):
        return isinstance(o, Walk) and self.oriented_blocks == o.oriented_blocks

    def __hash__(self):
        return hash(tuple(self.oriented_blocks))

    def __len__(self):
        return len(self.oriented_blocks)

    def __repr__(self):
        return " ".join(f"[{ob.id}|{'+' if ob.strand else '-'}]" for ob in self.oriented_blocks)

    def rotate_to(self, bid, strand: bool) -> "Walk":
        if not self.circular:
            raise ValueError("Walk is not circular")
        target = OrientedBlock(bid, strand)
        if target in self.oriented_blocks:
            i = self.oriented_blocks.index(target)
            return Walk(self.oriented_blocks[i:] + self.oriented_blocks[:i], True)
        inv = self.invert()
        if target not in inv.oriented_blocks:
            raise ValueError(f"Block {bid} not in walk")
        i = inv.oriented_blocks.index(target)
        return Walk(inv.oriented_blocks[i:] + inv.oriented_blocks[:i], True)

    def rename_bids(self, mapping: dict) -> "Walk":
        return Walk([OrientedBlock(mapping[ob.id], ob.strand) for ob in self.oriented_blocks], self.circular)

    def edges(self) -> list:
        obs = self.oriented_blocks
        es = [Edge(a, b) for a, b in zip(obs, obs[1:])]
        if self.circular and len(obs) > 1:
            es.append(Edge(obs[-1], obs[0]))
        return es


@dataclass(frozen=True)
class Edge:
    """Oriented link between oriented blocks; orientation-insensitive equality."""

    left: OrientedBlock
    right: OrientedBlock

    def invert(self) -> "Edge":
        return Edge(self.right.invert(), self.left.invert())

    def __invert__(self):
        return self.invert()

    def __eq__(self, o):
        if not isinstance(o, Edge):
            return NotImplemented
        inv = o.invert()
        return (self.left == o.left and self.right == o.right) or (
            self.left == inv.left and self.right == inv.right
        )

    def __hash__(self):
        a = hash((self.left, self.right))
        inv = self.invert()
        b = hash((inv.left, inv.right))
        return a ^ b

    def _natural_str_id(self) -> str:
        return "__".join([self.left.to_str_id(), self.right.to_str_id()])

    def is_canonical(self) -> bool:
        return self._natural_str_id() <= self.invert()._natural_str_id()

    def to_str_id(self) -> str:
        return self._natural_str_id() if self.is_canonical() else self.invert()._natural_str_id()

    @staticmethod
    def from_str_id(t: str) -> "Edge":
        left, right = t.split("__")
        return Edge(OrientedBlock.from_str_id(left), OrientedBlock.from_str_id(right))


def pangraph_to_walks(graph) -> dict:
    """{path name -> Walk} over a core Pangraph or AnalysisGraph."""
    g = getattr(graph, "graph", graph)
    res = {}
    for path in g.paths.values():
        obs = [
            OrientedBlock(g.nodes[nid].block_id, g.nodes[nid].strand == "+") for nid in path.nodes
        ]
        name = path.name if path.name is not None else path.id
        res[name] = Walk(obs, path.circular)
    return res


def filter_walks(walks: dict, keep_f) -> dict:
    return {
        iso: Walk([ob for ob in w.oriented_blocks if keep_f(ob.id)], w.circular) for iso, w in walks.items()
    }


def walk_categories(walks: dict) -> list:
    """[(count, oriented_blocks, isolates)] per distinct non-empty walk,
    sorted by count descending."""
    iso_list = defaultdict(list)
    counts = defaultdict(int)
    obs_of = {}
    for iso, w in walks.items():
        if len(w):
            counts[w] += 1
            iso_list[w].append(iso)
            obs_of[w] = w.oriented_blocks
    cats = [(c, obs_of[w], iso_list[w]) for w, c in counts.items()]
    cats.sort(key=lambda x: x[0], reverse=True)
    return cats


def walk_edge_count(walks: dict) -> dict:
    ct = Counter()
    for w in walks.values():
        ct.update(w.edges())
    return dict(ct)


def walk_block_count(walks: dict) -> dict:
    ct = Counter()
    for w in walks.values():
        for ob in w.oriented_blocks:
            ct[ob.id] += 1
    return dict(ct)


def find_mergers(walks: dict) -> dict:
    """Union-find of blocks that are always adjacent (co-traveling) across all
    walks: edge count == both endpoint block counts."""
    edge_ct = walk_edge_count(walks)
    block_ct = walk_block_count(walks)
    parent = {bid: bid for bid in block_ct}

    def find(b):
        root = b
        while parent[root] != root:
            root = parent[root]
        while parent[b] != root:
            parent[b], b = root, parent[b]
        return root

    for e, ec in edge_ct.items():
        bl, br = e.left.id, e.right.id
        if ec == block_ct[bl] and ec == block_ct[br]:
            parent[find(bl)] = find(br)
    return {bid: find(bid) for bid in block_ct}
