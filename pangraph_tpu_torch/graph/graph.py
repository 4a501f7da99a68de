"""Pangenome graph containers: blocks, nodes, paths.

Reference data model:
- `Pangraph{paths, blocks, nodes}` keyed by u64 ids (`pangraph/pangraph.rs:22-26`)
- `PangraphBlock{id, consensus, alignments: {node_id: Edit}}` (`pangraph_block.rs:41-46`)
- `PangraphNode{id, block_id, path_id, strand, position}` (`pangraph_node.rs:19-25`)
- `PangraphPath{id, nodes, tot_len, circular, name, desc}` (`pangraph_path.rs:14-33`)

Host-side dict-of-dataclass representation; the JSON wire format is byte-level
compatible with the reference schema (pangraph-schemas/Pangraph.schema.json) so
pypangraph-style analysis tools work unchanged.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from pangraph_tpu_torch.graph.edits import Edit
from pangraph_tpu_torch.graph.seq import as_seq, revcomp, to_str
from pangraph_tpu_torch.utils import trace
from pangraph_tpu_torch.utils.ids import content_id

FWD = "+"
REV = "-"


def flip(strand: str) -> str:
    return REV if strand == FWD else FWD


@dataclass
class Node:
    id: int
    block_id: int
    path_id: int
    strand: str  # '+' or '-'
    position: tuple  # (start, end) on the genome, half-open, circular wrap allowed

    @staticmethod
    def create(block_id, path_id, strand, position, node_id=None) -> "Node":
        # content-hash id when absent (pangraph_node.rs:45)
        if node_id is None:
            node_id = content_id("node", block_id, path_id, strand, position[0], position[1])
        return Node(node_id, block_id, path_id, strand, tuple(position))


@dataclass
class Path:
    id: int
    nodes: list  # ordered node ids
    tot_len: int
    circular: bool
    name: str = None
    desc: str = None


@dataclass
class Block:
    id: int
    consensus: np.ndarray  # uint8 ASCII
    alignments: dict  # node_id -> Edit

    def __post_init__(self):
        self.consensus = as_seq(self.consensus)

    @staticmethod
    def from_consensus(consensus, block_id: int, node_id: int) -> "Block":
        return Block(block_id, as_seq(consensus), {node_id: Edit.empty()})

    def depth(self) -> int:
        return len(self.alignments)

    def consensus_len(self) -> int:
        return len(self.consensus)

    def reverse_complement(self) -> "Block":
        # pangraph_block.rs:63-76
        L = self.consensus_len()
        aln = {nid: e.reverse_complement(L) for nid, e in self.alignments.items()}
        return Block(self.id, revcomp(self.consensus), aln)

    def is_duplicated(self, graph: "Pangraph") -> bool:
        pids = [graph.nodes[nid].path_id for nid in self.alignments]
        return len(pids) != len(set(pids))

    # ---- majority edits for reconsensus (pangraph_block.rs:192-256) ----
    def is_majority(self, count: int) -> bool:
        return count > self.depth() // 2

    def find_majority_substitutions(self) -> list:
        from pangraph_tpu_torch.graph.edits import Sub

        pos_l, alt_l = [], []
        for e in self.alignments.values():
            if e.subs:
                pos_l.append(np.fromiter((s.pos for s in e.subs), np.int64, len(e.subs)))
                alt_l.append(np.fromiter((ord(s.alt) for s in e.subs), np.int64, len(e.subs)))
        if not pos_l:
            return []
        pos = np.concatenate(pos_l)
        alt = np.concatenate(alt_l)
        uk, counts = np.unique(pos * 256 + alt, return_counts=True)
        upos, ualt = uk >> 8, uk & 255
        # per position keep the (count, alt)-max entry: sort by (pos, count,
        # alt) and take the last row of each pos group (ties -> larger alt,
        # matching max(kv, key=(count, alt)))
        order = np.lexsort((ualt, counts, upos))
        upos, ualt, counts = upos[order], ualt[order], counts[order]
        last = np.concatenate([upos[1:] != upos[:-1], [True]])
        sel = last & (counts > self.depth() // 2)
        return [Sub(int(p), chr(int(a))) for p, a in zip(upos[sel], ualt[sel])]

    def find_majority_deletions(self) -> list:
        from pangraph_tpu_torch.graph.edits import Del

        L = self.consensus_len()
        starts, ends = [], []
        for e in self.alignments.values():
            for d in e.dels:
                starts.append(d.pos)
                ends.append(min(d.end, L))
        if not starts:
            return []
        # endpoint sweep: coverage is piecewise-constant between deletion
        # endpoints, so scan the O(K) distinct endpoints instead of a
        # length-L difference array (blocks are Mbp-scale, K is small)
        s = np.sort(np.array(starts, dtype=np.int64))
        t = np.sort(np.array(ends, dtype=np.int64))
        events = np.unique(np.concatenate([s, t]))
        cov = np.searchsorted(s, events, side="right") - np.searchsorted(t, events, side="right")
        maj = cov > self.depth() // 2
        if not maj.any():
            return []
        out = []
        cur_s = cur_e = None
        for i in np.flatnonzero(maj):
            a, b = int(events[i]), int(events[i + 1]) if i + 1 < len(events) else L
            if cur_e == a:
                cur_e = b
            else:
                if cur_s is not None:
                    out.append(Del(cur_s, cur_e - cur_s))
                cur_s, cur_e = a, b
        out.append(Del(cur_s, cur_e - cur_s))
        return out

    def find_majority_insertions(self) -> list:
        from collections import Counter
        from pangraph_tpu_torch.graph.edits import Ins

        counts = Counter()
        for e in self.alignments.values():
            for i in e.inss:
                counts[(i.pos, i.seq)] += 1
        out = [Ins(pos, seq) for (pos, seq), c in sorted(counts.items()) if self.is_majority(c)]
        return out

    def find_majority_edits(self) -> Edit:
        return Edit(
            subs=self.find_majority_substitutions(),
            dels=self.find_majority_deletions(),
            inss=self.find_majority_insertions(),
        )

    def change_consensus_nucleotide_at_pos(self, sub) -> None:
        """Flip one consensus char and reconcile all alignments
        (pangraph_block.rs:260-293)."""
        self.apply_majority_substitutions([sub])

    def apply_majority_substitutions(self, subs: list) -> None:
        """Flip many consensus chars and reconcile every alignment in one
        pass per node (batch form of pangraph_block.rs:260-293; positions are
        distinct per the majority vote)."""
        if not subs:
            return
        L = self.consensus_len()
        originals = []
        self.consensus = self.consensus.copy()
        for sub in subs:
            if sub.pos >= L:
                raise ValueError(f"Position {sub.pos} out of bounds")
            original = chr(int(self.consensus[sub.pos]))
            if original == sub.alt:
                raise ValueError(f"Consensus already has {sub.alt!r} at {sub.pos}")
            originals.append(original)
            self.consensus[sub.pos] = ord(sub.alt)
        for e in self.alignments.values():
            e.reconcile_substitutions_with_consensus(subs, originals)


@dataclass
class GraphUpdate:
    """Splice-replacement of one block's nodes in all paths (pangraph.rs:296+)."""

    b_old_id: int
    b_new: list = field(default_factory=list)  # new Blocks
    n_new: dict = field(default_factory=dict)  # old node id -> [new Nodes] in path order


class Pangraph:
    """The pangenome graph: {paths, blocks, nodes} (pangraph.rs:22-26)."""

    def __init__(self, paths: dict = None, blocks: dict = None, nodes: dict = None):
        self.paths = paths or {}
        self.blocks = blocks or {}
        self.nodes = nodes or {}

    # ------------------------------------------------------------ constructors
    @staticmethod
    def singleton(name: str, seq, index: int, circular: bool, strand: str = FWD, desc=None) -> "Pangraph":
        # pangraph.rs:29-50; node spans whole path, (0,0) if circular
        seq = as_seq(seq)
        tot_len = len(seq)
        node_id = block_id = path_id = index
        position = (0, 0) if circular else (0, tot_len)
        block = Block.from_consensus(seq, block_id, node_id)
        node = Node.create(block_id, path_id, strand, position, node_id=node_id)
        path = Path(path_id, [node_id], tot_len, circular, name, desc)
        g = Pangraph()
        g.paths[path_id] = path
        g.blocks[block_id] = block
        g.nodes[node_id] = node
        return g

    # ---------------------------------------------------------------- queries
    def core_block_ids(self) -> list:
        # pangraph.rs:236-257: present exactly once in every path
        path_ids = set(self.paths)
        out = []
        for bid, block in self.blocks.items():
            pids = [self.nodes[nid].path_id for nid in block.alignments]
            if set(pids) == path_ids and len(pids) == len(set(pids)):
                out.append(bid)
        return out

    def newick_name(self) -> str:
        """Label for a guide-tree clade holding this graph: its named paths
        joined with '|', or None if no path is named (pangraph.rs:280-283)."""
        names = [p.name for p in self.paths.values() if p.name]
        return "|".join(names) if names else None

    def path_id_by_name(self, name: str) -> int:
        for pid, p in self.paths.items():
            if p.name == name:
                return pid
        raise KeyError(f"Path {name!r} not found")

    # ---------------------------------------------------------------- updates
    def update(self, u: GraphUpdate) -> None:
        """Apply a block-split update (pangraph.rs:68-107)."""
        old_from_graph = set(self.blocks[u.b_old_id].alignments)
        old_from_update = set(u.n_new)
        assert old_from_graph == old_from_update, "old node set mismatch in GraphUpdate"

        del self.blocks[u.b_old_id]
        for b in u.b_new:
            assert b.id not in self.blocks, f"conflicting block id {b.id}"
            self.blocks[b.id] = b

        for old_nid, new_nodes in u.n_new.items():
            path = self.paths[self.nodes[old_nid].path_id]
            idx = path.nodes.index(old_nid)
            path.nodes[idx : idx + 1] = [n.id for n in new_nodes]
            del self.nodes[old_nid]
            for n in new_nodes:
                self.nodes[n.id] = n

    def remove_path(self, pid: int) -> None:
        # pangraph.rs:110-133
        path = self.paths.pop(pid, None)
        if path is not None:
            for nid in path.nodes:
                node = self.nodes.pop(nid, None)
                if node is not None:
                    block = self.blocks.get(node.block_id)
                    if block is not None:
                        block.alignments.pop(nid, None)
        for bid in [bid for bid, b in self.blocks.items() if not b.alignments]:
            del self.blocks[bid]

    # ----------------------------------------------------------------- checks
    def sanity_check(self) -> None:
        """Cross-reference + positional-contiguity invariants (pangraph.rs:135-234)."""
        for nid, node in self.nodes.items():
            if node.block_id not in self.blocks:
                raise AssertionError(f"Block {node.block_id} not found")
            if node.path_id not in self.paths:
                raise AssertionError(f"Path {node.path_id} not found")
            if nid not in self.blocks[node.block_id].alignments:
                raise AssertionError(f"Node {nid} not in block {node.block_id}")
            if nid not in self.paths[node.path_id].nodes:
                raise AssertionError(f"Node {nid} not in path {node.path_id}")
        for bid, block in self.blocks.items():
            if not block.alignments:
                raise AssertionError(f"Block {bid} has no nodes")
            for nid in block.alignments:
                if nid not in self.nodes:
                    raise AssertionError(f"Node {nid} not in graph")
        for pid, path in self.paths.items():
            for nid in path.nodes:
                if nid not in self.nodes:
                    raise AssertionError(f"Node {nid} from path {pid} not in graph")
            if path.nodes:
                prev = self.nodes[path.nodes[0]].position[1]
                for nid in path.nodes[1:]:
                    pos = self.nodes[nid].position[0]
                    if pos != prev:
                        raise AssertionError(f"Node {nid} in path {pid}: position {pos} != previous end {prev}")
                    prev = self.nodes[nid].position[1]
                if path.circular:
                    first = self.nodes[path.nodes[0]].position[0]
                    last = self.nodes[path.nodes[-1]].position[1]
                    if first != last:
                        raise AssertionError(f"Circular path {pid}: first start {first} != last end {last}")

    # -------------------------------------------------------------------- json
    def to_json_dict(self) -> dict:
        paths = {
            str(pid): {
                "id": pid,
                "nodes": list(p.nodes),
                "tot_len": p.tot_len,
                "circular": p.circular,
                "name": p.name,
                "desc": p.desc,
            }
            for pid, p in sorted(self.paths.items())
        }
        blocks = {
            str(bid): {
                "id": bid,
                "consensus": to_str(b.consensus),
                "alignments": {str(nid): e.to_json() for nid, e in sorted(b.alignments.items())},
            }
            for bid, b in sorted(self.blocks.items())
        }
        nodes = {
            str(nid): {
                "id": nid,
                "block_id": n.block_id,
                "path_id": n.path_id,
                "strand": n.strand,
                "position": list(n.position),
            }
            for nid, n in sorted(self.nodes.items())
        }
        return {"paths": paths, "blocks": blocks, "nodes": nodes}

    def to_json(self, indent=2) -> str:
        with trace.span("graph.to_json"):
            return json.dumps(self.to_json_dict(), indent=indent) + "\n"

    @staticmethod
    def from_json_dict(d: dict) -> "Pangraph":
        g = Pangraph()
        for pd in d["paths"].values():
            g.paths[pd["id"]] = Path(
                pd["id"], list(pd["nodes"]), pd["tot_len"], pd["circular"], pd.get("name"), pd.get("desc")
            )
        for bd in d["blocks"].values():
            aln = {int(nid): Edit.from_json(e) for nid, e in bd["alignments"].items()}
            g.blocks[bd["id"]] = Block(bd["id"], as_seq(bd["consensus"]), aln)
        for nd in d["nodes"].values():
            g.nodes[nd["id"]] = Node(
                nd["id"], nd["block_id"], nd["path_id"], nd["strand"], tuple(nd["position"])
            )
        return g

    @staticmethod
    def from_json(text: str) -> "Pangraph":
        return Pangraph.from_json_dict(json.loads(text))

    @staticmethod
    def from_file(path) -> "Pangraph":
        from pangraph_tpu_torch.io.files import open_maybe_compressed

        with open_maybe_compressed(path, "rt") as f:
            return Pangraph.from_json(f.read())

    def to_file(self, path) -> None:
        from pangraph_tpu_torch.io.files import create_maybe_compressed

        with create_maybe_compressed(path, "wt") as f:
            f.write(self.to_json())


def graph_join(left: Pangraph, right: Pangraph) -> Pangraph:
    """Disjoint union of two graphs (graph_merging.rs:74-93)."""
    for k in left.blocks.keys() & right.blocks.keys():
        raise ValueError(f"Conflicting block id {k}")
    for k in left.paths.keys() & right.paths.keys():
        raise ValueError(f"Conflicting path id {k}")
    for k in left.nodes.keys() & right.nodes.keys():
        raise ValueError(f"Conflicting node id {k}")
    return Pangraph(
        paths={**left.paths, **right.paths},
        blocks={**left.blocks, **right.blocks},
        nodes={**left.nodes, **right.nodes},
    )


def reconstruct_path_sequence(graph: Pangraph, path: Path) -> np.ndarray:
    """Lossless inverse: rebuild one genome (reconstruct_run.rs:78-120)."""
    if not path.nodes:
        return as_seq("")
    parts = []
    for nid in path.nodes:
        node = graph.nodes[nid]
        block = graph.blocks[node.block_id]
        s = block.alignments[nid].apply(block.consensus)
        if node.strand == REV:
            s = revcomp(s)
        parts.append(s)
    genome = np.concatenate(parts) if parts else as_seq("")
    if len(genome) != path.tot_len:
        raise ValueError(f"Reconstructed length {len(genome)} != expected {path.tot_len}")
    first_start = graph.nodes[path.nodes[0]].position[0]
    if first_start:
        genome = np.roll(genome, first_start)
    return genome


def reconstruct(graph: Pangraph):
    """Yield (name, desc, seq) for every path, sorted by path id
    (reconstruct_run.rs:56-76)."""
    for pid in sorted(graph.paths):
        path = graph.paths[pid]
        name = path.name if path.name is not None else f"Unknown sequence #{pid}"
        yield name, path.desc, reconstruct_path_sequence(graph, path)
