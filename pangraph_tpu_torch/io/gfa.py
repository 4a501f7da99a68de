"""GFA v1 export (reference: io/gfa.rs:79-262).

S-lines per block (tags RC:i depth*len, LN:i len, TP:Z:duplicated), L-lines
from oriented path adjacencies in canonical orientation with RC:i edge counts,
P-lines per path with TP:Z:circular; filters by length/depth/duplication.
"""
from __future__ import annotations

from dataclasses import dataclass

from pangraph_tpu_torch.build.circularize import Edge, SimpleNode, path_edges
from pangraph_tpu_torch.graph.graph import Pangraph
from pangraph_tpu_torch.graph.seq import to_str


@dataclass
class GfaParams:
    minimum_length: int = None
    maximum_length: int = None
    minimum_depth: int = None
    maximum_depth: int = None
    include_sequences: bool = False
    no_duplicated: bool = False


def _block_passes(graph: Pangraph, block, p: GfaParams) -> bool:
    L = block.consensus_len()
    d = block.depth()
    if p.minimum_length is not None and L < p.minimum_length:
        return False
    if p.maximum_length is not None and L > p.maximum_length:
        return False
    if p.minimum_depth is not None and d < p.minimum_depth:
        return False
    if p.maximum_depth is not None and d > p.maximum_depth:
        return False
    if p.no_duplicated and block.is_duplicated(graph):
        return False
    return True


def gfa_lines(graph: Pangraph, params: GfaParams = None):
    p = params or GfaParams()
    keep = {bid for bid, b in graph.blocks.items() if _block_passes(graph, b, p)}

    yield "H\tVN:Z:1.0"
    if keep:
        yield "# blocks"
    for bid in sorted(keep):
        b = graph.blocks[bid]
        seq = to_str(b.consensus) if p.include_sequences else "*"
        dup = "\tTP:Z:duplicated" if b.is_duplicated(graph) else ""
        yield f"S\t{bid}\t{seq}\tRC:i:{b.depth() * b.consensus_len()}\tLN:i:{b.consensus_len()}{dup}"

    # edges from path adjacencies (filtered to kept blocks)
    counts = {}
    for path in graph.paths.values():
        for e in path_edges(graph, path):
            if e.n1.bid in keep and e.n2.bid in keep:
                k = e.key()
                if k in counts:
                    counts[k] = (counts[k][0], counts[k][1] + 1)
                else:
                    counts[k] = (e, 1)
    rows = sorted(
        ((e.canonical(), rc) for e, rc in counts.values()), key=lambda t: t[0].to_tuple()
    )
    if rows:
        yield "# edges"
    for e, rc in rows:
        yield f"L\t{e.n1.bid}\t{e.n1.strand}\t{e.n2.bid}\t{e.n2.strand}\t*\tRC:i:{rc}"

    paths = [p_ for p_ in graph.paths.values()]
    if paths:
        yield "# paths"
    for path in paths:
        segs = []
        for nid in path.nodes:
            n = graph.nodes[nid]
            if n.block_id in keep:
                segs.append(f"{n.block_id}{n.strand}")
        circ = "\tTP:Z:circular" if path.circular else ""
        name = path.name if path.name is not None else str(path.id)
        yield f"P\t{name}\t{','.join(segs)}\t*{circ}"


def gfa_write(graph: Pangraph, file_or_path, params: GfaParams = None) -> None:
    from pangraph_tpu_torch.io.files import create_maybe_compressed

    close = False
    f = file_or_path
    if isinstance(file_or_path, (str, bytes)) or hasattr(file_or_path, "__fspath__") or file_or_path is None:
        f = create_maybe_compressed(file_or_path, "wt")
        close = True
    try:
        for line in gfa_lines(graph, params):
            f.write(line + "\n")
    finally:
        if close and f is not None and getattr(f, "name", "") != "<stdout>":
            f.close()
