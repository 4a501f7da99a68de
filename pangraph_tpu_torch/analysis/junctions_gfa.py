"""Junction-bubble GFA export.

Decomposes a pangenome graph into per-junction bubbles hung between core
anchor blocks, so accessory variation renders as clean bubbles instead of a
tangle. Output conventions are kept compatible with the reference
pypangraph's ``export/junctions_to_gfa.py`` (reimplementation, not a port):
accessory segments are paralog-split per junction and named
``J{n}__{block_id}``; core anchors keep their bare block id and appear once
globally; ``RC``/``LN`` tags carry depth and length.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field


@dataclass
class JunctionGfa:
    """A junction-context decomposition, accumulated walk by walk.

    ``segments`` maps segment name -> consensus length; ``depths`` maps
    name -> coverage (graph-wide occurrence count for core anchors, junction
    traversal count for accessory copies); ``links`` holds oriented segment
    adjacencies as ((name, strand), (name, strand)) pairs; ``prefixes`` maps
    each ``J{n}`` tag back to the canonical core-edge id it represents.
    """

    segments: dict = field(default_factory=dict)
    depths: Counter = field(default_factory=Counter)
    links: set = field(default_factory=set)
    prefixes: dict = field(default_factory=dict)

    def add_walk(self, steps) -> None:
        """Record one junction traversal: steps = [(name, strand, length, core_count)].
        Core anchors pass core_count (their graph-wide depth); accessory
        copies pass None and are depth-counted by traversal."""
        oriented = []
        for name, strand, length, core_count in steps:
            self.segments[name] = length
            if core_count is None:
                self.depths[name] += 1
            else:
                self.depths[name] = core_count
            oriented.append((name, strand))
        self.links.update(zip(oriented, oriented[1:]))

    def gfa_lines(self):
        yield "H\tVN:Z:1.0"
        for name in sorted(self.segments):
            yield f"S\t{name}\t*\tLN:i:{self.segments[name]}\tRC:i:{self.depths[name]}"
        for (n1, s1), (n2, s2) in sorted(self.links, key=lambda l: (str(l[0][0]), str(l[1][0]))):
            o = {True: "+", "+": "+"}
            yield f"L\t{n1}\t{o.get(s1, '-')}\t{n2}\t{o.get(s2, '-')}\t*"

    def write(self, path) -> None:
        from pangraph_tpu_torch.io.files import create_maybe_compressed

        with create_maybe_compressed(path, "wt") as f:
            for line in self.gfa_lines():
                f.write(line + "\n")


def _kept_edges(bj, policy: str) -> list:
    """Canonical core-edge ids selected by the scaffold policy, sorted so the
    ``J{n}`` numbering is deterministic.

    ``"all"`` keeps every junction edge present in ``bj``. Otherwise each
    isolate's backbone (its genome purified to core blocks >= L_thr, via
    ``core_paths``) votes with its edge set: ``"consensus"`` keeps edges on a
    strict majority of backbones, and an isolate name keeps exactly that
    isolate's backbone edges. Selected edges absent from ``bj`` are dropped.
    """
    from pangraph_tpu_torch.analysis.msu import core_paths

    present = set(bj.edges())
    if policy == "all":
        return sorted(present)
    ballots = {
        iso: frozenset(e.to_str_id() for e in walk.edges())
        for iso, walk in core_paths(bj.g, bj.L_thr).items()
    }
    if policy == "consensus":
        tally = Counter(e for votes in ballots.values() for e in votes)
        chosen = {e for e, v in tally.items() if 2 * v > len(ballots)}
    elif policy in ballots:
        chosen = ballots[policy]
    else:
        raise ValueError(
            f"unknown scaffold {policy!r}: expected 'consensus', 'all', or an isolate "
            f"name from {sorted(ballots)}"
        )
    return sorted(chosen & present)


def build_junction_gfa(bj, scaffold: str = "consensus") -> JunctionGfa:
    """Build the junction-context decomposition of ``bj`` (a BackboneJunctions
    view) under the given scaffold policy."""
    stats = bj.g.to_blockstats_df()
    length_of = stats["len"].to_dict()
    count_of = stats["count"].to_dict()
    out = JunctionGfa()
    for n, edge in enumerate(_kept_edges(bj, scaffold)):
        tag = f"J{n}"
        out.prefixes[tag] = edge
        for junction in bj[edge].values():
            cj = junction.to_canonical()
            anchors = {cj.left.id, cj.right.id}
            out.add_walk(
                [
                    (
                        str(ob.id) if ob.id in anchors else f"{tag}__{ob.id}",
                        ob.strand,
                        int(length_of[ob.id]),
                        int(count_of[ob.id]) if ob.id in anchors else None,
                    )
                    for ob in (cj.left, *cj.center.oriented_blocks, cj.right)
                ]
            )
    return out


# -- compatibility wrappers (the tuple-based surface predating JunctionGfa) --


def junction_context_gfa(bj, scaffold: str = "consensus"):
    """Compat shim: returns (segments, links, depths, prefix_map) with links
    as 4-tuples, as the original function did."""
    jg = build_junction_gfa(bj, scaffold)
    links = {(n1, s1, n2, s2) for (n1, s1), (n2, s2) in jg.links}
    return jg.segments, links, dict(jg.depths), jg.prefixes


def write_junction_gfa(path, segments, links, depths) -> None:
    """Compat shim: serialize a tuple-based decomposition as GFA v1."""
    jg = JunctionGfa(segments=dict(segments), depths=Counter(depths))
    jg.links = {((n1, s1), (n2, s2)) for n1, s1, n2, s2 in links}
    jg.write(path)
