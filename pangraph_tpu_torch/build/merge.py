"""Pairwise graph merging: join, iterated self-merge, transitive-edge removal.

Reference: pangraph/graph_merging.rs. The per-iteration pipeline is:
find matches between block consensuses -> drop self-hits -> split at long
indels -> energy filter + greedy non-overlap acceptance -> reweave -> resolve
merge promises (the batched alignment workload) -> detach unaligned nodes ->
reconsensus.
"""
from __future__ import annotations

import logging

from pangraph_tpu_torch.align.alignment import Alignment, alignment_energy
from pangraph_tpu_torch.build.circularize import remove_transitive_edges
from pangraph_tpu_torch.build.reconsensus import detach_unaligned_nodes, reconsensus_graph
from pangraph_tpu_torch.build.reweave import reweave
from pangraph_tpu_torch.build.split_matches import split_matches
from pangraph_tpu_torch.graph.graph import Pangraph, graph_join
from pangraph_tpu_torch.utils import trace
from pangraph_tpu_torch.utils.intervals import have_no_overlap

log = logging.getLogger(__name__)


def filter_matches(alns: list, args) -> list:
    """Energy filter (E < 0), sort ascending, greedy non-overlap acceptance
    (graph_merging.rs:187-216)."""
    scored = [(alignment_energy(a, args), i, a) for i, a in enumerate(alns)]
    scored = [(e, i, a) for e, i, a in scored if e < 0.0]
    scored.sort(key=lambda t: (t[0], t[1]))

    accepted = []
    intervals = {}
    for _, _, aln in scored:
        assert aln.qry.name != aln.reff.name
        if have_no_overlap(intervals.get(aln.reff.name, []), aln.reff.interval) and have_no_overlap(
            intervals.get(aln.qry.name, []), aln.qry.interval
        ):
            accepted.append(aln)
            intervals.setdefault(aln.reff.name, []).append(aln.reff.interval)
            intervals.setdefault(aln.qry.name, []).append(aln.qry.interval)
    return accepted


def solve_promises(promises: list, args, aligner=None) -> list:
    """Resolve all merge promises, batching every re-alignment job of the
    round into one aligner call (the reference parallelizes with rayon,
    graph_merging.rs:144-151; here the batch is the device-level axis)."""
    if aligner is None or not hasattr(aligner, "align_many"):
        return [p.solve(args, aligner) for p in promises]

    from pangraph_tpu_torch.ops.batch_align import AlignJob

    all_jobs = []
    owners = []
    presolved_list = []
    job_lists = []
    for pi, p in enumerate(promises):
        jobs, presolved = p.collect_jobs()
        presolved_list.append(presolved)
        job_lists.append(jobs)
        for node_id, seq, band, hint, segments in jobs:
            all_jobs.append(AlignJob(p.anchor_block.consensus, seq, band, hint, segments))
            owners.append((pi, node_id))
    edits = aligner.align_many(all_jobs) if all_jobs else []
    results = [dict(pre) for pre in presolved_list]
    for (pi, node_id), e in zip(owners, edits):
        results[pi][node_id] = e
    return [p.finish(results[pi]) for pi, p in enumerate(promises)]


def self_merge(graph: Pangraph, args, find_matches, aligner=None, pair_cache=None):
    """One merge iteration (graph_merging.rs:97-174). Returns (graph, changed)."""
    with trace.span("find_matches"):
        if pair_cache is not None and getattr(find_matches, "supports_pair_cache", False):
            matches = find_matches(graph.blocks, args.aln_args, pair_cache=pair_cache)
        else:
            matches = find_matches(graph.blocks, args.aln_args)
    log.debug("found %d matches", len(matches))

    with trace.span("merge.split_filter"):
        split = []
        for m in matches:
            if m.qry.name == m.reff.name:
                continue
            split.extend(split_matches(m, args.aln_args.indel_len_threshold))
        log.debug("matches after splitting: %d", len(split))

        accepted = filter_matches(split, args.aln_args)
    log.debug("matches after filtering: %d", len(accepted))
    if not accepted:
        return graph, False

    with trace.span("reweave"):
        graph, promises = reweave(accepted, graph, args.aln_args.indel_len_threshold)

    with trace.span("solve_promises"):
        merged_blocks = solve_promises(promises, args, aligner)

    detach_unaligned_nodes(merged_blocks, graph.nodes)
    for block in merged_blocks:
        assert block.id not in graph.blocks, f"conflicting block id {block.id}"
        graph.blocks[block.id] = block

    merge_ids = [b.id for b in merged_blocks]
    with trace.span("reconsensus"):
        reconsensus_graph(graph, merge_ids, args, aligner)
    return graph, True


def merge_graphs(left: Pangraph, right: Pangraph, args, find_matches, aligner=None) -> Pangraph:
    """Merge two graphs: join then self-merge to fixpoint
    (graph_merging.rs:26-72)."""
    with trace.span("merge.graph_join"):
        graph = graph_join(left, right)
    i = 0
    # round-over-round pair cache, scoped to this merge's fixpoint loop:
    # later rounds re-map a mostly-unchanged block set; both-unchanged pairs
    # replay their previous chain alignments instead of re-anchoring and
    # re-running the banded DP (map_all_vs_all pair_cache docstring)
    pair_cache = {}
    while True:
        with trace.span("self_merge"):
            graph, changed = self_merge(graph, args, find_matches, aligner, pair_cache=pair_cache)
        if not changed:
            break
        if i >= args.max_self_map:
            log.warning("reached max self-merge iterations (%d)", args.max_self_map)
            break
        i += 1
    with trace.span("remove_transitive_edges"):
        remove_transitive_edges(graph)
    if __debug__:
        graph.sanity_check()
    return graph
