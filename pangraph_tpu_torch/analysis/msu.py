"""Minimal synteny units: mergers of co-traveling backbone blocks
(reference: pypangraph/minimal_synteny_units.py)."""
from __future__ import annotations

from collections import defaultdict

from pangraph_tpu_torch.analysis.topology import Walk, filter_walks, find_mergers, pangraph_to_walks


def core_paths(an_graph, L_thr: int) -> dict:
    bdf = an_graph.to_blockstats_df()
    walks = pangraph_to_walks(an_graph)

    def is_core(bid):
        row = bdf.loc[bid]
        return int(row["len"]) >= L_thr and bool(row["core"])

    return filter_walks(walks, is_core)


def flip_msu_to_most_common_orientation(paths: dict) -> dict:
    orient = defaultdict(int)
    for p in paths.values():
        for ob in p.oriented_blocks:
            orient[ob.id] += 1 if ob.strand else -1
    for iso, p in paths.items():
        flipped = [ob.invert() if orient[ob.id] < 0 else ob for ob in p.oriented_blocks]
        paths[iso] = Walk(flipped, p.circular)
    return paths


def minimal_synteny_units(an_graph, L_thr: int, rotate: bool = True):
    """Returns (mergers {block id -> MSU name}, {iso -> MSU Walk},
    {MSU name -> length})."""
    c_paths = core_paths(an_graph, L_thr)
    mergers = find_mergers(c_paths)

    b_len = an_graph.to_blockstats_df()["len"].to_dict()
    msu_len = defaultdict(int)
    for bid, msu in mergers.items():
        msu_len[msu] += int(b_len[bid])

    order = sorted(msu_len, key=msu_len.get, reverse=True)
    msu_paths = filter_walks(c_paths, lambda x: x in order)
    ids = {msu: f"MSU_{i}" for i, msu in enumerate(order)}
    msu_len = {ids[m]: msu_len[m] for m in order}
    msu_paths = {iso: p.rename_bids(ids) for iso, p in msu_paths.items()}
    msu_mergers = {src: ids[sink] for src, sink in mergers.items()}

    if rotate:
        if not all(p.circular for p in msu_paths.values()):
            raise ValueError("Only circular paths can be rotated")
        focal = max(msu_len, key=msu_len.get)
        msu_paths = {iso: p.rotate_to(focal, True) for iso, p in msu_paths.items()}

    flip_msu_to_most_common_orientation(msu_paths)
    return msu_mergers, msu_paths, msu_len
