"""All-vs-all consensus mapper: sketch -> index -> anchors -> chain -> extend.

Replaces the reference's vendored minimap2 (L0/L1/L2 of SURVEY.md §1; entry
align/minimap2_lib/align_with_minimap2_lib.rs). Design differences, TPU-first:

- the index is a sorted minimizer array + searchsorted lookup (no hash table),
- chains are cut at large diagonal jumps, so base-level alignment of a chain
  span is a single banded stripe DP (the same K3 kernel used for re-alignment)
  instead of per-anchor-pair ksw2 extension,
- every chain-span alignment of one self-map round is batched into one device
  call in the TPU path.

Sensitivity presets map to minimap2's asm5/10/20 (options.c:116-130): k=19,
w=19 (asm20: w=10), bw=1000, max_gap=10000; pangraph sets min chain score
max(l-10, 5) (align_with_minimap2_lib.rs:49-57).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pangraph_tpu_torch.align.alignment import Alignment, Hit
from pangraph_tpu_torch.align.chain import ChainParams, chain_anchors, split_chain_at_jumps
from pangraph_tpu_torch.align.cigar import cigar_from_aligned_pair, collapse_cigar
from pangraph_tpu_torch.align.minimizer import Minimizers, sketch_cached as sketch
from pangraph_tpu_torch.align.params import BandedAlignParams
from pangraph_tpu_torch.align.stripe import align_banded
from pangraph_tpu_torch.graph.seq import GAP, as_seq, revcomp

U64 = np.uint64


@dataclass
class MapperParams:
    k: int = 19
    w: int = 19
    max_gap: int = 10_000
    bw: int = 1_000
    min_chain_score: int = 90  # max(indel_len_threshold - 10, 5)
    min_anchors: int = 3
    mid_occ_frac: float = 2e-4
    max_occ_floor: int = 10
    extend_flank: int = 0  # extra bases beyond anchor span
    band_extra: int = 16  # band margin around anchor diagonal spread
    diag_break: int = 5_000  # cut chains at diagonal jumps >= this
    # hit post-processing (minimap2 hit.c defaults; see align/hits.py)
    mask_level: float = 0.5  # query-overlap fraction grouping hits (mm_set_parent)
    pri_ratio: float = 0.8  # secondaries below this fraction of primary are dropped
    best_n: int = 5  # max secondaries kept per primary (mm_select_sub)
    sdust_thres: int = 0  # DUST mask threshold; 0 = off (minimap2 default)

    @staticmethod
    def from_sensitivity(sensitivity: int, indel_len_threshold: int, kmer_length=None) -> "MapperParams":
        p = MapperParams()
        if sensitivity == 20:
            p.w = 10
        elif sensitivity not in (5, 10):
            raise ValueError(f"Unknown sensitivity preset: {sensitivity}")
        if kmer_length:
            p.k = kmer_length
        p.min_chain_score = max(indel_len_threshold - 10, 5)
        return p


@dataclass
class MinimizerIndex:
    """Sorted minimizer array over a set of named sequences."""

    values: np.ndarray  # sorted uint64
    seq_ids: np.ndarray  # int32 index into names
    positions: np.ndarray  # int64 k-mer start
    strands: np.ndarray  # uint8
    names: list
    lengths: np.ndarray
    max_occ: int
    # equal-value run of each entry (for the all-vs-all self-join: a query's
    # matches are exactly its own entries' runs — the index contains every
    # query, so no per-query searchsorted is needed)
    run_start: np.ndarray = None  # int64 per entry
    run_size: np.ndarray = None  # int64 per entry
    # entries grouped by seq id IN SKETCH ORDER: sid_order[bounds[i]:bounds[i+1]]
    # are sequence i's sorted-array slots, ordered by its own sketch positions
    # (the pre-sort concatenation is grouped by sequence, so this is the
    # inverse permutation of the value sort — no second argsort needed, and
    # sketch order is round-stable for an unchanged sketch regardless of how
    # other sequences shuffle the value ties, which is exactly what the
    # pair-cache occupancy masks need)
    sid_order: np.ndarray = None  # int64: concat position -> sorted slot
    sid_bounds: np.ndarray = None  # per-seq boundaries into concat order

    def entries_of(self, qi: int) -> np.ndarray:
        return self.sid_order[self.sid_bounds[qi] : self.sid_bounds[qi + 1]]


def build_index(seqs: list, names: list, p: MapperParams) -> MinimizerIndex:
    vals, sids, poss, strs = [], [], [], []
    lengths = np.zeros(len(seqs), dtype=np.int64)
    for i, s in enumerate(seqs):
        s = as_seq(s)
        lengths[i] = len(s)
        mm: Minimizers = sketch(s, p.k, p.w)
        vv, pp, ss = mm.values, mm.positions, mm.strands
        if p.sdust_thres > 0:
            from pangraph_tpu_torch.align.hits import dust_mask, filter_minimizers_by_mask

            keep = filter_minimizers_by_mask(pp, p.k, dust_mask(s, p.sdust_thres))
            vv, pp, ss = vv[keep], pp[keep], ss[keep]
        vals.append(vv)
        sids.append(np.full(len(vv), i, dtype=np.int32))
        poss.append(pp)
        strs.append(ss)
    values = np.concatenate(vals) if vals else np.zeros(0, dtype=U64)
    seq_ids = np.concatenate(sids) if sids else np.zeros(0, dtype=np.int32)
    positions = np.concatenate(poss) if poss else np.zeros(0, dtype=np.int64)
    strands = np.concatenate(strs) if strs else np.zeros(0, dtype=np.uint8)
    sid_bounds_list = [len(v) for v in vals]
    # native path: C++ radix sort + run structure + inverse permutation +
    # occurrence cutoff in one GIL-released call (the index is rebuilt every
    # merge round; this pass was ~3 s of the headline build in numpy)
    if len(values):
        from pangraph_tpu_torch.native import index_build_native

        nat = index_build_native(
            values, seq_ids, positions, strands, p.mid_occ_frac, p.max_occ_floor
        )
        if nat is not None:
            values, seq_ids, positions, strands, run_start, run_size, sid_order, max_occ = nat
            sid_bounds = np.concatenate(([0], np.cumsum(sid_bounds_list, dtype=np.int64)))
            return MinimizerIndex(
                values, seq_ids, positions, strands, list(names), lengths, max_occ,
                run_start, run_size, sid_order, sid_bounds,
            )
    # numpy fallback (also the native path's parity reference).
    # quicksort, not stable: within-run tie order is free to be arbitrary —
    # run membership/keep status depends only on the run, chaining lexsorts
    # its anchors, and the per-seq entry lists below use sketch order via
    # the inverse permutation.
    order = np.argsort(values, kind="quicksort")
    values, seq_ids, positions, strands = values[order], seq_ids[order], positions[order], strands[order]
    # equal-value runs + per-sequence entry lists (self-join support)
    n = len(values)
    if n:
        new_run = np.concatenate(([True], np.diff(values) != 0))
        run_id = np.cumsum(new_run) - 1
        starts = np.flatnonzero(new_run)
        sizes = np.bincount(run_id)
        run_start = starts[run_id]
        run_size = sizes[run_id]
        # inverse permutation: concat position -> sorted slot. The concat is
        # grouped by sequence, so per-seq slices of `inv` are the entry
        # lists (in sketch order) — no argsort over seq_ids needed.
        sid_order = np.empty(n, dtype=np.int64)
        sid_order[order] = np.arange(n, dtype=np.int64)
        sid_bounds = np.concatenate(
            ([0], np.cumsum([len(v) for v in vals], dtype=np.int64))
        )
    else:
        run_start = run_size = np.zeros(0, dtype=np.int64)
        sid_order = np.zeros(0, dtype=np.int64)
        sid_bounds = np.zeros(len(names) + 1, dtype=np.int64)
    # occurrence cutoff (mid_occ): drop the most frequent minimizers.
    # Exactly minimap2's mm_idx_cal_max_occ semantics (index.c:186-206):
    # the (1-f) k-smallest of the per-DISTINCT-minimizer occurrence counts,
    # plus one; max_occ_floor mirrors minimap2's min_mid_occ clamp
    # (options.c mm_mapopt_update). The per-distinct counts are the run
    # sizes of the sorted value array — no second sort (np.unique) needed.
    if n:
        a = np.sort(sizes)
        idx = min(int((1.0 - p.mid_occ_frac) * len(a)), len(a) - 1)
        max_occ = max(int(a[idx]) + 1, p.max_occ_floor)
    else:
        max_occ = p.max_occ_floor
    return MinimizerIndex(
        values, seq_ids, positions, strands, list(names), lengths, max_occ,
        run_start, run_size, sid_order, sid_bounds,
    )


def collect_anchors_self(index: MinimizerIndex, qi: int, skip_unchanged: np.ndarray = None):
    """All-vs-all anchors for sequence qi via the index self-join: the query
    IS in the index (same sketch), so its matches are exactly the other
    entries of its own equal-value runs — no searchsorted, no re-sketch.
    Applies the occurrence cutoff (run size <= max_occ) and -X semantics
    (keep rid < qi only). Returns (rid, rpos, qpos, rel) like
    collect_anchors; anchor ORDER differs but chaining lexsorts internally,
    so downstream results are identical.

    skip_unchanged (bool per seq id): pairs where BOTH sides are marked are
    dropped — their alignments are served from the round-over-round pair
    cache (map_all_vs_all's pair_cache) instead of being recomputed."""
    e = index.entries_of(qi)
    if len(e) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z, z.astype(np.uint8)
    sz = index.run_size[e]
    keep = (sz > 1) & (sz <= index.max_occ)
    e = e[keep]
    sz = index.run_size[e]
    if len(e) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z, z.astype(np.uint8)
    total = int(sz.sum())
    rep = np.repeat(np.arange(len(e)), sz)
    offs = np.arange(total) - np.repeat(np.cumsum(sz) - sz, sz)
    flat = index.run_start[e][rep] + offs
    rid = index.seq_ids[flat]
    mask = rid < qi
    if skip_unchanged is not None and skip_unchanged[qi]:
        mask &= ~skip_unchanged[rid]
    flat, rep = flat[mask], rep[mask]
    rid = rid[mask]
    rpos = index.positions[flat]
    qpos = index.positions[e][rep]
    rel = (index.strands[flat] != index.strands[e][rep]).astype(np.uint8)
    return rid, rpos, qpos, rel


def collect_anchors_all(index: MinimizerIndex, skip_unchanged: np.ndarray = None):
    """All-vs-all anchors for EVERY query in ONE vectorized pass over the
    index (the round-level form of collect_anchors_self: per-query calls
    cost ~0.4 ms of numpy overhead x ~550 queries x ~34 rounds on the
    headline build). Every kept entry (run size in (1, max_occ]) expands
    its equal-value run; -X semantics (rid < qi) and the pair-cache skip
    are applied globally. Returns (qi, rid, rpos, qpos, rel) arrays; pair
    and anchor order is arbitrary (chaining lexsorts internally)."""
    z = np.zeros(0, dtype=np.int64)
    empty = (z.astype(np.int32), z.astype(np.int32), z, z, z.astype(np.uint8))
    if len(index.values) == 0:
        return empty
    sz = index.run_size
    slots = np.flatnonzero((sz > 1) & (sz <= index.max_occ))
    if len(slots) == 0:
        return empty
    # native path: run expansion + -X filter + pair-cache skip in one
    # GIL-released C++ pass (identical emit order to the numpy path below)
    from pangraph_tpu_torch.native import anchors_all_native

    heads = index.run_start[slots] == slots
    hsz = sz[slots][heads]
    bound = int((hsz * (hsz - 1)).sum())
    skip_u8 = None if skip_unchanged is None else skip_unchanged.astype(np.uint8)
    nat = anchors_all_native(
        index.seq_ids, index.positions, index.strands,
        index.run_start, index.run_size, index.max_occ, skip_u8, bound,
    )
    if nat is not None:
        return nat
    s_sz = sz[slots]
    total = int(s_sz.sum())
    qslot = np.repeat(slots, s_sz)
    offs = np.arange(total) - np.repeat(np.cumsum(s_sz) - s_sz, s_sz)
    flat = index.run_start[qslot] + offs
    qi = index.seq_ids[qslot]
    rid = index.seq_ids[flat]
    mask = rid < qi
    if skip_unchanged is not None:
        mask &= ~(skip_unchanged[qi] & skip_unchanged[rid])
    qslot, flat = qslot[mask], flat[mask]
    qi, rid = qi[mask], rid[mask]
    rpos = index.positions[flat]
    qpos = index.positions[qslot]
    rel = (index.strands[flat] != index.strands[qslot]).astype(np.uint8)
    return qi, rid, rpos, qpos, rel


def collect_anchors(index: MinimizerIndex, qmm: Minimizers, qid: int):
    """Match query minimizers against the index -> anchor arrays
    (rid, rpos, qpos, rel_strand)."""
    if len(qmm.values) == 0 or len(index.values) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z, z.astype(np.uint8)
    lo = np.searchsorted(index.values, qmm.values, side="left")
    hi = np.searchsorted(index.values, qmm.values, side="right")
    occ = hi - lo
    keep = (occ > 0) & (occ <= index.max_occ)
    lo, hi = lo[keep], hi[keep]
    q_pos = qmm.positions[keep]
    q_str = qmm.strands[keep]
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z, z.astype(np.uint8)
    # expand ranges: flat index into the sorted index arrays
    rep = np.repeat(np.arange(len(lo)), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    flat = lo[rep] + offs
    rid = index.seq_ids[flat]
    rpos = index.positions[flat]
    rstr = index.strands[flat]
    qpos = q_pos[rep]
    qstr = q_str[rep]
    rel = (rstr != qstr).astype(np.uint8)  # 1 = reverse-strand match
    return rid, rpos, qpos, rel


from dataclasses import dataclass as _dataclass


@_dataclass
class _ChainJob:
    """One chain span awaiting base-level alignment."""

    ref_seg: np.ndarray
    qry_seg: np.ndarray
    mean_shift: int
    band_width: int
    rid_name: object
    qid_name: object
    rlen: int
    qlen: int
    rs: int
    qs: int  # segment start in aligned-orientation coords
    qe: int
    rel: int
    # anchor-split pieces [(r0, r1, q0, q1, ms, bw)] in span coordinates;
    # None = align the whole span as one job
    segments: list = None


# anchor-split: spans longer than 2*SEG are cut at chain anchors into ~SEG-
# sized pieces, each aligned independently with a LOCAL band and stitched.
# This is the reference's architecture (minimap2 ksw2 extends BETWEEN chain
# anchors, minimap2-sys/minimap2/align.c) and the band win is large: a whole
# Mbp span needs W >= its total diagonal drift, while each piece only needs
# its local drift — and ~SEG-sized pieces batch onto the device kernel's
# mid tiers instead of falling back to single-threaded host jobs.
# SEG is deliberately large: measured r3, splitting ~100 kb spans of the
# 2%-divergent bench set degraded the merge trajectory (core fraction
# 0.92 -> 0.87) and cost retries, while Mbp spans split at 64 kb keep full
# quality and the 2x speedup — splitting is a long-span tool only.
CHAIN_SEG = 65536


def _split_span_at_anchors(ar, aq, k: int, r_end: int, q_end: int, band_extra: int, seg: int = CHAIN_SEG):
    """Cut points along a chain span: returns [(r0, r1, q0, q1, ms, bw)].

    ar/aq: anchor positions in span coordinates (strictly increasing). Cuts
    land on anchor starts (ref[a] == qry[a] for k bases there, so pinning
    the DP corner at a cut is exact); each piece's band derives from its own
    anchors' diagonal spread plus the piece's corner offset."""
    n = len(ar)
    # only anchors inside an exactly-colinear run (same diagonal as both
    # neighbours) qualify as cut points: a stray off-diagonal anchor (repeat
    # hit, or an anchor adjacent to an indel) would pin the DP through a
    # suboptimal path and fragment the merge trajectory — measured on the
    # 2%-divergent 12x120kb bench set, unrestricted cuts cost ~0.04 of core
    # fraction.
    d = ar - aq
    colinear = np.zeros(n, dtype=bool)
    if n >= 3:
        colinear[1:-1] = (d[1:-1] == d[:-2]) & (d[1:-1] == d[2:])
    bounds = [(0, 0)]
    cut_idx = [0]
    last_r = 0
    for i in range(n):
        if (
            colinear[i]
            and ar[i] - last_r >= seg
            and ar[i] < r_end - k
            and aq[i] < q_end - k
        ):
            bounds.append((int(ar[i]), int(aq[i])))
            cut_idx.append(i)
            last_r = int(ar[i])
    bounds.append((r_end, q_end))
    cut_idx.append(n)
    out = []
    for s in range(len(bounds) - 1):
        r0, q0 = bounds[s]
        r1, q1 = bounds[s + 1]
        if r1 <= r0 or q1 <= q0:
            return None  # degenerate cut: align whole span instead
        j0, j1 = cut_idx[s], cut_idx[s + 1]
        d = (ar[j0:j1] - r0) - (aq[j0:j1] - q0)
        corner = (r1 - r0) - (q1 - q0)
        if len(d):
            ms = int(np.round(np.mean(d)))
            bw = int(max(np.max(np.abs(d - ms)), abs(corner - ms), 1)) + band_extra
        else:
            ms = corner // 2
            bw = abs(corner - ms) + band_extra
        out.append((r0, r1, q0, q1, ms, bw))
    return out


def _prepare_chain_job(ref_seq, qry_seq, rc_qry, rid_name, qid_name, rlen, qlen, cr, cq, rel, p: MapperParams):
    k = p.k
    rs, re_ = int(cr[0]), int(cr[-1]) + k
    qs, qe = int(cq[0]), int(cq[-1]) + k
    rs = max(rs - p.extend_flank, 0)
    qs = max(qs - p.extend_flank, 0)
    re_ = min(re_ + p.extend_flank, rlen)
    qe = min(qe + p.extend_flank, qlen)
    ref_seg = ref_seq[rs:re_]
    qry_seg = (rc_qry if rel else qry_seq)[qs:qe]
    # diagonal band around the chain in segment coordinates (r - q convention)
    diag = (cr - rs) - (cq - qs)
    ms = int(np.round(np.mean(diag)))
    bw = int(max(np.max(np.abs(diag - ms)), 1)) + p.band_extra
    segments = None
    if len(ref_seg) > 2 * CHAIN_SEG:
        segments = _split_span_at_anchors(
            cr - rs, cq - qs, k, len(ref_seg), len(qry_seg), p.band_extra
        )
    return _ChainJob(
        ref_seg, qry_seg, ms, bw, rid_name, qid_name, rlen, qlen, rs, qs, qe, rel, segments
    )


ZSPLIT_WINDOW = 100        # low-identity detector window (bp)
ZSPLIT_MAX_SUBFRAC = 0.4   # window sub fraction beyond any plausible homology
ZSPLIT_MIN_KEEP = 100      # kept segments shorter than a block are dropped


def _split_low_identity(edit, L: int):
    """Split an Edit over a ref span of length L at unalignable regions.

    The reference never emits alignments across such regions: minimap2's
    ksw2 extension z-drops there (align.c; e.g. an inversion is ~75%
    mismatch), and pangraph then sees separate hits whose gap becomes its
    own (reverse-strand) block. Our banded extension has no z-drop, so an
    inversion inside a chain span would be absorbed as a substitution pile.
    Detector: any ZSPLIT_WINDOW with > ZSPLIT_MAX_SUBFRAC substitutions
    marks an unalignable region; the complement intervals are re-emitted as
    separate alignments. Returns [(a, b, sub_edit, q_off, q_len)] with
    sub_edit positions shifted to interval coordinates."""
    from pangraph_tpu_torch.graph.edits import Edit

    n_subs = len(edit.subs)
    w = ZSPLIT_WINDOW
    if L < 3 * w or n_subs < int(w * ZSPLIT_MAX_SUBFRAC):
        return [(0, L, edit, 0, None)]
    sub_pos = np.fromiter((s.pos for s in edit.subs), dtype=np.int64, count=n_subs)
    # O(n_subs) pre-filter: a window with > T subs exists iff some T+1
    # consecutive (sorted) sub positions fit within w — only then is the
    # O(L) dense scan worth running (chain spans are Mbp-scale; clusters
    # are rare: inversions / unalignable regions)
    T = int(w * ZSPLIT_MAX_SUBFRAC)
    sp = np.sort(sub_pos)
    if n_subs <= T or not (sp[T:] - sp[:-T] < w).any():
        return [(0, L, edit, 0, None)]
    # Event-based bad-region construction, O(n_subs log n_subs) — the dense
    # per-position scan cost O(L) per call and chain spans are Mbp-scale.
    # A window start s is bad iff s in (sp[i+T]-w, sp[i]] for some i (then
    # [s, s+w) holds subs i..i+T); the covered positions are the union of
    # [max(0, sp[i+T]-w+1), min(sp[i], L-w) + w), which is sorted by
    # construction (sp ascending), so one merge pass yields the bad runs.
    lo = np.maximum(sp[T:] - w + 1, 0)
    hi = np.minimum(sp[:-T], L - w)
    sel = lo <= hi
    lo, hi = lo[sel], hi[sel] + w  # covered: [lo, hi)
    runs_b = []  # merged bad runs
    cur_s, cur_e = int(lo[0]), int(hi[0])
    for s0, e0 in zip(lo[1:].tolist(), hi[1:].tolist()):
        if s0 <= cur_e:
            cur_e = max(cur_e, e0)
        else:
            runs_b.append((cur_s, cur_e))
            cur_s, cur_e = s0, e0
    runs_b.append((cur_s, cur_e))
    # good runs = complement of the bad runs within [0, L)
    good_runs = []
    prev = 0
    for s0, e0 in runs_b:
        if s0 > prev:
            good_runs.append((prev, s0))
        prev = e0
    if prev < L:
        good_runs.append((prev, L))

    # sorted coordinate arrays for O(log E) slicing and query offsets.
    # Invariant: deletions must be NON-OVERLAPPING (q_before's single-straddle
    # correction and the summed `de - dp` lengths both assume it) — aligner
    # output satisfies this by construction (one DP path cannot delete the
    # same ref position twice), and the sorts make position order irrelevant.
    sp_sorted = sp
    sub_order = np.argsort(sub_pos, kind="stable")
    dels_sorted = sorted(edit.dels, key=lambda d: d.pos)
    dp = np.fromiter((d.pos for d in dels_sorted), np.int64, len(dels_sorted))
    de = np.minimum(
        dp + np.fromiter((d.len for d in dels_sorted), np.int64, len(dels_sorted)), L
    )
    dcum = np.concatenate(([0], np.cumsum(de - dp)))
    inss_sorted = sorted(edit.inss, key=lambda x: x.pos)
    ip = np.fromiter((i.pos for i in inss_sorted), np.int64, len(inss_sorted))
    il = np.fromiter((len(i.seq) for i in inss_sorted), np.int64, len(inss_sorted))
    ilcum = np.concatenate(([0], np.cumsum(il)))

    def q_before(a: int) -> int:
        # query chars consumed before ref position a: matched/sub positions
        # minus deleted positions < a, plus insertion chars at pos <= a (an
        # Ins at pos a sits between ref[a-1] and ref[a]). Deletions are
        # sorted and non-overlapping, so only the last one can straddle a.
        j = int(np.searchsorted(dp, a))
        deleted = int(dcum[j])
        if j > 0:
            deleted -= max(0, int(de[j - 1]) - a)
        return a - deleted + int(ilcum[int(np.searchsorted(ip, a, side="right"))])

    out = []
    for a, b in good_runs:
        if b - a < ZSPLIT_MIN_KEEP:
            continue
        s0i = int(np.searchsorted(sp_sorted, a))
        s1i = int(np.searchsorted(sp_sorted, b))
        subs = []
        for k in sub_order[s0i:s1i]:
            s = edit.subs[k]
            subs.append(type(s)(s.pos - a, s.alt))
        d0i = int(np.searchsorted(de, a, side="right"))
        d1i = int(np.searchsorted(dp, b))
        dels = []
        for k in range(d0i, d1i):
            ns, ne = max(int(dp[k]), a), min(int(de[k]), b)
            if ne > ns:
                dels.append(type(dels_sorted[k])(ns - a, ne - ns))
        i0i = int(np.searchsorted(ip, a, side="right"))
        i1i = int(np.searchsorted(ip, b, side="left"))
        inss = [type(x)(x.pos - a, x.seq) for x in inss_sorted[i0i:i1i]]
        q0 = q_before(a)
        q_len = (b - a) - sum(d.len for d in dels) + sum(len(i.seq) for i in inss)
        out.append((a, b, Edit(subs=subs, dels=dels, inss=inss), q0, q_len))
    return out


def _finish_chain_alignment(job: _ChainJob, edit) -> list:
    """Edit over the chain span -> trimmed local Alignment records (one per
    kept interval after the low-identity split)."""
    out = []
    for a, b, sub_edit, q0, q_len in _split_low_identity(edit, len(job.ref_seg)):
        if q_len is None:  # whole-span fast path
            q0, q_len = 0, job.qe - job.qs
        aln = _emit_alignment(job, sub_edit, a, b, q0, q_len)
        if aln is not None:
            out.append(aln)
    return out


def _emit_alignment(job: _ChainJob, edit, a: int, b: int, q0: int, q_len: int) -> Alignment:
    from pangraph_tpu_torch.align.cigar import edit_to_cigar

    seg_rlen = b - a
    cigar = edit_to_cigar(edit, seg_rlen)
    # trim flanking indels into the hit interval (local alignment semantics)
    rs, re_ = job.rs + a, job.rs + b
    qs_a = job.qs + q0
    qe_a = qs_a + q_len  # aligned-orientation coords
    while cigar and cigar[0][1] != "M":
        n, op = cigar.pop(0)
        if op == "D":
            rs += n
        else:
            qs_a += n
    while cigar and cigar[-1][1] != "M":
        n, op = cigar.pop()
        if op == "D":
            re_ -= n
        else:
            qe_a -= n
    if not cigar:
        return None
    n_subs = len(edit.subs)
    m_total = sum(n for n, op in cigar if op == "M")
    gap_opens = sum(1 for _, op in cigar if op != "M")
    mlen = m_total - n_subs
    denom = m_total + gap_opens
    divergence = (n_subs + gap_opens) / denom if denom else 1.0
    if job.rel:
        q_start, q_end = job.qlen - qe_a, job.qlen - qs_a
    else:
        q_start, q_end = qs_a, qe_a
    return Alignment(
        qry=Hit.new(job.qid_name, job.qlen, (q_start, q_end)),
        reff=Hit.new(job.rid_name, job.rlen, (rs, re_)),
        matches=mlen,
        length=sum(n for n, _ in cigar),
        quality=60,
        orientation="-" if job.rel else "+",
        cigar=cigar,
        divergence=divergence,
        align_score=None,
    )


def _align_chain_jobs(jobs: list, band_params: BandedAlignParams, aligner=None) -> list:
    """Base-level alignment of chain spans: batched on device when an aligner
    with align_many is provided, host numpy stripe otherwise. Anchor-split
    spans are flattened into per-piece jobs and the piece edits stitched
    back (shift to span coordinates + concat) into one span edit."""
    from pangraph_tpu_torch.align.map_variations import edits_from_aligned_pair
    from pangraph_tpu_torch.align.params import BandParameters

    flat = []  # (ref, qry, band) per piece
    plan = []  # per span job: [(flat_slot, r0)] of its pieces
    for j in jobs:
        if j.segments:
            entries = []
            for r0, r1, q0, q1, ms, bw in j.segments:
                entries.append((len(flat), r0))
                flat.append((j.ref_seg[r0:r1], j.qry_seg[q0:q1], BandParameters(ms, bw)))
            plan.append(entries)
        else:
            plan.append([(len(flat), 0)])
            flat.append((j.ref_seg, j.qry_seg, BandParameters(j.mean_shift, j.band_width)))

    if aligner is not None and hasattr(aligner, "align_many"):
        from pangraph_tpu_torch.ops.batch_align import AlignJob

        flat_edits = aligner.align_many([AlignJob(r, q, b) for r, q, b in flat])
    else:
        flat_edits = []
        for r, q, b in flat:
            aln = align_banded(r, q, b.mean_shift, b.band_width, band_params)
            if aln.hit_boundary:
                aln = align_banded(r, q, b.mean_shift, 2 * b.band_width + 16, band_params)
            flat_edits.append(edits_from_aligned_pair(aln.ref_aln, aln.qry_aln, len(r)))

    edits = []
    for entries in plan:
        edit = flat_edits[entries[0][0]].shift(entries[0][1]) if entries[0][1] else flat_edits[entries[0][0]]
        for slot, r0 in entries[1:]:
            edit = edit.concat(flat_edits[slot].shift(r0))
        edits.append(edit)
    return edits


def anchor_groups(a_qi: np.ndarray, a_rid: np.ndarray, a_rel: np.ndarray, n_seqs: int) -> tuple:
    """Group the anchor pass's anchors by (query, target, strand): returns
    (order, key_s, starts), group g holding anchors order[starts[g]:starts[g+1]]
    under the key key_s[starts[g]] = (query * n_seqs + target) * 2 + strand."""
    key = (a_qi.astype(np.int64) * n_seqs + a_rid) * 2 + a_rel
    order = np.argsort(key, kind="quicksort")
    key_s = key[order]
    if len(key_s):
        starts = np.concatenate(([0], np.flatnonzero(key_s[1:] != key_s[:-1]) + 1, [len(key_s)]))
    else:
        starts = np.zeros(1, dtype=np.int64)
    return order, key_s, starts


def anchor_group(groups: tuple, gi: int, a_rpos: np.ndarray, a_qpos: np.ndarray, seqs: list, k: int) -> tuple:
    """Group gi of `anchor_groups`: (query, target, strand, rpos, q_eff),
    q_eff the query coordinates the group is chained in (reverse matches on
    the reverse-complement query)."""
    order, key_s, starts = groups
    sel = order[int(starts[gi]) : int(starts[gi + 1])]
    key = int(key_s[starts[gi]])
    strand_rel = key & 1
    ri, qi = (key >> 1) % len(seqs), (key >> 1) // len(seqs)
    qpos = a_qpos[sel]
    q_eff = (len(seqs[qi]) - qpos - k) if strand_rel else qpos
    return qi, ri, strand_rel, a_rpos[sel], q_eff


def map_all_vs_all(
    seqs_by_name: dict, p: MapperParams, band_params: BandedAlignParams = None, aligner=None,
    n_threads: int = 1, pair_cache: dict = None,
) -> list:
    """Map every sequence against every other (minimap2 -X semantics: skip
    self-mapping and dual pairs — each unordered pair is reported once).
    Returns Alignment records with block names as Hit names. All base-level
    chain-span alignments are collected first and batched through `aligner`.

    With n_threads > 1 the per-query sketch/anchor/chain stage runs on a
    thread pool (the TPU mapping of the reference's rayon par_bridge,
    align_with_minimap2_lib.rs:64-74): the native sketch/chain C++ releases
    the GIL, the index is read-only, and job order stays deterministic
    (concatenated in query order).

    pair_cache (one dict per self-merge fixpoint loop, caller-owned): later
    rounds of a merge re-map a block set that is mostly UNCHANGED — a pair
    of unchanged consensuses reproduces the same chain alignments, so
    their pre-selection records are replayed from the previous round instead
    of re-anchored/re-chained/re-DP'd. Keys are (name, consensus digest)
    PLUS the sequence's per-entry occupancy keep-mask: another block's
    change can shift a shared minimizer run across the `>1`/`<=max_occ`
    cutoffs (or move max_occ itself), which changes the anchor set of an
    otherwise-unchanged pair — such sequences are invalidated, so replay is
    EXACTLY what a fresh recompute would produce (ADVICE r4). Disable the
    cache entirely with PANGRAPH_TPU_NO_PAIR_CACHE=1. Primary/secondary
    selection still runs globally on the full candidate set each round, so
    the filter semantics are unchanged."""
    import os as _os

    from pangraph_tpu_torch.utils import trace

    if pair_cache is not None and _os.environ.get("PANGRAPH_TPU_NO_PAIR_CACHE"):
        pair_cache = None
    band_params = band_params or BandedAlignParams()
    names = sorted(seqs_by_name)
    seqs = [as_seq(seqs_by_name[n]) for n in names]
    unchanged = None
    digests = None
    if pair_cache is not None:
        import hashlib

        digests = {
            n: hashlib.blake2b(s.tobytes(), digest_size=16).digest() for n, s in zip(names, seqs)
        }
        prev_keys = pair_cache.get("keys", {})
        unchanged = np.array([prev_keys.get(n) == digests[n] for n in names], dtype=bool)
        if not unchanged.any():
            unchanged = None
    with trace.span("mapper.index"):
        index = build_index(seqs, names, p)
    occ_vecs = None
    if pair_cache is not None:
        # per-sequence occupancy keep-mask over its own index entries, in
        # entry order (deterministic for an unchanged sketch: entries sort
        # by (value, own sketch order) regardless of other sequences). The
        # anchors of pair (q, r) are exactly the shared runs that pass
        # `size > 1 and size <= max_occ` — so equal masks on both sides
        # guarantee replay == fresh recompute.
        keep_all = (index.run_size > 1) & (index.run_size <= index.max_occ)
        occ_vecs = {
            n: np.packbits(keep_all[index.entries_of(qi)]).tobytes()
            for qi, n in enumerate(names)
        }
        if unchanged is not None:
            prev_occ = pair_cache.get("occ", {})
            drift = np.array([unchanged[qi] and prev_occ.get(n) != occ_vecs[n]
                              for qi, n in enumerate(names)], dtype=bool)
            if drift.any():
                unchanged &= ~drift
                if not unchanged.any():
                    unchanged = None
    chain_p = ChainParams(
        k=p.k, max_gap=p.max_gap, bw=p.bw, min_score=p.min_chain_score, min_anchors=p.min_anchors
    )

    # ONE vectorized anchor pass for the whole round (-X all-vs-all via the
    # index self-join, rid < qi built in; both-unchanged pairs served from
    # pair_cache instead), then chain per (query, target, strand) group
    with trace.span("mapper.anchors"):
        a_qi, a_rid, a_rpos, a_qpos, a_rel = collect_anchors_all(index, unchanged)
        groups = anchor_groups(a_qi, a_rid, a_rel, len(names))

    rc_cache = {}

    def rc_of(qi: int):
        rc = rc_cache.get(qi)
        if rc is None:
            rc = rc_cache[qi] = revcomp(seqs[qi])
        return rc

    def group_jobs(gi: int) -> list:
        qi, ri, strand_rel, rpos_g, q_eff = anchor_group(groups, gi, a_rpos, a_qpos, seqs, p.k)
        qseq = seqs[qi]
        qlen = len(qseq)
        rc_qry = rc_of(qi) if strand_rel else None
        jobs = []
        with trace.span("mapper.chain"):
            chains, _scores = chain_anchors(rpos_g, q_eff, chain_p)
            for chain in chains:
                cr_full = rpos_g[chain]
                cq_full = q_eff[chain]
                for s, e in split_chain_at_jumps(cr_full, cq_full, p.diag_break, p.max_gap):
                    if e - s < p.min_anchors:
                        continue
                    jobs.append(
                        _prepare_chain_job(
                            seqs[ri],
                            qseq,
                            rc_qry,
                            names[ri],
                            names[qi],
                            int(index.lengths[ri]),
                            qlen,
                            cr_full[s:e],
                            cq_full[s:e],
                            strand_rel,
                            p,
                        )
                    )
        return jobs

    n_groups = len(groups[2]) - 1
    n_threads = max(1, min(n_threads, n_groups)) if n_groups else 1
    with trace.span("mapper.groups"):
        if n_threads > 1 and n_groups > 1:
            import concurrent.futures as _cf

            with _cf.ThreadPoolExecutor(max_workers=n_threads) as pool:
                per_group = list(pool.map(trace.carry(group_jobs), range(n_groups)))
        else:
            per_group = [group_jobs(gi) for gi in range(n_groups)]
    jobs = [j for js in per_group for j in js]
    edits = _align_chain_jobs(jobs, band_params, aligner)
    out = []
    with trace.span("mapper.finish"):
        for job, edit in zip(jobs, edits):
            out.extend(_finish_chain_alignment(job, edit))
    if pair_cache is not None:
        unchanged_names = (
            {n for n, u in zip(names, unchanged) if u} if unchanged is not None else set()
        )
        out.extend(
            a
            for a in pair_cache.get("alns", [])
            if a.qry.name in unchanged_names and a.reff.name in unchanged_names
        )
        # store the PRE-selection candidate set: selection depends on the
        # whole round's hits and must rerun globally every round
        pair_cache["alns"] = list(out)
        pair_cache["keys"] = digests
        pair_cache["occ"] = occ_vecs
    # canonical candidate order BEFORE selection: select_hits breaks
    # equal-score ties by input order and filter_matches breaks equal-energy
    # ties by list index, so ordering must not depend on computation order
    # (fresh vs pair-cache-replayed, thread scheduling) — sort by a total
    # deterministic key instead
    with trace.span("mapper.select"):
        out.sort(
            key=lambda a: (
                a.qry.name, a.reff.name,
                a.qry.interval.start, a.qry.interval.end,
                a.reff.interval.start, a.reff.interval.end,
                a.orientation, -a.matches, a.length,
            )
        )
        # primary/secondary resolution + mapq (hit.c semantics; drops the
        # near-duplicate candidates repetitive genomes otherwise flood the
        # energy filter with)
        from pangraph_tpu_torch.align.hits import select_hits

        return select_hits(out, p.mask_level, p.pri_ratio, p.best_n)
