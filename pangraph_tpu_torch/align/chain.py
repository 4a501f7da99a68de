"""Anchor chaining DP (SURVEY.md §7 K2).

The reference vendors minimap2's mm_chain_dp (minimap2-sys/minimap2/lchain.c):
anchors sorted by reference position; each anchor looks back at a bounded
predecessor window; score = min(dq, dr, k) - gap_cost(|dr - dq|); best chains
extracted by descending peak score with used-anchor masking.

Here the predecessor window is a dense (N, H) gather + reduction — a pure
vector shape that ports directly to the TPU kernel. Chains are additionally cut
at diagonal jumps >= `diag_break` so downstream banded extension has a bounded
band (the reference instead splits alignments post-hoc at indels >= the same
threshold, split_matches.rs:13).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG = -1_000_000_000


@dataclass
class ChainParams:
    k: int = 19
    max_gap: int = 10_000  # options.c asm presets
    bw: int = 1_000
    window: int = 32  # predecessor look-back (mm max_chain_iter bounded)
    min_score: int = 40
    min_anchors: int = 3
    max_chains: int = 200


def sort_anchors(rpos: np.ndarray, qpos: np.ndarray) -> tuple:
    """(order, r, q): the anchors in the (r, q) order the chain DP takes, as int64."""
    order = np.lexsort((qpos, rpos))
    return order, rpos[order].astype(np.int64), qpos[order].astype(np.int64)


def chain_anchors(rpos: np.ndarray, qpos: np.ndarray, p: ChainParams):
    """Chain co-linear anchors. rpos/qpos: int64 arrays (same strand space,
    both increasing along a chain). Returns list of index arrays (chains),
    sorted by descending score, plus their scores."""
    n = len(rpos)
    if n == 0:
        return [], []
    order, r, q = sort_anchors(rpos, qpos)

    # native C++ DP when available (pangraph_tpu_torch.native)
    from pangraph_tpu_torch.native import chain_dp_native

    native = chain_dp_native(r, q, p.k, p.max_gap, p.bw, p.window)
    if native is not None:
        f, parent = native
        return _extract_chains(f, parent, order, p)

    H = min(p.window, n)
    # predecessor index matrix (N, H): j = i - 1 - h
    idx = np.arange(n)[:, None] - 1 - np.arange(H)[None, :]
    valid = idx >= 0
    idx_c = np.maximum(idx, 0)

    dr = r[:, None] - r[idx_c]
    dq = q[:, None] - q[idx_c]
    dd = np.abs(dr - dq)
    ok = valid & (dr > 0) & (dq > 0) & (dr <= p.max_gap) & (dq <= p.max_gap) & (dd <= p.bw)

    alpha = np.minimum(np.minimum(dq, dr), p.k)
    with np.errstate(divide="ignore"):
        log_dd = np.where(dd > 0, np.log2(np.maximum(dd, 1)).astype(np.int64), 0)
    # integer formulation (dd*k//100) so host numpy, native C++ and the K2
    # device kernel are bit-identical (float 0.01*dd*k truncation is
    # platform-order-sensitive)
    gap_cost = (dd * p.k) // 100 + (log_dd >> 1)
    contrib = np.where(ok, alpha - gap_cost, NEG)

    # sequential DP over anchors (window gather already precomputed)
    f = np.full(n, p.k, dtype=np.int64)
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        c = contrib[i]
        best_h = int(np.argmax(np.where(c > NEG, f[idx_c[i]] + c, NEG)))
        best = f[idx_c[i][best_h]] + c[best_h] if c[best_h] > NEG else NEG
        if best > p.k:
            f[i] = best
            parent[i] = idx_c[i][best_h]

    return _extract_chains(f, parent, order, p)


def _extract_chains(f, parent, order, p: ChainParams):
    """Chains by descending peak score with used-anchor masking."""
    n = len(f)
    from pangraph_tpu_torch.native import chain_extract_native

    native = chain_extract_native(f, parent, p.min_score, p.min_anchors, p.max_chains)
    if native is not None:
        out_idx, out_len, out_score = native
        chains, scores, at = [], [], 0
        for c in range(len(out_len)):
            ln = int(out_len[c])
            chains.append(order[out_idx[at : at + ln]])
            scores.append(int(out_score[c]))
            at += ln
        return chains, scores
    peaks = np.argsort(-f, kind="stable")
    used = np.zeros(n, dtype=bool)
    chains, scores = [], []
    for i in peaks:
        if used[i] or f[i] < p.min_score:
            continue
        chain = []
        j = int(i)
        while j >= 0 and not used[j]:
            chain.append(j)
            used[j] = True
            j = parent[j]
        if len(chain) >= p.min_anchors:
            chain = np.array(chain[::-1], dtype=np.int64)
            chains.append(order[chain])
            scores.append(int(f[i]))
        if len(chains) >= p.max_chains:
            break
    return chains, scores


def chain_anchors_vectorized(rpos, qpos, p: ChainParams):
    """Batched-DP entry point: same recurrence and results as chain_anchors."""
    return chain_anchors(rpos, qpos, p)


def split_chain_at_jumps(chain_r, chain_q, max_diag_jump: int, max_gap: int):
    """Cut a chain where the diagonal jumps by >= max_diag_jump or either
    coordinate gaps by > max_gap; yields (start, end) anchor index ranges."""
    diag = chain_r - chain_q
    cut = (
        (np.abs(np.diff(diag)) >= max_diag_jump)
        | (np.diff(chain_r) > max_gap)
        | (np.diff(chain_q) > max_gap)
    )
    bounds = np.concatenate(([0], np.flatnonzero(cut) + 1, [len(chain_r)]))
    return [(int(s), int(e)) for s, e in zip(bounds[:-1], bounds[1:]) if e > s]
