"""The port's anchor-chain DP (pangraph_tpu_torch/ops/chain_k2.py) held
against the Pallas kernel of pangraph_tpu/ops/chain_k2.py, run in interpret
mode on the CPU as tests/test_chain_k2.py runs it, and against the host
engines (the numpy DP and native chain_dp) at the mapper's parameters.

f and parent must be equal bit for bit, nearest-predecessor ties included.
Inputs are made with numpy from a seed."""
from __future__ import annotations

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU beside torch in one process)
import numpy as np
import pytest
import torch

from pangraph_tpu.ops.chain_k2 import chain_dp_pallas
from pangraph_tpu_torch.align.chain import ChainParams
from pangraph_tpu_torch.align.mapper import MapperParams
from pangraph_tpu_torch.native import chain_dp_native
from pangraph_tpu_torch.ops import chain_k2 as ch


def _anchors(rng, n, L, n_chains=3):
    """Anchor clouds: a few co-linear chains with drift plus noise anchors,
    sorted by (r, q) (tests/test_chain_k2.py's generator)."""
    rs, qs = [], []
    for _ in range(n_chains):
        m = n // (n_chains + 1)
        start_r = int(rng.integers(0, L // 2))
        start_q = int(rng.integers(0, L // 2))
        steps = rng.integers(5, 400, m)
        rs.append(start_r + np.cumsum(steps))
        qs.append(start_q + np.cumsum(steps) + np.cumsum(rng.integers(-3, 4, m)))
    m = n - sum(len(x) for x in rs)
    rs.append(rng.integers(0, L, m))
    qs.append(rng.integers(0, L, m))
    r, q = np.concatenate(rs), np.concatenate(qs)
    order = np.lexsort((q, r))
    return r[order].astype(np.int64), q[order].astype(np.int64)


def _host_dp(r, q, k, max_gap, bw, window):
    """The sequential host DP (align/chain.py's numpy branch), true log2."""
    n = len(r)
    H = min(window, n)
    idx = np.arange(n)[:, None] - 1 - np.arange(H)[None, :]
    idx_c = np.maximum(idx, 0)
    dr = r[:, None] - r[idx_c]
    dq = q[:, None] - q[idx_c]
    dd = np.abs(dr - dq)
    ok = (idx >= 0) & (dr > 0) & (dq > 0) & (dr <= max_gap) & (dq <= max_gap) & (dd <= bw)
    log_dd = np.where(dd > 0, np.log2(np.maximum(dd, 1)).astype(np.int64), 0)
    contrib = np.where(ok, np.minimum(np.minimum(dq, dr), k) - ((dd * k) // 100 + (log_dd >> 1)), -(10**9))
    f = np.full(n, k, dtype=np.int64)
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        cand = np.where(ok[i], f[idx_c[i]] + contrib[i], -(10**9))
        h = int(np.argmax(cand))
        if ok[i, h] and cand[h] > k:
            f[i], parent[i] = cand[h], idx_c[i, h]
    return f, parent


P = ChainParams()
ARGS = (P.k, P.max_gap, P.bw)


def _assert_equals_pallas(r, q, H=P.window):
    f0, p0 = chain_dp_pallas(r, q, *ARGS, H)
    f1, p1 = ch.chain_dp(r, q, *ARGS, H, device="cpu")
    assert f1.dtype == p1.dtype == np.int64
    assert np.array_equal(f0, f1) and np.array_equal(p0, p1)
    return f1, p1


@pytest.mark.parametrize("n", [50, 1000, 1500, 4100])
def test_chain_equals_pallas(n):
    r, q = _anchors(np.random.default_rng(n), n, L=200_000)
    before = dict(ch.LAUNCHES)
    f, _ = _assert_equals_pallas(r, q)
    assert f.max() > 10 * P.k  # chains formed
    assert ch.LAUNCHES == before  # the plain version counts no launch


@pytest.mark.parametrize("H", [1, 8, 40])
def test_window_sizes(H):
    r, q = _anchors(np.random.default_rng(7 + H), 1500, L=200_000)
    _assert_equals_pallas(r, q, H)


def test_dense_chain_across_blocks():
    """One chain over several of the reference's 1024-anchor tiles."""
    n = 3000
    r = np.cumsum(np.full(n, 25, np.int64))
    q = r + np.arange(n) % 3
    f, parent = _assert_equals_pallas(r, q)
    assert f[-1] > f[1000] and (parent[1:] >= 0).all()


def test_empty_and_tiny():
    f, parent = ch.chain_dp(np.zeros(0, np.int64), np.zeros(0, np.int64), 19, 10_000, 1_000, 32, device="cpu")
    assert f.shape == parent.shape == (0,)
    _assert_equals_pallas(np.array([100, 150], np.int64), np.array([100, 150], np.int64))
    _assert_equals_pallas(np.array([7], np.int64), np.array([9], np.int64))


def test_refusals():
    r = np.array([0, 1 << 30], np.int64)
    with pytest.raises(ValueError, match="int32"):
        chain_dp_pallas(r, r, *ARGS, 32)
    with pytest.raises(ValueError, match="int32"):
        ch.chain_dp(r, r, *ARGS, 32, device="cpu")
    # large coordinates are fine once offset, as in the reference
    far = np.array([5_000_000_000, 5_000_000_050], np.int64)
    _assert_equals_pallas(far, far - 7)
    for H in (0, ch.MAX_H + 1):
        with pytest.raises(ValueError, match="H="):
            ch.chain_dp(r[:1], r[:1], *ARGS, H, device="cpu")


def test_equals_host_engines_at_mapper_params():
    """At the mapper's parameters (bw 1,000 < 4,096) the ladder log2 and the
    host engines' true log2 agree, so all three DPs are equal."""
    mp = MapperParams()
    p = ChainParams(k=mp.k, max_gap=mp.max_gap, bw=mp.bw)
    r, q = _anchors(np.random.default_rng(3), 3000, L=300_000, n_chains=5)
    f1, p1 = ch.chain_dp(r, q, p.k, p.max_gap, p.bw, p.window, device="cpu")
    f0, p0 = _host_dp(r, q, p.k, p.max_gap, p.bw, p.window)
    assert np.array_equal(f0, f1) and np.array_equal(p0, p1)
    native = chain_dp_native(r, q, p.k, p.max_gap, p.bw, p.window)
    if native is not None:  # where the host C++ engine builds
        assert np.array_equal(native[0], f1) and np.array_equal(native[1], p1)


def test_ladder_log2_differs_from_host_at_wide_bw():
    """At bw >= 4096 the reference kernel's log2 ladder (capped at 10) and the
    host engines' true log2 can give different scores: a chain of 100
    anchors (f 1,900) then a jump with dd = 5,000 costs 950 + (12 >> 1) on
    the host and 950 + (10 >> 1) in the kernels. The port follows the
    reference kernel."""
    r = np.concatenate([100 * np.arange(100), [15_000]]).astype(np.int64)
    q = np.concatenate([100 * np.arange(100), [10_000]]).astype(np.int64)
    args = (19, 10_000, 10_000, 32)
    f_ref, p_ref = chain_dp_pallas(r, q, *args)
    f, parent = ch.chain_dp(r, q, *args, device="cpu")
    assert np.array_equal(f, f_ref) and np.array_equal(parent, p_ref)
    f_host, p_host = _host_dp(r, q, *args)
    assert np.array_equal(f[:100], f_host[:100]) and np.array_equal(parent, p_host)
    assert f[99] == 1900 and f[100] == 1900 + 19 - 955 and f_host[100] == f[100] - 1
    native = chain_dp_native(r, q, *args)
    if native is not None:
        assert np.array_equal(native[0], f_host)


def test_ragged_batch_equals_one_set_at_a_time():
    rng = np.random.default_rng(11)
    sets = [_anchors(rng, n, L=100_000) for n in (300, 0, 1, 900)]
    r32, q32, offsets = ch.pack_sets(sets)
    f, parent = ch.chain_sets(torch.from_numpy(r32), torch.from_numpy(q32), torch.from_numpy(offsets), *ARGS, 32)
    for s, (r, q) in enumerate(sets):
        f1, p1 = ch.chain_dp(r, q, *ARGS, 32, device="cpu")
        assert np.array_equal(f.numpy()[offsets[s] : offsets[s + 1]], f1)
        assert np.array_equal(parent.numpy()[offsets[s] : offsets[s + 1]], p1)


def _ties_and_k_sets():
    """Hand-made anchor sets (r, q sorted by (r, q)) where candidates tie
    exactly between predecessors, and where the best candidate equals k (at
    k = 19): the parent must be the nearest of the tied predecessors, and
    -1 where no candidate beats k."""
    # A = (x, x+10) and B = (x+10, x) both reach C = (x+20, x+20) with dr, dq
    # of 20 and 10 (dd 10, gap 1 + 1): equal candidates, B nearer
    motif = np.array([[0, 10], [10, 0], [20, 20]], np.int64)
    ties = np.concatenate([motif + x for x in range(0, 3000, 100)])
    # (x, x) -> (x+1, x+6): alpha 1, dd 5, gap 0 + 1, so the candidate is
    # f + 0 = k for a predecessor at f = k; spaced past max_gap so that no
    # other pair links
    at_k = np.concatenate([np.array([[0, 0], [1, 6]], np.int64) + x for x in range(0, 400_000, 20_000)])
    return {"ties": ties, "at_k": at_k, "ties_at_k": np.concatenate([ties, at_k + 100_000])}


@pytest.mark.parametrize("name", ["ties", "at_k", "ties_at_k"])
def test_ties_and_candidates_equal_to_k(name):
    rq = _ties_and_k_sets()[name]
    order = np.lexsort((rq[:, 1], rq[:, 0]))
    r, q = rq[order, 0], rq[order, 1]
    f, parent = _assert_equals_pallas(r, q)
    if name == "ties":
        c = np.arange(2, len(r), 3)  # each motif's C: B is its nearest tied predecessor
        assert (parent[c] == c - 1).all() and (f[c] > P.k).all()
    if name == "at_k":
        assert (f == P.k).all() and (parent == -1).all()


def test_key_path_bound():
    """The chain kernel's keyed loop is taken where H <= 32, k >= 0,
    k * n < 2^26 and k * bw < 2^31, per set; other sets take its
    two-reduction loop."""
    limit = ch.KEY_F_LIMIT // 19  # n * 19 < 2^26 up to here
    sizes = [0, 1, 500, limit, limit + 1, 4_000_000]
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64))
    assert 19 * limit < ch.KEY_F_LIMIT <= 19 * (limit + 1)
    assert ch.key_path(offsets, 19, 1000, 32).tolist() == [1, 1, 1, 1, 0, 0]
    assert ch.key_path(offsets, 19, 1000, 8).tolist() == [1, 1, 1, 1, 0, 0]
    assert ch.key_path(offsets, 19, 1000, 33).tolist() == [0] * 6  # H past a warp
    assert ch.key_path(offsets, -1, 1000, 32).tolist() == [0] * 6  # a negative k
    assert ch.key_path(offsets, 0, 1000, 32).tolist() == [1] * 6
    big_bw = (1 << 31) // 19 + 1  # dd * k could wrap
    assert ch.key_path(offsets, 19, big_bw, 32).tolist() == [0] * 6
    assert ch.key_path(offsets, 19, big_bw - 1, 32).tolist() == [1, 1, 1, 1, 0, 0]
    assert ch.key_path(offsets[:1], 19, 1000, 32).shape == (0,)
