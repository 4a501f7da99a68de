"""The port's checkpoint pair (stripe_dp_ckpt + walk_ckpt, pangraph_tpu_torch/
ops/stripe_v2.py) held against the Pallas checkpoint kernels of
pangraph_tpu/ops/stripe_v2.py, run in interpret mode on the CPU as
tests/test_stripe_ckpt.py runs them, and against the port's own v2 route;
then the batch aligner's routing to it.

Every comparison is exact. Inputs are made with numpy from a seed. Each
batch mixes random related pairs with cases that reach the walk's corners:
an indel-free stretch many windows long (window skips and run refreshes),
a path on band lane 0 and one on the band's top lane, an rlen equal to the
tier (no carry above the last window) and one on a window edge below it, a
deletion wider than the band (a dead walk), and a short pair."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangraph_tpu.graph.seq import IUPAC_MASK
from pangraph_tpu.ops import stripe_v2 as ref_sv
from pangraph_tpu_torch.align.params import BandedAlignParams, BandParameters
from pangraph_tpu_torch.ops import stripe_v2 as sv
from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner

ACGT = np.frombuffer(b"ACGT", np.uint8)
G = 8  # problems per Pallas group
R_CAP = 4096
K = 256
SHAPES = [128, 256, 1024]  # B; at B 1024 a window is 256 rows, 16 windows in R_CAP
CASES = ["random0", "random1", "long_run", "lane0", "lane_top", "rlen_is_tier", "rlen_on_edge", "dead_or_short"]


def subs(q, rng, n):
    q = q.copy()
    idx = rng.choice(len(q), n, replace=False)
    q[idx] = ACGT[(np.searchsorted(ACGT, q[idx]) + rng.integers(1, 4, n)) % 4]
    return q


def indels(r, rng, n, max_len=9):
    q = list(r)
    for _ in range(n):
        i = int(rng.integers(10, len(q) - 10))
        L = int(rng.integers(1, max_len))
        if rng.random() < 0.5:
            del q[i : i + L]
        else:
            q[i:i] = list(ACGT[rng.integers(0, 4, L)])
    return np.array(q, np.uint8)


def cases(B: int, seed: int = 2):
    """(name, ref, qry, mean_shift) for each of CASES at band width B."""
    rng = np.random.default_rng(seed + B)
    W = (B - 2) // 2
    WV = sv.ckpt_layout(B)

    def rand(n):
        return ACGT[rng.integers(0, 4, n)]

    out = []
    for s in range(2):
        r = rand(3000 - 137 * s)
        out.append((f"random{s}", r, subs(indels(r, rng, 3), rng, 70), int(rng.integers(-5, 5))))
    # one deletion near the start and one insertion near the end: the walk
    # crosses everything between them on carried runs
    r = rand(4000)
    q = subs(r, rng, 40)
    q = np.concatenate([q[:150], q[153:3890], rand(2), q[3890:]])
    out.append(("long_run", r, q, 0))
    r = rand(3000)
    q = subs(r, rng, 30)
    out.append(("lane0", r, q, -W))  # the main diagonal is band lane 0
    out.append(("lane_top", r, q, W + 1))  # ... and the band's top lane, B-1
    r = rand(R_CAP)
    out.append(("rlen_is_tier", r, subs(indels(r, rng, 4), rng, 40), 0))
    r = rand(2 * WV if 2 * WV < R_CAP else WV)
    out.append(("rlen_on_edge", r, subs(indels(r, rng, 2), rng, 20), 3))
    # a deletion wider than the band: the walk dies at the band edge
    r = rand(1500)
    out.append(("dead_or_short", r, np.concatenate([r[:500], r[500 + W + 40 :]]), 0))
    return out


def batch(cs, B: int):
    m = len(cs)
    ref_seq = np.zeros((m, R_CAP), np.uint8)
    qry_seq = np.zeros((m, R_CAP + B), np.uint8)
    rlen, qlen, ms = (np.zeros(m, np.int32) for _ in range(3))
    for s, (_n, r, q, shift) in enumerate(cs):
        ref_seq[s, : len(r)] = r
        qry_seq[s, : len(q)] = q
        rlen[s], qlen[s], ms[s] = len(r), len(q), shift
    W = np.full(m, (B - 2) // 2, np.int32)
    return ref_seq, qry_seq, rlen, qlen, ms, W


def reference_carries(ref_seq, qry_seq, rlen, qlen, ms, W, B: int):
    """The Pallas stripe_dp_ckpt's carries [m, n_windows, 3, B+128], with
    the reference's input prep (stripe_v2.py:996-1008) done in numpy."""
    WV, _n_qb = ref_sv.ckpt_layout(B)
    qm = IUPAC_MASK[qry_seq]
    qsh = np.zeros_like(qm)
    t = np.arange(qm.shape[1])
    for s in range(len(rlen)):
        shift = int(ms[s] + W[s])
        valid = (t >= shift) & (t < shift + qlen[s])
        qsh[s] = np.where(valid, np.roll(qm[s], shift), 0)
    gmax = rlen.reshape(-1, G).max(axis=1).astype(np.int32)
    ck = ref_sv.stripe_dp_ckpt(
        jnp.asarray(IUPAC_MASK[ref_seq].astype(np.int32)), jnp.asarray(qsh), jnp.asarray(rlen),
        jnp.asarray(qlen), jnp.asarray(ms), jnp.asarray(W), jnp.asarray(gmax), R_CAP, B, WV // ref_sv.DP_C, G,
    )
    return np.asarray(ck)


@pytest.fixture(scope="module", params=SHAPES, ids=[f"B{b}" for b in SHAPES])
def runs(request):
    B = request.param
    cs = cases(B)
    arrays = batch(cs, B)
    ref_seq, qry_seq, rlen, qlen, ms, W = arrays
    WV, n_qb = ref_sv.ckpt_layout(B)
    gmax = rlen.reshape(-1, G).max(axis=1).astype(np.int32)
    ref_out = ref_sv.stripe_align_v2_ckpt(ref_seq, qry_seq, rlen, qlen, ms, W, gmax, R_CAP, B, K,
                                         WV // ref_sv.DP_C, n_qb, G)
    t = [torch.from_numpy(a) for a in arrays]
    return {
        "B": B, "cases": cs, "arrays": arrays,
        "ref": {k: np.asarray(v) for k, v in ref_out.items()},
        "ref_carries": reference_carries(*arrays, B),
        "carries": sv.stripe_dp_ckpt(*t, B, R_CAP).numpy(),
        "ckpt": {k: v.numpy() for k, v in sv.stripe_align_ckpt(*arrays, B, K, R_CAP, "cpu").items()},
        "v2": {k: v.numpy() for k, v in sv.stripe_align(*arrays, B, K, sv.walk_segment(R_CAP, B), "cpu").items()},
    }


def events(out, s):
    n = int(out["n_events"][s])
    return n, out["rows"][s][: min(n, K)], out["words"][s][: min(n, K)]


def test_ckpt_layout_matches_reference():
    for B in range(128, sv.MAX_B + 1, 128):
        assert sv.ckpt_layout(B) == ref_sv.ckpt_layout(B)[0], B
    assert [sv.ckpt_layout(b) for b in (128, 256, 512, 1024, 2048)] == [2048, 1024, 512, 256, 128]
    assert sv.ckpt_windows(R_CAP, 1024) == 16


@pytest.mark.parametrize("case", CASES)
def test_walk_matches_pallas_ckpt(runs, case):
    """stripe_align_ckpt (plain versions) against stripe_align_v2_ckpt in
    interpret mode: n_events, rows, words and meta equal, meta[2] included."""
    s = CASES.index(case)
    ref, port = runs["ref"], runs["ckpt"]
    n, rows, words = events(ref, s)
    assert events(port, s)[0] == n
    np.testing.assert_array_equal(events(port, s)[1], rows)
    np.testing.assert_array_equal(events(port, s)[2], words)
    np.testing.assert_array_equal(port["meta"][s], ref["meta"][s])


def test_cases_reach_the_walks_corners(runs):
    """The batch really exercises what it is for: a match run longer than a
    window, a dead walk, and walks that report a boundary."""
    B, cs = runs["B"], runs["cases"]
    WV = sv.ckpt_layout(B)
    meta = runs["ref"]["meta"]
    assert meta[CASES.index("dead_or_short"), 1] == 1
    assert meta[:, 2].sum() >= 1
    s = CASES.index("long_run")
    assert len(cs[s][1]) > WV and int(runs["ref"]["n_events"][s]) == 2
    assert cs[CASES.index("rlen_is_tier")][1].shape[0] == R_CAP


def test_carries_match_pallas_ckpt(runs):
    """stripe_dp_ckpt_plain's carries against the Pallas stripe_dp_ckpt's,
    for every window that starts at or below a problem's rlen. The Pallas
    carry is saved in the window coordinates of the window's first chunk,
    where the row before it (the carried row) sits one lane to the left:
    band lane k is window lane k-1. Band lane 0 falls off the window there,
    so it has no counterpart (and the DP never reads it: the row after a
    window start is a chunk row, where lane 0 has no diagonal)."""
    B = runs["B"]
    WV = sv.ckpt_layout(B)
    port, ref = runs["carries"], runs["ref_carries"]
    rlen = runs["arrays"][2]
    assert port.shape == (G, R_CAP // WV, 3, B)
    for s in range(G):
        n = int(rlen[s]) // WV + 1
        np.testing.assert_array_equal(port[s, :n, :, 1:], ref[s, :n, :, : B - 1])


def test_ckpt_events_equal_v2_events(runs):
    """Inside the port: the checkpoint route's events equal the v2 route's
    on the same batch (meta[2] may differ: carried jumps read no record)."""
    ck, v2 = runs["ckpt"], runs["v2"]
    for s in range(G):
        n = events(v2, s)
        assert events(ck, s)[0] == n[0]
        np.testing.assert_array_equal(events(ck, s)[1], n[1])
        np.testing.assert_array_equal(events(ck, s)[2], n[2])
        np.testing.assert_array_equal(ck["meta"][s, [0, 1, 3]], v2["meta"][s, [0, 1, 3]])


def test_deletion_ending_on_a_window_edge():
    """A deletion run whose walk ends exactly on a window edge, below a
    match run that covers the whole window: the port's checkpoint walk reads
    the edge cell's record and emits the deletion there, as the v2 walk
    does. The Pallas checkpoint walk refreshes the walker's run budget at
    that edge instead, crosses the window without a record read, and so
    flushes the deletion at row 0: its events differ from its own v2
    route's there, which is why the port does not follow it."""
    B = 128
    WV = sv.ckpt_layout(B)
    rng = np.random.default_rng(5)
    r = ACGT[rng.integers(0, 4, 3000)]
    dl = 5
    # a unique placement: the deletion cannot shift by one either way
    r[WV + dl] = ACGT[(np.searchsorted(ACGT, r[WV]) + 1) % 4]
    r[WV + dl - 1] = ACGT[(np.searchsorted(ACGT, r[WV - 1]) + 1) % 4]
    q = np.concatenate([r[:WV], r[WV + dl :]])
    cs = [("deletion_on_edge", r, q, 0)] * G
    arrays = batch(cs, B)
    port = sv.stripe_align_ckpt(*arrays, B, K, R_CAP, "cpu")
    v2 = sv.stripe_align(*arrays, B, K, sv.walk_segment(R_CAP, B), "cpu")
    OP_D = 2
    want_word = OP_D | dl << 17
    for out in (port, v2):
        assert out["n_events"].tolist() == [1] * G
        assert out["rows"][:, 0].tolist() == [WV] * G and out["words"][:, 0].tolist() == [want_word] * G
    assert torch.equal(port["meta"], v2["meta"])
    edit, ok = sv.edit_from_events(port["rows"][0].numpy(), port["words"][0].numpy(), port["n_events"][0],
                                   port["meta"][0].numpy(), r, q)
    assert ok and edit.subs == [] and np.array_equal(edit.apply(r), q)

    ref_seq, qry_seq, rlen, qlen, ms, W = arrays
    WV_, n_qb = ref_sv.ckpt_layout(B)
    gmax = rlen.reshape(-1, G).max(axis=1)
    ref = ref_sv.stripe_align_v2_ckpt(ref_seq, qry_seq, rlen, qlen, ms, W, gmax, R_CAP, B, K,
                                      WV_ // ref_sv.DP_C, n_qb, G)
    assert np.asarray(ref["n_events"]).tolist() == [1] * G
    assert np.asarray(ref["rows"])[:, 0].tolist() == [0] * G  # the reference's misplaced flush
    assert np.asarray(ref["words"])[:, 0].tolist() == [want_word] * G
    # the reference's own v2 route sides with the port: the deletion at row WV
    ref_v2 = ref_sv.stripe_align_v2(ref_seq, qry_seq, rlen, qlen, ms, W, gmax, R_CAP, B, K, G)
    assert np.asarray(ref_v2["n_events"]).tolist() == [1] * G
    assert np.asarray(ref_v2["rows"])[:, 0].tolist() == [WV] * G
    assert np.asarray(ref_v2["words"])[:, 0].tolist() == [want_word] * G


def test_ckpt_wrappers_check_inputs():
    arrays = batch(cases(128)[:1], 128)
    t = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="R_cap"):
        sv.stripe_dp_ckpt(*t, 128, 1000)
    ck = sv.stripe_dp_ckpt(*t, 128, R_CAP)
    with pytest.raises(ValueError, match="ckpt"):
        sv.walk_ckpt(ck[:, :, :2].contiguous(), *t, K)
    with pytest.raises(ValueError, match="cover"):
        sv.walk_ckpt(ck[:, :1].contiguous(), *t, K)
    with pytest.raises(ValueError, match="CUDA"):
        sv.stripe_dp_ckpt_cuda(*t, 128)
    with pytest.raises(ValueError, match="CUDA"):
        sv.walk_ckpt_cuda(ck, *t, K)


# ------------------------------------------------------------------ routing


def mutate(r, rng, n_sub, n_indel):
    return subs(indels(r, rng, n_indel, 6), rng, n_sub)


def routing_jobs():
    """Jobs in the (4096, 128), (4096, 256) and (10240, 128) groups."""
    rng = np.random.default_rng(23)
    jobs = []
    for n, bw in ((1200, 20), (2500, 20), (1800, 80), (3000, 80), (5200, 20)):
        r = ACGT[rng.integers(0, 4, n)]
        jobs.append(AlignJob(r, mutate(r, rng, n // 80, n // 400), BandParameters(0, bw)))
    return jobs


def plan_routes(al, jobs, kbumps=None):
    widths = [j.band.band_width + al.extra for j in jobs]
    planned, fallback = al._plan(jobs, widths, kbumps or [1] * len(jobs))
    return {(R_cap, B): ckpt for _sub, R_cap, B, _K, ckpt in planned}, planned, fallback


def test_override_routes_groups_past_the_reference_quantity():
    """ckpt_paths_bytes is compared with R_cap * (B + 128) * 2: 2,097,152 at
    (4096, 128), 3,145,728 at (4096, 256), 5,242,880 at (10240, 128)."""
    jobs = routing_jobs()
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=3_000_000)
    routes, _planned, fallback = plan_routes(al, jobs)
    assert routes == {(4096, 128): False, (4096, 256): True, (10240, 128): True}
    assert fallback == {}
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    assert not any(plan_routes(al, jobs)[0].values())


def test_override_reads_the_environment(monkeypatch):
    monkeypatch.setenv("PANGRAPH_TPU_CKPT_BYTES", "32000000")
    assert BatchAligner(device="cpu").ckpt_paths_bytes == 32_000_000
    monkeypatch.delenv("PANGRAPH_TPU_CKPT_BYTES")
    assert BatchAligner(device="cpu").ckpt_paths_bytes == 10**18


def test_records_that_do_not_fit_take_the_ckpt_route():
    """8 problems' v2 records over a launch's share (a quarter of the
    budget): 8 * 10240 * 128 * 2 = 20,971,520 bytes > 10 MB, while the 4096
    tier's 8,388,608 (B 128) fits and 12,582,912 (B 256) does not."""
    jobs = routing_jobs()
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    al.budget = 40 << 20
    routes, _planned, _fallback = plan_routes(al, jobs)
    assert routes == {(4096, 128): False, (4096, 256): True, (10240, 128): True}


def test_event_dense_ckpt_jobs_go_to_the_host():
    """On the checkpoint route K is capped at 2048: a sub-batch that needs
    more (hint or bump) goes to the host, as in the reference."""
    jobs = routing_jobs()
    jobs[3].hint_events = 1100  # in the (4096, 256) group
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=3_000_000)
    routes, planned, fallback = plan_routes(al, jobs)
    assert fallback == {2: "ckpt_events", 3: "ckpt_events"}  # the whole sub-batch of the group
    assert (4096, 256) not in routes and routes[(10240, 128)]
    # the same hint on the v2 route just raises K
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    _routes, planned, fallback = plan_routes(al, jobs)
    assert fallback == {} and max(K_ for _s, _R, _B, K_, _c in planned) == 4096


def test_align_many_on_the_ckpt_route():
    """Every job on the checkpoint route: the edits reproduce each query and
    equal the v2 route's edits; the cells count as device cells, and the
    receipts name the route."""
    jobs = [routing_jobs()[i] for i in (0, 2, 3)]
    BatchAligner.reset_engine_stats()
    v2 = BatchAligner(BandedAlignParams(), 5, 4, device="cpu").align_many(jobs)
    assert set(BatchAligner.engine_report()["device_routes"]) == {"stripe"}
    BatchAligner.reset_engine_stats()
    ck = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=0).align_many(jobs)
    report = BatchAligner.engine_report()
    assert report["device_cells_frac"] == 1.0
    assert set(report["device_routes"]) == {"ckpt"}
    assert report["device_routes"]["ckpt"] == report["device"]["cells"]
    tiers = report["device_tiers"]  # "tier/route": [jobs, cells, B min, B max]
    assert {k.split("/")[1] for k in tiers} == {"ckpt"}
    assert sum(v[1] for v in tiers.values()) == report["device"]["cells"]
    assert tiers["4096/ckpt"][0] >= 3 and tiers["4096/ckpt"][2] == 128
    for a, b, j in zip(ck, v2, jobs):
        assert np.array_equal(a.apply(j.ref), j.qry)
        assert a == b


# ------------------------------------------------------------------ the walk's waves


@pytest.mark.parametrize("m,R,B,budget_windows", [
    (4, 65536, 128, None),  # the long-tier path's shapes: one wave, the full records
    (4, 131072, 1920, None),  # two waves
    (32, 2_097_152, 128, None),  # the Mbp shape: sixteen waves
    (3000, 4096, 128, None),  # more problems than the budget's windows: two groups
    (13, 5000, 128, 3),
    (13, 3000, 2048, 2),
    (5, 1000, 2048, 100),
    (2, 0, 256, None),  # no rows: one wave that only starts and finishes the walkers
])
def test_walk_ckpt_wave_plan(monkeypatch, m, R, B, budget_windows):
    """walk_ckpt_plan covers each window that holds rows of each problem once,
    top windows first within a group of problems; each wave's rows fit its
    scratch, which stays within the budget and within the launch's full
    records; and walk_ckpt_buffers allocates that scratch and the walkers'
    state."""
    WV = sv.ckpt_layout(B)
    if budget_windows:
        monkeypatch.setattr(sv, "WALK_CKPT_SCRATCH_BYTES", budget_windows * WV * B * 2)
    n_windows = sv.ckpt_windows(max(R, 1), B)
    G, S, waves = sv.walk_ckpt_plan(m, R, B, n_windows)
    assert G * S * B * 2 <= sv.WALK_CKPT_SCRATCH_BYTES and G * S <= m * R
    n_top = max(1, -(-R // WV))
    seen = {}
    for p_lo, p_hi, w_lo, w_hi in waves:
        assert 0 <= p_lo < p_hi <= p_lo + G and p_hi <= m and 0 <= w_lo < w_hi <= n_top
        assert min(w_hi * WV, R) - w_lo * WV <= S  # the wave's rows fit the scratch
        group = seen.setdefault((p_lo, p_hi), [])
        assert not group or group[-1][0] == w_hi  # top first, each window once
        group.append((w_lo, w_hi))
    groups = sorted(seen)
    assert groups[0][0] == 0 and groups[-1][1] == m and all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert all(g[0][1] == n_top and g[-1][0] == 0 for g in seen.values())
    assert list(seen) == groups  # a group's waves run before the next group's
    scratch, state, got = sv.walk_ckpt_buffers(m, R, B, n_windows, "meta")
    assert got == waves and scratch.shape == (G, S, B) and state.shape == (m, sv.WALKER_INTS)


def test_launch_bytes_charge_the_walk_scratch(monkeypatch):
    """A checkpoint launch's device bytes are its carries and input rows and
    exactly what walk_ckpt_cuda allocates for its walk (scratch and walker
    state, walk_ckpt_buffers), at the default budget and at one that forces
    waves; a v2 launch's are its records; both add exactly what the decode
    of a launch of their K allocates (its outputs on the CPU)."""
    jobs = routing_jobs()
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    sub = [0, 1, 4]
    R = max(len(jobs[i].ref) for i in sub)
    Q = max(len(jobs[i].qry) for i in sub)
    K = 256
    m = len(sub)
    walk = [torch.zeros(shape, dtype=torch.int32) for shape in ((m, K), (m, K), (m,), (m, 4))]
    seqs = [torch.zeros((m, n), dtype=torch.uint8) for n in (R, Q)]
    lens = [torch.full((m,), n, dtype=torch.int32) for n in (R, Q)]
    decoded = sv.decode_events(*walk, *seqs, *lens)
    decode = sum(t.nbytes for t in decoded.values())
    for budget in (sv.WALK_CKPT_SCRATCH_BYTES, 3 * sv.ckpt_layout(128) * 128 * 2):
        monkeypatch.setattr(sv, "WALK_CKPT_SCRATCH_BYTES", budget)
        scratch, state, _waves = sv.walk_ckpt_buffers(m, R, 128, sv.ckpt_windows(10240, 128), "cpu")
        carries = m * al._problem_bytes(10240, 128, True, R, Q)
        assert al._launch_bytes(jobs, sub, 10240, 128, K, True) == carries + scratch.nbytes + state.nbytes + decode
    assert al._launch_bytes(jobs, sub, 10240, 128, K, False) == m * R * 128 * 2 + decode
