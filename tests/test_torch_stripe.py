"""The port's stripe DP and walk (pangraph_tpu_torch/ops/stripe_v2.py) held
against the Pallas kernels of pangraph_tpu/ops/stripe_v2.py, run in
interpret mode on the CPU as tests/test_stripe_v2.py runs them.

Every comparison is exact: the DP is integer arithmetic and the events are
discrete. The Pallas DP writes records in 128-row window coordinates
(row i, band lane k at lane (i-1) % 128 + k); they are converted to the
port's band coordinates and compared element for element, padding rows
included. Inputs are made with numpy from a seed."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangraph_tpu.graph.seq import IUPAC_MASK
from pangraph_tpu.ops import stripe_v2 as ref_sv
from pangraph_tpu_torch.ops import stripe_v2 as sv

ACGT = np.frombuffer(b"ACGT", np.uint8)
IUPAC = np.frombuffer(b"NRYSWKMBDHVN", np.uint8)
G = 8  # problems per Pallas group


def mutate(ref, n_sub, n_ins, n_del, rng, max_len=6):
    q = list(ref)
    for _ in range(n_del):
        p = int(rng.integers(1, len(q) - 1))
        del q[p : p + int(rng.integers(1, max_len))]
    for _ in range(n_ins):
        p = int(rng.integers(1, len(q) - 1))
        q[p:p] = list(ACGT[rng.integers(0, 4, int(rng.integers(1, max_len)))])
    q = np.array(q, np.uint8)
    idx = rng.choice(len(q), min(n_sub, len(q)), replace=False)
    q[idx] = ACGT[rng.integers(0, 4, len(idx))]
    return q


def _cases_512(rng):
    """(name, ref, qry, mean_shift) for the R_cap 512 / B 128 batch."""
    out = []
    for kind, mut in [("identical", None), ("subs", (10, 0, 0)), ("mixed", (5, 3, 3)), ("heavy", (15, 5, 5))]:
        n = int(rng.integers(150, 480))
        r = ACGT[rng.integers(0, 4, n)]
        out.append((kind, r, r.copy() if mut is None else mutate(r, *mut, rng), 0))
    r = ACGT[rng.integers(0, 4, 300)]
    out += [("lead_gap", r, r[20:], 0), ("trail_gap", r, r[:-25], 0),
            ("ref_lead", r[30:], r, 0), ("ref_trail", r[:-30], r, 0)]
    q = mutate(r, 8, 2, 2, rng)
    out += [("shift+17", r, q, 17), ("shift-13", r, q, -13)]
    # IUPAC codes and N on both sides
    r2 = ACGT[rng.integers(0, 4, 400)]
    q2 = mutate(r2, 6, 2, 2, rng)
    r2[rng.choice(400, 12, replace=False)] = IUPAC[rng.integers(0, len(IUPAC), 12)]
    q2[rng.choice(len(q2), 12, replace=False)] = IUPAC[rng.integers(0, len(IUPAC), 12)]
    out.append(("iupac", r2, q2, 0))
    # event-dense pair: > 64 indel runs, for the K = 64 overflow
    r3 = ACGT[rng.integers(0, 4, 500)]
    q3 = []
    for p in range(0, 500, 5):  # alternately insert a base and delete one, every 5 bp
        q3 += list(r3[p : p + 5])
        if p // 5 % 2:
            q3.append(int(ACGT[rng.integers(0, 4)]))
        else:
            q3.pop()
    out.append(("dense", r3, np.array(q3, np.uint8), 0))
    while len(out) % G:
        out.append(("pad", np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0))
    return out


def _batch(cases, R_cap, B):
    m = len(cases)
    ref_seq = np.zeros((m, R_cap), np.uint8)
    qry_seq = np.zeros((m, R_cap + B), np.uint8)
    rlen = np.zeros(m, np.int32)
    qlen = np.zeros(m, np.int32)
    ms = np.zeros(m, np.int32)
    for s, (_name, r, q, shift) in enumerate(cases):
        ref_seq[s, : len(r)] = r
        qry_seq[s, : len(q)] = q
        rlen[s], qlen[s], ms[s] = len(r), len(q), shift
    W = np.full(m, (B - 2) // 2, np.int32)
    return ref_seq, qry_seq, rlen, qlen, ms, W


def reference_dp_walk(ref_seq, qry_seq, rlen, qlen, ms, W, R_cap, B, Ks):
    """Pallas stripe_dp_v2 (records converted to band coordinates) and
    walk_v2 for each K in Ks, with the reference's input prep
    (stripe_v2.py:1039-1052) done in numpy."""
    ref_mask = IUPAC_MASK[ref_seq].astype(np.int32)
    qm = IUPAC_MASK[qry_seq]
    qsh = np.zeros_like(qm)
    t = np.arange(qm.shape[1])
    for s in range(len(rlen)):
        shift = int(ms[s] + W[s])
        valid = (t >= shift) & (t < shift + qlen[s])
        qsh[s] = np.where(valid, np.roll(qm[s], shift), 0)
    gmax = rlen.reshape(-1, G).max(axis=1).astype(np.int32)
    paths = ref_sv.stripe_dp_v2(
        jnp.asarray(ref_mask), jnp.asarray(qsh), jnp.asarray(rlen), jnp.asarray(qlen),
        jnp.asarray(ms), jnp.asarray(W), jnp.asarray(gmax), R_cap, B, G,
    )
    win = np.asarray(paths)
    lane = (np.arange(R_cap) % ref_sv.DP_C)[:, None] + np.arange(B)[None, :]
    band = np.take_along_axis(win, np.broadcast_to(lane, (len(rlen), R_cap, B)), axis=2)
    walks = {
        K: [np.asarray(x) for x in ref_sv.walk_v2(paths, jnp.asarray(rlen), jnp.asarray(qlen),
                                                  jnp.asarray(ms), jnp.asarray(W), R_cap, B, K)]
        for K in Ks
    }
    return band, walks


def port_dp_walk(ref_seq, qry_seq, rlen, qlen, ms, W, R_cap, B, Ks, seg=None):
    t = [torch.from_numpy(a) for a in (ref_seq, qry_seq, rlen, qlen, ms, W)]
    rec = sv.stripe_dp(*t, B)
    seg = seg or sv.walk_segment(R_cap, B)
    walks = {K: [x.numpy() for x in sv.walk(rec, *t[2:], seg, K)] for K in Ks}
    return rec.numpy(), walks


def assert_events_equal(a, b, s, K):
    rows_a, words_a, nev_a, meta_a = a
    rows_b, words_b, nev_b, meta_b = b
    assert nev_a[s] == nev_b[s]
    np.testing.assert_array_equal(meta_a[s], meta_b[s])
    n = min(int(nev_a[s]), K)
    np.testing.assert_array_equal(rows_a[s, :n], rows_b[s, :n])
    np.testing.assert_array_equal(words_a[s, :n], words_b[s, :n])


def as_tuples(edit):
    return (
        [(x.pos, x.alt) for x in edit.subs],
        [(x.pos, x.len) for x in edit.dels],
        [(x.pos, x.seq) for x in edit.inss],
    )


CASES_512 = [c[0] for c in _cases_512(np.random.default_rng(5))]


@pytest.fixture(scope="module")
def batch_512():
    cases = _cases_512(np.random.default_rng(5))
    arrays = _batch(cases, 512, 128)
    ref = reference_dp_walk(*arrays, 512, 128, Ks=(512, 64))
    port = port_dp_walk(*arrays, 512, 128, Ks=(512, 64))
    return cases, arrays, ref, port


@pytest.mark.parametrize("case", [c for c in CASES_512 if c != "pad"])
def test_dp_and_walk_match_pallas(batch_512, case):
    cases, arrays, (band, ref_walks), (rec, port_walks) = batch_512
    s = CASES_512.index(case)
    np.testing.assert_array_equal(rec[s], band[s])
    assert_events_equal(port_walks[512], ref_walks[512], s, 512)
    assert int(port_walks[512][2][s]) <= 512


def test_padding_problems_and_rows_match(batch_512):
    _cases, _arrays, (band, _), (rec, _) = batch_512
    np.testing.assert_array_equal(rec, band)


def test_event_overflow_k64(batch_512):
    """Events past K land in slot K-1 and n_events keeps counting (the
    caller's signal to retry with 4x K); both sides agree slot for slot."""
    cases, _arrays, (_, ref_walks), (_, port_walks) = batch_512
    s = CASES_512.index("dense")
    assert int(ref_walks[512][2][s]) > 64  # the pair really overflows K = 64
    assert_events_equal(port_walks[64], ref_walks[64], s, 64)
    np.testing.assert_array_equal(port_walks[64][2], ref_walks[64][2])


@pytest.fixture(scope="module")
def pipelines_512(batch_512):
    """The reference's stripe_align_v2 (its own IUPAC take and query shift)
    and the port's stripe_align on the same raw bytes."""
    _cases, arrays, _ref, _port = batch_512
    ref_seq, qry_seq, rlen, qlen, ms, W = arrays
    gmax = rlen.reshape(-1, G).max(axis=1).astype(np.int32)
    out = ref_sv.stripe_align_v2(ref_seq, qry_seq, rlen, qlen, ms, W, gmax, 512, 128, 512, G)
    port = sv.stripe_align(ref_seq, qry_seq[:, : max(int(qlen.max()), 1)], rlen, qlen, ms, W, 128, 512,
                           sv.walk_segment(512, 128), "cpu")
    return {k: np.asarray(v) for k, v in out.items()}, {k: v.numpy() for k, v in port.items()}


@pytest.mark.parametrize("case", [c for c in CASES_512 if c != "pad"])
def test_pipeline_edits_match_reference(batch_512, pipelines_512, case):
    """The port's pipeline (stripe_align + edit_from_events) against the
    reference's stripe_align_v2 + edit_from_events: equal Edits."""
    cases = batch_512[0]
    out, port = pipelines_512
    s = CASES_512.index(case)
    r, q = cases[s][1], cases[s][2]
    e_ref, ok_ref = ref_sv.edit_from_events(out["rows"][s], out["words"][s], out["n_events"][s], out["meta"][s], r, q)
    e_port, ok_port = sv.edit_from_events(port["rows"][s], port["words"][s], port["n_events"][s], port["meta"][s], r, q)
    assert ok_ref and ok_port
    assert as_tuples(e_port) == as_tuples(e_ref)
    assert np.array_equal(e_port.apply(r), q)


@pytest.mark.parametrize(
    "name,R_cap,B,n,muts",
    [
        ("multichunk", 1024, 128, 900, (20, 4, 4)),
        ("band256", 512, 256, 450, (12, 6, 6)),
        ("tier10240", 10240, 128, 2600, (30, 6, 6)),
        # the narrowest band of the CUDA DP's block layout (band256 is the
        # widest of its warp layout), and B 512
        ("band384", 512, 384, 400, (8, 4, 4)),
        ("band512", 512, 512, 400, (8, 4, 4)),
    ],
)
def test_tiers_and_bands_match_pallas(name, R_cap, B, n, muts):
    rng = np.random.default_rng(hash(name) % 2**32)
    cases = []
    for s in range(G):
        r = ACGT[rng.integers(0, 4, n - 37 * s)]
        cases.append((name, r, mutate(r, *muts, rng), int(rng.integers(-9, 10))))
    if name == "tier10240":
        # a match run longer than 1023 rows that crosses the 1024- and
        # 2048-row boundaries (the walk's segment at this tier is 2048 rows)
        r = ACGT[rng.integers(0, 4, 3000)]
        q = r.copy()
        q[[300, 1500, 2900]] = ACGT[(np.searchsorted(ACGT, r[[300, 1500, 2900]]) + 1) % 4]
        q = np.concatenate([q[:500], q[503:]])  # one deletion before the long run
        cases[-1] = (name, r, q, 0)
    arrays = _batch(cases, R_cap, B)
    band, ref_walks = reference_dp_walk(*arrays, R_cap, B, Ks=(256,))
    rec, port_walks = port_dp_walk(*arrays, R_cap, B, Ks=(256,))
    np.testing.assert_array_equal(rec, band)
    for s in range(G):
        assert_events_equal(port_walks[256], ref_walks[256], s, 256)


LONG_RUN_R_CAP = 3072  # walk_segment(3072, 256) is 1024: segment edges at rows 1024 and 2048


def _indels(r, rng, edits):
    """r with (ref position, length) edits applied from the right: length > 0
    deletes ref[pos:pos+length], length < 0 inserts -length random bases
    before ref[pos]."""
    q = r.copy()
    for pos, n in sorted(edits, reverse=True):
        q = np.concatenate([q[:pos], q[pos + n :]]) if n > 0 else np.concatenate([q[:pos], ACGT[rng.integers(0, 4, -n)], q[pos:]])
    return q


def _long_run_cases(rng):
    """(name, ref, qry, mean_shift) at B 256 with gap runs longer than a warp
    (32 lanes): the cells where a warp-wide read of a run can go wrong."""
    out = []
    for L in (31, 32, 33):  # a run one short of a warp, one warp, one past
        r = ACGT[rng.integers(0, 4, 1300)]
        out.append((f"indel{L}", r, _indels(r, rng, [(400, L), (900, -L)]), 0))
    r = ACGT[rng.integers(0, 4, 1450)]
    out.append(("indel70-110", r, _indels(r, rng, [(300, 70), (800, -110), (1200, 40)]), 0))
    # a deletion run over rows 991-1070: it crosses the segment edge at 1024
    r = ACGT[rng.integers(0, 4, 1500)]
    out.append(("del_across_segment", r, _indels(r, rng, [(990, 80), (1300, -80)]), 0))
    # the query lacks the ref's first 70 bp: a deletion run down to row 0
    r = ACGT[rng.integers(0, 4, 1100)]
    out.append(("del_to_row0", r, r[70:].copy(), 0))
    # a 75 bp insertion at the query's end: the walk starts in a run
    r = ACGT[rng.integers(0, 4, 1000)]
    out.append(("trail_ins75", r, np.concatenate([r, ACGT[rng.integers(0, 4, 75)]]), 0))
    # a 150 bp deletion in a band shifted to its edge: the walk reads
    # BOUNDARY cells and dies in the band's last lane
    r = ACGT[rng.integers(0, 4, 1400)]
    out.append(("del150_band_edge", r, _indels(r, rng, [(600, 150)]), 145))
    return out


LONG_RUN_CASES = [c[0] for c in _long_run_cases(np.random.default_rng(17))]


@pytest.fixture(scope="module")
def long_runs_256():
    """The Pallas DP + walk_v2 and stripe_align_v2, and the port's DP + walk
    and stripe_align, on the long-run batch."""
    cases = _long_run_cases(np.random.default_rng(17))
    assert len(cases) == G
    arrays = _batch(cases, LONG_RUN_R_CAP, 256)
    ref_seq, qry_seq, rlen, qlen, ms, W = arrays
    ref = reference_dp_walk(*arrays, LONG_RUN_R_CAP, 256, Ks=(256,))
    port = port_dp_walk(*arrays, LONG_RUN_R_CAP, 256, Ks=(256,))
    gmax = rlen.reshape(-1, G).max(axis=1).astype(np.int32)
    ref_out = ref_sv.stripe_align_v2(ref_seq, qry_seq, rlen, qlen, ms, W, gmax, LONG_RUN_R_CAP, 256, 256, G)
    port_out = sv.stripe_align(ref_seq, qry_seq[:, : int(qlen.max())], rlen, qlen, ms, W, 256, 256,
                               sv.walk_segment(LONG_RUN_R_CAP, 256), "cpu")
    pipelines = ({k: np.asarray(v) for k, v in ref_out.items()}, {k: v.numpy() for k, v in port_out.items()})
    return cases, ref, port, pipelines


@pytest.mark.parametrize("case", LONG_RUN_CASES)
def test_long_gap_runs_match_pallas(long_runs_256, case):
    """Gap runs of 31-150 bp at B 256: records, events and meta equal the
    Pallas kernels', and the port's pipeline gives the reference pipeline's
    Edit."""
    cases, (band, ref_walks), (rec, port_walks), (out, port) = long_runs_256
    s = LONG_RUN_CASES.index(case)
    np.testing.assert_array_equal(rec[s], band[s])
    assert_events_equal(port_walks[256], ref_walks[256], s, 256)
    r, q = cases[s][1], cases[s][2]
    e_ref, ok_ref = ref_sv.edit_from_events(out["rows"][s], out["words"][s], out["n_events"][s], out["meta"][s], r, q)
    e_port, ok_port = sv.edit_from_events(port["rows"][s], port["words"][s], port["n_events"][s], port["meta"][s], r, q)
    assert ok_port == ok_ref
    if ok_port:
        assert as_tuples(e_port) == as_tuples(e_ref)
        assert np.array_equal(e_port.apply(r), q)
    words = port_walks[256][1][s, : port_walks[256][2][s]]
    runs = np.maximum((words >> 2) & 0x7FFF, np.where(words & 3 == 2, words >> 17, 0))
    if case == "del150_band_edge":
        assert tuple(port_walks[256][3][s, 1:3]) == (1, 1)  # dead, boundary
    else:
        assert runs.max(initial=0) >= 31  # the long run is walked as a run
    if case == "del_to_row0":
        assert port_walks[256][0][s, port_walks[256][2][s] - 1] == 0  # flushed at row 0
    if case == "del_across_segment":
        x = port_walks[256][0][s, : port_walks[256][2][s]]
        assert any(x_ < 1024 < x_ + d for x_, d in zip(x, words >> 17) if d)


def test_split_match_jump_emits_no_extra_event():
    """A match run longer than 1023 rows crossing segment boundaries: walking
    it in 1024-row segments, in the tier's segments, or in one segment gives
    the same events and the same lead/dead/pending-insertion meta."""
    rng = np.random.default_rng(3)
    r = ACGT[rng.integers(0, 4, 5000)]
    q = np.concatenate([r[:700], r[704:]])  # deletion, then a 4296-row match run
    q[[100, 3000]] = ACGT[(np.searchsorted(ACGT, q[[100, 3000]]) + 2) % 4]
    arrays = _batch([("run", r, q, 0)], 8192, 128)
    t = [torch.from_numpy(a) for a in arrays]
    rec = sv.stripe_dp(*t, 128)
    outs = [[x.numpy() for x in sv.walk(rec, *t[2:], seg, 64)] for seg in (1024, sv.walk_segment(8192, 128), 8192)]
    k = len(q) + 63 - len(r)  # band lane of the walk's first cell, (rlen, qlen)
    run = int(rec[0, len(r) - 1, k].item()) & 0xFFFF
    assert run >> 6 == 1023  # the run counter is capped, so the walk lands mid-run too
    for other in outs[1:]:
        assert int(other[2][0]) == int(outs[0][2][0])
        np.testing.assert_array_equal(other[0][0, : outs[0][2][0]], outs[0][0][0, : outs[0][2][0]])
        np.testing.assert_array_equal(other[1][0, : outs[0][2][0]], outs[0][1][0, : outs[0][2][0]])
        np.testing.assert_array_equal(other[3][0, [0, 1, 3]], outs[0][3][0, [0, 1, 3]])
