"""Tests that need an NVIDIA GPU and nvcc: the CUDA kernels against their
plain PyTorch versions, and the batch aligner on the card against the aligner
on the CPU. They skip where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them; there, tests/conftest.py (which imports JAX) is left
out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pangraph_tpu_torch.align.params import BandedAlignParams, BandParameters
from pangraph_tpu_torch.ops import stripe_v2 as sv
from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner

pytestmark = pytest.mark.cuda

ACGT = np.frombuffer(b"ACGT", np.uint8)
IUPAC = np.frombuffer(b"NRYSWKMBDHVN", np.uint8)


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def mutate(r, rng, n_sub, n_indel, max_len=6):
    q = list(r)
    for _ in range(n_indel):
        p = int(rng.integers(5, len(q) - 5))
        L = int(rng.integers(1, max_len))
        if rng.random() < 0.5:
            del q[p : p + L]
        else:
            q[p:p] = list(ACGT[rng.integers(0, 4, L)])
    q = np.array(q, np.uint8)
    q[rng.choice(len(q), n_sub, replace=False)] = ACGT[rng.integers(0, 4, n_sub)]
    return q


def pairs(rng, m, n_lo, n_hi):
    out = []
    for _ in range(m):
        n = int(rng.integers(n_lo, n_hi))
        r = ACGT[rng.integers(0, 4, n)]
        r[rng.choice(n, 4, replace=False)] = IUPAC[rng.integers(0, len(IUPAC), 4)]
        q = mutate(r, rng, n // 60, n // 150)
        out.append((r, q, int(rng.integers(-12, 13))))
    return out


def batch(prs, B):
    m = len(prs)
    R = max(len(r) for r, _, _ in prs)
    Q = max(len(q) for _, q, _ in prs)
    ref = np.zeros((m, R), np.uint8)
    qry = np.zeros((m, Q), np.uint8)
    for s, (r, q, _) in enumerate(prs):
        ref[s, : len(r)] = r
        qry[s, : len(q)] = q
    rlen = np.array([len(r) for r, _, _ in prs], np.int32)
    qlen = np.array([len(q) for _, q, _ in prs], np.int32)
    ms = np.array([x for _, _, x in prs], np.int32)
    W = np.full(m, (B - 2) // 2, np.int32)
    return [torch.from_numpy(a) for a in (ref, qry, rlen, qlen, ms, W)]


@pytest.mark.parametrize("B,R", [(128, 1200), (256, 3000), (2048, 1200)])
def test_kernels_match_plain_versions(B, R):
    need_cuda()
    rng = np.random.default_rng(B + R)
    t = batch(pairs(rng, 24, R // 2, R), B)
    tc = [x.cuda() for x in t]
    before = dict(sv.LAUNCHES)
    rec_plain = sv.stripe_dp(*t, B)
    rec = sv.stripe_dp(*tc, B)
    live = torch.arange(rec.shape[1])[None, :] < t[2][:, None]
    assert torch.equal(rec.cpu()[live], rec_plain[live])
    for K in (64, 1024):
        seg = sv.walk_segment(4096, B)
        got = [x.cpu() for x in sv.walk(rec, *tc[2:], seg, K)]
        want = sv.walk(rec_plain, *t[2:], seg, K)
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        for s in range(len(t[2])):
            n = min(int(want[2][s]), K)
            assert torch.equal(got[0][s, :n], want[0][s, :n]) and torch.equal(got[1][s, :n], want[1][s, :n])
    assert sv.LAUNCHES["stripe_dp"] == before["stripe_dp"] + 1
    assert sv.LAUNCHES["walk"] == before["walk"] + 2


def indels(r, rng, edits):
    """r with (ref position, length) edits applied from the right: length > 0
    deletes ref[pos:pos+length], length < 0 inserts -length random bases."""
    q = r.copy()
    for pos, n in sorted(edits, reverse=True):
        q = np.concatenate([q[:pos], q[pos + n :]]) if n > 0 else np.concatenate([q[:pos], ACGT[rng.integers(0, 4, -n)], q[pos:]])
    return q


def long_run_pairs(rng, B):
    """Pairs whose walks take gap runs longer than a warp where the band
    holds them (tests/test_torch_stripe.py's long-run cases, and a band
    shifted to its edge): indels of 31, 32, 33 and 70-110 bp, a deletion
    over rows 991-1070 (across the walk's segment edge at 1024), a deletion
    down to row 0, a trailing insertion, and a deletion that runs into the
    band's last lane."""
    W = (B - 2) // 2
    out = []
    for L in (31, 32, 33):
        r = ACGT[rng.integers(0, 4, 1300)]
        out.append((r, indels(r, rng, [(400, L), (900, -L)]), 0))
    r = ACGT[rng.integers(0, 4, 1450)]
    out.append((r, indels(r, rng, [(300, 70), (800, -110), (1200, 40)]), 0))
    r = ACGT[rng.integers(0, 4, 1500)]
    out.append((r, indels(r, rng, [(990, 80), (1300, -80)]), 0))
    r = ACGT[rng.integers(0, 4, 1100)]
    out += [(r, r[70:].copy(), 0), (r, np.concatenate([r, ACGT[rng.integers(0, 4, 75)]]), 0)]
    r = ACGT[rng.integers(0, 4, 1400)]
    out.append((r, indels(r, rng, [(600, min(150, W))]), W + 18))
    return out


@pytest.mark.parametrize("B", range(128, 2049, 128))
def test_walk_long_gap_runs_match_plain(B):
    """The walk kernel, whose gap runs are read a warp's width at a time,
    against walk_plain on long gap runs at every band width, also with
    events past K."""
    need_cuda()
    t = batch(long_run_pairs(np.random.default_rng(B), B), B)
    tc = [x.cuda() for x in t]
    rec = sv.stripe_dp(*tc, B)
    rec_plain = rec.cpu()
    seg = sv.walk_segment(3072, B)
    assert seg == 1024
    before = sv.LAUNCHES["walk"]
    for K in (256, 2):
        got = [x.cpu() for x in sv.walk(rec, *tc[2:], seg, K)]
        want = sv.walk(rec_plain, *t[2:], seg, K)
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        for s in range(len(t[2])):
            n = min(int(want[2][s]), K)
            assert torch.equal(got[0][s, :n], want[0][s, :n]) and torch.equal(got[1][s, :n], want[1][s, :n])
    assert sv.LAUNCHES["walk"] == before + 2


def deletion_on_window_edge(rng, B: int, dl: int = 5):
    """tests/test_torch_stripe_ckpt.py's deletion that ends on a window edge,
    at band width B: the walk comes down a match run, then deletes rows
    WV + dl .. WV + 1 and stops on window 0's top edge."""
    WV = sv.ckpt_layout(B)
    r = ACGT[rng.integers(0, 4, 3000)]
    # a unique placement: the deletion cannot shift by one either way
    r[WV + dl] = ACGT[(np.searchsorted(ACGT, r[WV]) + 1) % 4]
    r[WV + dl - 1] = ACGT[(np.searchsorted(ACGT, r[WV - 1]) + 1) % 4]
    return r, np.concatenate([r[:WV], r[WV + dl :]]), 0


@pytest.mark.parametrize("B,R,budget_windows", [
    pytest.param(128, 5000, None, id="128-5000"), pytest.param(256, 3000, None, id="256-3000"),
    pytest.param(2048, 1200, None, id="2048-1200"), pytest.param(128, 5000, 3, id="128-5000-waves"),
    pytest.param(2048, 1200, 2, id="2048-1200-waves")])
def test_ckpt_kernels_match_plain_versions(B, R, budget_windows, monkeypatch):
    """The checkpoint pair on the card against its plain versions (carries of
    every window that starts at or below rlen, events and meta), and its
    events against the v2 kernels' on the same batch. The batch ends with a
    deletion that ends on a window edge; with budget_windows, the walk's
    scratch holds that many windows, so its windows go in several waves."""
    need_cuda()
    rng = np.random.default_rng(7 * B + R)
    t = batch(pairs(rng, 12, R // 2, R) + [deletion_on_window_edge(rng, B)], B)
    tc = [x.cuda() for x in t]
    R_cap, K = 8192, 512
    WV = sv.ckpt_layout(B)
    if budget_windows:
        monkeypatch.setattr(sv, "WALK_CKPT_SCRATCH_BYTES", budget_windows * WV * B * 2)
        assert len(sv.walk_ckpt_plan(len(t[2]), t[0].shape[1], B, sv.ckpt_windows(R_cap, B))[2]) > 5
    before = dict(sv.LAUNCHES)
    ck_plain = sv.stripe_dp_ckpt(*t, B, R_cap)
    ck = sv.stripe_dp_ckpt(*tc, B, R_cap).cpu()
    live = torch.arange(ck.shape[1])[None, :] * WV <= t[2][:, None]
    assert torch.equal(ck[live], ck_plain[live])
    got = [x.cpu() for x in sv.walk_ckpt(ck.cuda(), *tc, K)]
    want = sv.walk_ckpt(ck_plain, *t, K)
    v2 = [x.cpu() for x in sv.walk(sv.stripe_dp(*tc, B), *tc[2:], sv.walk_segment(R_cap, B), K)]
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]) and torch.equal(got[2], v2[2])
    for s in range(len(t[2])):
        n = min(int(want[2][s]), K)
        for a in (0, 1):
            assert torch.equal(got[a][s, :n], want[a][s, :n]) and torch.equal(got[a][s, :n], v2[a][s, :n])
    assert got[2][-1] == 1 and got[0][-1, 0] == WV and got[1][-1, 0] == 2 | 5 << 17  # the deletion, at row WV
    assert sv.LAUNCHES["stripe_dp_ckpt"] == before["stripe_dp_ckpt"] + 1
    assert sv.LAUNCHES["walk_ckpt"] == before["walk_ckpt"] + 1


def layout_pairs(rng, B):
    """(ref, qry, mean shift) pairs for the DP kernel's layouts: rlen 0 and
    rlen 1; rows that cross many 32-row stages, several 128-row chunk rows
    and (at every B) checkpoint windows; a query longer than rlen + B; and
    bands shifted past the query's start and past its end."""
    W = (B - 2) // 2
    out = [(np.zeros(0, np.uint8), ACGT[rng.integers(0, 4, 40)], 0), (ACGT[:1].copy(), ACGT[rng.integers(0, 4, 3)], 0)]
    out += pairs(rng, 3, 300, 2300)
    r = ACGT[rng.integers(0, 4, 500)]
    out.append((r, np.concatenate([mutate(r, rng, 5, 3), ACGT[rng.integers(0, 4, B + 200)]]), 0))
    r = ACGT[rng.integers(0, 4, 700)]
    q = mutate(r, rng, 10, 4)
    out += [(r, q, W + 40), (r, q, -W - 40), (r, q, len(q) - len(r) + W // 2)]
    return out


@pytest.mark.parametrize("B", range(128, 2049, 128))
def test_dp_layouts_match_plain_versions(B):
    """Both DP modes and the checkpoint walk (whose re-derive runs the DP's
    row step) against their plain versions at every band width, on each side
    of the warp/block layout switch."""
    need_cuda()
    t = batch(layout_pairs(np.random.default_rng(B), B), B)
    tc = [x.cuda() for x in t]
    rec = sv.stripe_dp(*tc, B).cpu()
    rec_plain = sv.stripe_dp(*t, B)
    live = torch.arange(rec.shape[1])[None, :] < t[2][:, None]
    assert torch.equal(rec[live], rec_plain[live])
    R_cap, K = 2560, 512
    WV = sv.ckpt_layout(B)
    ck = sv.stripe_dp_ckpt(*tc, B, R_cap)
    ck_plain = sv.stripe_dp_ckpt(*t, B, R_cap)
    live = torch.arange(ck.shape[1])[None, :] * WV <= t[2][:, None]
    assert torch.equal(ck.cpu()[live], ck_plain[live])
    got = [x.cpu() for x in sv.walk_ckpt(ck, *tc, K)]
    want = sv.walk_ckpt(ck_plain, *t, K)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for s in range(len(t[2])):
        n = min(int(want[2][s]), K)
        assert torch.equal(got[0][s, :n], want[0][s, :n]) and torch.equal(got[1][s, :n], want[1][s, :n])


@pytest.mark.parametrize("ckpt_bytes", [None, 0], ids=["stripe", "ckpt"])
def test_align_many_on_the_card_matches_the_cpu(ckpt_bytes):
    need_cuda()
    rng = np.random.default_rng(9)
    jobs = [AlignJob(r, q, BandParameters(ms, 20)) for r, q, ms in pairs(rng, 40, 200, 6000)]
    cpu = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=ckpt_bytes).align_many(jobs)
    BatchAligner.reset_engine_stats()
    gpu = BatchAligner(BandedAlignParams(), 5, 4, device="cuda", ckpt_paths_bytes=ckpt_bytes).align_many(jobs)
    report = BatchAligner.engine_report()
    assert report["device_cells_frac"] == 1.0
    assert set(report["device_routes"]) == {"ckpt" if ckpt_bytes == 0 else "stripe"}
    for a, b, j in zip(gpu, cpu, jobs):
        assert a == b
        assert np.array_equal(a.apply(j.ref), j.qry)


def test_gated_round_on_the_card(monkeypatch):
    """The first CUDA aligner times a host-to-card round trip
    (MEASURED_RTT > 0); under a host-leg budget the adaptive split gates
    the round: a probe leg on the card beside the budget's host leg, and
    every Edit reproduces its query."""
    need_cuda()
    rng = np.random.default_rng(31)
    jobs = [AlignJob(r, q, BandParameters(ms, 20)) for r, q, ms in pairs(rng, 12, 400, 3000)]
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cuda")
    assert BatchAligner.MEASURED_RTT is not None and BatchAligner.MEASURED_RTT > 0
    cells = sorted(al._job_cells(j, 25) for j in jobs)
    monkeypatch.setattr(BatchAligner, "NATIVE_CELL_BUDGET", cells[0])
    BatchAligner.reset_engine_stats()
    assert al.gated()
    edits = al.align_many(jobs)
    first = BatchAligner.GATE_LOG[0]
    assert first["gate"] == "probe" and first["kind"] == "probe" and first["host"] == cells[0]
    assert first["L"] == max(BatchAligner.DEV_LATENCY_S, min(BatchAligner.MEASURED_RTT, 1.0))
    report = BatchAligner.engine_report()
    assert report["device"]["cells"] > 0 and report["host"]["cells"] > 0
    assert report["gate"]["measured_rtt_s"] == BatchAligner.MEASURED_RTT
    for a, j in zip(edits, jobs):
        assert np.array_equal(a.apply(j.ref), j.qry)


@pytest.mark.parametrize("ckpt", [False, True], ids=["stripe", "ckpt"])
def test_batch_launches_do_not_wait_for_the_stream(ckpt):
    """stripe_align and stripe_align_ckpt (the batch path) upload and launch
    without a synchronizing call: under torch's sync debug mode "error" they
    queue everything, the decode included, and their outputs equal the plain
    versions'."""
    need_cuda()
    rng = np.random.default_rng(23)
    B, K, R_cap = 128, 256, 4096
    arrays = [a.numpy() for a in batch(pairs(rng, 12, 300, 2500), B)]
    if ckpt:
        run = lambda dev: sv.stripe_align_ckpt(*arrays, B, K, R_cap, dev)  # noqa: E731
    else:
        run = lambda dev: sv.stripe_align(*arrays, B, K, sv.walk_segment(R_cap, B), dev)  # noqa: E731
    run("cuda")  # warm up: the kernels' libraries and the IUPAC table on the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run("cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = run("cpu")
    got = {k: v.cpu() for k, v in out.items()}
    assert torch.equal(got["n_events"], want["n_events"]) and torch.equal(got["meta"], want["meta"])
    for s in range(len(arrays[2])):
        n = min(int(want["n_events"][s]), K)
        assert torch.equal(got["rows"][s, :n], want["rows"][s, :n])
        assert torch.equal(got["words"][s, :n], want["words"][s, :n])
    assert_decodes_equal(out, want)


def decode_pairs(rng, m, R_cap, deletions_only=False):
    """m (ref, qry, 0) of lengths up to the tier R_cap, and IUPAC codes in
    ref: 10 substitutions a kb and 12 indels, or only deletions (12 runs),
    which an alignment takes without a substitution."""
    out = []
    for _ in range(m):
        n = int(rng.integers(R_cap * 3 // 5, R_cap - 64))
        r = ACGT[rng.integers(0, 4, n)]
        r[rng.choice(n, 4, replace=False)] = IUPAC[rng.integers(0, len(IUPAC), 4)]
        if deletions_only:
            starts = np.sort(rng.choice(np.arange(10, n - 20, 12), 12, replace=False))
            q = np.delete(r, np.concatenate([np.arange(a, a + int(rng.integers(1, 6))) for a in starts]))
        else:
            q = mutate(r, rng, n // 100, 12)
        out.append((r, q, 0))
    return out


def run_route(route, arrays, B, K, R_cap):
    if route == "ckpt":
        return sv.stripe_align_ckpt(*arrays, B, K, R_cap, "cuda")
    return sv.stripe_align(*arrays, B, K, sv.walk_segment(R_cap, B), "cuda")


def plain_decode(walk, arrays):
    """decode_events_plain on the CPU from the card's walk outputs."""
    return sv.decode_events_plain(*(walk[k].cpu() for k in ("rows", "words", "n_events", "meta")),
                                  *(torch.from_numpy(a) for a in arrays[:4]))


def assert_decodes_equal(got, want):
    """The card's decode against the plain one: every head column but the
    offsets, the totals, and each problem's substitutions and events; the
    card's reserved spans tile its written prefix."""
    got = {k: v.cpu() for k, v in got.items()}
    assert torch.equal(got["totals"], want["totals"])
    cols = [0, 1, 2, 3, 5, 7]
    assert torch.equal(got["head"][:, cols], want["head"][:, cols])
    for (a, n, col) in ((4, 5, ("sub_pos", "sub_alt")), (6, 7, ("evs",))):
        spans = sorted((int(h[a]), int(h[n])) for h in got["head"])
        end = 0
        for o, c in spans:
            assert o == end or c == 0
            end = max(end, o + c)
        assert end == int(got["totals"][0 if a == 4 else 1])
        for hg, hw in zip(got["head"].tolist(), want["head"].tolist()):
            for k in col:
                assert torch.equal(got[k][hg[a] : hg[a] + hg[n]], want[k][hw[a] : hw[a] + hw[n]])


# the headline's length tiers and bands (PERF.md §4)
DECODE_SHAPES = [(4096, 128), (10240, 512), (16384, 1408), (65536, 1664), (131072, 1920), (131072, 128)]


@pytest.mark.parametrize("route", ["stripe", "ckpt"])
@pytest.mark.parametrize("R_cap,B", DECODE_SHAPES)
def test_decode_kernel_matches_plain_version(R_cap, B, route):
    """decode_events on the card after the walk (stripe_align) or the
    checkpoint walk (stripe_align_ckpt) equals decode_events_plain on the
    same walk outputs, problem for problem."""
    need_cuda()
    rng = np.random.default_rng(R_cap + B)
    K = 1024
    arrays = [a.numpy() for a in batch(decode_pairs(rng, 4, R_cap), B)]
    before = sv.LAUNCHES["decode_events"]
    out = run_route(route, arrays, B, K, R_cap)
    torch.cuda.synchronize()
    assert sv.LAUNCHES["decode_events"] == before + 1
    want = plain_decode(out, arrays)
    assert (want["head"][:, 0] == sv.DECODE_OK).all() and int(want["totals"][0]) > 0
    assert_decodes_equal(out, want)


@pytest.mark.parametrize("kind", ["dead", "out_of_order", "no_substitutions"])
def test_decode_kernel_launches_of_one_kind(kind):
    """A launch whose every walk died and one whose events are out of order,
    as only a faulty walk gives them (both all DECODE_FAILED, nothing
    written), and one with deletions and no substitution (totals[0] == 0):
    the kernel equals the plain version."""
    need_cuda()
    rng = np.random.default_rng(41)
    R_cap, B, K = 10240, 256, 256
    prs = decode_pairs(rng, 6, R_cap, deletions_only=kind == "no_substitutions")
    arrays = [a.numpy() for a in batch(prs, B)]
    out = run_route("stripe", arrays, B, K, R_cap)
    walk = {k: out[k].clone() for k in ("rows", "words", "n_events", "meta")}
    if kind == "dead":
        walk["meta"][:, 1] = 1
    elif kind == "out_of_order":
        assert bool((walk["n_events"] >= 2).all())
        walk["rows"][:, :2] = walk["rows"][:, :2].flip(1).clone()
        walk["words"][:, :2] = walk["words"][:, :2].flip(1).clone()
    dev = torch.device("cuda")
    got = sv.decode_events(*walk.values(), *(torch.from_numpy(a).to(dev) for a in arrays[:4]))
    want = plain_decode(walk, arrays)
    status = {"dead": sv.DECODE_FAILED, "out_of_order": sv.DECODE_FAILED, "no_substitutions": sv.DECODE_OK}[kind]
    assert (want["head"][:, 0] == status).all()
    assert int(want["totals"][0]) == 0 and (int(want["totals"][1]) > 0) == (kind == "no_substitutions")
    assert_decodes_equal(got, want)


@pytest.mark.parametrize("ckpt_bytes", [None, 0], ids=["stripe", "ckpt"])
def test_packed_fetch_reads_every_byte_it_copies(ckpt_bytes):
    """On the card the aligner fetches each launch's head, totals and the
    written part of the packed arrays, and reads all of it (the bytes
    engine_report()["fetch"] counts); every problem is decoded on the card,
    to the CPU aligner's Edits."""
    need_cuda()
    rng = np.random.default_rng(9)
    jobs = [AlignJob(r, q, BandParameters(ms, 20)) for r, q, ms in pairs(rng, 24, 200, 6000)]
    cpu = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=ckpt_bytes).align_many(jobs)
    BatchAligner.reset_engine_stats()
    gpu = BatchAligner(BandedAlignParams(), 5, 4, device="cuda", ckpt_paths_bytes=ckpt_bytes).align_many(jobs)
    report = BatchAligner.engine_report()
    assert gpu == cpu
    assert report["decode"]["host"] == 0 and report["decode"]["device"] >= len(jobs)
    assert report["fetch"]["bytes"] > 0


def _codes(rng, m, L_pad, lengths):
    """An int32 code batch: TWOBIT codes of random rows with N at 4%
    (code 4), padded with 4."""
    codes = np.full((m, L_pad), 4, np.int32)
    for i, n in enumerate(lengths):
        codes[i, :n] = rng.choice(5, n, p=[0.24, 0.24, 0.24, 0.24, 0.04])
    return codes


# beside the main path's parameters: the kernel's switch from 32-bit to 64-bit
# words (k 16 and 17), from one packed key to a (value, position) pair (k 23
# and 24, and 25), windows of one and two positions, and the halo limits
SKETCH_SEAMS = [(16, 2), (17, 1), (23, 2), (24, 1), (25, 100), (19, 367), (32, 354)]


@pytest.mark.parametrize("k,w", [(15, 100), (19, 19), (7, 5), (32, 40)] + SKETCH_SEAMS)
def test_sketch_kernel_matches_plain_version(k, w):
    from pangraph_tpu_torch.ops import sketch_k1 as sk

    need_cuda()
    rng = np.random.default_rng(k * 1000 + w)
    L_pad = 40 * sk.C
    codes = torch.from_numpy(_codes(rng, 9, L_pad, rng.integers(L_pad // 2, L_pad, 9)))
    before = sk.LAUNCHES["sketch"]
    val, ps = sk.sketch_dense(codes.cuda(), k, w)
    want_val, want_ps = sk.sketch_dense(codes, k, w)
    assert torch.equal(val.cpu(), want_val) and torch.equal(ps.cpu(), want_ps)
    assert sk.LAUNCHES["sketch"] == before + 1


def _sketch_batch(rng, kind, k):
    """Code batches whose shapes cross the kernel's tiles: one row of many
    tiles (its window starts not a multiple of a tile's), several thousand
    short rows, rows of all N beside a row of one even-k palindrome
    repeated (every k-mer its own reverse complement) and random rows, and
    random rows that the test places off 16-byte alignment, which the
    kernel's 16-byte loads refuse."""
    if kind == "one_long_row":
        return _codes(rng, 1, 203 * 512, [203 * 512 - 300])
    if kind == "many_short_rows":
        return _codes(rng, 3000, 1024, rng.integers(1, 1024, 3000))
    if kind == "unaligned_codes":
        return _codes(rng, 3, 9 * 512, rng.integers(3000, 9 * 512, 3))
    codes = _codes(rng, 6, 12 * 512, rng.integers(3000, 12 * 512, 6))
    codes[1:3] = 4  # all N
    codes[3, :5000] = np.resize([0, 3], 5000)  # ATAT...
    return codes


@pytest.mark.parametrize("kind", ["one_long_row", "many_short_rows", "all_n_and_palindromes", "unaligned_codes"])
@pytest.mark.parametrize("k,w", [(15, 100), (19, 19), (16, 2), (17, 1), (24, 1), (32, 354)])
def test_sketch_kernel_tiles_and_edge_rows(k, w, kind):
    from pangraph_tpu_torch.ops import sketch_k1 as sk

    need_cuda()
    codes = torch.from_numpy(_sketch_batch(np.random.default_rng(7 * k + w), kind, k)).cuda()
    if kind == "unaligned_codes":  # a contiguous view one int32 into its storage
        buf = torch.empty(codes.numel() + 1, dtype=torch.int32, device=codes.device)
        buf[1:] = codes.flatten()
        codes = buf[1:].view(codes.shape)
        assert codes.is_contiguous() and codes.data_ptr() % 16
        before = sk.LAUNCHES["sketch"]
        with pytest.raises(ValueError, match="16-byte aligned"):
            sk.sketch_dense(codes, k, w)
        assert sk.LAUNCHES["sketch"] == before
        return
    val, ps = sk.sketch_dense(codes, k, w)
    want_val, want_ps = sk.sketch_dense_plain(codes, k, w)
    assert torch.equal(val, want_val) and torch.equal(ps, want_ps)
    if kind == "all_n_and_palindromes":
        assert bool((val[1:3] == -1).all())
        if k % 2 == 0:
            assert bool((val[3, :4000] == -1).all())


def _clouds(rng, sizes, L=2_000_000):
    """Anchor sets sorted by (r, q): co-linear chains with drift plus noise."""
    sets = []
    for n in sizes:
        m = n // 4
        steps = rng.integers(5, 400, (3, m))
        r = rng.integers(0, L // 2, (3, 1)) + np.cumsum(steps, 1)
        q = rng.integers(0, L // 2, (3, 1)) + np.cumsum(steps, 1) + np.cumsum(rng.integers(-3, 4, (3, m)), 1)
        r = np.concatenate([r.ravel(), rng.integers(0, L, n - 3 * m)])
        q = np.concatenate([q.ravel(), rng.integers(0, L, n - 3 * m)])
        o = np.lexsort((q, r))
        sets.append((r[o].astype(np.int64), q[o].astype(np.int64)))
    return sets


@pytest.mark.parametrize("H", [1, 8, 32, 40, 1024])
def test_chain_kernel_matches_plain_version(H):
    from pangraph_tpu_torch.ops import chain_k2 as ch

    need_cuda()
    rng = np.random.default_rng(H)
    sets = _clouds(rng, [1, 0, 37, 2100, 5000, 64])
    packed = [torch.from_numpy(a) for a in ch.pack_sets(sets)]
    before = ch.LAUNCHES["chain"]
    f, parent = ch.chain_sets(*(t.cuda() for t in packed), 19, 10_000, 1_000, H)
    want_f, want_p = ch.chain_sets(*packed, 19, 10_000, 1_000, H)
    assert torch.equal(f.cpu(), want_f) and torch.equal(parent.cpu(), want_p)
    assert ch.LAUNCHES["chain"] == before + 1
    # one set per launch gives what the ragged batch gives
    o = packed[2].numpy()
    for s, (r, q) in enumerate(sets):
        f1, p1 = ch.chain_dp(r, q, 19, 10_000, 1_000, H)
        assert np.array_equal(f1, f.cpu().numpy()[o[s] : o[s + 1]])
        assert np.array_equal(p1, parent.cpu().numpy()[o[s] : o[s + 1]])


def test_chain_kernel_past_the_key_bound():
    """At H 32, sets whose k * n passes the keyed loop's bound take the
    kernel's two-reduction loop, beside sets that take the keyed loop, in
    one launch; both equal the plain version."""
    from pangraph_tpu_torch.ops import chain_k2 as ch

    need_cuda()
    sets = _clouds(np.random.default_rng(3), [4000, 300, 5000, 0, 37])
    packed = [torch.from_numpy(a) for a in ch.pack_sets(sets)]
    k = 20_000  # 20,000 * 4,000 anchors passes 2^26
    assert ch.key_path(packed[2], k, 1000, 32).tolist() == [0, 1, 0, 1, 1]
    before = ch.LAUNCHES["chain"]
    f, parent = ch.chain_sets(*(t.cuda() for t in packed), k, 10_000, 1_000, 32)
    want_f, want_p = ch.chain_sets(*packed, k, 10_000, 1_000, 32)
    assert torch.equal(f.cpu(), want_f) and torch.equal(parent.cpu(), want_p)
    assert (want_p >= 0).sum() > 1000  # chains formed
    assert ch.LAUNCHES["chain"] == before + 1
