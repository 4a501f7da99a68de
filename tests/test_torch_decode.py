"""The decode of the walk's events (stripe_v2.decode_events, its plain
version on the CPU) held against the host decode, edit_from_events, job for
job: the same ok, and where ok the same Edit, built from the packed arrays
by decoded_edit. Events come from the plain walk and the plain checkpoint
walk (stripe_align and stripe_align_ckpt on the CPU) on random problems;
the cases that walks do not give by themselves (a pending insertion, a dead
walk, a length mismatch with no events, events out of order or past the
reference) change the walk's outputs before the decode. Events out of order
or past the reference come only from a faulty walk: the decode fails those
problems, and the aligner gives them its host fallback."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pangraph_tpu_torch.align.params import BandedAlignParams, BandParameters
from pangraph_tpu_torch.ops import stripe_v2 as sv
from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner

ACGT = np.frombuffer(b"ACGT", np.uint8)
B = 128
R_CAP = 4096
WALK = ("rows", "words", "n_events", "meta")


def mutate(r, rng, n_sub, n_indel, max_len=8):
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


def random_pairs(rng, m, n_sub, n_indel):
    out = []
    for _ in range(m):
        r = ACGT[rng.integers(0, 4, int(rng.integers(200, 600)))]
        out.append((r, mutate(r, rng, n_sub, n_indel), 0))
    return out


def delete_then_insert(rng):
    """A run of A deleted and a run of C inserted in its place: no C matches
    an A, so the alignment deletes and inserts side by side. The walk takes
    a deletion first where both orders score the same, which puts the
    insertion first in forward order; a mean shift that sets the diagonal
    near the band's top lane leaves no room for the insertion first, so
    the insertion follows the deletion."""
    out = []
    for n_del, n_ins, shift in ((30, 20, 0), (30, 20, 60), (22, 14, 61)):
        left, right = ACGT[rng.integers(0, 4, 150)], ACGT[rng.integers(0, 4, 200)]
        r = np.concatenate([left, np.full(n_del, ord("A"), np.uint8), right])
        out.append((r, np.concatenate([left, np.full(n_ins, ord("C"), np.uint8), right]), shift))
    return out


def _swap_two(walk, _rlen):
    rows, words = walk["rows"], walk["words"]
    many = np.flatnonzero(walk["n_events"] >= 2)
    rows[many, :2] = rows[many, 1::-1].copy()
    words[many, :2] = words[many, 1::-1].copy()
    return many


def _past_end(walk, rlen):
    has = np.flatnonzero(walk["n_events"] >= 1)
    walk["rows"][has, 0] = rlen[has] + 5
    return has


def _pending(walk, _rlen):
    walk["meta"][:, 3] = walk["meta"][:, 0] // 2
    walk["meta"][:, 0] -= walk["meta"][:, 3]
    return np.flatnonzero(walk["meta"][:, 3] > 0)


def _dead(walk, _rlen):
    walk["meta"][::2, 1] = 1
    return np.arange(0, len(walk["meta"]), 2)


def _lengths_differ(walk, _rlen):
    walk["meta"][:, 0] += 1
    return np.arange(len(walk["meta"]))


# case: (problems from a seeded rng, K, a change to the walk's outputs (and
# the problems' rlen) that returns the problems it changed, what the case
# must show)
CASES = {
    "substitutions_only": (lambda rng: random_pairs(rng, 4, 12, 0), 64, None, "subs"),
    "deletion_and_insertion_runs": (lambda rng: random_pairs(rng, 5, 6, 6), 64, None, "runs"),
    "insertion_right_after_a_deletion": (delete_then_insert, 64, None, "del_ins"),
    "leading_insertion": (lambda rng: [(r, np.concatenate([ACGT[rng.integers(0, 4, 9 + 4 * s)], q]), 0)
                                       for s, (r, q, _) in enumerate(random_pairs(rng, 3, 5, 2))], 64, None, "lead"),
    "pending_insertion": (lambda rng: [(r, np.concatenate([ACGT[rng.integers(0, 4, 14)], q]), 0)
                                       for r, q, _ in random_pairs(rng, 3, 5, 2)], 64, _pending, "ok"),
    "no_events_lengths_match": (lambda rng: [(r, r.copy(), 0) for r, _q, _ in random_pairs(rng, 3, 0, 0)], 64,
                                None, "no_events"),
    "no_events_lengths_differ": (lambda rng: random_pairs(rng, 3, 9, 0), 64, _lengths_differ, "failed"),
    "dead_walk": (lambda rng: random_pairs(rng, 4, 6, 4), 64, _dead, "failed"),
    "events_past_k": (lambda rng: random_pairs(rng, 3, 4, 12), 4, None, "overflow"),
    "events_out_of_order": (lambda rng: random_pairs(rng, 4, 6, 6), 64, _swap_two, "faulty"),
    "event_past_the_reference": (lambda rng: random_pairs(rng, 3, 6, 6), 64, _past_end, "faulty"),
}


def batch(prs):
    """(ref, qry, rlen, qlen, ms, W) of (ref, qry, mean shift) triples."""
    m = len(prs)
    ref = np.zeros((m, max(len(r) for r, _q, _ in prs)), np.uint8)
    qry = np.zeros((m, max(len(q) for _r, q, _ in prs)), np.uint8)
    for s, (r, q, _) in enumerate(prs):
        ref[s, : len(r)], qry[s, : len(q)] = r, q
    rlen = np.array([len(r) for r, _q, _ in prs], np.int32)
    qlen = np.array([len(q) for _r, q, _ in prs], np.int32)
    ms = np.array([x for _r, _q, x in prs], np.int32)
    return ref, qry, rlen, qlen, ms, np.full(m, (B - 2) // 2, np.int32)


def run(route, arrays, K):
    if route == "ckpt":
        return sv.stripe_align_ckpt(*arrays, B, K, R_CAP, "cpu")
    return sv.stripe_align(*arrays, B, K, sv.walk_segment(R_CAP, B), "cpu")


def check_against_host(decoded, walk, prs, K, faulty=()):
    """Every problem's head row against its walk's outputs and, but for the
    `faulty` problems (whose events a walk does not give, which must fail),
    against edit_from_events. Returns each problem's (status, ok, Edit or
    None)."""
    head = decoded["head"].numpy()
    n_sub, n_ev = decoded["totals"].tolist()
    sub_pos, sub_alt = decoded["sub_pos"][:n_sub].tolist(), decoded["sub_alt"][:n_sub].tolist()
    evs = decoded["evs"][:n_ev].tolist()
    spans = sorted((int(h[4]), int(h[5])) for h in head) + sorted((int(h[6]), int(h[7])) for h in head)
    assert sum(c for _o, c in spans) == n_sub + n_ev
    out = []
    for s, (r, q, _) in enumerate(prs):
        h = head[s].tolist()
        meta = walk["meta"][s]
        assert h[1:4] == [meta[2], walk["n_events"][s], meta[0] + meta[3]]
        assert h[4] + h[5] <= n_sub and h[6] + h[7] <= n_ev
        if s in faulty:
            assert h[0] == sv.DECODE_FAILED and h[5] == h[7] == 0
            out.append((h[0], None, None))
            continue
        edit, ok = sv.edit_from_events(*(walk[k][s] for k in WALK), r, q)
        assert ok == (h[0] == sv.DECODE_OK), (s, h)
        if ok:
            assert sv.decoded_edit(h, sub_pos, sub_alt, evs, q) == edit
            assert np.array_equal(edit.apply(r), q)
        else:
            assert h[5] == h[7] == 0
        out.append((h[0], ok, edit))
    return out


@pytest.mark.parametrize("route", ["stripe", "ckpt"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_decode_equals_edit_from_events(case, route):
    make, K, change, shows = CASES[case]
    prs = make(np.random.default_rng(sorted(CASES).index(case) + 7))
    arrays = batch(prs)
    out = run(route, arrays, K)
    walk = {k: out[k].numpy().copy() for k in WALK}
    changed = []
    if change is None:
        decoded = {k: v for k, v in out.items() if k not in WALK}
    else:
        changed = change(walk, arrays[2])
        assert len(changed)
        decoded = sv.decode_events(*(torch.from_numpy(walk[k]) for k in WALK),
                                   *(torch.from_numpy(a) for a in arrays[:4]))
    got = check_against_host(decoded, walk, prs, K, set(changed) if shows == "faulty" else ())
    status = [g[0] for g in got]
    n = walk["n_events"]
    d_events = [((walk["words"][s, e] & 3) == sv.OP_D, (walk["words"][s, e] >> 2) & 0x7FFF)
                for s in range(len(prs)) for e in range(min(n[s], K))]
    if shows == "subs":
        assert all(s == sv.DECODE_OK for s in status) and (n == 0).all() and decoded["totals"][0] > 0
    elif shows == "runs":
        assert all(s == sv.DECODE_OK for s in status)
        assert any(d and i == 0 for d, i in d_events) and any(not d and i > 0 for d, i in d_events)
    elif shows == "del_ins":
        assert all(s == sv.DECODE_OK for s in status) and any(d and i > 0 for d, i in d_events)
    elif shows == "lead":
        assert all(s == sv.DECODE_OK for s in status) and (walk["meta"][:, 0] > 0).all()
    elif shows == "ok":
        assert all(s == sv.DECODE_OK for s in status)
    elif shows == "no_events":
        assert all(s == sv.DECODE_OK for s in status) and (n == 0).all() and decoded["totals"].tolist() == [0, 0]
    elif shows == "failed":
        assert all(status[s] == sv.DECODE_FAILED for s in changed)
    elif shows == "overflow":
        assert (n > K).all() and all(s == sv.DECODE_FAILED for s in status)
    else:
        assert [s for s in range(len(prs)) if status[s] == sv.DECODE_FAILED] == sorted(changed)


def test_problems_left_to_the_host_decode_to_the_same_edits(monkeypatch):
    """Where a walk's events are out of order (a faulty walk), the decode
    fails the problem and the aligner leaves it to the host, as a dead walk:
    the host fallback gives the same Edits as the card's decode, and the
    decode counter moves from "device" to "host". The fetch copies what the
    host reads and nothing more."""
    rng = np.random.default_rng(5)
    jobs = [AlignJob(r, q, BandParameters(0, 20)) for r, q, _ in random_pairs(rng, 6, 8, 4)]
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    BatchAligner.reset_engine_stats()
    want = al.align_many(jobs)
    report = BatchAligner.engine_report()
    assert report["decode"] == {"device": len(jobs), "host": 0}
    assert report["fetch"]["bytes"] > 0
    decode = sv.decode_events
    swapped = []

    def faulty(rows, words, n_events, meta, *rest):
        rows, words = rows.clone(), words.clone()
        many = torch.nonzero(n_events >= 2).flatten()
        rows[many, :2] = rows[many, :2].flip(1)
        words[many, :2] = words[many, :2].flip(1)
        out = decode(rows, words, n_events, meta, *rest)
        assert (out["head"][many, 0] == sv.DECODE_FAILED).all() and not meta[many, 2].any()
        swapped.append(len(many))
        return out

    monkeypatch.setattr(sv, "decode_events", faulty)
    BatchAligner.reset_engine_stats()
    assert al.align_many(jobs) == want
    report = BatchAligner.engine_report()
    assert sum(swapped) > 0
    assert report["decode"] == {"device": len(jobs) - sum(swapped), "host": sum(swapped)}
    assert report["fetch"]["bytes"] > 0
    BatchAligner.reset_engine_stats()
    assert BatchAligner.engine_report()["decode"] == {"device": 0, "host": 0}
