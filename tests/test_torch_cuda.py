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


@pytest.mark.parametrize("B,R", [(128, 5000), (256, 3000), (2048, 1200)])
def test_ckpt_kernels_match_plain_versions(B, R):
    """The checkpoint pair on the card against its plain versions (carries of
    every window that starts at or below rlen, events and meta), and its
    events against the v2 kernels' on the same batch."""
    need_cuda()
    rng = np.random.default_rng(7 * B + R)
    t = batch(pairs(rng, 12, R // 2, R), B)
    tc = [x.cuda() for x in t]
    R_cap, K = 8192, 512
    WV = sv.ckpt_layout(B)
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
    assert sv.LAUNCHES["stripe_dp_ckpt"] == before["stripe_dp_ckpt"] + 1
    assert sv.LAUNCHES["walk_ckpt"] == before["walk_ckpt"] + 1


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
