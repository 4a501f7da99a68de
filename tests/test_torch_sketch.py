"""The port's minimizer sketch (pangraph_tpu_torch/ops/sketch_k1.py) held
against the Pallas kernel of pangraph_tpu/ops/sketch_k1.py, run in interpret
mode on the CPU as tests/test_sketch_k1.py runs it, and against
sketch_numpy.

Every comparison is exact: the sketch is integer arithmetic. The dense
outputs are compared element for element on every column, sentinel windows
and padding included. Inputs are made with numpy from a seed; each JAX
reference is computed once per module."""
from __future__ import annotations

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU beside torch in one process)
import numpy as np
import pytest
import torch

from pangraph_tpu.align.minimizer import jenkins_hash, sketch_numpy
from pangraph_tpu.ops.sketch_k1 import sketch_pallas, sketch_pallas_batch
from pangraph_tpu_torch.graph.seq import TWOBIT
from pangraph_tpu_torch.ops import sketch_k1 as sk

ACGTN = np.frombuffer(b"ACGTN", np.uint8)
PARAMS = [(15, 100), (19, 19), (7, 5)]
# the CUDA kernel's seams: its switch from 32-bit to 64-bit words (k 16,
# 17), from one packed key to a (value, position) pair (k 23, 24, 25), and
# windows of one and two positions
SEAMS = [(16, 2), (17, 1), (23, 2), (24, 1), (25, 2)]
ROWS = [1, 3, 9]


def _seq(rng, n, lower=False):
    s = ACGTN[rng.choice(5, n, p=[0.24, 0.24, 0.24, 0.24, 0.04])]
    return np.frombuffer(bytes(s).lower(), np.uint8).copy() if lower else s


def _batch(k, w, m):
    """An (m, L_pad) code batch of rows up to ~5,000 bp, N at 4%, every
    third row lowercase, padded with 4 as sketch_pallas pads."""
    rng = np.random.default_rng(1000 * k + 10 * w + m)
    seqs = [_seq(rng, int(rng.integers(w + k, 5000)), lower=i % 3 == 2) for i in range(m)]
    n_w = max(len(s) - k - w + 2 for s in seqs)
    L_pad = ((n_w + sk.C - 1) // sk.C + 1) * sk.C
    codes = np.full((m, L_pad), 4, np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = TWOBIT[s]
    return codes


@pytest.fixture(scope="module")
def dense_refs():
    """{(k, w, m): (codes, the Pallas kernel's (hi, lo, ps))}."""
    out = {}
    for k, w in PARAMS + SEAMS:
        for m in ROWS:
            codes = _batch(k, w, m)
            out[(k, w, m)] = codes, sketch_pallas_batch(codes, k, w)
    return out


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,w", PARAMS + SEAMS)
def test_dense_sketch_equals_pallas(dense_refs, k, w, m):
    codes, want = dense_refs[(k, w, m)]
    before = dict(sk.LAUNCHES)
    got = sk.sketch_batch(codes, k, w, device="cpu")
    for name, g, r in zip(("hi", "lo", "ps"), got, want):
        assert g.dtype == np.int32 and g.shape == r.shape == (m, codes.shape[1] - sk.C), name
        assert np.array_equal(g, r), name
    assert sk.LAUNCHES == before  # the plain version counts no launch


def _assert_same(a, b, ctx):
    assert np.array_equal(a.values, b.values), ctx
    assert np.array_equal(a.positions, b.positions), ctx
    assert np.array_equal(a.strands, b.strands), ctx


@pytest.mark.parametrize("k,w", PARAMS)
def test_sketch_one_equals_pallas_and_numpy(k, w):
    rng = np.random.default_rng(k + w)
    for trial, n in enumerate((w + k - 1, 600, 2500)):
        seq = _seq(rng, n, lower=trial == 1)
        got = sk.sketch_one(seq, k, w, device="cpu")
        _assert_same(got, sketch_pallas(seq, k, w), (k, w, n, "pallas"))
        _assert_same(got, sketch_numpy(seq, k, w), (k, w, n, "numpy"))
        assert len(got.values) > 0


def test_palindromes_are_skipped():
    """Even k over ATAT...: every k-mer is its own reverse complement, so
    every window holds the sentinel, whose strand bit comes from the codes."""
    seq = np.frombuffer(b"AT" * 200, np.uint8).copy()
    got = sk.sketch_one(seq, 8, 10, device="cpu")
    assert len(got.values) == 0
    _assert_same(got, sketch_pallas(seq, 8, 10), "pallas")
    _assert_same(got, sketch_numpy(seq, 8, 10), "numpy")
    codes = np.full((2, 2 * sk.C), 4, np.int32)
    codes[0, : len(seq)] = TWOBIT[seq]
    want = sketch_pallas_batch(codes, 8, 10)
    for g, r in zip(sk.sketch_batch(codes, 8, 10, device="cpu"), want):
        assert np.array_equal(g, r)


@pytest.mark.parametrize("k,w", [(16, 2), (17, 1), (24, 1), (25, 2), (32, 3)])
def test_edge_rows_equal_pallas(k, w):
    """A batch of a random row, a row of all N, a row of one even-k
    palindrome repeated (ATAT...: every k-mer its own reverse complement)
    and a lowercase row: dense outputs equal the Pallas kernel's."""
    rng = np.random.default_rng(100 * k + w)
    codes = np.full((4, 3 * sk.C), 4, np.int32)
    codes[0, :1400] = TWOBIT[_seq(rng, 1400)]
    codes[2, :1300] = np.resize([0, 3], 1300)
    codes[3, :1200] = TWOBIT[_seq(rng, 1200, lower=True)]
    got = sk.sketch_batch(codes, k, w, device="cpu")
    for name, g, r in zip(("hi", "lo", "ps"), got, sketch_pallas_batch(codes, k, w)):
        assert np.array_equal(g, r), name
    sentinel = (got[0] == -1) & (got[1] == -1)
    assert sentinel[1].all() and not sentinel[0, :1000].all()
    if k % 2 == 0:
        assert sentinel[2, :1000].all()


@pytest.mark.parametrize("n", [0, 5, 18, 36, 37, 40])
def test_short_and_empty(n):
    seq = ACGTN[np.arange(n) % 4]
    got = sk.sketch_one(seq, 19, 19, device="cpu")
    _assert_same(got, sketch_pallas(seq, 19, 19), n)
    _assert_same(got, sketch_numpy(seq, 19, 19), n)
    assert (len(got.values) > 0) == (n >= 37)  # 37 = k + w - 1: one window


@pytest.mark.parametrize("k,w,refused", [(19, 367, False), (19, 368, True), (32, 354, False), (32, 355, True),
                                         (15, 100, False)])
def test_halo_refused_where_the_reference_refuses(k, w, refused):
    codes = np.full((1, 2 * sk.C), 4, np.int32)
    codes[0, :600] = np.random.default_rng(w).integers(0, 4, 600)
    if refused:
        with pytest.raises(ValueError, match="halo"):
            sketch_pallas_batch(codes, k, w)
        with pytest.raises(ValueError, match="halo"):
            sk.sketch_batch(codes, k, w, device="cpu")
    else:
        for g, r in zip(sk.sketch_batch(codes, k, w, device="cpu"), sketch_pallas_batch(codes, k, w)):
            assert np.array_equal(g, r)


def test_bad_widths_refused_by_both():
    codes = np.full((1, 1000), 4, np.int32)  # not a multiple of C
    with pytest.raises((AssertionError, ValueError)):
        sketch_pallas_batch(codes, 19, 19)
    with pytest.raises(ValueError):
        sk.sketch_batch(codes, 19, 19, device="cpu")
    with pytest.raises((AssertionError, ValueError)):
        sketch_pallas_batch(codes[:, :512], 19, 19)
    with pytest.raises(ValueError):
        sk.sketch_batch(codes[:, :512], 19, 19, device="cpu")


@pytest.mark.parametrize("k", [15, 19, 31, 32])
def test_jenkins_plain_equals_numpy(k):
    """The int64 emulation of the Jenkins mix equals the uint64 one, and its
    unsigned compare orders values, the sentinel last, as uint64 does."""
    rng = np.random.default_rng(k)
    mask = (1 << (2 * k)) - 1
    x = rng.integers(0, mask, size=4096, dtype=np.uint64, endpoint=True)
    x[:3] = [0, mask, mask >> 1]
    got = sk.jenkins_plain(torch.from_numpy(x.view(np.int64)), k).numpy().view(np.uint64)
    want = jenkins_hash(x, mask)
    assert np.array_equal(got, want)
    vals = np.concatenate([want, [np.uint64(0xFFFFFFFFFFFFFFFF)], want[::-1]])
    a = torch.from_numpy(vals.view(np.int64))
    b = torch.from_numpy(np.roll(vals, 1).view(np.int64))
    assert np.array_equal(sk.ult(a, b).numpy(), vals < np.roll(vals, 1))
    sentinel = torch.full_like(a, -1)
    assert bool(sk.ult(torch.from_numpy(want.view(np.int64)), sentinel[: len(want)]).all())
