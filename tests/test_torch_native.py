"""The port's native host engine (pangraph_tpu_torch/native) held against the
reference's library (pangraph_tpu/native) on the same inputs: both compile
byte-identical C++ (native/*.cpp), so every output must be equal element for
element. The cases are the reference's tests/test_native.py stripe cases, run
on the port's library: the AVX-512 row loop against the scalar one
(-DSTRIPE_FORCE_SCALAR, get_scalar_lib) on 40 jobs, the boundary flag, the
numpy aligner, results that outlive the next call on one thread; and the C++
banded traceback, backtrace_band_native."""
from __future__ import annotations

import numpy as np
import pytest

import chip_smoke
import pangraph_tpu.native as ref_native
import pangraph_tpu_torch.native as native
from pangraph_tpu.align.params import BandedAlignParams as RefParams
from pangraph_tpu.graph.seq import IUPAC_MASK as REF_IUPAC_MASK
from pangraph_tpu_torch.align.map_variations import map_variations
from pangraph_tpu_torch.align.params import BandedAlignParams, BandParameters
from pangraph_tpu_torch.graph.seq import IUPAC_MASK
from pangraph_tpu_torch.ops.batch_align import _edit_from_rle_hostmatch

pytestmark = pytest.mark.skipif(native.get_lib() is None or ref_native.get_lib() is None,
                                reason="native library unavailable")

ACGT = np.frombuffer(b"ACGT", np.uint8)
_mutate = chip_smoke.native_mutate  # tests/test_native.py's _mutate


def assert_same(a: dict, b: dict) -> None:
    """Two stripe_align_batch_native results, element for element: the
    per-job flags and counts, and every job's ops and subs
    (chip_smoke.native_results_differ, which the smoke's row-loop line
    uses)."""
    assert chip_smoke.native_results_differ(a, b) == []


def _both(refs, qrys, ms, W, **kw):
    """The port's result and the reference library's on the same jobs."""
    port = native.stripe_align_batch_native(refs, qrys, ms, W, BandedAlignParams(), IUPAC_MASK, **kw)
    ref = ref_native.stripe_align_batch_native(refs, qrys, ms, W, RefParams(), REF_IUPAC_MASK, **kw)
    return port, ref


def test_scalar_and_vector_row_loops_agree():
    """tests/test_native.py:94. The port's default build (the AVX-512 row
    loop where the compiler targets it) and its scalar build give one result
    on the 40 jobs (chip_smoke.row_loop_jobs, the reference test's recipe),
    equal to the reference's default and scalar libraries'."""
    scalar = native.get_scalar_lib()
    assert scalar is not None, "scalar build failed where the default build succeeded"
    assert scalar is not native.get_lib()
    refs, qrys, ms, W = chip_smoke.row_loop_jobs()
    a, ref = _both(refs, qrys, ms, W)
    b = native.stripe_align_batch_native(refs, qrys, ms, W, BandedAlignParams(), IUPAC_MASK, lib=scalar)
    ref_scalar = ref_native.stripe_align_batch_native(refs, qrys, ms, W, RefParams(), REF_IUPAC_MASK,
                                                      lib=ref_native.get_scalar_lib())
    assert (a["status"] == 0).sum() >= 30
    assert_same(a, b)
    assert_same(a, ref)
    assert_same(a, ref_scalar)


def test_scalar_build_is_its_own_library():
    """The scalar build lands in the port's build directory under its own
    tag, beside the default one."""
    import os

    native.get_scalar_lib()
    names = sorted(f for f in os.listdir(native.BUILD_DIR) if f.endswith(".so"))
    plain = [f for f in names if not f.endswith("_scalar.so")]
    assert any(f[: -len(".so")] + "_scalar.so" in names for f in plain), names


def test_failed_scalar_build_is_tried_once(monkeypatch):
    """A scalar build that fails returns None and is not tried again on the
    next call, as get_lib's default build is."""
    calls = []

    def failing_build(force_scalar=False):
        calls.append(force_scalar)
        raise OSError("no toolchain")

    monkeypatch.setattr(native, "_SCALAR_LIB", None)
    monkeypatch.setattr(native, "_SCALAR_TRIED", False)
    monkeypatch.setattr(native, "_build_and_load", failing_build)
    assert native.get_scalar_lib() is None
    assert native.get_scalar_lib() is None
    assert calls == [True]


def test_boundary_flag_matches_the_reference():
    """tests/test_native.py:81. A 60 bp central insertion flags a boundary
    retry at band 5 on the port's library, with the reference library's
    outputs."""
    rng = np.random.default_rng(3)
    ref = ACGT[rng.integers(0, 4, 400)]
    qry = np.concatenate([ref[:200], ACGT[rng.integers(0, 4, 60)], ref[200:]])
    port, want = _both([ref], [qry], np.array([0]), np.array([5]))
    assert int(port["status"][0]) == 1 or bool(port["boundary"][0])
    assert_same(port, want)


def _native_with_retries(ref, qry, ms, W, p):
    """The batch aligner's retry loop, single job (align/align.rs:55-63), on
    the port's library (tests/test_native.py's _native_with_retries)."""
    w = W + 5
    attempt = 1
    edit = None
    while True:
        out = native.stripe_align_batch_native([ref], [qry], np.array([ms]), np.array([w]), p, IUPAC_MASK)
        st = int(out["status"][0])
        hb = bool(out["boundary"][0])
        if st == 0:
            edit = _edit_from_rle_hostmatch(
                out["ops"][0], int(out["n_ops"][0]), out["subs"][0], int(out["n_subs"][0]),
                int(out["lead_ins"][0]), qry,
            )
        if (st == 1 or (st == 0 and hb)) and attempt < p.max_alignment_attempts:
            w = max(2 * w, max(1, abs(ms)))
            attempt += 1
            continue
        return edit


def test_native_matches_the_numpy_aligner():
    """tests/test_native.py:60. 60 trials with N and R codes in the
    reference: the port's native engine with the aligner's retries gives the
    port's numpy aligner's Edit, and each first call's outputs equal the
    reference library's."""
    rng = np.random.default_rng(101)
    p = BandedAlignParams()
    for trial in range(60):
        L = int(rng.integers(10, 1200))
        ref = ACGT[rng.integers(0, 4, L)]
        if trial % 7 == 0:
            ii = rng.choice(L, max(1, L // 40), replace=False)
            ref[ii] = ord("N")
        if trial % 11 == 0:
            ii = rng.choice(L, max(1, L // 60), replace=False)
            ref[ii] = ord("R")
        qry = _mutate(ref, int(L * 0.05), max(1, L // 150), rng)
        ms = int(rng.integers(-15, 15))
        W = int(rng.integers(1, 50))
        host = map_variations(ref, qry, BandParameters(ms, W), p, extra_band_width=5)
        assert _native_with_retries(ref, qry, ms, W, p) == host, f"trial {trial}: L={L} ms={ms} W={W}"
        assert_same(*_both([ref], [qry], np.array([ms]), np.array([W + 5])))


def test_results_survive_the_next_call_on_the_same_thread():
    """tests/test_native.py:349. The flat buffers are a per-thread arena; a
    result stays as it was after the same thread's next, larger call, and
    both equal the reference library's."""
    rng = np.random.default_rng(42)
    p = BandedAlignParams()
    ref = ACGT[rng.integers(0, 4, 800)]
    qry = _mutate(ref, 25, 2, rng)
    first = native.stripe_align_batch_native([ref], [qry], np.array([0]), np.array([30]), p, IUPAC_MASK)
    ops0 = first["ops"][0].copy()
    subs0 = first["subs"][0].copy()
    ref2 = ACGT[rng.integers(0, 4, 3000)]
    qry2 = _mutate(ref2, 100, 6, rng)
    big = {"ops_cap": 1 << 20, "subs_cap": 1 << 21}
    second = native.stripe_align_batch_native([ref2], [qry2], np.array([0]), np.array([60]), p, IUPAC_MASK, **big)
    assert np.array_equal(first["ops"][0], ops0)
    assert np.array_equal(first["subs"][0], subs0)
    assert_same(first, _both([ref], [qry], np.array([0]), np.array([30]))[1])
    assert_same(second, _both([ref2], [qry2], np.array([0]), np.array([60]), **big)[1])


MATCH, REF_GAP, QRY_GAP, REF_EXT, QRY_EXT, BOUND = 1, 2, 4, 8, 16, 32


def _path_bits(rng, rows: int, B: int, p_match: float) -> np.ndarray:
    """Random int8 path bits [rows, B] (native/chain.cpp's layout): MATCH
    with probability p_match, else a gap bit with its extension bit half the
    time, BOUND now and then; no cell is 0."""
    match = rng.random((rows, B)) < p_match
    gap = np.where(rng.random((rows, B)) < 0.5, REF_GAP, QRY_GAP)
    ext = np.where(rng.random((rows, B)) < 0.5, np.where(gap == REF_GAP, REF_EXT, QRY_EXT), 0)
    bound = np.where(rng.random((rows, B)) < 0.02, BOUND, 0)
    bits = np.where(match, MATCH | np.where(rng.random((rows, B)) < 0.1, gap, 0), gap | ext) | bound
    return bits.astype(np.int8)


@pytest.mark.parametrize("clamped", [False, True])
def test_backtrace_band_matches_the_reference(clamped):
    """backtrace_band_native against the reference's on the same arrays:
    24 seeded cases of random path bits (all-MATCH diagonals with
    substitutions, and paths that wander through gap states, some out of
    the band), equal rc, ops, subs, counts, lead insertion and boundary
    flag; the cases reach rc 0 and rc 1, and some flag a boundary."""
    rng = np.random.default_rng(17 + clamped)
    rcs, flagged = set(), 0
    for case in range(24):
        L = int(rng.integers(50, 600))
        B = int(rng.choice([64, 128, 256]))
        ref = ACGT[rng.integers(0, 4, L)]
        qry = ref.copy()
        qry[rng.choice(L, L // 20, replace=False)] = ACGT[rng.integers(0, 4, L // 20)]
        ms, W = int(rng.integers(-3, 4)), int(rng.integers(1, B // 2))
        paths = _path_bits(rng, L, B, 1.0 if case % 3 == 0 else 0.85)
        got = native.backtrace_band_native(paths, ref, qry, ms, W, B, clamped)
        want = ref_native.backtrace_band_native(paths, ref, qry, ms, W, B, clamped)
        assert got[0] == want[0] and got[2] == want[2] and got[4] == want[4] and got[5:] == want[5:], case
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[3], want[3]), case
        rcs.add(got[0])
        flagged += got[0] == 0 and got[6]
    assert {0, 1} <= rcs and flagged
