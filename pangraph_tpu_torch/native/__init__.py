"""Native host runtime: C++ kernels compiled at first use, bound via ctypes.

Holds the host-side hot loops that don't belong on the accelerator: anchor
chaining DP (sequential scan; replaces the reference's lchain.c), sketch,
index and anchor expansion, and the banded stripe aligner that serves the
jobs the CUDA kernels cannot take. Build: g++ -O3 -shared into BUILD_DIR
(outside the package, listed in .gitignore), keyed by a source hash. All
callers fall back to numpy implementations when the toolchain is unavailable.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_HERE = os.path.dirname(__file__)
# build outputs live beside the package, never inside it
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(_HERE))), "_build", "native")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

# Per-thread grow-only scratch arenas for the stripe batch's flat result
# buffers (see stripe_align_batch_native). Thread-local so concurrent merge
# threads never share a buffer; grow-only so pages fault exactly once.
_ARENA = threading.local()


def _arena_buf(name: str, n: int, dtype) -> np.ndarray:
    buf = getattr(_ARENA, name, None)
    if buf is None or len(buf) < n:
        grow = max(n, 0 if buf is None else (len(buf) * 3) // 2)
        buf = np.empty(grow, dtype=dtype)
        setattr(_ARENA, name, buf)
    return buf[:n]


def _arena_i32(n: int) -> np.ndarray:
    return _arena_buf("i32", n, np.int32)


def _arena_i64(n: int) -> np.ndarray:
    return _arena_buf("i64", n, np.int64)


def _build_and_load(force_scalar: bool = False):
    srcs = [os.path.join(_HERE, f) for f in ("chain.cpp", "stripe.cpp", "sketch.cpp", "index.cpp")]
    h = hashlib.blake2b(digest_size=8)
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    tag = "_scalar" if force_scalar else ""
    so = os.path.join(BUILD_DIR, f"_native_{h.hexdigest()}{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = so + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-o", tmp, *srcs]
        if force_scalar:
            cmd.insert(1, "-DSTRIPE_FORCE_SCALAR")
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def _bind(lib):
    lib.chain_dp.restype = None
    lib.chain_extract.restype = ctypes.c_int64
    lib.stripe_align_batch.restype = None
    lib.sketch_native.restype = ctypes.c_int64
    lib.index_build_native.restype = ctypes.c_int64
    lib.anchors_all_native.restype = ctypes.c_int64
    lib.backtrace_band.restype = ctypes.c_int
    return lib


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _TRIED:
            try:
                _LIB = _bind(_build_and_load())
            except Exception as e:  # pragma: no cover
                log.warning("native library unavailable, using numpy fallbacks: %s", e)
            _TRIED = True
    return _LIB


_SCALAR_LIB = None
_SCALAR_TRIED = False


def get_scalar_lib():
    """The -DSTRIPE_FORCE_SCALAR build (native/stripe.cpp's scalar row
    loop), for parity checks against the default build's. Returns None
    when the toolchain is unavailable."""
    global _SCALAR_LIB, _SCALAR_TRIED
    if _SCALAR_LIB is not None or _SCALAR_TRIED:
        return _SCALAR_LIB
    with _LOCK:
        if _SCALAR_LIB is None and not _SCALAR_TRIED:
            try:
                _SCALAR_LIB = _bind(_build_and_load(force_scalar=True))
            except Exception as e:  # pragma: no cover
                log.warning("scalar native build unavailable: %s", e)
            _SCALAR_TRIED = True
    return _SCALAR_LIB


def chain_dp_native(rpos: np.ndarray, qpos: np.ndarray, k: int, max_gap: int, bw: int, window: int):
    """f/parent arrays via the C++ chaining DP; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(rpos)
    rpos = np.ascontiguousarray(rpos, dtype=np.int64)
    qpos = np.ascontiguousarray(qpos, dtype=np.int64)
    f = np.zeros(n, dtype=np.int64)
    parent = np.zeros(n, dtype=np.int64)
    lib.chain_dp(
        ctypes.c_int64(n),
        rpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(k),
        ctypes.c_int64(max_gap),
        ctypes.c_int64(bw),
        ctypes.c_int32(window),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return f, parent


def chain_extract_native(f: np.ndarray, parent: np.ndarray, min_score: int, min_anchors: int, max_chains: int):
    """Concatenated chains + lengths + scores via C++ peak-walk extraction;
    None if native unavailable. Semantics match align/chain._extract_chains."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(f)
    f = np.ascontiguousarray(f, dtype=np.int64)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    out_idx = np.empty(n, dtype=np.int64)
    out_len = np.empty(max_chains, dtype=np.int64)
    out_score = np.empty(max_chains, dtype=np.int64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    n_chains = lib.chain_extract(
        ctypes.c_int64(n),
        f.ctypes.data_as(p_i64), parent.ctypes.data_as(p_i64),
        ctypes.c_int64(min_score), ctypes.c_int64(min_anchors), ctypes.c_int64(max_chains),
        out_idx.ctypes.data_as(p_i64), out_len.ctypes.data_as(p_i64), out_score.ctypes.data_as(p_i64),
    )
    return out_idx, out_len[:n_chains], out_score[:n_chains]


def backtrace_band_native(paths: np.ndarray, ref: np.ndarray, qry: np.ndarray, ms: int, W: int, B: int, clamped: bool):
    """C++ banded traceback over int8 path bits [rows, B] (native/chain.cpp
    `backtrace_band`). Returns (rc, ops, n_ops, subs, n_subs, lead_ins,
    hit_boundary), rc 0 ok, 1 boundary retry, 2 overflow; None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    max_ops = 65536
    max_subs = 262144
    ops = np.zeros(max_ops * 2, dtype=np.int32)
    subs = np.zeros(max_subs * 2, dtype=np.int64)
    n_ops = ctypes.c_int64(0)
    n_subs = ctypes.c_int64(0)
    lead = ctypes.c_int64(0)
    hb = ctypes.c_int(0)
    paths = np.ascontiguousarray(paths, dtype=np.int8)
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    qry = np.ascontiguousarray(qry, dtype=np.uint8)
    rc = lib.backtrace_band(
        paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int64(B),
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(ref)),
        qry.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(qry)),
        ctypes.c_int64(ms),
        ctypes.c_int64(W),
        ctypes.c_int(1 if clamped else 0),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(max_ops),
        ctypes.byref(n_ops),
        subs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(max_subs),
        ctypes.byref(n_subs),
        ctypes.byref(lead),
        ctypes.byref(hb),
    )
    return rc, ops, int(n_ops.value), subs, int(n_subs.value), int(lead.value), bool(hb.value)


def stripe_align_batch_native(
    refs: list,
    qrys: list,
    ms: np.ndarray,
    W: np.ndarray,
    params,
    iupac_mask: np.ndarray,
    max_paths_bytes: int = 1 << 30,
    ops_cap: int = 65536,
    subs_cap: int = 262144,
    n_threads: int = 0,
    lib=None,
):
    """Batched banded stripe alignment on host (C++, threaded across jobs).

    refs/qrys: lists of uint8 arrays; ms/W: per-job band params. Returns a
    dict of flat result arrays (ops, n_ops, subs, n_subs, lead_ins, boundary,
    status) or None if the native library is unavailable. status per job:
    0 ok, 1 boundary-retry, 2 overflow, 3 paths over budget. `lib` overrides
    the default library (get_scalar_lib() for the scalar row loop)."""
    lib = lib or get_lib()
    if lib is None:
        return None
    n = len(refs)
    if n_threads <= 0:
        # PANGRAPH_TPU_NATIVE_THREADS pins the DP worker count (=1 gives a
        # fully serial host baseline)
        n_threads = int(os.environ.get("PANGRAPH_TPU_NATIVE_THREADS", 0)) or os.cpu_count() or 1
    ref_len = np.array([len(r) for r in refs], dtype=np.int64)
    qry_len = np.array([len(q) for q in qrys], dtype=np.int64)
    ref_off = np.zeros(n, dtype=np.int64)
    qry_off = np.zeros(n, dtype=np.int64)
    np.cumsum(ref_len[:-1], out=ref_off[1:]) if n > 1 else None
    np.cumsum(qry_len[:-1], out=qry_off[1:]) if n > 1 else None
    refs_cat = np.concatenate(refs) if n else np.zeros(0, np.uint8)
    qrys_cat = np.concatenate(qrys) if n else np.zeros(0, np.uint8)
    refs_cat = np.ascontiguousarray(refs_cat, dtype=np.uint8)
    qrys_cat = np.ascontiguousarray(qrys_cat, dtype=np.uint8)
    ms = np.ascontiguousarray(ms, dtype=np.int64)
    W = np.ascontiguousarray(W, dtype=np.int64)
    mask = np.ascontiguousarray(iupac_mask, dtype=np.uint8)
    # The flat result buffers come from a per-thread grow-only arena, NOT a
    # fresh np.empty per call: on this class of VM a fresh multi-hundred-MB
    # anonymous mapping costs ~1 ms per sparsely-faulted MB (nested-virt EPT
    # faults + huge-page zeroing), which at production caps is ~10-15 ms of
    # hidden per-call overhead — more than the DP itself for small rounds.
    # The arena's pages fault once per process lifetime; results are copied
    # out compactly below, so the returned dict never aliases the arena.
    ops = _arena_i32(n * ops_cap * 2)
    subs = _arena_i64(n * subs_cap * 2)
    n_ops = np.zeros(n, dtype=np.int64)
    n_subs = np.zeros(n, dtype=np.int64)
    lead_ins = np.zeros(n, dtype=np.int64)
    boundary = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.stripe_align_batch(
        ctypes.c_int64(n),
        refs_cat.ctypes.data_as(c_u8p), ref_off.ctypes.data_as(c_i64p), ref_len.ctypes.data_as(c_i64p),
        qrys_cat.ctypes.data_as(c_u8p), qry_off.ctypes.data_as(c_i64p), qry_len.ctypes.data_as(c_i64p),
        ms.ctypes.data_as(c_i64p), W.ctypes.data_as(c_i64p),
        ctypes.c_int64(params.score_match), ctypes.c_int64(params.penalty_mismatch),
        ctypes.c_int64(params.penalty_gap_open), ctypes.c_int64(params.penalty_gap_extend),
        ctypes.c_int64(int(params.left_align)),
        ctypes.c_int32(1 if params.left_terminal_gaps_free else 0),
        ctypes.c_int32(1 if params.right_terminal_gaps_free else 0),
        mask.ctypes.data_as(c_u8p),
        ctypes.c_int64(max_paths_bytes),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(ops_cap),
        n_ops.ctypes.data_as(c_i64p),
        subs.ctypes.data_as(c_i64p), ctypes.c_int64(subs_cap), n_subs.ctypes.data_as(c_i64p),
        lead_ins.ctypes.data_as(c_i64p),
        boundary.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n_threads),
    )
    # compact per-job copies (tiny: only the entries the DP produced) so the
    # result outlives the arena and concurrent/parity callers stay safe
    no_list = n_ops.tolist()
    ns_list = n_subs.tolist()
    ops_out = [
        ops[j * ops_cap * 2 : j * ops_cap * 2 + 2 * no_list[j]].reshape(-1, 2).copy()
        for j in range(n)
    ]
    subs_out = [
        subs[j * subs_cap * 2 : j * subs_cap * 2 + 2 * ns_list[j]].reshape(-1, 2).copy()
        for j in range(n)
    ]
    return {
        "ops": ops_out,
        "n_ops": n_ops,
        "subs": subs_out,
        "n_subs": n_subs,
        "lead_ins": lead_ins,
        "boundary": boundary.astype(bool),
        "status": status,
    }


def sketch_native(seq: np.ndarray, k: int, w: int, twobit: np.ndarray):
    """(values, positions, strands) minimizer sketch via C++, or None if the
    native library is unavailable. Exact parity with align/minimizer.sketch."""
    lib = get_lib()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    L = len(seq)
    cap = max(L - k + 1, 1)
    # arena buffers (results are compact-copied below): a fresh ~80 MB
    # np.empty per chromosome-scale sketch pays the VM's fault-storm tax
    vals = _arena_buf("sk_u64", cap, np.uint64)
    pos = _arena_buf("sk_i64", cap, np.int64)
    strand = _arena_buf("sk_u8", cap, np.uint8)
    tb = np.ascontiguousarray(twobit, dtype=np.uint8)
    n = lib.sketch_native(
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(L), ctypes.c_int32(k), ctypes.c_int32(w),
        tb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        strand.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return vals[:n].copy(), pos[:n].copy(), strand[:n].copy()


def index_build_native(values, seq_ids, positions, strands, mid_occ_frac, max_occ_floor):
    """Sorted minimizer index via C++ (radix sort + run structure + inverse
    permutation + occurrence cutoff), or None if the native library is
    unavailable. Exact parity with align/mapper.build_index's numpy path
    (stable sort => deterministic tie order; the quicksort path documents
    tie order as immaterial). Returns (values, seq_ids, positions, strands,
    run_start, run_size, sid_order, max_occ); the arrays persist (fresh
    allocations, not arena)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(values)
    values = np.ascontiguousarray(values, dtype=np.uint64)
    seq_ids = np.ascontiguousarray(seq_ids, dtype=np.int32)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    strands = np.ascontiguousarray(strands, dtype=np.uint8)
    out_v = np.empty(n, dtype=np.uint64)
    out_s = np.empty(n, dtype=np.int32)
    out_p = np.empty(n, dtype=np.int64)
    out_t = np.empty(n, dtype=np.uint8)
    run_start = np.empty(n, dtype=np.int64)
    run_size = np.empty(n, dtype=np.int64)
    sid_order = np.empty(n, dtype=np.int64)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_u64p = ctypes.POINTER(ctypes.c_uint64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    max_occ = lib.index_build_native(
        ctypes.c_int64(n),
        values.ctypes.data_as(c_u64p), seq_ids.ctypes.data_as(c_i32p),
        positions.ctypes.data_as(c_i64p), strands.ctypes.data_as(c_u8p),
        ctypes.c_double(mid_occ_frac), ctypes.c_int64(max_occ_floor),
        out_v.ctypes.data_as(c_u64p), out_s.ctypes.data_as(c_i32p),
        out_p.ctypes.data_as(c_i64p), out_t.ctypes.data_as(c_u8p),
        run_start.ctypes.data_as(c_i64p), run_size.ctypes.data_as(c_i64p),
        sid_order.ctypes.data_as(c_i64p),
    )
    return out_v, out_s, out_p, out_t, run_start, run_size, sid_order, int(max_occ)


def anchors_all_native(seq_ids, positions, strands, run_start, run_size, max_occ, skip_unchanged, bound):
    """All-vs-all anchor expansion via C++ (collect_anchors_all parity,
    identical emit order), or None if the native library is unavailable.
    `bound` = sum(size*(size-1)) over kept runs (caller-computed upper
    bound); the C++ writes into per-thread arena buffers and the kept
    entries are compact-copied out."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(seq_ids)
    seq_ids = np.ascontiguousarray(seq_ids, dtype=np.int32)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    strands = np.ascontiguousarray(strands, dtype=np.uint8)
    run_start = np.ascontiguousarray(run_start, dtype=np.int64)
    run_size = np.ascontiguousarray(run_size, dtype=np.int64)
    # one arena block, partitioned: qi/rid (i32), rpos/qpos (i64), rel (u8)
    i32buf = _arena_buf("anch_i32", 2 * bound, np.int32)
    i64buf = _arena_buf("anch_i64", 2 * bound, np.int64)
    u8buf = _arena_buf("anch_u8", bound, np.uint8)
    qi, rid = i32buf[:bound], i32buf[bound:]
    rpos, qpos = i64buf[:bound], i64buf[bound:]
    rel = u8buf
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    if skip_unchanged is not None:
        skip_unchanged = np.ascontiguousarray(skip_unchanged, dtype=np.uint8)
        skip_p = skip_unchanged.ctypes.data_as(c_u8p)
    else:
        skip_p = ctypes.POINTER(ctypes.c_uint8)()
    kept = lib.anchors_all_native(
        ctypes.c_int64(n),
        seq_ids.ctypes.data_as(c_i32p), positions.ctypes.data_as(c_i64p),
        strands.ctypes.data_as(c_u8p),
        run_start.ctypes.data_as(c_i64p), run_size.ctypes.data_as(c_i64p),
        ctypes.c_int64(max_occ), skip_p,
        qi.ctypes.data_as(c_i32p), rid.ctypes.data_as(c_i32p),
        rpos.ctypes.data_as(c_i64p), qpos.ctypes.data_as(c_i64p),
        rel.ctypes.data_as(c_u8p),
    )
    kept = int(kept)
    return (qi[:kept].copy(), rid[:kept].copy(), rpos[:kept].copy(),
            qpos[:kept].copy(), rel[:kept].copy())
