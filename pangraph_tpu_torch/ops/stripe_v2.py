"""Banded stripe DP and its run-jump traceback: the CUDA kernels of the
alignment path (the DP and the walk, their checkpoint pair, and the decode
of the walk's events into edits), their plain PyTorch versions, and the
host decode.

The reference runs these as Pallas kernels in 128-row window coordinates
(pangraph_tpu/ops/stripe_v2.py). Here the records are kept in band
coordinates: `rec[p, i-1, k]` is row i (1-based reference position), band
lane k, query position `q = i + k - ms - W`. Then the diagonal predecessor of
a cell is the same lane of the previous row, the vertical one is lane k+1 of
the previous row, and the horizontal gap is an exclusive prefix-max over the
row's lanes. A record packs the cell's origin bits with the length of the
diagonal MATCH run ending at it: `bits | min(run, RUN_CAP) << 6` as int16,
read back as unsigned 16-bit. The walk jumps whole match runs, so its cost
scales with the number of indel events, not with the alignment length.

For problems whose records would not fit device memory, the checkpoint
pair (`stripe_dp_ckpt`, `walk_ckpt`) runs the same recurrence but keeps
only the DP's carry at the start of every window of WV rows
(`ckpt_layout`); the walk re-derives a window's records from its carry
when it needs them, and crosses windows that a match run covers without
reading any.

Each kernel has a wrapper (`stripe_dp`, `walk`, `stripe_dp_ckpt`,
`walk_ckpt`, `decode_events`) that takes tensors: on a CUDA tensor it
launches the kernel on the current stream (or raises), on a CPU tensor it
runs the plain version (`stripe_dp_plain`, `walk_plain`, ...), which the
tests hold against the Pallas kernels element for element (the decode,
which has no Pallas kernel, against the host decode `edit_from_events`).

Scoring matches the reference aligner: match 3, mismatch -1 by IUPAC mask
overlap, N (mask 15) on either side 2, gap open 6, gap extend 0, free
terminal gaps.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from pangraph_tpu_torch.graph.seq import IUPAC_MASK
from pangraph_tpu_torch.ops.cuda_build import ptr as _ptr, stream as _stream

MATCH = 1
REF_GAP_MATRIX = 2
QRY_GAP_MATRIX = 4
REF_GAP_EXTEND = 8
QRY_GAP_EXTEND = 16
BOUNDARY = 32

NO_ALIGN = -1_000_000_000
SCORE_MATCH = 3
PENALTY_MISMATCH = 1
GAP_OPEN = 6

RUN_CAP = (1 << 10) - 1  # run counter shares an int16 record with 6 origin bits

OP_M = 1
OP_D = 2

# The reference DP computes rows in 128-row window chunks, and on the first
# row of each chunk (rows 1, 129, 257, ...) band lane 0 sees no diagonal
# predecessor (its window lane 0 has nothing to its left). Both versions here
# reproduce that, so that their records equal the reference's.
DP_C = 128

MAX_B = 2048

# kernel launches, per wrapper: one is added where a kernel is launched and
# nowhere else (the plain versions do not count)
LAUNCHES = {"stripe_dp": 0, "walk": 0, "stripe_dp_ckpt": 0, "walk_ckpt": 0, "decode_events": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


# Kernel launch log, off unless a caller sets it to a list: each launch of
# the DP, the walk, the checkpoint pair or the decode (B 0) then appends
# (name, B, R, problems, device index, start, end, stream), a CUDA event
# pair recorded on the launch's stream around the kernel, and that stream's
# handle (`cuda_stream`). Nothing here synchronizes; the caller reads the events
# after its own synchronize.
KERNEL_TIMING = None


def _launch_events(device):
    if KERNEL_TIMING is None:
        return None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    return start, end


def _log_launch(events, name: str, B: int, R: int, m: int, device) -> None:
    if events is not None:
        stream = torch.cuda.current_stream(device)
        events[1].record(stream)
        KERNEL_TIMING.append((name, B, R, m, torch.device(device).index, *events, stream.cuda_stream))


def walk_segment(R_cap: int, B: int) -> int:
    """Rows per walk segment for a tier: a match-run jump stops at the start
    of the segment holding its row. The reference walks its records in VMEM
    chunks of this many rows and caps each jump at the chunk edge; the
    cells a walk lands on decide the BOUNDARY flag it reports (meta[2]), so
    the port keeps the same edges. Splitting a jump emits no event."""
    WN = B + DP_C
    cw = 1024
    while cw * 2 <= min(R_cap, 8192) and cw * 2 * WN * 2 <= 4 * 1024 * 1024 and R_cap % (cw * 2) == 0:
        cw *= 2
    return min(cw, R_cap)


# --------------------------------------------------------------- checks


def _check_problem_vectors(m: int, device, **vecs) -> None:
    for name, v in vecs.items():
        if v.device != device:
            raise ValueError(f"{name} is on {v.device}, expected {device}")
        if v.dtype != torch.int32 or v.shape != (m,) or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor of shape ({m},)")


def _check_dp_inputs(ref, qry, rlen, qlen, ms, W, B: int, values: bool = True) -> None:
    """Shapes, dtypes, devices and B; with `values`, also the bounds of
    rlen/qlen, which reads them (on a CUDA tensor that waits for its
    stream). The batch path checks those on its host arrays instead
    (`_check_batch`) and passes values=False."""
    if ref.dim() != 2 or qry.dim() != 2 or ref.shape[0] != qry.shape[0]:
        raise ValueError("ref and qry must be [m, R] and [m, Q] tensors with the same m")
    if ref.dtype != torch.uint8 or qry.dtype != torch.uint8:
        raise ValueError("ref and qry must be uint8 sequence bytes")
    if not (ref.is_contiguous() and qry.is_contiguous()):
        raise ValueError("ref and qry must be contiguous")
    if qry.device != ref.device:
        raise ValueError(f"qry is on {qry.device}, expected {ref.device}")
    if B % 128 or not 128 <= B <= MAX_B:
        raise ValueError(f"band width B={B} must be a multiple of 128 in [128, {MAX_B}]")
    m = ref.shape[0]
    _check_problem_vectors(m, ref.device, rlen=rlen, qlen=qlen, ms=ms, W=W)
    if values and m:
        _check_lengths(int(rlen.max()), int(qlen.max()), int(rlen.min()), int(qlen.min()),
                       ref.shape[1], qry.shape[1])


def _check_lengths(rmax: int, qmax: int, rmin: int, qmin: int, R: int, Q: int) -> None:
    if rmax > R or qmax > Q:
        raise ValueError("rlen/qlen exceed the width of ref/qry")
    if rmin < 0 or qmin < 0:
        raise ValueError("rlen/qlen must be non-negative")


def _check_walk_inputs(rec, rlen, qlen, ms, W, seg: int, K: int, values: bool = True) -> None:
    if rec.dim() != 3 or rec.dtype != torch.int16 or not rec.is_contiguous():
        raise ValueError("rec must be a contiguous int16 tensor [m, R, B]")
    if seg < 1 or K < 1:
        raise ValueError("seg and K must be positive")
    m = rec.shape[0]
    _check_problem_vectors(m, rec.device, rlen=rlen, qlen=qlen, ms=ms, W=W)
    if values and m and int(rlen.max()) > rec.shape[1]:
        raise ValueError("rlen exceeds the rows of rec")


# --------------------------------------------------------------- DP


class _RowStep:
    """The DP's row recurrence, vectorized over problems and band lanes: the
    one Python definition of it, which stripe_dp_plain, stripe_dp_ckpt_plain
    and walk_ckpt_plain's window re-derive all call. A carry (H, qg, run) is
    three [m, B] int32 tensors in band coordinates: row i-1's H, its query
    gap, and its uncapped MATCH run."""

    def __init__(self, ref_mask, qry_mask, rl, ql, q0, B: int):
        dev = ref_mask.device
        self.ref_mask, self.qry_mask, self.rl, self.ql, self.q0 = ref_mask, qry_mask, rl, ql, q0
        self.B = B
        m = ref_mask.shape[0]
        k = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
        self.lane0, self.lane_hi = k == 0, k == B - 1
        self.q_ext_lane, self.r_ext_lane = k < B - 2, k > 1
        self.na_col = torch.full((m, 1), NO_ALIGN, dtype=torch.int32, device=dev)
        # int32 constants for torch.where, built once (a where of two Python
        # ints would give int64)
        self.c = {v: torch.tensor(v, dtype=torch.int32, device=dev) for v in (
            0, MATCH, REF_GAP_MATRIX, QRY_GAP_MATRIX, REF_GAP_EXTEND, QRY_GAP_EXTEND, BOUNDARY,
            QRY_GAP_EXTEND | QRY_GAP_MATRIX, SCORE_MATCH, SCORE_MATCH - 1, -PENALTY_MISMATCH, GAP_OPEN)}

    @classmethod
    def of(cls, ref, qry, rlen, qlen, ms, W, B: int) -> "_RowStep":
        dev = ref.device
        m = ref.shape[0]
        if qry.shape[1] == 0:
            qry = torch.zeros((m, 1), dtype=torch.uint8, device=dev)
        iupac = torch.as_tensor(IUPAC_MASK, device=dev).to(torch.int32)
        k = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
        # q0: query position of each lane at row 0
        return cls(iupac[ref.long()], iupac[qry.long()], rlen[:, None], qlen[:, None], k - (ms + W)[:, None], B)

    def take(self, idx) -> "_RowStep":
        """The same step for the problems `idx` only."""
        return _RowStep(self.ref_mask[idx], self.qry_mask[idx], self.rl[idx], self.ql[idx], self.q0[idx], self.B)

    def full(self, v) -> torch.Tensor:
        return torch.full((self.ref_mask.shape[0], self.B), v, dtype=torch.int32, device=self.ref_mask.device)

    def row0(self):
        """Row 0's carry: a free leading insertion wherever 0 <= q <= qlen."""
        H = torch.where((self.q0 >= 0) & (self.q0 <= self.ql), self.full(0), self.full(NO_ALIGN))
        return H, self.full(NO_ALIGN), self.full(0)

    def __call__(self, i: int, H, qg, run):
        """Row i (1-based) from row i-1's carry. Returns row i's carry and its
        records [m, B] int16; a problem with i > rlen keeps its carry and gets
        records 0."""
        c, na_col, lane0, rl, ql = self.c, self.na_col, self.lane0, self.rl, self.ql
        zero = c[0]
        q = self.q0 + i
        live = i <= rl
        in_matrix = (q >= 0) & (q <= ql) & live
        if (i - 1) % DP_C == 0:
            Hd, rund = torch.where(lane0, NO_ALIGN, H), torch.where(lane0, 0, run)
        else:
            Hd, rund = H, run
        Hu = torch.cat([H[:, 1:], na_col], 1)
        qgu = torch.cat([qg[:, 1:], na_col], 1)

        rm = self.ref_mask[:, i - 1 : i]
        qm = torch.gather(self.qry_mask, 1, (q - 1).clamp(0, self.qry_mask.shape[1] - 1).long())
        qm = torch.where((q >= 1) & (q <= ql), qm, 0)
        msub = torch.where((rm == 15) | (qm == 15), c[SCORE_MATCH - 1],
                           torch.where((rm & qm) > 0, c[SCORE_MATCH], c[-PENALTY_MISMATCH]))

        diag_valid = (q >= 1) & in_matrix
        up_valid = ~self.lane_hi & diag_valid
        M = torch.where(diag_valid, Hd + msub, NO_ALIGN)
        interior = (q >= 1) & (i < rl) & (q < ql) & in_matrix

        q_open = torch.where(q == ql, Hu, Hu - GAP_OPEN)
        q_ext = (qgu >= q_open) & self.q_ext_lane
        QG = torch.where(up_valid, torch.where(q_ext, qgu, q_open), NO_ALIGN)

        first_col = (q == 0) & in_matrix
        M = torch.where(first_col, 0, M)
        NQ = torch.maximum(M, QG)

        gap_cost = torch.where(i == rl, zero, c[GAP_OPEN])
        P = torch.where(in_matrix, NQ - gap_cost, NO_ALIGN)
        Gx = torch.cat([na_col, torch.cummax(P, 1).values[:, :-1]], 1)  # exclusive prefix max
        Gv = torch.where(lane0 | ~in_matrix, NO_ALIGN, Gx)
        prevG = torch.cat([na_col, Gv[:, :-1]], 1)
        r_open_prev = torch.cat([na_col, (torch.maximum(NQ, Gv) - gap_cost)[:, :-1]], 1)
        r_ext = (prevG >= r_open_prev) & self.r_ext_lane

        # flags: BOUNDARY where an interior cell lacks its diagonal or
        # vertical predecessor (lane B-1) or its horizontal one (lane 0)
        path = (torch.where(interior & (~up_valid | lane0), c[BOUNDARY], zero)
                | torch.where(up_valid & q_ext, c[QRY_GAP_EXTEND], zero)
                | torch.where((Gv > NO_ALIGN) & r_ext, c[REF_GAP_EXTEND], zero))
        ge = Gv >= M
        best_mr = torch.where(ge, Gv, M)
        qge = QG >= best_mr
        origin = torch.where(qge, c[QRY_GAP_MATRIX], torch.where(ge, c[REF_GAP_MATRIX], c[MATCH]))
        # the first column is a free leading insertion: H 0, a query gap
        Hn = torch.where(in_matrix, torch.where(first_col, zero, torch.where(qge, QG, best_mr)), NO_ALIGN)
        path = torch.where(first_col, c[QRY_GAP_EXTEND | QRY_GAP_MATRIX], path | origin)
        path = torch.where(in_matrix, path, zero)

        runn = torch.where((path & MATCH) > 0, rund + 1, zero)  # uncapped
        rec32 = path | (runn.clamp(max=RUN_CAP) << 6)
        rec = torch.where(rec32 >= 1 << 15, rec32 - (1 << 16), rec32).to(torch.int16)
        return torch.where(live, Hn, H), torch.where(live, QG, qg), torch.where(live, runn, run), rec


def stripe_dp_plain(ref, qry, rlen, qlen, ms, W, B: int) -> torch.Tensor:
    """Plain PyTorch version of the DP kernel: a loop over rows, vectorized
    over problems and band lanes. Same inputs and output as `stripe_dp`;
    rows past a problem's rlen are 0."""
    m, R = ref.shape
    rec = torch.zeros((m, R, B), dtype=torch.int16, device=ref.device)
    if m == 0:
        return rec
    step = _RowStep.of(ref, qry, rlen, qlen, ms, W, B)
    H, qg, run = step.row0()
    for i in range(1, int(rlen.max()) + 1):
        H, qg, run, rec[:, i - 1] = step(i, H, qg, run)
    return rec


_IUPAC_DEV = {}


def _iupac_on(device) -> torch.Tensor:
    t = _IUPAC_DEV.get(device)
    if t is None:
        t = _IUPAC_DEV[device] = torch.as_tensor(IUPAC_MASK, dtype=torch.uint8).to(device)
    return t


def stripe_dp(ref, qry, rlen, qlen, ms, W, B: int) -> torch.Tensor:
    """Banded stripe DP over m problems.

    ref [m, R] and qry [m, Q] uint8 sequence bytes (IUPAC letters; a row's
    bytes past rlen/qlen are ignored); rlen, qlen, ms, W [m] int32 (the band
    of problem p is lanes k in [0, B), query position q = i + k - ms - W).
    Returns rec [m, R, B] int16 records: `origin bits | min(run, 1023) << 6`
    for rows 1..rlen; later rows are unspecified on CUDA (0 on the CPU).
    On a CUDA tensor this launches csrc/stripe_dp.cu (replacing the Pallas
    kernel pangraph_tpu/ops/stripe_v2.py:_dp_kernel); on a CPU tensor it runs
    stripe_dp_plain."""
    if ref.device.type == "cpu":
        _check_dp_inputs(ref, qry, rlen, qlen, ms, W, B)
        return stripe_dp_plain(ref, qry, rlen, qlen, ms, W, B)
    return stripe_dp_cuda(ref, qry, rlen, qlen, ms, W, B)


def stripe_dp_cuda(ref, qry, rlen, qlen, ms, W, B: int) -> torch.Tensor:
    """Launch the DP kernel (see `stripe_dp`); CUDA tensors only."""
    if ref.device.type != "cuda":
        raise ValueError(f"the stripe_dp kernel runs on CUDA tensors, not {ref.device}")
    _check_dp_inputs(ref, qry, rlen, qlen, ms, W, B)
    return _stripe_dp_launch(ref, qry, rlen, qlen, ms, W, B)


def _stripe_dp_launch(ref, qry, rlen, qlen, ms, W, B: int) -> torch.Tensor:
    """stripe_dp_cuda for inputs whose lengths the caller has checked on the
    host: it reads no device value, so it does not wait for the stream."""
    _check_dp_inputs(ref, qry, rlen, qlen, ms, W, B, values=False)
    from pangraph_tpu_torch.ops import cuda_build

    m, R = ref.shape
    rec = torch.empty((m, R, B), dtype=torch.int16, device=ref.device)
    if m == 0 or R == 0:
        return rec
    lib = cuda_build.lib("stripe_dp.cu")
    with torch.cuda.device(ref.device):
        ev = _launch_events(ref.device)
        rc = lib.stripe_dp_launch(
            _ptr(ref), ref.stride(0), _ptr(qry), qry.stride(0),
            _ptr(rlen), _ptr(qlen), _ptr(ms), _ptr(W), _ptr(_iupac_on(ref.device)),
            _ptr(rec), R, B, m, _stream(ref.device),
        )
        _log_launch(ev, "stripe_dp", B, R, m, ref.device)
    if rc != 0:
        raise RuntimeError(f"stripe_dp kernel launch failed: CUDA error {rc}")
    _count_launch("stripe_dp")
    return rec


# --------------------------------------------------------------- walk


def _i32(x: int) -> int:
    """Wrap to a signed 32-bit value, as the kernels' int32 words do."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


class _Walker:
    """One problem's traceback state, walking back from (rlen, qlen). `move`
    applies one record, as csrc/walk_step.cuh's walk_move does; events go to
    the problem's rows/words rows (numpy [K] int32)."""

    def __init__(self, i: int, q: int, rows, words):
        self.i, self.q, self.rows, self.words = i, q, rows, words
        self.st = self.ins = self.dl = self.ia = self.cnt = self.dead = self.bnd = 0
        self.rr = 0  # the last match run's rows left below the row its jump stopped at

    def _emit(self, row: int, word: int) -> None:
        idx = min(self.cnt, len(self.rows) - 1)
        self.rows[idx] = row
        self.words[idx] = _i32(word)
        self.cnt += 1

    def move(self, word: int, floor: int) -> None:
        """One move from `word`, the record of cell (i, q) (0 out of band); a
        match-run jump stops at row `floor`."""
        bits, runv = word & 63, word >> 6
        st, ins, dl, ia = self.st, self.ins, self.dl, self.ia
        if bits & BOUNDARY:
            self.bnd = 1
        take_m = st == 0 and bits & MATCH
        take_i = (st == 0 and bits & REF_GAP_MATRIX and not take_m) or st == REF_GAP_MATRIX
        take_d = (st == 0 and bits & QRY_GAP_MATRIX and not take_m and not take_i) or st == QRY_GAP_MATRIX
        if bits == 0 or not (take_m or take_i or take_d):
            self.dead, self.rr = 1, 0
            return
        emit_d = (take_m or take_i) and dl > 0
        if emit_d:
            self._emit(self.i, OP_D | ia << 2 | dl << 17)
        elif take_m and ins > 0 and dl == 0:
            self._emit(self.i - 1, OP_M | ins << 2)
        self.ia = ins if (take_d and dl == 0) else (0 if emit_d else ia)
        self.dl = dl + 1 if take_d else (0 if emit_d else dl)
        self.rr = 0
        if take_m:
            run = max(runv, 1)
            L = min(run, self.i - floor)
            self.i, self.q, self.ins, self.rr = self.i - L, self.q - L, 0, run - L
        elif take_d:
            self.i, self.ins = self.i - 1, 0
            self.st = QRY_GAP_MATRIX if bits & QRY_GAP_EXTEND else 0
        else:
            self.q, self.ins = self.q - 1, ins + 1
            self.st = REF_GAP_MATRIX if bits & REF_GAP_EXTEND else 0

    def finish(self) -> tuple:
        """Flush a deletion run that reached row 0; returns (n_events, meta)."""
        if self.i == 0 and not self.dead and self.dl > 0:
            self._emit(0, OP_D | self.ia << 2 | self.dl << 17)
        return self.cnt, (self.q, self.dead | (self.i > 0), self.bnd, self.ins)


def _walk_outputs(m: int, K: int):
    return np.zeros((m, K), np.int32), np.zeros((m, K), np.int32), np.zeros(m, np.int32), np.zeros((m, 4), np.int32)


def walk_plain(rec, rlen, qlen, ms, W, seg: int, K: int):
    """Plain version of the walk kernel: a Python loop over problems and
    events, on a host copy of the records. Same inputs and outputs as `walk`;
    event slots past n_events are 0."""
    recs = rec.cpu().numpy().view(np.uint16)
    m, _, B = recs.shape
    rl, ql = rlen.cpu().numpy(), qlen.cpu().numpy()
    off = (ms + W).cpu().numpy()
    rows, words, nev, meta = _walk_outputs(m, K)
    for p in range(m):
        wk = _Walker(int(rl[p]), int(ql[p]), rows[p], words[p])
        o, rp = int(off[p]), recs[p]
        while wk.i > 0 and not wk.dead:
            k = wk.q + o - wk.i
            wk.move(int(rp[wk.i - 1, k]) if 0 <= k < B else 0, (wk.i - 1) // seg * seg)
        nev[p], meta[p] = wk.finish()
    dev = rec.device
    return tuple(torch.from_numpy(a).to(dev) for a in (rows, words, nev, meta))


def walk(rec, rlen, qlen, ms, W, seg: int, K: int):
    """Run-jump traceback over the DP records -> compact event lists.

    Returns (rows [m, K], words [m, K], n_events [m], meta [m, 4]) int32.
    Events are in walk order (descending row); slots past n_events are
    unspecified. Events past K land in slot K-1 while n_events keeps
    counting, so n_events > K flags an overflow. meta is (lead, dead,
    boundary, pending_ins). A deletion run is one event, word =
    OP_D | ins_after << 2 | del_len << 17 at its lowest row; a match row
    followed by an insertion run is word = OP_M | ins_len << 2.
    On a CUDA tensor this launches csrc/walk.cu (replacing the Pallas kernel
    pangraph_tpu/ops/stripe_v2.py:_walk_kernel); on a CPU tensor it runs
    walk_plain."""
    if rec.device.type == "cpu":
        _check_walk_inputs(rec, rlen, qlen, ms, W, seg, K)
        return walk_plain(rec, rlen, qlen, ms, W, seg, K)
    return walk_cuda(rec, rlen, qlen, ms, W, seg, K)


def walk_cuda(rec, rlen, qlen, ms, W, seg: int, K: int):
    """Launch the walk kernel (see `walk`); CUDA tensors only."""
    if rec.device.type != "cuda":
        raise ValueError(f"the walk kernel runs on CUDA tensors, not {rec.device}")
    _check_walk_inputs(rec, rlen, qlen, ms, W, seg, K)
    return _walk_launch(rec, rlen, qlen, ms, W, seg, K)


def _walk_launch(rec, rlen, qlen, ms, W, seg: int, K: int):
    """walk_cuda without the read of rlen (see _stripe_dp_launch)."""
    _check_walk_inputs(rec, rlen, qlen, ms, W, seg, K, values=False)
    from pangraph_tpu_torch.ops import cuda_build

    m, R, B = rec.shape
    dev = rec.device
    rows = torch.empty((m, K), dtype=torch.int32, device=dev)
    words = torch.empty((m, K), dtype=torch.int32, device=dev)
    nev = torch.empty(m, dtype=torch.int32, device=dev)
    meta = torch.empty((m, 4), dtype=torch.int32, device=dev)
    if m == 0:
        return rows, words, nev, meta
    lib = cuda_build.lib("walk.cu")
    with torch.cuda.device(dev):
        ev = _launch_events(dev)
        rc = lib.walk_launch(
            _ptr(rec), R, B, _ptr(rlen), _ptr(qlen), _ptr(ms), _ptr(W), seg, K,
            _ptr(rows), _ptr(words), _ptr(nev), _ptr(meta), m, _stream(dev),
        )
        _log_launch(ev, "walk", B, R, m, dev)
    if rc != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {rc}")
    _count_launch("walk")
    return rows, words, nev, meta


# --------------------------------------------------------------- checkpoint pair


def ckpt_layout(B: int) -> int:
    """Rows per checkpoint window at band width B: the reference's WV
    (pangraph_tpu/ops/stripe_v2.py:ckpt_layout), sized so that its record
    window of 8 problems, [8, WV, B + 128] int16, fits 8 MB. The walk's match
    jumps stop at window edges and its run refresh reads the carries there;
    where a jump stops decides which cells the walk reads, so the port keeps
    the same windows."""
    wv = 2048
    while wv > DP_C and 8 * wv * (B + DP_C) * 2 > 8 * 1024 * 1024:
        wv //= 2
    return wv


def ckpt_windows(R_cap: int, B: int) -> int:
    """Checkpoint windows of a tier of R_cap rows."""
    return -(-R_cap // ckpt_layout(B))


# device bytes of re-derived windows the checkpoint walk may hold at once; a
# launch whose windows need more walks them in waves (walk_ckpt_plan)
WALK_CKPT_SCRATCH_BYTES = 1 << 30
WALKER_INTS = 10  # the walk's state between waves: csrc/walk_step.cuh's Walker


def walk_ckpt_plan(m: int, R: int, B: int, n_windows: int) -> tuple:
    """How the checkpoint walk kernel takes a launch of m problems of R rows
    (ref's width) and n_windows checkpoint windows: (G, S, waves). A wave
    (p_lo, p_hi, w_lo, w_hi) re-derives windows [w_lo, w_hi) of problems
    [p_lo, p_hi) into a scratch of S rows of B int16 lanes for each of at
    most G problems, then walks them. Problems go in groups of G, and a
    group's waves go top windows first, each window of rows 1..R in exactly
    one wave. The scratch, G * S * B int16, stays within
    WALK_CKPT_SCRATCH_BYTES and within the launch's full records,
    m * R * B int16."""
    WV = ckpt_layout(B)
    window_bytes = WV * B * 2
    if window_bytes > WALK_CKPT_SCRATCH_BYTES:
        raise ValueError(f"WALK_CKPT_SCRATCH_BYTES={WALK_CKPT_SCRATCH_BYTES} does not hold one window "
                         f"({window_bytes} bytes at B={B})")
    n_top = max(1, min(-(-R // WV), n_windows))  # the windows holding rows 1..R
    G = max(1, min(m, WALK_CKPT_SCRATCH_BYTES // window_bytes))
    k = min(n_top, WALK_CKPT_SCRATCH_BYTES // (G * window_bytes))
    S = min(k * WV, R)
    waves = [(p, min(m, p + G), max(0, w - k), w) for p in range(0, m, G) for w in range(n_top, 0, -k)]
    return G, S, waves


def walk_ckpt_buffers(m: int, R: int, B: int, n_windows: int, device):
    """What walk_ckpt_cuda allocates for a launch: the scratch of re-derived
    windows [G, S, B] int16 and the walkers' state [m, WALKER_INTS] int32;
    and the waves (walk_ckpt_plan). On the "meta" device it allocates
    nothing and gives the sizes."""
    G, S, waves = walk_ckpt_plan(m, R, B, n_windows)
    scratch = torch.empty((G, S, B), dtype=torch.int16, device=device)
    state = torch.empty((m, WALKER_INTS), dtype=torch.int32, device=device)
    return scratch, state, waves


def _ckpt_windows_for(ref, B: int, R_cap) -> int:
    R_cap = ref.shape[1] if R_cap is None else R_cap
    if R_cap < ref.shape[1]:
        raise ValueError(f"R_cap={R_cap} is below the rows of ref ({ref.shape[1]})")
    return ckpt_windows(R_cap, B)


def stripe_dp_ckpt_plain(ref, qry, rlen, qlen, ms, W, B: int, R_cap: int = None) -> torch.Tensor:
    """Plain version of the checkpoint DP kernel: the row loop of
    stripe_dp_plain, keeping only each window's start carry. Same inputs and
    output as `stripe_dp_ckpt`; windows that start past a problem's rlen
    are 0."""
    m = ref.shape[0]
    WV = ckpt_layout(B)
    n_windows = _ckpt_windows_for(ref, B, R_cap)
    ckpt = torch.zeros((m, n_windows, 3, B), dtype=torch.int32, device=ref.device)
    if m == 0:
        return ckpt
    step = _RowStep.of(ref, qry, rlen, qlen, ms, W, B)
    carry = step.row0()
    ckpt[:, 0] = torch.stack(carry, 1)
    for i in range(1, int(rlen.max()) + 1):
        carry = step(i, *carry)[:3]
        if i % WV == 0 and i // WV < n_windows:
            ckpt[:, i // WV] = torch.where((i <= rlen)[:, None, None], torch.stack(carry, 1), 0)
    return ckpt


def stripe_dp_ckpt(ref, qry, rlen, qlen, ms, W, B: int, R_cap: int = None) -> torch.Tensor:
    """Checkpoint pass of the banded stripe DP over m problems: the same
    recurrence and inputs as `stripe_dp`, but instead of records it keeps
    the carry of every window start row w * WV (WV = ckpt_layout(B)), so a
    problem holds n_windows * 3 * B int32 instead of R * B int16.

    Returns ckpt [m, n_windows, 3, B] int32, n_windows = ceil(R_cap / WV)
    (R_cap defaults to the width of ref): planes H, query gap and uncapped
    MATCH run of row w * WV, band lane k. Windows that start past a
    problem's rlen are unspecified on CUDA (0 on the CPU). Band lane 0 of
    a carry is never read: the rows after a window start are chunk rows,
    where lane 0 has no diagonal predecessor. On a CUDA tensor this launches
    csrc/stripe_dp.cu in its checkpoint mode (replacing the Pallas kernel
    pangraph_tpu/ops/stripe_v2.py:_dp_ckpt_kernel); on a CPU tensor it runs
    stripe_dp_ckpt_plain."""
    if ref.device.type == "cpu":
        _check_dp_inputs(ref, qry, rlen, qlen, ms, W, B)
        return stripe_dp_ckpt_plain(ref, qry, rlen, qlen, ms, W, B, R_cap)
    return stripe_dp_ckpt_cuda(ref, qry, rlen, qlen, ms, W, B, R_cap)


def stripe_dp_ckpt_cuda(ref, qry, rlen, qlen, ms, W, B: int, R_cap: int = None) -> torch.Tensor:
    """Launch the checkpoint DP kernel (see `stripe_dp_ckpt`); CUDA tensors only."""
    if ref.device.type != "cuda":
        raise ValueError(f"the stripe_dp_ckpt kernel runs on CUDA tensors, not {ref.device}")
    _check_dp_inputs(ref, qry, rlen, qlen, ms, W, B)
    return _stripe_dp_ckpt_launch(ref, qry, rlen, qlen, ms, W, B, R_cap)


def _stripe_dp_ckpt_launch(ref, qry, rlen, qlen, ms, W, B: int, R_cap: int = None) -> torch.Tensor:
    """stripe_dp_ckpt_cuda without the reads of rlen/qlen (see _stripe_dp_launch)."""
    _check_dp_inputs(ref, qry, rlen, qlen, ms, W, B, values=False)
    from pangraph_tpu_torch.ops import cuda_build

    m = ref.shape[0]
    n_windows = _ckpt_windows_for(ref, B, R_cap)
    ckpt = torch.empty((m, n_windows, 3, B), dtype=torch.int32, device=ref.device)
    if m == 0 or ref.shape[1] == 0:
        return ckpt
    lib = cuda_build.lib("stripe_dp.cu")
    with torch.cuda.device(ref.device):
        ev = _launch_events(ref.device)
        rc = lib.stripe_dp_ckpt_launch(
            _ptr(ref), ref.stride(0), _ptr(qry), qry.stride(0),
            _ptr(rlen), _ptr(qlen), _ptr(ms), _ptr(W), _ptr(_iupac_on(ref.device)),
            _ptr(ckpt), n_windows, ckpt_layout(B), B, m, _stream(ref.device),
        )
        _log_launch(ev, "stripe_dp_ckpt", B, ref.shape[1], m, ref.device)
    if rc != 0:
        raise RuntimeError(f"stripe_dp_ckpt kernel launch failed: CUDA error {rc}")
    _count_launch("stripe_dp_ckpt")
    return ckpt


def _check_walk_ckpt_inputs(ckpt, ref, qry, rlen, qlen, ms, W, K: int, values: bool = True) -> None:
    if ckpt.dim() != 4 or ckpt.dtype != torch.int32 or not ckpt.is_contiguous():
        raise ValueError("ckpt must be a contiguous int32 tensor [m, n_windows, 3, B]")
    m, n_windows, _, B = ckpt.shape
    _check_dp_inputs(ref, qry, rlen, qlen, ms, W, B, values)
    if m != ref.shape[0] or ckpt.shape[2] != 3 or ckpt.device != ref.device:
        raise ValueError(f"ckpt must be [{ref.shape[0]}, n_windows, 3, {B}] on {ref.device}")
    if K < 1:
        raise ValueError("K must be positive")
    if values and m and int(rlen.max()) > n_windows * ckpt_layout(B):
        raise ValueError("rlen exceeds the rows the checkpoint windows cover")


def walk_ckpt_plain(ckpt, ref, qry, rlen, qlen, ms, W, K: int):
    """Plain version of the checkpoint walk kernel. All problems step through
    the windows together, last to first; the problems that need a window
    re-derive its records at once (vectorized over them), then each walks
    it in a Python loop. Same inputs and outputs as `walk_ckpt`; event slots
    past n_events are 0."""
    m, n_windows, _, B = ckpt.shape
    WV = ckpt_layout(B)
    dev = ref.device
    runs = ckpt[:, :, 2].cpu().numpy()
    rl, ql = rlen.cpu().numpy(), qlen.cpu().numpy()
    off = (ms + W).cpu().numpy()
    rows, words, nev, meta = _walk_outputs(m, K)
    walkers = [_Walker(int(rl[p]), int(ql[p]), rows[p], words[p]) for p in range(m)]
    step = _RowStep.of(ref, qry, rlen, qlen, ms, W, B) if m else None
    for w in range(n_windows - 1, -1, -1):
        c0 = w * WV
        need = []
        for p, wk in enumerate(walkers):
            if not wk.dead and wk.i == c0 + WV and wk.st == 0 and wk.dl == 0 and wk.rr < WV and w < n_windows - 1:
                # refresh the jump budget from the uncapped run carried at the
                # walker's cell; the reference's window lane k-1 drops band
                # lane 0, so a walker there reads 0. Not after a deletion run
                # (dl > 0): its event is emitted at the MATCH that ends it,
                # so that cell's record must be read
                k = wk.q + int(off[p]) - wk.i
                wk.rr = max(wk.rr, int(runs[p, w + 1, k]) if 1 <= k < B else 0)
            left = wk.i - c0
            if wk.dead or left <= 0:
                continue
            if wk.rr >= left:  # the carried run crosses the window: skip it
                wk.i, wk.q, wk.rr = c0, wk.q - left, wk.rr - left
            else:
                need.append(p)
        if not need:
            continue
        idx = torch.tensor(need, device=dev)
        sub = step.take(idx)
        carry = ckpt[idx, w].unbind(1)
        recs = torch.zeros((len(need), WV, B), dtype=torch.int16, device=dev)
        for i in range(c0 + 1, min(c0 + WV, int(rl[need].max())) + 1):
            *carry, recs[:, i - 1 - c0] = sub(i, *carry)
        recs = recs.cpu().numpy().view(np.uint16)
        for n, p in enumerate(need):
            wk = walkers[p]
            jump = min(wk.rr, wk.i - c0)  # consume the carried run first
            wk.i, wk.q, wk.rr = wk.i - jump, wk.q - jump, wk.rr - jump
            while wk.i > c0 and not wk.dead:
                k = wk.q + int(off[p]) - wk.i
                wk.move(int(recs[n, wk.i - 1 - c0, k]) if 0 <= k < B else 0, c0)
    for p, wk in enumerate(walkers):
        nev[p], meta[p] = wk.finish()
    return tuple(torch.from_numpy(a).to(dev) for a in (rows, words, nev, meta))


def walk_ckpt(ckpt, ref, qry, rlen, qlen, ms, W, K: int):
    """Run-jump traceback over checkpointed DP: the same outputs as `walk`,
    from the carries of `stripe_dp_ckpt` and the DP's own inputs.

    Windows of WV rows are walked last to first. A walker whose carried
    match run covers its rows in a window crosses it without reading a
    record; at a window edge its run budget is refreshed from the uncapped
    run carried at its cell, unless it has just ended a deletion run there
    (the reference refreshes that walker too, and so emits the deletion
    event at the wrong row; here it reads the cell's record and emits the
    event where `walk` does). Otherwise the window's records are re-derived
    from its start carry with the DP's row step and walked; match jumps stop
    at window edges and carry their remaining rows into the next window.
    Events equal `walk`'s on stripe_dp's records; meta[2] (boundary) can
    differ, since a carried jump reads no record. On a CUDA tensor this
    launches csrc/walk_ckpt.cu (replacing the Pallas kernel
    pangraph_tpu/ops/stripe_v2.py:_walk_ckpt_kernel); on a CPU tensor it
    runs walk_ckpt_plain."""
    if ref.device.type == "cpu":
        _check_walk_ckpt_inputs(ckpt, ref, qry, rlen, qlen, ms, W, K)
        return walk_ckpt_plain(ckpt, ref, qry, rlen, qlen, ms, W, K)
    return walk_ckpt_cuda(ckpt, ref, qry, rlen, qlen, ms, W, K)


def walk_ckpt_cuda(ckpt, ref, qry, rlen, qlen, ms, W, K: int):
    """Launch the checkpoint walk kernel (see `walk_ckpt`); CUDA tensors only."""
    if ref.device.type != "cuda":
        raise ValueError(f"the walk_ckpt kernel runs on CUDA tensors, not {ref.device}")
    _check_walk_ckpt_inputs(ckpt, ref, qry, rlen, qlen, ms, W, K)
    return _walk_ckpt_launch(ckpt, ref, qry, rlen, qlen, ms, W, K)


def _walk_ckpt_launch(ckpt, ref, qry, rlen, qlen, ms, W, K: int):
    """walk_ckpt_cuda without the reads of rlen/qlen (see _stripe_dp_launch)."""
    _check_walk_ckpt_inputs(ckpt, ref, qry, rlen, qlen, ms, W, K, values=False)
    from pangraph_tpu_torch.ops import cuda_build

    m, n_windows, _, B = ckpt.shape
    R = ref.shape[1]
    dev = ref.device
    rows = torch.empty((m, K), dtype=torch.int32, device=dev)
    words = torch.empty((m, K), dtype=torch.int32, device=dev)
    nev = torch.empty(m, dtype=torch.int32, device=dev)
    meta = torch.empty((m, 4), dtype=torch.int32, device=dev)
    if m == 0:
        return rows, words, nev, meta
    WV = ckpt_layout(B)
    scratch, state, waves = walk_ckpt_buffers(m, R, B, n_windows, dev)
    S, top = scratch.shape[1], waves[0][3]
    lib = cuda_build.lib("walk_ckpt.cu")
    problem_vecs = (_ptr(rlen), _ptr(qlen), _ptr(ms), _ptr(W))
    with torch.cuda.device(dev):
        ev = _launch_events(dev)
        for wave in waves:
            p_lo, p_hi, w_lo, w_hi = wave
            ev_r = _launch_events(dev)
            rc = lib.walk_ckpt_rederive_launch(
                _ptr(ref), ref.stride(0), _ptr(qry), qry.stride(0), *problem_vecs, _ptr(_iupac_on(dev)),
                _ptr(ckpt), n_windows, WV, B, _ptr(scratch), S, *wave, _stream(dev),
            )
            _log_launch(ev_r, "walk_ckpt.rederive", B, R, p_hi - p_lo, dev)
            if rc != 0:
                break
            ev_w = _launch_events(dev)
            rc = lib.walk_ckpt_walk_launch(
                *problem_vecs, _ptr(ckpt), n_windows, WV, B, _ptr(scratch), S, *wave, _ptr(state),
                int(w_hi == top), int(w_lo == 0), K, _ptr(rows), _ptr(words), _ptr(nev), _ptr(meta), _stream(dev),
            )
            _log_launch(ev_w, "walk_ckpt.walk", B, R, p_hi - p_lo, dev)
            if rc != 0:
                break
        _log_launch(ev, "walk_ckpt", B, R, m, dev)
    if rc != 0:
        raise RuntimeError(f"walk_ckpt kernel launch failed: CUDA error {rc}")
    _count_launch("walk_ckpt")
    return rows, words, nev, meta


# --------------------------------------------------------------- decode

# a problem's decode status (column 0 of the head): no Edit (a dead walk,
# n_events > K or a length mismatch, where edit_from_events's ok is False;
# or events out of order or past the reference, which only a faulty walk
# gives), or the events are decoded
DECODE_FAILED, DECODE_OK = 0, 1
# the head's columns: status, boundary (meta[2]), n_events, q0 (the leading
# insertion's length), the problem's substitutions (offset, count) in
# sub_pos/sub_alt and its events (offset, count) in evs
DECODE_HEAD = 8


def _check_decode_inputs(rows, words, n_events, meta, ref, qry, rlen, qlen) -> None:
    if rows.dim() != 2 or rows.shape != words.shape:
        raise ValueError("rows and words must be [m, K] tensors of one shape")
    m = rows.shape[0]
    for name, t in (("rows", rows), ("words", words), ("meta", meta)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != ref.device:
            raise ValueError(f"{name} must be a contiguous int32 tensor on {ref.device}")
    if meta.shape != (m, 4):
        raise ValueError(f"meta must be [{m}, 4]")
    if ref.dim() != 2 or qry.dim() != 2 or ref.shape[0] != m or qry.shape[0] != m:
        raise ValueError(f"ref and qry must be [{m}, R] and [{m}, Q] tensors")
    if ref.dtype != torch.uint8 or qry.dtype != torch.uint8 or not (ref.is_contiguous() and qry.is_contiguous()):
        raise ValueError("ref and qry must be contiguous uint8 sequence bytes")
    if qry.device != ref.device:
        raise ValueError(f"qry is on {qry.device}, expected {ref.device}")
    _check_problem_vectors(m, ref.device, n_events=n_events, rlen=rlen, qlen=qlen)


def decode_buffers(m: int, K: int, R: int, device) -> dict:
    """The outputs of a decode of m problems of K event slots and R
    reference bytes (see decode_events), unwritten but for totals (0). The
    packed arrays take what any such launch can write: a problem's
    substitutions are rows, and each of its events, in order, moves past at
    least one row. On the "meta" device it allocates nothing and gives the
    sizes."""
    S, E = m * R, m * min(K, R)
    return {"head": torch.empty((m, DECODE_HEAD), dtype=torch.int32, device=device),
            "totals": torch.zeros(2, dtype=torch.int32, device=device),
            "sub_pos": torch.empty(S, dtype=torch.int32, device=device),
            "sub_alt": torch.empty(S, dtype=torch.uint8, device=device),
            "evs": torch.empty((E, 4), dtype=torch.int32, device=device)}


def decode_events_plain(rows, words, n_events, meta, ref, qry, rlen, qlen) -> dict:
    """Plain version of the decode kernel, vectorized over problems: the
    same inputs and outputs as `decode_events`, the packed arrays in problem
    order."""
    m, K = rows.shape
    R, Q = ref.shape[1], qry.shape[1]
    dev = ref.device
    n, rl, ql = n_events.long(), rlen.long()[:, None], qlen.long()
    meta = meta.long()
    q0 = meta[:, 0] + meta[:, 3]
    failed = (meta[:, 1] != 0) | (n > K) | (n < 0) | (q0 < 0)
    nn = torch.where(failed, 0, n)
    # events in forward order: event e is walk slot n - 1 - e
    e = torch.arange(K, device=dev)[None, :]
    live = e < nn[:, None]
    slot = (nn[:, None] - 1 - e).clamp(min=0)
    x, w = rows.long().gather(1, slot), words.long().gather(1, slot)
    is_d, ins = (w & 3) == OP_D, (w >> 2) & 0x7FFF
    dl = torch.where(is_d, w >> 17, 0)
    local_bad = torch.where(is_d, (dl < 1) | (x > rl - dl), ((w & 3) != OP_M) | (x > rl - 1))
    # the first row past the event; each event starts at or after the last one's
    nxt = torch.where(local_bad, rl, torch.where(is_d, x + dl, x + 1))
    start = torch.cat([torch.zeros((m, 1), dtype=torch.long, device=dev), nxt[:, :-1]], 1)
    failed |= (live & (local_bad | (x < start))).any(1)
    delta = torch.where(live, ins - dl, 0)
    csum = delta.cumsum(1)
    ok = ~failed & (rl[:, 0] + q0 + csum[:, -1] == ql)
    status = torch.where(ok, DECODE_OK, DECODE_FAILED)

    # rows: a row's query position moves by each earlier event's delta (at
    # the event's nxt); deleted rows have none
    keep_ev = live & ok[:, None]
    shift = torch.zeros((m, R + 1), dtype=torch.long, device=dev)
    shift.scatter_add_(1, torch.where(keep_ev, nxt, R), torch.where(keep_ev, delta, 0))
    gone = keep_ev & is_d
    dmark = torch.zeros((m, R + 1), dtype=torch.long, device=dev)
    dmark.scatter_add_(1, torch.where(gone, x, R), gone.long())
    dmark.scatter_add_(1, torch.where(gone, x + dl, R), -gone.long())
    i = torch.arange(R, device=dev)[None, :]
    q_of = i + q0[:, None] + shift.cumsum(1)[:, :R]
    keep = ok[:, None] & (i < rl) & (dmark.cumsum(1)[:, :R] == 0)
    qb = qry.gather(1, q_of.clamp(0, Q - 1)) if Q else torch.zeros_like(ref)
    sp, si = (keep & (ref != qb)).nonzero(as_tuple=True)
    em = keep_ev & (is_d | (ins > 0))
    ep, ee = em.nonzero(as_tuple=True)
    q_start = torch.where(is_d, x, x + 1) + q0[:, None] + csum - delta
    ev_rows = torch.stack([x, dl, q_start, ins], 2)[ep, ee]

    out = {k: t.zero_() for k, t in decode_buffers(m, K, R, dev).items()}
    out["sub_pos"][: len(si)] = si.int()
    out["sub_alt"][: len(si)] = qb[sp, si]
    out["evs"][: len(ep)] = ev_rows.int()
    sub_cnt = torch.bincount(sp, minlength=m)
    ev_cnt = torch.bincount(ep, minlength=m)
    out["head"][:] = torch.stack([status, meta[:, 2], n, q0, sub_cnt.cumsum(0) - sub_cnt, sub_cnt,
                                  ev_cnt.cumsum(0) - ev_cnt, ev_cnt], 1)
    out["totals"][:] = torch.tensor([len(si), len(ep)])
    return out


def decode_events(rows, words, n_events, meta, ref, qry, rlen, qlen) -> dict:
    """The walk's events -> each problem's edit, packed: what
    `edit_from_events` returns, for every problem of a launch at once.

    Takes the walk's outputs (rows, words [m, K], n_events [m], meta [m, 4]
    int32) and the DP's inputs (ref [m, R], qry [m, Q] uint8, rlen, qlen
    [m] int32). Returns a dict of tensors: head [m, DECODE_HEAD] int32
    (status, boundary, n_events, q0, substitution offset and count, event
    offset and count); totals [2] int32, the substitutions and events
    written; sub_pos (int32, reference positions) and sub_alt (uint8, the
    query's bytes there), each problem's substitutions in ascending
    position; evs [., 4] int32, each problem's events that delete or insert
    in forward order: (row, deletion length, query start of the insertion,
    insertion length). A deletion is Del(row, len); an insertion sits before
    reference position row + max(deletion length, 1). Status DECODE_OK
    where edit_from_events's ok is True, else DECODE_FAILED, and also where
    the events are out of order or past the reference (a faulty walk, to
    which edit_from_events gives no error); a failed problem's counts are
    0. The packed arrays are
    decode_buffers(m, K, R)'s, of which `totals` entries are written; the
    offsets are each problem's own (on CUDA in no fixed order between
    problems). On a CUDA tensor this launches csrc/walk.cu's decode kernel
    (the reference decodes on the host, so it replaces no Pallas kernel); on
    a CPU tensor it runs decode_events_plain."""
    _check_decode_inputs(rows, words, n_events, meta, ref, qry, rlen, qlen)
    if ref.device.type == "cpu":
        return decode_events_plain(rows, words, n_events, meta, ref, qry, rlen, qlen)
    return _decode_events_launch(rows, words, n_events, meta, ref, qry, rlen, qlen)


def _decode_events_launch(rows, words, n_events, meta, ref, qry, rlen, qlen) -> dict:
    """decode_events on CUDA tensors: one launch, no read of a device value."""
    from pangraph_tpu_torch.ops import cuda_build

    m, K = rows.shape
    R = ref.shape[1]
    dev = ref.device
    out = decode_buffers(m, K, R, dev)
    if m == 0:
        return out
    lib = cuda_build.lib("walk.cu")
    with torch.cuda.device(dev):
        ev = _launch_events(dev)
        rc = lib.decode_events_launch(
            _ptr(rows), _ptr(words), _ptr(n_events), _ptr(meta), K, _ptr(ref), ref.stride(0), _ptr(qry),
            qry.stride(0), _ptr(rlen), _ptr(qlen),
            *(_ptr(out[k]) for k in ("head", "totals", "sub_pos", "sub_alt", "evs")), m, _stream(dev),
        )
        _log_launch(ev, "decode_events", 0, R, m, dev)
    if rc != 0:
        raise RuntimeError(f"decode_events kernel launch failed: CUDA error {rc}")
    _count_launch("decode_events")
    return out


_CHR = tuple(map(chr, range(256)))


def decoded_edit(head_row, sub_pos: list, sub_alt: list, evs: list, qry: np.ndarray):
    """The Edit of one problem that decode_events decoded (its head row's
    status DECODE_OK), from the fetched packed arrays as lists; equal to
    edit_from_events's."""
    from pangraph_tpu_torch.graph.edits import Del, Edit, Ins, Sub

    _status, _bnd, _n, q0, so, sc, eo, ec = head_row
    subs = [Sub(p, _CHR[a]) for p, a in zip(sub_pos[so : so + sc], sub_alt[so : so + sc])]
    dels = []
    inss = [Ins(0, bytes(qry[:q0]).decode())] if q0 else []
    for x, dl, qs, il in evs[eo : eo + ec]:
        if dl:
            dels.append(Del(x, dl))
        if il:
            inss.append(Ins(x + (dl or 1), bytes(qry[qs : qs + il]).decode()))
    return Edit(subs=subs, dels=dels, inss=inss)


# --------------------------------------------------------------- pipeline


def _check_batch(ref_seq, qry_seq, rlen, qlen, ms, W, B: int, K: int, rows: int) -> None:
    """The checks of the wrappers, made on a batch's host arrays before the
    upload: every vector an int32 [m], the sequences uint8 [m, R] and
    [m, Q], B a kernel band, K positive, rlen/qlen within R/Q and
    non-negative, and rlen within `rows` (the rows the records or the
    checkpoint windows cover)."""
    if ref_seq.ndim != 2 or qry_seq.ndim != 2 or ref_seq.shape[0] != qry_seq.shape[0]:
        raise ValueError("ref and qry must be [m, R] and [m, Q] arrays with the same m")
    if ref_seq.dtype != np.uint8 or qry_seq.dtype != np.uint8:
        raise ValueError("ref and qry must be uint8 sequence bytes")
    m = ref_seq.shape[0]
    for name, v in (("rlen", rlen), ("qlen", qlen), ("ms", ms), ("W", W)):
        if v.dtype != np.int32 or v.shape != (m,):
            raise ValueError(f"{name} must be an int32 array of shape ({m},)")
    if B % 128 or not 128 <= B <= MAX_B:
        raise ValueError(f"band width B={B} must be a multiple of 128 in [128, {MAX_B}]")
    if K < 1:
        raise ValueError("K must be positive")
    if m:
        _check_lengths(int(rlen.max()), int(qlen.max()), int(rlen.min()), int(qlen.min()),
                       ref_seq.shape[1], qry_seq.shape[1])
        if int(rlen.max()) > rows:
            raise ValueError(f"rlen exceeds the {rows} rows the records cover")


def _put(device, *arrays) -> list:
    """Host numpy arrays -> contiguous tensors on `device`. To a CUDA device
    through pinned staging, copied on the current stream without waiting
    for it (PyTorch's caching host allocator keeps a staging buffer until
    its copy has run)."""
    dev = torch.device(device)
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if dev.type != "cuda":
        return [t.to(dev) for t in tensors]
    return [t.pin_memory().to(dev, non_blocking=True) for t in tensors]


def stripe_align(ref_seq, qry_seq, rlen, qlen, ms, W, B: int, K: int, seg: int, device) -> dict:
    """DP, walk and decode for one batch on `device`. Inputs are host numpy
    arrays (ref_seq [m, R] and qry_seq [m, Q] uint8 bytes, the rest [m]
    int32); the result dict holds rows/words [m, K], n_events [m] and
    meta [m, 4], and decode_events's outputs, as tensors on `device` (not
    yet synchronized). The inputs are checked on the host, so on a CUDA
    device nothing here waits for the stream."""
    _check_batch(ref_seq, qry_seq, rlen, qlen, ms, W, B, K, ref_seq.shape[1])
    if seg < 1:
        raise ValueError("seg must be positive")
    ref, qry, rl, ql, msv, Wv = _put(device, ref_seq, qry_seq, rlen, qlen, ms, W)
    if ref.device.type == "cuda":
        rec = _stripe_dp_launch(ref, qry, rl, ql, msv, Wv, B)
        rows, words, nev, meta = _walk_launch(rec, rl, ql, msv, Wv, seg, K)
    else:
        rec = stripe_dp(ref, qry, rl, ql, msv, Wv, B)
        rows, words, nev, meta = walk(rec, rl, ql, msv, Wv, seg, K)
    del rec  # its memory can take the decode's outputs
    return {"rows": rows, "words": words, "n_events": nev, "meta": meta,
            **decode_events(rows, words, nev, meta, ref, qry, rl, ql)}


def stripe_align_ckpt(ref_seq, qry_seq, rlen, qlen, ms, W, B: int, K: int, R_cap: int, device) -> dict:
    """The checkpoint route of `stripe_align`: stripe_dp_ckpt, walk_ckpt
    and the decode, with the same inputs and output dict. R_cap is the
    length tier (it sets the number of windows, as in the reference)."""
    if R_cap < ref_seq.shape[1]:
        raise ValueError(f"R_cap={R_cap} is below the rows of ref ({ref_seq.shape[1]})")
    _check_batch(ref_seq, qry_seq, rlen, qlen, ms, W, B, K, ckpt_windows(R_cap, B) * ckpt_layout(B))
    ref, qry, rl, ql, msv, Wv = _put(device, ref_seq, qry_seq, rlen, qlen, ms, W)
    if ref.device.type == "cuda":
        ckpt = _stripe_dp_ckpt_launch(ref, qry, rl, ql, msv, Wv, B, R_cap)
        rows, words, nev, meta = _walk_ckpt_launch(ckpt, ref, qry, rl, ql, msv, Wv, K)
    else:
        ckpt = stripe_dp_ckpt(ref, qry, rl, ql, msv, Wv, B, R_cap)
        rows, words, nev, meta = walk_ckpt(ckpt, ref, qry, rl, ql, msv, Wv, K)
    del ckpt  # its memory can take the decode's outputs
    return {"rows": rows, "words": words, "n_events": nev, "meta": meta,
            **decode_events(rows, words, nev, meta, ref, qry, rl, ql)}


def edit_from_events(rows, words, n_events, meta, ref: np.ndarray, qry: np.ndarray):
    """Host decode: run-compressed event list -> Edit, fully vectorized.

    Conventions (edits.rs, map_variations.rs:70-73): Sub.pos / Del.pos are
    0-based reference positions; Ins.pos is the reference position *after*
    which the insertion sits. Event word layout (see `walk`): op in
    bits 0-1; insertion-run length in bits 2-16; deletion-run length in bits
    17-31. An OP_D event at row x deletes ref[x .. x+del_len) and inserts
    ins_len query chars at position x+del_len; an OP_M event at row x is a
    diagonal move with ins_len chars inserted at x+1. Rows not covered by
    events are implicit diagonal moves (substitutions recovered by compare).
    Returns (edit, ok) — ok False when the walk died or events overflowed."""
    from pangraph_tpu_torch.graph.edits import Del, Edit, Ins, Sub

    K = rows.shape[0]
    lead, dead, _bnd, pend_ins = int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3])
    n = int(n_events)
    if dead or n > K:
        return None, False
    rlen, qlen = len(ref), len(qry)
    q0 = lead + pend_ins  # query chars consumed before any ref row

    if n == 0:
        if q0 + rlen != qlen:
            return None, False
        d = np.nonzero(ref != qry[q0:])[0]
        subs = [Sub(int(i), chr(int(qry[q0 + i]))) for i in d]
        inss = [Ins(0, bytes(qry[:q0]).decode())] if q0 else []
        return Edit(subs=subs, dels=[], inss=inss), True

    # events arrive in walk order (descending row); flip to forward order
    xs = rows[:n][::-1].astype(np.int64)
    ws = words[:n][::-1].astype(np.int64)
    ops = ws & 3
    ins_len = (ws >> 2) & 0x7FFF
    del_len = ws >> 17
    is_d = ops == OP_D
    dlen = np.where(is_d, del_len, 0)

    # deleted-row mask via run difference array; insertion chars attach after
    # the event's last consumed ref row (before ref position `attach`)
    dmark = np.zeros(rlen + 2, dtype=np.int64)
    np.add.at(dmark, xs[is_d], 1)
    np.add.at(dmark, xs[is_d] + dlen[is_d], -1)
    del_mask = np.cumsum(dmark[: rlen + 1]) > 0
    attach = np.where(is_d, xs + dlen, xs + 1)
    ins_at = np.zeros(rlen + 1, dtype=np.int64)
    np.add.at(ins_at, attach, ins_len)
    nd_excl = np.zeros(rlen + 1, dtype=np.int64)
    np.cumsum(del_mask[:rlen], out=nd_excl[1:])  # deletions strictly before i
    ins_cum = np.cumsum(ins_at)  # ins chars attached at indices <= i
    if q0 + (rlen - nd_excl[rlen]) + ins_cum[rlen] != qlen:
        return None, False

    # substitutions: every non-deleted ref position i aligns to query position
    # q0 + (#non-deleted ref < i) + (#ins chars attached at indices <= i)
    idx = np.arange(rlen, dtype=np.int64)
    q_of = q0 + (idx - nd_excl[:rlen]) + ins_cum[:rlen]
    mi = np.nonzero(~del_mask[:rlen])[0]
    dif = mi[ref[mi] != qry[q_of[mi]]]
    subs = [Sub(int(i), chr(int(qry[q_of[i]]))) for i in dif]

    # deletions: one Del per OP_D event (runs are maximal by construction —
    # an insertion between two runs keeps them separate entries)
    di = np.nonzero(is_d)[0]
    dels = [Del(int(xs[t]), int(dlen[t])) for t in di]

    # insertions: event inserts qry[q_op : q_op+ins_len] at ref position
    # `attach`, where q_op = query consumed through the event's op
    inss = [Ins(0, bytes(qry[:q0]).decode())] if q0 else []
    it = np.nonzero(ins_len > 0)[0]
    if len(it):
        a_it = attach[it]
        q_op = q0 + (a_it - nd_excl[a_it]) + (ins_cum[a_it] - ins_len[it])
        for t, av, qs in zip(it, a_it, q_op):
            inss.append(Ins(int(av), bytes(qry[int(qs) : int(qs) + int(ins_len[t])]).decode()))
    return Edit(subs=subs, dels=dels, inss=inss), True
