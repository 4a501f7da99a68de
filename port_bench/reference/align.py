"""Plain banded alignment: the score an alignment earns and the best score
within a band, in the scoring of upstream pangraph's banded aligner
(align/nextclade/align/params.rs:142-176): match +3 (+2 where either base
is N), mismatch -1, a gap of any length -6 (gap extension costs 0), and
gaps that lead or trail the reference or the query free.

An alignment is an edit dict: {"subs": [(pos, alt byte)], "dels": [(pos,
len)], "inss": [(pos, bytes)]}, positions on the reference; an insertion
at `pos` sits before reference base `pos`.

The band: reference row i (1-based, rows 0..rlen) pairs with query
positions q = i + d for the diagonals d in [-ms - W, -ms + W], the
job's mean shift ms and half-width W. `best_scores` runs the DP over the
rows, vectorised over jobs and lanes, with PyTorch on any device; it is the
exact reference in int32, and `control_alignments` is the same DP computed
in int16 with a traceback: the lower precision that a faster DP would
tempt one to use."""
from __future__ import annotations

import numpy as np
import torch

MASK = np.zeros(256, dtype=np.uint8)
for _c, _m in {"A": 1, "C": 2, "G": 4, "T": 8, "U": 8, "R": 5, "Y": 10, "S": 6, "W": 9, "K": 12,
               "M": 3, "B": 14, "D": 13, "H": 11, "V": 7, "N": 15}.items():
    MASK[ord(_c)] = MASK[ord(_c.lower())] = _m


class Scoring:
    def __init__(self, match: int = 3, mismatch: int = 1, gap_open: int = 6):
        self.match, self.mismatch, self.gap_open = match, mismatch, gap_open
        a = np.arange(16)[:, None]
        b = np.arange(16)[None, :]
        tab = np.where((a == 15) | (b == 15), match - 1, np.where((a & b) > 0, match, -mismatch))
        self.table = tab.reshape(-1)  # score of mask pair (a, b) at a * 16 + b

    def pair(self, ref: np.ndarray, qry: np.ndarray) -> np.ndarray:
        return self.table[MASK[ref].astype(np.int64) * 16 + MASK[qry]]


def apply(ref: np.ndarray, edit: dict):
    """The query the edit makes of `ref`, or None where an edit lies
    outside the reference."""
    rl = len(ref)
    out = ref.copy()
    if edit["subs"]:
        pos = np.array([p for p, _ in edit["subs"]], dtype=np.int64)
        if pos.min() < 0 or pos.max() >= rl:
            return None
        out[pos] = np.array([a for _, a in edit["subs"]], dtype=np.uint8)
    keep = np.ones(rl, dtype=bool)
    for p, n in edit["dels"]:
        if p < 0 or n < 1 or p + n > rl:
            return None
        keep[p : p + n] = False
    parts, prev = [], 0
    for p, s in sorted(edit["inss"]):
        if p < 0 or p > rl:
            return None
        parts.append(out[prev:p][keep[prev:p]])
        parts.append(np.frombuffer(s, np.uint8))
        prev = p
    parts.append(out[prev:][keep[prev:]])
    return np.concatenate(parts)


def edit_score(ref: np.ndarray, qry: np.ndarray, edit: dict, sc: Scoring):
    """(valid, score): valid where the edit turns `ref` into `qry`; the
    score of the alignment it spells (None where not valid)."""
    got = apply(ref, edit)
    if got is None or len(got) != len(qry) or not np.array_equal(got, qry):
        return False, None
    rl, ql = len(ref), len(qry)
    deleted = np.zeros(rl, dtype=bool)
    for p, n in edit["dels"]:
        deleted[p : p + n] = True
    ins_len = np.zeros(rl + 1, dtype=np.int64)
    for p, s in edit["inss"]:
        ins_len[p] += len(s)
    aligned = ~deleted
    al_before = np.concatenate([[0], np.cumsum(aligned)])  # aligned bases before i
    ins_upto = np.cumsum(ins_len)  # inserted bases at positions <= i
    consumed = al_before + ins_upto  # query consumed before reference base i
    ai = np.nonzero(aligned)[0]
    score = int(sc.pair(ref[ai], qry[consumed[ai]]).sum()) if len(ai) else 0
    # every insertion position is one run: free in row 0 and row rlen
    ip = np.nonzero(ins_len)[0]
    gaps = int(np.count_nonzero((ip != 0) & (ip != rl)))
    # deletion runs, split by insertions: free in column 0 and column qlen
    if rl:
        start = deleted & ~np.concatenate([[False], deleted[:-1]] )
        start |= deleted & (ins_len[:rl] > 0)
        cols = consumed[np.nonzero(start)[0]]
        gaps += int(np.count_nonzero((cols != 0) & (cols != ql)))
    return True, score - sc.gap_open * gaps


class _Batch:
    """Jobs laid out for the row loop, longest reference first, and the
    loop's state: row i's H (best score ending in the cell) and F (best
    ending in a deletion) per lane, the row counter on the device, and
    each job's best end on its last row and in its last column."""

    def __init__(self, jobs: list, sc: Scoring, device, dtype, neg: int, pad: int):
        order = sorted(range(len(jobs)), key=lambda j: -len(jobs[j][0]))
        self.order = order
        jobs = [jobs[j] for j in order]
        m = len(jobs)
        self.rl = np.array([len(r) for r, _q, _ms, _W in jobs], dtype=np.int64)
        self.ql = np.array([len(q) for _r, q, _ms, _W in jobs], dtype=np.int64)
        ms = np.array([int(j[2]) for j in jobs], dtype=np.int64)
        W = np.array([int(j[3]) for j in jobs], dtype=np.int64)
        self.ms, self.W = ms, W
        self.L = L = int(2 * W.max() + 1)
        self.R = R = int(self.rl.max())
        Q = max(int(self.ql.max()), 1)
        ref = np.zeros((m, R + pad), dtype=np.uint8)
        qry = np.zeros((m, Q), dtype=np.uint8)
        for j, (r, q, _ms, _W) in enumerate(jobs):
            ref[j, : len(r)] = MASK[r]
            qry[j, : len(q)] = MASK[q]
        dev = self.dev = torch.device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        self.ref16 = t(ref).to(torch.int64) * 16
        self.qry = t(qry).to(torch.int64)
        self.table = t(sc.table).to(dtype)
        self.dlo = t(-ms - W)[:, None]
        k = torch.arange(L, device=dev)[None, :]
        self.D = k + self.dlo
        self.lane_ok = k <= t(2 * W)[:, None]
        self.qlc = t(self.ql)[:, None]
        self.rlc = t(self.rl)[:, None]
        # a job whose end corner lies below the band's lowest diagonal ends
        # in the query's last column, not the reference's last row
        self.col_end = (self.ql - self.rl) < (-ms - W)
        self.need_col = bool(self.col_end.any())
        self.NEG = torch.tensor(neg, dtype=dtype, device=dev)
        self.ZERO = torch.tensor(0, dtype=dtype, device=dev)
        self.GO = torch.tensor(sc.gap_open, dtype=dtype, device=dev)
        self.U2 = torch.tensor(2, dtype=torch.uint8, device=dev)
        self.H = torch.where(self.lane_ok & (self.D >= 0) & (self.D <= self.qlc), self.ZERO, self.NEG)
        self.F = torch.full((m, L), neg, dtype=dtype, device=dev)
        self.it = torch.zeros(1, dtype=torch.int64, device=dev)
        self.rowbest = torch.full((m,), neg, dtype=dtype, device=dev)
        self.rowlane = torch.zeros((m,), dtype=torch.int64, device=dev)
        self.colbest = torch.full((m,), neg, dtype=dtype, device=dev)
        self.colrow = torch.zeros((m,), dtype=torch.int64, device=dev)
        self.bits = self.eidx = None
        self.live = m

    def take(self, n: int) -> None:
        """Keep the first n jobs (the longest) for the rows still to run."""
        for name in ("ref16", "qry", "dlo", "D", "lane_ok", "qlc", "rlc", "H", "F"):
            setattr(self, name, getattr(self, name)[:n])
        self.live = n


def _step(b: _Batch) -> None:
    """One row of the DP for the live jobs, in place; the row number is
    the device counter b.it, so that a run of steps can be captured and
    replayed as one CUDA graph."""
    n = b.live
    it = b.it
    it.add_(1)
    NEG, ZERO, GO = b.NEG, b.ZERO, b.GO
    negcol = NEG.expand(n, 1)
    q = b.D + it
    inb = b.lane_ok & (q >= 0) & (q <= b.qlc)
    qm = b.qry.gather(1, (q - 1).clamp(0, b.qry.shape[1] - 1))
    M = b.H + b.table[b.ref16.index_select(1, it - 1) + qm]
    Hs = torch.cat([b.H[:, 1:], negcol], 1)  # row i-1 at query q: a deletion
    Fs = torch.cat([b.F[:, 1:], negcol], 1)
    Fo = torch.where(q == b.qlc, Hs, Hs - GO)  # free in the last column
    F = torch.maximum(Fs, Fo)
    N = torch.where(inb, torch.where(q == 0, ZERO, torch.maximum(M, F)), NEG)
    Ec, Ei = torch.cummax(N - torch.where(b.rlc == it, ZERO, GO), 1)  # free in the last row
    E = torch.cat([negcol, Ec[:, :-1]], 1)  # an insertion run from a lane to the left
    if b.bits is not None:
        nb = torch.where(q == 0, b.U2, (F > M).to(torch.uint8))
        code = nb | ((E > N).to(torch.uint8) << 2) | ((Fs >= Fo).to(torch.uint8) << 3)
        b.bits[:, :n].index_copy_(0, it, code[None])
        b.eidx[:, :n, 1:].index_copy_(0, it, Ei[None, :, :-1].to(torch.int16))
    H = torch.where(inb, torch.maximum(N, E), NEG)
    b.H.copy_(H)
    b.F.copy_(torch.where(inb, F, NEG))
    hm, ha = H.max(1)
    fin = b.rlc[:, 0] == it
    b.rowbest[:n].copy_(torch.where(fin, hm, b.rowbest[:n]))
    b.rowlane[:n].copy_(torch.where(fin, ha, b.rowlane[:n]))
    if b.need_col:
        lane = (b.qlc[:, 0] - it) - b.dlo[:, 0]
        ok = (lane >= 0) & (lane < b.L) & (b.rlc[:, 0] >= it)
        v = torch.where(ok, H.gather(1, lane.clamp(0, b.L - 1)[:, None])[:, 0], NEG)
        better = v > b.colbest[:n]
        b.colrow[:n].copy_(torch.where(better, it, b.colrow[:n]))
        b.colbest[:n].copy_(torch.where(better, v, b.colbest[:n]))


CHUNK = 64  # rows a CUDA graph replays


def _rows(b: _Batch, graphs: bool) -> None:
    """Run every row, dropping finished jobs as they halve; on the card
    each stretch of CHUNK rows is one captured CUDA graph, replayed."""
    i = 0
    g = None
    while i < b.R:
        live = int(np.count_nonzero(b.rl > i))
        if live <= b.live // 2:
            b.take(live)
            g = None
        if not graphs or b.R - i < 2 * CHUNK:
            _step(b)
            i += 1
            continue
        if g is None:
            _step(b)  # a real row, run eagerly before the capture
            i += 1
            torch.cuda.synchronize(b.dev)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(CHUNK):
                    _step(b)
            # capturing runs nothing; the counter is where it was
        g.replay()
        i += CHUNK


def _run(jobs: list, sc: Scoring, device, dtype, neg: int, trace: bool):
    """The banded DP over `jobs` [(ref bytes, qry bytes, ms, W)]. Returns
    (best score per job in job order, and (each job's end cell, the
    batch) in the batch's order)."""
    graphs = torch.device(device).type == "cuda" and not trace
    b = _Batch(jobs, sc, device, dtype, neg, CHUNK + 1)
    m, L = len(jobs), b.L
    if trace:
        b.bits = torch.zeros((b.R + 1, m, L), dtype=torch.uint8, device=b.dev)
        b.eidx = torch.zeros((b.R + 1, m, L), dtype=torch.int16, device=b.dev)
    _rows(b, graphs)
    best = b.rowbest.cpu().numpy().astype(np.int64)
    lane = b.rowlane.cpu().numpy()
    end = [(int(b.rl[j]), int(b.rl[j] - b.ms[j] - b.W[j] + lane[j])) for j in range(m)]
    if b.need_col:
        cb = b.colbest.cpu().numpy().astype(np.int64)
        cr = b.colrow.cpu().numpy()
        for j in np.nonzero(b.col_end & (cb > best))[0]:
            best[j] = cb[j]
            end[j] = (int(cr[j]), int(b.ql[j]))
    out = np.empty(m, dtype=np.int64)
    out[b.order] = best
    return out, (end, b)


NEG32 = -(1 << 30)
NEG16 = -(1 << 14)


def best_scores(jobs: list, sc: Scoring, device="cpu") -> np.ndarray:
    """The best score within each job's band, exactly (int32 holds every
    score of a reference under 100 Mbp). jobs: [(ref bytes, qry bytes, ms,
    W)] with non-empty ref and qry."""
    if not jobs:
        return np.zeros(0, dtype=np.int64)
    return _run(jobs, sc, device, torch.int32, NEG32, False)[0]


def control_alignments(jobs: list, sc: Scoring, device="cpu", max_bytes: int = 4 << 30, bits: int = 16) -> list:
    """A control: the same DP, computed in int16 (bits=16) or exactly
    (bits=32, for a control that narrows the band instead), traced back
    from its own best end cell into an edit dict per job (None where the
    trace leaves the band). Jobs run in groups, longest first, whose
    traceback tables (3 bytes a cell of rows x lanes) stay within
    `max_bytes`."""
    dtype, neg = (torch.int16, NEG16) if bits == 16 else (torch.int32, NEG32)
    order = sorted(range(len(jobs)), key=lambda j: -len(jobs[j][0]))
    out = [None] * len(jobs)
    while order:
        R = len(jobs[order[0]][0]) + 1
        group, L = [], 0
        for j in order:
            L2 = max(L, 2 * int(jobs[j][3]) + 1)
            if group and 3 * R * L2 * (len(group) + 1) > max_bytes:
                break
            group.append(j)
            L = L2
        order = order[len(group):]
        _best, (end, b) = _run([jobs[j] for j in group], sc, device, dtype, neg, True)
        for slot, g in enumerate(b.order):
            rl, Lj = int(b.rl[slot]), int(2 * b.W[slot] + 1)
            out[group[g]] = _traceback(jobs[group[g]], end[slot], b.bits[: rl + 1, slot, :Lj].cpu().numpy(),
                                       b.eidx[: rl + 1, slot, :Lj].cpu().numpy())
        del b
    return out


def _traceback(job, end, bits: np.ndarray, eidx: np.ndarray):
    """Follow the DP's recorded choices back from its end cell (i, q)."""
    ref, qry, ms, W = job
    rl, ql = len(ref), len(qry)
    dlo = -int(ms) - int(W)
    L = bits.shape[1]
    i, q = end
    if not (0 <= q <= ql and 0 <= i <= rl):
        return None
    subs, dels, inss = [], [], []
    if q < ql:
        inss.append((rl, bytes(qry[q:ql])))  # a free trailing insertion
    if i < rl:
        dels.append((i, rl - i))  # a free trailing deletion
    state = "H"
    while True:
        if i == 0:
            if state == "F":
                return None
            if q:
                inss.append((0, bytes(qry[:q])))
            break
        if q == 0:
            if state == "F":
                return None
            dels.append((0, i))
            break
        k = q - i - dlo
        if not 0 <= k < L:
            return None
        bt = int(bits[i, k])
        if state == "H":
            if bt & 4:
                q0 = i + dlo + int(eidx[i, k])
                if not 0 <= q0 < q:
                    return None
                inss.append((i, bytes(qry[q0:q])))
                q = q0
            state = "N"
            continue
        if state == "N":
            nb = bt & 3
            if nb == 2:
                return None  # the first column is q == 0, handled above
            if nb == 0:
                if ref[i - 1] != qry[q - 1]:
                    subs.append((i - 1, int(qry[q - 1])))
                i, q = i - 1, q - 1
                state = "H"
                continue
            state = "F"
        # state F: ref[i-1] deleted, extended from row i-1's F or opened
        # from its H
        dels.append((i - 1, 1))
        state = "F" if bt & 8 else "H"
        i -= 1
    return {"subs": subs[::-1], "dels": _merge_dels(dels), "inss": _merge_inss(inss)}


def _merge_dels(dels: list) -> list:
    out = []
    for p, n in sorted(dels):
        if out and out[-1][0] + out[-1][1] == p:
            out[-1] = (out[-1][0], out[-1][1] + n)
        else:
            out.append((p, n))
    return out


def _merge_inss(inss: list) -> list:
    """Insertions at one position, in query order (the trace meets them
    last first)."""
    by_pos = {}
    for p, s in inss:
        by_pos.setdefault(p, []).append(s)
    return [(p, b"".join(reversed(v))) for p, v in sorted(by_pos.items())]
