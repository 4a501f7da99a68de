// The banded stripe DP's row step for Hopper (sm_90a): the one CUDA
// definition of the recurrence, shared by the DP (csrc/stripe_dp.cu, records
// or window-start carries) and the checkpoint walk's window re-derive
// (csrc/walk_ckpt.cu). Its plain PyTorch twin is
// pangraph_tpu_torch/ops/stripe_v2.py:_RowStep; the Pallas original is
// pangraph_tpu/ops/stripe_v2.py:_chunk_compute.
//
// Band coordinates: row i (1-based reference position), band lane k in
// [0, B), query position q = i + k - ms - W. The diagonal predecessor of a
// cell is the same lane of the previous row, the vertical one is lane k+1 of
// the previous row, and the horizontal gap is an exclusive prefix-max over
// the row's lanes. The Pallas kernel's 128-row window chunks leave one
// visible effect, kept here: on rows 1, 129, 257, ... lane 0 has no diagonal
// predecessor. The step takes the absolute row index, so a re-derive that
// starts mid-problem keeps it.
//
// Layout. A thread holds LPT consecutive lanes in registers: their carry
// (H, query gap, MATCH run), their query masks and their match scores for
// the coming row. Two layouts:
// - warp (B <= WARP_MAX_B, so B 128 or 256): one warp holds the band, LPT =
//   B / 32. Nothing on the row chain leaves the warp: no barrier, no shared
//   memory.
// - wide (B > WARP_MAX_B): B / 128 warps of one block hold it, WIDE_LPT = 4
//   lanes a thread, and the warps meet once per row at one barrier, through
//   a small exchange in shared memory double-buffered by row parity.
//
// What a row's chain is, and what keeps it short:
// - The prefix-max of P: each thread's own exclusive prefix over its lanes
//   (3-input maxes, LPT/2 deep), the thread totals shifted up one thread and
//   scanned in three levels of 3-input maxes over shuffles, and in the wide
//   layout the totals of the warps below through one warp reduction (redux)
//   after the barrier. H is one 3-input max of NQ, that prefix and the
//   thread's own.
// - Lane k+1's previous H comes from the thread itself. A thread's top lane
//   needs H of the next thread's first lane, which is max(M, E, QG) there:
//   M and QG are known before the scan and are shuffled (or, across warps,
//   exchanged) while it runs, and E there is the thread's own inclusive
//   prefix. So no value crosses threads after a row's H is known.
// - No global load on the chain. A lane's query mask moves down one lane per
//   row (lane k at row i+1 needs what lane k+1 had at row i), so a row takes
//   in one new mask per warp, at its top lane. A warp stages its reference
//   bytes and its top lane's query bytes 32 rows ahead in registers, one
//   byte a lane (one coalesced load per 32 rows), and hands a row its masks
//   by shuffle; the next row's scores come from Tables::score during this
//   row's scan.
// - Records leave as one 8- or 16-byte store per thread per row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stripe {

constexpr int MATCH = 1;
constexpr int REF_GAP_MATRIX = 2;
constexpr int QRY_GAP_MATRIX = 4;
constexpr int REF_GAP_EXTEND = 8;
constexpr int QRY_GAP_EXTEND = 16;
constexpr int BOUNDARY = 32;

constexpr int NO_ALIGN = -1000000000;
constexpr int SCORE_MATCH = 3;
constexpr int PENALTY_MISMATCH = 1;
constexpr int GAP_OPEN = 6;
constexpr int RUN_CAP = 1023;
constexpr int DP_C = 128;  // row period of the reference's window chunks
constexpr unsigned FULL = 0xffffffffu;

constexpr int WARP_MAX_B = 256;  // widest band of the warp layout
constexpr int WIDE_LPT = 4;      // lanes a thread in the wide layout
constexpr int MAX_B = 2048;
constexpr int MAX_WARPS = MAX_B / (32 * WIDE_LPT);

// Shared-memory tables: the IUPAC mask of each byte, and the match score of
// each pair of masks, score[rm * 16 + qm].
struct Tables {
    uint8_t iupac[256];
    int score[256];
};

__device__ __forceinline__ void load_tables(Tables& t, const uint8_t* iupac_g) {
    for (int x = threadIdx.x; x < 256; x += blockDim.x) {
        t.iupac[x] = iupac_g[x];
        const int rm = x >> 4, qm = x & 15;
        t.score[x] = (rm == 15 || qm == 15) ? SCORE_MATCH - 1 : ((rm & qm) ? SCORE_MATCH : -PENALTY_MISMATCH);
    }
}

// What crosses warps in the wide layout, per warp, by row parity. tot has a
// slot for every lane of a warp: those past the block's warps hold
// NO_ALIGN (init_xchg), so that every lane reads one.
struct Xchg {
    int tot[2][32];           // max of P over the warp's lanes
    int elast[2][MAX_WARPS];  // exclusive prefix-max within the warp at its last lane
    int nql[2][MAX_WARPS];    // NQ at the warp's last lane
    int m0[2][MAX_WARPS];     // M at the warp's first lane
    int qg0[2][MAX_WARPS];    // query gap there
};

__device__ __forceinline__ void init_xchg(Xchg& x) {
    for (int k = threadIdx.x; k < 64; k += blockDim.x) x.tot[k >> 5][k & 31] = NO_ALIGN;
}

// A store to shared memory by the lanes where p holds, without a branch.
__device__ __forceinline__ void st_shared_if(bool p, int* addr, int v) {
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t@q st.shared.b32 [%1], %2;\n\t}"
                 :: "r"((int)p), "r"((unsigned)__cvta_generic_to_shared(addr)), "r"(v) : "memory");
}

// One problem's inputs.
struct Problem {
    const uint8_t* ref;
    const uint8_t* qry;
    int rlen, qlen, off;  // off = ms + W
};

__device__ __forceinline__ Problem problem(
    int p, const uint8_t* ref, long long ref_stride, const uint8_t* qry, long long qry_stride,
    const int* rlen_a, const int* qlen_a, const int* ms_a, const int* W_a)
{
    Problem P;
    P.ref = ref + (long long)p * ref_stride;
    P.qry = qry + (long long)p * qry_stride;
    P.rlen = rlen_a[p];
    P.qlen = qlen_a[p];
    P.off = ms_a[p] + W_a[p];
    return P;
}

// This thread's place in the band.
struct Lanes {
    int k0;    // first band lane
    int lane;  // lane in the warp
    int warp;  // warp in the problem
    int nw;    // warps of the problem
};

template <int LPT, bool WIDE>
__device__ __forceinline__ Lanes lanes() {
    Lanes L;
    L.lane = threadIdx.x & 31;
    L.warp = WIDE ? (int)(threadIdx.x >> 5) : 0;
    L.nw = WIDE ? (int)(blockDim.x >> 5) : 1;
    L.k0 = (L.warp * 32 + L.lane) * LPT;
    return L;
}

// A warp's bytes for the coming rows: lane l holds row base + l's reference
// mask and the query mask at the warp's top lane on that row, and the raw
// bytes of row base + 32 + l, loaded 32 rows before they are needed.
struct Stage {
    const uint8_t* ref;
    const uint8_t* qry;
    int rlen, qlen, qoff;  // query position of the top lane's code at row r: r + qoff
    int base;
    int cr, cq;
    int nr, nq;
};

__device__ __forceinline__ int ref_byte(const Stage& s, int row) {
    return (row >= 1 && row <= s.rlen) ? (int)s.ref[row - 1] : 0;
}

__device__ __forceinline__ int qry_byte(const Stage& s, int row) {
    const int pos = row + s.qoff;
    return (pos >= 0 && pos < s.qlen) ? (int)s.qry[pos] : 0;
}

// Move a warp's stage to rows row .. row + 31 (row = the old base + 32).
__device__ __forceinline__ void stage_refill(Stage& s, int row, int lane, const Tables& t) {
    s.base = row;
    s.cr = t.iupac[s.nr] << 4;
    s.cq = t.iupac[s.nq];
    s.nr = ref_byte(s, row + 32 + lane);
    s.nq = qry_byte(s, row + 32 + lane);
}

// Row `row`'s reference mask times 16 (its row of Tables::score) and the
// query mask at the warp's top lane. The whole warp asks, for rows in order
// one at a time; with REFILL it moves the stage on when `row` leaves it,
// without, the caller has made sure it does not.
template <bool REFILL>
__device__ __forceinline__ void stage_get(Stage& s, int row, int lane, const Tables& t, int& rm16, int& qm) {
    if (REFILL && row - s.base == 32) stage_refill(s, row, lane, t);
    rm16 = __shfl_sync(FULL, s.cr, row - s.base);
    qm = __shfl_sync(FULL, s.cq, row - s.base);
}

// A thread's lanes between two rows.
template <int LPT>
struct Band {
    int H[LPT], QG[LPT], run[LPT];  // the previous row's carry
    int qm[LPT];                    // query masks of the coming row (position q - 1)
    int ms[LPT];                    // its match scores
    int Hn, Qn;                     // the previous row's H and query gap at lane k0 + LPT
};

// Make row r0 the previous row of the next row step. ck = the carry of row r0
// (planes H, query gap, run, [3][B]), or nullptr for row 0 (a free leading
// insertion wherever 0 <= q <= qlen).
template <int LPT>
__device__ __forceinline__ void start_row(Band<LPT>& b, Stage& st, const Problem& P, const Lanes& L, int r0,
                                          const int* ck, int B, const Tables& t)
{
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        const int k = L.k0 + j;
        if (ck) {
            b.H[j] = ck[k];
            b.QG[j] = ck[B + k];
            b.run[j] = ck[2 * B + k];
        } else {
            const int q = k - P.off;
            b.H[j] = (q >= 0 && q <= P.qlen) ? 0 : NO_ALIGN;
            b.QG[j] = NO_ALIGN;
            b.run[j] = 0;
        }
        const int pos = r0 + k - P.off;
        b.qm[j] = (pos >= 0 && pos < P.qlen) ? t.iupac[P.qry[pos]] : 0;
    }
    const int kn = L.k0 + LPT;
    b.Hn = b.Qn = NO_ALIGN;
    if (kn < B) {
        if (ck) {
            b.Hn = ck[kn];
            b.Qn = ck[B + kn];
        } else {
            const int q = kn - P.off;
            b.Hn = (q >= 0 && q <= P.qlen) ? 0 : NO_ALIGN;
        }
    }
    st.ref = P.ref;
    st.qry = P.qry;
    st.rlen = P.rlen;
    st.qlen = P.qlen;
    st.qoff = (L.warp * 32 + 32) * LPT - 1 - P.off - 1;
    st.base = r0 + 1;
    st.cr = t.iupac[ref_byte(st, r0 + 1 + L.lane)] << 4;
    st.cq = t.iupac[qry_byte(st, r0 + 1 + L.lane)];
    st.nr = ref_byte(st, r0 + 33 + L.lane);
    st.nq = qry_byte(st, r0 + 33 + L.lane);
    int rm16, qtop;
    stage_get<true>(st, r0 + 1, L.lane, t, rm16, qtop);
#pragma unroll
    for (int j = 0; j < LPT; ++j) b.ms[j] = t.score[rm16 + b.qm[j]];
}

// Row i's carry of this thread's lanes into ck ([3][B] int32), after the row
// step of row i (or start_row of row 0).
template <int LPT>
__device__ __forceinline__ void store_carry(const Band<LPT>& b, const Lanes& L, int* ck, int B) {
    int4* h = reinterpret_cast<int4*>(ck + L.k0);
    int4* g = reinterpret_cast<int4*>(ck + B + L.k0);
    int4* r = reinterpret_cast<int4*>(ck + 2 * B + L.k0);
#pragma unroll
    for (int v = 0; v < LPT / 4; ++v) {
        h[v] = make_int4(b.H[4 * v], b.H[4 * v + 1], b.H[4 * v + 2], b.H[4 * v + 3]);
        g[v] = make_int4(b.QG[4 * v], b.QG[4 * v + 1], b.QG[4 * v + 2], b.QG[4 * v + 3]);
        r[v] = make_int4(b.run[4 * v], b.run[4 * v + 1], b.run[4 * v + 2], b.run[4 * v + 3]);
    }
}

// Row i (1-based, i <= rlen) from row i-1: updates the thread's lanes and,
// with REC, writes their records to rec_row[k0, k0 + LPT). In the wide
// layout every thread of the block calls it for the same row (it holds one
// barrier); x is the block's exchange.
//
// Two forms of the lane arithmetic: the general one, and (FAST) an interior
// one for a warp whose lanes all have 1 <= q < qlen on a row that is not the
// last, which is most rows of a long alignment (run_rows picks the form).
// There every lane has its diagonal and vertical predecessors and the gap
// open costs GAP_OPEN, so the recurrence loses its edge cases: QG = max(Hu -
// GAP_OPEN, qgu), NQ = max(M, QG), H = max(NQ, E); the origin is whichever of
// QG, E equals H first; a query gap extends where QG == qgu, and a reference
// gap where E equals the previous lane's E (E[k-1] >= P[k-1]). Band lanes 0
// and B-1 keep their BOUNDARY flag, and B-1 has no QRY_GAP_EXTEND. Both forms
// hand the other warps the same values. With REC the interior form keeps the
// run capped at RUN_CAP, which leaves the records as they are (the
// checkpoint carries keep it uncapped). FAST leaves the stage to the caller.
template <int LPT, bool WIDE, bool REC, bool FAST>
__device__ __forceinline__ void row_step(Band<LPT>& b, Stage& st, const Problem& P, const Lanes& L, Xchg* x,
                                         int i, int B, const Tables& t, uint16_t* rec_row)
{
    const int lane = L.lane;
    const bool last_row = i == P.rlen;
    const int gap = last_row ? 0 : GAP_OPEN;
    const bool lane0_cut = L.k0 == 0 && (i - 1) % DP_C == 0;  // lane 0 of a chunk row
    const bool top = L.k0 + LPT == B;
    const int q0 = i + L.k0 - P.off;

    // pass 1: everything up to the horizontal-gap input P, and the local
    // exclusive prefix-max of P
    int M[LPT], QG[LPT], NQ[LPT], lp[LPT], path[LPT];  // path: the flags, or (FAST) P
    bool inm[LPT], fcol[LPT];
    int tot = NO_ALIGN;
    if (FAST) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int Hd = (j == 0 && lane0_cut) ? NO_ALIGN : b.H[j];
            const int Hu = j < LPT - 1 ? b.H[j + 1] : b.Hn;
            const int qgu = j < LPT - 1 ? b.QG[j + 1] : b.Qn;
            M[j] = Hd + b.ms[j];
            QG[j] = __viaddmax_s32(Hu, -GAP_OPEN, qgu);
            NQ[j] = max(M[j], QG[j]);
            path[j] = NQ[j] - GAP_OPEN;
        }
        // the local exclusive prefix as a tree of 3-input maxes, LPT/2 deep
        lp[0] = NO_ALIGN;
        lp[1] = path[0];
#pragma unroll
        for (int j = 2; j < LPT; ++j) lp[j] = __vimax3_s32(lp[j - 2], path[j - 2], path[j - 1]);
        tot = __vimax3_s32(lp[LPT - 2], path[LPT - 2], path[LPT - 1]);
    } else {
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int k = L.k0 + j;
            const int q = q0 + j;
            const bool in_matrix = q >= 0 && q <= P.qlen;
            const int Hd = (j == 0 && lane0_cut) ? NO_ALIGN : b.H[j];
            const int Hu = j < LPT - 1 ? b.H[j + 1] : b.Hn;
            const int qgu = j < LPT - 1 ? b.QG[j + 1] : b.Qn;
            const bool diag = q >= 1 && in_matrix;
            const bool up = diag && k != B - 1;
            const bool interior = diag && !last_row && q < P.qlen;
            int pth = (interior && (!up || k == 0)) ? BOUNDARY : 0;
            int Mv = diag ? Hd + b.ms[j] : NO_ALIGN;
            const int q_open = (q == P.qlen) ? Hu : Hu - GAP_OPEN;
            const bool q_ext = qgu >= q_open && k < B - 2;
            const int QGv = up ? (q_ext ? qgu : q_open) : NO_ALIGN;
            if (up && q_ext) pth |= QRY_GAP_EXTEND;
            const bool fc = q == 0 && in_matrix;
            if (fc) Mv = 0;
            const int NQv = max(Mv, QGv);
            const int Pv = in_matrix ? NQv - gap : NO_ALIGN;
            lp[j] = tot;
            tot = max(tot, Pv);
            M[j] = Mv;
            QG[j] = QGv;
            NQ[j] = NQv;
            path[j] = pth;
            inm[j] = in_matrix;
            fcol[j] = fc;
        }
    }

    // the next row's query masks (each moves down one lane; the warp's top
    // lane takes the staged code) and scores, off the chain
    {
        int rm16, qtop;
        stage_get<!FAST>(st, i + 1, lane, t, rm16, qtop);
        const int q_in = __shfl_down_sync(FULL, b.qm[0], 1);
#pragma unroll
        for (int j = 0; j < LPT - 1; ++j) b.qm[j] = b.qm[j + 1];
        b.qm[LPT - 1] = lane == 31 ? qtop : q_in;
#pragma unroll
        for (int j = 0; j < LPT; ++j) b.ms[j] = t.score[rm16 + b.qm[j]];
    }

    // the next thread's first lane (for this thread's top lane next row) and
    // the previous thread's last lane (for this thread's first lane's flags);
    // whether those lanes are in the matrix follows from their q
    int m_up = __shfl_down_sync(FULL, M[0], 1);
    int qg_up = __shfl_down_sync(FULL, QG[0], 1);
    const int lp_dn = __shfl_up_sync(FULL, lp[LPT - 1], 1);
    int nq_dn = NO_ALIGN;
    if (!FAST) nq_dn = __shfl_up_sync(FULL, NQ[LPT - 1], 1);

    // the warp's exclusive scan of the thread totals: shifted up one thread,
    // then three levels of 3-input maxes over shuffles 1-3, 4-12 and 16
    // apart (a shuffle from below lane 0 returns the lane's own value, which
    // the max leaves as it is)
    int excl = __shfl_up_sync(FULL, tot, 1);
    if (lane == 0) excl = NO_ALIGN;
    excl = max(__vimax3_s32(excl, __shfl_up_sync(FULL, excl, 1), __shfl_up_sync(FULL, excl, 2)),
               __shfl_up_sync(FULL, excl, 3));
    excl = max(__vimax3_s32(excl, __shfl_up_sync(FULL, excl, 4), __shfl_up_sync(FULL, excl, 8)),
               __shfl_up_sync(FULL, excl, 12));
    excl = max(excl, __shfl_up_sync(FULL, excl, 16));
    const int incl = max(excl, tot);
    // exclusive prefix at lane k0 - 1, within the warp (records only)
    int e_dn = max(__shfl_up_sync(FULL, excl, 1), lp_dn);
    if (lane == 0) e_dn = NO_ALIGN;

    int pre = NO_ALIGN;  // max of P over the warps below
    if (WIDE) {
        // the warps' exchange, without a branch: lane 31 and lane 0 publish,
        // every lane reads, and the lanes that need a value pick it
        const int bb = i & 1;
        const int w = L.warp;
        st_shared_if(lane == 31, &x->tot[bb][w], incl);
        st_shared_if(lane == 31, &x->elast[bb][w], max(excl, lp[LPT - 1]));
        st_shared_if(lane == 31, &x->nql[bb][w], NQ[LPT - 1]);
        st_shared_if(lane == 0, &x->m0[bb][w], M[0]);
        st_shared_if(lane == 0, &x->qg0[bb][w], QG[0]);
        // the block's barrier 0 in its non-aligned form: run_rows lets each
        // warp reach it from its own form of the row step, that is, from
        // another instruction than the other warps
        asm volatile("barrier.sync 0;" ::: "memory");
        const int tv = x->tot[bb][lane];
        pre = __reduce_max_sync(FULL, lane < w ? tv : NO_ALIGN);
        const int pre_dn = __reduce_max_sync(FULL, lane < w - 1 ? tv : NO_ALIGN);
        const int wd = max(w - 1, 0), wu = min(w + 1, L.nw - 1);
        const int nql = x->nql[bb][wd], el = x->elast[bb][wd], m0 = x->m0[bb][wu], qg0 = x->qg0[bb][wu];
        const bool from_dn = lane == 0 && w > 0, from_up = lane == 31 && w < L.nw - 1;
        e_dn = from_dn ? max(pre_dn, el) : max(e_dn, pre);
        nq_dn = from_dn ? nql : nq_dn;
        m_up = from_up ? m0 : m_up;
        qg_up = from_up ? qg0 : qg_up;
    }

    // pass 2: horizontal gap, H, origin, record, carries
    const int base_e = max(pre, excl);
    const int G_up = max(pre, incl);  // E at lane k0 + LPT
    uint32_t words[LPT / 2];
    if (FAST) {
        int e_prev = e_dn;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int E = max(base_e, lp[j]);
            const int H = __vimax3_s32(NQ[j], base_e, lp[j]);
            const bool from_q = H == QG[j];
            const bool from_e = H == E;
            const int rd = (j == 0 && lane0_cut) ? 0 : b.run[j];
            const int run = (from_q || from_e) ? 0 : (REC ? __viaddmin_s32(rd, 1, RUN_CAP) : rd + 1);
            if (REC) {
                const int qgu = j < LPT - 1 ? b.QG[j + 1] : b.Qn;
                int pth = from_q ? QRY_GAP_MATRIX : (from_e ? REF_GAP_MATRIX : MATCH);
                if (QG[j] == qgu && (j < LPT - 1 || !top)) pth += QRY_GAP_EXTEND;
                if (E == e_prev && (j > 0 || E > NO_ALIGN)) pth += REF_GAP_EXTEND;
                if ((j == 0 && L.k0 == 0) || (j == LPT - 1 && top)) pth += BOUNDARY;
                const uint32_t r16 = (uint32_t)(pth + (run << 6));
                if (j & 1)
                    words[j >> 1] |= r16 << 16;
                else
                    words[j >> 1] = r16;
            }
            b.H[j] = H;
            b.QG[j] = QG[j];
            b.run[j] = run;
            e_prev = E;
        }
        // lane k0 + LPT has 2 <= q <= qlen here
        b.Hn = top ? NO_ALIGN : max(__vimax3_s32(m_up, qg_up, tot), base_e);
    } else {
        const int q_dn = q0 - 1;
        int e_prev = e_dn, nq_prev = nq_dn;
        bool im_prev = q_dn >= 0 && q_dn <= P.qlen;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int k = L.k0 + j;
            const int E = max(base_e, lp[j]);
            const int Gv = (k == 0 || !inm[j]) ? NO_ALIGN : E;
            const int Mv = M[j], QGv = QG[j];
            const int best_mr = max(Mv, Gv);
            int H = max(best_mr, QGv);
            int origin = QGv >= best_mr ? QRY_GAP_MATRIX : (Gv >= Mv ? REF_GAP_MATRIX : MATCH);
            int pth = path[j];
            if (REC) {
                const int prevG = (k <= 1 || !im_prev) ? NO_ALIGN : e_prev;
                const int r_open_prev = max(nq_prev, prevG) - gap;
                if (Gv > NO_ALIGN && prevG >= r_open_prev && k > 1) pth |= REF_GAP_EXTEND;
            }
            if (fcol[j]) {
                H = 0;
                origin = QRY_GAP_MATRIX;
                pth = QRY_GAP_EXTEND;
            }
            pth |= origin;
            if (!inm[j]) {
                H = NO_ALIGN;
                pth = 0;
            }
            const int rd = (j == 0 && lane0_cut) ? 0 : b.run[j];
            const int run = (pth & MATCH) ? rd + 1 : 0;  // uncapped; records cap at RUN_CAP
            if (REC) {
                const uint32_t r16 = (uint32_t)(pth | (min(run, RUN_CAP) << 6));
                if (j & 1)
                    words[j >> 1] |= r16 << 16;
                else
                    words[j >> 1] = r16;
            }
            b.H[j] = H;
            b.QG[j] = QGv;
            b.run[j] = run;
            e_prev = E;
            nq_prev = NQ[j];
            im_prev = inm[j];
        }
        const int q_up = q0 + LPT;
        const bool im_up = q_up >= 0 && q_up <= P.qlen;
        b.Hn = top || !im_up ? NO_ALIGN : (q_up == 0 ? 0 : max(max(m_up, G_up), qg_up));
    }
    b.Qn = top ? NO_ALIGN : qg_up;

    if (REC) {
        if (LPT % 8 == 0) {
            uint4* dst = reinterpret_cast<uint4*>(rec_row + L.k0);
#pragma unroll
            for (int v = 0; v < LPT / 8; ++v)
                dst[v] = make_uint4(words[4 * v], words[4 * v + 1], words[4 * v + 2], words[4 * v + 3]);
        } else {
            uint2* dst = reinterpret_cast<uint2*>(rec_row + L.k0);
#pragma unroll
            for (int v = 0; v < LPT / 4; ++v) dst[v] = make_uint2(words[2 * v], words[2 * v + 1]);
        }
    }
}

// Rows first .. last (1 <= first) of a problem, each from the one before, in
// the interior form wherever the warp's lanes allow it: those rows form one
// run, split into stretches that end where the stage moves on or at a stop
// row, so that a stretch's loop holds no branch. rec_row(i) is row i's record
// row (REC); with period > 0, on_stop(i) runs after every row i with
// i % period == 0. In the wide layout every warp walks the same rows, each
// with its own forms, and every row step holds one barrier (non-aligned,
// since the warps reach it from different instructions).
template <int LPT, bool WIDE, bool REC, class RecRow, class OnStop>
__device__ __forceinline__ void run_rows(Band<LPT>& b, Stage& st, const Problem& P, const Lanes& L, Xchg* x,
                                         int first, int last, int B, const Tables& t, RecRow rec_row,
                                         int period, OnStop on_stop)
{
    const int kw = L.warp * 32 * LPT;  // the warp's first band lane
    const int lo = max(first, P.off + 1 - kw);
    const int hi = min(min(last, P.rlen - 1), P.qlen - 1 + P.off - (kw + 32 * LPT - 1));
    int next = period > 0 ? (first + period - 1) / period * period : 0x7fffffff;
    int i = first;
    const int pre_end = min(last, lo - 1);
    for (; i <= pre_end; ++i) {
        row_step<LPT, WIDE, REC, false>(b, st, P, L, x, i, B, t, rec_row(i));
        if (i == next) {
            on_stop(i);
            next += period;
        }
    }
    while (i <= hi) {
        if (i + 1 - st.base == 32) stage_refill(st, i + 1, L.lane, t);
        const int end = min(min(hi, st.base + 30), next);
        for (; i <= end; ++i) row_step<LPT, WIDE, REC, true>(b, st, P, L, x, i, B, t, rec_row(i));
        if (i - 1 == next) {
            on_stop(next);
            next += period;
        }
    }
    for (; i <= last; ++i) {
        row_step<LPT, WIDE, REC, false>(b, st, P, L, x, i, B, t, rec_row(i));
        if (i == next) {
            on_stop(i);
            next += period;
        }
    }
}

}  // namespace stripe
