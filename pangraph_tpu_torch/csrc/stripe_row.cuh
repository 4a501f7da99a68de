// The banded stripe DP's row step for Hopper (sm_90a): one thread block per
// problem, the band's lanes spread over the block's threads (LPT lanes a
// thread). The one CUDA definition of the recurrence, shared by the DP
// (csrc/stripe_dp.cu, records or window-start carries) and the checkpoint
// walk's window re-derive (csrc/walk_ckpt.cu). Its plain PyTorch twin is
// pangraph_tpu_torch/ops/stripe_v2.py:_RowStep; the Pallas original is
// pangraph_tpu/ops/stripe_v2.py:_chunk_compute.
//
// Layout. Band coordinates: row i (1-based reference position), band lane k
// in [0, B), query position q = i + k - ms - W. The diagonal predecessor of
// a cell is the same lane of the previous row, the vertical one is lane k+1
// of the previous row, and the horizontal gap is an exclusive prefix-max over
// the row's lanes. Each lane keeps its H and (uncapped) MATCH run in
// registers; only the two values it needs from lane k+1 (H and the query gap)
// go through a double-buffered shared row, so a row costs two barriers; the
// prefix-max is a warp-shuffle scan plus one pass over the per-warp totals.
// The Pallas kernel's 128-row window chunks leave one visible effect, kept
// here: on rows 1, 129, 257, ... lane 0 has no diagonal predecessor. The row
// step takes the absolute row index, so a re-derive that starts mid-problem
// keeps it.
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

// Dynamic shared memory of the row step.
struct RowSmem {
    int* sH;           // [2][B + 1] H of the previous / current row (lane B: NO_ALIGN)
    int* sQ;           // [2][B + 1] query gap of the previous / current row
    int* sTot;         // [32] per-warp inclusive max of P
    int* sTot30;       // [32] inclusive max at warp lane 30
    int* sNQ;          // [32] NQ of each warp's last band lane
    int* sIM;          // [32] in-matrix flag of each warp's last band lane
    int* sP0;          // [32] P of the first lane of each warp's last thread
    uint8_t* sIupac;   // [256] IUPAC masks
};

inline size_t row_smem_bytes(int B) {
    return (size_t)(4 * (B + 1) + 5 * 32) * sizeof(int) + 256;
}

__device__ __forceinline__ RowSmem row_smem(int* smem, int B) {
    RowSmem s;
    s.sH = smem;
    s.sQ = s.sH + 2 * (B + 1);
    s.sTot = s.sQ + 2 * (B + 1);
    s.sTot30 = s.sTot + 32;
    s.sNQ = s.sTot30 + 32;
    s.sIM = s.sNQ + 32;
    s.sP0 = s.sIM + 32;
    s.sIupac = reinterpret_cast<uint8_t*>(s.sP0 + 32);
    return s;
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

// The IUPAC table into shared memory; the barrier of start_row publishes it.
__device__ __forceinline__ void load_iupac(const RowSmem& s, const uint8_t* iupac_g) {
    for (int x = threadIdx.x; x < 256; x += blockDim.x) s.sIupac[x] = iupac_g[x];
}

// Make row r0 the previous row of the next row step. ck = the carry of row r0
// (planes H, query gap, run, [3][B]), or nullptr for row 0 (a free leading
// insertion wherever 0 <= q <= qlen). Ends with a block barrier.
template <int LPT>
__device__ __forceinline__ void start_row(const RowSmem& s, const Problem& P, int r0, const int* ck, int B,
                                          int (&Hc)[LPT], int (&runc)[LPT])
{
    int* hP = s.sH + (r0 & 1) * (B + 1);
    int* qP = s.sQ + (r0 & 1) * (B + 1);
    int* hO = s.sH + ((r0 + 1) & 1) * (B + 1);
    int* qO = s.sQ + ((r0 + 1) & 1) * (B + 1);
    for (int x = threadIdx.x; x <= B; x += blockDim.x) {
        int h = NO_ALIGN, g = NO_ALIGN;
        if (x < B) {
            if (ck) {
                h = ck[x];
                g = ck[B + x];
            } else {
                const int q = x - P.off;
                h = (q >= 0 && q <= P.qlen) ? 0 : NO_ALIGN;
            }
        }
        hP[x] = h;
        qP[x] = g;
        hO[x] = NO_ALIGN;
        qO[x] = NO_ALIGN;
    }
    const int k0 = threadIdx.x * LPT;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        const int k = k0 + j;
        if (ck) {
            Hc[j] = ck[k];
            runc[j] = ck[2 * B + k];
        } else {
            const int q = k - P.off;
            Hc[j] = (q >= 0 && q <= P.qlen) ? 0 : NO_ALIGN;
            runc[j] = 0;
        }
    }
    __syncthreads();
}

// Row i's carry of this thread's lanes into ck ([3][B]); call after the row
// step of row i (or start_row of row 0). The query gap of a lane was written
// to the shared row by this thread itself, or before start_row's barrier.
template <int LPT>
__device__ __forceinline__ void store_carry(const RowSmem& s, int i, int* ck, int B,
                                            const int (&Hc)[LPT], const int (&runc)[LPT])
{
    const int* qC = s.sQ + (i & 1) * (B + 1);
    const int k0 = threadIdx.x * LPT;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        const int k = k0 + j;
        ck[k] = Hc[j];
        ck[B + k] = qC[k];
        ck[2 * B + k] = runc[j];
    }
}

// Row i (1-based, i <= rlen) from row i-1: updates the lanes' registers and
// the shared row, and writes row i's records to rec_row[0, B) unless it is
// nullptr. Ends with a block barrier.
template <int LPT>
__device__ __forceinline__ void row_step(const RowSmem& s, const Problem& P, int i, int B,
                                         int (&Hc)[LPT], int (&runc)[LPT], uint16_t* rec_row)
{
    const int t = threadIdx.x;
    const int lane_id = t & 31;
    const int warp = t >> 5;
    const int k0 = t * LPT;
    const int* hP = s.sH + ((i - 1) & 1) * (B + 1);
    const int* qP = s.sQ + ((i - 1) & 1) * (B + 1);
    int* hC = s.sH + (i & 1) * (B + 1);
    int* qC = s.sQ + (i & 1) * (B + 1);
    const int rm = s.sIupac[P.ref[i - 1]];
    const bool last_row = i == P.rlen;
    const int gap_cost = last_row ? 0 : GAP_OPEN;
    const bool chunk_row = (i - 1) % DP_C == 0;

    // pass 1: everything up to the horizontal-gap input P
    int Mv[LPT], QGv[LPT], NQv[LPT], Pv[LPT], pathv[LPT], rund[LPT];
    bool inm[LPT], intr[LPT], fcol[LPT];
    int tot = NO_ALIGN;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        const int k = k0 + j;
        const int q = i + k - P.off;
        const bool in_matrix = q >= 0 && q <= P.qlen;  // and i <= rlen
        int Hd = Hc[j];
        int rd = runc[j];
        if (k == 0 && chunk_row) {
            Hd = NO_ALIGN;
            rd = 0;
        }
        const int Hu = hP[k + 1];
        const int qgu = qP[k + 1];
        const bool diag_valid = q >= 1 && in_matrix;
        const bool up_valid = k != B - 1 && diag_valid;
        const bool interior = q >= 1 && !last_row && q < P.qlen && in_matrix;
        int path = (!diag_valid && interior) ? BOUNDARY : 0;
        int M = NO_ALIGN;
        if (diag_valid) {
            const int qm = s.sIupac[P.qry[q - 1]];
            const int msub = (rm == 15 || qm == 15) ? SCORE_MATCH - 1
                           : ((rm & qm) ? SCORE_MATCH : -PENALTY_MISMATCH);
            M = Hd + msub;
        }
        const int q_open = (q == P.qlen) ? Hu : Hu - GAP_OPEN;
        const bool q_ext = qgu >= q_open && k < B - 2;
        const int QG = up_valid ? (q_ext ? qgu : q_open) : NO_ALIGN;
        if (up_valid && q_ext) path |= QRY_GAP_EXTEND;
        if (!up_valid && interior) path |= BOUNDARY;
        const bool first_col = q == 0 && in_matrix;
        if (first_col) M = 0;
        const int NQ = max(M, QG);
        const int Pc = in_matrix ? NQ - gap_cost : NO_ALIGN;
        Mv[j] = M;
        QGv[j] = QG;
        NQv[j] = NQ;
        Pv[j] = Pc;
        pathv[j] = path;
        rund[j] = rd;
        inm[j] = in_matrix;
        intr[j] = interior;
        fcol[j] = first_col;
        tot = max(tot, Pc);
    }

    // exclusive prefix-max of P across the band: warp scan of the
    // per-thread maxima, then the totals of the warps below
    int incl = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane_id >= d) incl = max(incl, v);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    int excl_prev = __shfl_up_sync(FULL, incl, 2);
    if (lane_id < 1) excl = NO_ALIGN;
    if (lane_id < 2) excl_prev = NO_ALIGN;
    const int incl30 = __shfl_sync(FULL, incl, 30);
    // the values lane k0-1 (the previous thread's last lane) contributes
    int nb_nq = __shfl_up_sync(FULL, NQv[LPT - 1], 1);
    int nb_im = __shfl_up_sync(FULL, (int)inm[LPT - 1], 1);
    int nb_p0 = __shfl_up_sync(FULL, Pv[0], 1);
    if (lane_id == 31) {
        s.sTot[warp] = incl;
        s.sTot30[warp] = incl30;
        s.sNQ[warp] = NQv[LPT - 1];
        s.sIM[warp] = inm[LPT - 1];
        s.sP0[warp] = Pv[0];
    }
    __syncthreads();

    int pre = NO_ALIGN, pre_prev = NO_ALIGN;  // max over warps < warp, < warp-1
    for (int w = 0; w < warp; ++w) {
        pre_prev = pre;
        pre = max(pre, s.sTot[w]);
    }
    int x_prev;  // exclusive prefix-max before the previous thread's lanes
    if (lane_id == 0) {
        if (warp > 0) {
            x_prev = max(pre_prev, s.sTot30[warp - 1]);
            nb_nq = s.sNQ[warp - 1];
            nb_im = s.sIM[warp - 1];
            nb_p0 = s.sP0[warp - 1];
        } else {
            x_prev = NO_ALIGN;  // lane 0 has no lane below it
        }
    } else {
        x_prev = max(pre, excl_prev);
    }
    int E = max(pre, excl);                               // exclusive prefix at lane k0
    int e_m1 = (LPT == 1) ? x_prev : max(x_prev, nb_p0);  // ... at lane k0-1
    int nq_m1 = nb_nq;
    bool im_m1 = nb_im != 0;

    // pass 2: horizontal gap, origin, record, carries
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        const int k = k0 + j;
        const int Ej = E;
        E = max(E, Pv[j]);
        const int Gv = (k == 0 || !inm[j]) ? NO_ALIGN : Ej;
        int prevG = NO_ALIGN, r_open_prev = NO_ALIGN;
        if (k > 0) {
            prevG = (k == 1 || !im_m1) ? NO_ALIGN : e_m1;
            r_open_prev = max(nq_m1, prevG) - gap_cost;
        }
        const bool r_ext = prevG >= r_open_prev && k > 1;
        int path = pathv[j];
        if (k == 0 && intr[j]) path |= BOUNDARY;
        if (Gv > NO_ALIGN && r_ext) path |= REF_GAP_EXTEND;
        const int M = Mv[j];
        const int QG = QGv[j];
        int best_mr = M, origin = MATCH;
        if (Gv >= M) {
            best_mr = Gv;
            origin = REF_GAP_MATRIX;
        }
        int H = best_mr;
        if (QG >= best_mr) {
            H = QG;
            origin = QRY_GAP_MATRIX;
        }
        if (fcol[j]) {
            H = 0;
            origin = QRY_GAP_MATRIX;
            path = QRY_GAP_EXTEND;
        }
        path |= origin;
        if (!inm[j]) {
            H = NO_ALIGN;
            path = 0;
        }
        const int run = (path & MATCH) ? rund[j] + 1 : 0;  // uncapped; records cap at RUN_CAP
        if (rec_row) rec_row[k] = (uint16_t)(path | (min(run, RUN_CAP) << 6));
        hC[k] = H;
        qC[k] = QG;
        Hc[j] = H;
        runc[j] = run;
        // this lane is lane k-1 of the next one
        nq_m1 = NQv[j];
        im_m1 = inm[j];
        e_m1 = Ej;
    }
    __syncthreads();
}

}  // namespace stripe
