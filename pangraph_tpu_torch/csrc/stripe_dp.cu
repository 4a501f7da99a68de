// Banded stripe DP for Hopper (sm_90a).
//
// Replaces two Pallas kernels of pangraph_tpu/ops/stripe_v2.py: _dp_kernel,
// which writes the records, and (in checkpoint mode) _dp_ckpt_kernel, which
// keeps only the carry at each window start. Both run the row recurrence of
// csrc/stripe_row.cuh (the Pallas _chunk_compute and _prefix_max_exclusive).
// The plain PyTorch versions, pangraph_tpu_torch/ops/stripe_v2.py:
// stripe_dp_plain and stripe_dp_ckpt_plain, compute the same records and
// carries and are what this kernel is held against.
//
// Records are written in band coordinates, rec[p][i-1][k] for row i and band
// lane k (see stripe_row.cuh). In checkpoint mode nothing per row leaves the
// SM: after row 0 and after every row i with i % WV == 0 the problem's
// threads write row i's carry (H, query gap, uncapped MATCH run; [3][B]
// int32) to ckpt[p][i / WV], which is what the walk re-derives a window
// from. The Pallas kernel's 128-row window chunks, groups of 16 problems and
// group row bound exist for VMEM and the (8,128) tile and are not carried
// over.
//
// What bounds it: the serial chain of rows of the longest problem. Row i
// needs all of row i-1, and the path from one row's H to the next row's H
// runs through the horizontal gap's prefix-max across the band. Its bytes
// (one int16 record per cell, or none in checkpoint mode) and its integer
// operations are far below the card's rates; the build's launches mostly
// hold fewer problems than the card has SMs, so a launch costs its longest
// problem's rows times one row's latency. A warp issues in order, so that
// latency is the row's critical path plus every stall on a shuffle or a
// load that the row's other work does not cover. The critical path of the
// design below is about 150 cycles at B 128 (chip_smoke.py's
// dp_row_cycles), and a row takes about 370-430 on an H100 (chip_smoke.py
// phase 3, dev/dp_ab_cuda.py).
//
// What the design does about it (stripe_row.cuh has the row step):
// - Warp layout for B <= WARP_MAX_B (128 and 256): one warp per problem,
//   B/32 lanes a thread in registers, four problems per block. Nothing on the row chain
//   leaves the warp: no barrier, no shared memory. Lane k+1's H and query
//   gap come by shuffle, and the prefix-max is each thread's own prefix (a
//   tree of 3-input maxes) plus an exclusive warp scan of the thread totals
//   in three levels of 3-input maxes over shuffles.
// - Wide layout for B > WARP_MAX_B: one block of B/4 threads per problem
//   (4 lanes a thread, 3-16 warps), one barrier per row, the warps' totals
//   combined by one warp reduction, the exchange double-buffered by row
//   parity so that no second barrier is needed and written and read without
//   a branch. Past B 256 a warp's serial work on its lanes costs more than
//   the barrier (B 512 ran at about 1,000 cycles a row in one warp and 690
//   in four, on an H100).
// - Most rows take the interior form of the row step (no matrix edge in the
//   warp's lanes, not the last row), whose recurrence has no edge cases.
//   run_rows groups those rows into stretches whose loop holds no branch,
//   so the compiler schedules a whole row and hides the shuffles' latency
//   behind the row's other work; edge rows take the general form.
// - No global load on the chain: the query masks move down one lane per
//   row, and a warp stages its reference bytes and its top lane's query
//   bytes 32 rows ahead in registers; a lane's match score comes from a
//   16 x 16 table in shared memory. Records leave as one 8- or 16-byte store
//   per thread per row.

#include <cstdint>
#include <cuda_runtime.h>

#include "stripe_row.cuh"

namespace {

using namespace stripe;

constexpr int WARPS_PER_BLOCK = 4;  // problems per block in the warp layout

template <int LPT, bool WIDE, bool CKPT>
__global__ void __launch_bounds__(WIDE ? MAX_B / WIDE_LPT : WARPS_PER_BLOCK * 32) stripe_dp_kernel(
    const uint8_t* __restrict__ ref, long long ref_stride,
    const uint8_t* __restrict__ qry, long long qry_stride,
    const int* __restrict__ rlen_a, const int* __restrict__ qlen_a,
    const int* __restrict__ ms_a, const int* __restrict__ W_a,
    const uint8_t* __restrict__ iupac_g,
    uint16_t* __restrict__ rec, long long rec_rows,
    int* __restrict__ ckpt, int n_windows, int WV, int B, int m)
{
    __shared__ Tables s_t;
    __shared__ Xchg s_x;
    load_tables(s_t, iupac_g);
    init_xchg(s_x);
    __syncthreads();
    const int p = WIDE ? (int)blockIdx.x : (int)(blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5));
    if (p >= m) return;  // a whole warp, or (wide) the whole block
    const Lanes L = lanes<LPT, WIDE>();
    const Problem P = problem(p, ref, ref_stride, qry, qry_stride, rlen_a, qlen_a, ms_a, W_a);
    uint16_t* recp = CKPT ? nullptr : rec + (long long)p * rec_rows * B;
    int* ckp = CKPT ? ckpt + (long long)p * n_windows * 3 * B : nullptr;

    Band<LPT> b;
    Stage st;
    start_row<LPT>(b, st, P, L, 0, nullptr, B, s_t);
    if (CKPT) store_carry<LPT>(b, L, ckp, B);
    run_rows<LPT, WIDE, !CKPT>(
        b, st, P, L, &s_x, 1, P.rlen, B, s_t,
        [&](int i) { return CKPT ? nullptr : recp + (long long)(i - 1) * B; }, CKPT ? WV : 0,
        [&](int i) {
            if (i / WV < n_windows) store_carry<LPT>(b, L, ckp + (long long)(i / WV) * 3 * B, B);
        });
}

struct Args {
    const uint8_t* ref;
    long long ref_stride;
    const uint8_t* qry;
    long long qry_stride;
    const int *rlen, *qlen, *ms, *W;
    const uint8_t* iupac;
    uint16_t* rec;
    long long rec_rows;
    int* ckpt;
    int n_windows, WV, B, m;
};

template <int LPT, bool WIDE, bool CKPT>
void run(const Args& a, cudaStream_t st) {
    const int blocks = WIDE ? a.m : (a.m + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    const int threads = WIDE ? a.B / LPT : WARPS_PER_BLOCK * 32;
    stripe_dp_kernel<LPT, WIDE, CKPT><<<blocks, threads, 0, st>>>(
        a.ref, a.ref_stride, a.qry, a.qry_stride, a.rlen, a.qlen, a.ms, a.W, a.iupac,
        a.rec, a.rec_rows, a.ckpt, a.n_windows, a.WV, a.B, a.m);
}

template <bool CKPT>
int launch(const Args& a, void* stream)
{
    if (a.m <= 0) return 0;
    if (a.B < 128 || a.B > MAX_B || a.B % 128 != 0) return (int)cudaErrorInvalidValue;
    if (CKPT && (a.WV < DP_C || a.WV % DP_C != 0 || a.n_windows < 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (a.B > WARP_MAX_B)
        run<WIDE_LPT, true, CKPT>(a, st);
    else if (a.B == 128)
        run<4, false, CKPT>(a, st);
    else
        run<8, false, CKPT>(a, st);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stripe_dp_launch(
    const void* ref, long long ref_stride, const void* qry, long long qry_stride,
    const void* rlen, const void* qlen, const void* ms, const void* W, const void* iupac,
    void* rec, long long rec_rows, int B, int m, void* stream)
{
    const Args a{static_cast<const uint8_t*>(ref), ref_stride, static_cast<const uint8_t*>(qry), qry_stride,
                 static_cast<const int*>(rlen), static_cast<const int*>(qlen), static_cast<const int*>(ms),
                 static_cast<const int*>(W), static_cast<const uint8_t*>(iupac), static_cast<uint16_t*>(rec),
                 rec_rows, nullptr, 0, 0, B, m};
    return launch<false>(a, stream);
}

// Checkpoint mode: ckpt [m][n_windows][3][B] int32, window start rows w * WV;
// windows that start past a problem's rlen are left as they were.
extern "C" int stripe_dp_ckpt_launch(
    const void* ref, long long ref_stride, const void* qry, long long qry_stride,
    const void* rlen, const void* qlen, const void* ms, const void* W, const void* iupac,
    void* ckpt, int n_windows, int WV, int B, int m, void* stream)
{
    const Args a{static_cast<const uint8_t*>(ref), ref_stride, static_cast<const uint8_t*>(qry), qry_stride,
                 static_cast<const int*>(rlen), static_cast<const int*>(qlen), static_cast<const int*>(ms),
                 static_cast<const int*>(W), static_cast<const uint8_t*>(iupac), nullptr, 0,
                 static_cast<int*>(ckpt), n_windows, WV, B, m};
    return launch<true>(a, stream);
}
