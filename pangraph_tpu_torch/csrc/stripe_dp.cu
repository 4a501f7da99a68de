// Banded stripe DP for Hopper (sm_90a): one thread block per problem.
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
// SM: after row 0 and after every row i with i % WV == 0 the block writes
// row i's carry (H, query gap, uncapped MATCH run; [3][B] int32) to
// ckpt[p][i / WV], which is what the walk re-derives a window from. The
// Pallas kernel's 128-row window chunks, groups of 16 problems and group row
// bound exist for VMEM and the (8,128) tile and are not carried over.
//
// What bounds it: the serial chain of rows. Row i needs all of row i-1, and
// a row is some hundred dependent integer operations, a prefix-max across
// the band and two block barriers. Its bytes (one int16 record per cell, or
// none in checkpoint mode, one query byte per lane, coalesced) are far below
// the card's bandwidth. What the design does about it: see stripe_row.cuh;
// one block per problem lets many problems share an SM (sixteen 128-thread
// blocks at B = 128), which hides each problem's row latency behind the
// others'.

#include <cstdint>
#include <cuda_runtime.h>

#include "stripe_row.cuh"

namespace {

using namespace stripe;

template <int LPT, bool CKPT>
__global__ void __launch_bounds__(1024) stripe_dp_kernel(
    const uint8_t* __restrict__ ref, long long ref_stride,
    const uint8_t* __restrict__ qry, long long qry_stride,
    const int* __restrict__ rlen_a, const int* __restrict__ qlen_a,
    const int* __restrict__ ms_a, const int* __restrict__ W_a,
    const uint8_t* __restrict__ iupac_g,
    uint16_t* __restrict__ rec, long long rec_rows,
    int* __restrict__ ckpt, int n_windows, int WV, int B)
{
    extern __shared__ int smem[];
    const RowSmem s = row_smem(smem, B);
    const int p = blockIdx.x;
    const Problem P = problem(p, ref, ref_stride, qry, qry_stride, rlen_a, qlen_a, ms_a, W_a);
    uint16_t* recp = CKPT ? nullptr : rec + (long long)p * rec_rows * B;
    int* ckp = CKPT ? ckpt + (long long)p * n_windows * 3 * B : nullptr;

    load_iupac(s, iupac_g);
    int Hc[LPT], runc[LPT];
    start_row<LPT>(s, P, 0, nullptr, B, Hc, runc);
    if (CKPT) store_carry<LPT>(s, 0, ckp, B, Hc, runc);
    for (int i = 1; i <= P.rlen; ++i) {
        row_step<LPT>(s, P, i, B, Hc, runc, CKPT ? nullptr : recp + (long long)(i - 1) * B);
        if (CKPT && i % WV == 0 && i / WV < n_windows)
            store_carry<LPT>(s, i, ckp + (long long)(i / WV) * 3 * B, B, Hc, runc);
    }
}

template <bool CKPT>
int launch(const void* ref, long long ref_stride, const void* qry, long long qry_stride,
           const void* rlen, const void* qlen, const void* ms, const void* W, const void* iupac,
           void* rec, long long rec_rows, void* ckpt, int n_windows, int WV, int B, int m, void* stream)
{
    if (m <= 0) return 0;
    if (B < 128 || B > 2048 || B % 128 != 0) return (int)cudaErrorInvalidValue;
    if (CKPT && (WV < DP_C || WV % DP_C != 0 || n_windows < 1)) return (int)cudaErrorInvalidValue;
    const int lpt = B > 1024 ? 2 : 1;
    const int threads = B / lpt;
    const size_t shm = row_smem_bytes(B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* r = static_cast<const uint8_t*>(ref);
    const uint8_t* q = static_cast<const uint8_t*>(qry);
    const int* rl = static_cast<const int*>(rlen);
    const int* ql = static_cast<const int*>(qlen);
    const int* msp = static_cast<const int*>(ms);
    const int* wp = static_cast<const int*>(W);
    const uint8_t* iu = static_cast<const uint8_t*>(iupac);
    uint16_t* out = static_cast<uint16_t*>(rec);
    int* ck = static_cast<int*>(ckpt);
    if (lpt == 1)
        stripe_dp_kernel<1, CKPT><<<m, threads, shm, st>>>(r, ref_stride, q, qry_stride, rl, ql, msp, wp, iu,
                                                             out, rec_rows, ck, n_windows, WV, B);
    else
        stripe_dp_kernel<2, CKPT><<<m, threads, shm, st>>>(r, ref_stride, q, qry_stride, rl, ql, msp, wp, iu,
                                                             out, rec_rows, ck, n_windows, WV, B);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stripe_dp_launch(
    const void* ref, long long ref_stride, const void* qry, long long qry_stride,
    const void* rlen, const void* qlen, const void* ms, const void* W, const void* iupac,
    void* rec, long long rec_rows, int B, int m, void* stream)
{
    return launch<false>(ref, ref_stride, qry, qry_stride, rlen, qlen, ms, W, iupac, rec, rec_rows,
                         nullptr, 0, 0, B, m, stream);
}

// Checkpoint mode: ckpt [m][n_windows][3][B] int32, window start rows w * WV;
// windows that start past a problem's rlen are left as they were.
extern "C" int stripe_dp_ckpt_launch(
    const void* ref, long long ref_stride, const void* qry, long long qry_stride,
    const void* rlen, const void* qlen, const void* ms, const void* W, const void* iupac,
    void* ckpt, int n_windows, int WV, int B, int m, void* stream)
{
    return launch<true>(ref, ref_stride, qry, qry_stride, rlen, qlen, ms, W, iupac, nullptr, 0,
                        ckpt, n_windows, WV, B, m, stream);
}
