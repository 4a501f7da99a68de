// Run-jump traceback over the checkpointed stripe DP, for Hopper (sm_90a):
// one thread block per problem, persistent over problems.
//
// Replaces the Pallas kernel pangraph_tpu/ops/stripe_v2.py:_walk_ckpt_kernel.
// The plain version, pangraph_tpu_torch/ops/stripe_v2.py:walk_ckpt_plain,
// emits the same events and meta and is what this kernel is held against.
//
// Input: the carries of csrc/stripe_dp.cu's checkpoint mode, ckpt[p][w][3][B]
// int32 (H, query gap, uncapped MATCH run of row w * WV), and the DP's own
// inputs. The walk visits windows of WV rows last to first (WV as the
// reference's ckpt_layout). Per window, thread 0 first refreshes the
// walker's match-run budget rr: a walker sitting on the window's top edge
// reads the uncapped run carried at its cell in the next window's carry
// (band lane k >= 1 only: the reference reads window lane k-1, which drops
// band lane 0). A walker that ends a deletion run on the edge is not
// refreshed: the run's event is emitted at the MATCH move that ends it, so it
// must read that cell's record (the reference refreshes it too, and then
// emits the deletion at a later record read, at the wrong row). If rr covers
// the walker's rows in the window, it crosses the window without reading a
// record. Otherwise the whole block re-derives the
// window's records from its start carry with the DP's row step
// (csrc/stripe_row.cuh, absolute row indices, so the chunk-row rule of lane 0
// holds) into a global scratch window, and thread 0 walks it
// (csrc/walk_step.cuh): first the carried rr, then record by record, with
// match jumps stopped at the window's bottom edge and their remaining rows
// carried in rr. The events equal those of csrc/walk.cu on full records; the
// boundary flag (meta[2]) can differ, since carried jumps read no record.
//
// Layout. The reference re-derives a window of [8, WV, B+128] int16 records
// in 8 MB of VMEM. In band coordinates a window is still WV * B * 2 bytes
// (512 KB at every B), above the 227 KB of shared memory of a block, so each
// block owns a window of global scratch ([WV][B] uint16) that the wrapper
// allocates; the grid is bounded so that all windows together stay about
// L2-sized (stripe_v2.walk_ckpt_grid), and blocks loop over problems
// p = blockIdx.x, + gridDim.x, ... A block holds one problem's band in the
// DP's layout (stripe_row.cuh): one warp for B <= WARP_MAX_B, B/4 threads
// above.
//
// What bounds it: the re-derive, when a walker needs a window: WV rows of the
// DP's serial row chain (see stripe_dp.cu), then one dependent load per event
// for the walk itself. Windows that a carried match run covers cost nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "stripe_row.cuh"
#include "walk_step.cuh"

namespace {

using namespace stripe;
using namespace walkstep;

template <int LPT, bool WIDE>
__global__ void __launch_bounds__(WIDE ? MAX_B / WIDE_LPT : 32) walk_ckpt_kernel(
    const uint8_t* __restrict__ ref, long long ref_stride,
    const uint8_t* __restrict__ qry, long long qry_stride,
    const int* __restrict__ rlen_a, const int* __restrict__ qlen_a,
    const int* __restrict__ ms_a, const int* __restrict__ W_a,
    const uint8_t* __restrict__ iupac_g,
    const int* __restrict__ ckpt, int n_windows, int WV, int B,
    uint16_t* scratch, int K, int* __restrict__ rows, int* __restrict__ words,
    int* __restrict__ nev, int* __restrict__ meta, int m)
{
    __shared__ Tables s_t;
    __shared__ Xchg s_x;
    __shared__ int s_need;
    const int t = threadIdx.x;
    const Lanes L = lanes<LPT, WIDE>();
    uint16_t* win = scratch + (long long)blockIdx.x * WV * B;  // this block's window [WV][B]
    load_tables(s_t, iupac_g);
    init_xchg(s_x);
    __syncthreads();

    for (int p = blockIdx.x; p < m; p += gridDim.x) {
        const Problem P = problem(p, ref, ref_stride, qry, qry_stride, rlen_a, qlen_a, ms_a, W_a);
        const int* ckp = ckpt + (long long)p * n_windows * 3 * B;
        int* rows_p = rows + (long long)p * K;
        int* words_p = words + (long long)p * K;
        Walker wk = walker(P.rlen, P.qlen);  // thread 0's
        const int w_top = P.rlen > 0 ? min((P.rlen - 1) / WV, n_windows - 1) : -1;
        for (int w = w_top; w >= 0; --w) {
            const int c0 = w * WV;  // the window holds rows c0+1 .. c0+WV
            if (t == 0) {
                if (!wk.dead && wk.i == c0 + WV && wk.st == 0 && wk.dl == 0 && wk.rr < WV && w < n_windows - 1) {
                    const int k = wk.q + P.off - wk.i;
                    const int run_c = (k >= 1 && k < B) ? ckp[(long long)(w + 1) * 3 * B + 2 * B + k] : 0;
                    wk.rr = max(wk.rr, run_c);
                }
                const int left = wk.i - c0;
                int need = 0;
                if (!wk.dead && left > 0) {
                    if (wk.rr >= left) {  // the carried run crosses the window
                        wk.i -= left;
                        wk.q -= left;
                        wk.rr -= left;
                    } else {
                        need = 1;
                    }
                }
                s_need = need;
            }
            __syncthreads();
            if (s_need) {
                Band<LPT> b;
                Stage st;
                start_row<LPT>(b, st, P, L, c0, ckp + (long long)w * 3 * B, B, s_t);
                run_rows<LPT, WIDE, true>(
                    b, st, P, L, &s_x, c0 + 1, min(c0 + WV, P.rlen), B, s_t,
                    [&](int i) { return win + (long long)(i - 1 - c0) * B; }, 0, [](int) {});
                __syncthreads();  // the window's records, for thread 0
                if (t == 0) {
                    const int jump = min(wk.rr, wk.i - c0);  // the carried run first
                    wk.i -= jump;
                    wk.q -= jump;
                    wk.rr -= jump;
                    while (wk.i > c0 && !wk.dead) {
                        const int k = wk.q + P.off - wk.i;
                        const int word = (k >= 0 && k < B) ? (int)win[(long long)(wk.i - 1 - c0) * B + k] : 0;
                        walk_move(wk, word, c0, K, rows_p, words_p);
                    }
                }
            }
            __syncthreads();  // s_need and the window are reused
        }
        if (t == 0) walk_finish(wk, K, rows_p, words_p, nev + p, meta + 4 * (long long)p);
    }
}

template <int LPT, bool WIDE>
void run(int grid, cudaStream_t st, const uint8_t* r, long long ref_stride, const uint8_t* q, long long qry_stride,
         const int* rl, const int* ql, const int* msp, const int* wp, const uint8_t* iu, const int* ck,
         int n_windows, int WV, int B, uint16_t* sc, int K, int* ro, int* wo, int* ne, int* me, int m)
{
    const int threads = WIDE ? B / LPT : 32;
    walk_ckpt_kernel<LPT, WIDE><<<grid, threads, 0, st>>>(r, ref_stride, q, qry_stride, rl, ql, msp, wp, iu,
                                                         ck, n_windows, WV, B, sc, K, ro, wo, ne, me, m);
}

}  // namespace

extern "C" int walk_ckpt_launch(
    const void* ref, long long ref_stride, const void* qry, long long qry_stride,
    const void* rlen, const void* qlen, const void* ms, const void* W, const void* iupac,
    const void* ckpt, int n_windows, int WV, int B, void* scratch, int grid, int K,
    void* rows, void* words, void* nev, void* meta, int m, void* stream)
{
    if (m <= 0) return 0;
    if (B < 128 || B > MAX_B || B % 128 != 0 || K < 1 || grid < 1 || n_windows < 1 ||
        WV < DP_C || WV % DP_C != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* r = static_cast<const uint8_t*>(ref);
    const uint8_t* q = static_cast<const uint8_t*>(qry);
    const int* rl = static_cast<const int*>(rlen);
    const int* ql = static_cast<const int*>(qlen);
    const int* msp = static_cast<const int*>(ms);
    const int* wp = static_cast<const int*>(W);
    const uint8_t* iu = static_cast<const uint8_t*>(iupac);
    const int* ck = static_cast<const int*>(ckpt);
    uint16_t* sc = static_cast<uint16_t*>(scratch);
    int* ro = static_cast<int*>(rows);
    int* wo = static_cast<int*>(words);
    int* ne = static_cast<int*>(nev);
    int* me = static_cast<int*>(meta);
    const auto fn = B > WARP_MAX_B ? run<WIDE_LPT, true> : B == 128 ? run<4, false> : run<8, false>;
    fn(grid, st, r, ref_stride, q, qry_stride, rl, ql, msp, wp, iu, ck, n_windows, WV, B, sc, K, ro, wo, ne, me, m);
    return (int)cudaGetLastError();
}
