// Run-jump traceback over the checkpointed stripe DP, for Hopper (sm_90a):
// the windows are re-derived in parallel, ahead of a walker that takes them
// in order.
//
// Replaces the Pallas kernel pangraph_tpu/ops/stripe_v2.py:_walk_ckpt_kernel.
// The plain version, pangraph_tpu_torch/ops/stripe_v2.py:walk_ckpt_plain,
// emits the same events and meta and is what this kernel is held against.
//
// Input: the carries of csrc/stripe_dp.cu's checkpoint mode, ckpt[p][w][3][B]
// int32 (H, query gap, uncapped MATCH run of row w * WV), and the DP's own
// inputs. A window of WV rows (WV as the reference's ckpt_layout) depends
// only on its start carry, not on the walk, so every window of every problem
// can be re-derived at once; only the walker goes in order, last window to
// first. The wrapper (stripe_v2.walk_ckpt_cuda) splits a launch into waves
// whose windows fit a scratch budget (stripe_v2.walk_ckpt_plan): a group of
// problems [p_lo, p_hi) and a range of windows [w_lo, w_hi), the top windows
// first. A wave is two kernels, ordered by the stream, so that no block ever
// waits on another:
// - rederive_kernel: one (problem, window) pair per warp (B <= WARP_MAX_B,
//   four pairs a block) or per block of B/4 threads (wider bands), in the
//   DP's layouts. It runs the window's rows from its start carry through the
//   DP's row step (csrc/stripe_row.cuh: start_row + run_rows, with absolute
//   row indices, so the chunk-row rule of lane 0 holds) into the wave's
//   scratch, scratch[p - p_lo][i - 1 - w_lo * WV][k] for row i, band lane k.
// - walk_kernel: one warp a problem (its lane 0) walks the wave's windows
//   top to bottom (csrc/walk_step.cuh), its state (walkstep::Walker) kept in
//   a device array between waves. Per window it first refreshes its
//   match-run budget rr: a walker sitting on the window's top edge reads
//   the uncapped run carried at its cell in the next window's carry (band
//   lane k >= 1 only: the reference reads window lane k-1, which drops band
//   lane 0). A walker that
//   ends a deletion run on the edge is not refreshed: the run's event is
//   emitted at the MATCH move that ends it, so it must read that cell's
//   record (the reference refreshes it too, and then emits the deletion at a
//   later record read, at the wrong row). The carried rr is consumed first;
//   if it covers the walker's rows in the window, the walker crosses the
//   window without reading a record. Then it walks record by record, with
//   match jumps stopped at the window's bottom edge and their remaining
//   rows carried in rr. These rules decide which cells the walk reads: the
//   events equal those of csrc/walk.cu on full records, and the boundary
//   flag (meta[2]) can differ, since carried jumps read no record.
//
// What bounds it: the re-derive of one window, WV rows of the DP's serial
// row chain (see stripe_dp.cu), when the card holds a wave's windows at once;
// a wave of more windows than the SMs hold runs in rounds, bound by the
// rows' instructions over the SMs' issue rate. Then the walk: one dependent
// load per move, each a few hundred cycles, and one launch pair per wave.
// Windows that the walker crosses on a carried run are re-derived all the
// same: work done in parallel, off the critical path. The reference
// re-derives a window only when the walker needs it, in 8 MB of VMEM; here a
// window (WV * B * 2 bytes, 512 KB at every B) exceeds a block's 227 KB of
// shared memory, so windows go to device memory, and the budget bounds how
// many are held at once.

#include <cstdint>
#include <cuda_runtime.h>

#include "stripe_row.cuh"
#include "walk_step.cuh"

namespace {

using namespace stripe;
using namespace walkstep;

constexpr int WARPS_PER_BLOCK = 4;  // (problem, window) pairs a block in the warp layout
// The walk runs one problem a warp, on its lane 0: the walkers of one warp
// would start their windows at different rows and so diverge, and a warp
// runs diverged walkers' dependent loads one after another (measured on an
// H100: 8 problems in one warp walked in about the sum of their walks).
constexpr int WALK_THREADS = 128;

static_assert(sizeof(Walker) == 10 * sizeof(int), "stripe_v2.WALKER_INTS is the Walker's size in ints");

// A wave: problems [p_lo, p_hi), windows [w_lo, w_hi); its scratch holds S
// rows of B lanes a problem, from row w_lo * WV + 1.
struct Wave {
    int p_lo, p_hi, w_lo, w_hi, S;
};

// Offset of row i of problem p in the wave's scratch.
__device__ __forceinline__ long long slot(const Wave& v, int p, int i, int WV, int B) {
    return ((long long)(p - v.p_lo) * v.S + (i - 1 - v.w_lo * WV)) * B;
}

template <int LPT, bool WIDE>
__global__ void __launch_bounds__(WIDE ? MAX_B / WIDE_LPT : WARPS_PER_BLOCK * 32) rederive_kernel(
    const uint8_t* __restrict__ ref, long long ref_stride,
    const uint8_t* __restrict__ qry, long long qry_stride,
    const int* __restrict__ rlen_a, const int* __restrict__ qlen_a,
    const int* __restrict__ ms_a, const int* __restrict__ W_a,
    const uint8_t* __restrict__ iupac_g,
    const int* __restrict__ ckpt, int n_windows, int WV, int B, Wave v, uint16_t* __restrict__ scratch)
{
    __shared__ Tables s_t;
    __shared__ Xchg s_x;
    load_tables(s_t, iupac_g);
    init_xchg(s_x);
    __syncthreads();
    const int mp = v.p_hi - v.p_lo;
    const int u = WIDE ? (int)blockIdx.x : (int)(blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5));
    if (u >= mp * (v.w_hi - v.w_lo)) return;  // a whole warp, or (wide) the whole block
    const int p = v.p_lo + u % mp;
    const int w = v.w_hi - 1 - u / mp;  // the top windows in the first blocks
    const Problem P = problem(p, ref, ref_stride, qry, qry_stride, rlen_a, qlen_a, ms_a, W_a);
    const int c0 = w * WV;  // the window holds rows c0+1 .. c0+WV
    if (c0 >= P.rlen) return;
    const Lanes L = lanes<LPT, WIDE>();
    Band<LPT> b;
    Stage st;
    start_row<LPT>(b, st, P, L, c0, ckpt + ((long long)p * n_windows + w) * 3 * B, B, s_t);
    uint16_t* win = scratch + slot(v, p, c0 + 1, WV, B);
    run_rows<LPT, WIDE, true>(
        b, st, P, L, &s_x, c0 + 1, min(c0 + WV, P.rlen), B, s_t,
        [&](int i) { return win + (long long)(i - 1 - c0) * B; }, 0, [](int) {});
}

__global__ void walk_kernel(
    const int* __restrict__ rlen_a, const int* __restrict__ qlen_a,
    const int* __restrict__ ms_a, const int* __restrict__ W_a,
    const int* __restrict__ ckpt, int n_windows, int WV, int B, Wave v,
    const uint16_t* __restrict__ scratch, Walker* __restrict__ state, int first, int last,
    int K, int* __restrict__ rows, int* __restrict__ words, int* __restrict__ nev, int* __restrict__ meta)
{
    const int p = v.p_lo + (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    if ((threadIdx.x & 31) != 0 || p >= v.p_hi) return;
    const int rlen = rlen_a[p];
    const int off = ms_a[p] + W_a[p];
    const int* ckp = ckpt + (long long)p * n_windows * 3 * B;
    int* rows_p = rows + (long long)p * K;
    int* words_p = words + (long long)p * K;
    Walker wk = first ? walker(rlen, qlen_a[p]) : state[p];
    const int w_top = rlen > 0 ? min((rlen - 1) / WV, n_windows - 1) : -1;
    for (int w = min(v.w_hi - 1, w_top); w >= v.w_lo && !wk.dead; --w) {
        const int c0 = w * WV;
        if (wk.i == c0 + WV && wk.st == 0 && wk.dl == 0 && wk.rr < WV && w < n_windows - 1) {
            const int k = wk.q + off - wk.i;
            const int run_c = (k >= 1 && k < B) ? ckp[(long long)(w + 1) * 3 * B + 2 * B + k] : 0;
            wk.rr = max(wk.rr, run_c);
        }
        const int left = wk.i - c0;
        if (left <= 0) continue;
        const int jump = min(wk.rr, left);  // the carried run first: it may cross the window
        wk.i -= jump;
        wk.q -= jump;
        wk.rr -= jump;
        while (wk.i > c0 && !wk.dead) {
            const int k = wk.q + off - wk.i;
            const int word = (k >= 0 && k < B) ? (int)scratch[slot(v, p, wk.i, WV, B) + k] : 0;
            walk_move(wk, word, c0, K, rows_p, words_p);
        }
    }
    if (last)
        walk_finish(wk, K, rows_p, words_p, nev + p, meta + 4 * (long long)p);
    else
        state[p] = wk;
}

template <int LPT, bool WIDE>
void rederive(cudaStream_t st, const uint8_t* r, long long ref_stride, const uint8_t* q, long long qry_stride,
              const int* rl, const int* ql, const int* msp, const int* wp, const uint8_t* iu, const int* ck,
              int n_windows, int WV, int B, const Wave& v, uint16_t* sc)
{
    const int pairs = (v.p_hi - v.p_lo) * (v.w_hi - v.w_lo);
    const int blocks = WIDE ? pairs : (pairs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    const int threads = WIDE ? B / LPT : WARPS_PER_BLOCK * 32;
    rederive_kernel<LPT, WIDE><<<blocks, threads, 0, st>>>(r, ref_stride, q, qry_stride, rl, ql, msp, wp, iu, ck,
                                                           n_windows, WV, B, v, sc);
}

bool wave_ok(int n_windows, int WV, int B, const Wave& v) {
    return B >= 128 && B <= MAX_B && B % 128 == 0 && n_windows >= 1 && WV >= DP_C && WV % DP_C == 0 &&
           v.p_lo >= 0 && v.p_lo < v.p_hi && v.w_lo >= 0 && v.w_lo < v.w_hi && v.w_hi <= n_windows &&
           v.S >= 0 && (long long)(v.p_hi - v.p_lo) * (v.w_hi - v.w_lo) < (1LL << 31);
}

}  // namespace

// Re-derive the windows [w_lo, w_hi) of problems [p_lo, p_hi) into scratch
// ([p_hi - p_lo][S][B] uint16).
extern "C" int walk_ckpt_rederive_launch(
    const void* ref, long long ref_stride, const void* qry, long long qry_stride,
    const void* rlen, const void* qlen, const void* ms, const void* W, const void* iupac,
    const void* ckpt, int n_windows, int WV, int B, void* scratch, int S,
    int p_lo, int p_hi, int w_lo, int w_hi, void* stream)
{
    const Wave v{p_lo, p_hi, w_lo, w_hi, S};
    if (!wave_ok(n_windows, WV, B, v)) return (int)cudaErrorInvalidValue;
    const auto fn = B > WARP_MAX_B ? rederive<WIDE_LPT, true> : B == 128 ? rederive<4, false> : rederive<8, false>;
    fn(static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(ref), ref_stride,
       static_cast<const uint8_t*>(qry), qry_stride, static_cast<const int*>(rlen), static_cast<const int*>(qlen),
       static_cast<const int*>(ms), static_cast<const int*>(W), static_cast<const uint8_t*>(iupac),
       static_cast<const int*>(ckpt), n_windows, WV, B, v, static_cast<uint16_t*>(scratch));
    return (int)cudaGetLastError();
}

// Walk the wave's windows, top to bottom. first: the walkers start at
// (rlen, qlen); otherwise they resume from state ([m] Walker). last: they
// finish (n_events and meta written); otherwise they are stored in state.
extern "C" int walk_ckpt_walk_launch(
    const void* rlen, const void* qlen, const void* ms, const void* W,
    const void* ckpt, int n_windows, int WV, int B, const void* scratch, int S,
    int p_lo, int p_hi, int w_lo, int w_hi, void* state, int first, int last,
    int K, void* rows, void* words, void* nev, void* meta, void* stream)
{
    const Wave v{p_lo, p_hi, w_lo, w_hi, S};
    if (!wave_ok(n_windows, WV, B, v) || K < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (p_hi - p_lo + WALK_THREADS / 32 - 1) / (WALK_THREADS / 32);
    walk_kernel<<<blocks, WALK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rlen), static_cast<const int*>(qlen), static_cast<const int*>(ms),
        static_cast<const int*>(W), static_cast<const int*>(ckpt), n_windows, WV, B, v,
        static_cast<const uint16_t*>(scratch), static_cast<Walker*>(state), first, last, K,
        static_cast<int*>(rows), static_cast<int*>(words), static_cast<int*>(nev), static_cast<int*>(meta));
    return (int)cudaGetLastError();
}
