// Anchor-chain DP (minimap2's mm_chain_dp) for Hopper (sm_90a): one warp per
// anchor set, a ragged batch of sets in one launch.
//
// Replaces the Pallas kernel pangraph_tpu/ops/chain_k2.py:_chain_kernel. The
// plain version, pangraph_tpu_torch/ops/chain_k2.py:chain_sets_plain, gives
// the same f and parent and is what this kernel is held against.
//
//   f[i] = max(k, max_{h<H} f[i-1-h] + min(dr,dq,k) - (dd*k/100 + (ilog2(dd) >> 1)))
//
// gated by dr > 0, dq > 0, dr <= max_gap, dq <= max_gap, dd <= bw; parent[i]
// is i-1-h for the smallest h with the strictly greatest candidate, where
// that candidate beats k, else -1. ilog2 is the reference's ladder,
// min(floor(log2 max(dd, 1)), 10). Coordinates and scores are int32, as in
// the reference kernel.
//
// The reference has no cheap scalar loop, so it iterates each 1024-anchor
// tile to a fixed point, one chain hop per sweep. The card has one: a warp
// runs the recurrence in order. For anchor i, lane h evaluates predecessor
// i-1-h (in rounds of 32 lanes for H > 32), keeping in each lane the first
// best over its rounds; a warp max, then a warp min of h over the lanes that
// hold it, give f[i] and the nearest-on-tie parent. r and q are read from
// device memory (the last H anchors were read just before, so they should
// hit in L1); f of the last 1024 anchors is kept in a shared-memory ring,
// since f[i] is what the next anchor waits for. Outputs are buffered one
// per lane and stored 32 at a time.
//
// What bounds it: the dependency from f[i-1] to f[i], a chain of some
// hundred cycles per anchor (a shared-memory load, the candidate, two warp
// reductions, a shared-memory store), times the longest set's anchors; the
// operations, about 30 a candidate, are far from the card's rate, and one
// warp per set leaves most of the 132 SMs idle when there are fewer sets
// than warps the card holds. The design does nothing about the chain yet:
// keeping the H <= 32 window in registers (shifted with __shfl_up_sync)
// would shorten it, and splitting a long set into stretches that converge
// from a guess, as the reference does, would spread it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // sets per block
constexpr int RING = 1024;  // f of the last RING anchors; H <= RING
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int ilog2_capped(int dd)
{
    const int lg = 31 - __clz(dd > 1 ? dd : 1);
    return lg < 10 ? lg : 10;
}

__device__ __forceinline__ int floor_div100(int a)
{
    const int d = a / 100;
    return (a % 100 != 0 && a < 0) ? d - 1 : d;
}

__global__ void __launch_bounds__(WARPS * 32) chain_kernel(
    const int* __restrict__ r, const int* __restrict__ q, const long long* __restrict__ offsets,
    int n_sets, int k, int max_gap, int bw, int H, int* __restrict__ f, int* __restrict__ parent)
{
    __shared__ int ring_all[WARPS][RING];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s = blockIdx.x * WARPS + warp;
    if (s >= n_sets) return;  // the whole warp leaves together
    int* ring = ring_all[warp];
    const long long o = offsets[s];
    const int n = (int)(offsets[s + 1] - o);
    const int* R = r + o;
    const int* Q = q + o;
    int my_f = 0, my_p = -1;
    for (int i = 0; i < n; i++) {
        const int ri = __ldg(R + i), qi = __ldg(Q + i);
        int best = INT_MIN, besth = -1;
        for (int h0 = 0; h0 < H; h0 += 32) {
            const int h = h0 + lane;
            const int j = i - 1 - h;
            if (h < H && j >= 0) {
                const int dr = ri - __ldg(R + j), dq = qi - __ldg(Q + j);
                const int dd = dr > dq ? dr - dq : dq - dr;
                if (dr > 0 && dq > 0 && dr <= max_gap && dq <= max_gap && dd <= bw) {
                    int alpha = dr < dq ? dr : dq;
                    alpha = alpha < k ? alpha : k;
                    const int gap = floor_div100((int)((unsigned)dd * (unsigned)k)) + (ilog2_capped(dd) >> 1);
                    const int cand = ring[j & (RING - 1)] + alpha - gap;
                    if (cand > best) { best = cand; besth = h; }
                }
            }
        }
        const int wbest = __reduce_max_sync(FULL, best);
        const int h = __reduce_min_sync(FULL, best == wbest ? besth : INT_MAX);
        const int fi = wbest > k ? wbest : k;
        const int pi = wbest > k ? i - 1 - h : -1;
        if (lane == 0) ring[i & (RING - 1)] = fi;  // slot of i - RING, read for the last time above
        if (lane == (i & 31)) { my_f = fi; my_p = pi; }
        if ((i & 31) == 31 || i == n - 1) {
            const int first = i & ~31;
            if (lane <= (i & 31)) { f[o + first + lane] = my_f; parent[o + first + lane] = my_p; }
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" int chain_launch(
    const void* r, const void* q, const void* offsets, int n_sets, int k, int max_gap, int bw, int H,
    void* f, void* parent, void* stream)
{
    if (n_sets <= 0) return 0;
    if (H < 1 || H > RING) return (int)cudaErrorInvalidValue;
    const int blocks = (n_sets + WARPS - 1) / WARPS;
    chain_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(r), static_cast<const int*>(q), static_cast<const long long*>(offsets),
        n_sets, k, max_gap, bw, H, static_cast<int*>(f), static_cast<int*>(parent));
    return (int)cudaGetLastError();
}
