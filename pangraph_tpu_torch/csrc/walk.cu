// Run-jump traceback over the stripe DP's records, for Hopper (sm_90a): one
// warp per problem, gap runs read a warp's width at a time.
//
// Replaces the Pallas kernel pangraph_tpu/ops/stripe_v2.py:_walk_kernel. The
// plain version, pangraph_tpu_torch/ops/stripe_v2.py:walk_plain, emits the
// same events and is what this kernel is held against.
//
// The walk starts at (rlen, qlen) and moves backward through the records
// written by csrc/stripe_dp.cu (rec[p][i-1][k], band lane k = q + ms + W - i,
// read as unsigned 16-bit: bits 0-5 origin, bits 6-15 the diagonal MATCH run
// ending at the cell). A MATCH move jumps the whole run at once, so the walk
// costs one record read per indel move and per 1023 matched rows, not one
// per row. Events go straight to rows/words[p][K]: a deletion run is one
// event at its lowest row, a match row followed by an insertion run is one.
// Events past K land in slot K-1 while the count keeps going, so
// n_events > K reports an overflow to the caller, which retries with a
// larger K.
//
// What bounds it: the chain of dependent global loads, each a miss to
// device memory (the records of a launch are far larger than L2), a few
// hundred cycles; the arithmetic between loads is a few dozen operations.
// What the design does about it:
// - One warp walks one problem, so no two walkers share a warp: walkers of
//   one warp start on different rows, diverge, and a warp issues diverged
//   paths' loads one after another. Every lane holds the same Walker and
//   takes the same moves (csrc/walk_step.cuh); the few stores are made by
//   all lanes at once to one address with one value.
// - Inside a gap run the next cells do not depend on what is read: an
//   insertion run (st == REF_GAP_MATRIX) moves along its row, q-1, q-2, ...
//   (band lanes k-1, k-2, ..., one contiguous 64-byte span), a deletion run
//   (st == QRY_GAP_MATRIX) down its diagonal column, rows i-1, i-2, ...
//   (band lanes k+1, k+2, ...). So lane j reads the run's j-th next cell,
//   all 32 loads in flight at once, and one ballot finds where the run
//   ends: the first cell that is 0 (the walk dies there) or lacks the
//   run's EXTEND bit (the run's last move), or, for a deletion, row 0
//   (the walk ends). The walker then takes that many moves in one step, as
//   that many walk_move calls would, with the BOUNDARY bit OR-ed over the
//   cells those moves read. A run of L cells costs ceil(L / 32) dependent
//   reads after its first cell instead of L.
// The Pallas kernel walked its records in VMEM chunks; here the walk reads
// device memory directly and keeps only the chunk edges (`seg` rows),
// because a match jump that stops at an edge lands on a cell whose BOUNDARY
// bit the walk reports. Gap moves are not bounded by the edges, in either.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_step.cuh"

namespace {

using namespace walkstep;

constexpr int WARPS_PER_BLOCK = 4;  // problems a block

// The rest of a gap run, from the walker's cell: up to 32 moves in one
// dependent read (see the header note). The walker is inside a run
// (w.st != 0, so w.dl == 0 in an insertion run and w.dl >= 1 in a deletion
// run, and neither emits an event until the run ends).
__device__ __forceinline__ void gap_run(Walker& w, const uint16_t* __restrict__ R, int B, int off, int lane)
{
    const bool del = w.st == QRY_GAP_MATRIX;
    const int k = w.q + off - w.i + (del ? lane : -lane);
    const int row = w.i - 1 - (del ? lane : 0);
    const int word = (row >= 0 && k >= 0 && k < B) ? (int)R[(long long)row * B + k] : 0;
    const int bits = word & 63;
    const unsigned ended = __ballot_sync(stripe::FULL, row < 0);  // a deletion that reaches row 0
    const unsigned died = __ballot_sync(stripe::FULL, row >= 0 && bits == 0);
    const unsigned last = __ballot_sync(stripe::FULL, bits != 0 && !(bits & (del ? QRY_GAP_EXTEND : REF_GAP_EXTEND)));
    const unsigned bnd = __ballot_sync(stripe::FULL, bits & BOUNDARY);
    const unsigned stop = ended | died | last;
    const int t = stop ? __ffs(stop) - 1 : 32;  // the first cell that ends the run
    const bool run_ends = t < 32 && ((last >> t) & 1u);
    const int n = t + (run_ends ? 1 : 0);       // moves taken: a cell that ends the run is read and taken
    if (bnd & (n >= 32 ? stripe::FULL : (1u << n) - 1u)) w.bnd = 1;
    if (del) {
        w.i -= n;
        w.dl += n;
    } else {
        w.q -= n;
        w.ins += n;
    }
    if (run_ends) w.st = 0;
    if (t < 32 && ((died >> t) & 1u)) {
        w.dead = 1;
        w.rr = 0;
    }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) walk_v2_kernel(
    const uint16_t* __restrict__ rec, long long rec_rows, int B,
    const int* __restrict__ rlen_a, const int* __restrict__ qlen_a,
    const int* __restrict__ ms_a, const int* __restrict__ W_a,
    int seg, int K, int* __restrict__ rows, int* __restrict__ words,
    int* __restrict__ nev, int* __restrict__ meta, int m)
{
    const int p = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    if (p >= m) return;  // the whole warp leaves together
    const uint16_t* R = rec + (long long)p * rec_rows * B;
    int* rows_p = rows + (long long)p * K;
    int* words_p = words + (long long)p * K;
    const int off = ms_a[p] + W_a[p];
    Walker w = walker(rlen_a[p], qlen_a[p]);
    while (w.i > 0 && !w.dead) {
        if (w.st != 0) {
            gap_run(w, R, B, off, lane);
        } else {
            const int k = w.q + off - w.i;
            const int word = (k >= 0 && k < B) ? (int)R[(long long)(w.i - 1) * B + k] : 0;
            // a match jump stops at the start of this row's segment
            walk_move(w, word, (w.i - 1) / seg * seg, K, rows_p, words_p);
        }
    }
    walk_finish(w, K, rows_p, words_p, nev + p, meta + 4 * (long long)p);
}

}  // namespace

extern "C" int walk_launch(
    const void* rec, long long rec_rows, int B, const void* rlen, const void* qlen,
    const void* ms, const void* W, int seg, int K, void* rows, void* words,
    void* nev, void* meta, int m, void* stream)
{
    if (m <= 0) return 0;
    if (seg < 1 || K < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (m + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    walk_v2_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(rec), rec_rows, B,
        static_cast<const int*>(rlen), static_cast<const int*>(qlen),
        static_cast<const int*>(ms), static_cast<const int*>(W), seg, K,
        static_cast<int*>(rows), static_cast<int*>(words),
        static_cast<int*>(nev), static_cast<int*>(meta), m);
    return (int)cudaGetLastError();
}
