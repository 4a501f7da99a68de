// Run-jump traceback over the stripe DP's records, for Hopper (sm_90a): one
// thread per problem.
//
// Replaces the Pallas kernel pangraph_tpu/ops/stripe_v2.py:_walk_kernel. The
// plain version, pangraph_tpu_torch/ops/stripe_v2.py:walk_plain, emits the
// same events and is what this kernel is held against.
//
// The walk starts at (rlen, qlen) and moves backward through the records
// written by csrc/stripe_dp.cu (rec[p][i-1][k], band lane k = q + ms + W - i,
// read as unsigned 16-bit: bits 0-5 origin, bits 6-15 the diagonal MATCH run
// ending at the cell). A MATCH move jumps the whole run at once, so the walk
// costs one record read per indel event and per 1023 matched rows, not one
// per row. Events go straight to rows/words[p][K]: a deletion run is one
// event at its lowest row, a match row followed by an insertion run is one.
// Events past K land in slot K-1 while the count keeps going, so
// n_events > K reports an overflow to the caller, which retries with a
// larger K.
//
// What bounds it: the chain of dependent global loads, one per event, each a
// cache miss of a few hundred cycles; the arithmetic between loads is a few
// dozen operations. What the design does about it: nothing is staged, since
// a walk touches a handful of cells scattered over its problem's records;
// instead every problem walks at once on its own thread, so the card keeps
// as many loads in flight as there are problems. The Pallas kernel walked its
// records in VMEM chunks; here the walk reads device memory directly and
// keeps only the chunk edges (`seg` rows), because a jump that stops at an
// edge lands on a cell whose BOUNDARY bit the walk reports.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_step.cuh"

namespace {

using namespace walkstep;

__global__ void walk_kernel(
    const uint16_t* __restrict__ rec, long long rec_rows, int B,
    const int* __restrict__ rlen_a, const int* __restrict__ qlen_a,
    const int* __restrict__ ms_a, const int* __restrict__ W_a,
    int seg, int K, int* __restrict__ rows, int* __restrict__ words,
    int* __restrict__ nev, int* __restrict__ meta, int m)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= m) return;
    const uint16_t* R = rec + (long long)p * rec_rows * B;
    int* rows_p = rows + (long long)p * K;
    int* words_p = words + (long long)p * K;
    const int off = ms_a[p] + W_a[p];
    Walker w = walker(rlen_a[p], qlen_a[p]);
    while (w.i > 0 && !w.dead) {
        const int k = w.q + off - w.i;
        const int word = (k >= 0 && k < B) ? (int)R[(long long)(w.i - 1) * B + k] : 0;
        // a match jump stops at the start of this row's segment
        walk_move(w, word, (w.i - 1) / seg * seg, K, rows_p, words_p);
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
    const int threads = 128;
    const int blocks = (m + threads - 1) / threads;
    walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(rec), rec_rows, B,
        static_cast<const int*>(rlen), static_cast<const int*>(qlen),
        static_cast<const int*>(ms), static_cast<const int*>(W), seg, K,
        static_cast<int*>(rows), static_cast<int*>(words),
        static_cast<int*>(nev), static_cast<int*>(meta), m);
    return (int)cudaGetLastError();
}
