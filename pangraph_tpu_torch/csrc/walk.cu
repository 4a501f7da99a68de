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
//
// The same library holds the decode of the events (decode_events_kernel,
// below), which runs after the walk, or after the checkpoint walk, on the
// same stream.

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

// ---------------------------------------------------------------- decode
//
// The walk's events -> each problem's edit, packed for one copy to the
// host: what pangraph_tpu_torch/ops/stripe_v2.py:edit_from_events returns,
// and what decode_events_plain, its plain twin, computes for a launch. It
// replaces no Pallas kernel: the reference decodes on the host.
//
// Between two events the query runs beside the reference at a fixed offset,
// so a problem is a list of stretches of rows, each with its offset; the
// events are few, the rows many. One block takes one problem. Its threads
// take THREADS events at a time in forward order (walk slot n-1-e), check
// that each starts at or after the last one's end and ends within the
// reference (else the walk was faulty and the problem fails), and scan their
// offset changes and stretch lengths; then they stride over the rows of those
// stretches together, compare ref[i] with qry[i + offset], and compact the
// mismatches in row order with ballots. A first pass counts; the block then
// reserves its place in the launch's packed arrays with one atomic each,
// and a second pass writes. What bounds it: the bytes of ref and qry, read
// twice (the second time mostly from L2), and two block barriers per
// THREADS rows in the writing pass; about 5 bytes of output a row at most,
// against the DP's B * 2 bytes of records.

namespace decode {

using walkstep::OP_D;
using walkstep::OP_M;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HEAD = 8;  // stripe_v2.DECODE_HEAD
enum { FAILED = 0, OK = 1 };  // stripe_v2.DECODE_FAILED, DECODE_OK

struct Chunk {
    int next[THREADS];   // the first row past each event
    int start[THREADS];  // the first row of the stretch before it
    int off[THREADS];    // that stretch's query offset
    int incl[THREADS];   // inclusive sum of the stretch lengths
    int warp[WARPS];     // scan scratch
};

struct Pass {
    int subs, evs, off, bad;  // substitutions, events written, the query offset after the last event
};

// Inclusive sum over the block of one value a thread; `total` gets the sum
// of all. Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* warp, int& total)
{
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(stripe::FULL, v, d);
        if (lane >= d) v += t;
    }
    if (lane == 31) warp[wid] = v;
    __syncthreads();
    if (wid == 0) {
        int s = lane < WARPS ? warp[lane] : 0;
#pragma unroll
        for (int d = 1; d < WARPS; d <<= 1) {
            const int t = __shfl_up_sync(stripe::FULL, s, d);
            if (lane >= d) s += t;
        }
        if (lane < WARPS) warp[lane] = s;
    }
    __syncthreads();
    if (wid > 0) v += warp[wid - 1];
    total = warp[WARPS - 1];
    __syncthreads();  // warp[] is free again
    return v;
}

// One pass over a problem's events (n >= 0) and the rows between them. With
// WRITE it writes the substitutions and events from sub_pos/sub_alt/evs on
// (the block's reserved place); without, it counts. Block-uniform result.
template <bool WRITE>
__device__ Pass decode_pass(Chunk& c, const int* __restrict__ rows, const int* __restrict__ words, int n,
                            int rlen, int qlen, int q0, const uint8_t* __restrict__ ref,
                            const uint8_t* __restrict__ qry, int* __restrict__ sub_pos,
                            uint8_t* __restrict__ sub_alt, int4* __restrict__ evs)
{
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    Pass r{0, 0, q0, 0};
    int cur = 0;  // the first row past the events taken so far
    for (int base = 0; base <= n; base += THREADS) {
        const int e = base + tid;
        const bool event = e < n;  // e == n: the stretch after the last event
        int x = rlen, dl = 0, ins = 0, end = rlen, nxt = rlen;
        bool bad = false, is_d = false;
        if (event) {
            x = rows[n - 1 - e];
            const int w = words[n - 1 - e];
            is_d = (w & 3) == (int)OP_D;
            ins = (w >> 2) & 0x7FFF;
            if (is_d) {
                dl = w >> 17;
                bad = dl < 1 || x > rlen - dl;
                end = x;
                nxt = x + dl;
            } else {
                bad = (w & 3) != (int)OP_M || x > rlen - 1;
                end = nxt = x + 1;
            }
            if (bad) end = nxt = rlen;
        }
        c.next[tid] = nxt;
        __syncthreads();
        const int start = tid == 0 ? cur : c.next[tid - 1];
        if (__syncthreads_or(bad || (event && x < start))) {
            r.bad = 1;
            return r;
        }
        const int delta = event ? ins - dl : 0;
        int sum_delta, total_len, n_emit;
        const int off_e = r.off + block_scan(delta, c.warp, sum_delta) - delta;  // before event e
        const int incl = block_scan(end - start, c.warp, total_len);
        const bool emit = event && (is_d || ins > 0);
        const int rank = block_scan(emit ? 1 : 0, c.warp, n_emit) - (emit ? 1 : 0);
        if (WRITE && emit) evs[r.evs + rank] = make_int4(x, dl, (is_d ? x : x + 1) + off_e, ins);
        c.start[tid] = start;
        c.off[tid] = off_e;
        c.incl[tid] = incl;
        cur = c.next[min(n - base, THREADS - 1)];
        __syncthreads();
        for (int f0 = 0; f0 < total_len; f0 += THREADS) {
            const int f = f0 + tid;
            bool mis = false;
            int i = 0, q = 0;
            if (f < total_len) {
                int lo = 0, hi = THREADS - 1;  // the stretch holding flat row f
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (c.incl[mid] > f) hi = mid;
                    else lo = mid + 1;
                }
                i = c.start[lo] + f - (lo ? c.incl[lo - 1] : 0);
                q = i + c.off[lo];
                mis = q >= 0 && q < qlen && ref[i] != qry[q];
            }
            if (WRITE) {
                const unsigned b = __ballot_sync(stripe::FULL, mis);
                if (lane == 0) c.warp[wid] = __popc(b);
                __syncthreads();
                int before = 0, all = 0;
#pragma unroll
                for (int k = 0; k < WARPS; ++k) {
                    before += k < wid ? c.warp[k] : 0;
                    all += c.warp[k];
                }
                if (mis) {
                    const int at = r.subs + before + __popc(b & ((1u << lane) - 1u));
                    sub_pos[at] = i;
                    sub_alt[at] = qry[q];
                }
                r.subs += all;
                __syncthreads();
            } else {
                r.subs += __syncthreads_count(mis);
            }
        }
        r.off += sum_delta;
        r.evs += n_emit;
    }
    return r;
}

__global__ void __launch_bounds__(THREADS) decode_events_kernel(
    const int* __restrict__ rows, const int* __restrict__ words, const int* __restrict__ nev,
    const int* __restrict__ meta, int K, const uint8_t* __restrict__ ref, long long ref_stride,
    const uint8_t* __restrict__ qry, long long qry_stride, const int* __restrict__ rlen_a,
    const int* __restrict__ qlen_a, int* __restrict__ head, int* __restrict__ totals,
    int* __restrict__ sub_pos, uint8_t* __restrict__ sub_alt, int4* __restrict__ evs)
{
    __shared__ Chunk c;
    __shared__ int at[2];
    const long long p = blockIdx.x;
    const int* mp = meta + 4 * p;
    const int n = nev[p], q0 = mp[0] + mp[3];
    const int rlen = rlen_a[p], qlen = qlen_a[p];
    const int* rows_p = rows + p * K;
    const int* words_p = words + p * K;
    const uint8_t* ref_p = ref + p * ref_stride;
    const uint8_t* qry_p = qry + p * qry_stride;
    // a dead walk, an overflow, or a negative count or lead (a faulty walk)
    // fails before any event is read
    int status = FAILED;
    Pass r{0, 0, 0, 0};
    if (mp[1] == 0 && n <= K && n >= 0 && q0 >= 0) {
        r = decode_pass<false>(c, rows_p, words_p, n, rlen, qlen, q0, ref_p, qry_p, nullptr, nullptr, nullptr);
        status = !r.bad && rlen + r.off == qlen ? OK : FAILED;
    }
    const bool ok = status == OK;
    if (threadIdx.x == 0) {
        at[0] = ok ? atomicAdd(totals, r.subs) : 0;
        at[1] = ok ? atomicAdd(totals + 1, r.evs) : 0;
        int* h = head + HEAD * p;
        h[0] = status;
        h[1] = mp[2];
        h[2] = n;
        h[3] = q0;
        h[4] = at[0];
        h[5] = ok ? r.subs : 0;
        h[6] = at[1];
        h[7] = ok ? r.evs : 0;
    }
    if (!ok) return;  // the whole block leaves together
    __syncthreads();
    decode_pass<true>(c, rows_p, words_p, n, rlen, qlen, q0, ref_p, qry_p, sub_pos + at[0], sub_alt + at[0],
                      evs + at[1]);
}

}  // namespace decode

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

extern "C" int decode_events_launch(
    const void* rows, const void* words, const void* nev, const void* meta, int K,
    const void* ref, long long ref_stride, const void* qry, long long qry_stride,
    const void* rlen, const void* qlen, void* head, void* totals, void* sub_pos,
    void* sub_alt, void* evs, int m, void* stream)
{
    if (m <= 0) return 0;
    if (K < 1) return (int)cudaErrorInvalidValue;
    decode::decode_events_kernel<<<m, decode::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rows), static_cast<const int*>(words), static_cast<const int*>(nev),
        static_cast<const int*>(meta), K, static_cast<const uint8_t*>(ref), ref_stride,
        static_cast<const uint8_t*>(qry), qry_stride, static_cast<const int*>(rlen),
        static_cast<const int*>(qlen), static_cast<int*>(head), static_cast<int*>(totals),
        static_cast<int*>(sub_pos), static_cast<uint8_t*>(sub_alt), static_cast<int4*>(evs));
    return (int)cudaGetLastError();
}
