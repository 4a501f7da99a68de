// Anchor-chain DP (minimap2's mm_chain_dp) for Hopper (sm_90a): one block
// of four warps per anchor set, a ragged batch of sets in one launch.
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
// tile to a fixed point, one chain hop per sweep. The card has one: the
// recurrence runs in order, one warp holding one predecessor a lane.
//
// What bounds it: the dependency from f[i-1] to f[i], times the longest
// set's anchors; the operations, about 30 a candidate, are far from the
// card's rate. What the design does about the chain, in the keyed loop that
// a set takes when H <= 32 and its scores fit the key (the wrapper decides,
// chain_k2.key_path):
// - One key a candidate carries f and the tie rule together. The part of
//   a candidate that does not depend on f, min(dr,dq,k) - gap, is packed
//   with the predecessor's distance h as pre = that * 32 + (31 - h) (INT_MIN
//   where the gates fail); with G[j] = 32 * (f[j] - k), key = G[j] + pre =
//   32 * (cand - k) + (31 - h), and one signed max over the predecessors
//   gives f[i] (cand - k in the high bits, counted only when it is at least
//   1) and the nearest-on-tie parent (31 - h in the low bits) together.
// - Producers and a consumer. Warps 1-3 compute the pre of every (anchor,
//   predecessor) pair, which needs only r and q, two chunks of CHUNK anchors
//   ahead, into a ring of chunks in shared memory. Warp 0 runs the
//   recurrence, on a scheduler of its own, and reads one pre a lane a step.
//   A barrier a chunk keeps them in step.
// - The window lives in registers, in slots: lane L holds G of the latest
//   anchor j = L mod 32 (pre is laid out by the same slots), so a step
//   writes one lane and shifts nothing.
// - The warp max leaves the serial path. The reduction for anchor i covers
//   only predecessors i-1-h with h >= LOOK-1, whose f is known LOOK steps
//   earlier, so it is issued then; the LOOK-1 nearest come in through
//   scalar adds and maxes. The serial path of a step is an add-max, an and
//   and a max (about 15 cycles) where the warp max alone takes about 45.
// On an H100 the consumer runs about 41 cycles a step, held by what it
// issues (the warp max occupies it about 12 cycles, and some 18 other
// instructions follow); the producers alone run about 33. A larger LOOK
// adds scalar terms and runs slower; a shuffle tree for the max, slower
// still.
// The key holds 32 * f in a signed int while k * n < 2^26 (f <= k * (i+1),
// since every candidate adds at most k) and the gap is never negative
// (k * bw < 2^31, so dd * k does not wrap). A set past that, or H > 32,
// takes the two-reduction loop, in warp 0 alone: per step, lane h
// evaluates predecessors i-1-h in rounds of 32 lanes, keeping the first
// best of its rounds; a warp max, then a warp min of h over the lanes that
// hold it, give f[i] and the parent; f of the last 1024 anchors is kept in
// a shared-memory ring.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RING = 1024;      // f of the last RING anchors (two-reduction loop); H <= RING
constexpr int LOOK = 4;         // steps from a warp max's issue to its use (keyed loop)
constexpr int CHUNK = 64;       // anchors a chunk of pre
constexpr int RING_CHUNKS = 4;  // chunks in shared memory: two read, one written
constexpr int NEAR = LOOK <= 5 ? 4 : 8;  // near pre kept an anchor (LOOK-1 used), in int4s
constexpr int PRODUCERS = 3;    // warps 1-3
constexpr int PRODUCE_GROUP = 8;  // steps a producer computes between its stores
constexpr int THREADS = 32 * (1 + PRODUCERS);
constexpr unsigned FULL = 0xffffffffu;

struct alignas(16) KeyRing {
    int pre[RING_CHUNKS][CHUNK][32];  // [chunk][anchor][slot]: INT_MIN for h < LOOK-1
    int near[RING_CHUNKS][CHUNK][NEAR];  // [chunk][anchor][h]: pre of h < LOOK-1
    int st_r[PRODUCERS][CHUNK + 32];  // a producer's anchors: the chunk's 32 predecessors, then the chunk
    int st_q[PRODUCERS][CHUNK + 32];
};
static_assert(LOOK - 1 <= NEAR && 32 % LOOK == 0, "near holds LOOK-1 values; a 32-anchor block holds whole LOOKs");

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

// The keyed loop's pre for predecessor (rj, qj) of anchor (ri, qi) at
// distance h: (min(dr,dq,k) - gap) * 32 + (31 - h), or INT_MIN where the
// gates fail. Below 32 * (k - 2^26) it is clamped, which changes no
// outcome, since 32 * f < 2^31 (see the header note). Branch-free, so that
// the producers' steps interleave.
__device__ __forceinline__ int key_pre(int ri, int qi, int rj, int qj, bool live, int k, int max_gap, int bw, int h)
{
    const int dr = ri - rj, dq = qi - qj;
    const int dd = abs(dr - dq);
    const bool ok = live && dr > 0 && dq > 0 && dr <= max_gap && dq <= max_gap && dd <= bw;
    const int alpha = min(max(min(dr, dq), 0), k);
    const int gap = (int)((unsigned)dd * (unsigned)k / 100u) + (ilog2_capped(dd) >> 1);  // dd * k < 2^31 where ok
    const int pre = max(alpha - gap, k - (1 << 26)) * 32 + (31 - h);
    return ok ? pre : INT_MIN;
}

__device__ __forceinline__ int load_or_0(const int* __restrict__ a, int i, int n) { return i < n ? __ldg(a + i) : 0; }

// A producer's share of chunk c: the pre of anchors c * CHUNK + t for
// t = w, w + PRODUCERS, ..., every slot. (pr, pq) hold the chunk's 32
// predecessors and (nr, nq) the chunk, loaded one chunk ahead.
__device__ __forceinline__ void produce(KeyRing& kr, int w, int c, const int* __restrict__ R,
                                        const int* __restrict__ Q, int n, int k, int max_gap, int bw, int H,
                                        int lane, int& pr, int& pq, int (&nr)[2], int (&nq)[2])
{
    int* st_r = kr.st_r[w];
    int* st_q = kr.st_q[w];
    st_r[lane] = pr;
    st_q[lane] = pq;
    for (int x = 0; x < 2; x++) {
        st_r[32 + 32 * x + lane] = nr[x];
        st_q[32 + 32 * x + lane] = nq[x];
    }
    pr = nr[1];
    pq = nq[1];
    for (int x = 0; x < 2; x++) {  // the next chunk, in flight during this one
        nr[x] = load_or_0(R, (c + 1) * CHUNK + 32 * x + lane, n);
        nq[x] = load_or_0(Q, (c + 1) * CHUNK + 32 * x + lane, n);
    }
    __syncwarp();
    int(*pre)[32] = kr.pre[c % RING_CHUNKS];
    int(*near)[NEAR] = kr.near[c % RING_CHUNKS];
    // PRODUCE_GROUP steps at a time, all read and computed before any is
    // stored, so that their chains interleave (a store to shared memory
    // would otherwise hold back the next step's loads)
    const int steps = (CHUNK - w + PRODUCERS - 1) / PRODUCERS;
    for (int m0 = 0; m0 < steps; m0 += PRODUCE_GROUP) {
        int v[PRODUCE_GROUP], hs[PRODUCE_GROUP], ts[PRODUCE_GROUP];
#pragma unroll
        for (int g = 0; g < PRODUCE_GROUP; g++) {
            const int t = min(w + PRODUCERS * (m0 + g), CHUNK - 1);  // past the chunk: its last step again
            const int i = c * CHUNK + t;
            const int h = (i - 1 - lane) & 31;  // slot `lane` holds predecessor j = i-1-h
            const bool live = i < n && h < H && h < i;
            v[g] = key_pre(st_r[32 + t], st_q[32 + t], st_r[31 + t - h], st_q[31 + t - h], live, k, max_gap, bw, h);
            hs[g] = h;
            ts[g] = t;
        }
#pragma unroll
        for (int g = 0; g < PRODUCE_GROUP; g++) {
            pre[ts[g]][lane] = hs[g] >= LOOK - 1 ? v[g] : INT_MIN;
            if (hs[g] < LOOK - 1) near[ts[g]][hs[g]] = v[g];
        }
    }
    __syncwarp();
}

__device__ __forceinline__ void load_near(int (&P)[NEAR], const int* row)
{
#pragma unroll
    for (int x = 0; x < NEAR / 4; x++) {
        const int4 v = reinterpret_cast<const int4*>(row)[x];
        P[4 * x] = v.x;
        P[4 * x + 1] = v.y;
        P[4 * x + 2] = v.z;
        P[4 * x + 3] = v.w;
    }
}

// The consumer's chunk c (warp 0): anchors s = c * CHUNK + t. Rq[x], Pq[x]
// are the warp max and the near pre of the anchor in queue slot x (s mod
// LOOK), Gr[x] is G of the anchor in slot x; Gs is the lane's window slot,
// bo the lane's anchor's best key in the current 32-anchor block.
__device__ __forceinline__ void consume(const KeyRing& kr, int c, int n, int k, int* __restrict__ f,
                                        int* __restrict__ parent, int lane, int (&Rq)[LOOK],
                                        int (&Pq)[LOOK][NEAR], int (&Gr)[LOOK], int& Gs, int& bo)
{
    const int(*pre)[32] = kr.pre[c % RING_CHUNKS];
    const int(*pre_next)[32] = kr.pre[(c + 1) % RING_CHUNKS];
    const int(*near)[NEAR] = kr.near[c % RING_CHUNKS];
    const int(*near_next)[NEAR] = kr.near[(c + 1) % RING_CHUNKS];
#pragma unroll
    for (int t = 0; t < CHUNK; t++) {
        const int x = t % LOOK;
        int b = Rq[x];
#pragma unroll
        for (int h = LOOK - 2; h >= 0; h--) b = max(b, Gr[(t + LOOK - 1 - h) % LOOK] + Pq[x][h]);
        const int G = max(b & ~31, 0);
        Gr[x] = G;
        if (lane == t % 32) {
            Gs = G;
            bo = b;
        }
        // anchor s + LOOK: the warp max over its predecessors up to s
        const int t2 = t + LOOK;
        const int p = t2 < CHUNK ? pre[t2][lane] : pre_next[t2 - CHUNK][lane];
        Rq[x] = __reduce_max_sync(FULL, Gs + p);
        load_near(Pq[x], t2 < CHUNK ? near[t2] : near_next[t2 - CHUNK]);
        if (t % 32 == 31) {
            const int i = c * CHUNK + t - 31 + lane;
            if (i < n) {
                f[i] = k + (max(bo & ~31, 0) >> 5);
                parent[i] = bo >= 32 ? i - 32 + (bo & 31) : -1;
            }
        }
    }
}

// The keyed loop over one set (the whole block; see the header note).
__device__ void chain_keyed(KeyRing& kr, const int* __restrict__ R, const int* __restrict__ Q, int n, int k,
                            int max_gap, int bw, int H, int* __restrict__ f, int* __restrict__ parent)
{
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chunks = (n + CHUNK - 1) / CHUNK;
    // consumer state (warp 0)
    int Rq[LOOK], Pq[LOOK][NEAR], Gr[LOOK], Gs = 0, bo = 0;
    // producer state (warps 1-3)
    int pr = 0, pq = 0, nr[2], nq[2];
    if (warp > 0) {
        for (int x = 0; x < 2; x++) {
            nr[x] = load_or_0(R, 32 * x + lane, n);
            nq[x] = load_or_0(Q, 32 * x + lane, n);
        }
        produce(kr, warp - 1, 0, R, Q, n, k, max_gap, bw, H, lane, pr, pq, nr, nq);
        produce(kr, warp - 1, 1, R, Q, n, k, max_gap, bw, H, lane, pr, pq, nr, nq);
    }
    for (int c = 0; c < chunks; c++) {
        __syncthreads();  // chunks c and c+1 written; chunk c-2 read for the last time
        if (warp == 0) {
            if (c == 0) {
                // anchors 0 .. LOOK-1 have no predecessor at h >= LOOK-1
#pragma unroll
                for (int x = 0; x < LOOK; x++) {
                    Rq[x] = INT_MIN;
                    load_near(Pq[x], kr.near[0][x]);
                    Gr[x] = 0;
                }
            }
            consume(kr, c, n, k, f, parent, lane, Rq, Pq, Gr, Gs, bo);
        } else if (c + 2 <= chunks) {
            produce(kr, warp - 1, c + 2, R, Q, n, k, max_gap, bw, H, lane, pr, pq, nr, nq);
        }
    }
}

__device__ void chain_two_reductions(const int* __restrict__ R, const int* __restrict__ Q, int n, int k, int max_gap,
                                     int bw, int H, int* __restrict__ f, int* __restrict__ parent, int* ring, int lane)
{
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
            if (lane <= (i & 31)) { f[first + lane] = my_f; parent[first + lane] = my_p; }
        }
        __syncwarp();
    }
}

__global__ void __launch_bounds__(THREADS) chain_kernel(
    const int* __restrict__ r, const int* __restrict__ q, const long long* __restrict__ offsets,
    const uint8_t* __restrict__ keyed, int k, int max_gap, int bw, int H, int* __restrict__ f,
    int* __restrict__ parent)
{
    __shared__ union {
        KeyRing keys;
        int ring[RING];
    } sm;
    const int s = blockIdx.x;
    const long long o = offsets[s];
    const int n = (int)(offsets[s + 1] - o);
    if (n == 0) return;
    if (keyed[s])
        chain_keyed(sm.keys, r + o, q + o, n, k, max_gap, bw, H, f + o, parent + o);
    else if (threadIdx.x < 32)
        chain_two_reductions(r + o, q + o, n, k, max_gap, bw, H, f + o, parent + o, sm.ring, threadIdx.x);
}

}  // namespace

// keyed: [n_sets] uint8, 1 where the set takes the keyed loop (the wrapper's
// chain_k2.key_path; it needs H <= 32, k >= 0, k * n < 2^26, k * bw < 2^31).
extern "C" int chain_launch(
    const void* r, const void* q, const void* offsets, const void* keyed, int n_sets, int k, int max_gap, int bw,
    int H, void* f, void* parent, void* stream)
{
    if (n_sets <= 0) return 0;
    if (H < 1 || H > RING) return (int)cudaErrorInvalidValue;
    chain_kernel<<<n_sets, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(r), static_cast<const int*>(q), static_cast<const long long*>(offsets),
        static_cast<const uint8_t*>(keyed), k, max_gap, bw, H, static_cast<int*>(f), static_cast<int*>(parent));
    return (int)cudaGetLastError();
}
