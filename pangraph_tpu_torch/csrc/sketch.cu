// Minimizer sketch, dense per window start, for Hopper (sm_90a): one fused
// launch, one block per (row, tile of window starts).
//
// Replaces the Pallas kernel pangraph_tpu/ops/sketch_k1.py:_sketch_kernel.
// The plain version, pangraph_tpu_torch/ops/sketch_k1.py:sketch_dense_plain,
// gives the same output and is what this kernel is held against.
//
// For window start c of a row: the minimum, by unsigned compare and leftmost
// on ties, over k-mer positions p in [c, c + w) of the canonical hash of the
// k-mer at p (Jenkins' mix under the 2k-bit mask; the sentinel ~0 where a
// code is invalid or the k-mer is its own reverse complement), written as
// val[row][c] (the uint64 bits) and ps[row][c] = p << 1 | strand. An invalid
// code (4 and up) enters the k-mer codes as 0, so the strand bit of a
// sentinel window is computed from the substituted codes, as the reference
// computes it.
//
// What bounds it: per window start 4 bytes of codes read and 12 written
// (the bytes bind), and about 65 integer operations per k-mer position at
// k > 16 (37 at k <= 16, where the arithmetic fits 32-bit words). The
// design keeps every position's work O(1):
// - a block takes a tile of NP = 2048 positions (NP - w + 1 window starts,
//   rounded down to a multiple of 16), so the halo of w - 1 positions and
//   k - 1 codes is a few percent (5% at w = 100); 128 threads a block, 8
//   blocks an SM (dev/sketch_ab_cuda.py times other layouts); the tile's
//   codes come in once, in 16-byte loads (codes, val and ps must be 16-byte
//   aligned), and go to
//   shared memory as three packed streams of 16 codes a word: the forward
//   2-bit codes, first code highest (F); their complements, first code
//   lowest (G, a bit reverse of ~F with its pairs swapped); and a bit a
//   code that marks it invalid (I);
// - each thread takes a run of R = 16 consecutive positions and cuts each
//   position's k-mer codes out of three words of each stream with funnel
//   shifts, by amounts known at compile time but for the final align to 2k
//   bits: O(1) a position whatever k, with no serial chain between
//   positions; at k <= 16 the codes, the canonical pick and the mix run in
//   32-bit words, which is exact (every right shift in the mix acts on a
//   value already masked to 2k <= 32 bits, and the low 32 bits of an add,
//   multiply or not depend only on the low 32 bits of its operands); the
//   mix's shift-adds are multiplies by constants;
// - the window minimum is van Herk / Gil-Werman's: the positions are cut
//   into blocks of w, each position gets the suffix minimum S and the prefix
//   minimum P of its block, and window c is min(S[c], P[c + w - 1]). Each
//   thread scans its run in registers; the runs' carries cross threads by a
//   segmented warp scan (shuffles) and the warps' totals in shared memory;
// - a key orders by value, then by position, so every minimum is leftmost on
//   ties without a separate pick: at k <= 23 one 64-bit word, the value
//   above the local (position << 1 | strand) in 16 bits, with the sentinel's
//   value field all ones (no 46-bit hash reaches it); at k >= 24 a (value,
//   position) pair;
// - P goes to shared memory (padded one key in 16, so that runs of 16 keys
//   fall on distinct banks), the windows' results replace it there, and the
//   block writes val and ps out coalesced, four window starts a thread in
//   16-byte stores.
//
// Build flags for dev/sketch_ab_cuda.py's variants (none in the port's
// build): SKETCH_THREADS, SKETCH_MIN_BLOCKS and SKETCH_PAIR_MIN_BLOCKS set
// the layout; SKETCH_PAIR_KEY takes the (value, position) pair at every k
// (dev/sketch_ab_cuda.py found it 2.6-2.9x slower at k 15 and 19, hence the
// packed key where it fits);
// SKETCH_PROBE=1 writes the codes out with no hash and no minimum (loads
// and stores alone), 2 the hashes with no minimum, 3 the whole kernel
// without the mix. A probe's outputs are wrong by design.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

#ifndef SKETCH_THREADS
#define SKETCH_THREADS 128
#endif
#ifndef SKETCH_MIN_BLOCKS
#define SKETCH_MIN_BLOCKS 8
#endif
#ifndef SKETCH_PAIR_MIN_BLOCKS
#define SKETCH_PAIR_MIN_BLOCKS 2
#endif
#ifndef SKETCH_PROBE
#define SKETCH_PROBE 0
#endif

constexpr int C = 512;        // the wrapper's chunk: L_pad is a multiple of C
constexpr int R = 16;         // positions a thread
constexpr int THREADS = SKETCH_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int NP = R * THREADS;  // positions a block
constexpr int NKEYS = NP + NP / R;  // one pad key a run
constexpr int NW = NP / 16 + 2;     // stream words: a run reads codes [p0, p0 + R + k - 1), 3 words
constexpr int MIN_BLOCKS = SKETCH_MIN_BLOCKS;  // blocks an SM holds with packed keys (the registers a thread may take)
constexpr int PAIR_MIN_BLOCKS = SKETCH_PAIR_MIN_BLOCKS;  // the same with pair keys

// k <= 23: value << 16 | local (position << 1 | strand); the sentinel's
// value field is all ones
struct PackedKey {
    uint64_t x;
    static __device__ __forceinline__ PackedKey make(uint64_t h, uint32_t lo) { return {h << 16 | lo}; }
    static __device__ __forceinline__ PackedKey sentinel(uint32_t lo) { return {0xFFFFFFFFFFFF0000ull | lo}; }
    static __device__ __forceinline__ PackedKey identity() { return {~0ull}; }
    __device__ __forceinline__ bool less(const PackedKey& o) const { return x < o.x; }
    // a valid key's top bit is 0 (its value has at most 46 bits); the
    // sentinel's arithmetic shift is ~0
    __device__ __forceinline__ uint64_t value() const { return (uint64_t)((long long)x >> 16); }
    __device__ __forceinline__ uint32_t lo() const { return (uint32_t)x & 0xFFFF; }
    __device__ __forceinline__ PackedKey shfl_up(int d) const { return {__shfl_up_sync(~0u, x, d)}; }
    __device__ __forceinline__ PackedKey shfl_down(int d) const { return {__shfl_down_sync(~0u, x, d)}; }
};

// k >= 24: (value, local position << 1 | strand)
struct WideKey {
    uint64_t v;
    uint32_t l;
    static __device__ __forceinline__ WideKey make(uint64_t h, uint32_t lo) { return {h, lo}; }
    static __device__ __forceinline__ WideKey sentinel(uint32_t lo) { return {~0ull, lo}; }
    static __device__ __forceinline__ WideKey identity() { return {~0ull, ~0u}; }
    __device__ __forceinline__ bool less(const WideKey& o) const { return v < o.v || (v == o.v && l < o.l); }
    __device__ __forceinline__ uint64_t value() const { return v; }
    __device__ __forceinline__ uint32_t lo() const { return l; }
    __device__ __forceinline__ WideKey shfl_up(int d) const {
        return {__shfl_up_sync(~0u, v, d), __shfl_up_sync(~0u, l, d)};
    }
    __device__ __forceinline__ WideKey shfl_down(int d) const {
        return {__shfl_down_sync(~0u, v, d), __shfl_down_sync(~0u, l, d)};
    }
};

template <class K>
__device__ __forceinline__ K kmin(const K& a, const K& b) { return b.less(a) ? b : a; }

template <typename U>
__device__ __forceinline__ U jenkins(U x, U m)
{
    x = (x * (U)0x1FFFFF - 1) & m;  // ~x + (x << 21)
    x = x ^ (x >> 24);
    x = (x * 265) & m;  // x + (x << 3) + (x << 8)
    x = x ^ (x >> 14);
    x = (x * 21) & m;  // x + (x << 2) + (x << 4)
    x = x ^ (x >> 28);
    return (x * (U)0x80000001u) & m;  // x + (x << 31)
}

// k-mer codes of the run's position i from the streams' words 0-2 (see the
// header), aligned to 2k bits; U of 32 bits at k <= 16. Inside the callers'
// unrolled loops every shift but the align is a constant.
template <typename U>
__device__ __forceinline__ void kmer(const uint32_t (&f)[3], const uint32_t (&g)[3], int i, int k, U mask, U& fw,
                                     U& rv)
{
    if constexpr (sizeof(U) == 4) {
        fw = __funnelshift_l(f[1], f[0], 2 * i) >> (32 - 2 * k);
        rv = __funnelshift_r(g[0], g[1], 2 * i) & mask;
    } else {  // k >= 17: 64 - 2k < 32, and the mask's low word is all ones
        const uint32_t hi = __funnelshift_l(f[1], f[0], 2 * i), lo = __funnelshift_l(f[2], f[1], 2 * i);
        const int s = 64 - 2 * k;
        fw = (U)(hi >> s) << 32 | __funnelshift_r(lo, hi, s);
        rv = (U)(__funnelshift_r(g[1], g[2], 2 * i) & (uint32_t)(mask >> 32)) << 32
             | __funnelshift_r(g[0], g[1], 2 * i);
    }
}

// A segment of a scan: the minimum since the segment's last reset, and
// whether a reset lies in it.
template <class K>
struct Seg {
    K a;
    bool f;
};

// `e` comes earlier in scan order than `l`
template <class K>
__device__ __forceinline__ Seg<K> combine(const Seg<K>& e, const Seg<K>& l)
{
    return l.f ? l : Seg<K>{kmin(e.a, l.a), e.f};
}

// The segmented exclusive scan of the threads' run totals, in thread order
// (REV false) or against it (REV true): what thread t's first segment in
// scan order inherits from the threads before it.
template <bool REV, class K>
__device__ __forceinline__ K carry_in(Seg<K> x, Seg<K>* wtot)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Seg<K> o = {REV ? x.a.shfl_down(d) : x.a.shfl_up(d),
                          (bool)(REV ? __shfl_down_sync(~0u, (int)x.f, d) : __shfl_up_sync(~0u, (int)x.f, d))};
        if (REV ? lane + d < 32 : lane >= d) x = combine(o, x);
    }
    Seg<K> ex = {REV ? x.a.shfl_down(1) : x.a.shfl_up(1),
                 (bool)(REV ? __shfl_down_sync(~0u, (int)x.f, 1) : __shfl_up_sync(~0u, (int)x.f, 1))};
    if (lane == (REV ? 31 : 0)) ex = Seg<K>{K::identity(), false};
    if (lane == (REV ? 0 : 31)) wtot[warp] = x;
    __syncthreads();
    Seg<K> acc = {K::identity(), false};  // the warps before, nearest first, up to one with a reset
    for (int j = REV ? warp + 1 : warp - 1; !acc.f && (REV ? j < WARPS : j >= 0); j += REV ? 1 : -1)
        acc = combine(wtot[j], acc);
    return combine(acc, ex).a;
}

// U: the word of the k-mer codes and the mix (uint32_t at k <= 16)
template <typename U, class K>
__global__ void __launch_bounds__(THREADS, sizeof(K) == 8 ? MIN_BLOCKS : PAIR_MIN_BLOCKS) sketch_kernel(
    const int* __restrict__ codes, long long L_pad, int k, int w, U mask, int wt,
    long long* __restrict__ val, int* __restrict__ ps)
{
    extern __shared__ __align__(16) uint8_t smem[];
    K* keys = reinterpret_cast<K*>(smem);
    uint32_t* F = reinterpret_cast<uint32_t*>(keys + NKEYS);
    uint32_t* G = F + NW;
    uint16_t* I = reinterpret_cast<uint16_t*>(G + NW);
    __shared__ Seg<K> wtot[2][WARPS];

    const int tid = threadIdx.x;
    const long long L_out = L_pad - C;
    const int p0 = tid * R;
    const uint32_t kbits = k == 32 ? ~0u : (1u << k) - 1;
    U m = mask;  // the same mask, its low word known to the compiler at k >= 17
    if constexpr (sizeof(U) == 8) m = (U)(uint32_t)(mask >> 32) << 32 | 0xFFFFFFFFu;

    // w-blocks start where a tile's position is a multiple of w: bit i of
    // `starts` (`ends`) is set where the run's position i starts (ends) one
    uint32_t starts = 0;
    for (int i = (w - p0 % w) % w; i < R; i += w) starts |= 1u << i;
    const uint32_t ends = starts >> 1 | (uint32_t)((p0 + R) % w == 0) << (R - 1);
    const int first_start = starts ? __ffs(starts) - 1 : R, last_end = ends ? 31 - __clz(ends) : -1;

    const long long row = blockIdx.y;
    const long long c0 = (long long)blockIdx.x * wt;
    const int nwin = (int)min((long long)wt, L_out - c0);
    const int* crow = codes + row * L_pad;

    // codes [c0 + 16 j, c0 + 16 j + 16) to the streams' word j; 4 and up,
    // and codes past the row, are invalid and enter the k-mers as 0
    for (int j = tid; j < NW; j += THREADS) {
        const long long g = c0 + 16LL * j;  // a multiple of 16, as L_pad is
        uint32_t f = 0, inv = 0xFFFF;
        if (g < L_pad) {
            inv = 0;
#pragma unroll
            for (int u = 0; u < 4; u++) {
                const int4 q = __ldg(reinterpret_cast<const int4*>(crow + g + 4 * u));
                const uint32_t B = min((uint32_t)q.x, 4u) | min((uint32_t)q.y, 4u) << 8
                                   | min((uint32_t)q.z, 4u) << 16 | min((uint32_t)q.w, 4u) << 24;  // a byte a code
                f = f << 8 | ((B & 0x03030303u) * 0x40100401u) >> 24;             // 4 codes, first highest
                inv |= (((B >> 2) & 0x01010101u) * 0x01020408u) >> 24 << (4 * u);  // a bit a code, first lowest
            }
        }
        const uint32_t rb = __brev(~f);  // complements, first lowest, each code's two bits swapped
        F[j] = f;
        G[j] = ((rb >> 1) & 0x55555555u) | ((rb & 0x55555555u) << 1);
        I[j] = (uint16_t)inv;
    }
    __syncthreads();

    // key[i] is position p0 + i's
    const uint32_t f[3] = {F[tid], F[tid + 1], F[tid + 2]};
    const uint32_t g[3] = {G[tid], G[tid + 1], G[tid + 2]};
    const uint32_t z0 = I[tid] | (uint32_t)I[tid + 1] << 16, z1 = I[tid + 2];
    K key[R];
#pragma unroll
    for (int i = 0; i < R; i++) {
#if SKETCH_PROBE == 1
        key[i] = K::sentinel(__funnelshift_r(f[0], f[1], i) & 0xFFFF);
#else
        U fw, rv;
        kmer<U>(f, g, i, k, mask, fw, rv);
        const bool is_rev = rv < fw;
        const bool ok = (__funnelshift_r(z0, z1, i) & kbits) == 0;
        const uint32_t lo = (uint32_t)(p0 + i) << 1 | (uint32_t)is_rev;
#if SKETCH_PROBE == 3
        const U h = is_rev ? rv : fw;
#else
        const U h = jenkins<U>(is_rev ? rv : fw, m);
#endif
        key[i] = (ok && rv != fw) ? K::make((uint64_t)h, lo) : K::sentinel(lo);
#endif
    }
    K* mine = keys + p0 + tid;  // this run's keys, padded (see keys[j + j / R] below)

#if SKETCH_PROBE == 1 || SKETCH_PROBE == 2
#pragma unroll
    for (int i = 0; i < R; i++) mine[i] = key[i];
    (void)first_start;
    (void)last_end;
    (void)wtot;
#else
    // prefix minima (reset at a block start), straight to shared memory;
    // the run's first segment takes the carry from the threads before
    K pr = key[0];
#pragma unroll
    for (int i = 0; i < R; i++) {
        if (i > 0) pr = starts >> i & 1 ? key[i] : kmin(pr, key[i]);
        mine[i] = pr;
    }
    const K pin = carry_in<false, K>(Seg<K>{pr, first_start < R}, wtot[0]);
    for (int i = 0; i < first_start; i++) mine[i] = kmin(pin, mine[i]);

    // suffix minima (reset after a block end), in key
#pragma unroll
    for (int i = R - 2; i >= 0; i--) {
        if (!(ends >> i & 1)) key[i] = kmin(key[i + 1], key[i]);
    }
    const K sin = carry_in<true, K>(Seg<K>{key[0], last_end >= 0}, wtot[1]);
#pragma unroll
    for (int i = 0; i < R; i++) {
        if (i > last_end) key[i] = kmin(sin, key[i]);
    }
    __syncthreads();  // every P is in shared memory

    // window c = p0 + i: min(S[c], P[c + w - 1]), then the results replace P
#pragma unroll
    for (int i = 0; i < R; i++) {
        const int q = p0 + i + w - 1;
        if (p0 + i < nwin) key[i] = kmin(key[i], keys[q + q / R]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; i++) {
        if (p0 + i < nwin) mine[i] = key[i];
    }
#endif
    __syncthreads();

    // four window starts a thread in 16-byte stores (nwin, c0 and L_out
    // are multiples of 16)
    long long* vrow = val + row * L_out + c0;
    int* prow = ps + row * L_out + c0;
    const uint32_t ps0 = (uint32_t)c0 << 1;  // int32 bits, as the reference's
    for (int j = 4 * tid; j < nwin; j += 4 * THREADS) {
        K x[4];
#pragma unroll
        for (int q = 0; q < 4; q++) x[q] = keys[j + q + (j + q) / R];
        longlong2* v = reinterpret_cast<longlong2*>(vrow + j);
        v[0] = make_longlong2((long long)x[0].value(), (long long)x[1].value());
        v[1] = make_longlong2((long long)x[2].value(), (long long)x[3].value());
        *reinterpret_cast<int4*>(prow + j) = make_int4((int)(ps0 + x[0].lo()), (int)(ps0 + x[1].lo()),
                                                       (int)(ps0 + x[2].lo()), (int)(ps0 + x[3].lo()));
    }
}

template <typename U, class K>
int launch(const void* codes, long long L_pad, int m, int k, int w, U mask, void* val, void* ps, cudaStream_t stream)
{
    const size_t shm = sizeof(K) * NKEYS + 10 * NW;
    cudaError_t e = cudaFuncSetAttribute(sketch_kernel<U, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return (int)e;
    if ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(val) | reinterpret_cast<uintptr_t>(ps)) & 15)
        return (int)cudaErrorInvalidValue;
    const int wt = (NP - (w - 1)) & ~15;  // window starts a block, a multiple of 16 for the streams' words
    const dim3 grid((unsigned)((L_pad - C + wt - 1) / wt), (unsigned)m);
    sketch_kernel<U, K><<<grid, THREADS, shm, stream>>>(
        static_cast<const int*>(codes), L_pad, k, w, mask, wt,
        static_cast<long long*>(val), static_cast<int*>(ps));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sketch_launch(
    const void* codes, long long L_pad, int m, int k, int w, void* val, void* ps, void* stream)
{
    if (m <= 0) return 0;
    if (k < 1 || k > 32 || w < 1 || L_pad % C || L_pad < 2 * C || C + w - 1 + k - 1 > 2 * C || m > 65535)
        return (int)cudaErrorInvalidValue;
    const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef SKETCH_PAIR_KEY
    if (k <= 16) return launch<uint32_t, WideKey>(codes, L_pad, m, k, w, (uint32_t)mask, val, ps, s);
#else
    if (k <= 16) return launch<uint32_t, PackedKey>(codes, L_pad, m, k, w, (uint32_t)mask, val, ps, s);
    if (k <= 23) return launch<uint64_t, PackedKey>(codes, L_pad, m, k, w, mask, val, ps, s);
#endif
    return launch<uint64_t, WideKey>(codes, L_pad, m, k, w, mask, val, ps, s);
}
