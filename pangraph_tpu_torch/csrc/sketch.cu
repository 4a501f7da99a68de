// Minimizer sketch, dense per window start, for Hopper (sm_90a): one block
// per (row, chunk of C = 512 window starts).
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
// The reference emulates uint64 with int32 (hi, lo) pairs, builds shifted
// views with lane rotates and takes the window minimum by offset doubling,
// all forced by Mosaic. Here: native uint64. The block stages its chunk's
// codes with the w + k - 2 halo in shared memory, each thread hashes
// positions into shared memory, then each thread scans its window's w
// entries left to right with a strict less-than.
//
// What bounds it: the window scan, w compares of 64-bit values per window
// start (100 at the mash parameters), against about 90 integer operations
// per position for the codes and the hash, and 16 bytes moved per window
// start. It is bound by operations, most of them the scan. A van Herk /
// Gil-Werman minimum (a prefix and a suffix running minimum per w-block,
// three compares per position whatever w) is the later fix; the k-mer codes
// could also roll instead of being rebuilt from k codes per position.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int C = 512;  // window starts per block
constexpr int THREADS = 256;

__device__ __forceinline__ uint64_t jenkins(uint64_t x, uint64_t m)
{
    x = (~x + (x << 21)) & m;
    x = x ^ (x >> 24);
    x = (x + (x << 3) + (x << 8)) & m;
    x = x ^ (x >> 14);
    x = (x + (x << 2) + (x << 4)) & m;
    x = x ^ (x >> 28);
    return (x + (x << 31)) & m;
}

__global__ void __launch_bounds__(THREADS) sketch_kernel(
    const int* __restrict__ codes, long long L_pad, int k, int w, uint64_t mask,
    long long* __restrict__ val, int* __restrict__ ps)
{
    // positions [0, C + w - 1) and their codes [0, C + w + k - 2) fit 2C by
    // the wrapper's halo check
    __shared__ uint8_t sc[2 * C];
    __shared__ uint64_t sh[2 * C];
    __shared__ uint32_t sp[2 * C];

    const long long c0 = (long long)blockIdx.x * C;
    const long long row = blockIdx.y;
    const long long L_out = L_pad - C;
    const int* crow = codes + row * L_pad + c0;
    const int npos = C + w - 1;
    const int ncode = npos + k - 1;

    for (int t = threadIdx.x; t < ncode; t += THREADS) {
        const int c = crow[t];
        sc[t] = c < 4 ? (uint8_t)c : (uint8_t)4;
    }
    __syncthreads();

    for (int p = threadIdx.x; p < npos; p += THREADS) {
        uint64_t fw = 0, rv = 0;
        bool ok = true;
        for (int j = 0; j < k; j++) {
            const uint32_t c = sc[p + j];
            const uint64_t b = c < 4 ? c : 0;
            ok &= c < 4;
            fw = (fw << 2) | b;
            rv |= (3ull ^ b) << (2 * j);
        }
        const bool is_rev = rv < fw;
        sh[p] = (ok && rv != fw) ? jenkins(is_rev ? rv : fw, mask) : ~0ull;
        sp[p] = ((uint32_t)(c0 + p) << 1) | (uint32_t)is_rev;  // int32 bits, as the reference's
    }
    __syncthreads();

    for (int t = threadIdx.x; t < C; t += THREADS) {
        uint64_t best = sh[t];
        uint32_t bp = sp[t];
        for (int d = 1; d < w; d++) {
            const uint64_t v = sh[t + d];
            if (v < best) { best = v; bp = sp[t + d]; }
        }
        val[row * L_out + c0 + t] = (long long)best;
        ps[row * L_out + c0 + t] = (int)bp;
    }
}

}  // namespace

extern "C" int sketch_launch(
    const void* codes, long long L_pad, int m, int k, int w, void* val, void* ps, void* stream)
{
    if (m <= 0) return 0;
    if (k < 1 || k > 32 || w < 1 || L_pad % C || L_pad < 2 * C || C + w - 1 + k - 1 > 2 * C || m > 65535)
        return (int)cudaErrorInvalidValue;
    const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const dim3 grid((unsigned)(L_pad / C - 1), (unsigned)m);
    sketch_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(codes), L_pad, k, w, mask,
        static_cast<long long*>(val), static_cast<int*>(ps));
    return (int)cudaGetLastError();
}
