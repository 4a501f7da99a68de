"""What a step of the chain kernel's keyed loop (pangraph_tpu_torch/csrc/chain.cu)
is spent on, on one GPU.

    python3 dev/chain_step_probe.py

1. A microbenchmark of the warp primitives the loop could use: one warp,
   4,096 iterations of a dependent chain (or of 2-8 independent chains) of
   `__reduce_max_sync` (redux.sync), of `__shfl_xor_sync` plus an add, and
   of a five-shuffle max tree; cycles an operation by clock64.
2. Variants of csrc/chain.cu, each built with the port's nvcc flags and
   timed on one set of 325,473 anchors (phase 6's longest group's size; a
   chip_smoke._anchor_cloud) at the mapper's chain parameters, by CUDA
   events over 3 launches, in cycles a step at chip_smoke.SM_CLOCK_HZ:
   the tree's source; its consumer warp alone (the producers return at
   once, so the keys are stale and the outputs wrong); its producer warps
   alone (the consumer skips its chunks); LOOK 2 and 8; and the warp max
   done as a shuffle tree, at LOOK 4 and 8. The variants that keep the
   algorithm print whether f and parent equal the tree's kernel's.

Sources go into _build/chain_probe/ (gitignored). Run from the repository
root.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pangraph_tpu_torch.align.chain import ChainParams  # noqa: E402
from pangraph_tpu_torch.ops import chain_k2 as ch  # noqa: E402
from pangraph_tpu_torch.ops import cuda_build as cb  # noqa: E402

OUT = os.path.join(os.getcwd(), "_build", "chain_probe")
ANCHORS = 325_473

MICRO = r"""
#include <cstdio>
#include <cuda_runtime.h>
constexpr unsigned FULL = 0xffffffffu;
template <int C> __global__ void redux_chains(int* out, long long* cyc, int n) {
    int x[C];
    for (int c = 0; c < C; c++) x[c] = threadIdx.x * (c + 1);
    const long long t0 = clock64();
    for (int i = 0; i < n; i++)
#pragma unroll
        for (int c = 0; c < C; c++) x[c] = __reduce_max_sync(FULL, x[c] + (int)threadIdx.x);
    const long long t1 = clock64();
    int s = 0;
    for (int c = 0; c < C; c++) s += x[c];
    if (threadIdx.x == 0) { cyc[0] = t1 - t0; out[0] = s; }
}
template <int C> __global__ void shfl_chains(int* out, long long* cyc, int n) {
    int x[C];
    for (int c = 0; c < C; c++) x[c] = threadIdx.x * (c + 1);
    const long long t0 = clock64();
    for (int i = 0; i < n; i++)
#pragma unroll
        for (int c = 0; c < C; c++) x[c] = __shfl_xor_sync(FULL, x[c], 1 + c % 16) + 1;
    const long long t1 = clock64();
    int s = 0;
    for (int c = 0; c < C; c++) s += x[c];
    if (threadIdx.x == 0) { cyc[0] = t1 - t0; out[0] = s; }
}
__global__ void shuffle_tree_max(int* out, long long* cyc, int n) {
    int x = threadIdx.x;
    const long long t0 = clock64();
    for (int i = 0; i < n; i++) {
        x += threadIdx.x;
#pragma unroll
        for (int o = 16; o; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0) { cyc[0] = t1 - t0; out[0] = x; }
}
int main() {
    int* out;
    long long* cyc;
    cudaMalloc(&out, 4);
    cudaMalloc(&cyc, 8);
    const int n = 4096;
    long long c;
#define RUN(K, NAME, PER) K<<<1, 32>>>(out, cyc, n); cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost); \
    printf("micro %s cycles_per_op=%.2f\n", NAME, (double)c / n / PER);
    RUN(redux_chains<1>, "redux_dependent", 1)
    RUN(redux_chains<2>, "redux_2_chains", 2)
    RUN(redux_chains<4>, "redux_4_chains", 4)
    RUN(redux_chains<8>, "redux_8_chains", 8)
    RUN(shfl_chains<1>, "shfl_add_dependent", 1)
    RUN(shfl_chains<4>, "shfl_add_4_chains", 4)
    RUN(shfl_chains<8>, "shfl_add_8_chains", 8)
    RUN(shuffle_tree_max, "shuffle_tree_max_dependent", 1)
    return 0;
}
"""

TREE_MAX = """__device__ __forceinline__ int warp_max_tree(int x)
{
#pragma unroll
    for (int o = 16; o; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
    return x;
}

__device__ __forceinline__ void load_near("""


def variant(src: str, name: str) -> str:
    """csrc/chain.cu changed as `name` says (see the module docstring)."""
    edits = {
        "consumer_only": [("    int* st_r = kr.st_r[w];", "    return;\n    int* st_r = kr.st_r[w];")],
        "producers_only": [("consume(kr, c, n, k, f, parent, lane, Rq, Pq, Gr, Gs, bo);", "")],
        "look2": [("constexpr int LOOK = 4;", "constexpr int LOOK = 2;")],
        "look8": [("constexpr int LOOK = 4;", "constexpr int LOOK = 8;")],
        "tree_max": [("__device__ __forceinline__ void load_near(", TREE_MAX),
                     ("__reduce_max_sync(FULL, Gs + p)", "warp_max_tree(Gs + p)")],
    }
    out = src
    for part in name.split("+"):
        for old, new in edits.get(part, []):
            if old not in out:
                raise RuntimeError(f"variant {name}: csrc/chain.cu no longer holds {old!r}")
            out = out.replace(old, new, 1)
    return out


VARIANTS = ["tree", "consumer_only", "producers_only", "look2", "look8", "tree_max", "look8+tree_max"]
WRONG_BY_DESIGN = {"consumer_only", "producers_only"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_step_probe: needs a GPU", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    micro_src = os.path.join(OUT, "micro.cu")
    with open(micro_src, "w") as fh:
        fh.write(MICRO)
    procs = {"micro": subprocess.Popen([cb.nvcc(), "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-o",
                                        os.path.join(OUT, "micro"), micro_src],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    with open(os.path.join(cb.CSRC, "chain.cu")) as fh:
        src = fh.read()
    for name in VARIANTS:
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(variant(src, name))
        procs[name] = subprocess.Popen([cb.nvcc(), *cb.NVCC_FLAGS, "-o", os.path.join(OUT, f"{name}.so"), path],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}\n{log[-3000:]}", file=sys.stderr)
            return 1
        if name != "micro":
            libs[name] = cb._load(os.path.join(OUT, f"{name}.so"))
            print(f"built {name}: " + "; ".join(x.strip() for x in log.splitlines() if "registers" in x), flush=True)
    print(subprocess.run([os.path.join(OUT, "micro")], capture_output=True, text=True, check=True).stdout, end="")

    dev = torch.device("cuda", 0)
    cp = ChainParams()
    args = (cp.k, cp.max_gap, cp.bw, cp.window)
    t = c._chain_tensors(torch, [c._anchor_cloud(np.random.default_rng(7), ANCHORS, L=20 * ANCHORS)], dev)
    keyed = ch.key_path(t[2].cpu(), cp.k, cp.bw, cp.window).to(dev)
    want = ch.chain_sets(*t, *args)

    def run(lib):
        f, parent = torch.empty_like(t[0]), torch.empty_like(t[0])
        rc = lib.chain_launch(cb.ptr(t[0]), cb.ptr(t[1]), cb.ptr(t[2]), cb.ptr(keyed), 1, *args, cb.ptr(f),
                              cb.ptr(parent), cb.stream(dev))
        if rc != 0:
            raise RuntimeError(f"chain launch failed: CUDA error {rc}")
        return f, parent

    differ = 0
    for name, lib in libs.items():
        got = run(lib)
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        differ += name not in WRONG_BY_DESIGN and not equal
        ms = c._event_ms(torch, lambda: run(lib), 3)
        print(f"variant={name} anchors={ANCHORS} ms={ms:.3f} "
              f"cycles_per_step={ms * 1e-3 * c.SM_CLOCK_HZ / ANCHORS:.1f} "
              + ("outputs=wrong_by_design" if name in WRONG_BY_DESIGN else f"equal={equal}"), flush=True)
    print(c.smi_line())
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
