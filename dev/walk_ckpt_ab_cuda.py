"""A/B timing of the port's checkpoint walk (pangraph_tpu_torch/csrc/walk_ckpt.cu,
through stripe_v2.walk_ckpt) against the one-block-per-problem design it
replaced, on one GPU, in one process.

    python3 dev/walk_ckpt_ab_cuda.py path/to/old/walk_ckpt.cu

The old source is the kernel whose C entry point is `walk_ckpt_launch(...,
scratch, grid, K, ...)`: one block a problem, each block re-deriving the
windows its walker needs into its own window of scratch, the grid held so
that all blocks' windows take 48 MB. It is built with the port's nvcc flags
(its own directory's headers are the ones it includes) and called on the
same carries and inputs (chip_smoke.kernel_inputs, seeds of chip_smoke's
phases 3 and 3b) as the tree's wrapper. Outputs (events, n_events, meta)
must be equal. Per shape, both are timed in turns (old, new, new, old; CUDA
events) over the first 4 problems and over all of them, and the new
kernel's re-derive and walk launches are timed apart (its launch log).
Run from the repository root; a parent commit's source, unpacked with
`git archive` into a gitignored directory, is such a path.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pangraph_tpu_torch.ops import cuda_build as cb  # noqa: E402
from pangraph_tpu_torch.ops import stripe_v2 as sv  # noqa: E402

OLD_SCRATCH_BYTES = 48 << 20  # the old design's grid bound
OLD_ARGTYPES = [cb._P, cb._I64, cb._P, cb._I64, cb._P, cb._P, cb._P, cb._P, cb._P, cb._P, cb._I, cb._I, cb._I,
                cb._P, cb._I, cb._I, cb._P, cb._P, cb._P, cb._P, cb._I, cb._P]
# (B, R, problems, seed, mutation): chip_smoke's CKPT_SHAPES and MBP_SHAPE
SHAPES = [(B, R, m, 200 + i, {}) for i, (B, R, m) in enumerate(c.CKPT_SHAPES)] + [
    (*c.MBP_SHAPE, 300, {"indel_every": 4000, "balanced": True})]


def build_old(src: str, out_dir: str):
    so = os.path.join(out_dir, "walk_ckpt_ab_old.so")
    p = subprocess.run([cb.nvcc(), *cb.NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{(p.stdout + p.stderr)[-3000:]}")
    lib = cb._load(so)
    lib.walk_ckpt_launch.argtypes = OLD_ARGTYPES
    lib.walk_ckpt_launch.restype = cb._I
    return lib


def walk_old(lib, ck, ref, qry, rlen, qlen, ms, W, K: int):
    m, n_windows, _, B = ck.shape
    dev = ref.device
    WV = sv.ckpt_layout(B)
    grid = max(1, min(m, OLD_SCRATCH_BYTES // (WV * B * 2)))
    scratch = torch.empty(grid * WV * B, dtype=torch.int16, device=dev)
    out = [torch.empty((m, K), dtype=torch.int32, device=dev), torch.empty((m, K), dtype=torch.int32, device=dev),
           torch.empty(m, dtype=torch.int32, device=dev), torch.empty((m, 4), dtype=torch.int32, device=dev)]
    rc = lib.walk_ckpt_launch(cb.ptr(ref), ref.stride(0), cb.ptr(qry), qry.stride(0), cb.ptr(rlen), cb.ptr(qlen),
                              cb.ptr(ms), cb.ptr(W), cb.ptr(sv._iupac_on(dev)), cb.ptr(ck), n_windows, WV, B,
                              cb.ptr(scratch), grid, K, *(cb.ptr(x) for x in out), m, cb.stream(dev))
    if rc != 0:
        raise RuntimeError(f"old walk_ckpt launch failed: CUDA error {rc}")
    return out


def same(a, b, K: int) -> bool:
    return not c._walk_err(a, b, len(a[2]), K)


def main(argv) -> int:
    if not torch.cuda.is_available() or len(argv) != 1:
        print("walk_ckpt_ab_cuda: needs a GPU and the old walk_ckpt.cu's path", file=sys.stderr)
        return 1
    out_dir = os.path.join(os.getcwd(), "_build")
    os.makedirs(out_dir, exist_ok=True)
    old = build_old(argv[0], out_dir)
    dev = torch.device("cuda", 0)
    for B, R, m, seed, mutation in SHAPES:
        arrays = c.kernel_inputs(B, R, m, seed=seed, **mutation)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        ck = sv.stripe_dp_ckpt(*t, B, R)
        K = c.MBP_K if R > 1_000_000 else c.WALK_K
        reps = 1 if R > 1_000_000 else c.TIMED_REPS
        cols = []
        for n in sorted({min(c.PLAIN_CKPT_WALK_PROBLEMS, m), m}):
            args = [x[:n].contiguous() for x in [ck] + t]
            ok = same(sv.walk_ckpt(*args, K), walk_old(old, *args, K), K)
            o1 = c._event_ms(torch, lambda: walk_old(old, *args, K), reps)
            n1 = c._event_ms(torch, lambda: sv.walk_ckpt(*args, K), reps)
            n2 = c._event_ms(torch, lambda: sv.walk_ckpt(*args, K), reps)
            o2 = c._event_ms(torch, lambda: walk_old(old, *args, K), reps)
            parts = c._walk_ckpt_parts(torch, sv, args, K)
            cols.append(f"problems={n} old_ms={o1:.3f},{o2:.3f} new_ms={n1:.3f},{n2:.3f} "
                        f"speedup={(o1 + o2) / (n1 + n2):.2f} waves={parts['waves']} "
                        f"rederive_ms={parts['rederive_ms']:.3f} walk_ms={parts['walk_ms']:.3f}"
                        + ("" if ok else " DIFFERS"))
        print(f"B={B} R={R} " + " | ".join(cols), flush=True)
        del ck, t
        torch.cuda.empty_cache()
    print(c.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
