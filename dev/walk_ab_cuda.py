"""A/B timing of the port's walk kernel (pangraph_tpu_torch/csrc/walk.cu,
through stripe_v2.walk) against another walk.cu with the same C entry point,
on one GPU, in one process.

    python3 dev/walk_ab_cuda.py path/to/old/walk.cu

The old source is built with the port's nvcc flags (the headers of its own
directory are the ones it includes; a parent commit's csrc/, unpacked with
`git archive` into a gitignored directory, is such a path) and its
`walk_launch` is called on the same records as the tree's wrapper: the DP's
records of chip_smoke.kernel_inputs at phase 3's shapes and seeds
(KERNEL_SHAPES, then LONG_INDEL_SHAPE). Outputs (events, n_events, meta)
must be equal: the script exits 1 where they differ. Per shape both are
timed in turns (old, new, new, old; kernel-only device time from
torch.profiler's kernel records, chip_smoke._kernel_ms, chip_smoke.TIMED_REPS
launches each) over the first PLAIN_WALK_PROBLEMS problems and over all of
them, with cycles a dependent read (chip_smoke._walk_reads) at
chip_smoke.SM_CLOCK_HZ. Run from the repository root.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pangraph_tpu_torch.ops import cuda_build as cb  # noqa: E402
from pangraph_tpu_torch.ops import stripe_v2 as sv  # noqa: E402


# the kernels' names in a profiler trace: the old source's, the tree's
OLD_KERNEL = "::walk_kernel("
NEW_KERNEL = "::walk_v2_kernel("


def build_old(src: str, out_dir: str):
    so = os.path.join(out_dir, "walk_ab_old.so")
    p = subprocess.run([cb.nvcc(), *cb.NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{(p.stdout + p.stderr)[-3000:]}")
    return cb._load(so)  # walk_launch keeps its argument types


def walk_old(lib, rec, rlen, qlen, ms, W, seg: int, K: int):
    m, R, B = rec.shape
    dev = rec.device
    out = [torch.empty((m, K), dtype=torch.int32, device=dev), torch.empty((m, K), dtype=torch.int32, device=dev),
           torch.empty(m, dtype=torch.int32, device=dev), torch.empty((m, 4), dtype=torch.int32, device=dev)]
    rc = lib.walk_launch(cb.ptr(rec), R, B, cb.ptr(rlen), cb.ptr(qlen), cb.ptr(ms), cb.ptr(W), seg, K,
                         *(cb.ptr(x) for x in out), m, cb.stream(dev))
    if rc != 0:
        raise RuntimeError(f"old walk launch failed: CUDA error {rc}")
    return out


def main(argv) -> int:
    if not torch.cuda.is_available() or len(argv) != 1:
        print("walk_ab_cuda: needs a GPU and the old walk.cu's path", file=sys.stderr)
        return 1
    out_dir = os.path.join(os.getcwd(), "_build")
    os.makedirs(out_dir, exist_ok=True)
    old = build_old(argv[0], out_dir)
    dev = torch.device("cuda", 0)
    differ = 0
    shapes = [(shape, {}) for shape in c.KERNEL_SHAPES] + [(c.LONG_INDEL_SHAPE, c.LONG_INDELS)]
    for shape_i, ((B, R, m), mutation) in enumerate(shapes):
        arrays = c.kernel_inputs(B, R, m, seed=100 + shape_i, **mutation)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        rec = sv.stripe_dp(*t, B)
        seg = sv.walk_segment(R, B)
        K = c.WALK_K
        cols = []
        for n in sorted({min(c.PLAIN_WALK_PROBLEMS, m), m}):
            args = [rec[:n].contiguous()] + [x[:n].contiguous() for x in t[2:]]
            new_out = sv.walk(*args, seg, K)
            ok = not c._walk_err(new_out, walk_old(old, *args, seg, K), n, K)
            differ += not ok
            o1 = c._kernel_ms(torch, lambda: walk_old(old, *args, seg, K), c.TIMED_REPS, OLD_KERNEL)
            n1 = c._kernel_ms(torch, lambda: sv.walk(*args, seg, K), c.TIMED_REPS, NEW_KERNEL)
            n2 = c._kernel_ms(torch, lambda: sv.walk(*args, seg, K), c.TIMED_REPS, NEW_KERNEL)
            o2 = c._kernel_ms(torch, lambda: walk_old(old, *args, seg, K), c.TIMED_REPS, OLD_KERNEL)
            reads = int(c._walk_reads(new_out, arrays[2][:n], K, min(sv.RUN_CAP, seg)).max(initial=0))
            cyc = c.SM_CLOCK_HZ * 1e-3 / max(reads, 1)
            cols.append(f"problems={n} old_ms={o1:.4f},{o2:.4f} new_ms={n1:.4f},{n2:.4f} "
                        f"speedup={(o1 + o2) / (n1 + n2):.2f} reads_at_least={reads} "
                        f"old_cycles_per_read={(o1 + o2) / 2 * cyc:.0f} new_cycles_per_read={(n1 + n2) / 2 * cyc:.0f}"
                        + ("" if ok else " DIFFERS"))
        print(f"B={B} R={R} long_indels={bool(mutation)} " + " | ".join(cols), flush=True)
        del rec, t
        torch.cuda.empty_cache()
    print(c.smi_line())
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
