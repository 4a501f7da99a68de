"""A/B timing of the port's chain kernel (pangraph_tpu_torch/csrc/chain.cu,
through chain_k2.chain_sets) against the design it replaced, on one GPU, in
one process.

    python3 dev/chain_ab_cuda.py path/to/old/chain.cu

The old source is the kernel whose C entry point is `chain_launch(r, q,
offsets, n_sets, k, max_gap, bw, H, f, parent, stream)`: four sets a block,
two warp reductions a step, f in a shared-memory ring (a parent commit's
csrc/chain.cu, unpacked with `git archive` into a gitignored directory). It
is built with the port's nvcc flags and called on the same anchors as the
tree's wrapper: the mapper's all-vs-all anchor groups of the headline's ten
genomes (chip_smoke's phase 6, at its parameters). Outputs (f, parent) must
be equal: the script exits 1 where they differ. Both are timed in turns
(old, new, new, old; kernel-only device time from torch.profiler's kernel
records, chip_smoke._kernel_ms, chip_smoke.TIMED_REPS launches each),
with cycles a step of the longest set at chip_smoke.SM_CLOCK_HZ. Run from
the repository root.
"""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pangraph_tpu_torch.ops import chain_k2 as ch  # noqa: E402
from pangraph_tpu_torch.ops import cuda_build as cb  # noqa: E402

KERNEL = "::chain_kernel("  # both sources' kernel, by its name in a profiler trace
OLD_ARGTYPES = [cb._P, cb._P, cb._P, cb._I, cb._I, cb._I, cb._I, cb._I, cb._P, cb._P, cb._P]


def build_old(src: str, out_dir: str):
    so = os.path.join(out_dir, "chain_ab_old.so")
    p = subprocess.run([cb.nvcc(), *cb.NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{(p.stdout + p.stderr)[-3000:]}")
    lib = cb._load(so)
    lib.chain_launch.argtypes = OLD_ARGTYPES
    lib.chain_launch.restype = cb._I
    return lib


def chain_old(lib, r, q, offsets, k: int, max_gap: int, bw: int, H: int):
    f = torch.empty_like(r)
    parent = torch.empty_like(r)
    rc = lib.chain_launch(cb.ptr(r), cb.ptr(q), cb.ptr(offsets), len(offsets) - 1, k, max_gap, bw, H, cb.ptr(f),
                          cb.ptr(parent), cb.stream(r.device))
    if rc != 0:
        raise RuntimeError(f"old chain launch failed: CUDA error {rc}")
    return f, parent


def headline_sets() -> tuple:
    """Phase 6's anchor groups and chain parameters."""
    from pangraph_tpu_torch.align.chain import ChainParams
    from pangraph_tpu_torch.align.mapper import MapperParams
    from pangraph_tpu_torch.graph.seq import as_seq
    from pangraph_tpu_torch.io.fasta import read_fasta

    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "headline.fa")
        c.headline_fasta(fa)
        recs = sorted(read_fasta(fa), key=lambda rec: rec.seq_name)
    mp = MapperParams()
    cp = ChainParams(k=mp.k, max_gap=mp.max_gap, bw=mp.bw, min_score=mp.min_chain_score, min_anchors=mp.min_anchors)
    sets = c._headline_anchor_sets([as_seq(rec.seq) for rec in recs], [rec.seq_name for rec in recs], mp)
    return sets, (cp.k, cp.max_gap, cp.bw, cp.window)


def main(argv) -> int:
    if not torch.cuda.is_available() or len(argv) != 1:
        print("chain_ab_cuda: needs a GPU and the old chain.cu's path", file=sys.stderr)
        return 1
    out_dir = os.path.join(os.getcwd(), "_build")
    os.makedirs(out_dir, exist_ok=True)
    old = build_old(argv[0], out_dir)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    sets, args = headline_sets()
    t = [torch.from_numpy(a).to(dev) for a in ch.pack_sets(sets)]
    sizes = np.diff(t[2].cpu().numpy())
    print(f"sets={len(sets)} anchors={int(sizes.sum())} largest={int(sizes.max())} "
          f"keyed_sets={int(ch.key_path(t[2].cpu(), args[0], args[2], args[3]).sum())} "
          f"setup_s={time.time() - t0:.1f}", flush=True)
    new_out = ch.chain_sets(*t, *args)
    old_out = chain_old(old, *t, *args)
    ok = all(torch.equal(a, b) for a, b in zip(new_out, old_out))
    o1 = c._kernel_ms(torch, lambda: chain_old(old, *t, *args), c.TIMED_REPS, KERNEL)
    n1 = c._kernel_ms(torch, lambda: ch.chain_sets(*t, *args), c.TIMED_REPS, KERNEL)
    n2 = c._kernel_ms(torch, lambda: ch.chain_sets(*t, *args), c.TIMED_REPS, KERNEL)
    o2 = c._kernel_ms(torch, lambda: chain_old(old, *t, *args), c.TIMED_REPS, KERNEL)
    cyc = c.SM_CLOCK_HZ * 1e-3 / int(sizes.max())
    print(f"old_ms={o1:.3f},{o2:.3f} new_ms={n1:.3f},{n2:.3f} speedup={(o1 + o2) / (n1 + n2):.2f} "
          f"old_cycles_per_step={(o1 + o2) / 2 * cyc:.1f} new_cycles_per_step={(n1 + n2) / 2 * cyc:.1f}"
          + ("" if ok else " DIFFERS"), flush=True)
    print(c.smi_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
