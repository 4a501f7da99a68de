"""A/B timing of the port's sketch kernel (pangraph_tpu_torch/csrc/sketch.cu,
through sketch_k1.sketch_dense) against the design it replaced, and against
variants of itself, on one GPU, in one process.

    python3 dev/sketch_ab_cuda.py path/to/old/sketch.cu [--variants]

The old source is the kernel whose C entry point is `sketch_launch(codes,
L_pad, m, k, w, val, ps, stream)`: one block of 256 threads per 512 window
starts, k codes a position, w compares a window (a parent commit's
csrc/sketch.cu, unpacked with `git archive` into a gitignored directory).
It is built with the port's nvcc flags and called on the same codes as the
tree's wrapper: chip_smoke's phase 6 batches (the headline's ten genomes at
(19, 19) and (15, 100)) and its phase 3c batches. Outputs (val, ps) must be
equal: the script exits 1 where they differ. Both are timed in turns (old,
new, new, old; kernel-only device time from torch.profiler's kernel
records, chip_smoke._kernel_ms, chip_smoke.TIMED_REPS launches each), with
SM cycles a window start (chip_smoke._sketch_cycles) and the share of the
bound (chip_smoke._sketch_bound).

With --variants it also builds the tree's source under each of VARIANTS'
build flags (see csrc/sketch.cu's header) and times each beside the tree's
kernel, in turns (tree, variant, variant, tree), on phase 6's batches:
other layouts and the (value, position) pair key at every k, whose outputs
must equal the tree's, and the stage probes, whose outputs are wrong by
design. ptxas's registers and spills are printed for each build. Builds go
to _build/ (gitignored). Run from the repository root.
"""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pangraph_tpu_torch.ops import cuda_build as cb  # noqa: E402
from pangraph_tpu_torch.ops import sketch_k1 as sk  # noqa: E402

# name -> (build flags on the tree's csrc/sketch.cu, whether the outputs must equal the tree's)
VARIANTS = {
    "pair_key_2_blocks": (["-DSKETCH_PAIR_KEY"], True),
    "pair_key_4_blocks": (["-DSKETCH_PAIR_KEY", "-DSKETCH_PAIR_MIN_BLOCKS=4"], True),
    "min_blocks_4": (["-DSKETCH_MIN_BLOCKS=4"], True),
    "threads_64": (["-DSKETCH_THREADS=64", "-DSKETCH_MIN_BLOCKS=16"], True),
    "threads_256": (["-DSKETCH_THREADS=256", "-DSKETCH_MIN_BLOCKS=4"], True),
    "probe_loads_stores": (["-DSKETCH_PROBE=1"], False),
    "probe_hash_stores": (["-DSKETCH_PROBE=2"], False),
    "probe_no_mix": (["-DSKETCH_PROBE=3"], False),
}


def build(name: str, src: str, flags: list, out_dir: str):
    """Start nvcc on `src`; (the library's path, the process)."""
    so = os.path.join(out_dir, f"sketch_ab_{name}.so")
    return so, subprocess.Popen([cb.nvcc(), *cb.NVCC_FLAGS, *flags, "-o", so, src], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def finish(name: str, so: str, proc):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}\n{log[-3000:]}")
    regs = sorted({line.strip() for line in log.splitlines() if "registers" in line or "spill" in line})
    print(f"build={name} ptxas={regs}", flush=True)
    return cb._load(so)


def run(lib, codes, k: int, w: int):
    m, L_pad = codes.shape
    val = torch.empty((m, L_pad - sk.C), dtype=torch.int64, device=codes.device)
    ps = torch.empty((m, L_pad - sk.C), dtype=torch.int32, device=codes.device)
    rc = lib.sketch_launch(cb.ptr(codes), L_pad, m, k, w, cb.ptr(val), cb.ptr(ps), cb.stream(codes.device))
    if rc != 0:
        raise RuntimeError(f"sketch launch failed: CUDA error {rc}")
    return val, ps


def headline_batches() -> list:
    """Phase 6's batches: ((k, w), codes) of the headline's ten genomes."""
    from pangraph_tpu_torch.graph.seq import as_seq
    from pangraph_tpu_torch.io.fasta import read_fasta

    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "headline.fa")
        c.headline_fasta(fa)
        seqs = [as_seq(rec.seq) for rec in sorted(read_fasta(fa), key=lambda rec: rec.seq_name)]
    return [((k, w), c.sketch_codes(seqs, k, w)[0]) for k, w in c.PATH_SKETCH_PARAMS]


def ab(a, b, ct, k: int, w: int) -> tuple:
    """Kernel-only ms of a and b in turns (a, b, b, a): (a's two, b's two)."""
    a1 = c._kernel_ms(torch, lambda: a(ct, k, w), c.TIMED_REPS, c.SKETCH_KERNEL)
    b1 = c._kernel_ms(torch, lambda: b(ct, k, w), c.TIMED_REPS, c.SKETCH_KERNEL)
    b2 = c._kernel_ms(torch, lambda: b(ct, k, w), c.TIMED_REPS, c.SKETCH_KERNEL)
    a2 = c._kernel_ms(torch, lambda: a(ct, k, w), c.TIMED_REPS, c.SKETCH_KERNEL)
    return (a1, a2), (b1, b2)


def main(argv) -> int:
    variants = "--variants" in argv
    argv = [a for a in argv if a != "--variants"]
    if not torch.cuda.is_available() or len(argv) != 1:
        print("sketch_ab_cuda: needs a GPU and the old sketch.cu's path", file=sys.stderr)
        return 1
    out_dir = os.path.join(os.getcwd(), "_build")
    os.makedirs(out_dir, exist_ok=True)
    tree_src = os.path.join(cb.CSRC, "sketch.cu")
    procs = {"old": build("old", argv[0], [], out_dir)}
    if variants:
        procs.update({name: build(name, tree_src, flags, out_dir) for name, (flags, _) in VARIANTS.items()})
    libs = {name: finish(name, so, proc) for name, (so, proc) in procs.items()}
    old = lambda ct, k, w: run(libs["old"], ct, k, w)  # noqa: E731
    dev = torch.device("cuda", 0)
    t0 = time.time()
    headline = [("headline", p, x) for p, x in headline_batches()]
    batches = headline + [("3c", p, x) for p, x in c.sketch_batches_3c()]
    print(f"setup_s={time.time() - t0:.1f}", flush=True)
    ok = True
    for name, (k, w), codes in batches:
        ct = torch.from_numpy(codes).to(dev)
        m, L_pad = codes.shape
        windows = m * (L_pad - sk.C)
        want = sk.sketch_dense(ct, k, w)
        same = all(torch.equal(a, b) for a, b in zip(want, old(ct, k, w)))
        ok &= same
        (o1, o2), (n1, n2) = ab(old, sk.sketch_dense, ct, k, w)
        bound = c._sketch_bound(m, L_pad, k, w)
        print(f"batch={name} k={k} w={w} rows={m} L_pad={L_pad} windows={windows} "
              f"old_ms={o1:.4f},{o2:.4f} new_ms={n1:.4f},{n2:.4f} speedup={(o1 + o2) / (n1 + n2):.2f} "
              f"old_cycles_per_window={c._sketch_cycles((o1 + o2) / 2, windows):.3f} "
              f"new_cycles_per_window={c._sketch_cycles((n1 + n2) / 2, windows):.3f} "
              f"bound_ms={bound['bound_ms']:.5f} bytes_bound_ms={bound['bytes_ms']:.5f} "
              f"ops_bound_ms={bound['ops_ms']:.5f} bound_by={bound['bound_by']} "
              f"new_share_of_bound={bound['bound_ms'] / ((n1 + n2) / 2):.4f}"
              + ("" if same else " DIFFERS"), flush=True)
        if variants and name == "headline":
            for vname, (_, exact) in VARIANTS.items():
                fn = lambda ct, k, w, lib=libs[vname]: run(lib, ct, k, w)  # noqa: E731
                vsame = all(torch.equal(a, b) for a, b in zip(want, fn(ct, k, w))) if exact else None
                ok &= vsame is not False
                (t1, t2), (v1, v2) = ab(sk.sketch_dense, fn, ct, k, w)
                print(f"variant={vname} k={k} w={w} tree_ms={t1:.4f},{t2:.4f} variant_ms={v1:.4f},{v2:.4f} "
                      f"variant_over_tree={(v1 + v2) / (t1 + t2):.3f} "
                      f"variant_cycles_per_window={c._sketch_cycles((v1 + v2) / 2, windows):.3f}"
                      + ("" if vsame is None else f" equal_to_tree={vsame}"), flush=True)
        del ct, want
        torch.cuda.empty_cache()
    print(c.smi_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
