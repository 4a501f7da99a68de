"""A/B timing of the port's stripe DP kernel (pangraph_tpu_torch/csrc/stripe_dp.cu)
against other sources of the same kernel, on one GPU, in one process.

    python3 dev/dp_ab_cuda.py [NAME=path/to/stripe_dp.cu ...]

Each NAME=path is built with the port's nvcc flags (its own directory's
stripe_row.cuh is the one it includes) and called through the same C entry
points as the tree's kernel on the same inputs (chip_smoke.kernel_inputs):
records, or window-start carries for the checkpoint shapes. Every output is
compared with the tree's; the line per shape gives each kernel's ms (CUDA
events) and cycles per row of the longest problem at chip_smoke.SM_CLOCK_HZ.
Run from the repository root; a parent commit's source, unpacked with
`git archive` into a gitignored directory, is one such path.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pangraph_tpu_torch.ops import cuda_build as cb  # noqa: E402
from pangraph_tpu_torch.ops import stripe_v2 as sv  # noqa: E402

# (B, R, problems, checkpoint R or None)
SHAPES = [(128, 10240, 256, None), (128, 4096, 256, None), (256, 10240, 128, None), (384, 4096, 64, None),
          (512, 4096, 32, None), (1024, 4096, 32, None), (2048, 10240, 32, None), (128, 65536, 8, 65536),
          (1920, 131072, 4, 131072)]


def build(variants: dict, out_dir: str) -> dict:
    """{name: loaded library}: the tree's kernel as "tree", the others built
    in parallel."""
    libs = {"tree": cb.lib("stripe_dp.cu")}
    procs = {}
    for name, src in variants.items():
        so = os.path.join(out_dir, f"dp_ab_{name}.so")
        procs[name] = (so, subprocess.Popen([cb.nvcc(), *cb.NVCC_FLAGS, "-o", so, src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
        libs[name] = cb._load(so)
    return libs


def dp(lib, t, B: int, ckpt_R):
    ref, qry, rlen, qlen, ms, W = t
    m, R = ref.shape
    dev = ref.device
    args = (cb.ptr(ref), ref.stride(0), cb.ptr(qry), qry.stride(0), cb.ptr(rlen), cb.ptr(qlen), cb.ptr(ms),
            cb.ptr(W), cb.ptr(sv._iupac_on(dev)))
    if ckpt_R is None:
        out = torch.empty((m, R, B), dtype=torch.int16, device=dev)
        rc = lib.stripe_dp_launch(*args, cb.ptr(out), R, B, m, cb.stream(dev))
    else:
        nw = sv.ckpt_windows(ckpt_R, B)
        out = torch.empty((m, nw, 3, B), dtype=torch.int32, device=dev)
        rc = lib.stripe_dp_ckpt_launch(*args, cb.ptr(out), nw, sv.ckpt_layout(B), B, m, cb.stream(dev))
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("dp_ab_cuda: no GPU", file=sys.stderr)
        return 1
    variants = dict(a.split("=", 1) for a in argv)
    out_dir = os.path.join(os.getcwd(), "_build")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(variants, out_dir)
    dev = torch.device("cuda", 0)
    for si, (B, R, m, ck) in enumerate(SHAPES):
        arrays = c.kernel_inputs(B, R, m, seed=100 + si)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        want = dp(libs["tree"], t, B, ck)
        rows = int(arrays[2].max())
        if ck is None:
            live = torch.arange(R, device=dev)[None, :] < t[2][:, None].long()
        else:
            live = torch.arange(want.shape[1], device=dev)[None, :] * sv.ckpt_layout(B) <= t[2][:, None].long()
        cols = []
        for name, lib in libs.items():
            same = bool(torch.equal(dp(lib, t, B, ck)[live], want[live]))
            ms_ = c._event_ms(torch, lambda: dp(lib, t, B, ck), 2 if R > 60000 else 5)
            cols.append(f"{name}={ms_:.3f}ms/{ms_ * 1e-3 * c.SM_CLOCK_HZ / rows:.0f}cyc" + ("" if same else "/DIFFERS"))
        print(f"B={B} R={R} problems={m} ckpt={ck is not None} rows={rows} " + " ".join(cols), flush=True)
        del want, t
        torch.cuda.empty_cache()
    print(c.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
