"""What the checkpoint pair's plain versions cost in chip_smoke's phase 3,
by the problems they run on, on one GPU.

    python3 dev/ckpt_plain_cost.py

At each of chip_smoke.CKPT_SHAPES, on phase 3's inputs (the same seeds),
stripe_dp_ckpt_plain and then walk_ckpt_plain (on the checkpoint DP
kernel's carries) each run twice, timed on the host clock around one
synchronized call: on the problems chip_smoke holds the walk to
(chip_smoke._plain_ckpt_problems: the one with the most windows and the
first of the others), and on every problem. Each is held against the
kernels on the same problems (carries of live windows, and
chip_smoke._walk_err); the script exits 1 where they differ. It prints the
seconds of each, so that the problems each plain version runs on in
phase 3 rest on a measurement. Run from the repository root.
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pangraph_tpu_torch.ops import stripe_v2 as sv  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ckpt_plain_cost: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    ok = True
    for shape_i, (B, R, m) in enumerate(c.CKPT_SHAPES):
        arrays = c.kernel_inputs(B, R, m, seed=200 + shape_i)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        ck = sv.stripe_dp_ckpt(*t, B, R)
        out = sv.walk_ckpt(ck, *t, c.WALK_K)
        sets = (("longest_and_first", c._plain_ckpt_problems(arrays[2])), ("all", list(range(m))))
        for name, problems in sets:
            idx = torch.tensor(problems, device=dev)
            tsub = [x[idx].contiguous() for x in t]
            ms, plain = c._host_ms(torch, lambda: sv.stripe_dp_ckpt_plain(*tsub, B, R))
            live = torch.arange(plain.shape[1], device=dev)[None, :] * sv.ckpt_layout(B) <= tsub[2][:, None].long()
            err = int((ck[idx] - plain).abs()[live].max())
            ok &= err == 0
            print(f"B={B} R={R} set={name} problems={problems} rows={arrays[2][problems].tolist()} "
                  f"plain_dp_s={ms / 1e3:.1f} max_abs_err={err}", flush=True)
            del plain
        for name, problems in sets:
            idx = torch.tensor(problems, device=dev)
            sub = [ck[idx].contiguous()] + [x[idx].contiguous() for x in t]
            ms, plain = c._host_ms(torch, lambda: sv.walk_ckpt_plain(*sub, c.WALK_K))
            err = c._walk_err([x[idx] for x in out], plain, len(problems), c.WALK_K)
            ok &= err == 0
            print(f"B={B} R={R} set={name} problems={problems} rows={arrays[2][problems].tolist()} "
                  f"plain_walk_s={ms / 1e3:.1f} max_abs_err={err}", flush=True)
        del ck, out
        torch.cuda.empty_cache()
    print(c.smi_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
