"""The headline build with its alignment launches split over several cards.

    python3 dev/mesh_build_cuda.py [N ...]

Writes chip_smoke's headline pangenome (10 x 4.6 Mbp, seed 13) and runs
`build -c -f -j 2 --device cuda --devices N` through the CLI for each N in
turn (default: every visible card, then 1), with the launch counts and the
aligner's receipts set to 0 before each: per build its wall, the DP and
walk launches and device ms per card (the launch log), the launches and
device cells per shard, and `device_cells_frac`. Prints each card's
`nvidia-smi` name and power limit first. Exits 1 where a build fails or
the graphs of the builds differ byte for byte. Run from the repository
root.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from pangraph_tpu_torch import cli  # noqa: E402
from pangraph_tpu_torch.ops import stripe_v2 as sv  # noqa: E402
from pangraph_tpu_torch.ops.batch_align import BatchAligner  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("mesh_build_cuda: needs a GPU", file=sys.stderr)
        return 1
    counts = [int(a) for a in argv] or [torch.cuda.device_count(), 1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for i, line in enumerate(smi):
        c.say("card", index=i, smi=repr(line))
    c.phase_build()
    graphs = {}
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "headline.fa")
        t0 = time.time()
        c.say("headline", input_bp=c.headline_fasta(fa), setup_s=round(time.time() - t0, 1))
        for n in counts:
            out = os.path.join(tmp, f"devices_{n}.json")
            torch.cuda.empty_cache()
            BatchAligner.reset_engine_stats()
            sv.reset_launches()
            sv.KERNEL_TIMING = []
            try:
                t0 = time.time()
                rc = cli.main(["build", fa, "-c", "-f", "-j", "2", "--device", "cuda", "--devices", str(n),
                               "--no-progress-bar", "-o", out])
                wall = time.time() - t0
                torch.cuda.synchronize()
                log = c.launch_log_summary(sv.KERNEL_TIMING)
            finally:
                sv.KERNEL_TIMING = None
            report = BatchAligner.engine_report()
            c.say("mesh_build", devices=n, rc=rc, wall_s=round(wall, 3), launches=json.dumps(sv.LAUNCHES),
                  device_cells=report["device"]["cells"], device_cells_frac=report["device_cells_frac"],
                  shards=json.dumps(report["device_shards"]))
            c.say_launch_log(f"mesh_build.devices_{n}", log)
            if rc != 0:
                return 1
            with open(out, "rb") as f:
                graphs[n] = f.read()
    same = len(set(graphs.values())) == 1
    c.say("mesh_build.graphs", equal=same, builds=json.dumps(counts))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
