"""Where a bench workload's host-engine DP cells come from.

    python3 dev/host_cells_cuda.py [WORKLOAD ...] [--device cuda|cpu]

For each build workload of pangraph_tpu_torch.bench (default: the 12 x 120
kb synthetic), builds it once to warm up, then once with the aligner's
receipts set to 0 and its host paths counted: per reason, the jobs and DP
cells (at the host's 2W+2 band, as engine_report() counts them) that went to
the host engine, "past_clamp" (a band widened past the kernel's widest,
which only the host engine widens further) or "budget" (the smallest jobs
within NATIVE_CELL_BUDGET), and the jobs that _plan sent to the host
before any launch ("plan_fallback", whose cells _host_fallback counts).
Prints one JSON object with those counts, the widths of the past-clamp
jobs and engine_report(). Run from the repository root.
"""
import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

from pangraph_tpu_torch import bench  # noqa: E402
from pangraph_tpu_torch.build.build import build  # noqa: E402
from pangraph_tpu_torch.ops.batch_align import BatchAligner  # noqa: E402


def host_cells(name: str, device: str) -> dict:
    w = bench.WORKLOADS[name]
    recs = w.make()
    args = w.build_args()
    al = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts,
                      device=None if w.host else device)
    max_w = (BatchAligner.MAX_B - 2) // 2
    jobs, cells, clamp_widths = collections.Counter(), collections.Counter(), []
    run_native, plan = BatchAligner._run_round_native, BatchAligner._plan

    def counted_native(self, round_jobs, widths):
        for j, W in zip(round_jobs, widths):
            why = "past_clamp" if W > max_w else "budget"
            jobs[why] += 1
            cells[why] += self._job_cells(j, int(W))
            if why == "past_clamp":
                clamp_widths.append(int(W))
        return run_native(self, round_jobs, widths)

    def counted_plan(self, round_jobs, widths, kbumps):
        planned, fallback = plan(self, round_jobs, widths, kbumps)
        for i in fallback:
            jobs["plan_fallback"] += 1
            cells["plan_fallback"] += self._job_cells(round_jobs[i], int(widths[i]))
        return planned, fallback

    build(recs, args, aligner=al)  # warm-up
    BatchAligner._run_round_native, BatchAligner._plan = counted_native, counted_plan
    try:
        BatchAligner.reset_engine_stats()
        t = time.time()
        build(recs, args, aligner=al)
        wall = time.time() - t
    finally:
        BatchAligner._run_round_native, BatchAligner._plan = run_native, plan
    return {"workload": name, "device": device, "wall_s": round(wall, 3), "host_jobs": dict(jobs),
            "host_cells": dict(cells), "past_clamp_widths": sorted(clamp_widths),
            "engines": BatchAligner.engine_report()}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("workloads", nargs="*", help=f"default: {bench.SYNTH}")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    opts = p.parse_args()
    names = opts.workloads or [bench.SYNTH]
    made = [n for n, w in bench.WORKLOADS.items() if w.make is not None]
    if any(n not in made for n in names):
        p.error(f"workloads are among {made}")
    for name in names:
        print(json.dumps(host_cells(name, opts.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
