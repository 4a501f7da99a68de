"""Readings that the limits of a cell's comparison are set from, on the
card at the cell's own size:

    python3 port_bench/limits.py --workload NAME --seed N [--seed N ...]

For each seed, in one process: the cell's genomes built once by the
program on the card, as a run's first job; the run's checks on that job
(harness.check: the program's readings); then two controls put in the
program's place on the same sampled alignment jobs (reference/align.py:
control_alignments), and the same checks on their alignments: `int16`,
the plain reference's DP computed in int16 at the band the program's
first attempt covers, and `half_band`, the exact DP at half that band,
which breaks the configuration's band guarantee. One JSON line per seed.

Not part of a benchmark run; PERF.md gives the readings and the limits
set from them."""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv) -> int:
    import torch

    from pangraph_tpu_torch.build.build import build
    from pangraph_tpu_torch.ops.batch_align import BatchAligner
    from port_bench import generators, harness
    from port_bench.reference import align

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    a = p.parse_args(argv)
    _m, _w, config, traffic = harness.load_cell(a.workload)
    args = harness.build_args(config)
    g = config["guarantees"]
    sc = align.Scoring(**config["scoring"])
    aligner = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device="cuda")
    for seed in a.seed:
        genomes = generators.make(config["genomes"], seed)
        sample = harness.AlignSample(aligner, seed, traffic["align_sample"], traffic["align_longest"])
        sample.job_no, sample.on = 1, True
        t = time.perf_counter()
        text = build(harness.records(genomes), args, aligner=aligner).to_json()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        sample.on = False
        sample.remove()
        kept = sample.sample()
        t = time.perf_counter()
        prog = harness.check(config, [genomes], [(0, text)], kept, "cuda")
        check_s = time.perf_counter() - t
        controls = {}
        for name, bits, shrink in (("half_band", 32, 2), ("int16", 16, 1)):
            t = time.perf_counter()
            jobs = [(ref, qry, ms, max(1, min(bw + args.extra_band_width, g["band_cap"]) // shrink))
                    for _k, ref, qry, ms, bw, _e in kept]
            ctl = align.control_alignments(jobs, sc, "cuda", bits=bits)
            ctl_kept = [(k, ref, qry, ms, bw, e) for (k, ref, qry, ms, bw, _e), e in zip(kept, ctl)]
            checks = harness.check(config, [genomes], [(0, text)], ctl_kept, "cuda")
            controls[name] = {k: v["value"] for k, v in checks.items() if k != "genomes_mismatched"}
            controls[name]["seconds"] = time.perf_counter() - t
        print(json.dumps({"workload": a.workload, "seed": seed, "alignments": len(kept),
                          "longest_ref": max((len(r[1]) for r in kept), default=0),
                          "build_s": build_s, "check_s": check_s,
                          "program": {k: v["value"] for k, v in prog.items()}, "controls": controls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
