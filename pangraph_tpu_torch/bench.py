"""Benchmark of the port: pangenome graph build throughput on one NVIDIA GPU.

    python -m pangraph_tpu_torch.bench [--workload NAME ...] [--repeats N]
        [--native-budget CELLS] [--device {cuda,cpu}]
        [--plasmids FASTA] [--plasmids15 FASTA]

The counterpart of the JAX package's `bench.py`, with its function names and
its one JSON line on stdout (progress goes to stderr): `metric`, `value`,
`unit`, `vs_baseline`, `wall_s`, `align_engine_s` and `detail`, one entry per
workload, plus `workload` (the one the top-level numbers come from: the
headline where it ran, else the first build workload that did), `device`
(platform, name, count and power limit of the device that produced every
number), `native_budget` (BatchAligner.NATIVE_CELL_BUDGET for the run) and
`gate` (the top workload's adaptive-split receipts, engine_report()["gate"]).

Workloads (WORKLOADS, then the kernel probe), all run where no --workload is
given, after one warm-up build of the 12 x 120 kb synthetic (which also
builds the CUDA kernels and the host engine):

- `ecoli_class_realistic_10x4.6Mbp`, the headline: 10 x 4.6 Mbp from
  make_accessory_pangenome (seed 13), best of 3;
- `ecoli_class_realistic_10x4.6Mbp_host`: the same on the host C++ engine
  (BatchAligner(device=None), the CLI's --no-tpu), best of 2: the wall the
  card has to beat;
- `chromosome_scale_4x2.5Mbp_mutation_only` and
  `synthetic_12x120kb_mutation_only` (mutation-only synthetics), best of 2;
  the second also builds once with one merge thread and
  PANGRAPH_TPU_NATIVE_THREADS=1 (`host_scaling`);
- `russian_doll_plasmids` and `real_plasmids_15x`, only from the FASTA given
  by --plasmids / --plasmids15 (null with the reason otherwise);
- `device_kernel_probe`: the stripe DP and walk alone at the reference
  probe's shape (null off the card).

Every build workload reports its best wall, the graph quality and an exact
roundtrip, each repeat's wall, max RSS and (on the card) peak device bytes,
each repeat's sha256 of the graph JSON and the count of distinct ones, and
from its last repeat the aligner's receipts with the DP and walk kernels'
launches and summed device ms and the adaptive split's (`gate`: rates,
overhead, round trip, rounds by kind). Where routing is fixed (the host
route, or a budget of 0) the repeats must give one graph, checked for an
exact roundtrip once; where the adaptive split routes (a budget above 0 on
a device) routing follows measured walls, so the graph may differ between
repeats, and every repeat is checked: an exact roundtrip, and quality
within QUALITY_TOLERANCE of the workload's reference figures (the
headline's, BENCH_r05's) or else of the first repeat's. One aligner serves
the warm-up and every workload of its route where routing is fixed; where
the adaptive split routes, each workload gets a new one, whose measured
rates carry over between its repeats only. A workload that fails fails the run: exit 1, its name and error on
stderr, nothing on stdout.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import platform
import resource
import statistics
import subprocess
import sys
import time
import traceback
from typing import Callable

import numpy as np
import torch

from pangraph_tpu_torch.align.params import BuildArgs
from pangraph_tpu_torch.build.build import build, verify_roundtrip
from pangraph_tpu_torch.commands import graph_quality
from pangraph_tpu_torch.io.fasta import read_fasta
from pangraph_tpu_torch.ops import stripe_v2
from pangraph_tpu_torch.ops.batch_align import BatchAligner
from pangraph_tpu_torch.utils.synth import make_accessory_pangenome, make_synthetic

# reference pangraph v1 builds ~46 Mbp of E. coli in ~300 s on 4 CPU cores
# (BASELINE.md): ~0.153 Mbp/s of input
REFERENCE_BPS = 46_000_000 / 300.0
METRIC = "graph_build_input_bp_per_s"
BASELINE = ("reference pangraph v1: 46 Mbp real E. coli in ~300 s on 4 CPU cores "
            "(BASELINE.md); ours is a structure-matched synthetic (LFS stub environment)")

HEADLINE = "ecoli_class_realistic_10x4.6Mbp"
SYNTH = "synthetic_12x120kb_mutation_only"
PROBE = "device_kernel_probe"


def _headline_records():
    return make_accessory_pangenome(n_genomes=10, genome_len=4_600_000, seed=13)


# the reference's graph of the headline (BENCH_r05), and how far a graph of
# the kernel route may lie from it (relative for blocks and bp, absolute for
# the core fraction): the kernels band B lanes where the host engine bands
# 2W+2, so edits differ at band edges
HEADLINE_QUALITY = {"n_blocks": 1156, "core_fraction": 0.4875, "pangenome_bp": 7028975}
QUALITY_TOLERANCE = {"n_blocks": 0.01, "core_fraction": 0.01, "pangenome_bp": 0.001}


@dataclasses.dataclass(frozen=True)
class Workload:
    """One build workload: `make()` gives its records (None: read from the
    FASTA that the command-line option `option` names), built with
    BuildArgs(circular=True, jobs=jobs), best of `repeats`; `host` builds on
    the host engine (BatchAligner(device=None)); `host_scaling` adds one
    serial build (jobs 1, PANGRAPH_TPU_NATIVE_THREADS=1); `quality` is the
    reference's graph quality for the input, where known."""

    make: Callable
    jobs: int
    repeats: int
    host: bool = False
    host_scaling: bool = False
    option: str = None
    quality: dict = None

    def build_args(self) -> BuildArgs:
        return BuildArgs(circular=True, jobs=self.jobs)


# the reference bench's workloads (bench.py:185-238), in the order they run
WORKLOADS = {
    SYNTH: Workload(lambda: make_synthetic(n_genomes=12, length=120_000, seed=42), jobs=6, repeats=2,
                    host_scaling=True),
    "chromosome_scale_4x2.5Mbp_mutation_only": Workload(
        lambda: make_synthetic(n_genomes=4, length=2_500_000, seed=7, sub_rate=0.005), jobs=2, repeats=2),
    "russian_doll_plasmids": Workload(None, jobs=2, repeats=3, option="plasmids"),
    "real_plasmids_15x": Workload(None, jobs=2, repeats=2, option="plasmids15"),
    HEADLINE: Workload(_headline_records, jobs=2, repeats=3, quality=HEADLINE_QUALITY),
    HEADLINE + "_host": Workload(_headline_records, jobs=2, repeats=2, host=True),
}
WARMUP = SYNTH  # the workload built once before the timed ones

# the kernel probe's shape, the reference's (bench.py:115): m problems of
# L bp with 1% substitutions, record rows R_CAP, band B, event capacity K
PROBE_M, PROBE_L, PROBE_R_CAP, PROBE_B, PROBE_K, PROBE_SEED = 64, 8000, 8192, 128, 1024, 0
PROBE_CALLS = 5  # timed calls after one warm-up; the median is reported
# The DP's dependency bound: row i needs all of row i-1, so a launch takes
# at least its longest problem's rows times one row's critical path, here
# at B 128: 148 assumed cycles (chip_smoke.dp_row_cycles(128), which lists
# them) at the H100's 1.98 GHz boost clock
DP_ROW_CYCLES_B128 = 148
SM_CLOCK_HZ = 1.98e9


class WorkloadFailed(RuntimeError):
    pass


def _say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _cuda_device(aligner):
    dev = getattr(aligner, "device", None)
    return dev if dev is not None and dev.type == "cuda" else None


def _launch_log_ms(log: list) -> dict:
    """Summed device ms per kernel name of a launch log
    (stripe_v2.KERNEL_TIMING, read after a synchronize)."""
    out = {}
    for name, _B, _R, _m, _dev, start, end, _stream in log:
        out[name] = out.get(name, 0.0) + start.elapsed_time(end)
    return {k: round(v, 3) for k, v in sorted(out.items())}


def graph_sha256(graph) -> str:
    return hashlib.sha256(json.dumps(graph.to_json_dict(), sort_keys=True).encode()).hexdigest()


def quality_off(quality: dict, want: dict) -> dict:
    """The quality figures of `quality` that lie beyond QUALITY_TOLERANCE of
    `want`'s: {name: (got, want)}."""
    off = {}
    for k, tol in QUALITY_TOLERANCE.items():
        if abs(quality[k] - want[k]) / (1 if k == "core_fraction" else want[k]) > tol:
            off[k] = (quality[k], want[k])
    return off


def timed_build(records, args, aligner, repeats=1, stats=False, quality=None):
    """Best-of-N host-clock wall around build(). With stats=True the last
    repeat collects the aligner's receipts: DP cells, aligned reference bp
    and engine seconds summed over its round-level STATS rows ("host",
    "host[probe-wait,...]", "mixed[...]"; the per-launch-group "device.*"
    and per-combined-round "broker[...]" rows count the same device cells
    again), engine_report(), the kernels' launches and, on the card, their
    summed device ms from the launch log. Every repeat's graph JSON is
    hashed. Where the aligner's routing is fixed (no device, or a budget of
    0), repeats that differ raise and the roundtrip is verified once, after
    the timed repeats. Where the adaptive split routes (aligner.gated()),
    every repeat's roundtrip is verified and its quality held within
    QUALITY_TOLERANCE of `quality` (the reference's figures) or, where that
    is None, of the first repeat's; these checks are outside the walls.

    Returns (best wall, graph, align stats or None, runs), runs holding
    each repeat's wall, max RSS, (on the card) peak device bytes and graph
    sha256, the last repeat's sha256 and the count of distinct ones."""
    gated = aligner.gated()
    cuda = _cuda_device(aligner)
    best, graph, align_stats = None, None, None
    runs = {"walls_s": [], "max_rss_bytes": []}
    if cuda is not None:
        runs["peak_device_bytes"] = []
    digests = []
    for rep in range(repeats):
        collect = stats and rep == repeats - 1
        if collect:
            BatchAligner.reset_engine_stats()
            stripe_v2.reset_launches()
            if cuda is not None:
                stripe_v2.KERNEL_TIMING = []
        if cuda is not None:
            torch.cuda.reset_peak_memory_stats(cuda)
        try:
            t = time.time()
            graph = build(records, args, aligner=aligner)
            dt = time.time() - t
            kernel_ms = "not measured"
            if cuda is not None:
                torch.cuda.synchronize(cuda)
                runs["peak_device_bytes"].append(torch.cuda.max_memory_allocated(cuda))
                if collect:
                    kernel_ms = _launch_log_ms(stripe_v2.KERNEL_TIMING)
        finally:
            if collect:
                stripe_v2.KERNEL_TIMING = None
        best = dt if best is None else min(best, dt)
        runs["walls_s"].append(round(dt, 3))
        runs["max_rss_bytes"].append(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
        digests.append(graph_sha256(graph))
        _say(f"repeat {rep + 1}/{repeats}: {dt:.3f} s")
        if gated:
            verify_roundtrip(graph, records)
            q = graph_quality(graph)
            quality = quality or q
            off = quality_off(q, quality)
            if off:
                raise AssertionError(f"repeat {rep + 1}'s graph quality is off: {off}")
        if collect:
            rounds = [s for s in BatchAligner.STATS if s[0] == "host" or s[0].startswith(("mixed[", "host["))]
            cells = sum(s[2] for s in rounds)
            bp = sum(s[4] for s in rounds)
            secs = sum(s[3] for s in rounds)
            align_stats = {
                "aligned_ref_bp": bp,
                "dp_cells": cells,
                "align_engine_s": round(secs, 2),
                "aligned_bp_per_s_per_chip": round(bp / dt, 1),
                "dp_cells_per_s": round(cells / max(secs, 1e-9), 1),
                "engines": BatchAligner.engine_report(),
                "launches": dict(stripe_v2.LAUNCHES),
                "kernel_ms": kernel_ms,
            }
    if not gated:
        if len(set(digests)) > 1:
            raise AssertionError(f"the graphs of the {repeats} repeats differ: sha256 {digests}")
        verify_roundtrip(graph, records)
    runs["graph_sha256s"] = digests
    runs["distinct_graphs"] = len(set(digests))
    runs["graph_sha256"] = digests[-1]
    return best, graph, align_stats, runs


def workload_report(records, dt, graph, align_stats=None, runs=None):
    """The reference's per-workload report (bench.py:80-95), the same keys
    and rounding; `runs` (timed_build's) adds each repeat's figures and the
    graph's sha256."""
    q = graph_quality(graph)
    rep = {
        "genomes": len(records),
        "input_bp": q["input_bp"],
        "wall_s": round(dt, 2),
        "bp_per_s": round(q["input_bp"] / dt, 1),
        "vs_baseline": round(q["input_bp"] / dt / REFERENCE_BPS, 3),
        "roundtrip": "exact",
        "quality": {k: q[k] for k in ("pangenome_bp", "core_fraction", "compression", "n_blocks")},
    }
    if align_stats:
        rep["align"] = align_stats
    if runs:
        rep.update(runs)
    return rep


def _probe_inputs(m: int):
    rng = np.random.default_rng(PROBE_SEED)
    L, R_cap, B = PROBE_L, PROBE_R_CAP, PROBE_B
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    ref_seq = np.zeros((m, R_cap), np.uint8)
    qry_seq = np.zeros((m, R_cap + B), np.uint8)
    for s in range(m):
        ref = ACGT[rng.integers(0, 4, L)]
        q = ref.copy()
        idx = rng.choice(L, L // 100, replace=False)
        q[idx] = ACGT[rng.integers(0, 4, len(idx))]
        ref_seq[s, :L] = ref
        qry_seq[s, :L] = q
    rlen = np.full(m, L, np.int32)
    qlen = np.full(m, L, np.int32)
    ms = np.zeros(m, np.int32)
    W = np.full(m, (B - 2) // 2, np.int32)
    return ref_seq, qry_seq, rlen, qlen, ms, W


def device_kernel_probe(device, m: int = PROBE_M):
    """The stripe DP and walk alone (stripe_v2.stripe_align) at the
    reference probe's shape: m problems of PROBE_L bp with 1% substitutions,
    R_cap 8192, B 128, K 1024. Device time is the launch log's event pairs
    (DP plus walk), the median of PROBE_CALLS calls after a warm-up;
    `effective_1call` is the host clock around one synchronized call,
    upload included. Beside them, the DP's dependency bound and the share of
    it reached. Every problem's walk must end alive within K events.
    Returns None off the card, as the reference's does off the TPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    B, K, L = PROBE_B, PROBE_K, PROBE_L
    args = _probe_inputs(m)
    seg = stripe_v2.walk_segment(PROBE_R_CAP, B)

    def call():
        out = stripe_v2.stripe_align(*args, B, K, seg, dev)
        torch.cuda.synchronize(dev)
        return out

    calls = []
    try:
        stripe_v2.KERNEL_TIMING = []
        out = call()  # warm-up
        t = time.time()
        call()
        one_s = time.time() - t
        for _ in range(PROBE_CALLS):
            stripe_v2.KERNEL_TIMING = []
            call()
            calls.append(_launch_log_ms(stripe_v2.KERNEL_TIMING))
    finally:
        stripe_v2.KERNEL_TIMING = None
    n_ev = out["n_events"].cpu().numpy()
    dead = out["meta"][:, 1].cpu().numpy()
    if (dead != 0).any() or (n_ev > K).any() or (n_ev < 0).any():
        raise AssertionError(f"probe walks died or overflowed: {int((dead != 0).sum())} dead, "
                             f"most events {int(n_ev.max())} of {K}")
    dp_ms = statistics.median(c["stripe_dp"] for c in calls)
    walk_ms = statistics.median(c["walk"] for c in calls)
    dev_ms = statistics.median(c["stripe_dp"] + c["walk"] for c in calls)
    cells = m * L * B
    bound_ms = L * DP_ROW_CYCLES_B128 / SM_CLOCK_HZ * 1e3
    return {
        "kernel": "v2", "m": m, "B": B, "L": L, "R_cap": PROBE_R_CAP, "K": K,
        "on_device_gcells_per_s": round(cells / dev_ms / 1e6, 2),
        "effective_1call_gcells_per_s": round(cells / one_s / 1e9, 2),
        "device_ms": round(dev_ms, 4), "dp_ms": round(dp_ms, 4), "walk_ms": round(walk_ms, 4),
        "effective_1call_ms": round(one_s * 1e3, 3),
        "calls_device_ms": [round(c["stripe_dp"] + c["walk"], 4) for c in calls],
        "dp_dependency_bound_ms": round(bound_ms, 4),
        "dp_dependency_bound_gcells_per_s": round(cells / bound_ms / 1e6, 2),
        "dp_bound_share": round(bound_ms / dp_ms, 4),
        "timed_by": f"launch-log event pairs, median of {PROBE_CALLS} calls after a warm-up",
    }


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0].rsplit(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def device_info(device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count(), "power_limit": _power_limit()}
    return {"platform": "cpu", "name": platform.processor() or platform.machine(), "count": 1,
            "power_limit": "not read"}


def run(opts) -> dict:
    """Run the selected workloads; returns the JSON line's object."""
    device = torch.device(opts.device)
    selected = opts.workload or [*WORKLOADS, PROBE]
    builds = [n for n in WORKLOADS if n in selected]
    base = BuildArgs(circular=True)
    aligners = {}

    def aligner(host: bool):
        """The route's aligner. Where the adaptive split routes, each call
        gets a new one, so that a workload's measured rates are its own and
        not the warm-up's or an earlier workload's."""
        if host not in aligners or aligners[host].gated():
            aligners[host] = BatchAligner(base.banded_params, base.extra_band_width, base.max_alignment_attempts,
                                          device=None if host else device)
        return aligners[host]

    made = {}

    def records(w: Workload):
        if w.make not in made:
            t = time.time()
            made[w.make] = w.make()
            _say(f"inputs: {len(made[w.make])} genomes, {sum(len(r.seq) for r in made[w.make])} bp "
                 f"in {time.time() - t:.1f} s")
        return made[w.make]

    detail = {n: None for n in (HEADLINE, HEADLINE + "_host", "chromosome_scale_4x2.5Mbp_mutation_only", SYNTH,
                                "russian_doll_plasmids", "real_plasmids_15x", PROBE)}
    not_run = {}
    for name in builds:
        w = WORKLOADS[name]
        if w.option and getattr(opts, w.option) is None:
            not_run[name] = f"no --{w.option} FASTA given"
    todo = [n for n in builds if n not in not_run]
    if todo:
        host = all(WORKLOADS[n].host for n in todo)
        w = WORKLOADS[WARMUP]
        t = time.time()
        try:
            build(records(w), w.build_args(), aligner=aligner(host))
        except Exception as e:
            traceback.print_exc()
            raise WorkloadFailed(f"warm-up ({WARMUP}): {e}") from e
        detail["warmup"] = {"workload": WARMUP, "route": "host" if host else str(device),
                            "wall_s": round(time.time() - t, 3)}
        _say(f"warm-up {WARMUP}: {detail['warmup']['wall_s']} s")
    for name in todo:
        w = WORKLOADS[name]
        repeats = opts.repeats or w.repeats
        _say(f"{name}: best of {repeats}")
        try:
            recs = read_fasta(getattr(opts, w.option)) if w.option else records(w)
            al = aligner(w.host)
            dt, graph, align, runs = timed_build(recs, w.build_args(), al, repeats=repeats, stats=True,
                                                 quality=w.quality)
            rep = workload_report(recs, dt, graph, align, runs)
            rep["route"] = "host" if w.host else str(device)
            if w.host_scaling:
                os.environ["PANGRAPH_TPU_NATIVE_THREADS"] = "1"
                try:
                    serial, _g, _a, _r = timed_build(recs, BuildArgs(circular=True, jobs=1), al)
                finally:
                    os.environ.pop("PANGRAPH_TPU_NATIVE_THREADS", None)
                rep["host_scaling"] = {
                    "serial_wall_s": round(serial, 2),
                    "parallel_wall_s": round(dt, 2),
                    "speedup": round(serial / dt, 2),
                    "host_cores": os.cpu_count(),
                }
        except Exception as e:
            traceback.print_exc()
            raise WorkloadFailed(f"workload {name}: {e}") from e
        detail[name] = rep
        _say(f"{name}: {rep['wall_s']} s, {rep['bp_per_s']} bp/s, sha256 {rep['graph_sha256'][:16]}")
    if PROBE in selected:
        try:
            probe = device_kernel_probe(device)
        except Exception as e:
            traceback.print_exc()
            raise WorkloadFailed(f"workload {PROBE}: {e}") from e
        detail[PROBE] = "not measured" if probe is None else probe
    for name in detail:
        if name in WORKLOADS or name == PROBE:
            if name not in selected:
                not_run[name] = "not selected (--workload)"
    detail["not_run"] = not_run
    detail["baseline"] = BASELINE
    top = next((n for n in (HEADLINE, *WORKLOADS) if isinstance(detail.get(n), dict)), None)
    head = detail[top] if top else {}
    return {
        "metric": METRIC,
        "value": head.get("bp_per_s"),
        "unit": "bp/s",
        "vs_baseline": head.get("vs_baseline"),
        "wall_s": head.get("wall_s"),
        "align_engine_s": (head.get("align") or {}).get("align_engine_s"),
        "workload": top,
        "device": device_info(device),
        "native_budget": BatchAligner.NATIVE_CELL_BUDGET,
        "gate": (head.get("align") or {}).get("engines", {}).get("gate"),
        "detail": detail,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pangraph_tpu_torch.bench",
                                description="Graph build throughput of the port; one JSON line on stdout.")
    p.add_argument("--workload", action="append", choices=[*WORKLOADS, PROBE],
                   help="run this workload (repeatable; default: all)")
    p.add_argument("--repeats", type=int, help="builds per workload, overriding each one's count")
    p.add_argument("--native-budget", type=float,
                   help="DP cells a round's host leg may take (BatchAligner.NATIVE_CELL_BUDGET)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default), or cpu for the kernels' plain versions")
    p.add_argument("--plasmids", help="FASTA of the russian_doll_plasmids workload")
    p.add_argument("--plasmids15", help="FASTA of the real_plasmids_15x workload")
    opts = p.parse_args(argv)
    if opts.repeats is not None and opts.repeats < 1:
        p.error("--repeats must be at least 1")
    if opts.device == "cuda" and not torch.cuda.is_available():
        print("bench: --device cuda: no CUDA device is available (--device cpu runs the kernels' plain versions)",
              file=sys.stderr)
        return 1
    saved = BatchAligner.NATIVE_CELL_BUDGET
    if opts.native_budget is not None:
        BatchAligner.NATIVE_CELL_BUDGET = int(opts.native_budget)
    try:
        line = run(opts)
    except WorkloadFailed as e:
        print(f"bench: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        BatchAligner.NATIVE_CELL_BUDGET = saved
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
