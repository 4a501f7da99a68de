"""One run of one benchmark cell (see run.py for the command).

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(configs/<name>.json: the deployment's genomes, as a generator spec, its
`pangraph build` arguments, the scoring its alignments are judged by and
the guarantees its result is held to) under a traffic mix
(traffic/<name>.json: the job kind and its parameters). A generator spec
names genomes/<name>.py (generators.py). The per-layer metrics of
BENCHMARK.json are read by metrics/<name>.py, each a `read(record)` that
returns a number or None. All are found by name, so a configuration, a
cell or a metric is added by adding files and manifest entries.

A run, in one process:

1. set-up: import the program, open the card, build or load its kernels
   and host engine (BatchAligner), make the cell's genomes from the seed,
   and build the traffic's small warm-up input once;
2. the window: build jobs back to back for `seconds`; a job is what
   `pangraph build` does after reading its FASTA, the graph serialised to
   its JSON string, held in memory; job k builds input k of the run's
   pool (generators.pool: inputs made from the seed until they hold the
   traffic's `pool_bp` bases), cycling; the job that starts before the
   window closes runs to its end and counts;
3. the check: the graphs' genomes against the inputs and a sample of the
   window's alignments against the plain reference (reference/), once the
   program's state is freed;
4. one JSON line on stdout, each job's line before it.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import heapq
import importlib.util
import json
import os
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pangraph_tpu")


def say(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------ the manifest


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> tuple:
    """(manifest, workload entry, configuration, traffic) of cell `name`."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "port_bench", "traffic", w["traffic"] + ".json"))
    from port_bench import generators

    for spec in (config["genomes"], traffic["warmup"]):
        generators.load(spec["generator"], root)
    judged_as_built(config)
    return manifest, w, config, traffic


def readers(manifest: dict, workload: str, root: str = ROOT) -> list:
    """[(per-layer metric entry, its read function)] for the metrics the
    cell reports: those whose `workloads` list it, or that list none."""
    out = []
    for m in manifest["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        path = os.path.join(root, "port_bench", "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("port_bench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append((m, mod.read))
    return out


def end_to_end(manifest: dict, workload: str) -> list:
    return [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]


# ------------------------------------------------------- alignment sample


class AlignSample:
    """Keeps a sample of the alignments `BatchAligner.align_many` returns
    in the window, drawn from the seed: each job of a call without pin-split
    plans (those calls are the pieces of the others) gets a key, a CRC of
    the seed, the build job's number and the job's lengths, band and first
    bases; the `size` smallest keys are kept, and beside them the
    `longest` jobs by reference length (ties by key), so the sample depends
    on the seed and the jobs alone, not on the merge threads' order. The
    inputs and the edits are copied when they are returned: the program
    edits both later."""

    def __init__(self, aligner, seed: int, size: int, longest: int = 0):
        self.size, self.longest = size, longest
        self.top = []  # min-heap of ((reference length, key), arrival, row)
        self.seed = seed % (1 << 64)
        self.job_no = 0
        self.on = False
        self.kept = []  # (key, ref, qry, mean shift, band width, edit dict)
        self.cut = 1 << 32
        self._arrivals = 0  # orders rows of equal rank in the heap: rows do not compare
        self._lock = threading.Lock()
        self._orig = aligner.align_many
        self._aligner = aligner
        aligner.align_many = self._align_many

    def _align_many(self, jobs):
        edits = self._orig(jobs)
        if self.on and not any(getattr(j, "segments", None) for j in jobs):
            self._keep(jobs, edits)
        return edits

    def _keep(self, jobs, edits) -> None:
        from pangraph_tpu_torch.ops.batch_align import AlignJob

        head = struct.pack("<QQ", self.seed, self.job_no)
        rows = []
        for j, e in zip(jobs, edits):
            j = j if isinstance(j, AlignJob) else AlignJob(*j)
            ms, bw = int(j.band.mean_shift), int(j.band.band_width)
            key = zlib.crc32(j.ref[:32].tobytes() + j.qry[:32].tobytes(),
                             zlib.crc32(head + struct.pack("<qqqq", len(j.ref), len(j.qry), ms, bw)))
            rank = (len(j.ref), key)
            if key < self.cut or (self.longest and (len(self.top) < self.longest or rank > self.top[0][0])):
                rows.append((rank, (key, np.array(j.ref, dtype=np.uint8), np.array(j.qry, dtype=np.uint8), ms, bw,
                                    edit_dict(e))))
        with self._lock:
            self.kept.extend(r for _rank, r in rows if r[0] < self.cut)
            if len(self.kept) > 4 * self.size:
                self.kept.sort(key=lambda r: r[0])
                del self.kept[2 * self.size :]
                self.cut = self.kept[-1][0]
            for rank, r in rows:
                self._arrivals += 1
                if len(self.top) < self.longest:
                    heapq.heappush(self.top, (rank, self._arrivals, r))
                elif rank > self.top[0][0]:
                    heapq.heapreplace(self.top, (rank, self._arrivals, r))

    def sample(self) -> list:
        uniform = sorted(self.kept, key=lambda r: r[0])[: self.size]
        chosen = {id(r) for r in uniform}
        longest = [r for _rank, _n, r in sorted(self.top, key=lambda t: t[:2], reverse=True) if id(r) not in chosen]
        return uniform + longest

    def remove(self) -> None:
        del self._aligner.align_many


def edit_dict(e) -> dict:
    return {"subs": [(s.pos, ord(s.alt)) for s in e.subs], "dels": [(d.pos, d.len) for d in e.dels],
            "inss": [(i.pos, i.seq.encode()) for i in e.inss]}


# ------------------------------------------------------------------- run


def build_args(config: dict):
    """The configuration's `BuildArgs`: its groups `aln_args` and
    `banded_params`, where given, as `AlignmentArgs` and
    `BandedAlignParams`. A key that its dataclass lacks, or a group value
    that `BuildArgs` overrides, raises."""
    from pangraph_tpu_torch.align.params import AlignmentArgs, BandedAlignParams, BuildArgs

    given = config["build_args"]
    groups = {"aln_args": AlignmentArgs, "banded_params": BandedAlignParams}
    kw = {k: _fill(groups[k], v, "build_args." + k) if k in groups else v for k, v in given.items()}
    args = _fill(BuildArgs, kw, "build_args")
    for k in groups.keys() & given.keys():
        group = getattr(args, k)
        for key, v in given[k].items():
            if getattr(group, key) != v:
                raise ValueError(f"build_args.{k}.{key} is {v!r}, but BuildArgs sets {getattr(group, key)!r}")
    return args


def _fill(cls, kw: dict, where: str):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kw) - known)
    if unknown:
        raise ValueError(f"{where}: {cls.__name__} has no {', '.join(map(repr, unknown))}")
    return cls(**kw)


def judged_as_built(config: dict) -> None:
    """Raise where the check (`scoring`, the plain reference: a gap costs
    gap_open at any length, end gaps are free) would score alignments
    otherwise than the build's `banded_params` do."""
    from port_bench.reference import align

    bp, sc = build_args(config).banded_params, align.Scoring(**config["scoring"])
    pairs = {"match": bp.score_match, "mismatch": bp.penalty_mismatch, "gap_open": bp.penalty_gap_open}
    wrong = [f"scoring.{k} {getattr(sc, k)} against banded_params {v}" for k, v in pairs.items()
             if getattr(sc, k) != v]
    if bp.penalty_gap_extend != 0:
        wrong.append(f"banded_params.penalty_gap_extend {bp.penalty_gap_extend}: the reference charges none")
    if not (bp.left_terminal_gaps_free and bp.right_terminal_gaps_free):
        wrong.append("banded_params end gaps not free: the reference's are")
    if wrong:
        raise ValueError(f"the check would not score as the build does: {'; '.join(wrong)}")


def records(genomes: list) -> list:
    from pangraph_tpu_torch.io.fasta import FastaRecord

    return [FastaRecord(seq_name=n, desc="", seq=s, index=i) for i, (n, s) in enumerate(genomes)]


def card_power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float, root: str = ROOT,
             device: str = "cuda", out=None) -> dict:
    """Run one cell and return its result (the JSON line's object), or
    raise. `device` other than "cuda" is for the tests: "cpu" runs the
    kernels' plain versions, None the host engine; such a run is no
    measurement and says so in `device`."""
    import torch

    from pangraph_tpu_torch.build.build import build
    from pangraph_tpu_torch.ops import stripe_v2
    from pangraph_tpu_torch.ops.batch_align import BatchAligner
    from port_bench import generators, tracing

    out = out or sys.stdout
    manifest, w, config, traffic = load_cell(workload, root)
    if traffic["kind"] != "build":
        raise ValueError(f"unknown job kind {traffic['kind']!r}")
    args = build_args(config)
    cuda = device == "cuda"
    aligner = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device=device)
    pool = generators.pool(config["genomes"], seed, traffic["pool_bp"], root)
    pool_recs = [records(g) for g in pool]
    pool_bp = [sum(len(s) for _n, s in g) for g in pool]
    bp_done = 0
    warm = records(generators.make(traffic["warmup"], seed, root))
    attempted = failed = 0
    error = None
    try:
        build(warm, args, aligner=aligner).to_json()
    except Exception as ex:  # a program that fails its warm-up build runs no window
        failed, error = 1, f"warm-up: {type(ex).__name__}: {ex}"
        say(error)
    BatchAligner.reset_engine_stats()
    stripe_v2.reset_launches()
    sample = AlignSample(aligner, seed, traffic["align_sample"], traffic["align_longest"])
    rec = tracing.TraceRecorder(aligner) if trace else None
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    graphs = []
    if rec:
        rec.start()
    sample.on = True
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0
    while not failed and time.perf_counter() - t0 < seconds:
        attempted += 1
        sample.job_no = attempted
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        tj = time.perf_counter()
        try:
            k = (attempted - 1) % len(pool)
            text = build(pool_recs[k], args, aligner=aligner).to_json()
            if cuda:
                torch.cuda.synchronize()
        except Exception as ex:  # a job that fails is counted and ends the window
            failed += 1
            error = f"{type(ex).__name__}: {ex}"
            say(f"job {attempted} failed: {error}")
            break
        t_end = time.perf_counter()
        jp = torch.cuda.max_memory_allocated() if cuda else 0
        peak = max(peak, jp)
        graphs.append((k, text))
        bp_done += pool_bp[k]
        print(json.dumps({"job": attempted, "input": k, "input_bp": pool_bp[k], "wall_s": t_end - tj,
                          "peak_device_bytes": jp,
                          "graph_sha256": hashlib.sha256(text.encode()).hexdigest()}), file=out, flush=True)
    sample.on = False
    window_s = t_end - t0
    done = len(graphs)
    record = rec.stop(done, window_s) if rec else None
    sample.remove()

    metrics = {}
    if trace:
        for m, read in readers(manifest, workload, root):
            v = read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in end_to_end(manifest, workload):
            v = {"input_bp_per_s": bp_done / window_s if window_s > 0 else 0.0,
                 "setup_s": setup_s}[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": w["chips"] if cuda else 0, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        busy = sum(b - a for a, b in tracing.busy(record))
        dev.update(busy_s=busy, window_s=window_s)
        ops = {}
        for l in record["launches"]:
            if "." not in l["name"]:
                ops[l["name"]] = ops.get(l["name"], 0.0) + l["end_s"] - l["start_s"]
        spans = sorted(record["spans"].items(), key=lambda kv: -kv[1])
        breakdown = {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:10],
                     "idle_gaps": [[k, v] for k, v in tracing.idle_by_span(record)[:10]]}

    # the program's state goes before the reference runs on the card
    kept = sample.sample()
    del aligner, sample, rec, record
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(config, pool, graphs, kept, "cuda" if cuda else "cpu")
    say(f"check: {len(graphs)} graphs, {len(kept)} alignments, {time.perf_counter() - t_check:.1f} s")
    correct = (failed == 0 and done > 0 and len(kept) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    result["run"] = {"workload": workload, "seed": seed, "seconds": seconds, "trace": int(trace), "jobs": done,
                     "inputs": len(pool), "input_bp_done": bp_done, "alignments_sampled": len(kept),
                     "window_s": window_s, "setup_s": setup_s,
                     "power_limit": card_power_limit() if cuda else None, "error": error}
    if trace:
        result["run"]["span_thread_s"] = [[k, v] for k, v in spans[:12]]
    result["checks"] = checks
    return result


def check(config: dict, pool: list, graphs: list, kept: list, device: str) -> dict:
    """The comparison that decides `correct`, each number beside its limit
    (pool: the run's inputs, each a list of (name, genome); graphs: (input
    index, JSON) of every job that completed):
    - genomes_mismatched: input genomes that their job's graph does not
      give back byte for byte (reference/graph.py);
    - alignments_invalid: sampled alignments whose edits do not turn the
      job's reference into its query;
    - alignment_gap_max: the most by which a sampled alignment scores below
      the best alignment within the job's band, narrowed by
      `band_shrink` and capped at `band_cap` (reference/align.py): the
      program's band holds that one, so a sound alignment never scores
      below it."""
    from port_bench.reference import align, graph

    g = config["guarantees"]
    t = time.perf_counter()
    mismatched = sum(graph.mismatched(text, dict(pool[k])) for k, text in graphs)
    say(f"genomes checked in {time.perf_counter() - t:.1f} s")
    sc = align.Scoring(**config["scoring"])
    extra = build_args(config).extra_band_width
    invalid, scored, jobs = 0, [], []
    for _key, ref, qry, ms, bw, edit in kept:
        ok, s = align.edit_score(ref, qry, edit, sc) if edit is not None else (False, None)
        if not ok:
            invalid += 1
        elif len(ref) and len(qry):
            W = min(bw + extra, g["band_cap"]) - g["band_shrink"]
            scored.append(s)
            jobs.append((ref, qry, ms, W))
        else:
            scored.append(s)  # an empty side: the free all-gap alignment, 0, is the best
            jobs.append(None)
    dp = [j for j in jobs if j is not None]
    best = iter(align.best_scores(dp, sc, device)) if dp else iter(())
    gap = None
    for s, j in zip(scored, jobs):
        b = int(next(best)) if j is not None else 0
        if b > align.NEG32 // 2:  # a band with no path from start to end bounds nothing
            gap = b - s if gap is None else max(gap, b - s)
    limits = g["limits"]
    checks = {
        "genomes_mismatched": {"value": mismatched, "limit": limits["genomes_mismatched"]},
        "alignments_invalid": {"value": invalid, "limit": limits["alignments_invalid"]},
        "alignment_gap_max": {"value": gap if gap is not None else 0, "limit": limits["alignment_gap_max"]},
    }
    return checks


def main(argv: list, t_start: float) -> int:
    p = argparse.ArgumentParser(prog="port_bench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        import torch
    except ImportError as ex:
        say(f"PyTorch is not importable: {ex}")
        return 2
    _manifest, w, _config, _traffic = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        say(f"{a.workload} needs {w['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if found:
        say(f"the run loaded {', '.join(found)}: the benchmark runs the PyTorch port alone")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
