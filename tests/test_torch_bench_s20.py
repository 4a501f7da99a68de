"""The benchmark's `ecoli10-build-s20` cell (upstream's `-c -b 5 -s 20 -l
100` preset on a stand-in with divergent alleles): its generator, its
configuration, a cut-down run judged by the plain reference, the tie from
the preset to a smaller pangenome, and the aligner's counter of the host
engine's DP cells by reason that two of its per-layer metrics read."""
import importlib
import inspect
import json
import os

import numpy as np
import pytest

from pangraph_tpu_torch.align.params import AlignmentArgs, BandedAlignParams, BandParameters
from pangraph_tpu_torch.build.build import build
from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner
from port_bench import generators, harness
from port_bench.tiny import tiny_root

CELL = "ecoli10-build-s20"
MANIFEST = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
div = importlib.import_module("port_bench.genomes.divergent_pangenome")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _spec(n, length, **kw):
    return {"generator": "divergent_pangenome", "n_genomes": n, "genome_len": length, **kw}


# ------------------------------------------------------------ the generator


@pytest.mark.parametrize("seed", [5, 2**31 + 11, [7, 3]])
def test_divergent_pangenome_is_deterministic_by_seed(seed):
    a = generators.make(_spec(3, 20_000), seed)
    b = generators.make(_spec(3, 20_000), seed)
    other = generators.make(_spec(3, 20_000), 99)
    assert [n for n, _ in a] == ["div_0", "div_1", "div_2"]
    for (_n, x), (_m, y), (_o, z) in zip(a, b, other):
        assert x.dtype == np.uint8 and np.array_equal(x, y) and not np.array_equal(x, z)
        assert set(np.unique(x).tobytes()) <= set(b"ACGT")


def test_the_configuration_holds_the_generators_defaults():
    """The configuration's `genomes` states every allele parameter, at the
    generator's defaults, and its genomes come out near ecoli10's 46 Mbp
    shape (checked here at a 100th of the length)."""
    _m, _w, config, _t = harness.load_cell(CELL)
    g = config["genomes"]
    defaults = {k: v.default for k, v in inspect.signature(div.make).parameters.items()
                if k.startswith("allele")}
    assert {k: g[k] for k in defaults} == defaults
    got = generators.make({**g, "genome_len": 46_000}, 3)
    assert len(got) == 10 and 0.9 * 460_000 < sum(len(s) for _n, s in got) < 1.1 * 460_000


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_two_alleles_of_a_segment_lie_within_the_stated_divergence(seed):
    """Before `mutate`: each allele differs from its ancestor at int(L *
    rate) positions, rate in [0.02, 0.10], and two alleles from each other
    at 2-20 % of their positions (counted with substitutions alone, so
    that the count is positional); with the default indels each allele's
    length stays within 11 bp per indel of the ancestor's."""
    rng = np.random.default_rng(seed)
    L = 8_000
    anc = ACGT[rng.integers(0, 4, L)]
    subs_only = div.alleles(anc, rng, 4, 0.02, 0.10, 0.0)
    for a in subs_only:
        assert len(a) == L and int(0.02 * L) <= int((a != anc).sum()) <= 0.10 * L
    for i in range(len(subs_only)):
        for j in range(i + 1, len(subs_only)):
            d = (subs_only[i] != subs_only[j]).mean()
            assert 0.02 <= d <= 0.20
    for a in div.alleles(anc, rng, 4, 0.02, 0.10, 0.1):
        assert abs(len(a) - L) <= 11 * round(0.10 * L * 0.1)


# ------------------------------------------------------------ the cell


def test_the_cell_loads_with_upstreams_sensitive_preset():
    _m, w, config, traffic = harness.load_cell(CELL)
    assert w["chips"] == 1 and w["traffic"] == "build" and config["reduced"] == []
    args = harness.build_args(config)
    assert args.aln_args == AlignmentArgs(sensitivity=20, beta=5.0, indel_len_threshold=100)
    assert (args.circular, args.jobs, args.max_self_map, args.extra_band_width) == (True, 4, 100, 5)
    assert config["guarantees"]["limits"] == {"genomes_mismatched": 0, "alignments_invalid": 0,
                                              "alignment_gap_max": 0}
    assert traffic == harness.load_cell("ecoli10-build")[3]


def test_the_cell_reports_every_per_layer_metric_it_reads():
    names = [m["name"] for m, _r in harness.readers(MANIFEST, CELL)]
    assert names == [p["name"] for p in MANIFEST["per_layer"]]
    assert names[-2:] == ["align.host_past_clamp_frac", "align.native_s"]


@pytest.fixture
def one_torch_thread():
    """The plain kernels and the check's DP on one thread: the suite runs
    in several worker processes at once."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_the_cut_cell_runs_and_is_judged_correct(tmp_path, one_torch_thread, device):
    root = tiny_root(str(tmp_path), 4, 2000)
    traffic = os.path.join(root, "port_bench", "traffic", "build.json")
    t = harness.load_json(traffic)
    t["warmup"].update(n_genomes=2, genome_len=1000)  # the kernels' plain versions are slow on the CPU
    with open(traffic, "w") as f:
        json.dump(t, f)
    with open(os.devnull, "w") as null:
        r = harness.run_cell(CELL, 2**31 + 21, 0.2, True, 0.0, root=root, device=device, out=null)
    assert r["correct"] and r["run"]["jobs"] >= 1 and r["failed"] == 0
    assert {k: c["value"] for k, c in r["checks"].items()} == {"genomes_mismatched": 0, "alignments_invalid": 0,
                                                                "alignment_gap_max": 0}
    assert "align.host_past_clamp_frac" in r["metrics"]
    if device is None:  # every job on the host engine
        assert r["metrics"]["align.native_s"]["value"] > 0
        assert r["metrics"]["align.device_cells_frac"]["value"] == 0


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_s20_merges_what_s10_keeps_apart(seed):
    """The configuration's preset does what it is chosen for: on the same
    divergent genomes, -s 20 -b 5 gives a smaller pangenome (the blocks'
    consensus bases) than upstream's default -s 10 -b 10."""
    config = harness.load_cell(CELL)[2]
    genomes = generators.make(_spec(4, 300_000), seed)
    sizes = {}
    for s, b in ((10, 10.0), (20, 5.0)):
        args = harness.build_args({**config, "build_args": {**config["build_args"],
                                                            "aln_args": {"sensitivity": s, "beta": b}}})
        al = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device=None)
        g = build(harness.records(genomes), args, aligner=al)
        sizes[s] = sum(len(bl.consensus) for bl in g.blocks.values())
    assert sizes[20] < sizes[10]


# ------------------------------------------------- host cells by reason

def _pair(n, seed, cut=None):
    rng = np.random.default_rng(seed)
    r = ACGT[rng.integers(0, 4, n)]
    q = r.copy()
    q[rng.choice(n, n // 50, replace=False)] = ACGT[rng.integers(0, 4, n // 50)]
    return (r, q if cut is None else np.concatenate([q[: cut[0]], q[cut[1]:]]))


def _jobs(case):
    """Jobs that send cells to the host engine for the reason `case`."""
    if case == "past_clamp":  # a first band past the kernels' widest, W 1105
        return [AlignJob(*_pair(2500, 1), BandParameters(0, 1100)), AlignJob(*_pair(900, 2), BandParameters(0, 10))]
    if case == "plan.corner":  # 1,200 bases deleted: the end corner lies past the widest band
        return [AlignJob(*_pair(3000, 3, (1000, 2200)), BandParameters(0, 30)),
                AlignJob(*_pair(900, 4), BandParameters(0, 10))]
    if case == "plan.ckpt_events":  # the checkpoint route with more events than its cap
        return [AlignJob(*_pair(1200, 5), BandParameters(0, 10), BatchAligner.CKPT_K_CAP)]
    return [AlignJob(*_pair(n, n), BandParameters(0, 10)) for n in (600, 900)]


CASES = {"past_clamp": {}, "plan.corner": {}, "plan.ckpt_events": {"ckpt_paths_bytes": 0},
         "no_device": {"device": None}, "fill": {}}


@pytest.mark.parametrize("case", list(CASES))
def test_host_reasons_add_up_to_the_host_cells(monkeypatch, case):
    if case == "fill":  # a host leg whose budget takes every job
        monkeypatch.setattr(BatchAligner, "NATIVE_CELL_BUDGET", 10**12)
    kw = {"device": "cpu", **CASES[case]}
    al = BatchAligner(BandedAlignParams(), 5, 4, **kw)
    BatchAligner.reset_engine_stats()
    jobs = _jobs(case)
    edits = al.align_many(jobs)
    for j, e in zip(jobs, edits):
        assert np.array_equal(e.apply(j.ref), j.qry)
    rep = BatchAligner.engine_report()
    reasons, plan = rep["host_reasons"], rep["host_plan"]
    assert rep["host"]["cells"] > 0 and sum(reasons.values()) == rep["host"]["cells"]
    assert sum(plan.values()) == reasons["plan"]
    key, _, sub = case.partition(".")
    assert reasons[key] > 0 and (not sub or plan[sub] == reasons["plan"])
    assert all(v == 0 for k, v in reasons.items() if k not in (key, "exhausted"))
    if case == "past_clamp":
        assert reasons["past_clamp"] >= BatchAligner._job_cells(jobs[0], 1105)
        assert rep["device"]["cells"] > 0
    BatchAligner.reset_engine_stats()
    rep = BatchAligner.engine_report()
    assert set(rep["host_reasons"].values()) == {0} and set(rep["retries"].values()) == {0}


def test_retries_are_counted_by_cause():
    """A 63 bp deletion made up 600 bp later under a 20 bp band widens; an
    indel every 12 bp of 3.6 kb overflows the first event capacity."""
    rng = np.random.default_rng(23)
    r = ACGT[rng.integers(0, 4, 1600)]
    q = np.concatenate([r[:500], r[563:1100], ACGT[rng.integers(0, 4, 63)], r[1100:]])
    r2 = ACGT[rng.integers(0, 4, 3600)]
    parts = [np.append(r2[p : p + 12], ACGT[rng.integers(0, 4, 1)]) if k % 2 else r2[p : p + 11]
             for k, p in enumerate(range(0, 3600, 12))]
    jobs = [AlignJob(r, q, BandParameters(0, 20)), AlignJob(r2, np.concatenate(parts), BandParameters(0, 12))]
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    BatchAligner.reset_engine_stats()
    for j, e in zip(jobs, al.align_many(jobs)):
        assert np.array_equal(e.apply(j.ref), j.qry)
    retries = BatchAligner.engine_report()["retries"]
    assert retries["widened"] >= 1 and retries["k_bumped"] >= 1


# ------------------------------------------------------------ the readers


def _readers():
    return {m["name"]: read for m, read in harness.readers(MANIFEST, CELL)}


def _record(reasons=True, spans=True):
    engine = {"host": {"cells": 40}, "device": {"cells": 60}}
    if reasons:
        engine["host_reasons"] = {"fill": 0, "past_clamp": 25, "plan": 15, "probe_wait": 0, "no_device": 0,
                                  "exhausted": 0}
    ivs = [("align.native", 1, 0.0, 2.0), ("align.host_fallback", 1, 0.5, 1.0),
           ("align.host_fallback", 2, 1.0, 1.5), ("align.wait", 3, 0.0, 4.0)] if spans else []
    return {"jobs": 2, "window_s": 5.0, "spans": {}, "span_intervals": ivs, "launches": [], "dp_problems": [],
            "engine": engine}


def test_the_readers_read_the_counter_and_the_host_engines_spans():
    read = _readers()
    assert read["align.host_past_clamp_frac"](_record()) == pytest.approx(0.25)
    # thread 1's fallback inside its host round counts once: (2.0 + 0.5) / 2 jobs
    assert read["align.native_s"](_record()) == pytest.approx(1.25)


def test_the_readers_report_nothing_without_their_counter_or_spans():
    read = _readers()
    assert read["align.host_past_clamp_frac"](_record(reasons=False)) is None
    assert read["align.native_s"](_record(spans=False)) is None
