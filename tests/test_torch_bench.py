"""The port's bench (pangraph_tpu_torch/bench.py) held against the
reference's (bench.py at the repo root): the same per-workload report and
align receipts on the same build, the round-level cell count, the repeats'
graph hash, and the one JSON line of `main` on the CPU with tiny inputs.
Importing the root `bench` reads no data; only its `main` does."""
from __future__ import annotations

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import bench as ref_bench
import chip_smoke
import pangraph_tpu_torch.align.params as port_params
from pangraph_tpu.align.params import BuildArgs
from pangraph_tpu.utils.synth import make_synthetic
from pangraph_tpu_torch import bench
from pangraph_tpu_torch.io.fasta import write_fasta
from pangraph_tpu_torch.ops.batch_align import BatchAligner
from pangraph_tpu_torch.utils.synth import make_synthetic as port_synthetic
from test_torch_build import genomes, port_aligner, port_args, port_records, ref_aligner

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_json_keys() -> tuple:
    """The top-level and `detail` keys of the JSON line that the reference's
    bench.py prints, read from its source (its main cannot run here)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Dict) and any(getattr(k, "value", None) == "metric" for k in node.keys):
            top = [k.value for k in node.keys]
            detail = node.values[top.index("detail")]
            return set(top), {k.value for k in detail.keys}
    raise AssertionError("no JSON line in bench.py's main")


@pytest.fixture(scope="module")
def host_route_builds():
    """make_synthetic(4, 40_000, seed=3) through both benches' timed_build
    on the host route, one repeat with stats."""
    recs = make_synthetic(4, 40_000, seed=3)
    args = BuildArgs(circular=True, jobs=2)
    ref = ref_bench.timed_build(recs, args, ref_aligner(args, False), repeats=1, stats=True)
    pargs = port_args(args)
    precs = port_records(recs)
    port = bench.timed_build(precs, pargs, port_aligner(pargs, None), repeats=1, stats=True)
    return recs, precs, ref, port


def test_workload_report_equals_the_reference(host_route_builds):
    recs, precs, (_dt, g_ref, _a), (_pdt, g_port, _pa, _runs) = host_route_builds
    assert bench.workload_report(precs, 1.0, g_port) == ref_bench.workload_report(recs, 1.0, g_ref)


def test_timed_build_cells_equal_the_reference(host_route_builds):
    _recs, _precs, (_dt, _g, ref_align), (_pdt, _pg, align, runs) = host_route_builds
    assert align["dp_cells"] == ref_align["dp_cells"] > 0
    assert align["aligned_ref_bp"] == ref_align["aligned_ref_bp"] > 0
    assert set(ref_align) <= set(align)
    assert align["engines"]["device_cells_frac"] == 0.0
    assert align["kernel_ms"] == "not measured" and "peak_device_bytes" not in runs


def test_dp_cells_count_round_level_rows_only():
    """On the kernel route each device leg's cells are in its round's row,
    again in its launch groups' "device.*" rows and again in its combined
    round's "broker[...]" row; dp_cells sums the round-level rows alone."""
    args = port_params.BuildArgs(jobs=2)
    precs = port_records(genomes(np.random.default_rng(42)))
    _dt, _g, align, _runs = bench.timed_build(precs, args, port_aligner(args, "cpu"), repeats=1, stats=True)
    stats = list(BatchAligner.STATS)
    rounds = [s for s in stats if s[0] == "host" or s[0].startswith("mixed[")]
    assert rounds and align["dp_cells"] == sum(s[2] for s in rounds)
    assert any(s[0].startswith("broker[") for s in stats)
    assert align["dp_cells"] < sum(s[2] for s in stats)
    assert align["engines"]["device_cells_frac"] == 1.0
    assert align["launches"] == {"stripe_dp": 0, "walk": 0, "stripe_dp_ckpt": 0, "walk_ckpt": 0, "decode_events": 0}


def test_repeats_share_one_graph_hash(monkeypatch):
    args = port_params.BuildArgs(circular=True, jobs=2)
    recs = port_synthetic(3, 5000, seed=5)
    al = port_aligner(args, None)
    _dt, graph, _a, runs = bench.timed_build(recs, args, al, repeats=2)
    assert runs["graph_sha256"] == bench.graph_sha256(graph) and len(runs["graph_sha256"]) == 64
    assert runs["graph_sha256s"] == [runs["graph_sha256"]] * 2 and runs["distinct_graphs"] == 1
    assert len(runs["walls_s"]) == len(runs["max_rss_bytes"]) == 2

    real_build, calls = bench.build, []

    def other_graph_second_time(records, build_args, aligner=None):
        calls.append(1)
        if len(calls) == 2:
            records = port_synthetic(3, 5000, seed=6)
        return real_build(records, build_args, aligner=aligner)

    monkeypatch.setattr(bench, "build", other_graph_second_time)
    with pytest.raises(AssertionError, match="repeats differ"):
        bench.timed_build(recs, args, al, repeats=2)


@pytest.mark.parametrize("case", ["hashes", "roundtrip", "quality"])
def test_gated_repeats_check_every_graph(monkeypatch, case):
    """Under a host-leg budget on a device the adaptive split routes by
    measured walls, so repeats may give other graphs: timed_build reports
    every repeat's hash and the count of distinct ones instead of raising,
    and holds every repeat to an exact roundtrip and to the first repeat's
    quality within QUALITY_TOLERANCE, the limits chip_smoke's check_quality
    holds the headline to."""
    chip_smoke.check_quality("test", bench.HEADLINE_QUALITY)
    with pytest.raises(AssertionError, match="beyond"):
        chip_smoke.check_quality("test", {**bench.HEADLINE_QUALITY, "n_blocks": 2 * bench.HEADLINE_QUALITY["n_blocks"]})
    monkeypatch.setattr(BatchAligner, "NATIVE_CELL_BUDGET", 1000)
    args = port_params.BuildArgs(circular=True, jobs=2)
    recs = port_synthetic(2, 1500, seed=1)
    al = port_aligner(args, "cpu")
    assert al.gated()
    calls = []
    if case == "hashes":
        hashes = iter(["a" * 64, "b" * 64])
        monkeypatch.setattr(bench, "graph_sha256", lambda graph: next(hashes))
    real_build, real_quality = bench.build, bench.graph_quality

    def second_is_other(records, build_args, aligner=None):
        calls.append(1)
        if case == "roundtrip" and len(calls) == 2:
            records = port_synthetic(2, 1500, seed=2)
        return real_build(records, build_args, aligner=aligner)

    def second_is_off(graph):
        q = real_quality(graph)
        return {**q, "n_blocks": q["n_blocks"] * 2} if len(calls) == 2 else q

    if case != "hashes":
        monkeypatch.setattr(bench, "build", second_is_other)
        monkeypatch.setattr(bench, "graph_quality", second_is_off)
    if case == "hashes":
        _dt, _g, _a, runs = bench.timed_build(recs, args, al, repeats=2)
        assert runs["graph_sha256s"] == ["a" * 64, "b" * 64] and runs["distinct_graphs"] == 2
        assert runs["graph_sha256"] == "b" * 64
    else:
        with pytest.raises(AssertionError, match="Roundtrip" if case == "roundtrip" else "quality is off"):
            bench.timed_build(recs, args, al, repeats=2)


def test_gated_line_carries_the_gate_receipts(monkeypatch, capsys):
    """Under a budget the line carries the headline's gate receipts, and the
    headline runs on an aligner of its own, not the warm-up's, so its rates
    are measured afresh."""
    _tiny_table(monkeypatch)
    made = []
    real_init = BatchAligner.__init__

    def counting_init(self, *a, **k):
        made.append(self)
        real_init(self, *a, **k)

    monkeypatch.setattr(BatchAligner, "__init__", counting_init)
    assert bench.main(["--device", "cpu", "--repeats", "2", "--native-budget", "1e8",
                       "--workload", bench.HEADLINE]) == 0
    line = json.loads(capsys.readouterr().out)
    rep = line["detail"][bench.HEADLINE]
    assert line["gate"] == rep["align"]["engines"]["gate"]
    assert line["gate"]["rounds"] and set(line["gate"]["rounds"]) <= set(BatchAligner.GATE_KINDS)
    assert len(rep["graph_sha256s"]) == 2 and rep["distinct_graphs"] >= 1 and rep["roundtrip"] == "exact"
    assert len(made) == 2 and made[0] is not made[1]  # the warm-up's and the headline's own


def test_device_cuda_without_cuda_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--device", "cuda"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def _tiny_table(monkeypatch, make=None, host=False):
    tiny = make or (lambda: port_synthetic(2, 1500, seed=1))
    W = bench.Workload
    monkeypatch.setattr(bench, "WORKLOADS", {
        bench.SYNTH: W(tiny, jobs=2, repeats=2, host=host, host_scaling=True),
        "chromosome_scale_4x2.5Mbp_mutation_only": W(tiny, jobs=2, repeats=2, host=host),
        "russian_doll_plasmids": W(None, jobs=2, repeats=3, option="plasmids"),
        "real_plasmids_15x": W(None, jobs=2, repeats=2, option="plasmids15"),
        bench.HEADLINE: W(tiny, jobs=2, repeats=3, host=host),
        bench.HEADLINE + "_host": W(tiny, jobs=2, repeats=2, host=True),
    })


def test_main_prints_the_reference_json_line(tmp_path, monkeypatch, capsys):
    _tiny_table(monkeypatch)
    fa = tmp_path / "plasmids.fa"
    write_fasta(str(fa), port_synthetic(2, 1200, seed=9))
    budget = BatchAligner.NATIVE_CELL_BUDGET
    assert bench.main(["--device", "cpu", "--repeats", "1", "--native-budget", "1000", "--plasmids", str(fa)]) == 0
    assert BatchAligner.NATIVE_CELL_BUDGET == budget
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    top, detail = _reference_json_keys()
    assert top <= set(line) and {"device", "native_budget", "workload"} <= set(line)
    assert detail <= set(line["detail"])
    assert line["metric"] == "graph_build_input_bp_per_s" and line["unit"] == "bp/s"
    assert line["workload"] == bench.HEADLINE and line["value"] == line["detail"][bench.HEADLINE]["bp_per_s"]
    assert line["device"]["platform"] == "cpu" and line["native_budget"] == 1000
    d = line["detail"]
    assert d["device_kernel_probe"] == "not measured"
    assert d["real_plasmids_15x"] is None and "--plasmids15" in d["not_run"]["real_plasmids_15x"]
    for name in (bench.HEADLINE, bench.HEADLINE + "_host", bench.SYNTH, "chromosome_scale_4x2.5Mbp_mutation_only",
                 "russian_doll_plasmids"):
        rep = d[name]
        assert rep["roundtrip"] == "exact" and rep["align"]["dp_cells"] > 0 and len(rep["walls_s"]) == 1
        assert rep["route"] == ("host" if name.endswith("_host") else "cpu")
    assert set(d[bench.SYNTH]["host_scaling"]) == {"serial_wall_s", "parallel_wall_s", "speedup", "host_cores"}
    assert d["warmup"]["workload"] == bench.SYNTH


def test_a_failed_workload_exits_1_and_names_it(monkeypatch, capsys):
    _tiny_table(monkeypatch, host=True)
    W = bench.Workload

    def no_input():
        raise RuntimeError("no input for this one")

    monkeypatch.setitem(bench.WORKLOADS, bench.HEADLINE, W(no_input, jobs=2, repeats=3, host=True))
    assert bench.main(["--device", "cpu", "--repeats", "1"]) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert f"FAILED: workload {bench.HEADLINE}: no input for this one" in err


def test_probe_alone_off_the_card(monkeypatch, capsys):
    def never():
        raise AssertionError("built a workload that was not selected")

    _tiny_table(monkeypatch, make=never)
    assert bench.main(["--workload", "device_kernel_probe", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["value"] is None and line["workload"] is None
    assert line["detail"]["device_kernel_probe"] == "not measured" and "warmup" not in line["detail"]
    assert line["detail"]["not_run"][bench.HEADLINE] == "not selected (--workload)"
    assert bench.device_kernel_probe("cpu") is None


def test_probe_shape_and_bound():
    """The probe's inputs are the reference probe's, and its dependency
    bound is chip_smoke's DP rule at B 128 (0.598 ms for 8,000 rows)."""
    assert bench.DP_ROW_CYCLES_B128 == chip_smoke.dp_row_cycles(128)
    assert bench.SM_CLOCK_HZ == chip_smoke.SM_CLOCK_HZ
    ref_seq, qry_seq, rlen, qlen, ms, W = bench._probe_inputs(4)
    L = bench.PROBE_L
    assert ref_seq.shape == (4, bench.PROBE_R_CAP) and qry_seq.shape == (4, bench.PROBE_R_CAP + bench.PROBE_B)
    assert (rlen == L).all() and (qlen == L).all() and (ms == 0).all() and (W == 63).all()
    subs = (ref_seq[:, :L] != qry_seq[:, :L]).sum(axis=1)
    assert (subs <= L // 100).all() and (subs > L // 200).all()
    assert not ref_seq[:, L:].any() and not qry_seq[:, L:].any()
    assert round(L * bench.DP_ROW_CYCLES_B128 / bench.SM_CLOCK_HZ * 1e3, 3) == 0.598
