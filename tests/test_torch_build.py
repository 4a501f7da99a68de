"""Whole builds through the port (pangraph_tpu_torch) held against the
reference (pangraph_tpu): graph JSON must be byte-equal when both sides
route their alignments alike.

- kernel route: the port's BatchAligner on device="cpu" (plain versions of
  the CUDA kernels) against the reference with NATIVE_CELL_BUDGET = 0 (the
  Pallas kernels in interpret mode);
- host route: both sides on the host C++ engine.

The port's build arguments are made from dataclasses.asdict of the
reference's, and graphs cross between the packages as graph JSON."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import pangraph_tpu_torch.align.params as port_params
from pangraph_tpu.align.params import AlignmentArgs, BuildArgs
from pangraph_tpu.build.build import build as ref_build
from pangraph_tpu.build.build import make_find_matches as ref_find_matches
from pangraph_tpu.build.merge import merge_graphs as ref_merge
from pangraph_tpu.commands import graph_quality as ref_graph_quality
from pangraph_tpu.graph.graph import Pangraph as RefPangraph
from pangraph_tpu.io.fasta import FastaRecord, write_fasta
from pangraph_tpu.ops.batch_align import TpuBatchAligner
from pangraph_tpu.utils.synth import make_accessory_pangenome, make_synthetic
from pangraph_tpu_torch.build.build import build as port_build
from pangraph_tpu_torch.build.build import make_find_matches as port_find_matches
from pangraph_tpu_torch.build.merge import merge_graphs as port_merge
from pangraph_tpu_torch.commands import graph_quality as port_graph_quality
from pangraph_tpu_torch.graph.graph import Pangraph as PortPangraph
from pangraph_tpu_torch.io.fasta import FastaRecord as PortRecord
from pangraph_tpu_torch.ops.batch_align import BatchAligner

ACGT = np.frombuffer(b"ACGT", np.uint8)


def genomes(rng, n=5, L=1800):
    """The genomes of tests/test_mesh_build_e2e.py: ~1% substitutions, small
    indels, one inversion."""
    base = ACGT[rng.integers(0, 4, L)]
    recs = []
    for i in range(n):
        g = base.copy()
        idx = rng.choice(L, L // 100, replace=False)
        g[idx] = ACGT[rng.integers(0, 4, len(idx))]
        g = list(g)
        for _ in range(2):
            p = int(rng.integers(100, len(g) - 100))
            if rng.random() < 0.5:
                del g[p : p + int(rng.integers(2, 12))]
            else:
                g[p:p] = list(ACGT[rng.integers(0, 4, int(rng.integers(2, 12)))])
        if i == n - 1:
            a, b = L // 3, L // 3 + 300
            comp = {65: 84, 84: 65, 67: 71, 71: 67}
            g[a:b] = [comp.get(int(c), int(c)) for c in g[a:b]][::-1]
        recs.append(FastaRecord(seq_name=f"g{i}", desc=None, seq=np.array(g, np.uint8), index=i))
    return recs


def port_args(args: BuildArgs) -> port_params.BuildArgs:
    d = dataclasses.asdict(args)
    aln, banded = d.pop("aln_args"), d.pop("banded_params")
    return port_params.BuildArgs(
        **d, aln_args=port_params.AlignmentArgs(**aln), banded_params=port_params.BandedAlignParams(**banded)
    )


def port_records(recs):
    return [PortRecord(seq_name=r.seq_name, desc=r.desc, seq=r.seq, index=r.index) for r in recs]


def graph_json(graph) -> str:
    return json.dumps(graph.to_json_dict(), sort_keys=True)


def ref_aligner(args, kernel_route: bool):
    al = TpuBatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts)
    if kernel_route:
        al.NATIVE_CELL_BUDGET = 0
    return al


def port_aligner(args, device):
    return BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device=device)


def test_kernel_route_build_is_byte_equal():
    recs = genomes(np.random.default_rng(42))
    args = BuildArgs(circular=False, verify=True, aln_args=AlignmentArgs())
    g_ref = ref_build(recs, args, aligner=ref_aligner(args, True))
    pargs = port_args(args)
    BatchAligner.reset_engine_stats()
    g_port = port_build(port_records(recs), pargs, aligner=port_aligner(pargs, "cpu"))
    assert graph_json(g_port) == graph_json(g_ref)
    assert BatchAligner.engine_report()["device_cells_frac"] == 1.0


def test_host_route_build_is_byte_equal():
    recs = make_synthetic(4, 40_000, seed=3)
    args = BuildArgs(circular=True, verify=True, jobs=2)
    g_ref = ref_build(recs, args, aligner=ref_aligner(args, False))
    pargs = port_args(args)
    g_port = port_build(port_records(recs), pargs, aligner=port_aligner(pargs, None))
    assert graph_json(g_port) == graph_json(g_ref)


# (records, circular) for graph_quality's parity: a mutation-only
# pangenome, an accessory one (blocks of every depth) and the inversion set
QUALITY_INPUTS = {
    "synthetic": (lambda: make_synthetic(4, 40_000, seed=3), True),
    "accessory": (lambda: make_accessory_pangenome(6, 60_000, seed=11), True),
    "inversion": (lambda: genomes(np.random.default_rng(42)), False),
}


@pytest.mark.parametrize("name", list(QUALITY_INPUTS))
def test_graph_quality_equals_the_reference(name):
    """The port's graph_quality (the figures chip_smoke holds the headline
    to) equals the reference's on graphs both packages build on the host
    route."""
    make, circular = QUALITY_INPUTS[name]
    recs = make()
    args = BuildArgs(circular=circular, jobs=2)
    g_ref = ref_build(recs, args, aligner=ref_aligner(args, False))
    pargs = port_args(args)
    g_port = port_build(port_records(recs), pargs, aligner=port_aligner(pargs, None))
    quality = port_graph_quality(g_port)
    assert quality == ref_graph_quality(g_ref)
    assert quality["input_bp"] == sum(len(r.seq) for r in recs) and quality["n_blocks"] > 0


def test_merge_of_reference_subgraphs():
    """Two subgraphs built by the reference, read by the port from their
    graph JSON and merged with the port's merge_graphs, give the reference's
    merge."""
    recs = make_synthetic(4, 20_000, seed=11)
    args = BuildArgs(circular=True)
    al = ref_aligner(args, False)

    def subgraph(a, b):
        singles = [RefPangraph.singleton(r.seq_name, r.seq, r.index, True, desc=r.desc) for r in (a, b)]
        return graph_json(ref_merge(*singles, args, ref_find_matches(args, al), al))

    left, right = subgraph(*recs[:2]), subgraph(*recs[2:])
    merged_ref = ref_merge(RefPangraph.from_json(left), RefPangraph.from_json(right), args,
                           ref_find_matches(args, al), al)
    pargs = port_args(args)
    pal = port_aligner(pargs, None)
    merged_port = port_merge(PortPangraph.from_json(left), PortPangraph.from_json(right), pargs,
                             port_find_matches(pargs, pal), pal)
    assert graph_json(merged_port) == graph_json(merged_ref)
    assert graph_json(PortPangraph.from_json(left)) == left


@pytest.mark.parametrize("route", ["kernel", "host", "numpy"])
def test_cli_build_matches_reference_cli(tmp_path, monkeypatch, route):
    """`python -m pangraph_tpu_torch.cli build` writes the same graph file as
    the reference CLI on the same FASTA (--device cpu against the reference
    kernel route; --no-tpu on both sides, with the host C++ engine, and
    without it, where both align with the numpy aligner)."""
    import pangraph_tpu.native as ref_native
    import pangraph_tpu_torch.native as port_native
    from pangraph_tpu.cli import main as ref_main
    from pangraph_tpu_torch.cli import main as port_main

    fa = tmp_path / "in.fa"
    write_fasta(str(fa), genomes(np.random.default_rng(7), n=3, L=900))
    common = ["build", str(fa), "--no-progress-bar", "-f"]
    if route == "kernel":
        monkeypatch.setattr(TpuBatchAligner, "NATIVE_CELL_BUDGET", 0)
        ref_extra, port_extra = ["--devices", "1"], ["--device", "cpu"]
    else:
        ref_extra = port_extra = ["--no-tpu"]
    if route == "numpy":  # no C++ toolchain on either side
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
        monkeypatch.setattr(port_native, "get_lib", lambda: None)
    TpuBatchAligner.reset_engine_stats()
    BatchAligner.reset_engine_stats()
    assert ref_main([*common, "-o", str(tmp_path / "ref.json"), *ref_extra]) == 0
    assert port_main([*common, "-o", str(tmp_path / "port.json"), *port_extra]) == 0
    frac = {"kernel": 1.0, "host": 0.0, "numpy": None}[route]  # the numpy path counts no cells
    assert TpuBatchAligner.engine_report()["device_cells_frac"] == frac
    assert BatchAligner.engine_report()["device_cells_frac"] == frac
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


def test_build_without_an_aligner_runs_on_the_card(monkeypatch):
    """build() with no aligner builds one for the card: where there is no
    CUDA device it raises, and does not run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recs = port_records(genomes(np.random.default_rng(3), n=2, L=600))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_build(recs, port_args(BuildArgs()))
