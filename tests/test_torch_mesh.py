"""The port's mesh (pangraph_tpu_torch/parallel/mesh.py and
`BatchAligner(..., mesh=...)`) held against its one-device aligner and
against the reference's mesh path, on the CPU.

Like routing on both sides: the port's BatchAligner on device="cpu" (the
plain versions of the CUDA kernels) over a mesh of CPU shards, and the
reference's TpuBatchAligner with NATIVE_CELL_BUDGET = 0 (the Pallas kernels
in interpret mode, shard_map over conftest's 8 virtual CPU devices).
Equality everywhere: Edits element for element, graph JSON byte for byte.
The jobs and genomes are those of tests/test_mesh_align.py and
tests/test_mesh_build_e2e.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pangraph_tpu.align.params import AlignmentArgs, BuildArgs
from pangraph_tpu.align.params import BandedAlignParams as RefParams
from pangraph_tpu.align.params import BandParameters as RefBand
from pangraph_tpu.build.build import build as ref_build
from pangraph_tpu.io.fasta import write_fasta
from pangraph_tpu.ops.batch_align import AlignJob as RefJob
from pangraph_tpu.ops.batch_align import TpuBatchAligner
from pangraph_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pangraph_tpu_torch.align.params import BandedAlignParams, BandParameters
from pangraph_tpu_torch.build.build import build as port_build
from pangraph_tpu_torch.cli import main as port_main
from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner
from pangraph_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_jobs
from test_torch_build import genomes, graph_json, port_args, port_records

ACGT = np.frombuffer(b"ACGT", np.uint8)


def mesh_jobs():
    """tests/test_mesh_align.py's 11 jobs: 300 bp pairs, 10 substitutions."""
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(11):
        ref = ACGT[rng.integers(0, 4, 300)]
        qry = ref.copy()
        idx = rng.choice(300, 10, replace=False)
        qry[idx] = ACGT[rng.integers(0, 4, 10)]
        jobs.append((ref, qry))
    return jobs


def as_tuples(edit):
    return (
        [(x.pos, x.alt) for x in edit.subs],
        [(x.pos, x.len) for x in edit.dels],
        [(x.pos, x.seq) for x in edit.inss],
    )


@pytest.mark.parametrize("route", ["stripe", "ckpt"])
def test_mesh_align_matches_one_device_and_reference(route):
    jobs = mesh_jobs()
    ckpt_bytes = 0 if route == "ckpt" else None
    port_jobs = [AlignJob(r, q, BandParameters(0, 40)) for r, q in jobs]
    one = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=ckpt_bytes).align_many(port_jobs)
    BatchAligner.reset_engine_stats()
    sharded = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=ckpt_bytes,
                           mesh=make_mesh(8, device="cpu"))
    port = sharded.align_many(port_jobs)
    report = BatchAligner.engine_report()
    ref_al = TpuBatchAligner(RefParams(), 5, 4, mesh=ref_make_mesh(8))
    ref_al.NATIVE_CELL_BUDGET = 0
    if route == "ckpt":
        ref_al.CKPT_PATHS_BYTES = 0
    ref = ref_al.align_many([RefJob(r, q, RefBand(0, 40)) for r, q in jobs])
    for (r, q), a, b, c in zip(jobs, port, one, ref):
        assert as_tuples(a) == as_tuples(b) == as_tuples(c)
        assert np.array_equal(a.apply(r), q)
    # the one launch of 11 problems ran on all 8 shards, on the route asked for
    assert sorted(report["device_shards"]) == [f"{s}:cpu" for s in range(8)]
    assert list(report["device_routes"]) == [route]


@pytest.fixture(scope="module")
def one_device_graphs():
    """The genomes of tests/test_mesh_build_e2e.py, built by the port on one
    device and by the reference on a mesh of 2 virtual devices."""
    recs = genomes(np.random.default_rng(42))
    args = BuildArgs(circular=False, verify=True, aln_args=AlignmentArgs())
    ref_al = TpuBatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts,
                             mesh=ref_make_mesh(2))
    ref_al.NATIVE_CELL_BUDGET = 0
    g_ref = graph_json(ref_build(recs, args, aligner=ref_al))
    pargs = port_args(args)
    al = BatchAligner(pargs.banded_params, pargs.extra_band_width, pargs.max_alignment_attempts, device="cpu")
    g_one = graph_json(port_build(port_records(recs), pargs, aligner=al))
    return recs, pargs, g_ref, g_one


@pytest.mark.parametrize("shards", [2, 8])
def test_mesh_build_is_byte_equal(one_device_graphs, shards):
    recs, pargs, g_ref, g_one = one_device_graphs
    BatchAligner.reset_engine_stats()
    al = BatchAligner(pargs.banded_params, pargs.extra_band_width, pargs.max_alignment_attempts, device="cpu",
                      mesh=make_mesh(shards, device="cpu"))
    g = graph_json(port_build(port_records(recs), pargs, aligner=al))
    assert g == g_one
    assert g == g_ref
    report = BatchAligner.engine_report()
    assert report["device_cells_frac"] == 1.0
    # the build's launches hold 1-3 problems, so at most 3 shards take any
    assert 2 <= len(report["device_shards"]) <= min(shards, 3)
    assert sum(s["cells"] for s in report["device_shards"].values()) == report["device"]["cells"]


def test_cli_devices_on_the_cpu(tmp_path):
    """`build --device cpu --devices 2` writes the one-device graph, and
    --no-tpu ignores the flag."""
    fa = tmp_path / "in.fa"
    write_fasta(str(fa), genomes(np.random.default_rng(7), n=3, L=900))
    outs = {}
    for name, flags in {"one": [], "two": ["--devices", "2"], "host": ["--no-tpu", "--devices", "99"]}.items():
        outs[name] = tmp_path / f"{name}.json"
        dev = [] if name == "host" else ["--device", "cpu"]
        BatchAligner.reset_engine_stats()
        assert port_main(["build", str(fa), "-f", "--no-progress-bar", *dev, *flags, "-o", str(outs[name])]) == 0
        if name == "two":
            assert sorted(BatchAligner.engine_report()["device_shards"]) == ["0:cpu", "1:cpu"]
    assert outs["two"].read_bytes() == outs["one"].read_bytes()
    assert outs["host"].exists()


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_cli_too_many_devices_exits_1(tmp_path, monkeypatch, capsys, device):
    """More devices than there are: one line, exit 1, before any aligner is
    built (the card patched to one visible device)."""
    import os

    import pangraph_tpu_torch.ops.batch_align as ba

    def no_aligner(*a, **k):
        raise AssertionError("an aligner was built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(ba.BatchAligner, "__init__", no_aligner)
    fa = tmp_path / "in.fa"
    fa.write_text(">a\nACGTACGTACGT\n>b\nACGTACGTACGT\n")
    n = 99 if device == "cuda" else (os.cpu_count() or 1) + 1
    out = tmp_path / "g.json"
    assert port_main(["build", str(fa), "--device", device, "--devices", str(n), "-o", str(out)]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and f"--devices {n}: only" in err[0]
    assert not out.exists()


def test_shard_jobs_interleaves_and_skips_empty_shards():
    mesh = make_mesh(3, device="cpu")
    idxs = [7, 3, 9, 0, 5, 1, 8, 2, 6, 4]  # a launch, sorted longest first
    parts = shard_jobs(mesh, idxs)
    assert parts == [(0, [7, 0, 8, 4]), (1, [3, 5, 2]), (2, [9, 1, 6])]
    assert sorted(i for _, part in parts for i in part) == sorted(idxs)
    assert shard_jobs(mesh, [4, 2]) == [(0, [4]), (1, [2])]
    assert shard_jobs(mesh, []) == []
    # on the aligner: 3 jobs over 8 shards launch on 3 of them
    BatchAligner.reset_engine_stats()
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", mesh=make_mesh(8, device="cpu"))
    jobs = mesh_jobs()[:3]
    al.align_many([AlignJob(r, q, BandParameters(0, 40)) for r, q in jobs])
    assert sorted(BatchAligner.engine_report()["device_shards"]) == ["0:cpu", "1:cpu", "2:cpu"]


def test_mesh_and_device_must_agree():
    mesh = make_mesh(2, device="cpu")
    assert mesh == Mesh((torch.device("cpu"),) * 2) and mesh.size == 2 and mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="needs device='cpu'"):
        BatchAligner(device=None, mesh=mesh)
    with pytest.raises(ValueError, match="of one type"):
        Mesh((torch.device("cpu"), torch.device("meta")))
