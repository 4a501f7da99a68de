"""The port's multi-process layer (pangraph_tpu_torch/parallel/distributed.py)
on the CPU: torch.distributed on gloo, the merge tree split through the TCP
coordinator, each worker's launches split over its own mesh of CPU shards
(the plain versions of the kernels).

Mirrors tests/test_distributed.py (2 processes x 4 shards on the
reference's 6 x 900 bp workload), and holds the cluster's graph against a
solo port build of the same records, byte for byte."""
from __future__ import annotations

import socket

from pangraph_tpu.parallel.distributed import _synth_records as ref_synth_records
from pangraph_tpu_torch.align.params import AlignmentArgs, BuildArgs
from pangraph_tpu_torch.build.build import build
from pangraph_tpu_torch.ops.batch_align import BatchAligner
from pangraph_tpu_torch.parallel import distributed as dist_mod


def test_two_process_cluster_on_the_cpu(tmp_path):
    results = dist_mod.launch_local_cluster(n_processes=2, device="cpu", local_shards=4, genomes=6, length=900,
                                            timeout_s=300, out_dir=str(tmp_path))
    assert len(results) == 2
    assert results[0]["digest"] == results[1]["digest"]
    assert results[0]["blocks"] >= 2, "the workload should give a graph of several blocks"
    for r in results:
        assert r["local_devices"] == 4
        assert r["global_devices"] == 8
        assert r["psum"] == 8.0
    # the merge tree was shared: 6 genomes make 5 merges, each claimed once
    # (a worker that starts late may find them all claimed)
    assert 1 <= sum(r["merges_claimed"] for r in results) <= 5
    assert sum(s["launches"] for r in results for s in r["shards"].values()) > 0
    recs = dist_mod._synth_records(seed=3, n=6, L=900)
    args = BuildArgs(circular=False, jobs=2, aln_args=AlignmentArgs())
    solo = build(recs, args, aligner=BatchAligner(args.banded_params, args.extra_band_width,
                                                  args.max_alignment_attempts, device="cpu"))
    assert dist_mod.graph_digest(solo) == results[0]["digest"]


def test_synth_records_are_the_reference_workload():
    port = dist_mod._synth_records(seed=3, n=6, L=900)
    ref = ref_synth_records(seed=3, n=6, L=900)
    assert [(r.seq_name, bytes(r.seq)) for r in port] == [(r.seq_name, bytes(r.seq)) for r in ref]


def test_global_mesh_sanity_in_one_process():
    """A group of one: the sum is this process's shard count."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist_mod.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = dist_mod.local_mesh("cpu", 3)
        assert dist_mod.global_mesh_sanity(mesh) == 3.0
        assert dist_mod.local_mesh("cpu").size == 1
    finally:
        dist.destroy_process_group()

