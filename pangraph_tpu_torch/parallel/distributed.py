"""Several processes on one build: torch.distributed and the merge coordinator.

The port's counterpart of pangraph_tpu/parallel/distributed.py. N worker
processes join one `torch.distributed` process group, split the merge tree
through the TCP claim and exchange coordinator (parallel/coordinator.py),
and split each claimed merge's alignment launches over their own local
mesh (parallel/mesh.py). Subgraphs move between merge-tree levels as
gzipped graph JSON over the coordinator; alignment launches never cross a
process, so the hot path runs no collective.

The process group runs on gloo over CPU tensors, also where the workers
align on CUDA cards: its one collective (`global_mesh_sanity`) only proves
that the group is live, and NCCL refuses two ranks on one card, which is
how one machine with one card runs a cluster.

Worker entry point: `python -m pangraph_tpu_torch.parallel.distributed`
(`worker_main`); `launch_local_cluster` spawns N such workers on one host,
each over `--local-shards` repeats of the CPU or of one card. On several
hosts, run one worker per host with the same flags and reachable
addresses.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np


def initialize(coordinator_address: str, num_processes: int, process_id: int):
    """Join the process group at `coordinator_address` (HOST:PORT, or
    tcp://HOST:PORT; process 0 hosts it), on gloo. Returns
    torch.distributed."""
    import torch.distributed as dist

    url = coordinator_address if coordinator_address.startswith("tcp://") else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=url, world_size=num_processes, rank=process_id)
    return dist


def local_mesh(device: str = "cuda", shards: int = None):
    """This process's mesh: every visible card (one CPU shard for "cpu"), or
    `shards` repeats of the CPU or of the current card."""
    from pangraph_tpu_torch.parallel.mesh import make_mesh

    if shards is None:
        return make_mesh(device=device)
    return make_mesh(devices=[device] * shards)


def global_mesh_sanity(mesh) -> float:
    """One collective over every process's mesh: each process contributes
    one per shard of its own mesh, and the sum over the group comes back.
    Returns that sum (== the number of shards in the cluster), as the
    reference's psum over ones returns its global device count."""
    import torch
    import torch.distributed as dist

    x = torch.ones(mesh.size, dtype=torch.float32).sum().reshape(1)
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return float(x[0])


def distributed_build(records, args, coordinate_url: str, aligner):
    """Run the build with merge-tree nodes split across the cluster: claims
    and subgraph exchange over `coordinate_url` (tcp://HOST:PORT), the
    alignment launches split over `aligner`'s mesh."""
    from pangraph_tpu_torch.build.build import build

    args.coordinate = coordinate_url
    return build(records, args, aligner=aligner)


def _synth_records(seed: int, n: int, L: int):
    """Deterministic tiny workload every worker regenerates identically (the
    reference's: pangraph_tpu/parallel/distributed.py:_synth_records)."""
    from pangraph_tpu_torch.io.fasta import FastaRecord

    ACGT = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    base = ACGT[rng.integers(0, 4, L)]
    accessory = ACGT[rng.integers(0, 4, max(150, L // 5))]  # present in half
    recs = []
    for i in range(n):
        g = base.copy()
        idx = rng.choice(L, L // 100, replace=False)
        g[idx] = ACGT[rng.integers(0, 4, len(idx))]
        g = list(g)
        if i % 2 == 0:
            g[L // 2 : L // 2] = list(accessory)
        p = int(rng.integers(100, L - 100))
        g[p:p] = list(ACGT[rng.integers(0, 4, 6)])
        recs.append(FastaRecord(seq_name=f"g{i}", desc=None, seq=np.array(g, np.uint8), index=i))
    return recs


def graph_digest(graph) -> str:
    import hashlib

    return hashlib.blake2b(graph.to_json().encode(), digest_size=16).hexdigest()


def worker_main(argv=None) -> int:
    """One cluster worker: join the process group, run the sanity
    collective, then a coordinated build over this process's mesh; write
    {digest, blocks, local_devices, global_devices, psum, merges_claimed,
    launches} JSON to --out."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="process group HOST:PORT (process 0 hosts it)")
    ap.add_argument("--exchange", required=True, help="merge coordinator tcp://HOST:PORT")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--local-shards", type=int, default=0,
                    help="shards of this process's mesh, repeats of the CPU or of one card (0: every card)")
    ap.add_argument("--genomes", type=int, default=6)
    ap.add_argument("--length", type=int, default=900)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)

    dist = initialize(a.coordinator, a.num_processes, a.process_id)
    try:
        mesh = local_mesh(a.device, a.local_shards or None)
        psum = global_mesh_sanity(mesh)
        # every worker of a cluster runs the same mesh, so the cluster's
        # shards are known without a collective (the reference reads
        # len(jax.devices())); the psum above must come to the same count
        global_devices = dist.get_world_size() * mesh.size

        from pangraph_tpu_torch.align.params import AlignmentArgs, BuildArgs
        from pangraph_tpu_torch.build.build import verify_roundtrip
        from pangraph_tpu_torch.ops import stripe_v2
        from pangraph_tpu_torch.ops.batch_align import BatchAligner
        from pangraph_tpu_torch.parallel.coordinator import TcpMergeCheckpointer

        recs = _synth_records(seed=3, n=a.genomes, L=a.length)
        args = BuildArgs(circular=False, jobs=2, aln_args=AlignmentArgs())
        aligner = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts,
                               device=a.device, mesh=mesh)
        graph = distributed_build(recs, args, a.exchange, aligner)
        verify_roundtrip(graph, recs)
        with open(a.out, "w") as f:
            json.dump(
                {
                    "process_id": a.process_id,
                    "digest": graph_digest(graph),
                    "blocks": len(graph.blocks),
                    "local_devices": mesh.size,
                    "global_devices": global_devices,
                    "psum": psum,
                    "merges_claimed": TcpMergeCheckpointer.CLAIMS_GRANTED,
                    "launches": dict(stripe_v2.LAUNCHES),
                    "shards": BatchAligner.engine_report()["device_shards"],
                },
                f,
            )
    finally:
        dist.destroy_process_group()
    return 0


def _worker_env() -> dict:
    """Worker env: the repository on the path."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo] + parts)
    return env


def launch_local_cluster(
    n_processes: int = 2, device: str = "cuda", local_shards: int = None, genomes: int = 6, length: int = 900,
    timeout_s: float = 600.0, out_dir: str = None,
) -> list:
    """Spawn an n-process cluster on this host, each worker over
    `local_shards` repeats of `device` (the CPU, or the current card; None:
    every card, or one CPU shard), and return the per-worker result dicts. Raises if any worker fails or the
    workers disagree on the final graph."""
    import socket
    import tempfile

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    coord = f"127.0.0.1:{free_port()}"
    exchange = f"tcp://127.0.0.1:{free_port()}"
    out_dir = out_dir or tempfile.mkdtemp(prefix="pangraph-dist-")
    os.makedirs(out_dir, exist_ok=True)
    env = _worker_env()
    procs, outs, logs = [], [], []
    try:
        for pid in range(n_processes):
            out = os.path.join(out_dir, f"worker-{pid}.json")
            outs.append(out)
            # logs go to files, not pipes: workers wait on each other in the
            # collective and the coordinator, so a worker blocked on a full
            # pipe (the parent reads them in turn) would stall the cluster
            log_path = os.path.join(out_dir, f"worker-{pid}.log")
            logs.append(log_path)
            with open(log_path, "w") as log_f:  # the child holds its own handle
                procs.append(subprocess.Popen(
                    [
                        sys.executable, "-m", "pangraph_tpu_torch.parallel.distributed",
                        "--coordinator", coord, "--exchange", exchange,
                        "--num-processes", str(n_processes), "--process-id", str(pid),
                        "--device", device, "--local-shards", str(local_shards or 0),
                        "--genomes", str(genomes), "--length", str(length),
                        "--out", out,
                    ],
                    env=env, stdout=log_f, stderr=subprocess.STDOUT,
                ))
        results = []
        for p, out, log_path in zip(procs, outs, logs):
            try:
                p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                raise RuntimeError("distributed worker timed out") from None
            if p.returncode != 0:
                with open(log_path) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"worker failed (rc={p.returncode}):\n{tail}")
            with open(out) as f:
                results.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    digests = {r["digest"] for r in results}
    if len(digests) != 1:
        raise RuntimeError(f"workers disagree on the final graph: {results}")
    return results


if __name__ == "__main__":
    sys.exit(worker_main())
