"""`--coordinate tcp://HOST:PORT` in the port (pangraph_tpu_torch.parallel.
coordinator), on synth genomes with the host C++ engine (`--no-tpu`).

Two port workers share one build through the coordination server (the
first to bind hosts it) and write the graph that a solo port build and the
reference's build (pangraph_tpu, `--no-tpu`) write, byte for byte; the
checkpointer claims and exchanges subgraphs; it degrades to a solo build
when the server dies; and a typo'd scheme raises, as in the reference.
Mirrors the TCP tests of tests/test_coordinate.py."""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pangraph_tpu.cli import main as ref_main
from pangraph_tpu_torch.align.params import BuildArgs
from pangraph_tpu_torch.build.build import build as port_build
from pangraph_tpu_torch.cli import build_parser
from pangraph_tpu_torch.cli import main as port_main
from pangraph_tpu_torch.graph.graph import Pangraph
from pangraph_tpu_torch.io.fasta import FastaRecord, write_fasta
from pangraph_tpu_torch.parallel.coordinator import TcpMergeCheckpointer

ACGT = np.frombuffer(b"ACGT", np.uint8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def genomes(n=6, L=1200, seed=9):
    """tests/test_coordinate.py's genomes: ~1% substitutions and one 5 bp
    insertion each."""
    rng = np.random.default_rng(seed)
    base = ACGT[rng.integers(0, 4, L)]
    recs = []
    for i in range(n):
        g = base.copy()
        idx = rng.choice(L, L // 100, replace=False)
        g[idx] = ACGT[rng.integers(0, 4, len(idx))]
        g = list(g)
        p = int(rng.integers(100, L - 100))
        g[p:p] = list(ACGT[rng.integers(0, 4, 5)])
        recs.append(FastaRecord(seq_name=f"g{i}", desc=None, seq=np.array(g, np.uint8), index=i))
    return recs


def free_url() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def port_worker(fa, out, url):
    args = [sys.executable, "-m", "pangraph_tpu_torch.cli", "build", str(fa), "-o", str(out), "--no-tpu",
            "--no-progress-bar", "-j", "2", "--verbosity", "info", "--coordinate", url]
    return subprocess.Popen(args, cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def test_two_port_workers_share_one_build_tcp(tmp_path):
    fa = tmp_path / "in.fa"
    write_fasta(str(fa), genomes())
    solo = ["build", str(fa), "--no-tpu", "--no-progress-bar", "-j", "2"]
    assert port_main([*solo, "-o", str(tmp_path / "solo.json")]) == 0  # also builds the host engine once
    assert ref_main([*solo, "-o", str(tmp_path / "ref.json")]) == 0
    url = free_url()
    outs = [tmp_path / "w1.json", tmp_path / "w2.json"]
    workers = [port_worker(fa, out, url) for out in outs]
    logs = []
    for w in workers:
        _, err = w.communicate(timeout=300)
        logs.append(err.decode())
        assert w.returncode == 0, logs[-1][-2000:]
    # one worker hosted the server, the other joined it
    assert sorted("hosting merge coordinator" in e for e in logs) == [False, True]
    assert sum("joining merge coordinator" in e for e in logs) == 1
    graph = outs[0].read_bytes()
    assert outs[1].read_bytes() == graph
    assert (tmp_path / "solo.json").read_bytes() == graph
    assert (tmp_path / "ref.json").read_bytes() == graph


def test_tcp_checkpointer_claim_and_exchange():
    url = free_url()
    host0 = TcpMergeCheckpointer(url)  # binds: hosts the server
    peer = TcpMergeCheckpointer(url)  # the port is taken: joins as a client
    try:
        assert host0.server is not None and peer.server is None
        leaves = ["a", "b"]
        assert host0.try_claim(leaves)
        assert host0.try_claim(leaves)  # idempotent for its own holder
        assert not peer.try_claim(leaves)  # already claimed
        rec = genomes(n=1)[0]
        g = Pangraph.singleton(rec.seq_name, rec.seq, 0, circular=True)
        assert peer.load(leaves) is None
        host0.save(leaves, g)
        got = peer.wait_for(leaves, timeout_s=10.0)
        assert got.to_json() == g.to_json()
        assert peer.load(leaves).to_json() == g.to_json()
        assert not peer.try_claim(leaves)  # published: the claim is refused
        with pytest.raises(TimeoutError):
            peer.wait_for(["never"], timeout_s=0.3)
    finally:
        host0.server.close()


def test_tcp_checkpointer_degrades_when_server_dies(monkeypatch):
    """Claims succeed locally, loads miss and waits raise TimeoutError (the
    build then computes the merge itself)."""
    url = free_url()
    host0 = TcpMergeCheckpointer(url)
    peer = TcpMergeCheckpointer(url)
    assert peer.try_claim(["a"])  # the server is alive: the first claim wins
    host0.server.close()
    rpc = peer._rpc
    monkeypatch.setattr(peer, "_rpc", lambda header, payload=b"", timeout=None, max_wait=30.0:
                        rpc(header, payload, timeout=timeout, max_wait=0.5))
    assert peer.try_claim(["b"]) is True  # solo: the claim is granted locally
    assert peer._dead
    assert peer.load(["a"]) is None
    with pytest.raises(TimeoutError):
        peer.wait_for(["a"], timeout_s=0.5)


def test_coordinate_flag_and_scheme():
    """The bare flag keeps the shared-directory transport, a URL selects TCP,
    and a scheme other than tcp:// raises in build() and in the client."""
    parse = build_parser().parse_args
    assert parse(["build", "in.fa", "--coordinate"]).coordinate is True
    assert parse(["build", "in.fa", "--coordinate", "tcp://127.0.0.1:1"]).coordinate == "tcp://127.0.0.1:1"
    assert parse(["build", "in.fa"]).coordinate is False
    with pytest.raises(ValueError, match="expected tcp://HOST:PORT"):
        port_build(genomes(n=2, L=600), BuildArgs(coordinate="tpc://127.0.0.1:1"), aligner="numpy")
    with pytest.raises(ValueError, match="tcp://HOST:PORT"):
        TcpMergeCheckpointer("http://127.0.0.1:1")
