"""`--checkpoint-dir` resume and the file-claim transport of the port
(pangraph_tpu_torch/build/build.py: MergeCheckpointer, `coordinate=True`),
on the host route (the host C++ engine on both sides).

Mirrors tests/test_checkpoint.py on a synth input (4 x ~20 kb from
make_accessory_pangenome) in place of the plasmid FASTA: a full resume
(find_matches never runs), a partial resume (the root checkpoint deleted),
the jobs=2 schedule, and two workers sharing one checkpoint directory with
`--coordinate`. Every graph must be byte-equal to an uninterrupted port
build and to the reference's build of the same records."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from pangraph_tpu.align.params import BuildArgs
from pangraph_tpu.build.build import build as ref_build
from pangraph_tpu.io.fasta import read_fasta, write_fasta
from pangraph_tpu.utils.synth import make_accessory_pangenome
from pangraph_tpu_torch.build.build import MergeCheckpointer, make_find_matches, verify_roundtrip
from pangraph_tpu_torch.build.build import build as port_build
from test_torch_build import graph_json, port_aligner, port_args, port_records, ref_aligner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The records (read back from their FASTA, as the CLI reads them), the
    FASTA, and per jobs in (1, 2) the uninterrupted port graph, equal to the
    reference's with like routing (the host engine) and to each other."""
    fa = tmp_path_factory.mktemp("input") / "in.fa"
    write_fasta(str(fa), make_accessory_pangenome(4, 20_000, seed=5))
    recs = read_fasta(str(fa))
    graphs = {}
    for jobs in (1, 2):
        args = BuildArgs(circular=True, jobs=jobs)
        g_ref = graph_json(ref_build(recs, args, aligner=ref_aligner(args, False)))
        pargs = port_args(args)
        g_port = graph_json(port_build(port_records(recs), pargs, aligner=port_aligner(pargs, None)))
        assert g_port == g_ref
        graphs[jobs] = g_port
    assert graphs[1] == graphs[2]
    return port_records(recs), fa, graphs


def _args(jobs, d, **kw):
    return port_args(BuildArgs(circular=True, jobs=jobs, checkpoint_dir=str(d), **kw))


def _boom(blocks, aln_args, pair_cache=None):
    raise RuntimeError("find_matches must not be called on a full resume")


def test_full_resume(uninterrupted, tmp_path):
    recs, _, graphs = uninterrupted
    d = tmp_path / "ckpt"
    args = _args(1, d)
    g1 = port_build(recs, args, aligner=port_aligner(args, None))
    verify_roundtrip(g1, recs)
    assert len(os.listdir(d)) == 3  # one per internal clade of a 4-leaf tree
    assert graph_json(g1) == graphs[1]
    g2 = port_build(recs, args, aligner=port_aligner(args, None), find_matches_override=_boom)
    assert graph_json(g2) == graphs[1]


def test_partial_resume(uninterrupted, tmp_path):
    recs, _, graphs = uninterrupted
    d = tmp_path / "ckpt"
    args = _args(1, d)
    port_build(recs, args, aligner=port_aligner(args, None))
    os.remove(d / f"merge-{MergeCheckpointer.fingerprint([r.seq_name for r in recs])}.json.gz")
    aligner = port_aligner(args, None)
    inner = make_find_matches(args, aligner)
    calls = [0]

    def counting(blocks, aln_args, pair_cache=None):
        calls[0] += 1
        return inner(blocks, aln_args, pair_cache=pair_cache)

    counting.supports_pair_cache = True
    g3 = port_build(recs, args, aligner=aligner, find_matches_override=counting)
    verify_roundtrip(g3, recs)
    assert calls[0] > 0  # only the root merge reran
    assert len(os.listdir(d)) == 3
    assert graph_json(g3) == graphs[1]


def test_parallel_schedule_resumes(uninterrupted, tmp_path):
    recs, _, graphs = uninterrupted
    args = _args(2, tmp_path / "ckpt_par")
    g1 = port_build(recs, args, aligner=port_aligner(args, None))
    verify_roundtrip(g1, recs)
    assert graph_json(g1) == graphs[2]
    g2 = port_build(recs, args, aligner=port_aligner(args, None), find_matches_override=_boom)
    assert graph_json(g2) == graphs[2]


def test_two_workers_share_a_checkpoint_dir(uninterrupted, tmp_path):
    """Two port CLI workers with `--checkpoint-dir D --coordinate` (the file
    claims) claim the merges between them and write the solo graph."""
    _, fa, graphs = uninterrupted
    d = tmp_path / "coord"
    outs = [tmp_path / "w1.json", tmp_path / "w2.json"]
    workers = [
        subprocess.Popen(
            [sys.executable, "-m", "pangraph_tpu_torch.cli", "build", str(fa), "-c", "--no-tpu", "-j", "2",
             "--no-progress-bar", "--checkpoint-dir", str(d), "--coordinate", "-o", str(out)],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        for out in outs
    ]
    for w in workers:
        _, err = w.communicate(timeout=300)
        assert w.returncode == 0, err.decode()[-2000:]
    assert outs[0].read_bytes() == outs[1].read_bytes()
    with open(outs[0]) as f:
        assert json.dumps(json.load(f), sort_keys=True) == graphs[2]
    # each of the three merges was claimed once, and its checkpoint written
    names = sorted(os.listdir(d))
    assert sum(n.startswith("claim-") for n in names) == 3
    assert sum(n.startswith("merge-") for n in names) == 3
