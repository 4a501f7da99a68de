"""Every subcommand of the port's CLI (pangraph_tpu_torch.cli) held against
the reference CLI (pangraph_tpu.cli) on the same graph JSON: exports,
reconstruct and schema give equal text, simplify and merge byte-equal
graph JSON (merge with like routing on both sides). The graph is built by
the reference on the host route from make_accessory_pangenome (4 x 20 kb,
circular)."""
from __future__ import annotations

import os
import subprocess

import numpy as np
import pytest

from pangraph_tpu.align.params import BuildArgs
from pangraph_tpu.build.build import make_find_matches as ref_find_matches
from pangraph_tpu.build.merge import merge_graphs as ref_merge
from pangraph_tpu.cli import main as ref_main
from pangraph_tpu.graph.graph import Pangraph as RefPangraph
from pangraph_tpu.io.fasta import FastaRecord, read_fasta, write_fasta
from pangraph_tpu.ops.batch_align import TpuBatchAligner
from pangraph_tpu.utils.synth import make_accessory_pangenome
from pangraph_tpu_torch import cli as port_cli
from pangraph_tpu_torch.ops.batch_align import BatchAligner

SUBCOMMANDS = ["build", "export", "simplify", "reconstruct", "schema", "completions", "help-markdown", "merge"]


def run(main, *args) -> int:
    return main([str(a) for a in args])


def both(tmp_path, make_args):
    """Run make_args(out) through both CLIs, each with an output path of its
    own (out is tmp_path/ref/<name> and tmp_path/port/<name>); returns the
    two output paths."""
    outs = []
    for side, main in (("ref", ref_main), ("port", port_cli.main)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        assert run(main, *make_args(d)) == 0, side
        outs.append(d)
    return outs


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    """(FASTA path, graph JSON path, path names) of the reference's host-route
    build of 4 x 20 kb circular genomes."""
    d = tmp_path_factory.mktemp("cli")
    fa, js = d / "in.fa", d / "graph.json"
    recs = make_accessory_pangenome(n_genomes=4, genome_len=20_000, seed=13)
    write_fasta(str(fa), recs)
    assert run(ref_main, "build", fa, "-c", "--no-tpu", "--no-progress-bar", "-o", js) == 0
    return fa, js, [r.seq_name for r in recs]


@pytest.mark.parametrize(
    "flags",
    [
        ["--minimum-length", 1000, "--minimum-depth", 2],
        ["--minimum-length", 1000, "--minimum-depth", 2, "--no-duplicated"],
        [],
        ["--no-duplicated"],
        ["--include-sequences"],
    ],
    ids=["len-depth", "len-depth-nodup", "all", "nodup", "sequences"],
)
def test_export_gfa(graph, tmp_path, flags):
    _, js, _ = graph
    ref, port = both(tmp_path, lambda d: ["export", "gfa", js, "-o", d / "g.gfa", *flags])
    text = (ref / "g.gfa").read_text()
    assert "\nS\t" in text and "\nP\t" in text
    assert (port / "g.gfa").read_text() == text


def test_export_block_consensus(graph, tmp_path):
    _, js, _ = graph
    ref, port = both(tmp_path, lambda d: ["export", "block-consensus", js, "-o", d / "c.fa"])
    assert (port / "c.fa").read_text() == (ref / "c.fa").read_text()


@pytest.mark.parametrize("unaligned", [False, True])
def test_export_block_sequences(graph, tmp_path, unaligned):
    _, js, _ = graph
    extra = ["--unaligned"] if unaligned else []
    ref, port = both(tmp_path, lambda d: ["export", "block-sequences", js, "-o", d / "blocks", *extra])
    files = sorted(os.listdir(ref / "blocks"))
    assert files and sorted(os.listdir(port / "blocks")) == files
    for f in files:
        assert (port / "blocks" / f).read_bytes() == (ref / "blocks" / f).read_bytes(), f


@pytest.mark.parametrize("unaligned", [False, True])
def test_export_core_genome(graph, tmp_path, unaligned):
    _, js, names = graph
    extra = ["--unaligned"] if unaligned else []
    ref, port = both(tmp_path, lambda d: ["export", "core-genome", js, "-o", d / "core.fa",
                                          "--guide-strain", names[0], *extra])
    text = (ref / "core.fa").read_text()
    assert text.count(">") == len(names)
    assert (port / "core.fa").read_text() == text


def test_simplify(graph, tmp_path):
    _, js, names = graph
    ref, port = both(tmp_path, lambda d: ["simplify", js, "-o", d / "s.json", "-s", ",".join(names[1:3])])
    assert (port / "s.json").read_bytes() == (ref / "s.json").read_bytes()


def test_reconstruct(graph, tmp_path):
    fa, js, _ = graph
    ref, port = both(tmp_path, lambda d: ["reconstruct", js, "-o", d / "r.fa"])
    assert (port / "r.fa").read_text() == (ref / "r.fa").read_text()
    got = {r.seq_name: bytes(r.seq) for r in read_fasta(str(port / "r.fa"))}
    assert got == {r.seq_name: bytes(r.seq) for r in read_fasta(str(fa))}


def test_reconstruct_verify(graph, tmp_path, capsys):
    """--verify exits 0 on the input FASTA and 1 on one with a base changed."""
    fa, js, _ = graph
    recs = read_fasta(str(fa))
    seq = recs[1].seq.copy()
    seq[len(seq) // 2] = ord("A") if seq[len(seq) // 2] != ord("A") else ord("C")
    recs[1] = FastaRecord(recs[1].seq_name, recs[1].desc, seq, recs[1].index)
    bad = tmp_path / "bad.fa"
    write_fasta(str(bad), recs)
    for main in (ref_main, port_cli.main):
        assert run(main, "reconstruct", js, "--verify", fa) == 0
        assert "reconstructed exactly" in capsys.readouterr().err
        assert run(main, "reconstruct", js, "--verify", bad) == 1
        err = capsys.readouterr().err
        assert f"MISMATCH {recs[1].seq_name}" in err and err.count("MISMATCH") == 1


def test_schema(tmp_path, capsys):
    ref, port = both(tmp_path, lambda d: ["schema", "-o", d / "schema.json"])
    text = (ref / "schema.json").read_text()
    assert (port / "schema.json").read_text() == text
    assert run(port_cli.main, "schema") == 0
    assert capsys.readouterr().out == text


def _port_flags():
    """{subcommand path: flags} of the port's own parser."""
    return {path: sorted(flags) for path, (flags, _subs) in port_cli._parser_tree().items()}


def test_parser_has_every_reference_subcommand():
    """Every subcommand of the reference parses in the port, and every flag
    of the reference's, `build --devices` included."""
    from pangraph_tpu.cli import _parser_tree as ref_tree

    port = port_cli._parser_tree()
    for path, (flags, subs) in ref_tree().items():
        assert path in port, path
        missing = set(flags) - set(port[path][0])
        assert not missing, (path, missing)
        assert port[path][1] == subs
    assert "--devices" in port[("build",)][0]
    assert {"--device", "--no-tpu"} <= set(port[("merge",)][0])
    assert set(SUBCOMMANDS) == set(port[()][1])


def test_help_markdown(capsys):
    assert run(port_cli.main, "help-markdown") == 0
    md = capsys.readouterr().out
    assert md.startswith("# pangraph-tpu-torch CLI reference")
    for name in SUBCOMMANDS:
        assert f"## `pangraph-tpu-torch {name}`" in md, name
    for path, flags in _port_flags().items():
        for f in flags:
            assert f in md, (path, f)


@pytest.mark.parametrize("shell", ["bash", "zsh", "fish"])
def test_completions(shell, capsys):
    """Completions name every subcommand and every flag of the port's parser
    (zsh covers the flags of the top-level subcommands, as the reference's
    does); bash's parses."""
    assert run(port_cli.main, "completions", shell) == 0
    out = capsys.readouterr().out
    for name in SUBCOMMANDS:
        assert name in out, name
    for path, flags in _port_flags().items():
        if not path or (shell == "zsh" and len(path) != 1):
            continue
        for f in flags:
            if shell == "fish":
                word = f"-l {f[2:]} " if f.startswith("--") else f"-s {f[1]} "
            elif shell == "zsh":
                word = f"'{f}["
            else:
                word = f
            assert word in out, (path, f)
    if shell == "bash":
        r = subprocess.run(["bash", "-n", "/dev/stdin"], input=out, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert "complete -o filenames -F _pangraph_tpu_torch pangraph-tpu-torch" in out
    else:
        assert "pangraph-tpu-torch" in out and "pangraph-tpu " not in out


def _genomes(n=4, L=1800, seed=42):
    """Small genomes with ~1% substitutions and a few short indels."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, L)]
    recs = []
    for i in range(n):
        g = base.copy()
        idx = rng.choice(L, L // 100, replace=False)
        g[idx] = acgt[rng.integers(0, 4, len(idx))]
        g = list(g)
        for _ in range(2):
            p = int(rng.integers(100, len(g) - 100))
            g[p : p + int(rng.integers(2, 12))] = []
        recs.append(FastaRecord(seq_name=f"g{i}", desc=None, seq=np.array(g, np.uint8), index=i))
    return recs


@pytest.mark.parametrize("route", ["kernel", "host"])
def test_merge(tmp_path, monkeypatch, route):
    """`merge` of two subgraphs built by the reference: --device cpu (the
    kernels' plain versions) against the reference with every alignment on
    its kernels (NATIVE_CELL_BUDGET = 0), and --no-tpu against the
    reference's host route; both byte-equal."""
    recs = _genomes() if route == "kernel" else make_accessory_pangenome(n_genomes=4, genome_len=20_000, seed=5)
    args = BuildArgs(circular=True)
    al = TpuBatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts)
    halves = []
    for i, (a, b) in enumerate((recs[:2], recs[2:])):
        singles = [RefPangraph.singleton(r.seq_name, r.seq, r.index, True, desc=r.desc) for r in (a, b)]
        js = tmp_path / f"half{i}.json"
        ref_merge(*singles, args, ref_find_matches(args, al), al).to_file(str(js))
        halves.append(js)
    if route == "kernel":
        monkeypatch.setattr(TpuBatchAligner, "NATIVE_CELL_BUDGET", 0)
        port_extra = ["--device", "cpu"]
    else:
        port_extra = ["--no-tpu"]
    TpuBatchAligner.reset_engine_stats()
    BatchAligner.reset_engine_stats()
    assert run(ref_main, "merge", *halves, "-c", "-o", tmp_path / "ref.json") == 0
    assert run(port_cli.main, "merge", *halves, "-c", "-o", tmp_path / "port.json", *port_extra) == 0
    frac = {"kernel": 1.0, "host": 0.0}[route]
    assert TpuBatchAligner.engine_report()["device_cells_frac"] == frac
    assert BatchAligner.engine_report()["device_cells_frac"] == frac
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    merged = RefPangraph.from_file(str(tmp_path / "ref.json"))
    assert len(merged.blocks) < sum(len(RefPangraph.from_file(str(h)).blocks) for h in halves)


@pytest.mark.parametrize("params", [{}, {"include_sequences": True}, {"maximum_length": 15}])
def test_gfa_writers_on_the_ported_fixtures(params):
    """tests/test_gfa_ported.py's graphs through both GFA writers."""
    from pangraph_tpu.graph.graph import Pangraph as RefPangraph
    from pangraph_tpu.io.gfa import GfaParams as RefParams
    from pangraph_tpu.io.gfa import gfa_lines as ref_lines
    from pangraph_tpu_torch.graph.graph import Pangraph
    from pangraph_tpu_torch.io.gfa import GfaParams, gfa_lines
    from test_gfa_ported import GENERAL_GRAPH

    empty = {"paths": {}, "blocks": {}, "nodes": {}}
    for data in (empty, GENERAL_GRAPH):
        want = list(ref_lines(RefPangraph.from_json_dict(data), RefParams(**params)))
        assert list(gfa_lines(Pangraph.from_json_dict(data), GfaParams(**params))) == want
    assert len(want) > 3


def test_build_parses_devices_and_merge_does_not():
    """`build --devices` parses since the port has its multi-device layer
    (parallel/mesh.py; tests/test_torch_mesh.py runs it); `merge` still
    parses no `--devices`, as the reference's has none."""
    parse = port_cli.build_parser().parse_args
    assert parse(["build", "x.fa", "--devices", "2"]).devices == 2
    assert parse(["build", "x.fa"]).devices is None
    with pytest.raises(SystemExit):
        parse(["merge", "a.json", "b.json", "--devices", "2"])
