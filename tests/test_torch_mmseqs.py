"""The port's mmseqs backend (pangraph_tpu_torch.align.mmseqs) held against
the reference's (pangraph_tpu.align.mmseqs), as tests/test_mmseqs.py tests
the reference: canned easy-search rows through both row parsers, the
subprocess path against a stub `mmseqs` on PATH, and `build -k mmseqs`
through both CLIs with the same stub (the port on --device cpu, the
reference with every alignment on its kernels)."""
from __future__ import annotations

import dataclasses
import os
import stat

import numpy as np
import pytest

import pangraph_tpu.align.mmseqs as ref_mm
import pangraph_tpu_torch.align.mmseqs as port_mm
from pangraph_tpu.graph.graph import Block as RefBlock
from pangraph_tpu.io.fasta import FastaRecord, write_fasta
from pangraph_tpu.ops.batch_align import TpuBatchAligner
from pangraph_tpu_torch.graph.graph import Block as PortBlock
from pangraph_tpu_torch.ops.batch_align import BatchAligner

FWD_ROW = "1\t100\t1\t100\t\t2\t100\t1\t100\t98\t100\t180\t100M\t0.98\t450\n"
REV_ROW = "3\t50\t50\t1\t\t4\t60\t5\t54\t48\t50\t90\t50M\t0.96\t210\n"
# a row with indels and a fractional bit score
GAPPED_ROW = "5\t120\t3\t118\t\t6\t130\t10\t128\t101\t119\t150.7\t40M2I30M4D45M\t0.8487\t312\n"
ROWS = [FWD_ROW, REV_ROW, GAPPED_ROW, "\n", "1\t2\t3\n", FWD_ROW.rstrip("\n") + "\textra\n"]


def as_dict(aln):
    return None if aln is None else dataclasses.asdict(aln)


@pytest.mark.parametrize("row", ROWS, ids=["fwd", "rev", "gapped", "empty", "short", "extra-column"])
def test_parse_row_matches_reference(row):
    assert port_mm.PAF_FIELDS == ref_mm.PAF_FIELDS
    assert as_dict(port_mm._parse_row(row)) == as_dict(ref_mm._parse_row(row))


def _blocks(Block):
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return {bid: Block(bid, acgt[rng.integers(0, 4, 100)], {bid * 10: None}) for bid in (1, 2, 3, 4)}


def _stub(tmp_path, monkeypatch, rows: str):
    """A fake `mmseqs` on PATH: checks the subcommand, copies the query FASTA
    it was given beside itself, and writes `rows` to the result path."""
    exe = tmp_path / "mmseqs"
    canned = tmp_path / "canned.paf"
    canned.write_text(rows)
    exe.write_text(
        "#!/bin/sh\n"
        '[ "$1" = easy-search ] || { echo "unexpected subcommand $1" >&2; exit 2; }\n'
        f'cat "$2" >> "{tmp_path}/queries.fa"\n'
        f'cp "{canned}" "$4"\n'
    )
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    return tmp_path / "queries.fa"


def test_align_with_mmseqs_stub_binary(tmp_path, monkeypatch):
    """The subprocess path on both sides: the same FASTA handed to mmseqs,
    the same alignments parsed back (the malformed row dropped)."""
    queries = _stub(tmp_path, monkeypatch, FWD_ROW + REV_ROW + GAPPED_ROW + "bad\trow\n")
    port_mm.check_mmseqs()
    got = port_mm.align_with_mmseqs(_blocks(PortBlock), kmer_length=13)
    port_fasta = queries.read_text()
    queries.unlink()
    want = ref_mm.align_with_mmseqs(_blocks(RefBlock), kmer_length=13)
    assert queries.read_text() == port_fasta and port_fasta.count(">") == 4
    assert len(got) == 3
    assert [as_dict(a) for a in got] == [as_dict(a) for a in want]

    class _A:
        kmer_length = None

    assert len(port_mm.make_mmseqs_find_matches(None)(_blocks(PortBlock), _A())) == 3


def test_check_mmseqs_raises_without_binary(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="mmseqs"):
        port_mm.check_mmseqs()


def test_build_without_mmseqs_exits_1(tmp_path, monkeypatch, capsys):
    from pangraph_tpu_torch.cli import main

    monkeypatch.setenv("PATH", "/nonexistent")
    fa = tmp_path / "in.fa"
    fa.write_text(">a\nACGTACGTACGT\n>b\nACGTACGTACGT\n")
    assert main(["build", str(fa), "-k", "mmseqs", "--device", "cpu", "-o", str(tmp_path / "g.json")]) == 1
    assert "mmseqs" in capsys.readouterr().err
    assert not (tmp_path / "g.json").exists()


def test_cli_build_with_mmseqs_matches_reference(tmp_path, monkeypatch):
    """`build -k mmseqs` on the port (--device cpu) and on the reference (its
    kernels, NATIVE_CELL_BUDGET = 0), each with a stub mmseqs that finds no
    match: byte-equal graph JSON, and the same block FASTAs handed to mmseqs."""
    from pangraph_tpu.cli import main as ref_main
    from pangraph_tpu_torch.cli import main as port_main

    queries = _stub(tmp_path, monkeypatch, "")
    rng = np.random.default_rng(9)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fa = tmp_path / "in.fa"
    write_fasta(str(fa), [FastaRecord(f"g{i}", None, acgt[rng.integers(0, 4, 700)], i) for i in range(4)])
    monkeypatch.setattr(TpuBatchAligner, "NATIVE_CELL_BUDGET", 0)
    common = ["build", str(fa), "-k", "mmseqs", "-c", "-f", "--no-progress-bar"]
    assert ref_main([*common, "--devices", "1", "-o", str(tmp_path / "ref.json")]) == 0
    ref_queries = queries.read_text()
    queries.unlink()
    BatchAligner.reset_engine_stats()
    assert port_main([*common, "--device", "cpu", "-o", str(tmp_path / "port.json")]) == 0
    assert queries.read_text() == ref_queries and ref_queries.count(">") >= 3
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
