"""mmseqs2 alternative alignment backend (subprocess).

Reference: align/mmseqs/align_with_mmseqs.rs + paf.rs. Writes block consensuses
to a temp FASTA, runs `mmseqs easy-search` with a custom PAF-like column
format, parses rows back into Alignment records. Requires the external
`mmseqs` binary (checked at startup, build_run.rs:19-35).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

from pangraph_tpu_torch.align.alignment import Alignment, Hit
from pangraph_tpu_torch.align.cigar import parse_cigar
from pangraph_tpu_torch.graph.seq import to_str
from pangraph_tpu_torch.io.fasta import FastaRecord, write_fasta

# columns requested via --format-output (align/mmseqs/paf.rs:14-40)
PAF_FIELDS = [
    "query", "qlen", "qstart", "qend", "empty", "target", "tlen", "tstart", "tend",
    "nident", "alnlen", "bits", "cigar", "fident", "raw",
]


def check_mmseqs() -> None:
    if shutil.which("mmseqs") is None:
        raise RuntimeError(
            "The mmseqs backend requires the external `mmseqs` binary in PATH. "
            "Install MMseqs2 (https://github.com/soedinglab/MMseqs2) or use the "
            "default minimap2-equivalent kernel (-k minimap2)."
        )


def align_with_mmseqs(blocks: dict, kmer_length=None) -> list:
    check_mmseqs()
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "blocks.fa")
        out = os.path.join(tmp, "result.paf")
        tmpdir = os.path.join(tmp, "work")
        recs = [FastaRecord(str(bid), None, b.consensus, 0) for bid, b in blocks.items()]
        write_fasta(fasta, recs)
        cmd = [
            "mmseqs", "easy-search", fasta, fasta, out, tmpdir,
            "--threads", str(os.cpu_count() or 1),
            "--max-seq-len", str(max((b.consensus_len() for b in blocks.values()), default=10000) + 1),
            "-a", "--search-type", "3",
            "--format-output", ",".join(PAF_FIELDS),
        ]
        if kmer_length:
            cmd += ["-k", str(kmer_length)]
        subprocess.run(cmd, check=True, capture_output=True)
        with open(out) as f:
            return [aln for line in f if (aln := _parse_row(line)) is not None]


def _order_range(start: int, end: int):
    """mmseqs 1-based inclusive -> 0-based right-exclusive; a swapped pair
    (start > end) marks a reverse-complemented hit (paf.rs:74-86: an exact
    reverse match of two length-10 sequences reports query = (10, 1),
    target = (1, 10) — the STRAND comes from the query range). A degenerate
    start == end (single-column) hit classifies as reverse, exactly like
    the reference's order_range — mmseqs never emits such rows."""
    if start < end:
        return start - 1, end, "+"
    return end - 1, start, "-"


def _parse_row(line: str):
    parts = line.rstrip("\n").split("\t")
    if len(parts) < len(PAF_FIELDS):
        return None
    row = dict(zip(PAF_FIELDS, parts))
    qs, qe, orientation = _order_range(int(row["qstart"]), int(row["qend"]))
    ts, te, _ = _order_range(int(row["tstart"]), int(row["tend"]))
    cigar = parse_cigar(row["cigar"])
    return Alignment(
        qry=Hit.new(int(row["query"]), int(row["qlen"]), (qs, qe)),
        reff=Hit.new(int(row["target"]), int(row["tlen"]), (ts, te)),
        matches=int(row["nident"]),
        length=int(row["alnlen"]),
        quality=int(float(row["bits"])),
        orientation=orientation,
        cigar=cigar,
        divergence=1.0 - float(row["fident"]),
        align_score=float(row["raw"]),
    )


def make_mmseqs_find_matches(args):
    def find_matches(blocks: dict, aln_args):
        return align_with_mmseqs(blocks, kmer_length=aln_args.kmer_length)

    return find_matches
