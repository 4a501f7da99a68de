"""High-level command implementations: export / simplify / reconstruct / schema.

Reference: commands/export/* (export_args.rs:15-122), commands/simplify/
simplify_run.rs, commands/reconstruct/reconstruct_run.rs, commands/schema/.
"""
from __future__ import annotations

import json
import os

import numpy as np

from pangraph_tpu_torch.build.circularize import remove_transitive_edges
from pangraph_tpu_torch.graph.graph import Pangraph, reconstruct
from pangraph_tpu_torch.graph.seq import revcomp, to_str
from pangraph_tpu_torch.io.fasta import FastaRecord, write_fasta


def block_sequence_records(graph: Pangraph, block, aligned: bool, naming: str):
    """Per-node FASTA records of one block (pangraph_block.rs:135-190).
    naming: 'node' (node id + json meta desc) or 'path' (path name)."""
    for nid, edits in block.alignments.items():
        node = graph.nodes[nid]
        if naming == "node":
            path_name = graph.paths[node.path_id].name
            meta = json.dumps(
                {
                    "path_name": path_name,
                    "block_id": node.block_id,
                    "start": node.position[0],
                    "end": node.position[1],
                    "strand": node.strand,
                },
                separators=(",", ":"),
            )
            name, desc = str(nid), meta
        else:
            path = graph.paths[node.path_id]
            name = path.name if path.name is not None else str(node.path_id)
            desc = path.desc
        seq = edits.apply_aligned(block.consensus) if aligned else edits.apply(block.consensus)
        yield FastaRecord(seq_name=name, desc=desc, seq=seq, index=0)


def export_block_consensus(graph: Pangraph, output) -> None:
    recs = [
        FastaRecord(str(bid), None, graph.blocks[bid].consensus, 0) for bid in sorted(graph.blocks)
    ]
    write_fasta(output, recs)


def export_block_sequences(graph: Pangraph, output_dir, unaligned: bool = False) -> None:
    os.makedirs(output_dir, exist_ok=True)
    for bid in sorted(graph.blocks):
        block = graph.blocks[bid]
        recs = list(block_sequence_records(graph, block, aligned=not unaligned, naming="node"))
        write_fasta(os.path.join(output_dir, f"block_{bid}.fa"), recs)


def export_core_genome(graph: Pangraph, guide_strain: str, output, unaligned: bool = False) -> None:
    """Core blocks ordered/oriented by the guide strain, concatenated per path
    (export_core_genome.rs:28-141)."""
    core_ids = set(graph.core_block_ids())
    guide_pid = graph.path_id_by_name(guide_strain)
    guide_path = graph.paths[guide_pid]

    per_block = []
    for nid in guide_path.nodes:
        node = graph.nodes[nid]
        if node.block_id not in core_ids:
            continue
        block = graph.blocks[node.block_id]
        recs = list(block_sequence_records(graph, block, aligned=not unaligned, naming="path"))
        if node.strand == "-":
            for r in recs:
                r.seq = revcomp(r.seq)
        per_block.append(recs)

    if not per_block:
        out = [
            FastaRecord(p.name if p.name is not None else str(i), p.desc, np.zeros(0, dtype=np.uint8), i)
            for i, p in enumerate(graph.paths.values())
        ]
    else:
        by_name = {
            r.seq_name: FastaRecord(r.seq_name, r.desc, np.zeros(0, dtype=np.uint8), r.index)
            for r in per_block[0]
        }
        for recs in per_block:
            for r in recs:
                tgt = by_name[r.seq_name]
                tgt.seq = np.concatenate([tgt.seq, r.seq])
        out = sorted(by_name.values(), key=lambda r: r.seq_name)
    write_fasta(output, out)


def simplify(graph: Pangraph, focal_strains: list) -> Pangraph:
    """Keep only the named strains, then re-compact transitive edges
    (simplify_run.rs:11-38)."""
    names = {p.name for p in graph.paths.values()}
    missing = [s for s in focal_strains if s not in names]
    if missing:
        raise ValueError(f"Strains not found in graph: {missing}")
    for pid in [pid for pid, p in graph.paths.items() if p.name not in set(focal_strains)]:
        graph.remove_path(pid)
    remove_transitive_edges(graph)
    return graph


def reconstruct_to_fasta(graph: Pangraph, output) -> None:
    recs = [
        FastaRecord(name, desc, seq, i) for i, (name, desc, seq) in enumerate(reconstruct(graph))
    ]
    write_fasta(output, recs)


def _graph_json_schema() -> dict:
    from pangraph_tpu_torch.schema import generate_schema

    return generate_schema()


def export_schema(output=None) -> str:
    text = json.dumps(_graph_json_schema(), indent=2) + "\n"
    if output is not None:
        from pangraph_tpu_torch.io.files import create_maybe_compressed

        with create_maybe_compressed(output, "wt") as f:
            f.write(text)
    return text


def graph_quality(graph: Pangraph) -> dict:
    """Graph-quality summary: the metrics the reference publishes for its
    ecoli tutorial run (t02-pangraph-output-file.md:220-225 — pangenome
    size, core-genome size, block-frequency distribution), plus the
    compression ratio (input bp / pangenome bp). chip_smoke.py compares it
    with the reference's headline figures, catching merge-trajectory
    degradations that the lossless-roundtrip oracle cannot see."""
    pangenome_bp = sum(b.consensus_len() for b in graph.blocks.values())
    core_ids = set(graph.core_block_ids())
    core_bp = sum(graph.blocks[b].consensus_len() for b in core_ids)
    input_bp = sum(p.tot_len for p in graph.paths.values())
    depth_hist: dict = {}
    for b in graph.blocks.values():
        depth_hist[len(b.alignments)] = depth_hist.get(len(b.alignments), 0) + 1
    return {
        "input_bp": input_bp,
        "pangenome_bp": pangenome_bp,
        "core_bp": core_bp,
        "core_fraction": round(core_bp / pangenome_bp, 4) if pangenome_bp else 0.0,
        "compression": round(input_bp / pangenome_bp, 3) if pangenome_bp else 0.0,
        "n_blocks": len(graph.blocks),
        "n_core_blocks": len(core_ids),
        "block_depth_hist": dict(sorted(depth_hist.items())),
    }
