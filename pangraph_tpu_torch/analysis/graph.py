"""Graph analysis API (reference: pypangraph/class_graph.py).

Wraps the core Pangraph with strain-name-keyed accessors and pandas
dataframes: block counts, block stats, path dictionaries, pairwise accessory
comparison, core-genome alignment.
"""
from __future__ import annotations

import itertools

import numpy as np

from pangraph_tpu_torch.graph.graph import Pangraph
from pangraph_tpu_torch.graph.seq import revcomp, to_str


class AnalysisGraph:
    def __init__(self, graph: Pangraph):
        self.graph = graph

    # ---------------------------------------------------------------- loading
    @staticmethod
    def load_json(path, validate: bool = False) -> "AnalysisGraph":
        g = Pangraph.from_file(path)
        if validate:
            import json

            import jsonschema

            from pangraph_tpu_torch.schema import generate_schema

            jsonschema.validate(g.to_json_dict(), generate_schema())
        return AnalysisGraph(g)

    # --------------------------------------------------------------- accessors
    @property
    def paths(self):
        return self.graph.paths

    @property
    def blocks(self):
        return self.graph.blocks

    @property
    def nodes(self):
        return self.graph.nodes

    def strains(self) -> list:
        return [p.name for p in self.graph.paths.values()]

    def path_by_name(self, name: str):
        return self.graph.paths[self.graph.path_id_by_name(name)]

    def block_consensus(self, bid) -> str:
        return to_str(self.graph.blocks[bid].consensus)

    def block_alignment(self, bid) -> dict:
        """{path name -> aligned sequence string} for one block."""
        block = self.graph.blocks[bid]
        out = {}
        for nid, e in block.alignments.items():
            pname = self.graph.paths[self.graph.nodes[nid].path_id].name
            out.setdefault(pname, []).append(to_str(e.apply_aligned(block.consensus)))
        return out

    def block_sequences(self, bid) -> dict:
        """{node id -> full unaligned sequence string} for one block."""
        block = self.graph.blocks[bid]
        return {nid: to_str(e.apply(block.consensus)) for nid, e in block.alignments.items()}

    # -------------------------------------------------------------- dataframes
    def to_blockcount_df(self):
        """Rows: block ids; columns: strain names; values: occurrence counts."""
        import pandas as pd

        names = {pid: (p.name if p.name is not None else str(pid)) for pid, p in self.graph.paths.items()}
        counts = {bid: {n: 0 for n in names.values()} for bid in self.graph.blocks}
        for node in self.graph.nodes.values():
            counts[node.block_id][names[node.path_id]] += 1
        return pd.DataFrame.from_dict(counts, orient="index").sort_index()

    def to_blockstats_df(self):
        """Index: block ids; columns: count / n_strains / duplicated / len / core."""
        import pandas as pd

        n_paths = len(self.graph.paths)
        rows = {}
        for bid, block in self.graph.blocks.items():
            pids = [self.graph.nodes[nid].path_id for nid in block.alignments]
            n_strains = len(set(pids))
            count = len(pids)
            rows[bid] = {
                "count": count,
                "n_strains": n_strains,
                "duplicated": count > n_strains,
                "len": block.consensus_len(),
                "core": (n_strains == n_paths) and (count == n_paths),
            }
        return pd.DataFrame.from_dict(rows, orient="index").sort_index()

    def to_path_dictionary(self) -> dict:
        """{strain name -> [(block id, strand bool)]}"""
        out = {}
        for path in self.graph.paths.values():
            name = path.name if path.name is not None else path.id
            out[name] = [
                (self.graph.nodes[nid].block_id, self.graph.nodes[nid].strand == "+") for nid in path.nodes
            ]
        return out

    def pairwise_accessory_genome_comparison(self):
        """MultiIndex (path_i, path_j) -> shared / diff pangenome bp."""
        import pandas as pd

        pa = self.to_blockcount_df() > 0
        lens = self.to_blockstats_df().loc[pa.index, "len"]
        rows = []
        for i, j in itertools.combinations_with_replacement(pa.columns, 2):
            shared = int(((pa[i] & pa[j]) * lens).sum())
            diff = int(((pa[i] ^ pa[j]) * lens).sum())
            rows.append({"path_i": i, "path_j": j, "shared": shared, "diff": diff})
            if i != j:
                rows.append({"path_i": j, "path_j": i, "shared": shared, "diff": diff})
        return pd.DataFrame(rows).set_index(["path_i", "path_j"])

    # ------------------------------------------------------------ core genome
    def core_genome_alignment(self, guide_strain: str = None) -> dict:
        """{strain name -> concatenated aligned core sequence}, core blocks
        ordered/oriented by the guide strain (class_graph.py:160+)."""
        strains = self.strains()
        if guide_strain is None:
            guide_strain = strains[0]
        if guide_strain not in strains:
            raise ValueError(f"Guide strain {guide_strain} not found")
        core = set(self.graph.core_block_ids())
        guide = self.path_by_name(guide_strain)
        out = {s: [] for s in strains}
        for nid in guide.nodes:
            node = self.graph.nodes[nid]
            if node.block_id not in core:
                continue
            block = self.graph.blocks[node.block_id]
            for bnid, e in block.alignments.items():
                pname = self.graph.paths[self.graph.nodes[bnid].path_id].name
                seq = e.apply_aligned(block.consensus)
                if node.strand == "-":
                    seq = revcomp(seq)
                out[pname].append(to_str(seq))
        return {s: "".join(parts) for s, parts in out.items()}
