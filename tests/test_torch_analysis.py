"""The port's analysis layer and pypangraph facade (pangraph_tpu_torch.analysis,
pangraph_tpu_torch.pypangraph) held against the reference's: the same graph
JSON loaded through both packages gives equal walks, junctions, minimal
synteny units, junction-context GFA, dataframes and dotplot. The graphs are
the reference's host-route build of 4 x 20 kb circular genomes and
hand-built circular, linear, inversion and sequence graphs like those of
tests/test_pypangraph_junctions_ported.py. The dataframe parts need pandas,
the dotplot matplotlib and validation jsonschema; each skips where its
package is absent."""
from __future__ import annotations

import json

import pytest

import pangraph_tpu.analysis as ref_an
import pangraph_tpu.analysis.export as ref_export
import pangraph_tpu.analysis.junctions_gfa as ref_jgfa
import pangraph_tpu.analysis.msu as ref_msu
import pangraph_tpu.analysis.topology as ref_topo
import pangraph_tpu.pypangraph as ref_ppg
import pangraph_tpu_torch.analysis as port_an
import pangraph_tpu_torch.analysis.export as port_export
import pangraph_tpu_torch.analysis.junctions_gfa as port_jgfa
import pangraph_tpu_torch.analysis.msu as port_msu
import pangraph_tpu_torch.analysis.topology as port_topo
import pangraph_tpu_torch.pypangraph as port_ppg


def _node(node_id, block_id, path_id, strand, start, end):
    return {"id": node_id, "block_id": block_id, "path_id": path_id,
            "strand": "+" if strand else "-", "position": [start, end]}


def _block(block_id, consensus, node_ids, edits=None):
    empty = {"subs": [], "dels": [], "inss": []}
    return {"id": block_id, "consensus": consensus,
            "alignments": {str(n): (edits or {}).get(n, empty) for n in node_ids}}


def _path(path_id, name, node_ids, tot_len, circular=True):
    return {"id": path_id, "nodes": node_ids, "tot_len": tot_len, "circular": circular, "name": name, "desc": None}


def _graph(node_rows, block_rows, path_rows):
    return {"paths": {str(p["id"]): p for p in path_rows},
            "blocks": {str(b["id"]): b for b in block_rows},
            "nodes": {str(r[0]): _node(*r) for r in node_rows}}


def junction_graph():
    """3 circular strains, 4 core and 3 accessory blocks; s3 swaps C2 and C3
    and inverts A2."""
    nodes = [(1, 100, 0, True, 0, 1000), (2, 500, 0, True, 1000, 1200), (3, 600, 0, True, 1200, 1350),
             (4, 200, 0, True, 1350, 2150), (5, 300, 0, True, 2150, 2750), (6, 400, 0, True, 2750, 3450),
             (7, 100, 1, True, 0, 1000), (8, 500, 1, True, 1000, 1200), (9, 200, 1, True, 1200, 2000),
             (10, 700, 1, True, 2000, 2300), (11, 300, 1, True, 2300, 2900), (12, 400, 1, True, 2900, 3600),
             (13, 100, 2, True, 0, 1000), (14, 600, 2, False, 1000, 1150), (15, 300, 2, True, 1150, 1750),
             (16, 200, 2, True, 1750, 2550), (17, 700, 2, True, 2550, 2850), (18, 400, 2, True, 2850, 3550)]
    blocks = [_block(100, "A" * 1000, [1, 7, 13]), _block(200, "A" * 800, [4, 9, 16]),
              _block(300, "A" * 600, [5, 11, 15]), _block(400, "A" * 700, [6, 12, 18]),
              _block(500, "A" * 200, [2, 8]), _block(600, "A" * 150, [3, 14]), _block(700, "A" * 300, [10, 17])]
    paths = [_path(0, "s1", [1, 2, 3, 4, 5, 6], 3450), _path(1, "s2", [7, 8, 9, 10, 11, 12], 3600),
             _path(2, "s3", [13, 14, 15, 16, 17, 18], 3550)]
    return _graph(nodes, blocks, paths), 500


def linear_graph():
    """2 linear strains; c5 is core but below the backbone threshold, at
    opposite ends."""
    nodes = [(1, 500, 0, True, 0, 200), (2, 100, 0, True, 200, 1200), (3, 600, 0, True, 1200, 1350),
             (4, 200, 0, True, 1350, 2150), (5, 300, 0, True, 2150, 2750),
             (6, 100, 1, True, 0, 1000), (7, 700, 1, True, 1000, 1300), (8, 200, 1, True, 1300, 2100),
             (9, 300, 1, True, 2100, 2700), (10, 500, 1, True, 2700, 2900)]
    blocks = [_block(100, "A" * 1000, [2, 6]), _block(200, "A" * 800, [4, 8]), _block(300, "A" * 600, [5, 9]),
              _block(500, "A" * 200, [1, 10]), _block(600, "A" * 150, [3]), _block(700, "A" * 300, [7])]
    paths = [_path(0, "s1", [1, 2, 3, 4, 5], 2750, circular=False),
             _path(1, "s2", [6, 7, 8, 9, 10], 2900, circular=False)]
    return _graph(nodes, blocks, paths), 500


def sequence_graph():
    """One junction, forward in s1 and inverted in s2, with a substitution."""
    sub = {"subs": [{"pos": 0, "alt": "T"}], "dels": [], "inss": []}
    nodes = [(1, 10, 0, True, 0, 6), (2, 30, 0, True, 6, 9), (3, 20, 0, True, 9, 15),
             (4, 20, 1, False, 0, 6), (5, 40, 1, False, 6, 9), (6, 10, 1, False, 9, 15)]
    blocks = [_block(10, "AAACCC", [1, 6], edits={6: sub}), _block(20, "GGGAAA", [3, 4]),
              _block(30, "TTC", [2]), _block(40, "ACG", [5])]
    paths = [_path(0, "s1", [1, 2, 3], 15), _path(1, "s2", [4, 5, 6], 15)]
    return _graph(nodes, blocks, paths), 4


def inversion_graph():
    """s2 is s1 reverse-complemented whole; s3 inverts a run of core blocks."""
    cons = {10: "ACGTTGCAACCA", 20: "TTGGAACCGGTTAC", 30: "GATTACAGGCT", 40: "CCAGTACGTGACATCA",
            50: "ACACGTGTACGTA", 60: "TGTCATGCAATGCAT", 70: "GGATCCGAATTCAGTCA", 80: "ACGTGA", 90: "TTCAGGCA"}
    nodes = [(1, 10, 0, True, 0, 12), (2, 50, 0, True, 12, 25), (3, 80, 0, True, 25, 31),
             (4, 20, 0, True, 31, 45), (5, 60, 0, True, 45, 60), (6, 30, 0, True, 60, 71),
             (7, 70, 0, True, 71, 88), (8, 90, 0, False, 88, 96), (9, 40, 0, True, 96, 112),
             (10, 40, 1, False, 0, 16), (11, 90, 1, True, 16, 24), (12, 70, 1, False, 24, 41),
             (13, 30, 1, False, 41, 52), (14, 60, 1, False, 52, 67), (15, 20, 1, False, 67, 81),
             (16, 80, 1, False, 81, 87), (17, 50, 1, False, 87, 100), (18, 10, 1, False, 100, 112),
             (19, 10, 2, True, 0, 12), (20, 50, 2, True, 12, 25), (21, 20, 2, True, 25, 39),
             (22, 60, 2, True, 39, 54), (23, 70, 2, False, 54, 71), (24, 30, 2, False, 71, 82),
             (25, 40, 2, True, 82, 98)]
    members = {10: [1, 18, 19], 20: [4, 15, 21], 30: [6, 13, 24], 40: [9, 10, 25], 50: [2, 17, 20],
               60: [5, 14, 22], 70: [7, 12, 23], 80: [3, 16], 90: [8, 11]}
    blocks = [_block(b, cons[b], nids) for b, nids in members.items()]
    paths = [_path(0, "s1", [1, 2, 3, 4, 5, 6, 7, 8, 9], 112), _path(1, "s2", list(range(10, 19)), 112),
             _path(2, "s3", list(range(19, 26)), 98)]
    return _graph(nodes, blocks, paths), 10


@pytest.fixture(scope="module")
def synth_json(tmp_path_factory):
    """The reference's host-route build of 4 x 20 kb circular genomes."""
    from pangraph_tpu.cli import main as ref_main
    from pangraph_tpu.io.fasta import write_fasta
    from pangraph_tpu.utils.synth import make_accessory_pangenome

    d = tmp_path_factory.mktemp("analysis")
    write_fasta(str(d / "in.fa"), make_accessory_pangenome(n_genomes=4, genome_len=20_000, seed=13))
    assert ref_main(["build", str(d / "in.fa"), "-c", "--no-tpu", "--no-progress-bar",
                     "-o", str(d / "graph.json")]) == 0
    return d / "graph.json"


HAND_BUILT = {"junction": junction_graph, "linear": linear_graph, "sequence": sequence_graph,
              "inversion": inversion_graph}
GRAPHS = ["synth", *HAND_BUILT]


@pytest.fixture(params=GRAPHS)
def loaded(request, synth_json, tmp_path):
    """(reference AnalysisGraph, port AnalysisGraph, backbone threshold) of
    one graph JSON, loaded through each package's pypangraph facade."""
    if request.param == "synth":
        path, L_thr = synth_json, 100
    else:
        data, L_thr = HAND_BUILT[request.param]()
        path = tmp_path / "g.json"
        path.write_text(json.dumps(data))
    return (ref_ppg.Pangraph.from_json(str(path), validate=False),
            port_ppg.Pangraph.from_json(str(path), validate=False), L_thr)


def ob(o):
    return None if o is None else (o.id, o.strand)


def walk(w):
    return tuple(ob(o) for o in w.oriented_blocks), w.circular


def junction(j):
    return ob(j.left), walk(j.center), ob(j.right)


def _is_backbone(an, L_thr):
    core = set(an.graph.core_block_ids())
    return lambda bid: bid in core and an.graph.blocks[bid].consensus_len() >= L_thr


def test_walks_and_categories(loaded):
    ref, port, _ = loaded
    rw, pw = ref_topo.pangraph_to_walks(ref), port_topo.pangraph_to_walks(port)
    assert {k: walk(w) for k, w in pw.items()} == {k: walk(w) for k, w in rw.items()}
    norm = lambda cats: [(c, tuple(ob(o) for o in obs), isos) for c, obs, isos in cats]  # noqa: E731
    assert norm(port_topo.walk_categories(pw)) == norm(ref_topo.walk_categories(rw))
    assert port_topo.find_mergers(pw) == ref_topo.find_mergers(rw)
    assert sum(c for c, _, _ in port_topo.walk_categories(pw)) == len(port.strains())


def test_path_junction_split(loaded):
    ref, port, L_thr = loaded
    rw, pw = ref_topo.pangraph_to_walks(ref), port_topo.pangraph_to_walks(port)
    n = 0
    for iso in rw:
        want = [junction(j) for j in ref_an.path_junction_split(rw[iso], _is_backbone(ref, L_thr))]
        got = [junction(j) for j in port_an.path_junction_split(pw[iso], _is_backbone(port, L_thr))]
        assert got == want, iso
        n += len(got)
    assert n > 0


def test_backbone_junctions(loaded):
    pytest.importorskip("pandas")
    from pandas.testing import assert_frame_equal

    ref, port, L_thr = loaded
    rb, pb = ref_an.BackboneJunctions(ref, L_thr=L_thr), port_an.BackboneJunctions(port, L_thr=L_thr)
    assert pb.edges() == rb.edges() and pb.edges()
    assert {iso: [junction(j) for j in js] for iso, js in pb.junctions_by_isolate().items()} == {
        iso: [junction(j) for j in js] for iso, js in rb.junctions_by_isolate().items()}
    assert_frame_equal(pb.positions(), rb.positions())
    assert_frame_equal(pb.stats(), rb.stats())
    for e in rb.edges() + ["999_f__888_f"]:
        assert pb.sequences(e) == rb.sequences(e), e


@pytest.mark.parametrize("rotate", [False, True])
def test_minimal_synteny_units(loaded, rotate):
    pytest.importorskip("pandas")
    ref, port, L_thr = loaded
    if rotate and not all(p.circular for p in ref.paths.values()):
        for msu, an in ((ref_msu, ref), (port_msu, port)):
            with pytest.raises(ValueError, match="circular"):
                msu.minimal_synteny_units(an, L_thr, rotate=True)
        return
    rm, rp, rl = ref_an.minimal_synteny_units(ref, L_thr, rotate=rotate)
    pm, pp, pl = port_an.minimal_synteny_units(port, L_thr, rotate=rotate)
    assert (pm, pl) == (rm, rl) and pl
    assert {k: walk(w) for k, w in pp.items()} == {k: walk(w) for k, w in rp.items()}


@pytest.mark.parametrize("scaffold", ["consensus", "all", "s1"])
def test_junction_context_gfa(loaded, scaffold, tmp_path):
    pytest.importorskip("pandas")
    ref, port, L_thr = loaded
    rb, pb = ref_an.BackboneJunctions(ref, L_thr=L_thr), port_an.BackboneJunctions(port, L_thr=L_thr)
    if scaffold == "s1" and "s1" not in ref.strains():
        scaffold = ref.strains()[0]
    want = ref_jgfa.junction_context_gfa(rb, scaffold)
    got = port_jgfa.junction_context_gfa(pb, scaffold)
    assert got == want
    ref_jgfa.write_junction_gfa(str(tmp_path / "ref.gfa"), *want[:3])
    port_jgfa.write_junction_gfa(str(tmp_path / "port.gfa"), *got[:3])
    assert (tmp_path / "port.gfa").read_text() == (tmp_path / "ref.gfa").read_text()
    with pytest.raises(ValueError, match="unknown scaffold"):
        port_jgfa.junction_context_gfa(pb, "no-such-isolate")


@pytest.mark.parametrize("transform", [None, lambda n: 0.001 * n, lambda n: 10 * n ** 0.5])
def test_export_gfa_write(tmp_path, transform):
    segments = {"a": 1500, "J0__b": 40, "c": 3}
    links = [("a", True, "J0__b", False), ("J0__b", "-", "c", "+"), ("c", False, "a", True)]
    depths = {"a": 4, "c": 2}
    ref_export.GFA(segments, links, depths=depths).write(str(tmp_path / "ref.gfa"), length_transform=transform)
    port_export.GFA(segments, links, depths=depths).write(str(tmp_path / "port.gfa"), length_transform=transform)
    text = (tmp_path / "ref.gfa").read_text()
    assert text.startswith("H\tVN:Z:1.0") and text.count("\nL\t") == 3
    assert (tmp_path / "port.gfa").read_text() == text


def test_dataframes(loaded):
    pytest.importorskip("pandas")
    from pandas.testing import assert_frame_equal

    ref, port, _ = loaded
    assert_frame_equal(port.to_blockcount_df(), ref.to_blockcount_df())
    assert_frame_equal(port.to_blockstats_df(), ref.to_blockstats_df())
    assert_frame_equal(port.pairwise_accessory_genome_comparison(), ref.pairwise_accessory_genome_comparison())
    assert port.to_path_dictionary() == ref.to_path_dictionary()
    assert port.core_genome_alignment() == ref.core_genome_alignment()
    bid = sorted(ref.blocks)[0]
    assert port.block_alignment(bid) == ref.block_alignment(bid)
    assert port.block_sequences(bid) == ref.block_sequences(bid)
    assert port.block_consensus(bid) == ref.block_consensus(bid)


def test_dotplot(loaded):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    ref, port, _ = loaded
    s0, s1 = ref.strains()[:2]
    lines = []
    for ppg, an in ((ref_ppg, ref), (port_ppg, port)):
        ax = ppg.dotplot(an, s0, s1)
        lines.append(sorted((tuple(ln.get_xdata()), tuple(ln.get_ydata()), ln.get_color()) for ln in ax.lines))
        plt.close(ax.figure)
    assert lines[1] == lines[0] and lines[0]


def test_pypangraph_facade_symbols(synth_json, tmp_path):
    """The facade exports what the reference's pypangraph/__init__.py does,
    and each symbol works on the port's graph."""
    assert set(port_ppg.__all__) == set(ref_ppg.__all__) == {
        "Pangraph", "PangraphLoadError", "minimal_synteny_units", "dotplot", "junctions", "export"}
    g = port_ppg.Pangraph.from_json(str(synth_json), validate=False)
    assert isinstance(g, port_an.AnalysisGraph) and len(g.strains()) == 4
    assert port_ppg.junctions.BackboneJunctions is port_an.BackboneJunctions
    assert port_ppg.minimal_synteny_units is port_an.minimal_synteny_units
    assert port_ppg.export.GFA is port_export.GFA
    assert port_ppg.export.junction_context_gfa is port_jgfa.junction_context_gfa


def test_pangraph_load_error(tmp_path):
    bad_json = tmp_path / "broken.json"
    bad_json.write_text("{not json")
    for ppg in (ref_ppg, port_ppg):
        with pytest.raises(ppg.PangraphLoadError, match="should be in .json"):
            ppg.Pangraph.from_json("not-a-json.txt")
        with pytest.raises(ppg.PangraphLoadError, match="failed to load"):
            ppg.Pangraph.from_json(str(bad_json), validate=False)


def test_load_json_validates_against_the_schema(synth_json, tmp_path):
    pytest.importorskip("jsonschema")
    g = port_ppg.Pangraph.from_json(str(synth_json))
    assert len(g.strains()) == 4
    doc = json.loads(synth_json.read_text())
    node = next(iter(doc["nodes"].values()))
    node["strand"] = "x"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    for ppg in (ref_ppg, port_ppg):
        with pytest.raises(ppg.PangraphLoadError):
            ppg.Pangraph.from_json(str(bad))


def test_pandas_free_counts_match_the_layer(loaded):
    """chip_smoke.py's MSU and backbone-junction counts for machines without
    pandas equal those of minimal_synteny_units and BackboneJunctions."""
    pytest.importorskip("pandas")
    import chip_smoke

    _, port, L_thr = loaded
    counts = chip_smoke._pandas_free_counts(port, L_thr)
    assert counts["msu"] == len(port_an.minimal_synteny_units(port, L_thr, rotate=False)[2])
    assert counts["backbone_junctions"] == len(port_an.BackboneJunctions(port, L_thr=L_thr).edges())
    assert counts["walk_categories"] == len(port_topo.walk_categories(port_topo.pangraph_to_walks(port)))
