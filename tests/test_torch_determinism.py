"""Thread-count and run-to-run determinism of the port's build
(pangraph_tpu_torch/build/build.py), the counterpart of
tests/test_determinism.py on a synth input (4 x ~7 kb from
make_accessory_pangenome) in place of the plasmid FASTA.

On both routes (the kernel route, device="cpu" with the plain versions of
the kernels, and the host route, the host C++ engine) the graph of
jobs=1 and the graphs of two jobs=4 builds must be byte-equal. The second
kernel-route jobs=4 build runs under a long broker gather window, so that
concurrent merges' device legs ride combined rounds: coalescing must not
change the graph. The kernel route's graph must also equal the reference's
with like routing (NATIVE_CELL_BUDGET = 0, the Pallas kernels in interpret
mode)."""
from __future__ import annotations

import pytest

from pangraph_tpu.align.params import BuildArgs
from pangraph_tpu.build.build import build as ref_build
from pangraph_tpu.utils.synth import make_accessory_pangenome
from pangraph_tpu_torch.build.build import build as port_build
from pangraph_tpu_torch.ops.batch_align import BatchAligner
from test_torch_build import graph_json, port_aligner, port_args, port_records, ref_aligner

ROUTES = {"kernel": "cpu", "host": None}


@pytest.fixture(scope="module")
def records():
    return make_accessory_pangenome(4, 3000, seed=7)


@pytest.fixture(scope="module")
def graphs(records):
    """Per route: the jobs=1 graph, two jobs=4 graphs, and the broker's
    receipt of the second jobs=4 build."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for route, device in ROUTES.items():
            g = out[route] = {}
            for key, jobs, gather in (("jobs1", 1, None), ("jobs4", 4, None), ("jobs4_again", 4, 0.2)):
                if gather is not None:
                    mp.setattr(BatchAligner, "BROKER_GATHER_S", gather)
                pargs = port_args(BuildArgs(circular=True, jobs=jobs))
                BatchAligner.reset_engine_stats()
                g[key] = graph_json(port_build(port_records(records), pargs, aligner=port_aligner(pargs, device)))
                g["broker"] = BatchAligner.engine_report()["broker"]
                mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_build_deterministic_across_thread_counts(graphs, route):
    assert graphs[route]["jobs4"] == graphs[route]["jobs1"]


@pytest.mark.parametrize("route", ROUTES)
def test_build_deterministic_across_runs(graphs, route):
    assert graphs[route]["jobs4_again"] == graphs[route]["jobs4"]


def test_coalesced_rounds_keep_the_graph(graphs):
    """The kernel route's second jobs=4 build did merge legs of concurrent
    merges into combined rounds (and its graph is checked above)."""
    assert graphs["kernel"]["broker"]["max_legs"] >= 2, graphs["kernel"]["broker"]
    assert graphs["host"]["broker"]["rounds"] == 0


def test_kernel_route_build_matches_reference(records, graphs):
    args = BuildArgs(circular=True, jobs=1)
    assert graph_json(ref_build(records, args, aligner=ref_aligner(args, True))) == graphs["kernel"]["jobs1"]
