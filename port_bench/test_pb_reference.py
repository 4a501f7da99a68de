"""The plain reference: genomes from a graph's JSON, banded DP scores, the
score of an alignment, and what it imports."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pangraph_tpu_torch.align.params import BandParameters, BuildArgs
from pangraph_tpu_torch.build.build import build
from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner
from port_bench import generators, harness
from port_bench.reference import align, graph

SC = align.Scoring()
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module", params=[None, "cpu"], ids=["host", "plain-kernels"])
def built(request):
    genomes = generators.make({"generator": "accessory_pangenome", "n_genomes": 4,
                               "genome_len": 2_500 if request.param else 6_000}, 3)
    args = BuildArgs(circular=True, jobs=2)
    al = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device=request.param)
    return genomes, build(harness.records(genomes), args, aligner=al).to_json()


def test_every_genome_comes_back(built):
    genomes, text = built
    got = graph.genomes(text)
    assert set(got) == {n for n, _ in genomes}
    assert all(np.array_equal(got[n], s) for n, s in genomes)
    assert graph.mismatched(text, dict(genomes)) == 0


def _corrupt_one_edit(text):
    g = json.loads(text)
    for b in g["blocks"].values():
        for e in b["alignments"].values():
            if e["subs"]:
                s = e["subs"][0]
                s["alt"] = "A" if s["alt"] != "A" else "C"
                return json.dumps(g)
            if e["dels"]:
                e["dels"][0]["len"] += 1
                return json.dumps(g)
    raise AssertionError("no edit to corrupt")


def test_one_corrupted_edit_is_caught(built):
    genomes, text = built
    assert graph.mismatched(_corrupt_one_edit(text), dict(genomes)) >= 1


def test_a_graph_that_does_not_parse_fails_every_genome(built):
    genomes, text = built
    assert graph.mismatched(text[: len(text) // 2], dict(genomes)) == len(genomes)


def _brute(ref, qry, ms, W):
    """The banded DP cell by cell, the module's recurrences written out."""
    NEG = -10**9
    rl, ql = len(ref), len(qry)
    H, F, best = {}, {}, NEG
    for i in range(rl + 1):
        E = NEG
        for q in range(ql + 1):
            if not (0 <= q <= ql and -ms - W <= q - i <= -ms + W):
                E = NEG
                continue
            if i == 0 or q == 0:
                h = n = 0
                f = NEG
            else:
                m = H.get((i - 1, q - 1), NEG) + int(SC.pair(ref[i - 1 : i], qry[q - 1 : q])[0])
                f = max(F.get((i - 1, q), NEG), H.get((i - 1, q), NEG) - (0 if q == ql else SC.gap_open))
                n = max(m, f)
                h = max(n, E)
            H[(i, q)], F[(i, q)] = h, f
            if i:
                E = max(E, n - (0 if i == rl else SC.gap_open))
            if i == rl or q == ql:
                best = max(best, h)
    return best


def _pairs(rng, n, lo, hi, alphabet=b"ACGTN"):
    letters = np.frombuffer(alphabet, np.uint8)
    jobs = []
    for _ in range(n):
        ref = ACGT[rng.integers(0, 4, int(rng.integers(lo, hi)))]
        q = list(ref)
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, len(q)))
            op = rng.integers(0, 3)
            if op == 0:
                q[p] = letters[rng.integers(0, len(letters))]
            elif op == 1 and len(q) > 4:
                del q[p : p + int(rng.integers(1, 4))]
            else:
                q[p:p] = list(ACGT[rng.integers(0, 4, int(rng.integers(1, 4)))])
        jobs.append((ref, np.array(q, np.uint8), int(rng.integers(-3, 4)), int(rng.integers(2, 8))))
    return jobs


def test_best_scores_are_the_recurrences():
    jobs = _pairs(np.random.default_rng(0), 50, 2, 40)
    assert list(align.best_scores(jobs, SC)) == [_brute(*j) for j in jobs]


def test_control_traceback_scores_its_best_where_int16_holds():
    jobs = _pairs(np.random.default_rng(1), 30, 5, 60)
    best = align.best_scores(jobs, SC)
    for j, e, b in zip(jobs, align.control_alignments(jobs, SC), best):
        assert align.edit_score(j[0], j[1], e, SC) == (True, b)


def test_edit_score_rejects_an_edit_that_does_not_make_the_query():
    ref = ACGT[np.random.default_rng(2).integers(0, 4, 50)]
    qry = ref.copy()
    qry[10] = ACGT[(np.searchsorted(ACGT, qry[10]) + 1) % 4]
    good = {"subs": [(10, int(qry[10]))], "dels": [], "inss": []}
    assert align.edit_score(ref, qry, good, SC) == (True, 49 * 3 - 1)
    bad = {"subs": [(11, int(qry[10]))], "dels": [], "inss": []}
    assert align.edit_score(ref, qry, bad, SC)[0] is False


def test_a_suboptimal_alignment_shows_a_gap():
    rng = np.random.default_rng(3)
    ref = ACGT[rng.integers(0, 4, 300)]
    qry = np.concatenate([ref[:100], ref[103:]])  # one 3 bp deletion
    best = align.best_scores([(ref, qry, 0, 10)], SC)[0]
    optimal = {"subs": [], "dels": [(100, 3)], "inss": []}
    assert align.edit_score(ref, qry, optimal, SC) == (True, best)
    # ten bases deleted and seven put back: valid, seven matches and a gap below
    detour = {"subs": [], "dels": [(100, 10)], "inss": [(110, bytes(ref[103:110]))]}
    assert align.edit_score(ref, qry, detour, SC) == (True, best - 7 * 3 - 6)
    # every base as a gap: free at the ends, valid, far below
    all_gap = {"subs": [], "dels": [(0, 300)], "inss": [(0, bytes(qry))]}
    ok, s = align.edit_score(ref, qry, all_gap, SC)
    assert ok and s == 0 and best - s > 800


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "plain-kernels"])
def test_the_ports_alignments_meet_the_band_optimum(device):
    rng = np.random.default_rng(4)
    jobs = []
    for _ in range(24):
        ref = ACGT[rng.integers(0, 4, int(rng.integers(200, 1500)))]
        q = ref.copy()
        idx = rng.choice(len(q), len(q) // 50, replace=False)
        q[idx] = ACGT[rng.integers(0, 4, len(idx))]
        q = list(q)
        for _ in range(int(rng.integers(0, 6))):
            p, L = int(rng.integers(0, len(q))), int(rng.integers(1, 25))
            if rng.random() < 0.5:
                del q[p : p + L]
            else:
                q[p:p] = list(ACGT[rng.integers(0, 4, L)])
        jobs.append(AlignJob(ref, np.array(q, np.uint8), BandParameters(int(rng.integers(-4, 5)),
                                                                        int(rng.integers(5, 40)))))
    al = BatchAligner(device=device)
    edits = al.align_many(jobs)
    band = [(j.ref, j.qry, j.band.mean_shift, min(j.band.band_width + al.extra, 1023) - 1) for j in jobs]
    gaps = []
    for j, e, b in zip(jobs, edits, align.best_scores(band, SC)):
        ok, s = align.edit_score(j.ref, j.qry, harness.edit_dict(e), SC)
        assert ok
        gaps.append(b - s)
    assert max(gaps) <= 0 and gaps.count(0) >= len(gaps) // 3


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=harness.ROOT, check=True,
                         env={**os.environ, "PYTHONPATH": harness.ROOT})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program_or_jax():
    mods = _top_level_modules("import port_bench.reference.align, port_bench.reference.graph")
    assert not mods & {"jax", "jaxlib", "flax", "pangraph_tpu", "pangraph_tpu_torch"}


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    from port_bench.tiny import tiny_root

    root = tiny_root(str(tmp_path), 4, 3000)
    mods = _top_level_modules(
        "import time, io\nfrom port_bench import harness\n"
        f"r = harness.run_cell('ecoli10-build', 5, 0.5, True, time.perf_counter(), root={root!r}, device=None,"
        " out=io.StringIO())\nassert r['correct'], r['checks']")
    assert "pangraph_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "pangraph_tpu"}
