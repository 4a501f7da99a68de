"""BENCHMARK.json against the benchmark's manifest rules, discovery of cells and
metrics by name, and a run without a card."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from pangraph_tpu_torch.align.params import AlignmentArgs, BandedAlignParams, BuildArgs
from port_bench import generators, harness
from port_bench.tiny import tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
MANIFEST = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def test_keys_and_names():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "port_bench/run.py"] and m["paths"] == ["port_bench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    cells = 24
    assert 2 + 14 * cells * (m["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("port_bench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(p["layer"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in m[group]]
        assert len(names) == len(set(names))
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert len(json.dumps(m)) < 64 * 1024


def test_every_cell_finds_its_files():
    configs = {c["name"] for c in MANIFEST["configs"]}
    assert configs == {w["config"] for w in MANIFEST["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MANIFEST["workloads"]:
        _m, _w, config, traffic = harness.load_cell(w["name"])
        assert config["name"] == w["config"] and traffic["kind"] == "build"
        conf = {c["name"]: c for c in MANIFEST["configs"]}[w["config"]]
        assert config["source"] == conf["source"] and config["reduced"] == conf["reduced"]


def test_every_metric_is_found_by_name():
    e2e = {e["name"] for e in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for p in MANIFEST["per_layer"]:
        assert p["moves"] in e2e and p["workloads"] and set(p["workloads"]) <= cells
        assert os.path.exists(os.path.join(harness.HERE, "metrics", p["name"] + ".py"))
    for w in cells:
        got = [m["name"] for m, read in harness.readers(MANIFEST, w)]
        assert got == [p["name"] for p in MANIFEST["per_layer"] if w in p["workloads"]]
        assert got and all(callable(read) for _m, read in harness.readers(MANIFEST, w))


def _digests(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_and_a_metric_are_added_by_adding_files(tmp_path):
    root = tiny_root(str(tmp_path), 4, 3000)
    before = _digests(root)
    pb = os.path.join(root, "port_bench")
    config = harness.load_json(os.path.join(pb, "configs", "ecoli10.json"))
    config["name"] = "extra"
    with open(os.path.join(pb, "configs", "extra.json"), "w") as f:
        json.dump(config, f)
    traffic = harness.load_json(os.path.join(pb, "traffic", "build.json"))
    traffic["align_sample"] = 16
    with open(os.path.join(pb, "traffic", "extra-build.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "metrics", "extra.jobs.py"), "w") as f:
        f.write("def read(record):\n    return record['jobs']\n")
    # the manifest gains entries; no file of the benchmark changes
    m = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    m["configs"].append({"name": "extra", "source": "https://example.org/extra",
                         "file": "port_bench/configs/extra.json", "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "extra-cell", "config": "extra", "traffic": "extra-build", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "extra.jobs", "unit": "jobs", "better": "higher", "source": "host_clock",
                           "layer": "build", "moves": "input_bp_per_s", "workloads": ["extra-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    _m, _w, c, t = harness.load_cell("extra-cell", root)
    assert c["name"] == "extra" and t["align_sample"] == 16
    assert [p["name"] for p, _r in harness.readers(m, "extra-cell", root)] == \
        [p["name"] for p in m["per_layer"] if "extra-cell" in p["workloads"]]
    r = harness.run_cell("extra-cell", 3, 0.2, True, 0.0, root=root, device=None, out=open(os.devnull, "w"))
    assert r["correct"] and r["metrics"]["extra.jobs"]["value"] == r["run"]["jobs"] >= 1


def _add_config(root, name, **changes):
    """Add configuration `name`, ecoli10's with `changes`, and its cell
    `<name>-build` on the build traffic, by a new file and manifest
    entries; return the cell's name."""
    config = harness.load_json(os.path.join(root, "port_bench", "configs", "ecoli10.json"))
    config.update(name=name, **changes)
    with open(os.path.join(root, "port_bench", "configs", name + ".json"), "w") as f:
        json.dump(config, f)
    m = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    m["configs"].append({"name": name, "source": "https://example.org/" + name,
                         "file": f"port_bench/configs/{name}.json", "reduced": [], "why": "a test"})
    m["workloads"].append({"name": name + "-build", "config": name, "traffic": "build", "chips": 1, "why": "a test"})
    for p in m["per_layer"]:
        p["workloads"].append(name + "-build")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return name + "-build"


def test_a_configuration_is_added_by_files_alone(tmp_path):
    root = tiny_root(str(tmp_path), 4, 3000)
    before = _digests(root)
    with open(os.path.join(root, "port_bench", "genomes", "extra_random.py"), "w") as f:
        f.write("import numpy as np\n\n\ndef make(n_genomes, genome_len, seed):\n"
                "    rng = np.random.default_rng(seed)\n"
                "    return [(f'r{i}', np.frombuffer(b'ACGT', np.uint8)[rng.integers(0, 4, genome_len)])"
                " for i in range(n_genomes)]\n")
    got = generators.make({"generator": "extra_random", "n_genomes": 2, "genome_len": 50}, 4, root)
    assert [n for n, _ in got] == ["r0", "r1"] and all(len(s) == 50 for _n, s in got)
    cell = _add_config(root, "chrom", genomes={"generator": "mutation_only", "n_genomes": 4, "genome_len": 3000,
                                               "sub_rate": 0.02},
                       build_args={"circular": True, "jobs": 2, "extra_band_width": 5, "max_alignment_attempts": 4,
                                   "aln_args": {"sensitivity": 20, "beta": 5.0, "indel_len_threshold": 100}})
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    _m, _w, c, _t = harness.load_cell(cell, root)
    args = harness.build_args(c)
    assert args.aln_args == AlignmentArgs(sensitivity=20, beta=5.0, indel_len_threshold=100)
    assert args.banded_params == BandedAlignParams(max_alignment_attempts=4)
    r = harness.run_cell(cell, 2**31 + 5, 0.2, False, 0.0, root=root, device=None, out=open(os.devnull, "w"))
    assert r["correct"] and r["run"]["jobs"] >= 1
    assert all(ch["value"] == 0 for ch in r["checks"].values())


BAD = {
    "unknown generator": ({"genomes": {"generator": "no_such_thing", "n_genomes": 2, "genome_len": 3000}},
                          FileNotFoundError, r"genomes/no_such_thing\.py"),
    "unknown key": ({"build_args": {"circular": True, "jbos": 4}}, ValueError, r"build_args: BuildArgs has no 'jbos'"),
    "unknown group key": ({"build_args": {"aln_args": {"sensitivty": 20}}}, ValueError,
                          r"build_args.aln_args: AlignmentArgs has no 'sensitivty'"),
    "overridden group key": ({"build_args": {"max_alignment_attempts": 4,
                                             "banded_params": {"max_alignment_attempts": 2}}},
                             ValueError, r"banded_params.max_alignment_attempts is 2, but BuildArgs sets 4"),
    "scoring": ({"build_args": {"banded_params": {"penalty_gap_open": 8}}}, ValueError,
                r"scoring.gap_open 6 against banded_params 8"),
    "gap extension": ({"build_args": {"banded_params": {"penalty_gap_extend": 1}}}, ValueError,
                      r"penalty_gap_extend 1"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_a_bad_configuration_raises_at_load(tmp_path, case):
    changes, error, message = BAD[case]
    root = tiny_root(str(tmp_path), 4, 3000)
    cell = _add_config(root, "bad", **changes)
    with pytest.raises(error, match=message):
        harness.load_cell(cell, root)


def test_ecoli10_build_args():
    _m, _w, config, _t = harness.load_cell("ecoli10-build")
    assert harness.build_args(config) == BuildArgs(circular=True, jobs=4, max_self_map=100, extra_band_width=5,
                                                   max_alignment_attempts=4)


def _run_py(cwd):
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload", "ecoli10-build", "--seed",
                           "2147483701", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_py(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_a_checkout_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    out = _run_py(harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and list(r)[-1] == "checks"
