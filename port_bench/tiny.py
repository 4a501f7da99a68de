"""A copy of the benchmark with the cells cut to a size the CPU tests can
run (the tests' helper; a run here is no measurement)."""
import json
import os
import shutil

from port_bench import harness


def tiny_root(dest: str, n_genomes: int = 4, genome_len: int = 3000, pool_inputs: int = 2) -> str:
    """Copy BENCHMARK.json and port_bench/ into `dest`, with every
    configuration's genomes cut to n_genomes x genome_len and every
    traffic's input pool to about `pool_inputs` inputs; return `dest`."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(harness.HERE, os.path.join(dest, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"), dirs_exist_ok=True)
    conf_dir = os.path.join(dest, "port_bench", "configs")
    for name in os.listdir(conf_dir):
        path = os.path.join(conf_dir, name)
        c = harness.load_json(path)
        c["genomes"].update(n_genomes=n_genomes, genome_len=genome_len)
        with open(path, "w") as f:
            json.dump(c, f)
    traffic_dir = os.path.join(dest, "port_bench", "traffic")
    for name in os.listdir(traffic_dir):
        path = os.path.join(traffic_dir, name)
        t = harness.load_json(path)
        t["pool_bp"] = (pool_inputs - 1) * n_genomes * genome_len + 1
        with open(path, "w") as f:
            json.dump(t, f)
    return dest
