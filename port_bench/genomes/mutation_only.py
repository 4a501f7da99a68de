"""The benchmark's copy of the port's mutation-only generator
(`make_synthetic` of `pangraph_tpu_torch/utils/synth.py`): one random
ancestor, then `mutate` per genome, the same random draws in the same
order, so the same genomes byte for byte for the same arguments and seed.
Every pair of genomes is about 2 * sub_rate divergent and the built graph
is almost all core."""
import numpy as np

from port_bench.generators import ACGT, mutate


def make(n_genomes: int, genome_len: int, seed=0, sub_rate: float = 0.01) -> list:
    rng = np.random.default_rng(seed)
    ancestor = ACGT[rng.integers(0, 4, genome_len)]
    return [(f"synth_{gi}", mutate(ancestor, rng, sub_rate)) for gi in range(n_genomes)]
