"""The benchmark's generator copy makes the port's genomes byte for byte."""
import numpy as np
import pytest

from pangraph_tpu_torch.utils import synth
from port_bench import generators


def _same(mine, theirs):
    assert [n for n, _ in mine] == [r.seq_name for r in theirs]
    for (_, a), r in zip(mine, theirs):
        assert a.dtype == np.uint8 and np.array_equal(a, r.seq)


@pytest.mark.parametrize("n, length, seed", [(3, 20_000, 5), (5, 3_000, 7), (34, 5_000, 1), (2, 60_000, 2**31 + 11)])
def test_accessory_pangenome_matches_the_port(n, length, seed):
    _same(generators.accessory_pangenome(n, length, seed), synth.make_accessory_pangenome(n, length, seed))


def test_make_reads_a_spec():
    spec = {"generator": "accessory_pangenome", "n_genomes": 3, "genome_len": 4_000}
    _same(generators.make(spec, 9), synth.make_accessory_pangenome(3, 4_000, 9))


def test_a_pool_holds_its_bases_and_starts_with_the_seeds_genomes():
    spec = {"generator": "accessory_pangenome", "n_genomes": 4, "genome_len": 3_000}
    pool = generators.pool(spec, 11, 100_000)
    sizes = [sum(len(s) for _n, s in g) for g in pool]
    assert sum(sizes) >= 100_000 > sum(sizes[:-1]) and len(pool) > 2
    _same(pool[0], synth.make_accessory_pangenome(4, 3_000, 11))
    _same(pool[2], synth.make_accessory_pangenome(4, 3_000, [11, 2]))
    assert not np.array_equal(pool[0][0][1], pool[1][0][1])
    assert len(generators.pool(spec, 11, 1)) == 1
