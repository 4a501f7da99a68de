"""The benchmark's generator files, called by name through
generators.make, make the port's genomes byte for byte."""
import numpy as np
import pytest

from pangraph_tpu_torch.utils import synth
from port_bench import generators


def _same(mine, theirs):
    assert [n for n, _ in mine] == [r.seq_name for r in theirs]
    for (_, a), r in zip(mine, theirs):
        assert a.dtype == np.uint8 and np.array_equal(a, r.seq)


def _spec(generator, n, length, **kw):
    return {"generator": generator, "n_genomes": n, "genome_len": length, **kw}


@pytest.mark.parametrize("n, length, seed", [(3, 20_000, 5), (5, 3_000, 7), (34, 5_000, 1), (2, 60_000, 2**31 + 11)])
def test_accessory_pangenome_matches_the_port(n, length, seed):
    _same(generators.make(_spec("accessory_pangenome", n, length), seed),
          synth.make_accessory_pangenome(n, length, seed))


@pytest.mark.parametrize("n, length, seed, kw", [(4, 25_000, 3, {"sub_rate": 0.005}), (3, 4_000, 2**31 + 7, {}),
                                                 (2, 60_000, [5, 1], {"sub_rate": 0.02})])
def test_mutation_only_matches_the_port(n, length, seed, kw):
    _same(generators.make(_spec("mutation_only", n, length, **kw), seed), synth.make_synthetic(n, length, seed, **kw))


def test_make_reads_a_spec():
    spec = _spec("accessory_pangenome", 3, 4_000)
    _same(generators.make(spec, 9), synth.make_accessory_pangenome(3, 4_000, 9))


def test_an_unknown_generator_names_its_missing_file():
    with pytest.raises(FileNotFoundError, match=r"genomes/no_such_thing\.py"):
        generators.make(_spec("no_such_thing", 2, 3_000), 1)


def test_a_pool_holds_its_bases_and_starts_with_the_seeds_genomes():
    spec = _spec("accessory_pangenome", 4, 3_000)
    pool = generators.pool(spec, 11, 100_000)
    sizes = [sum(len(s) for _n, s in g) for g in pool]
    assert sum(sizes) >= 100_000 > sum(sizes[:-1]) and len(pool) > 2
    _same(pool[0], synth.make_accessory_pangenome(4, 3_000, 11))
    _same(pool[2], synth.make_accessory_pangenome(4, 3_000, [11, 2]))
    assert not np.array_equal(pool[0][0][1], pool[1][0][1])
    assert len(generators.pool(spec, 11, 1)) == 1
