"""The benchmark's genome generators, found by name as files: a
configuration's `genomes.generator` names `port_bench/genomes/<name>.py`,
which defines `make(n_genomes, genome_len, seed, **arguments)` and returns
the genomes as (name, uint8 array) pairs. Nothing here or there imports
the program.

Here too the mutation model the port's generators share
(`pangraph_tpu_torch/utils/synth.py:_mutate`), with the same random draws
in the same order. The port applies each genome's short indels by
`del`/insert on a Python list of its bases, which costs seconds per 4.6 Mbp
genome; here they go through a piece table and one concatenation."""
from __future__ import annotations

import importlib.util
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ACGT = np.frombuffer(b"ACGT", np.uint8)

_COMP = np.zeros(256, np.uint8)
_COMP[ord("A")], _COMP[ord("C")], _COMP[ord("G")], _COMP[ord("T")] = (
    ord("T"), ord("G"), ord("C"), ord("A"),
)


def _split(pieces: list, pos: int) -> int:
    """Cut the piece table at sequence position `pos`; return the index of
    the first piece at or after it."""
    acc = 0
    for i, (arr, s, e) in enumerate(pieces):
        n = e - s
        if acc + n > pos:
            if acc == pos:
                return i
            cut = s + pos - acc
            pieces[i : i + 1] = [(arr, s, cut), (arr, cut, e)]
            return i + 1
        acc += n
    return len(pieces)


def mutate(g: np.ndarray, rng, sub_rate: float) -> np.ndarray:
    """synth._mutate: ~sub_rate substitutions, ~1 short indel per 15 kb,
    1-2 inversions of 3-10 kb, and a circular rotation."""
    length = len(g)
    n_sub = int(length * sub_rate)
    idx = rng.choice(length, n_sub, replace=False)
    g = g.copy()
    g[idx] = ACGT[(np.searchsorted(ACGT, g[idx]) + rng.integers(1, 4, n_sub)) % 4]
    pieces = [(g, 0, length)]
    cur = length
    for _ in range(max(1, length // 15_000)):
        p = int(rng.integers(100, cur - 100))
        L = int(rng.integers(1, 12))
        if rng.random() < 0.5:
            i = _split(pieces, p)
            j = _split(pieces, min(p + L, cur))
            n_del = sum(e - s for _a, s, e in pieces[i:j])
            del pieces[i:j]
            cur -= n_del
        else:
            ins = ACGT[rng.integers(0, 4, L)]
            pieces.insert(_split(pieces, p), (ins, 0, L))
            cur += L
    g = np.concatenate([a[s:e] for a, s, e in pieces])
    for _ in range(int(rng.integers(1, 3))):
        hi = min(10_000, len(g) // 3)
        if hi <= 3_000:
            break  # genome too short for a 3-10 kb inversion
        L = int(rng.integers(3_000, hi))
        p = int(rng.integers(0, len(g) - L))
        g[p : p + L] = _COMP[g[p : p + L]][::-1]
    return np.roll(g, int(rng.integers(0, len(g))))


def load(name: str, root: str = ROOT):
    """The `make` of generator `name`: `port_bench/genomes/<name>.py` under
    `root`, a `make(n_genomes, genome_len, seed, **arguments)` that returns
    [(name, uint8 array)]."""
    path = os.path.join(root, "port_bench", "genomes", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no genome generator {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location("port_bench_genomes_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def make(spec: dict, seed, root: str = ROOT) -> list:
    """The genomes of a generator spec ({"generator": name, **arguments})
    for `seed`."""
    args = {k: v for k, v in spec.items() if k != "generator"}
    return load(spec["generator"], root)(seed=seed, **args)


def pool(spec: dict, seed: int, pool_bp: int, root: str = ROOT) -> list:
    """A run's inputs: input 0 made from `seed`, input k from (seed, k),
    until they hold `pool_bp` bases; at least one."""
    out, bp = [], 0
    while not out or bp < pool_bp:
        g = make(spec, seed if not out else [seed, len(out)], root)
        out.append(g)
        bp += sum(len(s) for _n, s in g)
    return out
