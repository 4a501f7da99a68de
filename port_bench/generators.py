"""The benchmark's own copy of the port's synthetic pangenome generator
(`make_accessory_pangenome` of `pangraph_tpu_torch/utils/synth.py`): the
same random draws in the same order, so the same genomes byte for byte
for the same arguments and seed.

The port applies each genome's short indels by `del`/insert on a Python
list of its bases, which costs seconds per 4.6 Mbp genome; here they go
through a piece table and one concatenation. Genomes are returned as
(name, uint8 array) pairs; nothing here imports the program."""
from __future__ import annotations

import numpy as np

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


def _mutate(g: np.ndarray, rng, sub_rate: float) -> np.ndarray:
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


def accessory_pangenome(n_genomes: int, genome_len: int, seed: int = 0, sub_rate: float = 0.005,
                        n_seg: int = None, core_frac_of_genome: float = 0.72) -> list:
    """synth.make_accessory_pangenome: a shared core interleaved with
    accessory segments of bimodal presence and IS-like repeats at 2-4 loci,
    then `_mutate` per genome."""
    rng = np.random.default_rng(seed)
    core_len = int(genome_len * core_frac_of_genome)
    acc_target = genome_len - core_len
    lo = max(300, min(1_000, genome_len // 500))
    hi = max(2 * lo, min(25_000, genome_len // 200))
    mean_seg = (np.exp(np.log(hi)) - np.exp(np.log(lo))) / max(np.log(hi) - np.log(lo), 1e-9)
    if n_seg is None:
        n_seg = int(min(acc_target * 3.5 / mean_seg, core_len / 2_000))
        n_seg = max(12, n_seg)
    seg_lens = np.exp(rng.uniform(np.log(lo), np.log(hi), n_seg)).astype(int)
    common = rng.random(n_seg) < 0.25
    common_bp = int((seg_lens * common).sum())
    rare_bp = int((seg_lens * ~common).sum())
    p_common = 0.8
    p_rare = float(np.clip((acc_target - p_common * common_bp) / max(rare_bp, 1), 0.02, 0.6))
    pres_p = np.where(common, p_common, p_rare)
    loci = np.sort(rng.choice(core_len, n_seg, replace=False))
    seg_seqs = [ACGT[rng.integers(0, 4, L)] for L in seg_lens]
    n_rep = max(2, n_seg // 60)
    rep_seqs = [ACGT[rng.integers(0, 4, int(L))] for L in rng.integers(600, 1600, n_rep)]
    events = sorted(
        [(int(loci[i]), "seg", i, 0.0) for i in range(n_seg)]
        + [
            (int(rng.integers(0, core_len)), "rep", ri, 0.7)
            for ri in range(n_rep)
            for _ in range(int(rng.integers(2, 5)))
        ]
    )
    core = ACGT[rng.integers(0, 4, core_len)]
    genomes = []
    for gi in range(n_genomes):
        seg_present = rng.random(n_seg) < pres_p
        pieces = []
        prev = 0
        for pos, kind, idx, pp in events:
            pieces.append(core[prev:pos])
            prev = pos
            if kind == "seg":
                if seg_present[idx]:
                    pieces.append(seg_seqs[idx])
            elif rng.random() < pp:
                pieces.append(rep_seqs[idx])
        pieces.append(core[prev:])
        genomes.append((f"acc_{gi}", _mutate(np.concatenate(pieces), rng, sub_rate)))
    return genomes


GENERATORS = {"accessory_pangenome": accessory_pangenome}


def make(spec: dict, seed: int) -> list:
    """The genomes of a generator spec ({"generator": name, **arguments})
    for `seed`."""
    args = {k: v for k, v in spec.items() if k != "generator"}
    return GENERATORS[spec["generator"]](seed=seed, **args)


def pool(spec: dict, seed: int, pool_bp: int) -> list:
    """A run's inputs: input 0 made from `seed`, input k from (seed, k),
    until they hold `pool_bp` bases; at least one."""
    out, bp = [], 0
    while not out or bp < pool_bp:
        g = make(spec, seed if not out else [seed, len(out)])
        out.append(g)
        bp += sum(len(s) for _n, s in g)
    return out
