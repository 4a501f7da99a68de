"""The benchmark's copy of the port's accessory-genome generator
(`make_accessory_pangenome` of `pangraph_tpu_torch/utils/synth.py`): the
same random draws in the same order, so the same genomes byte for byte for
the same arguments and seed."""
import numpy as np

from port_bench.generators import ACGT, mutate


def make(n_genomes: int, genome_len: int, seed=0, sub_rate: float = 0.005, n_seg: int = None,
         core_frac_of_genome: float = 0.72) -> list:
    """synth.make_accessory_pangenome: a shared core interleaved with
    accessory segments of bimodal presence and IS-like repeats at 2-4 loci,
    then `mutate` per genome."""
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
        genomes.append((f"acc_{gi}", mutate(np.concatenate(pieces), rng, sub_rate)))
    return genomes
