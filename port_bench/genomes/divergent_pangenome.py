"""An accessory pangenome whose accessory segments come as divergent
alleles: the structure of `accessory_pangenome` (a shared core, accessory
segments of bimodal presence, IS-like repeats at 2-4 loci, then `mutate`
per genome), except that each accessory segment comes as `alleles_min` to
`alleles_max` alleles, each its ancestor with substitutions at a rate drawn
log-uniform in [`allele_div_min`, `allele_div_max`] and one 1-11 bp indel
per 1 / `allele_indel_per_sub` substitutions. A genome that carries the
segment takes one of its alleles at random. Two alleles of a segment lie
about 4-20 % apart at the defaults: homologs that a sensitive mapping preset
(minimap2's asm20) finds and asm10 mostly does not."""
import numpy as np

from port_bench.generators import ACGT, mutate


def alleles(ancestor: np.ndarray, rng, n: int, div_min: float, div_max: float, indel_per_sub: float) -> list:
    """`n` alleles of `ancestor`: each with int(len * rate) substitutions at
    distinct positions, rate log-uniform in [div_min, div_max], and
    round(substitutions * indel_per_sub) indels of 1-11 bp at distinct
    positions of the ancestor, each a deletion or an insertion of random
    bases with equal odds."""
    L = len(ancestor)
    out = []
    for rate in np.exp(rng.uniform(np.log(div_min), np.log(div_max), n)):
        n_sub = int(L * rate)
        a = ancestor.copy()
        idx = rng.choice(L, n_sub, replace=False)
        a[idx] = ACGT[(np.searchsorted(ACGT, a[idx]) + rng.integers(1, 4, n_sub)) % 4]
        n_indel = min(int(round(n_sub * indel_per_sub)), L)
        pos = np.sort(rng.choice(L, n_indel, replace=False))
        lens = rng.integers(1, 12, n_indel)
        is_del = rng.random(n_indel) < 0.5
        keep = np.ones(L, dtype=bool)
        for p, k in zip(pos[is_del], lens[is_del]):
            keep[p : p + k] = False
        ins_at = np.repeat(pos[~is_del], lens[~is_del])
        ins = ACGT[rng.integers(0, 4, len(ins_at))]
        out.append(np.insert(a, ins_at, ins)[np.insert(keep, ins_at, True)])
    return out


def make(n_genomes: int, genome_len: int, seed=0, sub_rate: float = 0.005, n_seg: int = None,
         core_frac_of_genome: float = 0.72, alleles_min: int = 2, alleles_max: int = 4,
         allele_div_min: float = 0.02, allele_div_max: float = 0.10, allele_indel_per_sub: float = 0.1) -> list:
    rng = np.random.default_rng(seed)
    core_len = int(genome_len * core_frac_of_genome)
    acc_target = genome_len - core_len
    lo = max(300, min(1_000, genome_len // 500))
    hi = max(2 * lo, min(25_000, genome_len // 200))
    mean_seg = (hi - lo) / max(np.log(hi) - np.log(lo), 1e-9)
    if n_seg is None:
        n_seg = max(12, int(min(acc_target * 3.5 / mean_seg, core_len / 2_000)))
    seg_lens = np.exp(rng.uniform(np.log(lo), np.log(hi), n_seg)).astype(int)
    common = rng.random(n_seg) < 0.25
    common_bp = int((seg_lens * common).sum())
    rare_bp = int((seg_lens * ~common).sum())
    p_common = 0.8
    p_rare = float(np.clip((acc_target - p_common * common_bp) / max(rare_bp, 1), 0.02, 0.6))
    pres_p = np.where(common, p_common, p_rare)
    loci = np.sort(rng.choice(core_len, n_seg, replace=False))
    seg_alleles = [alleles(ACGT[rng.integers(0, 4, L)], rng, int(rng.integers(alleles_min, alleles_max + 1)),
                           allele_div_min, allele_div_max, allele_indel_per_sub) for L in seg_lens]
    n_rep = max(2, n_seg // 60)
    rep_seqs = [ACGT[rng.integers(0, 4, int(L))] for L in rng.integers(600, 1600, n_rep)]
    events = sorted(
        [(int(loci[i]), "seg", i, 0.0) for i in range(n_seg)]
        + [(int(rng.integers(0, core_len)), "rep", ri, 0.7)
           for ri in range(n_rep) for _ in range(int(rng.integers(2, 5)))]
    )
    core = ACGT[rng.integers(0, 4, core_len)]
    genomes = []
    for gi in range(n_genomes):
        seg_present = rng.random(n_seg) < pres_p
        pick = rng.random(n_seg)
        pieces = []
        prev = 0
        for pos, kind, idx, pp in events:
            pieces.append(core[prev:pos])
            prev = pos
            if kind == "seg":
                if seg_present[idx]:
                    pieces.append(seg_alleles[idx][int(pick[idx] * len(seg_alleles[idx]))])
            elif rng.random() < pp:
                pieces.append(rep_seqs[idx])
        pieces.append(core[prev:])
        genomes.append((f"div_{gi}", mutate(np.concatenate(pieces), rng, sub_rate)))
    return genomes
