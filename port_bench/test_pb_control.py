"""The controls, at a size a test run holds, put in the program's place,
fail the comparison that the program passes: the plain reference's exact
DP at half the band (the control the configurations name) and the same
DP computed in int16. At the cells' own size they run on the card by
`python3 port_bench/limits.py` (PERF.md gives their readings)."""
import os

import numpy as np
import pytest

from pangraph_tpu_torch.align.params import BandParameters
from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner
from port_bench import harness
from port_bench.reference import align

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _jobs(seed):
    rng = np.random.default_rng(seed)
    jobs = []
    for length in (12_500, 12_000, 3_000, 800, 400):  # scores past int16's 32,767 in the first two
        ref = ACGT[rng.integers(0, 4, length)]
        q = ref.copy()
        idx = rng.choice(length, length // 100, replace=False)
        q[idx] = ACGT[rng.integers(0, 4, len(idx))]
        q = list(q)
        if length > 10_000:
            del q[length // 2 : length // 2 + 14]  # a path the half band cannot follow
        for _ in range(4):
            p, L = int(rng.integers(0, len(q))), int(rng.integers(1, 10))
            if rng.random() < 0.5:
                del q[p : p + L]
            else:
                q[p:p] = list(ACGT[rng.integers(0, 4, L)])
        jobs.append(AlignJob(ref, np.array(q, np.uint8), BandParameters(0, 15)))
    return jobs


@pytest.mark.parametrize("control, bits, shrink", [("half_band", 32, 2), ("int16", 16, 1)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_where_the_program_passes(seed, control, bits, shrink):
    config = harness.load_json(os.path.join(harness.HERE, "configs", "ecoli10.json"))
    cap, extra = config["guarantees"]["band_cap"], config["build_args"]["extra_band_width"]
    jobs = _jobs(seed)
    program = BatchAligner(device=None).align_many(jobs)
    kept = [(k, j.ref, j.qry, j.band.mean_shift, j.band.band_width, harness.edit_dict(e))
            for k, (j, e) in enumerate(zip(jobs, program))]
    prog = harness.check(config, [], [], kept, "cpu")
    assert all(c["value"] <= c["limit"] for c in prog.values()), prog
    ctl = align.control_alignments(
        [(j.ref, j.qry, j.band.mean_shift, max(1, min(j.band.band_width + extra, cap) // shrink)) for j in jobs],
        align.Scoring(), bits=bits)
    ctl_kept = [(k, ref, qry, ms, bw, e) for (k, ref, qry, ms, bw, _e), e in zip(kept, ctl)]
    ctl_checks = harness.check(config, [], [], ctl_kept, "cpu")
    assert any(c["value"] > c["limit"] for c in ctl_checks.values()), ctl_checks
    if control == "int16":
        # the short jobs, where int16 holds every score, it aligns as well as the reference
        short = [(k, ref, qry, ms, bw, e) for k, ref, qry, ms, bw, e in ctl_kept if len(ref) < 5_000]
        assert harness.check(config, [], [], short, "cpu")["alignment_gap_max"]["value"] <= 0
