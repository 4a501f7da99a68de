"""The headline at the reference's host-leg budget with the aligner's record
budget cut, so that the measured-rate checkpoint rule decides the groups
that do not fit (chip_smoke.py phase 12), once per record budget given.

    python3 dev/ckpt_route_cuda.py [RECORD_BUDGET ...]
    python3 dev/ckpt_route_cuda.py --paired [PAIRS]

Default: 536,870,908 bytes (the 65,536 tier's groups at B 128 do not fit a
launch's quarter), chip_smoke.CKPT_ROUTE_RECORD_BUDGET (the 10,240 tier's
up) and 33,554,428 (every tier's). Each build prints phase 12's lines, then
the checkpoint log's decisions by (tier, band) and its observations; a build
that fails phase 12's checks prints why and the script goes on to the next,
exiting 1 at the end. Needs a CUDA card; about 40 s a budget on an H100.

--paired builds the headline at chip_smoke.CKPT_ROUTE_RECORD_BUDGET with
the rule ("rule") and with every oversized group kept on the checkpoint
pair ("forced": _ckpt_competitive answers yes whatever the rates), in the
order rule, forced, forced, rule repeated PAIRS times (default 2), all in
one process; each build prints its wall, device share and decisions, and
the last line gives both arms' walls and the pairs the rule won. A group
the rule sends to the host runs on the single-job fallback's two threads,
not on the host leg's batch engine whose rate h it was compared with; the
pairs show what that costs the build's wall.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402

BUDGETS = [4 * 8 * 65536 * 128 * 2 - 4, c.CKPT_ROUTE_RECORD_BUDGET, 4 * 8 * 4096 * 128 * 2 - 4]


def summarize(log: list) -> None:
    """The log's decisions per (tier, band, answer) and its observations."""
    groups = {}
    for e in log:
        if e["event"] == "decide":
            key = f"{e['R_cap']}/{e['B']}/{'ckpt' if e['ckpt'] else 'host'}"
            groups[key] = groups.get(key, 0) + 1
    c.say("ckpt_route.decisions", groups=json.dumps(dict(sorted(groups.items()))))
    for e in log:
        if e["event"] == "observe":
            c.say("ckpt_route.observe", cells=e["cells"], secs=round(e["secs"], 4),
                  gcells_per_s=round(e["cells"] / e["secs"] / 1e9, 4), ema=round(e["ckpt_rate"] / 1e9, 4))


def paired(torch, fa: str, pairs: int) -> int:
    """Rule against forced, in ABBA order: every build's wall and share,
    then the walls of both arms and the pairs the rule won."""
    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    rule = BatchAligner._ckpt_competitive
    walls = {"rule": [], "forced": []}
    for arm in ["rule", "forced", "forced", "rule"] * pairs:
        BatchAligner._ckpt_competitive = rule if arm == "rule" else (lambda self, R_cap=None, B=None: True)
        try:
            out = c._gated_build(torch, f"paired.{arm}", fa, c.CKPT_ROUTE_RECORD_BUDGET)
        finally:
            BatchAligner._ckpt_competitive = rule
        summarize(list(BatchAligner.CKPT_LOG))
        walls[arm].append(out["wall_s"])
        c.say("paired.build", arm=arm, wall_s=round(out["wall_s"], 3),
              device_cells_frac=out["report"]["device_cells_frac"],
              host_cells=out["report"]["host"]["cells"], launches=json.dumps(out["launches"]))
    won = sum(r < f for r, f in zip(walls["rule"], walls["forced"]))
    c.say("paired", pairs=len(walls["rule"]), rule_won=won, rule_s=json.dumps([round(w, 3) for w in walls["rule"]]),
          forced_s=json.dumps([round(w, 3) for w in walls["forced"]]))
    return 0


def main(argv: list) -> int:
    import torch

    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    if not torch.cuda.is_available():
        print("ckpt_route_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    pairs = int(argv[1]) if argv[:1] == ["--paired"] and len(argv) > 1 else 2
    budgets = [] if argv[:1] == ["--paired"] else [int(float(a)) for a in argv] or BUDGETS
    print(c.smi_line())
    c.phase_build()
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "headline.fa")
        c.say("headline", input_bp=c.headline_fasta(fa))
        if not budgets:
            return paired(torch, fa, pairs)
        for budget in budgets:
            t0 = time.time()
            try:
                c.phase_ckpt_route(torch, fa, budget)
            except AssertionError as e:
                failed.append(budget)
                print(f"ckpt_route_cuda: record budget {budget}: {e}", file=sys.stderr)
            summarize(list(BatchAligner.CKPT_LOG))
            c.say("ckpt_route.budget", record_budget=budget, wall_s=round(time.time() - t0, 3))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
