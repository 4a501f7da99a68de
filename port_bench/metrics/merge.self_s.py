"""Thread-seconds a build spends in the merge layer's own work: inside the
program's `self_merge` spans (build/merge.py), less the part of each that
spans named `mapper.*` or `align.*` on the same thread cover (the mapper,
the aligner's calls and its waits), per job. What is left is match
splitting and filtering, reweave, and the own work of `solve_promises`
and `reconsensus`."""
from port_bench import tracing


def read(record):
    merges, inner = [], {}
    for name, tid, a, b in record["span_intervals"]:
        if name == "self_merge":
            merges.append((tid, a, b))
        elif name.startswith(("mapper.", "align.")):
            inner.setdefault(tid, []).append((a, b))
    if not merges or not record["jobs"]:
        return None
    merged = {tid: tracing.union(ivs) for tid, ivs in inner.items()}
    own = 0.0
    for tid, a, b in merges:
        own += (b - a) - sum(y - x for x, y in tracing.clip(merged.get(tid, []), a, b))
    return own / record["jobs"]
