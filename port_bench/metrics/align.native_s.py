"""Thread-seconds a build spends in the host engine: the program's
`align.native` spans (ops/batch_align.py: a round's host leg, or a whole
round on the host) and `align.host_fallback` spans (single jobs, the
numpy aligner where that fails), each thread's intervals merged so that a
fallback inside a host round counts once, per job."""
from port_bench import tracing


def read(record):
    by_thread = {}
    for name, tid, a, b in record["span_intervals"]:
        if name in ("align.native", "align.host_fallback"):
            by_thread.setdefault(tid, []).append((a, b))
    if not by_thread or not record["jobs"]:
        return None
    return sum(b - a for ivs in by_thread.values() for a, b in tracing.union(ivs)) / record["jobs"]
