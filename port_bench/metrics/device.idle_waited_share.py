"""The share of the traced window in which no kernel of the launch log
ran on the card while at least one thread was inside the program's
`align.wait` span: the card idle although a merge thread waits on it
(the complement of `tracing.busy` within the window, intersected with
the union of the `align.wait` intervals)."""
from port_bench import tracing


def read(record):
    w = record["window_s"]
    waits = [(a, b) for name, _tid, a, b in record["span_intervals"] if name == "align.wait"]
    if not record["launches"] or not waits or w <= 0:
        return None
    busy = tracing.busy(record)
    idle_waited = 0.0
    for a, b in tracing.clip(tracing.union(waits), 0.0, w):
        covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
        idle_waited += (b - a) - covered
    return idle_waited / w
