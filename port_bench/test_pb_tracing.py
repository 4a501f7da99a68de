"""The per-layer readers of the aligner's waits, the merge layer's own work
and the guide tree (metrics/*.py) on hand-made records with known answers,
and None where their input is missing."""
import importlib.util
import os

import pytest

from port_bench import harness


def reader(name: str):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("test_pb_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(intervals=(), launches=(), jobs=2, window_s=10.0) -> dict:
    spans = {}
    for name, _tid, a, b in intervals:
        spans[name] = spans.get(name, 0.0) + (b - a)
    return {"jobs": jobs, "window_s": window_s, "spans": spans, "span_intervals": list(intervals),
            "launches": [{"name": "stripe_dp", "start_s": a, "end_s": b} for a, b in launches],
            "engine": {}}


# merge thread 1 and 2, broker thread 9
TRACE = [
    ("self_merge", 1, 0.0, 6.0),
    ("find_matches", 1, 0.0, 3.0),
    ("mapper.index", 1, 0.0, 1.0),
    ("align.wait", 1, 1.5, 2.5),
    ("align.decode", 1, 2.5, 3.0),
    ("mapper.chain", 2, 0.5, 4.0),  # another thread: not taken off thread 1's self_merge
    ("align.pack", 9, 1.5, 2.0),  # the broker's: likewise
    ("self_merge", 2, 4.0, 8.0),
    ("align.wait", 2, 5.0, 7.0),
    ("align.host_wait", 2, 6.5, 7.5),  # overlaps its wait: counted once
    ("build.guide_tree", 0, 8.0, 9.0),
]

CASES = {
    # thread-s in align.wait over 2 jobs
    ("align.wait_s", "trace"): (record(TRACE), (1.0 + 2.0) / 2),
    ("align.wait_s", "no wait"): (record(TRACE[:3]), None),
    # self_merge 6 - (mapper.index 1 + wait 1 + decode 0.5) on thread 1; 4 - 2.5 on thread 2
    ("merge.self_s", "trace"): (record(TRACE), ((6.0 - 2.5) + (4.0 - 2.5)) / 2),
    ("merge.self_s", "no merge"): (record(TRACE[-1:]), None),
    ("build.guide_tree_s", "trace"): (record(TRACE), 0.5),
    ("build.guide_tree_s", "no span"): (record(TRACE[:-1]), None),
    # busy [2, 5.5]: waits [1.5, 2.5] and [5, 7] are idle in [1.5, 2] and [5.5, 7]
    ("device.idle_waited_share", "trace"): (record(TRACE, launches=[(2.0, 3.0), (2.5, 5.5)]), (0.5 + 1.5) / 10),
    ("device.idle_waited_share", "no launches"): (record(TRACE), None),
    ("device.idle_waited_share", "no wait"): (record(TRACE[:3], launches=[(2.0, 3.0)]), None),
    # a wait past the window's end counts up to the end
    ("device.idle_waited_share", "clipped"): (
        record([("align.wait", 1, 8.0, 12.0)], launches=[(0.0, 1.0)]), 2.0 / 10),
}


@pytest.mark.parametrize("metric,case", list(CASES), ids=[f"{m}-{c}" for m, c in CASES])
def test_reader(metric, case):
    rec, want = CASES[(metric, case)]
    got = reader(metric)(rec)
    assert got == pytest.approx(want) if want is not None else got is None
