"""The port's span recorder (pangraph_tpu_torch/utils/trace.py): parents,
self time, build ids and causes across threads, idle time by innermost
span, the off path; and a tiny build on the kernels' plain versions, under
the recorder and under a one-argument `span` swapped in as the
benchmark's traced run does, which must find the build's spans and the
aligner's fetch counter."""
from __future__ import annotations

import ast
import contextlib
import pathlib
import re
import threading
import time

import pytest

from pangraph_tpu_torch.utils import trace
from pangraph_tpu_torch.utils.trace import Span

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def recorder():
    trace.reset()
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)
        trace.reset()


def test_parents_self_time_builds_and_causes_across_two_threads(recorder):
    bid = trace.new_build()
    seen = {}

    def worker():
        with trace.span("t.outer"):
            with trace.span("t.inner"):
                pass
            seen["current"] = trace.current()

    with trace.span("outer"):
        with trace.span("inner"):
            th = threading.Thread(target=trace.carry(worker))
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        with trace.span("inner"):
            pass
    evs = {(e.name, e.thread != threading.get_ident()): e for e in trace.events()}
    outer, t_outer, t_inner = evs[("outer", False)], evs[("t.outer", True)], evs[("t.inner", True)]
    inners = [e for e in trace.events() if e.name == "inner"]
    assert len(inners) == 2 and all(e.parent == outer.sid for e in inners)
    assert outer.parent is None and t_outer.parent is None and t_inner.parent == t_outer.sid
    assert seen["current"] == t_outer.sid
    # the thread's spans name the span that handed it the work; the caller's do not
    assert t_outer.causes == t_inner.causes == (inners[0].sid,) and outer.causes == ()
    assert {e.build for e in trace.events()} == {bid}
    # self time: the duration less the same thread's children, not the other thread's
    own = trace.self_times(trace.events())
    assert own[outer.sid] * 1e9 == pytest.approx(
        (outer.end_ns - outer.start_ns) - sum(e.end_ns - e.start_ns for e in inners))
    assert own[t_outer.sid] * 1e9 == pytest.approx((t_outer.end_ns - t_outer.start_ns)
                                                   - (t_inner.end_ns - t_inner.start_ns))
    lines = trace.summary().splitlines()
    assert lines[0].split() == ["phase", "calls", "total_s", "self_s", "mean_ms", "max_ms", "parent"]
    assert next(line for line in lines if line.split()[0] == "inner").split()[1] == "2"
    wall = (max(e.end_ns for e in trace.events()) - outer.start_ns) / 1e9
    assert f"build {bid}: {wall:.3f} s" in trace.summary() and "5 spans on 2 threads" in trace.summary()


def _span(sid, name, thread, a, b, parent=None):
    return Span(sid, name, thread, a, b, parent, None, ())


# (spans, busy intervals, window, expected idle seconds by name); times in ns
IDLE_CASES = {
    "nested-one-thread": (
        [_span(1, "outer", 1, 0, 100, None), _span(2, "inner", 1, 20, 60, 1)],
        [[30, 40]], (0, 100), {"outer": 60, "inner": 30}),
    "two-threads-share": (
        [_span(1, "a", 1, 0, 100), _span(2, "b", 2, 50, 150)],
        [[80, 120]], (0, 200), {"a": 50 + 15, "b": 15 + 30, "outside spans": 50}),
    "three-threads-and-a-gap": (
        [_span(1, "a", 1, 0, 60), _span(2, "b", 2, 0, 60), _span(3, "c", 3, 0, 30), _span(4, "d", 3, 30, 30),
         _span(5, "e", 1, 70, 90)],
        [], (0, 90), {"a": 10 + 15, "b": 10 + 15, "c": 10, "outside spans": 10, "e": 20}),
    "busy-past-the-window": (
        [_span(1, "a", 1, 0, 50)], [[-20, 10], [40, 80]], (0, 60), {"a": 30}),
}


@pytest.mark.parametrize("case", list(IDLE_CASES))
def test_idle_by_innermost_span_sums_to_the_idle_time(case):
    spans, busy, (lo, hi), want = IDLE_CASES[case]
    got = trace.idle_by_innermost(spans, busy, lo, hi)
    assert got.keys() == want.keys()
    for name, ns in want.items():
        assert got[name] * 1e9 == pytest.approx(ns)
    idle = (hi - lo) - sum(min(b, hi) - max(a, lo) for a, b in busy if b > lo and a < hi)
    assert sum(got.values()) * 1e9 == pytest.approx(idle)


def test_a_disabled_recorder_records_nothing():
    trace.reset()
    trace.enable(False)
    assert trace.new_build() is None and trace.current() is None
    fn = lambda: None  # noqa: E731
    assert trace.carry(fn) is fn
    with trace.caused_by([1]), trace.span("x"):
        assert trace.current() is None
    trace.anchor_device("cuda")  # off: touches no card
    assert trace.events() == [] and trace.summary() == "trace: no spans recorded"


def test_every_span_call_has_one_positional_argument():
    """The benchmark swaps trace.span for a recorder that takes the name
    alone: every call in the port passes exactly that."""
    calls = 0
    for path in (ROOT / "pangraph_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "span"
                    and isinstance(node.func.value, ast.Name) and node.func.value.id == "trace"):
                calls += 1
                assert len(node.args) == 1 and not node.keywords, f"{path}:{node.lineno}"
                assert not isinstance(node.args[0], ast.Starred), f"{path}:{node.lineno}"
    assert calls >= 20


@pytest.fixture(scope="module")
def tiny_build():
    """A 3-genome build at jobs 2 on the kernels' plain versions, then its
    JSON, with the program's recorder on and trace.span swapped for a
    wrapper that takes one positional argument, as port_bench/tracing.py's
    recorder does, and hands the name to the program's span. Returns (the
    names the wrapper saw, the recorded spans, the engine report, the
    report after reset_engine_stats)."""
    from pangraph_tpu_torch.align.params import BuildArgs
    from pangraph_tpu_torch.build.build import build
    from pangraph_tpu_torch.io.fasta import FastaRecord
    from pangraph_tpu_torch.ops.batch_align import BatchAligner
    from pangraph_tpu_torch.utils.synth import make_accessory_pangenome

    names = set()
    orig = trace.span

    @contextlib.contextmanager
    def one_argument(name, /):
        names.add(name)
        with orig(name):
            yield

    recs = [FastaRecord(seq_name=r.seq_name, desc=None, seq=r.seq, index=r.index)
            for r in make_accessory_pangenome(n_genomes=3, genome_len=3000, seed=5)]
    args = BuildArgs(circular=True, jobs=2)
    aligner = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device="cpu")
    BatchAligner.reset_engine_stats()
    trace.reset()
    trace.enable(True)
    trace.span = one_argument
    try:
        build(recs, args, aligner=aligner).to_json()
        evs, text = trace.events(), trace.summary()
    finally:
        trace.span = orig
        trace.enable(False)
        trace.reset()
    report = BatchAligner.engine_report()
    BatchAligner.reset_engine_stats()
    return names, evs, text, report, BatchAligner.engine_report()


@pytest.mark.parametrize("name", ["build.guide_tree", "merge.graph_join", "merge.split_filter", "graph.to_json",
                                  "align.wait", "align.gather", "align.fetch", "mapper.groups"])
def test_a_one_argument_span_sees_the_build(tiny_build, name):
    names, evs, _text, _report, _after = tiny_build
    assert name in names and name in {e.name for e in evs}


def test_the_fetch_counter(tiny_build):
    *_, report, after = tiny_build
    f = report["fetch"]
    assert f["bytes"] > 0
    assert after["fetch"] == {"bytes": 0}
    assert set(report["host"]) == {"cells"} and set(report["device"]) == {"cells"}


def test_the_recorder_on_a_build(tiny_build):
    """One build id on the caller and every thread it hands work to; the
    broker's spans caused by spans of the threads that submitted the legs;
    each align.wait inside a self_merge of its own thread."""
    _names, evs, text, _report, _after = tiny_build
    by_sid = {e.sid: e for e in evs}
    broker = [e for e in evs if e.name in ("align.pack", "align.dispatch", "align.fetch", "align.gather")]
    assert broker and all(e.causes for e in broker)
    for e in broker:
        assert e.build is None
        for c in e.causes:
            assert c in by_sid and by_sid[c].thread != e.thread and by_sid[c].build is not None
    builds = {e.build for e in evs if e not in broker}
    assert len(builds) == 1 and None not in builds
    pooled = [e for e in evs if e.name == "mapper.chain" and e.parent is None]
    assert pooled and all(by_sid[c].name == "mapper.groups" for e in pooled for c in e.causes)
    waits = [e for e in evs if e.name == "align.wait"]
    assert waits
    for e in waits:
        chain = []
        p = e.parent
        while p is not None:
            assert by_sid[p].thread == e.thread
            chain.append(by_sid[p].name)
            p = by_sid[p].parent
        assert "self_merge" in chain
    assert "self_s" in text.splitlines()[0]


class _Event:
    """A CUDA event's stand-in: recorded at `ms` on the card's clock."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, other) -> float:
        return other.ms - self.ms


def test_the_summary_places_launches_on_the_spans_clock(recorder, monkeypatch):
    """Launches on an anchored card are put on the spans' clock; those on
    another card are left out and counted; the idle time by innermost span
    sums to the window less the busy time."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with trace.span("outer"):
        time.sleep(0.03)
        with trace.span("inner"):
            time.sleep(0.05)
    (inner, outer) = trace.events()
    t0 = outer.start_ns
    trace._ANCHORS[0] = (_Event(5.0), t0)  # the anchor: 5 ms on the card's clock
    # one launch of 1/4 of outer, on card 0, from 5 ms after the anchor's reading
    span_ms = (outer.end_ns - t0) / 1e6
    launches = [("stripe_dp", 0, _Event(5.0), _Event(5.0 + span_ms / 4)), ("walk", 1, _Event(0.0), _Event(1.0))]
    text = trace.summary(launches)
    lines = text.splitlines()
    device = next(line for line in lines if line.startswith("device:"))
    assert "1 launches (1 on cards not anchored)" in device and "busy share 0.2500" in device
    assert any(line.split()[:2] == ["kernel", "stripe_dp"] for line in lines)
    idle_head = next(i for i, line in enumerate(lines) if line.startswith("idle "))
    idle_s = float(lines[idle_head].split()[1])
    rows = {line.split()[0]: float(line.split()[1]) for line in lines[idle_head + 1:]}
    assert sum(rows.values()) == pytest.approx(idle_s, rel=1e-3, abs=2e-3)
    assert set(rows) == {"outer", "inner"} and rows["inner"] > 0.04


class _CardLike:
    """The CPU aligner, under the name of card 0, for the CLI's card branch."""

    def __init__(self, aligner):
        import torch

        self._aligner = aligner
        self.device = torch.device("cuda", 0)
        self.mesh = type("Mesh", (), {"devices": [self.device, self.device]})()

    def __getattr__(self, name):
        return getattr(self._aligner, name)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_build_trace_through_the_cli(tmp_path, monkeypatch, capsys, card):
    """`build --trace` prints the phase table after the graph is written,
    so `graph.to_json` is in it, and a line for the build; on a card (here
    the CPU aligner under card 0's name, with a stand-in anchor and one
    launch in the log's 8-field form) the device section too, whose idle
    rows sum to its idle time."""
    import torch

    from pangraph_tpu_torch import cli
    from pangraph_tpu_torch.build import build as build_mod
    from pangraph_tpu_torch.io.fasta import FastaRecord, write_fasta
    from pangraph_tpu_torch.ops import stripe_v2
    from pangraph_tpu_torch.utils.synth import make_accessory_pangenome

    recs = [FastaRecord(seq_name=r.seq_name, desc=None, seq=r.seq, index=r.index)
            for r in make_accessory_pangenome(n_genomes=3, genome_len=3000, seed=5)]
    fa, out = tmp_path / "in.fa", tmp_path / "g.json"
    write_fasta(str(fa), recs)
    anchored = []
    if card:
        real_aligner, real_build = cli._aligner, build_mod.build

        def logged_build(*a, **k):
            g = real_build(*a, **k)
            stripe_v2.KERNEL_TIMING.append(("stripe_dp", 8, 64, 3, 0, _Event(1.0), _Event(2.0), 0))
            return g

        def anchor(dev):
            anchored.append(dev)
            trace._ANCHORS[0] = (_Event(0.0), time.perf_counter_ns())

        monkeypatch.setattr(cli, "_no_card", lambda args: False)
        monkeypatch.setattr(cli, "_mesh", lambda args: None)
        monkeypatch.setattr(cli, "_aligner", lambda args, build_args, mesh=None: _CardLike(
            real_aligner(cli.build_parser().parse_args(["build", str(fa), "--device", "cpu"]), build_args)))
        monkeypatch.setattr(build_mod, "build", logged_build)
        monkeypatch.setattr(trace, "anchor_device", anchor)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    trace.reset()
    try:
        rc = cli.main(["build", str(fa), "-c", "-j", "2", "--device", "cpu", "--trace", "--no-progress-bar",
                       "-o", str(out)])
    finally:
        trace.enable(False)
        trace.reset()
    assert rc == 0 and out.exists()
    lines = capsys.readouterr().err.splitlines()
    head = next(i for i, line in enumerate(lines) if line.startswith("phase"))
    assert lines[head].split()[2:4] == ["total_s", "self_s"] and lines[head].split()[-1] == "parent"
    assert any(line.split()[0] == "graph.to_json" for line in lines[head + 1:])
    assert sum(re.match(r"build \d+: [\d.]+ s from", line) is not None for line in lines) == 1
    assert any(line.startswith("device:") for line in lines) == card
    assert stripe_v2.KERNEL_TIMING is None
    if card:
        assert len(anchored) == 1  # one anchor a card, however many mesh slots it fills
        device = next(line for line in lines if line.startswith("device:"))
        assert "1 launches," in device and "busy 0.001 s" in device
        assert any(line.split()[:3] == ["kernel", "stripe_dp", "0.001"] for line in lines)
        idle_head = next(i for i, line in enumerate(lines) if line.startswith("idle "))
        idle_s = float(lines[idle_head].split()[1])
        rows = [float(line.split()[-2]) for line in lines[idle_head + 1:]]
        # each printed figure is rounded to the millisecond
        assert rows and sum(rows) == pytest.approx(idle_s, abs=5e-4 * (len(rows) + 1))
