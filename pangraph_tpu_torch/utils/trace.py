"""Lightweight phase tracing (SURVEY.md §5: the reference has no built-in
tracer — `dev/profile` wraps samply externally; here tracing is first-class).

Enable with PANGRAPH_TPU_TRACE=1 or `pangraph-tpu build --trace`. Every
`span("phase")` then records one event: its name, thread, start and end on
`time.perf_counter_ns`, its parent (the enclosing span on the same thread),
the build it belongs to (`new_build`, carried to other threads by
`carry`) and, on a thread that serves other threads' work, the spans that
caused it (`carry`, `caused_by`). Events are kept in memory until `reset()`.
`summary()` is derived from them: each phase's calls, inclusive and self
time (its duration less the part its children cover) and parent, each
build's wall and, once `anchor_device` has put a card on the spans'
clock, the card's busy share, kernel time by name and idle time by
innermost span.

A span opens with exactly one argument, its name: the benchmark's traced
run swaps `span` for a recorder of its own that takes the name alone.
Spans are no-ops when tracing is disabled (~100 ns overhead), and so are
the build and cause functions.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    sid: int  # ids rise in the order spans open
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: int | None  # sid of the enclosing span on the same thread
    build: int | None
    causes: tuple  # sids of the spans, on other threads, whose work this serves


_LOCK = threading.Lock()
_EVENTS: list = []  # Span, appended as each closes
_IDS = itertools.count(1)
_BUILDS = itertools.count(1)
_TLS = threading.local()  # .stack (open sids), .build, .causes
_ANCHORS: dict = {}  # CUDA device index -> (event, perf_counter_ns at it)
_ENABLED = bool(int(os.environ.get("PANGRAPH_TPU_TRACE", "0") or 0))


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    with _LOCK:
        _EVENTS.clear()
        _ANCHORS.clear()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@contextlib.contextmanager
def span(name: str):
    if not _ENABLED:
        yield
        return
    st = _stack()
    sid = next(_IDS)
    parent = st[-1] if st else None
    st.append(sid)
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        st.pop()
        ev = Span(sid, name, threading.get_ident(), t0, t1, parent, getattr(_TLS, "build", None),
                  getattr(_TLS, "causes", ()))
        with _LOCK:
            _EVENTS.append(ev)


def new_build() -> int | None:
    """Give the calling thread a fresh build id and return it (None when
    tracing is off). Its spans carry the id until the thread takes
    another, so work after the build, such as its serialisation, shares
    it."""
    if not _ENABLED:
        return None
    _TLS.build = next(_BUILDS)
    return _TLS.build


def carry(fn):
    """`fn`, to run on another thread: the spans it opens there take the
    calling thread's build id and, as their cause, the span open here."""
    if not _ENABLED:
        return fn
    build, cause = getattr(_TLS, "build", None), current()

    def run(*args):
        _TLS.build = build
        _TLS.causes = () if cause is None else (cause,)
        return fn(*args)

    return run


def current() -> int | None:
    """The id of the innermost span open on the calling thread, or None."""
    if not _ENABLED:
        return None
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def caused_by(causes):
    """Spans the calling thread opens inside serve the work of the spans
    `causes` (ids from current() on the threads that handed it over)."""
    if not _ENABLED:
        yield
        return
    prev = getattr(_TLS, "causes", ())
    _TLS.causes = tuple(c for c in causes if c is not None)
    try:
        yield
    finally:
        _TLS.causes = prev


def anchor_device(device) -> None:
    """Put a CUDA card on the spans' clock: after a synchronize, one event
    recorded on its current stream beside one perf_counter_ns reading.
    summary() then places the launch log's event pairs of that card."""
    if not _ENABLED:
        return
    import torch

    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    torch.cuda.synchronize(index)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(index))
    t = time.perf_counter_ns()
    ev.synchronize()
    with _LOCK:
        _ANCHORS[index] = (ev, t)


def events() -> list:
    with _LOCK:
        return list(_EVENTS)


def self_times(evs: list) -> dict:
    """{sid: self seconds}: each span's duration less its children's. A
    thread's spans nest, so a span's children never overlap each other."""
    out = {e.sid: (e.end_ns - e.start_ns) / 1e9 for e in evs}
    for e in evs:
        if e.parent in out:
            out[e.parent] -= (e.end_ns - e.start_ns) / 1e9
    return out


def union(intervals) -> list:
    """Merge [(start, end)] into disjoint sorted [start, end] intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_innermost(evs: list, busy: list, lo: int, hi: int) -> dict:
    """Split the idle time of [lo, hi] (what `busy`, disjoint sorted
    intervals, leaves free) by innermost span: each idle stretch is shared
    equally among the threads inside a span then, each thread's share
    going to its innermost open span's name; a stretch with no thread
    inside a span goes to "outside spans". Returns {name: seconds}, which
    sums to the idle seconds. Times are in ns."""
    points = [(lo, 2, 0, 0, None), (hi, 2, 0, 0, None)]
    for e in (e for e in evs if e.end_ns > e.start_ns):  # a span of no length holds no idle time
        # at one instant: busy edges, then closes (inner first), then opens (outer first)
        points.append((e.start_ns, 1, e.sid, e.thread, e.name))
        points.append((e.end_ns, 0, -e.sid, e.thread, e.name))
    for a, b in busy:
        points.append((a, -1, 1, 0, None))
        points.append((b, -1, -1, 0, None))
    points.sort(key=lambda p: p[:3])
    stacks = {}  # thread -> [(sid, name)] of its open spans, outermost first
    depth = 0  # busy intervals open
    out = {}
    t_prev = None
    for t, kind, key, thread, name in points:
        if t_prev is not None and t > t_prev and depth == 0:
            a, b = max(t_prev, lo), min(t, hi)
            if b > a:
                inside = [st[-1][1] for st in stacks.values() if st]
                if inside:
                    share = (b - a) / 1e9 / len(inside)
                    for n in inside:
                        out[n] = out.get(n, 0.0) + share
                else:
                    out["outside spans"] = out.get("outside spans", 0.0) + (b - a) / 1e9
        t_prev = t
        if kind == -1:
            depth += key
        elif kind == 1:
            stacks.setdefault(thread, []).append((key, name))
        elif kind == 0:
            st = stacks[thread]
            if st and st[-1][0] == -key:
                st.pop()
            else:
                st.remove((-key, name))
    return out


def _launches_on_clock(launches) -> tuple:
    """[(name, start ns, end ns)] of the launches ((name, device index,
    start event, end event)) on an anchored card, and how many were on
    none."""
    import torch

    torch.cuda.synchronize()
    with _LOCK:
        anchors = dict(_ANCHORS)
    placed, skipped = [], 0
    for name, index, start, end in launches:
        a = anchors.get(index)
        if a is None:
            skipped += 1
            continue
        ev0, t0 = a
        placed.append((name, t0 + round(ev0.elapsed_time(start) * 1e6), t0 + round(ev0.elapsed_time(end) * 1e6)))
    return placed, skipped


def summary(launches=None) -> str:
    """The phase table (calls, inclusive and self seconds, mean and max ms,
    the parent most of a phase's calls ran in, or, starred, the span on
    another thread that caused them), one line a build (its wall, spans
    and threads; a broker's spans serve many builds and count in none)
    and, where `launches`
    ((name, device index, start event, end event) per kernel launch, the
    launch log's) are given and a card was anchored, the card's section:
    the window from the first anchor to the last span's end, the busy
    share (the union of the launches), kernel seconds by name, and idle
    seconds by innermost span."""
    evs = events()
    if not evs:
        return "trace: no spans recorded"
    by_sid = {e.sid: e for e in evs}
    self_s = self_times(evs)
    rows = {}
    for e in evs:
        r = rows.setdefault(e.name, [0, 0.0, 0.0, 0.0, {}])
        dt = (e.end_ns - e.start_ns) / 1e9
        r[0] += 1
        r[1] += dt
        r[2] += self_s[e.sid]
        r[3] = max(r[3], dt)
        if e.parent in by_sid:
            p = by_sid[e.parent].name
        else:  # a thread's outermost span: the span that handed it the work, starred
            p = next((by_sid[c].name + "*" for c in e.causes if c in by_sid), "-")
        r[4][p] = r[4].get(p, 0) + 1
    order = sorted(rows.items(), key=lambda kv: -kv[1][1])
    width = max(len(k) for k in rows)
    lines = [f"{'phase':<{width}}  {'calls':>6}  {'total_s':>9}  {'self_s':>9}  {'mean_ms':>9}  {'max_ms':>9}  parent"]
    for name, (n, tot, own, mx, parents) in order:
        parent = max(parents.items(), key=lambda kv: kv[1])[0]
        lines.append(f"{name:<{width}}  {n:>6}  {tot:>9.3f}  {own:>9.3f}  {tot / n * 1e3:>9.2f}  {mx * 1e3:>9.2f}  {parent}")
    builds = {}
    for e in evs:
        if e.build is not None:
            b = builds.setdefault(e.build, [e.start_ns, e.end_ns, 0, set()])
            b[0], b[1], b[2] = min(b[0], e.start_ns), max(b[1], e.end_ns), b[2] + 1
            b[3].add(e.thread)
    for bid, (a, b, n, threads) in sorted(builds.items()):
        lines.append(f"build {bid}: {(b - a) / 1e9:.3f} s from its first span's start to its last span's end, "
                     f"{n} spans on {len(threads)} threads")
    if launches is None or not _ANCHORS:
        return "\n".join(lines)
    placed, skipped = _launches_on_clock(launches)
    with _LOCK:
        lo = min(t for _ev, t in _ANCHORS.values())
    hi = max(e.end_ns for e in evs)
    window = (hi - lo) / 1e9
    busy = [[max(a, lo), min(b, hi)] for a, b in union((a, b) for _n, a, b in placed) if b > lo and a < hi]
    busy_s = sum(b - a for a, b in busy) / 1e9
    lines.append("")
    lines.append(f"device: window {window:.3f} s, {len(placed)} launches"
                 + (f" ({skipped} on cards not anchored)" if skipped else "")
                 + f", busy {busy_s:.3f} s, busy share {busy_s / window if window > 0 else 0.0:.4f}")
    kernels = {}
    for name, a, b in placed:
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e9
    for name, s in sorted(kernels.items(), key=lambda kv: -kv[1]):
        lines.append(f"  kernel {name:<{width}}  {s:>9.3f} s")
    idle = idle_by_innermost(evs, busy, lo, hi)
    lines.append(f"idle {window - busy_s:.3f} s by innermost span (sums to {sum(idle.values()):.3f} s):")
    for name, s in sorted(idle.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<{width}}  {s:>9.3f} s")
    return "\n".join(lines)
