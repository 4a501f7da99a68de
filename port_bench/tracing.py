"""What a traced run (--trace 1) records, from outside the program:

- the program's spans (`pangraph_tpu_torch.utils.trace.span`, which every
  layer calls by attribute) with each one's thread, start and end;
- the kernels' launch log (`stripe_v2.KERNEL_TIMING`): a CUDA event pair
  on the launch's stream around each kernel, placed on the window's clock
  by an event recorded when the window opens;
- the DP problems the card is handed: each problem planned onto a kernel
  launch by the aligner (`BatchAligner._plan`, wrapped on the instance),
  with its rows, query length, working band half-width and kernel route;
- the aligner's engine receipts (`BatchAligner.engine_report()`).

`stop()` restores the program and returns the record the per-layer
metric readers (metrics/*.py) take. Nothing here changes what a job does;
tracing costs two clock reads and an append per span and two events per
kernel launch."""
from __future__ import annotations

import contextlib
import threading
import time


class TraceRecorder:
    def __init__(self, aligner):
        self.aligner = aligner
        self.intervals = []  # (name, thread id, start s, end s) on the window's clock
        self.problems = []  # (ckpt, rlen, qlen, W) per problem planned onto a launch
        self._lock = threading.Lock()

    def start(self) -> None:
        import torch

        from pangraph_tpu_torch.ops import stripe_v2
        from pangraph_tpu_torch.utils import trace

        self._trace, self._stripe = trace, stripe_v2
        self._span = trace.span
        trace.span = self._record_span
        stripe_v2.KERNEL_TIMING = []
        plan = self.aligner._plan

        def planned(jobs, widths, kbumps):
            out = plan(jobs, widths, kbumps)
            rows = [(bool(ckpt), len(jobs[i].ref), len(jobs[i].qry), int(widths[i]))
                    for sub, _R, _B, _K, ckpt in out[0] for i in sub]
            with self._lock:
                self.problems.extend(rows)
            return out

        self.aligner._plan = planned
        self._cuda = self.aligner.device is not None and self.aligner.device.type == "cuda"
        if self._cuda:
            torch.cuda.synchronize()
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def _record_span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            iv = (name, threading.get_ident(), t - self.t0, time.perf_counter() - self.t0)
            with self._lock:
                self.intervals.append(iv)

    def stop(self, jobs: int, window_s: float) -> dict:
        import torch

        self._trace.span = self._span
        del self.aligner._plan
        log, self._stripe.KERNEL_TIMING = self._stripe.KERNEL_TIMING, None
        launches = []
        if self._cuda:
            torch.cuda.synchronize()
            for name, B, R, m, _dev, start, end, _stream in log:
                launches.append({"name": name, "B": B, "R": R, "m": m,
                                 "start_s": self._ev0.elapsed_time(start) / 1e3,
                                 "end_s": self._ev0.elapsed_time(end) / 1e3})
        spans = {}
        for name, _tid, a, b in self.intervals:
            spans[name] = spans.get(name, 0.0) + (b - a)
        return {
            "jobs": jobs,
            "window_s": window_s,
            "spans": spans,
            "span_intervals": self.intervals,
            "launches": launches,
            "dp_problems": self.problems,
            "engine": type(self.aligner).engine_report(),
        }


def union(intervals: list) -> list:
    """Merge [(start, end)] into disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def clip(intervals: list, lo: float, hi: float) -> list:
    return [[max(a, lo), min(b, hi)] for a, b in intervals if b > lo and a < hi]


def busy(record: dict) -> list:
    """The device's busy intervals in the window: the union of every
    logged kernel's event pair (copies are not in the launch log)."""
    return clip(union([(l["start_s"], l["end_s"]) for l in record["launches"]]), 0.0, record["window_s"])


def idle_by_span(record: dict) -> list:
    """[(span name, idle device seconds during which some thread was inside
    a span of that name)], most first, with ("outside spans", idle seconds
    during which no thread was inside any span)."""
    w = record["window_s"]
    idle, t = [], 0.0
    for a, b in busy(record):
        if a > t:
            idle.append([t, a])
        t = max(t, b)
    if t < w:
        idle.append([t, w])

    def overlap(ivs):
        s, j = 0.0, 0
        for a, b in ivs:
            while j < len(idle) and idle[j][1] <= a:
                j += 1
            k = j
            while k < len(idle) and idle[k][0] < b:
                s += min(b, idle[k][1]) - max(a, idle[k][0])
                k += 1
        return s

    by_name = {}
    for name, _tid, a, b in record["span_intervals"]:
        by_name.setdefault(name, []).append((a, b))
    out = [(name, overlap(union(ivs))) for name, ivs in by_name.items()]
    inside = overlap(union([(a, b) for _n, _t, a, b in record["span_intervals"]]))
    out.append(("outside spans", sum(b - a for a, b in idle) - inside))
    return sorted(out, key=lambda kv: -kv[1])
