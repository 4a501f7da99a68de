"""The port's round broker and overlapped host leg
(pangraph_tpu_torch/ops/batch_align.py: `_broker_submit`, `_broker_loop`,
`_run_round`), on the CPU (device="cpu", the plain versions of the
kernels), held against the reference's `TpuBatchAligner` where it has the
same behaviour.

- Two threads' device legs ride one combined round, each gets its own
  Edits (a port of tests/test_watchdog.py's
  test_broker_coalesces_concurrent_device_rounds).
- A raising launch reaches every leg of its round; an idle broker stands
  down and the next submit respawns it.
- The host leg runs while the device leg is in flight.
- Under a host-leg budget, the jobs sent to the host are the reference's.
- On the checkpoint route, a leg's engines and Edits do not depend on the
  legs it meets (the port merges planned launches, not jobs)."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from pangraph_tpu.align.map_variations import map_variations as ref_map_variations
from pangraph_tpu.align.params import BandedAlignParams as RefParams
from pangraph_tpu.align.params import BandParameters as RefBand
from pangraph_tpu.ops.batch_align import AlignJob as RefJob
from pangraph_tpu.ops.batch_align import TpuBatchAligner
from pangraph_tpu_torch.align.params import BandedAlignParams, BandParameters
from pangraph_tpu_torch.ops import batch_align as ba
from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner

ACGT = np.frombuffer(b"ACGT", np.uint8)
JOIN_S = 60


def _pairs(n, L, seed, n_sub=6):
    """n (ref, qry) pairs of L bp, qry with n_sub substitutions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ref = ACGT[rng.integers(0, 4, L)]
        qry = ref.copy()
        idx = rng.choice(L, n_sub, replace=False)
        qry[idx] = ACGT[(np.searchsorted(ACGT, qry[idx]) + 1) % 4]
        out.append((ref, qry))
    return out


def _jobs(pairs, band_width=8, hint=0):
    return [AlignJob(r, q, BandParameters(0, band_width), hint) for r, q in pairs]


def _as_tuples(edit):
    return (
        [(x.pos, x.alt) for x in edit.subs],
        [(x.pos, x.len) for x in edit.dels],
        [(x.pos, x.seq) for x in edit.inss],
    )


def _in_threads(fns: dict) -> dict:
    """Run each fn in a thread of its own; returns {key: result or the
    exception it raised}. Every thread must end within JOIN_S."""
    out = {}

    def run(key, fn):
        try:
            out[key] = fn()
        except Exception as e:  # handed to the test
            out[key] = e

    ths = [threading.Thread(target=run, args=kv) for kv in fns.items()]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in ths), "a leg never returned"
    return out


@pytest.fixture(autouse=True)
def _fresh_stats():
    BatchAligner.reset_engine_stats()
    yield
    BatchAligner.reset_engine_stats()


def _launch_sizes(monkeypatch, name="stripe_align"):
    """Record the problems of every launch the aligner makes."""
    sizes = []
    orig = getattr(ba, name)

    def spy(ref_seq, *a, **k):
        sizes.append(ref_seq.shape[0])
        return orig(ref_seq, *a, **k)

    monkeypatch.setattr(ba, name, spy)
    return sizes


def test_broker_coalesces_concurrent_device_rounds(monkeypatch):
    """Two threads' legs of 5 and 7 jobs ride one combined round of 12
    problems under a 0.3 s gather window, and each thread gets exactly its
    own Edits, equal to the reference's kernel route on the same jobs."""
    monkeypatch.setattr(BatchAligner, "BROKER_GATHER_S", 0.3)
    sizes = _launch_sizes(monkeypatch)
    pairs = {"a": _pairs(5, 500, seed=31), "b": _pairs(7, 500, seed=32)}
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    out = _in_threads({k: (lambda p=p: al.align_many(_jobs(p))) for k, p in pairs.items()})
    ref = TpuBatchAligner(RefParams(), 5, 4)
    ref.NATIVE_CELL_BUDGET = 0  # the Pallas kernels (interpret mode) take every job
    for key, ps in pairs.items():
        want = ref.align_many([RefJob(r, q, RefBand(0, 8)) for r, q in ps])
        assert [_as_tuples(e) for e in out[key]] == [_as_tuples(e) for e in want]
        for (r, q), e in zip(ps, out[key]):
            assert np.array_equal(e.apply(r), q)
    assert sizes == [12], sizes
    rep = BatchAligner.engine_report()
    assert rep["broker"] == {"rounds": 1, "legs": 2, "max_legs": 2}
    assert [(n, c) for k, n, c, _s, _bp in BatchAligner.STATS if k == "broker[legs=2]"] == [
        (12, rep["device"]["cells"])]


def test_raising_launch_reaches_every_leg_and_the_broker_respawns(monkeypatch):
    """A launch that raises fails both legs of its combined round, and
    neither hangs; later rounds run. An idle broker stands down, and the
    next submit starts a new one."""
    monkeypatch.setattr(BatchAligner, "BROKER_GATHER_S", 0.3)
    orig = ba.stripe_align
    fail = [True]

    def launch(*a, **k):
        if fail[0]:
            raise RuntimeError("launch failed")
        return orig(*a, **k)

    spawns = []
    orig_loop = BatchAligner._broker_loop

    def loop(self):
        spawns.append(threading.current_thread().name)
        return orig_loop(self)

    monkeypatch.setattr(ba, "stripe_align", launch)
    monkeypatch.setattr(BatchAligner, "_broker_loop", loop)
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    pairs = {"a": _pairs(2, 300, seed=1), "b": _pairs(3, 300, seed=2)}
    out = _in_threads({k: (lambda p=p: al.align_many(_jobs(p))) for k, p in pairs.items()})
    for key in pairs:
        assert isinstance(out[key], RuntimeError) and "launch failed" in str(out[key]), out[key]
    assert len(spawns) == 1  # one broker took the failing round and kept running
    monkeypatch.setattr(BatchAligner, "BROKER_IDLE_S", 0.05)
    deadline = time.time() + JOIN_S
    while al._broker_running and time.time() < deadline:
        time.sleep(0.01)
    assert not al._broker_running, "the idle broker did not stand down"
    fail[0] = False
    edits = al.align_many(_jobs(pairs["a"]))
    assert len(spawns) == 2  # a new broker thread took the round
    for (r, q), e in zip(pairs["a"], edits):
        assert np.array_equal(e.apply(r), q)


def test_host_leg_runs_while_the_device_leg_is_in_flight(monkeypatch):
    """The host leg starts after the device leg's launch and ends before the
    launch returns: each side waits, with a timeout, for the other."""
    from pangraph_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    pairs = _pairs(4, 400, seed=5) + _pairs(1, 200, seed=6)
    jobs = _jobs(pairs)
    smallest = BatchAligner._job_cells(jobs[-1], 8 + 5)
    monkeypatch.setattr(BatchAligner, "NATIVE_CELL_BUDGET", smallest)
    launched, host_done = threading.Event(), threading.Event()
    seen = {}
    orig_launch, orig_native = ba.stripe_align, BatchAligner._run_round_native

    def launch(*a, **k):
        launched.set()
        seen["host_during_launch"] = host_done.wait(JOIN_S)
        return orig_launch(*a, **k)

    def host_leg(self, h_jobs, widths):
        seen["launch_before_host"] = launched.wait(JOIN_S)
        seen["host_jobs"] = len(h_jobs)
        try:
            return orig_native(self, h_jobs, widths)
        finally:
            host_done.set()

    monkeypatch.setattr(ba, "stripe_align", launch)
    monkeypatch.setattr(BatchAligner, "_run_round_native", host_leg)
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    edits = _in_threads({"leg": lambda: al.align_many(jobs)})["leg"]
    assert seen == {"launch_before_host": True, "host_during_launch": True, "host_jobs": 1}
    for (r, q), e in zip(pairs, edits):
        assert np.array_equal(e.apply(r), q)


def _budget_jobs():
    """Jobs of varied DP area, the smallest first to fill a host budget,
    and one band past the kernel's clamp, which the host takes whatever the
    budget."""
    pairs = []
    for s, L in enumerate((900, 250, 1400, 400, 700, 300, 1100, 600)):
        pairs += _pairs(1, L, seed=40 + s, n_sub=4)
    wide = _pairs(1, 1500, seed=60, n_sub=4)[0]
    bands = [8] * len(pairs) + [1100]
    return pairs + [wide], bands


@pytest.mark.parametrize("n_small", [1, 3, 5])
def test_host_leg_under_a_budget_matches_the_reference(monkeypatch, n_small):
    """With NATIVE_CELL_BUDGET set to the cells of the n_small smallest jobs,
    the port's first round sends the same jobs to the host leg and to the
    device as the reference's, under tests/test_watchdog.py's settings for
    the broker test (a proven, fast TPU). (A budget of 0 differs by design:
    the reference then has no host leg, and clamps the wide band on the
    device.)"""
    from pangraph_tpu import native as ref_native

    if ref_native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    pairs, bands = _budget_jobs()
    slot = {id(r): s for s, (r, _q) in enumerate(pairs)}
    cells = sorted(BatchAligner._job_cells(AlignJob(r, q, BandParameters(0, b)), b + 5)
                   for (r, q), b in zip(pairs, bands))
    budget = sum(cells[:n_small])

    # the reference
    ref_params = RefParams()
    monkeypatch.setattr(TpuBatchAligner, "_device_kind_cache", "tpu")
    monkeypatch.setattr(TpuBatchAligner, "MEASURED_RTT", None)
    monkeypatch.setattr(TpuBatchAligner, "DEVICE_UNHEALTHY", False)
    ref_calls = {"host": [], "device": []}
    ref_native_round = TpuBatchAligner._run_round_native

    def ref_dispatch(self, jobs, widths, kbumps=None, count=True):
        ref_calls["device"].append({slot[id(j.ref)] for j in jobs})
        return ([ref_map_variations(j.ref, j.qry, j.band, ref_params, self.extra) for j in jobs],
                [False] * len(jobs), [False] * len(jobs))

    def ref_host(self, jobs, widths):
        ref_calls["host"].append({slot[id(j.ref)] for j in jobs})
        return ref_native_round(self, jobs, widths)

    monkeypatch.setattr(TpuBatchAligner, "_dispatch_device", ref_dispatch)
    monkeypatch.setattr(TpuBatchAligner, "_run_round_native", ref_host)
    ref = TpuBatchAligner(ref_params, 5, 4)
    ref.NATIVE_CELL_BUDGET = budget
    ref._host_rate, ref._dev_rate, ref._dev_lat = 1e9, 1e12, 0.0
    ref.align_many([RefJob(r, q, RefBand(0, b)) for (r, q), b in zip(pairs, bands)])

    # the port
    port_calls = {"host": [], "device": []}
    port_native_round, port_device_round = BatchAligner._run_round_native, BatchAligner._run_round_device

    def port_host(self, jobs, widths):
        port_calls["host"].append({slot[id(j.ref)] for j in jobs})
        return port_native_round(self, jobs, widths)

    def port_device(self, jobs, widths, kbumps):
        port_calls["device"].append({slot[id(j.ref)] for j in jobs})
        return port_device_round(self, jobs, widths, kbumps)

    monkeypatch.setattr(BatchAligner, "_run_round_native", port_host)
    monkeypatch.setattr(BatchAligner, "_run_round_device", port_device)
    monkeypatch.setattr(BatchAligner, "NATIVE_CELL_BUDGET", budget)
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    edits = al.align_many([AlignJob(r, q, BandParameters(0, b)) for (r, q), b in zip(pairs, bands)])

    wide = len(pairs) - 1
    assert wide in port_calls["host"][0]
    assert len(port_calls["host"][0]) == n_small + 1
    assert port_calls["host"][0] == ref_calls["host"][0]
    assert port_calls["device"][0] == ref_calls["device"][0]
    for (r, q), e in zip(pairs, edits):
        assert np.array_equal(e.apply(r), q)


def test_ckpt_route_legs_do_not_depend_on_their_launch_mates(monkeypatch):
    """On the checkpoint route, leg A holds an event-dense job (its hint past
    CKPT_K_CAP sends its whole sub-batch to the host) beside a wider band;
    leg B holds jobs of the dense job's (tier, band) and one of A's wider
    band. Coalesced with A or run alone, B's jobs take the same engine and
    get the same Edits: the broker merges planned launches, not jobs."""
    dense = _jobs(_pairs(1, 700, seed=70), hint=BatchAligner.CKPT_K_CAP)
    a_wide = _jobs(_pairs(1, 600, seed=71), band_width=100)
    b_jobs = _jobs(_pairs(3, 650, seed=72)) + _jobs(_pairs(1, 550, seed=73), band_width=100)
    host = []
    orig_fallback = BatchAligner._host_fallback

    def fallback(self, job, count=True):
        host.append(id(job.ref))
        return orig_fallback(self, job, count)

    monkeypatch.setattr(BatchAligner, "_host_fallback", fallback)
    monkeypatch.setattr(BatchAligner, "BROKER_GATHER_S", 0.3)
    sizes = _launch_sizes(monkeypatch, "stripe_align_ckpt")

    def engines(jobs):
        return ["host" if id(j.ref) in host else "device" for j in jobs]

    alone = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=0).align_many(b_jobs)
    alone_engines = engines(b_jobs)
    assert alone_engines == ["device"] * 4 and sorted(sizes) == [1, 3]
    host.clear()
    sizes.clear()
    BatchAligner.reset_engine_stats()
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu", ckpt_paths_bytes=0)
    out = _in_threads({"a": lambda: al.align_many(dense + a_wide), "b": lambda: al.align_many(b_jobs)})
    assert engines(dense) == ["host"] and engines(a_wide) == ["device"]
    assert engines(b_jobs) == alone_engines
    assert [_as_tuples(e) for e in out["b"]] == [_as_tuples(e) for e in alone]
    assert BatchAligner.engine_report()["broker"]["max_legs"] == 2
    assert sorted(sizes) == [2, 3]  # the two wider bands rode one launch
    for j, e in zip(dense + a_wide + b_jobs, out["a"] + out["b"]):
        assert np.array_equal(e.apply(j.ref), j.qry)
