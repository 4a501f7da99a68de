"""The port's adaptive host/device split (pangraph_tpu_torch/ops/batch_align.py:
`_gate`, `_observe_rate`, `_effective_dev_lat`, the probe leg in
`_run_round`, the device-rate observation in `_leg_decoded`), on the CPU
(device="cpu", the kernels' plain versions), held against the reference's
`TpuBatchAligner` on the same inputs and state. The reference is told it
has a TPU (`_device_kind_cache = "tpu"`) and its device legs are faked; the
port's run the plain versions.

(a) One round in many states: the same jobs to the host and to the device,
    and the same gate state after it.
(b) One sequence of rate observations: the same EMAs and round trip.
(c) The reference's five gate tests (tests/test_watchdog.py), on the port.
(d) Two threads in probe mode: the one that finds the other's probe leg in
    flight, at the gate or at the test-and-set, runs whole on the host.
(e) A probe leg whose launch raises makes align_many raise, and no job of
    it is served from the host (the reference serves them from the host).
(f) The device rate is observed once per combined round, from a wall that
    holds the legs' decode.
(g) A mixed round's legs run side by side, the device leg's decode beside
    the host leg, so its wall is the gate's predicted mixed wall.

Also: chip_smoke's recomputation of the gate (check_gate_log) against a
gated run's log, and the reference's checkpoint-route rate rule
(`_ckpt_competitive`), held against the port's:

(h) A group whose records do not fit takes the same route in both packages
    in six rate states, and the explicit override takes it whatever the
    rates.
(i) A sequence of rounds wholly on the checkpoint route gives the
    reference's checkpoint-rate EMA, a round under RATE_MIN_CELLS none;
    the round's host-fallback jobs stay outside it.
(j) A round with checkpoint and v2 launches observes no checkpoint rate.
(k) A checkpoint launch that raises makes align_many raise, as in (e).
(l) chip_smoke's recomputation of the checkpoint-route log."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import chip_smoke
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


def _pairs(n=12, L=400, seed=3):
    """tests/test_watchdog.py's _jobs(n, L, seed) recipe, as (ref, qry) pairs
    with band (0, 8)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ref = ACGT[rng.integers(0, 4, L)]
        qry = ref.copy()
        idx = rng.choice(L, 6, replace=False)
        qry[idx] = ACGT[rng.integers(0, 4, 6)]
        out.append((ref, qry))
    return out


def _port_jobs(pairs):
    return [AlignJob(r, q, BandParameters(0, 8)) for r, q in pairs]


def _ref_jobs(pairs):
    return [RefJob(r, q, RefBand(0, 8)) for r, q in pairs]


def _port(budget: int, **state) -> BatchAligner:
    al = BatchAligner(BandedAlignParams(), 5, 4, device="cpu")
    al.NATIVE_CELL_BUDGET = budget
    for k, v in state.items():
        setattr(al, k, v)
    return al


CELLS = BatchAligner._job_cells(_port_jobs(_pairs(1))[0], 13)  # one job's cells at its working band


@pytest.fixture(autouse=True)
def _class_state(monkeypatch):
    """The reference is a healthy TPU with no measured round trip; both
    classes' class-level state is restored after each test
    (tests/test_watchdog.py:21-34)."""
    monkeypatch.setattr(TpuBatchAligner, "_device_kind_cache", "tpu")
    monkeypatch.setattr(TpuBatchAligner, "DEVICE_UNHEALTHY", False)
    monkeypatch.setattr(TpuBatchAligner, "DEVICE_EVER_STALLED", TpuBatchAligner.DEVICE_EVER_STALLED)
    monkeypatch.setattr(TpuBatchAligner, "MEASURED_RTT", None)
    monkeypatch.setattr(BatchAligner, "MEASURED_RTT", None)
    monkeypatch.setattr(BatchAligner, "_LAST_GATE", dict(BatchAligner._LAST_GATE))
    BatchAligner.reset_engine_stats()
    yield
    BatchAligner.reset_engine_stats()


def _frozen_clock(monkeypatch):
    """time.time() stands still, so that no round's wall is a rate
    observation ((b), (c) and (f) cover those): both packages' state then
    moves by the gate alone."""
    frozen = time.time()
    monkeypatch.setattr(time, "time", lambda: frozen)


# (a): name, device rate, host rate, overhead L, starved, probe period,
# budget, RATE_MIN_CELLS, MEASURED_RTT, and the gate's decision
H = 3.667e6  # a host rate at which L = 0.03 s opens the gate on a small device share
STATES = [
    ("probe-cap", None, None, 0.03, 0, 8, CELLS, None, None, "probe"),
    ("probe-L10", None, 1e9, 10.0, 0, 8, CELLS, None, None, "probe"),
    ("probe-budget-covers", None, 1e9, 0.03, 0, 8, int(1e8), None, None, "probe"),
    ("probe-budget-0", None, None, 0.03, 0, 8, 0, None, None, None),
    ("open-L0", 3e9, 1e9, 0.0, 0, 8, CELLS, None, None, "open"),
    ("open-budget-1e8", 3e9, 1e9, 0.0, 0, 8, int(1e8), None, None, "open"),
    ("closed-break-even", 1e9, 1e9, 0.0, 0, 8, CELLS, None, None, "closed"),
    ("closed-L0.03", 3e9, 1e9, 0.03, 0, 8, CELLS, None, None, "closed"),
    ("closed-rtt", 3e9, 1e9, 0.0, 0, 8, CELLS, None, 0.2, "closed"),
    ("closed-below-1.3-L10", 1.2e9, 1e9, 10.0, 0, 64, CELLS, 10_000, None, "closed"),
    ("slice-starved-7", 3e9, 1e9, 10.0, 7, 8, CELLS, 10_000, None, "slice"),
    ("closed-starved-7-period-64", 3e9, 1e9, 10.0, 7, 64, CELLS, 10_000, None, "closed"),
    ("slice-starved-8-budget-1e8", 1e9, 1e9, 0.0, 8, 8, int(1e8), 10_000, None, "slice"),
    ("open-anti-starvation", 100 * H, H, 0.03, 7, 8, CELLS, 30_000, None, "open"),
    ("open-resets-period", 100 * H, H, 0.03, 0, 64, CELLS, 30_000, None, "open"),
    ("fixed-no-host-rate", 3e9, None, 0.03, 0, 8, CELLS, None, None, "fixed"),
    ("device-rate-budget-0", 3e9, 1e9, 0.03, 0, 8, 0, None, None, None),
]


@pytest.mark.parametrize("name,d,h,L,starved,period,budget,rate_min,rtt,gate", STATES, ids=[s[0] for s in STATES])
def test_round_routes_as_the_reference(monkeypatch, name, d, h, L, starved, period, budget, rate_min, rtt, gate):
    """(a) One round of the reference's _jobs(n=12, seed=3) in one state:
    the port sends the same jobs to the host leg and to the device as the
    reference, and ends in the same _dev_starved, _probe_period,
    _host_rate, _dev_rate and MEASURED_RTT."""
    pairs = _pairs()
    slot = {id(r): s for s, (r, _q) in enumerate(pairs)}
    state = {"_dev_rate": d, "_host_rate": h, "_dev_lat": L, "_dev_starved": starved, "_probe_period": period}
    if rate_min is not None:
        state["RATE_MIN_CELLS"] = rate_min
    monkeypatch.setattr(TpuBatchAligner, "MEASURED_RTT", rtt)
    monkeypatch.setattr(BatchAligner, "MEASURED_RTT", rtt)

    ref_params = RefParams()
    ref_calls = {"host": [], "device": []}
    ref_native = TpuBatchAligner._run_round_native

    def ref_dispatch(self, jobs, widths, kbumps=None, count=True):
        ref_calls["device"].append({slot[id(j.ref)] for j in jobs})
        return ([ref_map_variations(j.ref, j.qry, j.band, ref_params, self.extra) for j in jobs],
                [False] * len(jobs), [False] * len(jobs))

    def ref_host(self, jobs, widths):
        ref_calls["host"].append({slot[id(j.ref)] for j in jobs})
        return ref_native(self, jobs, widths)

    monkeypatch.setattr(TpuBatchAligner, "_dispatch_device", ref_dispatch)
    monkeypatch.setattr(TpuBatchAligner, "_run_round_native", ref_host)
    port_calls = {"host": [], "device": []}
    port_native, port_device = BatchAligner._run_round_native, BatchAligner._run_round_device

    def p_host(self, jobs, widths):
        port_calls["host"].append({slot[id(j.ref)] for j in jobs})
        return port_native(self, jobs, widths)

    def p_device(self, jobs, widths, kbumps):
        port_calls["device"].append({slot[id(j.ref)] for j in jobs})
        return port_device(self, jobs, widths, kbumps)

    monkeypatch.setattr(BatchAligner, "_run_round_native", p_host)
    monkeypatch.setattr(BatchAligner, "_run_round_device", p_device)

    ref = TpuBatchAligner(ref_params, 5, 4)
    ref.NATIVE_CELL_BUDGET = budget
    for k, v in state.items():
        setattr(ref, k, v)
    port = _port(budget, **state)
    widths = [8 + 5] * len(pairs)
    _frozen_clock(monkeypatch)
    ref._run_round(_ref_jobs(pairs), widths, [1] * len(pairs))
    port._run_round(_port_jobs(pairs), widths, [1] * len(pairs))

    assert port_calls == ref_calls
    assert sum(len(x) for v in port_calls.values() for x in v) == len(pairs)
    for attr in ("_dev_starved", "_probe_period", "_host_rate", "_dev_rate"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert BatchAligner.MEASURED_RTT == TpuBatchAligner.MEASURED_RTT
    log = BatchAligner.GATE_LOG
    assert [e["gate"] for e in log] == ([] if gate is None else [gate])


def test_rate_observations_match_the_reference(monkeypatch):
    """(b) One seeded sequence of (engine, cells, seconds) observations, fed
    to both _observe_rate's from a stale 0.5 s round trip: the EMAs, the
    starved count and MEASURED_RTT are equal after every step, and every
    rule (too few cells, a stale round trip, an overhead-dominated wall, a
    slope) fires."""
    monkeypatch.setattr(TpuBatchAligner, "MEASURED_RTT", 0.5)
    monkeypatch.setattr(BatchAligner, "MEASURED_RTT", 0.5)
    ref = TpuBatchAligner(RefParams())
    port = _port(0)
    rng = np.random.default_rng(7)
    rmc = BatchAligner.RATE_MIN_CELLS
    fired = set()
    for step in range(200):
        which = ["host", "dev"][int(rng.integers(0, 2))]
        cells = int(rng.choice([rmc // 2, rmc, 3 * rmc, 20 * rmc]))
        secs = float(rng.choice([0.0, 0.002, 0.02, 0.04, 0.2, 0.7, 2.5]) * rng.uniform(0.5, 1.5))
        ref._dev_starved = port._dev_starved = step % 5
        rtt_before, rate_before = BatchAligner.MEASURED_RTT, port._dev_rate
        ref._observe_rate(which, cells, secs)
        port._observe_rate(which, cells, secs)
        assert (port._host_rate, port._dev_rate, port._dev_starved) == (ref._host_rate, ref._dev_rate, ref._dev_starved)
        assert BatchAligner.MEASURED_RTT == TpuBatchAligner.MEASURED_RTT
        if cells < rmc or secs <= 0:
            fired.add("nothing to observe")
        elif which == "dev" and BatchAligner.MEASURED_RTT != rtt_before:
            fired.add("stale round trip")
        elif which == "dev":
            fired.add("overhead-dominated" if port._dev_rate == rate_before else "slope")
    assert fired == {"nothing to observe", "stale round trip", "overhead-dominated", "slope"}


# (c): the reference's gate tests (tests/test_watchdog.py), on the port


def _fake_device_leg(seen: dict):
    """A device leg that records its jobs and returns no Edits."""

    def leg(self, jobs, widths, kbumps):
        seen["dev"] = seen.get("dev", 0) + len(jobs)
        n = len(jobs)
        return (lambda: ([None] * n, [False] * n, [False] * n)), 0

    return leg


def _widths(jobs, al):
    return [j.band.band_width + al.extra for j in jobs]


def test_adaptive_split_tracks_engine_rates(monkeypatch):
    """(c) tests/test_watchdog.py:123. With both rates and a device slope
    past DEVICE_MIN_ADVANTAGE the host's share is h(Ld+C)/(d+h); a device
    at break-even is gated to host-only; small observations are ignored."""
    seen = {}
    monkeypatch.setattr(BatchAligner, "_run_round_device", _fake_device_leg(seen))
    real_native = BatchAligner._run_round_native

    def spy_native(self, jobs, widths):
        seen["host"] = len(jobs)
        return real_native(self, jobs, widths)

    monkeypatch.setattr(BatchAligner, "_run_round_native", spy_native)
    jobs = _port_jobs(_pairs())
    al = _port(CELLS, _dev_lat=0.0)
    al._host_rate, al._dev_rate = 1e9, 3e9
    al._run_round(jobs, _widths(jobs, al), [1] * 12)
    assert 2 <= seen["host"] <= 5 and seen["host"] + seen["dev"] == 12
    seen["dev"] = 0
    al._host_rate, al._dev_rate = 1e9, 1e9
    al._run_round(jobs, _widths(jobs, al), [1] * 12)
    assert seen["host"] == 12 and seen["dev"] == 0
    before = al._host_rate
    al._observe_rate("host", 1000, 0.5)
    assert al._host_rate == before
    al._observe_rate("host", BatchAligner.RATE_MIN_CELLS, 1.0)
    assert al._host_rate != before


def test_latency_gate_routes_host_only(monkeypatch):
    """(c) tests/test_watchdog.py:184. A break-even device on a round far
    smaller than the modeled overhead is gated to host-only, and the gated
    round counts toward the periodic probe slice."""
    seen = {"dev": 0}
    monkeypatch.setattr(BatchAligner, "_run_round_device", _fake_device_leg(seen))
    jobs = _port_jobs(_pairs())
    al = _port(CELLS, _host_rate=1e9, _dev_rate=1e9, _dev_lat=0.03)
    al._run_round(jobs, _widths(jobs, al), [1] * 12)
    assert seen["dev"] == 0, "device dispatched on a round the gate should close"
    assert al._dev_starved == 1


def test_measured_rtt_raises_modeled_latency(monkeypatch):
    """(c) tests/test_watchdog.py:220. The measured round trip raises the
    modeled overhead, capped at 1 s; the floor holds below it."""
    al = _port(0, _dev_lat=0.03)
    for rtt, want in ((None, 0.03), (0.2, 0.2), (30.0, 1.0), (0.001, 0.03)):
        monkeypatch.setattr(BatchAligner, "MEASURED_RTT", rtt)
        assert al._effective_dev_lat() == want


def test_dev_rate_observation_overhead_rules(monkeypatch):
    """(c) tests/test_watchdog.py:236. No slope from an overhead-dominated
    wall; a wall under the overhead decays a stale round trip; an
    informative wall gives cells / (secs - L)."""
    al = _port(0, _dev_lat=0.03)
    C = BatchAligner.RATE_MIN_CELLS
    monkeypatch.setattr(BatchAligner, "MEASURED_RTT", 0.5)
    al._observe_rate("dev", C, 0.3)
    assert al._dev_rate is None
    assert BatchAligner.MEASURED_RTT == pytest.approx(0.15)
    monkeypatch.setattr(BatchAligner, "MEASURED_RTT", 0.5)
    al._observe_rate("dev", C, 0.6)
    assert al._dev_rate is None
    al._observe_rate("dev", C, 1.5)
    assert al._dev_rate == pytest.approx(C / 1.0)


def test_latency_gate_periodic_reprobe(monkeypatch):
    """(c) tests/test_watchdog.py:258. The 8th gated round of measurable
    size gives the device a slice and doubles the probe period; an open
    gate sets it back to 8."""
    seen = {"dev": 0}
    monkeypatch.setattr(BatchAligner, "_run_round_device", _fake_device_leg(seen))
    monkeypatch.setattr(BatchAligner, "RATE_MIN_CELLS", 10_000)
    jobs = _port_jobs(_pairs())
    al = _port(CELLS, _host_rate=1e9, _dev_rate=1e9, _dev_lat=10.0, _dev_starved=7)
    al._run_round(jobs, _widths(jobs, al), [1] * 12)
    assert seen["dev"] > 0, "8th gated round must include a device probe slice"
    assert al._dev_starved == 0 and al._probe_period == 16
    monkeypatch.setattr(BatchAligner, "MEASURED_RTT", None)
    seen["dev"] = 0
    al._dev_rate, al._dev_lat = 5e9, 0.0
    al._run_round(jobs, _widths(jobs, al), [1] * 12)
    assert seen["dev"] > 0 and al._probe_period == 8


# (d)-(f)


def _in_threads(fns: dict) -> dict:
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
    assert not any(t.is_alive() for t in ths), "a thread never returned"
    return out


def _first_calls_wait(monkeypatch, name: str, barrier: threading.Barrier):
    """The first two calls of BatchAligner.<name> wait for each other after
    they return."""
    real, count, lock = getattr(BatchAligner, name), [0], threading.Lock()

    def wrapped(self, *a):
        out = real(self, *a)
        with lock:
            count[0] += 1
            first = count[0] <= 2
        if first:
            barrier.wait(JOIN_S)
        return out

    monkeypatch.setattr(BatchAligner, name, wrapped)


@pytest.mark.parametrize("where", ["gate", "test-and-set"])
def test_round_that_finds_a_probe_leg_in_flight_runs_on_the_host(monkeypatch, where):
    """(d) Two threads in probe mode (no device rate), one probe leg in
    flight per aligner. "gate": thread A's probe leg is held in its launch
    while B's rounds gate, so B's gate sees it in flight. "test-and-set":
    both threads gate before either claims the leg, and both claim before
    either goes on, so one loses the claim. Either way the other thread's
    round runs whole on the host, with a host[probe-wait,n=<jobs>] row,
    and every Edit reproduces its query."""
    pairs = {"a": _pairs(6, 400, seed=5), "b": _pairs(5, 400, seed=6)}
    jobs = {k: _port_jobs(p) for k, p in pairs.items()}
    owner = {id(j.ref): k for k, js in jobs.items() for j in js}
    native_calls = []
    real_native = BatchAligner._run_round_native

    def spy_native(self, h_jobs, widths):
        native_calls.append([owner[id(j.ref)] for j in h_jobs])
        return real_native(self, h_jobs, widths)

    monkeypatch.setattr(BatchAligner, "_run_round_native", spy_native)
    al = _port(CELLS)
    if where == "gate":
        launched, b_done = threading.Event(), threading.Event()
        real_launch = ba.stripe_align

        def held_launch(*a, **k):
            launched.set()
            assert b_done.wait(JOIN_S)
            return real_launch(*a, **k)

        monkeypatch.setattr(ba, "stripe_align", held_launch)

        def b():
            assert launched.wait(JOIN_S)
            try:
                return al.align_many(jobs["b"])
            finally:
                b_done.set()

        out = _in_threads({"a": lambda: al.align_many(jobs["a"]), "b": b})
    else:
        _first_calls_wait(monkeypatch, "_gate", threading.Barrier(2))
        _first_calls_wait(monkeypatch, "_claim_probe", threading.Barrier(2))
        out = _in_threads({k: (lambda k=k: al.align_many(jobs[k])) for k in jobs})
    for k in jobs:
        assert not isinstance(out[k], Exception), out[k]
        for (r, q), e in zip(pairs[k], out[k]):
            assert np.array_equal(e.apply(r), q)
    waits = [e for e in BatchAligner.GATE_LOG if e["kind"] == "probe-wait"]
    rows = [s for s in BatchAligner.STATS if s[0].startswith("host[probe-wait,")]
    assert waits and len(rows) == len(waits)
    if where == "gate":
        assert all(e["gate"] == "probe-wait" and e["inflight"] and not e["race_lost"] for e in waits)
        assert rows[0][0] == f"host[probe-wait,n={len(jobs['b'])}]"
        assert ["b"] * len(jobs["b"]) in native_calls
    else:
        first_two = BatchAligner.GATE_LOG[:2]
        assert sorted(e["kind"] for e in first_two) == ["probe", "probe-wait"]
        lost = next(e for e in first_two if e["kind"] == "probe-wait")
        assert lost["gate"] == "probe" and lost["race_lost"] and lost["host"] == lost["C"] and lost["dev"] == 0
        loser = "a" if rows[0][0] == f"host[probe-wait,n={len(jobs['a'])}]" else "b"
        assert rows[0][0] == f"host[probe-wait,n={len(jobs[loser])}]"
        assert [loser] * len(jobs[loser]) in native_calls
    assert al._probe_inflight is False


def test_failed_probe_leg_raises_and_serves_nothing_from_the_host(monkeypatch):
    """(e) The reference serves a failed probe leg's jobs from the host
    (tests/test_watchdog.py:409); the port does not: a probe leg whose
    launch raises makes align_many raise, no job of the leg reaches a host
    engine, and the probe slot is free again with no device rate."""
    pairs = _pairs()
    jobs = _port_jobs(pairs)
    slot = {id(r): s for s, (r, _q) in enumerate(pairs)}
    host = []
    real_native, real_fallback = BatchAligner._run_round_native, BatchAligner._host_fallback

    def spy_native(self, h_jobs, widths):
        host.extend(slot[id(j.ref)] for j in h_jobs)
        return real_native(self, h_jobs, widths)

    def spy_fallback(self, job, count=True):
        host.append(slot[id(job.ref)])
        return real_fallback(self, job, count)

    def failed_launch(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(BatchAligner, "_run_round_native", spy_native)
    monkeypatch.setattr(BatchAligner, "_host_fallback", spy_fallback)
    monkeypatch.setattr(ba, "stripe_align", failed_launch)
    al = _port(CELLS)
    with pytest.raises(RuntimeError, match="launch failed"):
        al.align_many(jobs)
    (entry,) = BatchAligner.GATE_LOG
    assert entry["kind"] == "probe" and entry["host"] == CELLS and entry["dev"] == 11 * CELLS
    assert len(host) == 1, host  # the budget's one job, routed to the host before the leg ran
    assert al._probe_inflight is False and al._dev_rate is None


@pytest.mark.parametrize("legs", [1, 2])
def test_device_rate_is_observed_with_the_legs_decode(monkeypatch, legs):
    """(f) Every leg's decode is slowed by SLOW s: the device rate is
    observed once per combined round, from the round's wall plus each of its
    legs' decode, so from at least legs * SLOW s, over the legs' cells at
    their working bands. Two legs under a 0.3 s gather window meet in one
    round. The split routes (a budget above 0) with a device rate and no
    host rate, so its budget of 1 cell stands and every job is on the
    device; at budget 0 nothing is observed."""
    SLOW = 0.5
    monkeypatch.setattr(BatchAligner, "RATE_MIN_CELLS", 1)
    monkeypatch.setattr(BatchAligner, "BROKER_GATHER_S", 0.3)
    real_decode, real_observe = BatchAligner._decode, BatchAligner._observe_rate
    seen = []

    def slow_decode(self, *a):
        time.sleep(SLOW)
        return real_decode(self, *a)

    def spy_observe(self, which, cells, secs):
        seen.append((which, cells, secs))
        return real_observe(self, which, cells, secs)

    monkeypatch.setattr(BatchAligner, "_decode", slow_decode)
    monkeypatch.setattr(BatchAligner, "_observe_rate", spy_observe)
    al = _port(1, _dev_rate=1.0)
    groups = [_port_jobs(_pairs(4, 400, seed=20 + g)) for g in range(legs)]
    out = _in_threads({g: (lambda g=g: al.align_many(groups[g])) for g in range(legs)})
    for g, js in enumerate(groups):
        for j, e in zip(js, out[g]):
            assert np.array_equal(e.apply(j.ref), j.qry)
    dev = [s for s in seen if s[0] == "dev"]
    broker = BatchAligner.engine_report()["broker"]
    assert broker["max_legs"] == legs and len(dev) == broker["rounds"]
    rounds = [s for s in BatchAligner.STATS if s[0].startswith("broker[")]
    assert dev[0][1] == sum(BatchAligner._job_cells(j, 13) for js in groups for j in js)
    assert dev[0][2] >= legs * SLOW > rounds[0][3]
    assert al._dev_rate != 1.0
    assert {e["gate"] for e in BatchAligner.GATE_LOG} == {"fixed"}
    assert all(s[0] != "host" for s in seen)

    seen.clear()
    BatchAligner.reset_engine_stats()
    _port(0).align_many(groups[0])
    assert seen == [] and BatchAligner.GATE_LOG == []


def test_mixed_round_wall_is_the_longer_legs(monkeypatch):
    """(g) The gate sizes a mixed round's legs to end together, at
    mixed_wall = (L*d + C)/(d + h). Here the host leg (3 of 12 equal jobs)
    is slowed by SLOW s and the device leg's decode (the other 9) by SLOW s,
    so the engines' rates are h = 3 jobs' cells / SLOW and d = 3h, and with
    L = 0 the gate opens, gives the host those 3 jobs, and predicts
    mixed_wall = SLOW. The round's wall is that, not the legs' sum: the
    device leg's decode runs beside the host leg. (The round's own work
    takes about 0.2 s on the CPU, inside the 0.5 * SLOW margin.)"""
    SLOW = 2.0
    real_decode, real_native = BatchAligner._decode, BatchAligner._run_round_native

    def slow_decode(self, *a):
        time.sleep(SLOW)
        return real_decode(self, *a)

    def slow_native(self, jobs, widths):
        time.sleep(SLOW)
        return real_native(self, jobs, widths)

    monkeypatch.setattr(BatchAligner, "_decode", slow_decode)
    monkeypatch.setattr(BatchAligner, "_run_round_native", slow_native)
    pairs = _pairs()
    C, h = len(pairs) * CELLS, 3 * CELLS / SLOW
    d, L = 3 * h, 0.0
    mixed_wall = (L * d + C) / (d + h)
    al = _port(CELLS, _host_rate=h, _dev_rate=d, _dev_lat=L)
    edits = al.align_many(_port_jobs(pairs))
    for (r, q), e in zip(pairs, edits):
        assert np.array_equal(e.apply(r), q)
    (entry,) = BatchAligner.GATE_LOG
    assert entry["kind"] == "mixed" and entry["host"] == 3 * CELLS and entry["dev"] == 9 * CELLS
    (row,) = [s for s in BatchAligner.STATS if s[0].startswith("mixed[")]
    assert row[0] == "mixed[n=3,d=9]"
    assert mixed_wall <= row[3] < mixed_wall + 0.5 * SLOW, (row, mixed_wall)


def test_gate_log_passes_chip_smokes_recomputation(monkeypatch):
    """chip_smoke.check_gate_log recomputes each logged round's decision
    from the state logged before it with its own copy of the reference's
    rule. A gated run through probe mode, an open gate, nine closed rounds
    (the eighth gives a probe slice) and an open gate again passes it; a
    log whose budget was altered does not. Rates are set between calls, as
    observations would set them; the counters are left to the gate."""
    monkeypatch.setattr(BatchAligner, "RATE_MIN_CELLS", 10_000)
    jobs = _port_jobs(_pairs())
    al = _port(CELLS)
    al.align_many(jobs)  # probe mode
    for h, d, L in [(1e9, 3e9, 0.0)] + [(1e9, 1e9, 10.0)] * 9 + [(H, 100 * H, 0.03)]:
        al._host_rate, al._dev_rate, al._dev_lat = h, d, L
        al.align_many(jobs)
    log = [dict(e) for e in BatchAligner.GATE_LOG]
    settings = chip_smoke.gate_settings(BatchAligner)
    kinds = chip_smoke.check_gate_log("test", log, settings)
    assert {"probe", "mixed", "host-only", "slice"} <= set(kinds)
    assert sum(kinds.values()) == len(log)
    log[-1]["cap"] += 1
    with pytest.raises(AssertionError, match="the rule gives"):
        chip_smoke.check_gate_log("test", log, settings)


class _AllWarm:
    """A _SHAPES_WARM that holds every shape: no round is cold."""

    def __ge__(self, other):
        return True

    def __len__(self):
        return 0

    def update(self, *a):
        pass


def test_reference_ckpt_route_follows_its_measured_rate(monkeypatch):
    """The reference's _ckpt_competitive (pangraph_tpu/ops/batch_align.py:608)
    says yes to the checkpoint route on a healthy TPU until a checkpoint
    rate is known, then only while that rate beats the host's. The rate is
    written (:1220-1222) by a warm round whose every launch is on the
    checkpoint route and which holds at least RATE_MIN_CELLS device cells.
    The port's rule and its route (_route) give the same answer in each of
    CKPT_STATES."""
    ref = TpuBatchAligner(RefParams())
    assert ref._ckpt_rate is None and ref._ckpt_competitive()
    monkeypatch.setattr(TpuBatchAligner, "RATE_MIN_CELLS", 1)
    ref.CKPT_PATHS_BYTES = 0  # every tier to the checkpoint route
    ref._SHAPES_WARM = _AllWarm()

    def planned(self, jobs, planned, edits, boundary, overflow, fb_futs, count=True):
        time.sleep(0.05)
        return edits, boundary, overflow

    monkeypatch.setattr(TpuBatchAligner, "_run_planned", planned)
    jobs = _ref_jobs(_pairs(4))
    ref._run_round_v2(jobs, [13] * 4, [1] * 4)
    assert ref._ckpt_rate is not None and ref._ckpt_rate > 0
    ref._host_rate = ref._ckpt_rate * 2
    assert not ref._ckpt_competitive()
    ref._host_rate = ref._ckpt_rate / 2
    assert ref._ckpt_competitive()
    port = _port(0)
    for _name, ck, h, explicit, _want in CKPT_STATES:
        ref._ckpt_rate, ref._host_rate = port._ckpt_rate, port._host_rate = ck, h
        port.ckpt_paths_bytes = 0 if explicit else 10**18
        answer = explicit or ref._ckpt_competitive()
        assert port._ckpt_competitive() == ref._ckpt_competitive()
        assert port._route(131072, 128, 8 * 131072 * 128 * 2 - 1) == ("ckpt" if answer else "host")


# (h)-(l): name, checkpoint rate, host rate, the explicit override, and
# whether the group takes the checkpoint route
CKPT_STATES = [
    ("no-ckpt-rate", None, 1e9, False, True),
    ("ckpt-above-host", 2e9, 1e9, False, True),
    ("ckpt-below-host", 1e9, 2e9, False, False),
    ("ckpt-equals-host", 1e9, 1e9, False, False),
    ("no-host-rate", 1e9, None, False, True),
    ("override-below-host", 1e9, 2e9, True, True),
]
# records that do not fit: the reference's v2 records of a minimum group of 8
# problems at (4096, 128), 8 * 4096 * 256 * 2 bytes, over half its HBM_BUDGET,
# and the port's, 8 * 4096 * 128 * 2, over a quarter of its record budget
REF_HBM_BUDGET = 8 << 20
PORT_RECORD_BUDGET = 16 << 20


def _ref_ckpt(ck=None, h=None, explicit=False) -> TpuBatchAligner:
    ref = TpuBatchAligner(RefParams())
    ref.HBM_BUDGET = REF_HBM_BUDGET
    ref.CKPT_PATHS_BYTES = 0 if explicit else 10**18
    ref._SHAPES_WARM = _AllWarm()
    ref._ckpt_rate, ref._host_rate = ck, h
    return ref


def _port_ckpt(ck=None, h=None, explicit=False, budget=0) -> BatchAligner:
    port = _port(budget, _ckpt_rate=ck, _host_rate=h)
    port.budget = PORT_RECORD_BUDGET
    port.ckpt_paths_bytes = 0 if explicit else 10**18
    return port


def _ref_routes(monkeypatch, ref, jobs, widths) -> dict:
    """One reference round (_run_round_v2) with its launches faked: the
    jobs it planned on each route and the ones it sent to the host."""
    routes = {"ckpt": set(), "v2": set(), "host": set()}

    def planned(self, r_jobs, planned, edits, boundary, overflow, fb_futs, count=True):
        for sub, *_, ck in planned:
            routes["v2" if ck is None else "ckpt"].update(sub)
        routes["host"].update(fb_futs or ())
        return edits, boundary, overflow

    monkeypatch.setattr(TpuBatchAligner, "_run_planned", planned)
    ref._run_round_v2(jobs, widths, [1] * len(jobs))
    return routes


@pytest.mark.parametrize("name,ck,h,explicit,want", CKPT_STATES, ids=[s[0] for s in CKPT_STATES])
def test_ckpt_route_decision_matches_the_reference(monkeypatch, name, ck, h, explicit, want):
    """(h) One round of four (4096, 128) jobs whose records do not fit, in
    one state of the two rates: the port plans each job on the route the
    reference plans it on (the checkpoint pair, or the host engine when the
    pair is measured slower), and logs the decision with both rates; past
    the explicit override nothing is decided."""
    pairs = _pairs(4)
    widths = [13] * len(pairs)
    ref_routes = _ref_routes(monkeypatch, _ref_ckpt(ck, h, explicit), _ref_jobs(pairs), widths)
    port = _port_ckpt(ck, h, explicit)
    planned, fallback = port._plan(_port_jobs(pairs), widths, [1] * len(pairs))
    port_routes = {"ckpt": set(), "v2": set(), "host": set(fallback)}
    for sub, _R, _B, _K, ckpt in planned:
        port_routes["ckpt" if ckpt else "v2"].update(sub)
    assert port_routes == ref_routes
    assert port_routes["ckpt" if want else "host"] == set(range(len(pairs)))
    log = BatchAligner.CKPT_LOG
    if explicit:
        assert log == []
    else:
        assert log == [{"aligner": id(port), "event": "decide", "R_cap": 4096, "B": 128, "ckpt_rate": ck,
                        "host_rate": h, "ckpt": want}]


def _dyadic_clock(monkeypatch) -> list:
    """time.time() reads a clock that moves only when a test moves it, by
    multiples of 1/8 s from 1024 s: every difference of two readings is
    exact, so both packages see the same seconds to the last bit."""
    now = [1024.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


# (i): jobs a round and its device seconds, the launches' part and the
# decode's part
CKPT_ROUNDS = [(4, 0.5, 0.25), (3, 0.125, 0.125), (2, 0.25, 0.125), (4, 1.0, 0.5), (3, 0.375, 0.25)]


def test_ckpt_rate_ema_matches_the_reference(monkeypatch):
    """(i) Five rounds wholly on the checkpoint route (the explicit
    override), one of them (2 jobs) under RATE_MIN_CELLS (3 jobs' cells at
    the launch's band): after each the port's checkpoint rate equals the
    reference's, half the last estimate and half the round's device cells
    over its launches and decode; the small round observes nothing, and
    the log holds one observation per other round. The port runs at budget
    0, where the reference observes too."""
    pairs = _pairs(4)
    cells = BatchAligner._job_cells(_port_jobs(pairs)[0], 63)  # every job's, at B 128
    rmc = 3 * cells
    monkeypatch.setattr(BatchAligner, "RATE_MIN_CELLS", rmc)
    monkeypatch.setattr(TpuBatchAligner, "RATE_MIN_CELLS", rmc)
    now = _dyadic_clock(monkeypatch)
    ref, port = _ref_ckpt(explicit=True), _port_ckpt(explicit=True)
    step = {}

    def ref_planned(self, jobs, planned, edits, boundary, overflow, fb_futs, count=True):
        assert all(ck is not None for *_, ck in planned)
        now[0] += step["launch"] + step["decode"]
        return edits, boundary, overflow

    real_planned, real_decode = BatchAligner._run_planned, BatchAligner._decode

    def port_planned(self, launches):
        out = real_planned(self, launches)
        now[0] += step["launch"]
        return out

    def port_decode(self, *a):
        real_decode(self, *a)
        now[0] += step["decode"]

    monkeypatch.setattr(TpuBatchAligner, "_run_planned", ref_planned)
    monkeypatch.setattr(BatchAligner, "_run_planned", port_planned)
    monkeypatch.setattr(BatchAligner, "_decode", port_decode)
    rates = []
    for n, launch, decode in CKPT_ROUNDS:
        step.update(launch=launch, decode=decode)
        ref._run_round_v2(_ref_jobs(pairs[:n]), [13] * n, [1] * n)
        edits, _b, _o = port._run_round(_port_jobs(pairs[:n]), [13] * n, [1] * n)
        for (r, q), e in zip(pairs, edits):
            assert np.array_equal(e.apply(r), q)
        assert port._ckpt_rate == ref._ckpt_rate
        rates.append(port._ckpt_rate)
    assert rates[0] == 4 * cells / 0.75 and rates[2] == rates[1] != rates[0]
    obs = [e for e in BatchAligner.CKPT_LOG if e["event"] == "observe"]
    assert [e["ckpt_rate"] for e in obs] == [rates[i] for i in (0, 1, 3, 4)]
    assert [e["secs"] for e in obs] == [0.75, 0.25, 1.5, 0.625]
    assert BatchAligner.engine_report()["gate"]["ckpt_rate"] == rates[-1]


def test_ckpt_rate_leaves_the_host_fallback_out(monkeypatch):
    """(i) A round wholly on the checkpoint route whose leg also sends an
    event-dense job (hint_events 1,100: K past CKPT_K_CAP) to the host
    engine: the job's Edit comes from the host, and the 4 s it takes after
    the decode stay out of the checkpoint rate, as the reference leaves its
    host-fallback jobs out (:1223-1226); the rate equals the reference's,
    whose fallback thread the test does not slow. The device rate, where
    the split routes, does wait for them (f)."""
    monkeypatch.setattr(BatchAligner, "RATE_MIN_CELLS", 1)
    monkeypatch.setattr(TpuBatchAligner, "RATE_MIN_CELLS", 1)
    now = _dyadic_clock(monkeypatch)
    pairs = _pairs(5)
    widths = [13] * 4 + [65]
    ref, port = _ref_ckpt(explicit=True), _port_ckpt(explicit=True)
    decoded = threading.Event()

    def ref_planned(self, jobs, planned, edits, boundary, overflow, fb_futs, count=True):
        assert sorted(fb_futs) == [4]
        now[0] += 0.75
        return edits, boundary, overflow

    real_planned, real_decode, real_fallback = (BatchAligner._run_planned, BatchAligner._decode,
                                                BatchAligner._host_fallback)

    def port_planned(self, launches):
        out = real_planned(self, launches)
        now[0] += 0.5
        return out

    def port_decode(self, *a):
        real_decode(self, *a)
        now[0] += 0.25
        decoded.set()

    def slow_fallback(self, job, count=True):
        assert decoded.wait(JOIN_S)
        now[0] += 4.0
        return real_fallback(self, job, count)

    monkeypatch.setattr(TpuBatchAligner, "_run_planned", ref_planned)
    monkeypatch.setattr(BatchAligner, "_run_planned", port_planned)
    monkeypatch.setattr(BatchAligner, "_decode", port_decode)
    monkeypatch.setattr(BatchAligner, "_host_fallback", slow_fallback)
    ref_jobs, port_jobs = _ref_jobs(pairs), _port_jobs(pairs)
    ref_jobs[4].hint_events = port_jobs[4].hint_events = 1100
    ref._run_round_v2(ref_jobs, widths, [1] * 5)
    edits, _b, _o = port._run_round(port_jobs, widths, [1] * 5)
    for (r, q), e in zip(pairs, edits):
        assert np.array_equal(e.apply(r), q)
    (obs,) = BatchAligner.CKPT_LOG
    assert obs["secs"] == 0.75 and port._ckpt_rate == ref._ckpt_rate == obs["cells"] / 0.75


def test_mixed_round_observes_no_ckpt_rate(monkeypatch):
    """(j) A round whose (4096, 128) jobs take the v2 route and whose
    (4096, 256) jobs take the checkpoint route (the override at 3,000,000
    bytes, between the two groups' per-problem records) observes no
    checkpoint rate in either package, whatever its size; the same jobs of
    the checkpoint group alone do."""
    monkeypatch.setattr(BatchAligner, "RATE_MIN_CELLS", 1)
    monkeypatch.setattr(TpuBatchAligner, "RATE_MIN_CELLS", 1)
    pairs = _pairs(4)
    widths = [13, 13, 65, 65]

    def ref_planned(self, jobs, planned, edits, boundary, overflow, fb_futs, count=True):
        time.sleep(0.01)
        return edits, boundary, overflow

    monkeypatch.setattr(TpuBatchAligner, "_run_planned", ref_planned)
    ref = TpuBatchAligner(RefParams())  # every group's records fit
    ref.CKPT_PATHS_BYTES = 3_000_000
    ref._SHAPES_WARM = _AllWarm()
    port = _port(0)
    port.ckpt_paths_bytes = 3_000_000
    planned, _fb = port._plan(_port_jobs(pairs), widths, [1] * 4)
    assert sorted(ckpt for *_, ckpt in planned) == [False, True]
    ref._run_round_v2(_ref_jobs(pairs), widths, [1] * 4)
    edits, _b, _o = port._run_round(_port_jobs(pairs), widths, [1] * 4)
    for (r, q), e in zip(pairs, edits):
        assert np.array_equal(e.apply(r), q)
    assert ref._ckpt_rate is None and port._ckpt_rate is None
    assert [e for e in BatchAligner.CKPT_LOG if e["event"] == "observe"] == []
    ref._run_round_v2(_ref_jobs(pairs[2:]), widths[2:], [1] * 2)
    port._run_round(_port_jobs(pairs[2:]), widths[2:], [1] * 2)
    assert ref._ckpt_rate is not None and port._ckpt_rate is not None


def test_failed_ckpt_launch_raises_and_serves_nothing_from_the_host(monkeypatch):
    """(k) A round whose group does not fit takes the checkpoint pair (no
    checkpoint rate yet) under the adaptive split ("fixed"); its launch raises, so
    align_many raises, no job reaches a host engine, and no checkpoint rate
    is observed."""
    host = []
    real_native, real_fallback = BatchAligner._run_round_native, BatchAligner._host_fallback

    def spy_native(self, h_jobs, widths):
        host.extend(h_jobs)
        return real_native(self, h_jobs, widths)

    def spy_fallback(self, job, count=True):
        host.append(job)
        return real_fallback(self, job, count)

    def failed_launch(*a, **k):
        raise RuntimeError("checkpoint launch failed")

    monkeypatch.setattr(BatchAligner, "_run_round_native", spy_native)
    monkeypatch.setattr(BatchAligner, "_host_fallback", spy_fallback)
    monkeypatch.setattr(ba, "stripe_align_ckpt", failed_launch)
    port = _port_ckpt(budget=1)
    port._dev_rate = 1e9  # and no host rate: the split's budget of 1 cell stands
    with pytest.raises(RuntimeError, match="checkpoint launch failed"):
        port.align_many(_port_jobs(_pairs(4)))
    assert host == [] and port._ckpt_rate is None
    assert [e["ckpt"] for e in BatchAligner.CKPT_LOG] == [True]


def test_ckpt_log_passes_chip_smokes_recomputation(monkeypatch):
    """(l) chip_smoke.check_ckpt_log recomputes the checkpoint rate's EMA
    from the logged observations and each logged decision from the rates
    before it with its own copy of the reference's rule. The log of a probe
    round, observations and decisions in the states of (h) passes it and
    counts its rate-decided groups; a log with an answer flipped, or a rate
    that is not the EMA's, does not."""
    monkeypatch.setattr(BatchAligner, "RATE_MIN_CELLS", 1)
    jobs = _port_jobs(_pairs(4))
    port = _port_ckpt()
    port._run_round(jobs, [13] * 4, [1] * 4)  # the probe: no rate yet
    assert port._ckpt_rate is not None
    for h in (port._ckpt_rate / 2, port._ckpt_rate * 2, None):
        port._host_rate = h
        port._plan(jobs, [13] * 4, [1] * 4)
    log = [dict(e) for e in BatchAligner.CKPT_LOG]
    got = chip_smoke.check_ckpt_log("test", log, 1)
    assert got == {"observed": 1, "decided": 4, "rate_decided": 2, "ckpt": 3, "host": 1}
    bad = [dict(e) for e in log]
    bad[-2]["ckpt"] = not bad[-2]["ckpt"]
    with pytest.raises(AssertionError, match="the rule gives"):
        chip_smoke.check_ckpt_log("test", bad, 1)
    bad = [dict(e) for e in log]
    bad[1]["ckpt_rate"] *= 1.5
    with pytest.raises(AssertionError, match="EMA"):
        chip_smoke.check_ckpt_log("test", bad, 1)
