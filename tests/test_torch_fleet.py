"""Fleet serving in the port: the health-checked failover router over N
AccelServer replicas — chaos injection, circuit breakers, retry/hedge
semantics, eject/heal/readmit lifecycle, fleet-wide precision brownout, and
the typed-shutdown / fail-fast contracts on the underlying server.

All 36 tests of ``tests/test_fleet.py`` under the port's mapping
(``repro.`` -> ``repro_torch.``).  Then parity with the JAX package: a fleet
over the port's ``qtorch`` D8 separable-cnn points on the CPU returns the
bytes a fleet over the reference's ``qjax`` points returns, before a W4
view flip and after the replicas' scrubbers repaired it.
"""

import threading
import time

import jax
import numpy as np
import pytest

from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core import adaptive as j_adaptive
from repro.core.flow import DesignFlow as JFlow
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.models import cnn as j_models
from repro.quant.qtypes import DatatypeConfig as JDT
from repro.runtime import fleet as j_fleet
from repro.runtime import integrity as j_integrity
from repro.runtime import serve as j_serve

from repro_torch.configs.separable_cnn import CONFIG as T_SEP
from repro_torch.core import adaptive as t_adaptive
from repro_torch.core.flow import DesignFlow as TFlow
from repro_torch.core.reader import separable_cnn_to_ir as t_sep_to_ir
from repro_torch.models import cnn as t_models
from repro_torch.quant.qtypes import DatatypeConfig as TDT
from repro_torch.runtime import fleet as t_fleet
from repro_torch.runtime import integrity as t_integrity
from repro_torch.runtime import serve as t_serve
from repro_torch.core.adaptive import (BrownoutSelector, ServiceObjective,
                                 WorkingPoint)
from repro_torch.runtime.fleet import (ChaosExecutable, CircuitBreaker,
                                 DeadlineExceeded, FleetRouter,
                                 NoReplicaAvailable, ReplicaCrash,
                                 RequestFailed)
from repro_torch.runtime.ft import FailureInjector
from repro_torch.runtime.serve import AccelServer, ServerStopped


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def double(x):
    return np.asarray(x) * 2.0


def vals(n, start=0):
    return [np.full((2, 3), start + i, np.float32) for i in range(n)]


def make_factory(exe=double, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait", 0.001)
    return lambda: AccelServer(exe, **kw)


def make_router(factories, **kw):
    kw.setdefault("probe", [np.ones((1, 3), np.float32)])
    kw.setdefault("probe_interval_s", 0.01)
    kw.setdefault("heal_cooldown_s", 0.05)
    kw.setdefault("default_deadline_s", 15.0)
    return FleetRouter(factories, **kw)


# ---------------------------------------------------------------------------
# chaos layer
# ---------------------------------------------------------------------------


def test_chaos_executable_passes_through_and_counts():
    chaos = ChaosExecutable(double)
    out = chaos(np.ones((2, 2)))
    np.testing.assert_array_equal(out, np.full((2, 2), 2.0))
    assert chaos.calls == 1


def test_chaos_executable_crash_fires_once():
    chaos = ChaosExecutable(double, crash_at=[1])
    chaos(np.ones((1, 1)))
    with pytest.raises(ReplicaCrash):
        chaos(np.ones((1, 1)))
    # fire-once: the healed replica's fresh pump is not re-killed
    chaos(np.ones((1, 1)))
    assert chaos.calls == 3


def test_chaos_executable_injects_failures_and_delays():
    slept = []
    inj = FailureInjector(fail_at=[0], delay_at=[1], delay_s=0.5,
                          sleep=slept.append)
    chaos = ChaosExecutable(double, inj)
    with pytest.raises(RuntimeError, match="injected"):
        chaos(np.ones((1, 1)))
    chaos(np.ones((1, 1)))
    assert slept == [0.5]


def test_chaos_executable_shares_counter_across_points():
    # one schedule spans a replica's W8/W4/W2 point executables
    counter = [0]
    w8 = ChaosExecutable(double, crash_at=[2], counter=counter)
    w4 = ChaosExecutable(double, crash_at=[2], counter=counter)
    w8(np.ones((1, 1)))
    w4(np.ones((1, 1)))
    with pytest.raises(ReplicaCrash):
        w8(np.ones((1, 1)))   # third call overall, whichever point runs it


def test_chaos_executable_delegates_telemetry():
    class Exe:
        bits = 4

        def __call__(self, x):
            return x

    chaos = ChaosExecutable(Exe())
    assert chaos.bits == 4


def test_replica_crash_escapes_exception_containment():
    # ReplicaCrash must be a BaseException so it skips the pump's per-batch
    # `except Exception` containment and kills the whole pump thread
    assert issubclass(ReplicaCrash, BaseException)
    assert not issubclass(ReplicaCrash, Exception)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


def test_breaker_opens_after_threshold_and_half_opens():
    clk = FakeClock()
    br = CircuitBreaker(threshold=3, cooldown_s=1.0, clock=clk)
    assert br.allows()
    br.record_failure()
    br.record_failure()
    assert br.allows()            # below threshold
    br.record_failure()
    assert not br.allows() and br.open and br.trips == 1
    clk.advance(1.5)
    assert br.allows()            # cooldown over: half-open trickle
    br.record_success()
    assert br.allows() and not br.open and br.failures == 0


def test_breaker_reopens_on_half_open_failure():
    clk = FakeClock()
    br = CircuitBreaker(threshold=1, cooldown_s=1.0, clock=clk)
    br.record_failure()
    assert not br.allows()
    clk.advance(1.0)
    assert br.allows()            # half-open
    br.record_failure()           # probe failed
    assert not br.allows()
    clk.advance(0.5)
    assert not br.allows()        # cooldown restarted from the re-open
    clk.advance(0.6)
    assert br.allows()


# ---------------------------------------------------------------------------
# brownout selector (fleet-wide precision ladder)
# ---------------------------------------------------------------------------

POINTS = [WorkingPoint("w8", 8), WorkingPoint("w4", 4), WorkingPoint("w2", 2)]
NAMES = [p.name for p in POINTS]


def _slo(**kw):
    kw.setdefault("p95_latency_s", 0.1)
    kw.setdefault("window", 8)
    kw.setdefault("min_samples", 4)
    kw.setdefault("hold", 4)
    return ServiceObjective(**kw)


def test_brownout_walks_down_under_p95_pressure_and_recovers():
    sel = BrownoutSelector(POINTS, _slo())
    assert sel.select().name == "w8"
    for _ in range(4):
        sel.observe(0.5)          # way over the 0.1s target
    assert sel.select().name == "w4"
    for _ in range(4):
        sel.observe(0.5)
    assert sel.select().name == "w2"   # keeps walking down
    for _ in range(8):
        sel.observe(0.5)
    assert sel.select().name == "w2"   # clamps at the floor
    for _ in range(20):
        sel.observe(0.001)        # recovery with margin
    assert sel.select().name == "w8"
    downs = [s for s in sel.shifts if NAMES.index(s[1]) > NAMES.index(s[0])]
    ups = [s for s in sel.shifts if NAMES.index(s[1]) < NAMES.index(s[0])]
    assert len(downs) == 2 and len(ups) == 2


def test_brownout_downshifts_on_queue_depth():
    sel = BrownoutSelector(POINTS, _slo(), max_queue_depth=10)
    for _ in range(4):
        sel.observe_depth(50)     # backlog breach alone, no latency samples
    assert sel.select().name == "w4"
    for _ in range(4):
        sel.observe_depth(50)     # breach persists: keep shedding precision
    assert sel.select().name == "w2"
    # fast samples while the backlog is still over: NO recovery
    for _ in range(8):
        sel.observe(0.001)
    assert sel.select().name == "w2"
    # backlog clears: fast samples walk the ladder back up
    sel.observe_depth(0)
    for _ in range(10):
        sel.observe(0.001)
    assert sel.select().name == "w8"


def test_brownout_holds_between_shifts():
    sel = BrownoutSelector(POINTS, _slo(hold=100))
    for _ in range(50):
        sel.observe(0.5)
    assert sel.select().name == "w8"   # hold not satisfied yet
    for _ in range(60):
        sel.observe(0.5)
    assert sel.select().name == "w4"


def test_brownout_telemetry_and_validation():
    sel = BrownoutSelector(POINTS, _slo(), max_queue_depth=4)
    t = sel.telemetry()
    assert t["point"] == "w8" and t["max_queue_depth"] == 4
    with pytest.raises(ValueError):
        BrownoutSelector([], _slo())
    with pytest.raises(ValueError):
        BrownoutSelector(POINTS, _slo(), max_queue_depth=0)


def test_brownout_is_thread_safe_under_concurrent_observers():
    sel = BrownoutSelector(POINTS, _slo())

    def hammer():
        for _ in range(200):
            sel.observe(0.5)
            sel.select()

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sel.select() in POINTS


# ---------------------------------------------------------------------------
# fleet router: routing, failover, lifecycle
# ---------------------------------------------------------------------------


def test_fleet_serves_and_spreads_load():
    r = make_router({"a": make_factory(), "b": make_factory(),
                     "c": make_factory()})
    with r:
        tks = [r.submit(v) for v in vals(30)]
        for i, t in enumerate(tks):
            np.testing.assert_allclose(t.result(timeout=10), 2.0 * vals(30)[i])
        s = r.stats()
    assert s["succeeded"] == 30 and s["failed"] == 0
    assert s["availability"] == 1.0
    served = [rep["served"] for rep in s["replicas"].values()]
    assert all(n > 0 for n in served)    # every replica took traffic


def test_fleet_requires_start_and_validates():
    r = make_router({"a": make_factory()})
    with pytest.raises(RuntimeError, match="not running"):
        r.submit(*vals(1))
    with pytest.raises(ValueError):
        FleetRouter({})
    with pytest.raises(ValueError):
        FleetRouter({"a": make_factory()}, retries=-1)


def test_fleet_retries_batch_failure_on_another_replica():
    # replica b fails its first executable call; the ticket must be retried
    # on a sibling and still resolve successfully
    bad = ChaosExecutable(double, FailureInjector(fail_at=[0]))
    r = make_router({"a": make_factory(), "b": make_factory(bad)},
                    retries=2, backoff_s=0.001)
    with r:
        tks = [r.submit(v) for v in vals(12)]
        outs = [t.result(timeout=10) for t in tks]
        s = r.stats()
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, 2.0 * vals(12)[i])
    assert s["failed"] == 0 and s["retries"] >= 1


def test_fleet_pump_crash_ejects_heals_and_readmits():
    chaos = ChaosExecutable(double, crash_at=[2])
    r = make_router({"a": make_factory(), "b": make_factory(chaos),
                     "c": make_factory()},
                    retries=2, backoff_s=0.001, heal_cooldown_s=0.02)
    with r:
        tks = [r.submit(v) for v in vals(40)]
        for i, t in enumerate(tks):
            np.testing.assert_allclose(t.result(timeout=10), 2.0 * vals(40)[i])
        # replica b's pump died mid-burst, yet zero tickets were lost
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            rb = r.stats()["replicas"]["b"]
            if rb["readmissions"] >= 1 and rb["state"] == "healthy":
                break
            time.sleep(0.01)
        s = r.stats()
    rb = s["replicas"]["b"]
    assert rb["ejections"] >= 1, s
    assert rb["readmissions"] >= 1 and rb["state"] == "healthy", s
    assert rb["generation"] >= 2          # healed via a fresh server build
    assert s["availability"] == 1.0


def test_fleet_terminal_failure_is_typed_and_chains_cause():
    def always_fail(x):
        raise ValueError("device poisoned")

    r = make_router({"a": make_factory(always_fail),
                     "b": make_factory(always_fail)},
                    retries=1, backoff_s=0.001, probe=None)
    with r:
        t = r.submit(*vals(1))
        with pytest.raises(RequestFailed) as ei:
            t.result(timeout=10)
        assert "device poisoned" in str(ei.value.__cause__)
        # a terminal ticket re-raises the same typed error on re-claim
        with pytest.raises(RequestFailed):
            t.result(timeout=10)
        s = r.stats()
    assert s["failed"] == 1 and s["availability"] < 1.0


def test_fleet_sheds_when_no_replica_routable():
    chaos = ChaosExecutable(double, crash_at=[0])
    r = make_router({"a": make_factory(chaos)}, probe=None,
                    heal_cooldown_s=30.0)
    with r:
        t = r.submit(*vals(1))
        with pytest.raises(RequestFailed):
            t.result(timeout=10)   # crash + nowhere to retry
        # the lone replica is now ejected: new submits are shed, typed
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if r.stats()["replicas"]["a"]["state"] == "ejected":
                break
            time.sleep(0.005)
        with pytest.raises(NoReplicaAvailable):
            r.submit(*vals(1))
        assert r.stats()["shed"] == 1


def test_fleet_sheds_when_every_queue_is_full():
    # all routable replicas rejecting with QueueFull must raise a typed
    # NoReplicaAvailable (shed), not busy-spin re-routing forever
    gate = threading.Event()

    def wedged(x):
        gate.wait(10.0)
        return np.asarray(x) * 2.0

    r = make_router({"a": make_factory(wedged, queue_depth=1),
                     "b": make_factory(wedged, queue_depth=1)},
                    probe=None)
    out = {}

    def fill():
        try:
            for v in vals(10):     # > pump slots + queue slots of the fleet
                r.submit(v)
            out["err"] = None
        except NoReplicaAvailable as e:
            out["err"] = e

    try:
        with r:
            th = threading.Thread(target=fill, daemon=True)
            th.start()
            th.join(5.0)
            assert not th.is_alive(), \
                "submit busy-spun on full queues instead of shedding"
            assert isinstance(out["err"], NoReplicaAvailable)
            assert r.stats()["shed"] == 1
    finally:
        gate.set()


def test_stale_attempt_never_touches_a_healed_servers_tickets():
    # an attempt outstanding across a heal must settle against the server
    # GENERATION it was submitted to: the rebuilt server restarts its rid
    # counter, so settling against rep.server would claim/drop an unrelated
    # request's result on the new generation
    gate = threading.Event()
    calls = {"n": 0}
    lock = threading.Lock()

    def slow_first(x):
        with lock:
            calls["n"] += 1
            first = calls["n"] == 1
        if first:
            gate.wait(10.0)       # only generation 1's first batch wedges
        return np.asarray(x) * 2.0

    r = make_router({"a": make_factory(slow_first)}, probe=None, retries=0)
    try:
        with r:
            rep = r.replicas["a"]
            old_srv = rep.server
            v0, v1 = vals(2)
            t1 = r.submit(v0)     # rid 0 on generation 1, wedged in-flight
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and calls["n"] < 1:
                time.sleep(0.005)
            with r._lock:
                r._build_server(rep)          # heal: fresh pump, rids reset
            assert rep.server is not old_srv
            t2 = r.submit(v1)     # rid 0 again — on generation 2
            gate.set()
            # each ticket must claim from ITS OWN generation's server
            np.testing.assert_allclose(t1.result(timeout=10), 2.0 * v0)
            np.testing.assert_allclose(t2.result(timeout=10), 2.0 * v1)
            old_srv.stop(drain=False, timeout=2.0)
    finally:
        gate.set()


def test_fleet_drop_releases_only_its_own_generation():
    # drop() of a pre-heal ticket must not discard the rid-colliding request
    # on the healed server
    gate, started = threading.Event(), threading.Event()
    calls = {"n": 0}
    lock = threading.Lock()

    def slow_first(x):
        with lock:
            calls["n"] += 1
            first = calls["n"] == 1
        if first:
            started.set()
            gate.wait(10.0)
        return np.asarray(x) * 2.0

    r = make_router({"a": make_factory(slow_first)}, probe=None, retries=0)
    try:
        with r:
            rep = r.replicas["a"]
            old_srv = rep.server
            v0, v1 = vals(2)
            t1 = r.submit(v0)     # rid 0 on generation 1
            # t1 holds the gated first call before generation 2 exists, so
            # t2 cannot take it on a loaded machine
            assert started.wait(10.0)
            with r._lock:
                r._build_server(rep)
            t2 = r.submit(v1)     # rid 0 on generation 2
            r.drop(t1)            # must hit generation 1, not t2's ticket
            np.testing.assert_allclose(t2.result(timeout=10), 2.0 * v1)
            with pytest.raises(RequestFailed, match="dropped"):
                t1.result(timeout=10)
            gate.set()
            old_srv.stop(drain=False, timeout=2.0)
    finally:
        gate.set()


def test_probe_failure_drops_canary_ticket():
    # a timed-out probe must release its canary so repeated probes of a
    # persistently suspect replica never accumulate unclaimed results
    gate = threading.Event()

    def wedged(x):
        gate.wait(10.0)
        return np.asarray(x) * 2.0

    r = make_router({"a": make_factory(wedged)}, probe_timeout_s=0.02,
                    probe_interval_s=30.0)   # sentinel effectively quiet
    try:
        with r:
            rep = r.replicas["a"]
            srv = rep.server
            for _ in range(3):
                assert r._probe(rep) == "probe"   # canary times out
            gate.set()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline \
                    and (srv.queue_depth() or srv._results):
                time.sleep(0.01)
            assert srv._results == {}   # canary outputs never stay resident
    finally:
        gate.set()


def test_fleet_result_single_consumption_under_concurrency():
    # concurrent result() calls on one fleet ticket: exactly one claims,
    # the rest get the documented KeyError (no race on the attempt list)
    gate = threading.Event()

    def slow(x):
        gate.wait(10.0)
        return np.asarray(x) * 2.0

    r = make_router({"a": make_factory(slow)}, probe=None)
    try:
        with r:
            t = r.submit(*vals(1))
            oks, errs = [], []

            def claim():
                try:
                    oks.append(t.result(timeout=10))
                except KeyError:
                    errs.append("key")

            ths = [threading.Thread(target=claim) for _ in range(4)]
            for th in ths:
                th.start()
            time.sleep(0.05)      # let every thread reach the claim gate
            gate.set()
            for th in ths:
                th.join(10.0)
            assert len(oks) == 1 and len(errs) == 3
            np.testing.assert_allclose(oks[0], 2.0 * vals(1)[0])
    finally:
        gate.set()


def test_fleet_deadline_budget_is_typed():
    gate = threading.Event()

    def wedged(x):
        gate.wait(5.0)
        return x

    r = make_router({"a": make_factory(wedged)}, probe=None,
                    hedge_after_s=None)
    try:
        with r:
            t = r.submit(*vals(1), deadline_s=0.15)
            with pytest.raises(DeadlineExceeded):
                t.result(timeout=10)
            assert r.stats()["deadlines_exceeded"] == 1
    finally:
        gate.set()


def test_fleet_caller_timeout_leaves_ticket_claimable():
    gate = threading.Event()

    def slow(x):
        gate.wait(0.3)
        return np.asarray(x) * 2.0

    r = make_router({"a": make_factory(slow)}, probe=None)
    with r:
        t = r.submit(*vals(1))
        with pytest.raises(TimeoutError):
            t.result(timeout=0.05)
        gate.set()
        np.testing.assert_allclose(t.result(timeout=10), 2.0 * vals(1)[0])


def test_fleet_hedges_stragglers_first_result_wins():
    gate = threading.Event()
    calls = {"n": 0}
    lock = threading.Lock()

    def sometimes_slow(x):
        with lock:
            calls["n"] += 1
            slow = calls["n"] == 1
        if slow:
            gate.wait(5.0)        # first batch straggles
        return np.asarray(x) * 2.0

    r = make_router({"a": make_factory(sometimes_slow),
                     "b": make_factory()},
                    hedge_after_s=0.05, probe=None)
    try:
        with r:
            t = r.submit(*vals(1))
            np.testing.assert_allclose(t.result(timeout=10), 2.0 * vals(1)[0])
            s = r.stats()
        assert s["hedges"] >= 1 and s["hedge_wins"] >= 1
        assert s["succeeded"] == 1       # one request, despite two attempts
    finally:
        gate.set()


def test_fleet_brownout_wired_into_every_replica():
    sel = BrownoutSelector(POINTS, _slo())
    seen = []
    lock = threading.Lock()

    class PointExe:
        def __init__(self, tag):
            self.tag = tag

        def __call__(self, x):
            with lock:
                seen.append(self.tag)
            return np.asarray(x) * 2.0

    def factory():
        return AccelServer(PointExe("w8"), max_batch=8, max_wait=0.001,
                           point_executables={p.name: PointExe(p.name)
                                              for p in POINTS})

    r = make_router({"a": factory, "b": factory}, brownout=sel, probe=None)
    with r:
        for v in vals(6):
            r.submit(v).result(timeout=10)
        # force the shared selector down: BOTH replicas must follow the rung
        for _ in range(12):
            sel.observe(10.0)
        rung = sel.select().name
        assert rung != "w8"
        seen.clear()
        # fewer requests than the SLO hold: the rung cannot move mid-check
        for v in vals(3):
            r.submit(v).result(timeout=10)
    assert set(seen) == {rung}
    assert r.stats()["brownout"]["point"] == rung


def test_fleet_sentinel_feeds_queue_depth_to_brownout():
    """The sentinel really feeds the depth: a tick that began after the
    result resolved (the second feed after it; ticks run one after another
    on one thread, so the first may have read the depth before) reports
    the drained fleet's depth, 0."""
    sel = BrownoutSelector(POINTS, _slo(hold=1), max_queue_depth=1000)
    feeds = []
    observe = sel.observe_depth

    def recording(depth):
        feeds.append((time.monotonic(), depth))
        observe(depth)

    sel.observe_depth = recording
    r = make_router({"a": make_factory()}, brownout=sel, probe=None,
                    probe_interval_s=0.005)
    with r:
        r.submit(*vals(1)).result(timeout=10)
        done = time.monotonic()
        deadline = done + 5.0
        while time.monotonic() < deadline:
            if sum(t > done for t, _ in list(feeds)) >= 2:
                break
            time.sleep(0.005)
    after = [d for t, d in list(feeds) if t > done]
    assert len(after) >= 2, feeds                # the sentinel fed the depth
    assert after[1] == 0                         # drained fleet
    assert sel.telemetry()["queue_depth"] == 0


def test_fleet_drop_releases_all_attempts():
    r = make_router({"a": make_factory()}, probe=None)
    with r:
        t = r.submit(*vals(1))
        r.drop(t)
        with pytest.raises(RequestFailed, match="dropped"):
            t.result(timeout=10)


def test_fleet_stop_is_idempotent_and_restart_guarded():
    r = make_router({"a": make_factory()})
    r.start()
    with pytest.raises(RuntimeError, match="already running"):
        r.start()
    r.stop()
    r.stop()   # safe no-op
    with pytest.raises(RuntimeError, match="not running"):
        r.submit(*vals(1))


def test_fleet_call_shorthand():
    r = make_router({"a": make_factory()}, probe=None)
    with r:
        out = r(*vals(1))
    np.testing.assert_allclose(out, 2.0 * vals(1)[0])


# ---------------------------------------------------------------------------
# AccelServer shutdown / fail-fast contracts (satellites)
# ---------------------------------------------------------------------------


def _wedged_server():
    gate = threading.Event()

    def wedge(x):
        gate.wait(30.0)
        return x

    return AccelServer(wedge, max_batch=4, max_wait=0.001), gate


def test_stop_timeout_resolves_all_tickets_with_typed_error():
    srv, gate = _wedged_server()
    try:
        srv.start()
        tks = [srv.submit(v) for v in vals(6)]
        with pytest.raises(RuntimeError, match="did not exit"):
            srv.stop(drain=True, timeout=0.05)
        # EVERY ticket — in-flight and still-queued — resolved, typed
        for t in tks:
            assert t.done()
            with pytest.raises(ServerStopped):
                t.result(timeout=1.0)
        assert not srv.alive and isinstance(srv.fatal, ServerStopped)
        srv.stop(drain=True, timeout=0.05)    # repeated stop: safe no-op
        with pytest.raises(RuntimeError, match="no new requests"):
            srv.submit(*vals(1))
    finally:
        gate.set()


def test_stop_never_started_is_noop():
    srv = AccelServer(double, max_batch=4)
    srv.stop()
    srv.stop(drain=False)


def test_dead_pump_fails_fast_instead_of_hanging(monkeypatch):
    # a pump thread that exits without resolving tickets (crashed start)
    # must not block a timeout=None waiter forever
    srv = AccelServer(double, max_batch=4, max_wait=60.0)
    monkeypatch.setattr(AccelServer, "_pump_loop", lambda self: None)
    srv.start()
    srv._thread.join(5.0)
    tk = srv.submit(*vals(1))
    with pytest.raises(RuntimeError, match="pump thread is not running"):
        tk.result()       # timeout=None: would previously hang forever
    srv._thread = None    # detach the dead thread: sync path still works
    np.testing.assert_allclose(tk.result(), vals(1)[0] * 2.0)


def test_unresolvable_claim_names_unstarted_pump():
    srv = AccelServer(double, max_batch=4, max_wait=60.0)
    tk = srv.submit(*vals(1))
    # empty the queue behind the ticket's back: the sync on-demand pump can
    # no longer produce it, and nobody is running the background pump
    srv._default.scheduler.abandon()
    with pytest.raises(RuntimeError, match="never start"):
        tk.result()


# ---------------------------------------------------------------------------
# parity with the JAX package: fleets over the D8 separable-cnn points
# ---------------------------------------------------------------------------

BUDGETS = (1.0, 0.5, 0.1)          # -> w8, w4, w2 under the policy below


def _separable_points():
    """Each package's W8/W4/W2 point executables over its one packed buffer,
    from the same numpy parameters and the reference's activation ranges
    (the reference on its plain path, no Pallas, with the sub-byte packed
    W4/W2 views the port serves from)."""
    p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(0))
    p = {k: np.asarray(v) for k, v in p.items()}
    calib = np.random.default_rng(0).random((4, 28, 28, 1), np.float32)
    jres = JFlow(j_sep_to_ir(J_SEP, p)).run(
        ("qjax",), JDT(8, 8), calib_inputs=(calib,),
        writer_kwargs={"qjax": {"use_kernel": False,
                                "packed_weights": True}})
    tres = TFlow(t_sep_to_ir(T_SEP, t_models.params_from_jax(p, "cpu")),
                 device="cpu").run(("qtorch",), TDT(8, 8),
                                   act_ranges=jres.act_ranges)
    jpoints = [j_adaptive.WorkingPoint(q.name, q.weight_bits) for q in POINTS]
    jpts = j_adaptive.shared_point_executables(jres.writers["qjax"], jpoints)
    tpts = t_adaptive.shared_point_executables(tres.writers["qtorch"],
                                               POINTS)
    return (tpts, jpts), (POINTS, jpoints)


def _fleet(pkg, pts, points, scrubbers):
    fleet_mod, serve_mod, integ, adaptive = pkg

    def factory():
        srv = serve_mod.AccelServer(
            pts["w8"], max_batch=8, max_wait=0.002,
            point_executables=dict(pts),
            policy=adaptive.RuntimePolicy(list(points),
                                          thresholds=[0.66, 0.33]))
        sc = integ.Scrubber(pts["w8"].packed, rate_bytes_s=50e6,
                            interval_s=0.002)
        srv.attach_scrubber(sc)
        sc.start()
        scrubbers.append(sc)
        return srv

    return fleet_mod.FleetRouter({n: factory for n in ("a", "b")},
                                 probe=None, default_deadline_s=60.0)


def _serve(router, reqs):
    """Every request at every budget, one budget at a time: a batch takes
    its members' least budget, so budgets must not share a batch."""
    out = []
    for b in BUDGETS:
        tks = [router.submit(x, budget=b) for x in reqs]
        out += [(b, np.asarray(tk.result(timeout=60))) for tk in tks]
    return out


def _wait_clean(packed, seconds=20.0):
    deadline = time.monotonic() + seconds
    while packed.verify() and time.monotonic() < deadline:
        time.sleep(0.005)
    return packed.verify() == []


def test_fleet_outputs_equal_the_reference_fleet_before_and_after_a_repair():
    (tpts, jpts), (tpoints, jpoints) = _separable_points()
    rng = np.random.default_rng(1)
    reqs = [rng.random((k, 28, 28, 1), np.float32) for k in (1, 3, 8, 2)]
    tpack, jpack = tpts["w8"].packed, jpts["w8"].packed
    for pack in (tpack, jpack):
        # derive every W4/W2 view region up front, at the alignment each
        # writer streams (depthwise taps at 8, else 128): the reference
        # cannot seal a view first touched inside its trace
        for name, t in pack.tensors.items():
            for bits in (4, 2):
                t.packed_view(bits, 8 if name.startswith("dw") else 128)
    assert [r.label() for r in tpack.regions()] == \
        [r.label() for r in jpack.regions()]
    scrubbers = []
    trouter = _fleet((t_fleet, t_serve, t_integrity, t_adaptive), tpts,
                     tpoints, scrubbers)
    jrouter = _fleet((j_fleet, j_serve, j_integrity, j_adaptive), jpts,
                     jpoints, scrubbers)
    try:
        with trouter, jrouter:
            before = _serve(trouter, reqs)
            want = _serve(jrouter, reqs)
            for (b, got), (_, ref) in zip(before, want):
                assert got.tobytes() == ref.tobytes(), f"budget {b}"
            # one W4 view bit, the same in both packages; each fleet's
            # scrubbers repair it in place from the master codes
            v4 = next(r for r in tpack.regions()
                      if r.kind == "view" and r.bits == 4)
            t_rec = t_integrity.BitFlipInjector(tpack, seed=3).flip(
                region=v4)
            j_rec = j_integrity.BitFlipInjector(jpack, seed=3).flip(
                region=next(r for r in jpack.regions()
                            if r.label() == v4.label()))
            assert (t_rec.byte, t_rec.bit) == (j_rec.byte, j_rec.bit)
            assert _wait_clean(tpack) and _wait_clean(jpack)
            after = _serve(trouter, reqs)
            again = _serve(jrouter, reqs)
            for (b, got), (_, ref), (_, old) in zip(after, again, before):
                assert got.tobytes() == ref.tobytes() == old.tobytes(), \
                    f"budget {b}"
            tstats = trouter.stats()
        assert tstats["failed"] == 0
        assert tstats["integrity"]["repaired_views"] >= 1
        assert tstats["integrity"]["quarantines"] == 0
    finally:
        for sc in scrubbers:
            sc.stop()


# ---------------------------------------------------------------------------
# the card's fleet phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_fleet_phase_rehearses_on_the_cpu():
    """``chip_smoke.fleet_path`` end to end on the CPU plain path: it raises
    on any inexact result, lost ticket, missed eject or missed repair."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs.separable_cnn import SeparableCNNConfig
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    info = chip_smoke.fleet_path("separable-cnn", SeparableCNNConfig(),
                                 device="cpu", n_requests=24, rate_rounds=1)
    mf = info["master_flip"]
    assert mf["corrupted_after_detection"] == 0
    assert set(mf["eject_to_readmit_ms"]) == {"a", "b", "c"}
    assert info["crash"]["eject_cause"] == "dead-pump"
    assert {"4", "2"} <= {str(b) for b in info["brownout"]["bits_views"]}
