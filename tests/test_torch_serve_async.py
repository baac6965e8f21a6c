"""Async multi-tenant AccelServer: background pump with future-style
tickets, weighted round-robin QoS between tenants, per-tenant admission
control, pump-death ticket resolution, and the two closed loops (measured
per-bucket latency -> BucketPolicy, measured request p95 -> precision
ladder under an SLO).

Every test of ``tests/test_serve_async.py`` under the port's mapping
(``repro.`` -> ``repro_torch.``), the computed-Pareto-front loop included.
"""

import threading

import numpy as np
import pytest

from repro_torch.core.adaptive import (RuntimePolicy, ServiceObjective,
                                 SLOController, WorkingPoint)
from repro_torch.runtime.scheduler import BucketPolicy, LatencyEWMA, QueueFull
from repro_torch.runtime.serve import AccelServer


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Recorder:
    """Executable that tags rows and records call order (thread-safe)."""

    def __init__(self, tag=0.0, fail=False):
        self.tag = tag
        self.fail = fail
        self.calls = []
        self._lock = threading.Lock()

    def __call__(self, x):
        if self.fail:
            raise RuntimeError("injected executable failure")
        with self._lock:
            self.calls.append(np.asarray(x).copy())
        return np.asarray(x) + self.tag


def vals(n, start=0):
    """n distinct single-row requests with a recognizable payload."""
    return [np.full((1, 3), start + i, np.float32) for i in range(n)]


# ---------------------------------------------------------------------------
# background pump: tickets, lifecycle, drain
# ---------------------------------------------------------------------------


def test_async_pump_resolves_tickets():
    srv = AccelServer(Recorder(tag=100.0), max_batch=4, max_wait=0.001)
    with srv:
        tks = [srv.submit(v) for v in vals(16)]
        outs = [t.result(timeout=10) for t in tks]
    for i, o in enumerate(outs):
        assert o.shape == (1, 3) and float(o[0, 0]) == 100.0 + i


def test_stop_drains_queue():
    srv = AccelServer(Recorder(), max_batch=4, max_wait=60.0).start()
    tks = [srv.submit(v) for v in vals(6)]
    # max_wait is huge and the batch is partial: nothing is due yet, but
    # stop(drain=True) must flush and serve everything before exiting
    srv.stop(drain=True)
    for i, t in enumerate(tks):
        assert t.done()
        assert float(srv.result(t)[0, 0]) == i


def test_stop_without_drain_errors_queued_tickets():
    srv = AccelServer(Recorder(), max_batch=4, max_wait=60.0).start()
    tks = [srv.submit(v) for v in vals(3)]
    srv.stop(drain=False)
    for t in tks:
        assert t.done()
        with pytest.raises(RuntimeError, match="stopped before serving"):
            t.result()


def test_result_timeout_leaves_ticket_claimable():
    srv = AccelServer(Recorder(), max_batch=4, max_wait=60.0).start()
    try:
        tk = srv.submit(*vals(1))
        with pytest.raises(TimeoutError):
            tk.result(timeout=0.01)
    finally:
        srv.stop(drain=True)
    assert float(tk.result()[0, 0]) == 0.0


def test_sync_pump_refused_while_thread_runs():
    srv = AccelServer(Recorder(), max_batch=4).start()
    try:
        with pytest.raises(RuntimeError, match="background pump"):
            srv.pump()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# concurrency: N producer threads, interleaved tenants, exact demux
# ---------------------------------------------------------------------------


def test_threaded_submit_exact_demux_across_tenants():
    srv = AccelServer(max_batch=4, max_wait=0.001)
    tenants = ["a", "b", "c"]
    for k, name in enumerate(tenants):
        srv.add_tenant(name, Recorder(tag=1000.0 * (k + 1)),
                       max_batch=4, max_wait=0.001)
    per_thread = 40
    results = {}
    errors = []

    def producer(k, name):
        try:
            for i in range(per_thread):
                payload = 10_000 * k + i
                tk = srv.submit(np.full((1, 3), payload, np.float32),
                                tenant=name)
                results[(k, i)] = (payload, tk.result(timeout=30))
        except Exception as e:   # pragma: no cover - surfaced via errors
            errors.append(e)

    with srv:
        threads = [threading.Thread(target=producer, args=(k, name))
                   for k, name in enumerate(tenants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors
    assert len(results) == per_thread * len(tenants)
    for (k, i), (payload, out) in results.items():
        # each ticket got exactly its own row back, transformed by its own
        # tenant's executable (tag identifies the tenant)
        assert float(out[0, 0]) == payload + 1000.0 * (k + 1)


def test_threaded_submit_fifo_order_per_tenant():
    recs = {"a": Recorder(), "b": Recorder()}
    srv = AccelServer(max_batch=4, max_wait=0.001)
    for name, rec in recs.items():
        srv.add_tenant(name, rec, max_batch=4, max_wait=0.001)

    def producer(name):
        for i in range(1, 31):          # nonzero payloads: zero rows = padding
            srv.submit(np.full((1, 3), i, np.float32), tenant=name)

    with srv:
        threads = [threading.Thread(target=producer, args=(n,)) for n in recs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    # schedulers pack arrival-order prefixes and the pump pops batches in
    # order, so each tenant's executed rows (padding stripped) must be its
    # submission order exactly
    for name, rec in recs.items():
        real = [int(r[0]) for call in rec.calls for r in call if r[0] != 0]
        assert real == list(range(1, 31)), name


# ---------------------------------------------------------------------------
# QoS: weighted round-robin + per-tenant admission control
# ---------------------------------------------------------------------------


def test_wrr_ratio_between_backlogged_tenants():
    order = []

    def make_exe(name):
        def exe(x):
            order.append(name)
            return x
        return exe

    srv = AccelServer(max_batch=2, max_wait=0.0)
    srv.add_tenant("gold", make_exe("gold"), max_batch=2, max_wait=0.0,
                   weight=2)
    srv.add_tenant("bronze", make_exe("bronze"), max_batch=2, max_wait=0.0,
                   weight=1)
    # backlog both queues with full batches, then drive synchronously: the
    # pump must interleave gold:bronze = 2:1 while both are backlogged
    for i in range(12):
        srv.submit(np.full((2, 3), i, np.float32), tenant="gold")
    for i in range(6):
        srv.submit(np.full((2, 3), i, np.float32), tenant="bronze")
    srv.pump(flush=True)
    assert order[:9] == ["gold", "gold", "bronze"] * 3
    assert order.count("gold") == 12 and order.count("bronze") == 6


def test_wrr_is_work_conserving_when_one_tenant_idle():
    order = []
    srv = AccelServer(max_batch=2, max_wait=0.0)
    srv.add_tenant("gold", lambda x: (order.append("gold"), x)[1],
                   max_batch=2, max_wait=0.0, weight=3)
    srv.add_tenant("bronze", lambda x: (order.append("bronze"), x)[1],
                   max_batch=2, max_wait=0.0, weight=1)
    for i in range(4):
        srv.submit(np.full((2, 3), i, np.float32), tenant="bronze")
    srv.pump(flush=True)
    # gold idle: bronze gets the whole device, no slots wasted on gold
    assert order == ["bronze"] * 4


def test_admission_control_is_per_tenant():
    srv = AccelServer(max_batch=4, max_wait=60.0)
    srv.add_tenant("small", Recorder(), max_batch=4, max_wait=60.0,
                   queue_depth=2)
    srv.add_tenant("big", Recorder(), max_batch=4, max_wait=60.0,
                   queue_depth=64)
    srv.submit(*vals(1), tenant="small")
    srv.submit(*vals(1), tenant="small")
    with pytest.raises(QueueFull):
        srv.submit(*vals(1), tenant="small")
    # the other tenant's queue is unaffected by small's backpressure
    for _ in range(10):
        srv.submit(*vals(1), tenant="big")


def test_duplicate_tenant_rejected():
    srv = AccelServer(Recorder())
    with pytest.raises(ValueError, match="already registered"):
        srv.add_tenant("default", Recorder())


# ---------------------------------------------------------------------------
# fault handling: failing batches and pump death
# ---------------------------------------------------------------------------


def test_failing_executable_resolves_tickets_with_errors_async():
    srv = AccelServer(Recorder(fail=True), max_batch=4, max_wait=0.001)
    with srv:
        tks = [srv.submit(v) for v in vals(8)]
        for t in tks:
            with pytest.raises(RuntimeError, match="batch execution failed"):
                t.result(timeout=10)
    # per-batch containment: the failures were recorded, the pump survived
    assert len(srv.pump_errors) >= 1
    assert srv._fatal is None


def test_failing_tenant_does_not_poison_healthy_tenant():
    srv = AccelServer(max_batch=4, max_wait=0.001)
    srv.add_tenant("bad", Recorder(fail=True), max_batch=4, max_wait=0.001)
    srv.add_tenant("good", Recorder(tag=7.0), max_batch=4, max_wait=0.001)
    with srv:
        bad = [srv.submit(v, tenant="bad") for v in vals(4)]
        good = [srv.submit(v, tenant="good") for v in vals(4)]
        for t in bad:
            with pytest.raises(RuntimeError):
                t.result(timeout=10)
        for i, t in enumerate(good):
            assert float(t.result(timeout=10)[0, 0]) == 7.0 + i


def test_pump_death_resolves_all_outstanding_and_queued_tickets(monkeypatch):
    srv = AccelServer(Recorder(), max_batch=4, max_wait=60.0)

    def boom(flush):
        raise MemoryError("injected pump catastrophe")

    monkeypatch.setattr(srv, "_pump_async", boom)
    tks = [srv.submit(v) for v in vals(6)]
    srv.start()
    # every ticket must resolve with the error — no caller blocks forever
    for t in tks:
        assert t._event.wait(timeout=10)
        with pytest.raises(RuntimeError, match="batch execution failed"):
            t.result(timeout=10)
    with pytest.raises(RuntimeError, match="pump died"):
        srv.submit(*vals(1))
    with pytest.raises(RuntimeError, match="pump died"):
        srv.start()


def test_sync_failed_batch_still_raises_and_resolves():
    srv = AccelServer(Recorder(fail=True), max_batch=4, max_wait=0.0)
    tk = srv.submit(*vals(1))
    with pytest.raises(RuntimeError, match="injected executable failure"):
        srv.pump(flush=True)
    with pytest.raises(RuntimeError, match="batch execution failed"):
        srv.result(tk)


class FailNthCall:
    """Executable that fails on exactly the given 0-based call indices."""

    def __init__(self, fail_calls, tag=0.0):
        self.fail_calls = set(fail_calls)
        self.n = 0
        self._lock = threading.Lock()

    def __call__(self, x):
        with self._lock:
            i = self.n
            self.n += 1
        if i in self.fail_calls:
            raise RuntimeError(f"injected failure on call {i}")
        return np.asarray(x) * 2.0


def test_split_chunk_failure_resolves_parent_and_releases_siblings_async():
    # an oversize submit splits into 3 chunks; the MIDDLE chunk's batch
    # fails mid-flight.  The ONE parent ticket must resolve with the
    # failure and every sibling chunk must be released — no resident
    # outputs, no dangling split state, no hung waiter.
    srv = AccelServer(FailNthCall([1]), max_batch=4, max_wait=0.001)
    with srv:
        big = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
        tk = srv.submit(big)
        with pytest.raises(RuntimeError, match="injected failure"):
            tk.result(timeout=10)
        # the failure was contained to the batch: pump alive, server usable
        assert srv.alive and srv._fatal is None
        out = srv.submit(*vals(1)).result(timeout=10)
        assert float(out[0, 0]) == 0.0
    assert not srv._results and not srv._split and not srv._dropped
    assert not srv._default.parent_left and not srv._default.child_parent


def test_split_chunk_failure_releases_siblings_sync():
    srv = AccelServer(FailNthCall([0]), max_batch=4, max_wait=0.0)
    big = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    tk = srv.submit(big)
    with pytest.raises(RuntimeError, match="injected failure"):
        srv.pump(flush=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        srv.result(tk)
    # the sibling chunks were still queued when the claim raised; once the
    # pump flushes them their (dropped) outputs are discarded at demux and
    # every piece of split bookkeeping unwinds
    srv.pump(flush=True)
    assert not srv._results and not srv._split and not srv._dropped
    assert not srv._default.parent_left and not srv._default.child_parent


def test_split_failure_does_not_poison_other_requests():
    # a failing split must not take down traffic in OTHER batches: only the
    # batch containing the failing call is lost
    exe = FailNthCall([0])
    srv = AccelServer(exe, max_batch=4, max_wait=0.0)
    big = np.arange(9 * 3, dtype=np.float32).reshape(9, 3)
    a = np.full((2, 3), 500.0, np.float32)
    tbig = srv.submit(big)       # chunks dispatch first: call 0 fails
    ta = srv.submit(a)
    with pytest.raises(RuntimeError, match="injected failure"):
        srv.pump(flush=True)
    srv.pump(flush=True)         # remaining batches (incl. a's) execute
    np.testing.assert_allclose(srv.result(ta), a * 2.0)
    with pytest.raises(RuntimeError, match="injected failure"):
        srv.result(tbig)
    assert not srv._results and not srv._split and not srv._dropped


# ---------------------------------------------------------------------------
# closed loop 1: measured per-bucket latency drives bucket selection
# ---------------------------------------------------------------------------


def test_bucket_policy_prefers_measured_faster_bucket():
    lat = LatencyEWMA()
    pol = BucketPolicy(max_batch=8, latency=lat)
    assert pol.bucket_for(3) == 4            # cold start: static ladder
    lat.observe(4, 0.010)
    lat.observe(8, 0.002)                    # bigger bucket measured faster
    assert pol.bucket_for(3) == 8            # measurements overrule padding
    lat.observe(8, 0.050)                    # bucket 8 regresses (EWMA rises)
    assert pol.bucket_for(3) == 4


def test_bucket_policy_explores_unmeasured_fallback_first():
    lat = LatencyEWMA()
    pol = BucketPolicy(max_batch=8, latency=lat)
    lat.observe(8, 0.001)
    # the heuristic picks 2 for size 2; 2 is unmeasured, so the policy must
    # route through it (exploration) rather than jumping to measured 8
    assert pol.bucket_for(2) == 2


def test_server_feeds_bucket_latency_from_reports():
    clock = FakeClock()

    def exe(x):
        clock.advance(0.25)
        return x

    srv = AccelServer(exe, max_batch=4, max_wait=0.0, clock=clock)
    srv.submit(np.ones((4, 3), np.float32))
    srv.pump(flush=True)
    assert srv.reports[-1].exec_s == pytest.approx(0.25)
    est = srv.stats()["bucket_latency_s"]
    assert est[4] == pytest.approx(0.25)
    # the scheduler's policy reads the same EWMA instance the server feeds
    assert srv.scheduler.policy.latency.estimate(4) == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# closed loop 2: p95 SLO walks the precision ladder (deterministic clock)
# ---------------------------------------------------------------------------

POINTS = [WorkingPoint("w8", 8), WorkingPoint("w4", 4), WorkingPoint("w2", 2)]


class BitsExe:
    """Fake point executable: advances the fake clock by a per-bits cost
    that a shared `pressure` switch scales (injected latency pressure)."""

    def __init__(self, bits, clock, pressure):
        self.bits = bits
        self.clock = clock
        self.pressure = pressure

    def __call__(self, x):
        base = {8: 2.0, 4: 1.5, 2: 0.8}[self.bits]
        self.clock.advance(base if self.pressure["on"] else 0.1)
        return x


def test_slo_loop_downshifts_bits_then_recovers():
    clock = FakeClock()
    pressure = {"on": True}
    exes = {p.name: BitsExe(p.weight_bits, clock, pressure) for p in POINTS}
    slo = ServiceObjective(p95_latency_s=1.0, window=4, min_samples=4,
                           hold=4, recover_margin=0.5)
    srv = AccelServer(exes["w8"], max_batch=4, max_wait=0.0, clock=clock,
                      policy=RuntimePolicy(POINTS), point_executables=exes,
                      slo=slo)

    def serve_one():
        tk = srv.submit(np.ones((4, 3), np.float32))
        srv.pump(flush=True)
        srv.result(tk)

    # under pressure: w8 costs 2.0s (p95 > 1.0 SLO) -> downshift to w4
    # (1.5s, still violating) -> downshift to w2 (0.8s, inside SLO)
    for _ in range(12):
        serve_one()
    ctl = srv._default.controller
    assert ctl.shifts == [("w8", "w4"), ("w4", "w2")]
    # pressure off: once the 0.8s samples age out of the window, p95 drops
    # under recover_margin * SLO and the controller climbs w2 -> w4 -> w8
    pressure["on"] = False
    for _ in range(12):
        serve_one()
    assert ctl.shifts == [("w8", "w4"), ("w4", "w2"),
                          ("w2", "w4"), ("w4", "w8")]
    # BatchReport.bits telemetry confirms the full trajectory
    bits = [r.bits for r in srv.reports]
    assert bits == [8] * 4 + [4] * 4 + [2] * 8 + [4] * 4 + [8] * 4
    tel = srv.stats()["slo"]
    assert tel["point"] == "w8" and len(tel["shifts"]) == 4


def test_slo_controller_holds_between_shifts():
    ctl = SLOController(POINTS, ServiceObjective(
        p95_latency_s=1.0, window=8, min_samples=2, hold=4,
        recover_margin=0.5))
    for _ in range(3):
        ctl.observe(5.0)
    assert ctl.select().name == "w8"        # hold not yet satisfied
    ctl.observe(5.0)
    assert ctl.select().name == "w4"        # 4th observation may shift
    ctl.observe(5.0)
    ctl.observe(5.0)
    assert ctl.select().name == "w4"        # window cleared + hold again


def test_slo_requires_policy():
    with pytest.raises(ValueError, match="needs a RuntimePolicy"):
        AccelServer(Recorder(), slo=ServiceObjective(p95_latency_s=1.0))


# ---------------------------------------------------------------------------
# unified selector surface: selector= equals the legacy policy=/slo= pair,
# and a computed ParetoFront drives the same closed loop
# ---------------------------------------------------------------------------


def _drive_slo_trajectory(srv, pressure):
    """The canonical downshift-then-recover trajectory against a server."""

    def serve_one():
        tk = srv.submit(np.ones((4, 3), np.float32))
        srv.pump(flush=True)
        srv.result(tk)

    for _ in range(12):
        serve_one()
    pressure["on"] = False
    for _ in range(12):
        serve_one()
    return [r.bits for r in srv.reports]


def test_selector_kwarg_matches_legacy_policy_slo_pair():
    """selector=SLOController(...) reproduces the policy=/slo= trajectory
    bit-for-bit: the legacy pair is sugar over the one selector slot."""
    slo_kw = dict(p95_latency_s=1.0, window=4, min_samples=4, hold=4,
                  recover_margin=0.5)
    traces = []
    for style in ("legacy", "selector"):
        clock = FakeClock()
        pressure = {"on": True}
        exes = {p.name: BitsExe(p.weight_bits, clock, pressure)
                for p in POINTS}
        kw = (dict(policy=RuntimePolicy(POINTS),
                   slo=ServiceObjective(**slo_kw)) if style == "legacy"
              else dict(selector=SLOController(
                  POINTS, ServiceObjective(**slo_kw))))
        srv = AccelServer(exes["w8"], max_batch=4, max_wait=0.0, clock=clock,
                          point_executables=exes, **kw)
        traces.append(_drive_slo_trajectory(srv, pressure))
        assert srv._default.controller is srv.selector   # legacy view intact
    assert traces[0] == traces[1]
    assert traces[0] == [8] * 4 + [4] * 4 + [2] * 8 + [4] * 4 + [8] * 4


def test_selector_excludes_legacy_pair():
    sel = SLOController(POINTS, ServiceObjective(p95_latency_s=1.0))
    with pytest.raises(ValueError, match="not both"):
        AccelServer(Recorder(), selector=sel, policy=RuntimePolicy(POINTS))
    with pytest.raises(ValueError, match="not both"):
        AccelServer(Recorder(), selector=sel,
                    slo=ServiceObjective(p95_latency_s=1.0))


def test_slo_loop_walks_a_computed_pareto_front():
    """The DSE acceptance loop: an explorer-shaped ParetoFront (not the
    hardcoded ladder) feeds serve-time selection, and the SLO controller
    demonstrably shifts across the front's own points."""
    from repro_torch.dse import ParetoFront, ParetoPoint

    def ppt(name, bits, wb, lat, agree):
        return ParetoPoint(WorkingPoint(name, bits, act_bits=8),
                           weight_bytes=wb, fifo_bytes=64, scratch_bytes=0,
                           predicted_latency_s=lat, agreement=agree)

    front = ParetoFront("toy", [ppt("w8", 8, 300, 3e-6, 1.0),
                                ppt("w4", 4, 150, 2e-6, 0.9),
                                ppt("w2", 2, 80, 1e-6, 0.6)])
    # the front round-trips through its wire format before serving, exactly
    # as a deployment loading a committed front artifact would
    front = ParetoFront.from_json(front.to_json())
    clock = FakeClock()
    pressure = {"on": True}
    exes = {p.name: BitsExe(p.weight_bits, clock, pressure)
            for p in front.working_points()}
    sel = front.selector(ServiceObjective(p95_latency_s=1.0, window=4,
                                          min_samples=4, hold=4,
                                          recover_margin=0.5))
    srv = AccelServer(exes["w8"], max_batch=4, max_wait=0.0, clock=clock,
                      point_executables=exes, selector=sel)
    bits = _drive_slo_trajectory(srv, pressure)
    assert bits == [8] * 4 + [4] * 4 + [2] * 8 + [4] * 4 + [8] * 4
    assert sel.shifts == [("w8", "w4"), ("w4", "w2"),
                          ("w2", "w4"), ("w4", "w8")]
    tel = srv.stats()["slo"]
    assert tel["point"] == "w8" and len(tel["shifts"]) == 4


# ---------------------------------------------------------------------------
# telemetry shapes
# ---------------------------------------------------------------------------


def test_multi_tenant_stats_aggregate_and_breakdown():
    srv = AccelServer(max_batch=4, max_wait=0.0)
    srv.add_tenant("a", Recorder(), max_batch=4, max_wait=0.0, weight=2)
    srv.add_tenant("b", Recorder(), max_batch=4, max_wait=0.0)
    for _ in range(3):
        srv.submit(*vals(1), tenant="a")
    srv.submit(*vals(1), tenant="b")
    srv.pump(flush=True)
    s = srv.stats()
    assert set(s["tenants"]) == {"a", "b"}
    assert s["submitted"] == 4
    assert s["tenants"]["a"]["weight"] == 2
    assert s["executed_batches"] == (s["tenants"]["a"]["executed_batches"]
                                     + s["tenants"]["b"]["executed_batches"])
    sa = srv.stats(tenant="a")
    assert sa["submitted"] == 3


def test_report_carries_tenant_name():
    srv = AccelServer(max_batch=4, max_wait=0.0)
    srv.add_tenant("x", Recorder(), max_batch=4, max_wait=0.0)
    srv.submit(*vals(1), tenant="x")
    srv.pump(flush=True)
    rep = srv.tenants["x"].reports[-1]
    assert rep.tenant == "x" and rep.exec_s is not None
