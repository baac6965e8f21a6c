"""Batch-coalescing serving runtime: deterministic scheduler behaviour
(fake clock), bucket-vs-LRU selection, pad/slice-back round-trips, precision
working-point selection, and the differential property that coalesced
execution equals naive per-request execution.

Every test of ``tests/test_scheduler.py`` under the port's mapping
(``repro.`` -> ``repro_torch.``, target ``"jax"`` -> ``"torch"``, flows on the
CPU); the requests are the reference's, drawn with ``jax.random``.
"""

import jax
import numpy as np
import pytest

from repro_torch.core.adaptive import RuntimePolicy, WorkingPoint
from repro_torch.core.flow import DesignFlow
from repro_torch.core.reader import mlp_to_ir
from repro_torch.runtime.scheduler import (
    BucketPolicy,
    CoalescingScheduler,
    QueueFull,
)
from repro_torch.runtime.serve import AccelServer


class FakeClock:
    """Injected monotonic clock: tests advance time explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def mlp_flow(seed=0, feat=6, hidden=12, classes=4):
    rng = np.random.default_rng(seed)
    sizes = [feat, hidden, classes]
    params = {}
    for i in range(len(sizes) - 1):
        params[f"fc{i}/w"] = rng.normal(size=(sizes[i], sizes[i + 1])).astype(
            np.float32
        )
        params[f"fc{i}/b"] = rng.normal(size=(sizes[i + 1],)).astype(np.float32)
    return DesignFlow(mlp_to_ir(sizes, params), device="cpu").run()


def req(size, feat=6, seed=0):
    return np.asarray(
        jax.random.normal(jax.random.PRNGKey(seed * 1000 + size), (size, feat))
    )


# ---------------------------------------------------------------------------
# scheduler (pure host logic, fake clock)
# ---------------------------------------------------------------------------


def test_max_wait_flushes_partial_batch():
    clock = FakeClock()
    sched = CoalescingScheduler(max_batch=8, max_wait=0.01, clock=clock)
    sched.submit((req(2),))
    assert sched.ready() is None  # partial batch: keep waiting
    clock.advance(0.005)
    assert sched.ready() is None  # still inside max_wait
    clock.advance(0.006)
    batch = sched.ready()
    assert batch is not None and batch.size == 2 and len(batch.requests) == 1
    assert len(sched) == 0


def test_full_batch_flushes_without_waiting():
    sched = CoalescingScheduler(max_batch=4, max_wait=1e9, clock=FakeClock())
    for _ in range(2):
        sched.submit((req(2),))
    batch = sched.ready()
    assert batch is not None and batch.size == 4 and batch.padding == 0


def test_oversubscribed_queue_closes_batch_early():
    # 5 + 4 > max_batch: the head batch is as full as it can get, so it
    # flushes immediately instead of waiting out max_wait
    sched = CoalescingScheduler(max_batch=8, max_wait=1e9, clock=FakeClock())
    a = sched.submit((req(5),))
    b = sched.submit((req(4),))
    batch = sched.ready()
    assert [r.rid for r in batch.requests] == [a.rid]
    assert batch.bucket == 8  # 5 rows pad to the ladder bucket
    assert sched.ready() is None  # the 4-row tail keeps waiting
    batch2 = sched.ready(flush=True)
    assert [r.rid for r in batch2.requests] == [b.rid]


def test_fifo_order_preserved_across_batches():
    sched = CoalescingScheduler(max_batch=4, max_wait=0.0, clock=FakeClock())
    rids = [sched.submit((req(2, seed=i),)).rid for i in range(4)]
    seen = []
    for batch in sched.drain():
        seen.extend(r.rid for r in batch.requests)
    assert seen == rids


def test_queue_depth_backpressure():
    sched = CoalescingScheduler(max_batch=8, queue_depth=2, clock=FakeClock())
    sched.submit((req(1),))
    sched.submit((req(1),))
    with pytest.raises(QueueFull):
        sched.submit((req(1),))


def test_submit_validation():
    sched = CoalescingScheduler(max_batch=4, clock=FakeClock())
    with pytest.raises(ValueError, match="leading dim"):
        sched.submit((req(2), req(3)))
    with pytest.raises(ValueError, match="no inputs"):
        sched.submit(())


def test_oversize_submit_splits_into_chunks():
    """A request larger than max_batch no longer raises: it splits into
    back-to-back chunk requests and returns a parent carrying their rids."""
    sched = CoalescingScheduler(max_batch=4, max_wait=0.0, clock=FakeClock())
    parent = sched.submit((req(10),))
    assert parent.size == 10 and len(parent.children) == 3
    assert len(sched) == 3  # only the chunks are queued
    sizes = [r.size for r in sched._queue]
    assert sizes == [4, 4, 2]
    # chunks drain contiguously in arrival order
    seen = []
    for batch in sched.drain():
        seen.extend(r.rid for r in batch.requests)
    assert seen == parent.children
    s = sched.stats()
    assert s["split_requests"] == 1 and s["split_chunks"] == 3
    assert s["submitted"] == 1


def test_oversize_submit_respects_queue_depth_atomically():
    sched = CoalescingScheduler(max_batch=4, queue_depth=2, clock=FakeClock())
    with pytest.raises(QueueFull):
        sched.submit((req(12),))  # needs 3 chunk slots, only 2 exist
    assert len(sched) == 0  # nothing partially enqueued


def test_mismatched_request_signature_rejected_at_submit():
    """A request whose arity / trailing shape / dtype differs from the served
    artifact's cannot share a padded column — it must be rejected up front,
    not poison the batch it would have coalesced into."""
    sched = CoalescingScheduler(max_batch=8, clock=FakeClock())
    sched.submit((req(2, feat=6),))
    with pytest.raises(ValueError, match="signature"):
        sched.submit((req(2, feat=5),))  # trailing shape differs
    with pytest.raises(ValueError, match="signature"):
        sched.submit((req(2), req(2)))  # arity differs
    with pytest.raises(ValueError, match="signature"):
        sched.submit((req(2).astype(np.float64),))  # dtype differs
    sched.submit((req(3, feat=6),))  # matching request still accepted


def test_flow_serve_locks_signature_to_the_artifact():
    """FlowResult.serve passes the graph's input spec down, so a malformed
    FIRST request is rejected immediately instead of poisoning the lock for
    every correctly-shaped request after it."""
    res = mlp_flow()  # 6-feature MLP
    srv = res.serve(max_batch=8, max_wait=0.0)
    with pytest.raises(ValueError, match="served artifact"):
        srv.submit(req(2, feat=5))  # wrong trailing shape, never enqueued
    t = srv.submit(req(2, feat=6))  # the server is not poisoned
    assert np.asarray(srv.result(t)).shape == (2, 4)


def test_failed_batch_resolves_member_tickets_to_errors():
    """An executable failure must not lose the batch's tickets: pump raises,
    but every member resolves to a per-ticket error, and the server keeps
    serving afterwards."""

    class Flaky:
        fail = True

        def __call__(self, x):
            if self.fail:
                raise RuntimeError("device fell over")
            return x

    exe = Flaky()
    srv = AccelServer(exe, max_batch=8, max_wait=0.0, clock=FakeClock())
    ta, tb = srv.submit(req(2)), srv.submit(req(3))
    with pytest.raises(RuntimeError, match="device fell over"):
        srv.pump(flush=True)
    for t in (ta, tb):
        with pytest.raises(RuntimeError, match="batch execution failed"):
            srv.result(t)
    exe.fail = False  # transient failure clears: later requests serve fine
    tc = srv.submit(req(2, seed=9))
    assert np.asarray(srv.result(tc)).shape == (2, 6)


# ---------------------------------------------------------------------------
# bucket policy vs the executable's LRU
# ---------------------------------------------------------------------------


def test_bucket_ladder_defaults_to_powers_of_two():
    pol = BucketPolicy(max_batch=8)
    assert pol.buckets == (1, 2, 4, 8)
    assert BucketPolicy(max_batch=6).buckets == (1, 2, 4, 6)
    with pytest.raises(ValueError, match="exceed max_batch"):
        BucketPolicy(buckets=(16,), max_batch=8)  # would pad every batch 2x


def test_bucket_prefers_cached_size_when_padding_no_worse():
    pol = BucketPolicy(max_batch=8)
    assert pol.bucket_for(3, cached=()) == 4  # ladder
    assert pol.bucket_for(3, cached=(3,)) == 3  # exact trace resident: reuse
    assert pol.bucket_for(3, cached=(8,)) == 4  # cached 8 pads worse: ladder
    assert pol.bucket_for(5, cached=(6,)) == 6  # 6 <= ladder 8: hit wins
    assert pol.bucket_for(5, cached=(6, 7)) == 6  # smallest fitting hit
    assert pol.bucket_for(2, cached=(2, 4)) == 2


def test_scheduler_bucket_tracks_lru_contents():
    sched = CoalescingScheduler(max_batch=8, max_wait=0.0, clock=FakeClock())
    sched.submit((req(3),))
    assert sched.ready(cached=(3, 8)).bucket == 3
    sched.submit((req(3),))
    assert sched.ready(cached=(8,)).bucket == 4


def test_server_reuses_prewarmed_trace_instead_of_retracing():
    res = mlp_flow()
    exe = res.batched["torch"]
    exe(req(4))  # pre-warm a batch-4 trace
    assert exe.misses == 1 and exe.cached_batches == (4,)
    srv = AccelServer(exe, max_batch=8, max_wait=0.0)
    srv.submit(req(3))
    srv.pump(flush=True)
    # 3 useful rows ride the resident batch-4 trace: a hit, not a retrace
    assert exe.misses == 1 and exe.hits == 1
    assert srv.reports[-1].bucket == 4 and srv.reports[-1].padding == 1


def test_on_compile_hook_observes_trace_misses():
    res = mlp_flow()
    seen = []
    exe = res.writers["torch"].build_batched(on_compile=seen.append)
    srv = AccelServer(exe, max_batch=8, max_wait=0.0)
    for size in (1, 2, 1):
        srv.submit(req(size, seed=size))
        srv.pump(flush=True)
    assert [sig[0][0][0] for sig in seen] == [1, 2]  # batch-1 retrace avoided


# ---------------------------------------------------------------------------
# pad / slice-back and differential conformance
# ---------------------------------------------------------------------------


def assert_matches(actual, desired):
    """Coalesced vs per-request outputs agree to float32 rounding: executing
    at a different batch size may legally change the library's reduction order
    by an ulp, so "equal" means ulp-level closeness, not bitwise identity."""
    np.testing.assert_allclose(
        np.asarray(actual), np.asarray(desired), rtol=1e-5, atol=1e-6
    )


def test_pad_slice_back_roundtrip_is_exact():
    res = mlp_flow()
    srv = res.serve(max_batch=8, max_wait=0.0)
    x = req(3)
    y = srv(x)  # pads 3 -> bucket 4, slices back
    assert srv.reports[-1].padding == 1
    assert_matches(y, res.executables["torch"](x))


def test_coalesced_results_match_per_request_execution():
    """The differential property: a mixed-size stream served coalesced is
    identical (to float rounding) to executing every request alone."""
    res = mlp_flow(seed=7)
    srv = res.serve(max_batch=8, max_wait=0.0)
    sizes = [1, 3, 2, 5, 1, 4, 2, 8, 1]
    xs = [req(s, seed=i) for i, s in enumerate(sizes)]
    tickets = [srv.submit(x) for x in xs]
    srv.pump(flush=True)
    naive = res.executables["torch"]
    for t, x in zip(tickets, xs):
        assert_matches(srv.result(t), naive(x))
    stats = srv.stats()
    assert stats["submitted"] == len(sizes)
    assert stats["executed_batches"] == len(srv.reports) < len(sizes)
    assert stats["scheduled_rows"] == sum(sizes)


def test_every_ticket_demuxes_its_own_rows():
    res = mlp_flow(seed=1)
    srv = res.serve(max_batch=8, max_wait=0.0)
    a, b = req(2, seed=1), req(2, seed=2)
    ta, tb = srv.submit(a), srv.submit(b)
    ya, yb = srv.result(ta), srv.result(tb)
    naive = res.executables["torch"]
    assert_matches(ya, naive(a))
    assert_matches(yb, naive(b))
    with pytest.raises(KeyError):
        srv.result(ta)  # results are single-consumption
    tc = srv.submit(req(2, seed=3))
    srv.pump(flush=True)
    srv.drop(tc)  # abandoned ticket: result released, not resident forever
    assert not srv._results
    td = srv.submit(req(2, seed=4))
    srv.drop(td)  # dropped BEFORE execution: output discarded at demux
    srv.pump(flush=True)
    assert not srv._results and not srv._dropped


def test_split_request_demuxes_to_one_ticket():
    """An oversize submission is served in chunks but claimed as ONE ticket
    whose rows equal the unsplit execution."""
    res = mlp_flow(seed=3)
    srv = res.serve(max_batch=4, max_wait=0.0)
    x = req(11, seed=5)
    t = srv.submit(x)
    srv.pump(flush=True)
    assert_matches(srv.result(t), res.executables["torch"](x))
    s = srv.stats()
    assert s["split_requests"] == 1 and s["split_chunks"] == 3
    assert not srv._results and not srv._split


def test_split_request_interleaves_with_normal_traffic():
    res = mlp_flow(seed=4)
    srv = res.serve(max_batch=4, max_wait=0.0)
    a, big, b = req(2, seed=1), req(9, seed=2), req(3, seed=3)
    ta, tbig, tb = srv.submit(a), srv.submit(big), srv.submit(b)
    srv.pump(flush=True)
    naive = res.executables["torch"]
    assert_matches(srv.result(tbig), naive(big))
    assert_matches(srv.result(ta), naive(a))
    assert_matches(srv.result(tb), naive(b))


def test_dropped_split_parent_releases_every_chunk():
    res = mlp_flow(seed=5)
    srv = res.serve(max_batch=4, max_wait=0.0)
    t = srv.submit(req(10, seed=6))
    srv.drop(t)  # before execution
    srv.pump(flush=True)
    assert not srv._results and not srv._dropped and not srv._split
    t2 = srv.submit(req(10, seed=7))
    srv.pump(flush=True)
    srv.drop(t2)  # after execution
    assert not srv._results and not srv._split


def test_server_pump_respects_fake_clock():
    clock = FakeClock()
    res = mlp_flow()
    srv = res.serve(max_batch=8, max_wait=0.5, clock=clock)
    srv.submit(req(2))
    assert srv.pump() == 0  # nothing ready yet
    clock.advance(1.0)
    assert srv.pump() == 1  # max_wait elapsed on the fake clock
    assert srv.latencies and srv.latencies[0] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# precision working points per scheduled batch
# ---------------------------------------------------------------------------


def test_policy_selects_point_from_batch_budget():
    points = [WorkingPoint("w8", 8), WorkingPoint("w4", 4), WorkingPoint("w2", 2)]
    policy = RuntimePolicy(points, thresholds=[0.66, 0.33])
    calls = []

    def fake_point(name):
        def run(x):
            calls.append(name)
            return x

        return run

    srv = AccelServer(
        fake_point("default"),
        max_batch=8,
        max_wait=0.0,
        policy=policy,
        point_executables={n: fake_point(n) for n in ("w8", "w4", "w2")},
        clock=FakeClock(),
    )
    for budget in (1.0, 0.5, 0.1):
        srv.submit(req(2), budget=budget)
        srv.pump(flush=True)
    assert calls == ["w8", "w4", "w2"]
    assert [r.point for r in srv.reports] == ["w8", "w4", "w2"]
    assert srv.stats()["points"] == {"w8": 1, "w4": 1, "w2": 1}


def test_batch_budget_is_most_constrained_member():
    points = [WorkingPoint("w8", 8), WorkingPoint("w2", 2)]
    policy = RuntimePolicy(points, thresholds=[0.5])
    srv = AccelServer(
        lambda x: x,
        max_batch=8,
        max_wait=0.0,
        policy=policy,
        clock=FakeClock(),
    )
    srv.submit(req(2), budget=1.0)
    srv.submit(req(2), budget=0.2)  # constrained member drags the batch down
    srv.pump(flush=True)
    assert [r.point for r in srv.reports] == ["w2"]


# ---------------------------------------------------------------------------
# best-fit packing (BucketPolicy.packing="best_fit")
# ---------------------------------------------------------------------------


def test_best_fit_dispatches_min_waste_prefix():
    # sizes [4, 3]: fifo packs both (7 rows -> bucket 8, waste 1); best-fit
    # stops at [4] (bucket 4, waste 0) and serves [3] from the next batch
    sched = CoalescingScheduler(
        max_batch=8, max_wait=1e9, clock=FakeClock(), packing="best_fit"
    )
    for n in (4, 3):
        sched.submit((req(n),))
    first = sched.ready(flush=True)
    assert [r.size for r in first.requests] == [4]
    assert first.bucket == 4 and first.padding == 0
    second = sched.ready(flush=True)
    assert [r.size for r in second.requests] == [3]


def test_best_fit_tie_prefers_longer_prefix():
    # [2, 2]: prefix [2] (bucket 2, waste 0) ties with [2, 2] (bucket 4,
    # waste 0) -> the longer prefix wins (more requests per dispatch)
    sched = CoalescingScheduler(
        max_batch=8, max_wait=1e9, clock=FakeClock(), packing="best_fit"
    )
    for _ in range(2):
        sched.submit((req(2),))
    batch = sched.ready(flush=True)
    assert [r.size for r in batch.requests] == [2, 2]
    assert batch.padding == 0


def test_best_fit_never_reorders_the_queue():
    # arrival order is preserved: best-fit only picks a PREFIX length, so the
    # head request is always in the dispatched batch (no starvation)
    sched = CoalescingScheduler(
        max_batch=8, max_wait=1e9, clock=FakeClock(), packing="best_fit"
    )
    for n in (3, 4, 1):
        sched.submit((req(n),))
    batch = sched.ready(flush=True)
    assert batch.requests[0].size == 3


def test_fifo_stays_the_default_packing():
    sched = CoalescingScheduler(max_batch=8, max_wait=1e9, clock=FakeClock())
    for n in (4, 3):
        sched.submit((req(n),))
    batch = sched.ready(flush=True)
    assert [r.size for r in batch.requests] == [4, 3]
    with pytest.raises(ValueError):
        BucketPolicy(max_batch=8, packing="round_robin")


def test_accel_server_passes_packing_through():
    res = mlp_flow()
    srv = AccelServer(
        res.batched["torch"],
        max_batch=8,
        max_wait=1e9,
        clock=FakeClock(),
        packing="best_fit",
    )
    t4, t3 = srv.submit(req(4)), srv.submit(req(3, seed=1))
    srv.pump(flush=True)
    assert [r.rows for r in srv.reports] == [4, 3]  # two min-waste batches
    ref = res.executables["torch"]
    np.testing.assert_allclose(
        np.asarray(srv.result(t4)), np.asarray(ref(req(4))), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(srv.result(t3)), np.asarray(ref(req(3, seed=1))), atol=1e-5
    )
