"""Weight-memory integrity in the port: CRC-sealed regions on the packed
buffer, the rate-bounded scrubber (detect / repair-in-place / quarantine),
the fatal escalation through AccelServer into fleet ejection with a
``quarantined`` cause, semantic canaries, the NaN/Inf output guard, seeded
SEU injection and the hardened Pareto-front deserializer.

Every test of ``tests/test_integrity.py`` under the port's mapping
(``repro.`` -> ``repro_torch.``; host copies through ``device.to_numpy``)
but the two autotune-cache tests, which wait for ``kernels/autotune.py``.
Then parity with the JAX package on the same numpy weights: the regions,
their sealed CRCs, the flip sequence a seed draws and the scrubber's
telemetry after the same flips are equal; and the port's own guarantee
that a batch still running when the weights are quarantined is withheld.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.models import cnn as j_models
from repro.quant import pack as j_pack
from repro.runtime import integrity as j_integrity

from repro_torch.device import to_numpy
from repro_torch.dse.pareto import FrontFormatError, ParetoFront, ParetoPoint
from repro_torch.quant.pack import PACK_ALIGN, PackedWeights
from repro_torch.runtime.fleet import FleetRouter, HealthState
from repro_torch.runtime.integrity import (BitFlipInjector, CanarySet,
                                           IntegrityError, Scrubber)
from repro_torch.runtime.serve import AccelServer, NumericalFault


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_packed(with_views=True):
    """Two small quantizable weights; optionally derive the W4/W2 views so
    every region kind (codes, scale, view) exists."""
    rng = np.random.default_rng(0)
    pw = PackedWeights.from_initializers({
        "fc/w": rng.standard_normal((16, 24)).astype(np.float32),
        "out/w": rng.standard_normal((24, 8)).astype(np.float32),
    })
    if with_views:
        for t in pw.tensors.values():
            t.packed_view(4)
            t.packed_view(2)
    return pw


def snapshot(pw):
    """Golden copies of every live buffer, for restore between flips."""
    return {(n, "codes"): np.array(to_numpy(t.codes))
            for n, t in pw.tensors.items()} \
        | {(n, "scale"): np.array(to_numpy(t.scale))
           for n, t in pw.tensors.items()} \
        | {(n, "view", b, a): np.array(to_numpy(buf))
           for n, t in pw.tensors.items()
           for (b, a), buf in t._packed.items()}


def restore(pw, golden):
    for n, t in pw.tensors.items():
        t.codes = torch.tensor(golden[(n, "codes")])
        t.scale = torch.tensor(golden[(n, "scale")])
        t.seal()
        for (b, a) in list(t._packed):
            t.repair_view(b, align=a)


# ---------------------------------------------------------------------------
# region checksums: detection sweep
# ---------------------------------------------------------------------------


def test_verify_catches_any_single_bit_flip_in_any_region():
    # seeded sweep: several random (byte, bit) flips per region, at every
    # region kind — verify() must name exactly the corrupted region
    pw = make_packed()
    golden = snapshot(pw)
    regions = pw.regions()
    assert {r.kind for r in regions} == {"codes", "scale", "view"}
    assert len(regions) == 2 * 4          # 2 tensors x (codes, scale, v4, v2)
    for i, region in enumerate(regions):
        for seed in range(3):
            inj = BitFlipInjector(pw, seed=100 * i + seed)
            rec = inj.flip(region=region)
            mismatches = pw.verify()
            assert [m.region for m in mismatches] == [region], \
                f"flip {rec} in {region.label()} not isolated"
            assert mismatches[0].repairable == (region.kind == "view")
            restore(pw, golden)
    assert pw.verify() == []


def test_verify_bits_filter_sees_the_serving_points_regions():
    # per-working-point verification: the bits filter must cover exactly
    # the buffers that point serves from
    pw = make_packed()
    golden = snapshot(pw)
    inj = BitFlipInjector(pw, seed=7)
    # W2 view flip: invisible to the W8 path, caught by W2 and the full scan
    v2 = next(r for r in pw.regions() if r.kind == "view" and r.bits == 2)
    inj.flip(region=v2)
    assert pw.verify(bits=8) == []
    assert [m.region for m in pw.verify(bits=2)] == [v2]
    restore(pw, golden)
    # master-code flip: the W8 path and the full scan see it
    codes = next(r for r in pw.regions() if r.kind == "codes")
    inj.flip(region=codes)
    assert [m.region for m in pw.verify(bits=8)] == [codes]
    assert codes in [m.region for m in pw.verify()]
    restore(pw, golden)


def test_view_repair_is_bit_exact_from_master():
    pw = make_packed()
    golden = snapshot(pw)
    v4 = next(r for r in pw.regions() if r.kind == "view" and r.bits == 4)
    BitFlipInjector(pw, seed=3).flip(region=v4)
    [m] = pw.verify()
    pw.repair(m)
    assert pw.verify() == []
    buf = to_numpy(pw.tensors[v4.tensor]._packed[(v4.bits, v4.align)])
    assert np.array_equal(buf, golden[(v4.tensor, "view", v4.bits, v4.align)])


def test_repair_refuses_unrepairable_regions():
    pw = make_packed()
    codes = next(r for r in pw.regions() if r.kind == "codes")
    BitFlipInjector(pw, seed=4).flip(region=codes)
    [m] = pw.verify(bits=8)
    assert not m.repairable and "UNREPAIRABLE" in str(m)
    with pytest.raises(ValueError, match="cannot repair"):
        pw.repair(m)


def test_packed_view_cache_is_thread_safe():
    # hammer first-touch derivation: every thread must get the identical
    # sealed buffer, with exactly one cache entry and one checksum per view
    pw = make_packed(with_views=False)
    t = pw.tensors["fc/w"]
    results, errs = [], []
    start = threading.Barrier(8)

    def worker(bits):
        try:
            start.wait(5.0)
            for _ in range(50):
                results.append((bits, to_numpy(t.packed_view(bits))))
        except Exception as e:                      # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(b,))
               for b in (4, 2) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10.0)
    assert not errs
    assert set(t._packed) == {(4, PACK_ALIGN), (2, PACK_ALIGN)}
    for bits in (4, 2):
        bufs = [b for bb, b in results if bb == bits]
        assert all(np.array_equal(bufs[0], b) for b in bufs)
    assert pw.verify() == []        # checksums sealed consistently


# ---------------------------------------------------------------------------
# scrubber
# ---------------------------------------------------------------------------


def test_scrubber_detects_and_repairs_view_flip():
    pw = make_packed()
    golden = snapshot(pw)
    repaired = []
    sc = Scrubber(pw, on_repair=repaired.append)
    v2 = next(r for r in pw.regions() if r.kind == "view" and r.bits == 2)
    BitFlipInjector(pw, seed=5).flip(region=v2)
    sc.scrub_once()                 # one full pass catches any single flip
    assert sc.detected_flips == 1 and sc.repaired_views == 1
    assert sc.quarantines == 0 and sc.fatal is None
    assert [m.region for m in repaired] == [v2]
    assert pw.verify() == []
    buf = to_numpy(pw.tensors[v2.tensor]._packed[(v2.bits, v2.align)])
    assert np.array_equal(buf, golden[(v2.tensor, "view", v2.bits, v2.align)])


def test_scrubber_quarantines_master_corruption_once():
    pw = make_packed()
    quarantined = []
    sc = Scrubber(pw, on_quarantine=quarantined.append)
    codes = next(r for r in pw.regions() if r.kind == "codes")
    BitFlipInjector(pw, seed=6).flip(region=codes)
    for _ in range(3):              # repeated passes must not re-escalate
        sc.scrub_once()
    assert sc.quarantines == 1 and len(quarantined) == 1
    assert sc.detected_flips == 1   # quarantined region is off-duty
    assert sorted(sc.quarantined) == [codes.label()]
    err = sc.fatal
    assert isinstance(err, IntegrityError)
    assert [m.region for m in err.mismatches] == [codes]
    assert sc.telemetry()["quarantines"] == 1


def test_scrubber_never_repairs_view_from_corrupt_master():
    # a view flip whose master is ALSO corrupt must not be re-derived (that
    # would launder the corruption); both regions end up quarantined
    pw = make_packed()
    t = pw.tensors["fc/w"]
    regs = {r.kind if r.kind != "view" else (r.kind, r.bits): r
            for r in t.regions("fc/w")}
    inj = BitFlipInjector(pw, seed=8)
    inj.flip(region=regs["codes"])
    inj.flip(region=regs[("view", 4)])
    sc = Scrubber(pw)
    sc.scrub_once()
    assert sc.repaired_views == 0
    assert set(sc.quarantined) == {regs["codes"].label(),
                                   regs[("view", 4)].label()}


def test_scrubber_rate_bound_and_round_robin():
    pw = make_packed()
    clock = FakeClock()
    n = len(pw.regions())
    per_pass = sum(r.nbytes for r in pw.regions())
    biggest = max(r.nbytes for r in pw.regions())
    # rate = one full pass per second; a 0.25s tick funds ~a quarter pass
    sc = Scrubber(pw, rate_bytes_s=per_pass, interval_s=0.01, clock=clock)
    assert sc.period_bytes() == per_pass
    sc._tick()                      # first tick only arms the clock
    clock.advance(0.25)
    sc._tick()
    assert 0 < sc.scrubbed_bytes <= 0.25 * per_pass + biggest
    assert 0 < sc._cursor < n       # partial pass: cursor mid-list
    # four more funded ticks complete at least one full round-robin pass
    for _ in range(4):
        clock.advance(0.3)
        sc._tick()
    assert sc.scrub_passes >= 1


def test_scrubber_budget_cap_bounds_a_stall_burst():
    pw = make_packed()
    clock = FakeClock()
    per_pass = sum(r.nbytes for r in pw.regions())
    sc = Scrubber(pw, rate_bytes_s=per_pass, interval_s=0.01, clock=clock)
    sc._tick()
    clock.advance(1000.0)           # a long stall accrues a huge allowance
    sc._tick()                      # ...but bursts at most ~2 full passes
    assert sc.scrubbed_bytes <= 2 * per_pass
    assert sc.scrub_passes <= 2


def test_scrubber_daemon_lifecycle():
    pw = make_packed()
    sc = Scrubber(pw, rate_bytes_s=50e6, interval_s=0.001)
    with sc:
        assert sc.alive
        with pytest.raises(RuntimeError, match="already running"):
            sc.start()
        deadline = time.monotonic() + 5.0
        while sc.scrub_passes < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sc.scrub_passes >= 2
    assert not sc.alive
    p = sc.scrub_passes
    time.sleep(0.02)
    assert sc.scrub_passes == p     # really stopped


def test_scrubber_rejects_bad_config():
    pw = make_packed()
    with pytest.raises(ValueError):
        Scrubber(pw, rate_bytes_s=0)
    with pytest.raises(ValueError):
        Scrubber(pw, interval_s=-1)


# ---------------------------------------------------------------------------
# escalation: scrubber -> AccelServer -> fleet
# ---------------------------------------------------------------------------


def shared_exe(pw):
    """A tiny 'working point' reading the LIVE master codes (not a traced
    constant), so served results actually depend on the shared buffer."""
    def exe(x):
        w = to_numpy(pw.tensors["fc/w"].codes).astype(np.float32)
        return np.asarray(x, np.float32) @ w
    return exe


def test_attach_scrubber_kills_server_on_quarantine():
    pw = make_packed()
    srv = AccelServer(shared_exe(pw), max_batch=4, max_wait=0.001)
    sc = Scrubber(pw)
    srv.attach_scrubber(sc)
    assert srv.scrubber is sc
    with srv:
        assert float(np.asarray(srv(np.ones((1, 16), np.float32))).sum()) \
            == pytest.approx(float(to_numpy(pw.tensors["fc/w"].codes).sum()))
        codes = next(r for r in pw.regions() if r.kind == "codes")
        BitFlipInjector(pw, seed=9).flip(region=codes)
        sc.scrub_once()             # detection -> quarantine -> fatal pump
        assert isinstance(srv.fatal, IntegrityError)
        deadline = time.monotonic() + 5.0
        while srv.alive and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not srv.alive        # refuses further work: no corrupted
        with pytest.raises(RuntimeError):   # result is served post-detection
            srv.submit(np.ones((1, 16), np.float32))
        assert srv.stats()["integrity"]["quarantines"] == 1


def test_fleet_ejects_quarantined_replica_and_heals_via_factory():
    pw = make_packed()
    golden = snapshot(pw)
    scrubbers = []

    def factory():
        if pw.verify():             # heal path: restore the pristine master
            restore(pw, golden)
        srv = AccelServer(shared_exe(pw), max_batch=4, max_wait=0.001)
        sc = Scrubber(pw, rate_bytes_s=50e6, interval_s=0.001)
        srv.attach_scrubber(sc)
        sc.start()
        scrubbers.append(sc)
        return srv

    r = FleetRouter({"a": factory}, probe=[np.ones((1, 16), np.float32)],
                    probe_interval_s=0.01, heal_cooldown_s=0.05,
                    default_deadline_s=15.0)
    try:
        with r:
            assert r(np.ones((1, 16), np.float32)) is not None
            codes = next(rg for rg in pw.regions() if rg.kind == "codes")
            BitFlipInjector(pw, seed=10).flip(region=codes)
            rep = r.replicas["a"]
            deadline = time.monotonic() + 10.0
            while rep.eject_cause != "quarantined" \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rep.eject_cause == "quarantined"
            # the dead generation's scrubber still backs the fleet telemetry
            # until the heal swaps it out
            assert r.stats()["integrity"]["quarantines"] >= 1
            # heal: factory restores the master and the sentinel readmits
            deadline = time.monotonic() + 10.0
            while not (rep.state == HealthState.HEALTHY
                       and rep.server.alive) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            s = r.stats()
            assert s["replicas"]["a"]["eject_cause"] == "quarantined"
            assert s["replicas"]["a"]["readmissions"] >= 1
            # the healed fleet's LIVE scrubber starts clean
            assert s["integrity"]["quarantined"] == []
            assert r(np.ones((1, 16), np.float32)) is not None
    finally:
        for sc in scrubbers:
            sc.stop()


def test_stats_during_quarantine_does_not_deadlock():
    # stats() takes the server's lock and then the scrubber's; the
    # quarantine takes the scrubber's and then the server's (``_die``).  A
    # reader of stats() racing the quarantine must get through: the
    # scrubber runs its callbacks with its own lock released
    pw = make_packed()
    srv = AccelServer(shared_exe(pw), max_batch=4, max_wait=0.001)
    probe = []

    def racing_reader(mismatch):
        th = threading.Thread(target=lambda: probe.append(srv.stats()))
        th.start()
        th.join(5.0)
        probe.append(th.is_alive())

    sc = Scrubber(pw, on_quarantine=racing_reader)
    srv.attach_scrubber(sc)
    stop, reads = threading.Event(), [0]

    def reader():
        while not stop.is_set():
            srv.stats()
            reads[0] += 1

    # daemon threads joined with a timeout: a deadlock fails the test and
    # leaves them blocked, rather than hanging the run
    srv.start()
    reader_th = threading.Thread(target=reader, daemon=True)
    scrub_th = threading.Thread(target=sc.scrub_once, daemon=True)
    reader_th.start()
    codes = next(r for r in pw.regions() if r.kind == "codes")
    BitFlipInjector(pw, seed=9).flip(region=codes)
    scrub_th.start()
    scrub_th.join(15.0)
    stop.set()
    reader_th.join(5.0)
    assert not scrub_th.is_alive() and not reader_th.is_alive()
    assert reads[0] > 0
    assert probe[-1] is False               # the racing reader finished
    assert probe[0]["integrity"]["quarantines"] == 1
    assert isinstance(srv.fatal, IntegrityError)
    assert srv.stats()["integrity"]["quarantines"] == 1
    srv.stop(drain=False, timeout=5.0)


def test_one_scrubber_over_a_buffer_kills_every_replica_at_detection():
    # the port's replicas read one live buffer, so one scrubber attached to
    # every replica's server is the buffer's only watcher: its first
    # detection is fatal to all of them at once, and the fleet counts it once
    pw = make_packed()
    sc = Scrubber(pw)
    servers = {}

    def factory(name):
        def build():
            srv = AccelServer(shared_exe(pw), max_batch=4, max_wait=0.001)
            srv.attach_scrubber(sc)
            servers[name] = srv
            return srv
        return build

    r = FleetRouter({n: factory(n) for n in ("a", "b", "c")},
                    probe_interval_s=0.01, heal_cooldown_s=10.0,
                    default_deadline_s=15.0)
    with r:
        assert r(np.ones((1, 16), np.float32)) is not None
        codes = next(rg for rg in pw.regions() if rg.kind == "codes")
        BitFlipInjector(pw, seed=10).flip(region=codes)
        sc.scrub_once()
        assert all(isinstance(srv.fatal, IntegrityError)
                   for srv in servers.values())
        deadline = time.monotonic() + 10.0
        while any(rep.eject_cause != "quarantined"
                  for rep in r.replicas.values()) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert {rep.eject_cause for rep in r.replicas.values()} \
            == {"quarantined"}
        integ = r.stats()["integrity"]
        assert integ["quarantines"] == 1 and integ["detected_flips"] == 1
        assert integ["quarantined"] == [codes.label()]


def test_fleet_canary_failure_names_the_eject():
    # semantic corruption: the replica stays alive and finite but answers
    # outside every captured fingerprint -> probe returns "canary"
    drift = {"on": False}

    def exe(x):
        out = np.asarray(x, np.float32) * 2.0
        return out + 1.0 if drift["on"] else out

    cs = CanarySet.capture({"p": lambda x: np.asarray(x, np.float32) * 2.0},
                           [(np.ones((1, 3), np.float32),)], k=1)
    r = FleetRouter({"a": lambda: AccelServer(exe, max_batch=4,
                                              max_wait=0.001)},
                    canaries=cs, probe_interval_s=0.01,
                    heal_cooldown_s=0.05, default_deadline_s=15.0)
    with r:
        rep = r.replicas["a"]
        assert r._probe(rep) is None
        drift["on"] = True
        assert r._probe(rep) == "canary"
        assert r.stats()["canary_failures"] >= 1
        with r._lock:
            rep.state = HealthState.SUSPECT    # make the sentinel probe it
        deadline = time.monotonic() + 10.0
        while rep.eject_cause != "canary" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rep.eject_cause == "canary"


# ---------------------------------------------------------------------------
# NaN/Inf output guard
# ---------------------------------------------------------------------------


def poison_marked(x):
    """NaN-poison exactly the rows whose marker column is 13 — batch
    neighbours stay clean, so the guard's per-request demux is observable."""
    out = np.asarray(x, np.float32) * 2.0
    out[np.asarray(x)[:, 0] == 13.0] = np.nan
    return out


def test_nan_guard_withholds_only_the_poisoned_request():
    srv = AccelServer(poison_marked, max_batch=8, max_wait=0.05)
    with srv:
        bad = srv.submit(np.full((1, 3), 13.0, np.float32))
        good = srv.submit(np.full((1, 3), 2.0, np.float32))
        assert float(srv.result(good, timeout=10)[0, 0]) == 4.0
        with pytest.raises(NumericalFault):
            srv.result(bad, timeout=10)
        s = srv.stats()
        assert s["numerical_faults"] == 1
        assert s["submitted"] == 2  # the clean neighbour was not withheld


def test_nan_guard_catches_inf_and_spares_integer_outputs():
    def exe(x):
        xs = np.asarray(x, np.float32)
        return np.where(xs[:, :1] == 13.0, np.inf, 1.0).astype(np.float32), \
            np.ones((xs.shape[0], 2), np.int32)

    srv = AccelServer(exe, max_batch=4, max_wait=0.001)
    with srv:
        with pytest.raises(NumericalFault):
            srv(np.full((1, 3), 13.0, np.float32))
        f, i = srv(np.zeros((1, 3), np.float32))
        assert float(f[0, 0]) == 1.0 and i.dtype == np.int32


# ---------------------------------------------------------------------------
# canaries + injector
# ---------------------------------------------------------------------------


def test_canary_check_accepts_any_point_fingerprint():
    pts = {"w8": lambda x: np.asarray(x) * 2.0,
           "w2": lambda x: np.asarray(x) * 2.0 + 0.5}
    cs = CanarySet.capture(pts, [(np.ones((1, 4), np.float32),),
                                 (np.full((1, 4), 3.0, np.float32),)], k=2)
    assert len(cs) == 2
    x0 = cs.inputs(0)[0]
    assert cs.check(0, x0 * 2.0)            # the W8 fingerprint
    assert cs.check(0, x0 * 2.0 + 0.5)      # a brownout downshift to W2
    assert not cs.check(0, x0 * 2.0 + 0.3)  # neither point: corruption
    assert not cs.check(0, np.full_like(x0, np.nan))   # non-finite fails
    assert cs.inputs(2)[0] is cs.inputs(0)[0]          # mod indexing
    with pytest.raises(ValueError):
        CanarySet.capture(pts, [], k=2)


def test_bit_flip_injector_is_seed_deterministic():
    recs = []
    for _ in range(2):
        pw = make_packed()
        inj = BitFlipInjector(pw, seed=42)
        recs.append([(r.region.label(), r.byte, r.bit)
                     for r in (inj.flip(i) for i in range(6))])
    assert recs[0] == recs[1]
    assert len({r[0] for r in recs[0]}) > 1     # spreads across regions


def test_bit_flip_injector_schedule_fires_once_and_validates():
    pw = make_packed()
    inj = BitFlipInjector(pw, flip_at=[3], seed=1, kinds=("view",))
    assert inj.maybe_flip(2) is None
    rec = inj.maybe_flip(3)
    assert rec is not None and rec.region.kind == "view"
    assert inj.maybe_flip(3) is None            # fire-once
    assert inj.injected_flips == 1
    with pytest.raises(ValueError):
        BitFlipInjector(pw, rate=1.5)
    with pytest.raises(ValueError):
        BitFlipInjector(pw, kinds=("codes", "bogus"))


# ---------------------------------------------------------------------------
# hardened deserialization
# ---------------------------------------------------------------------------


def good_point_dict():
    return {"name": "w8", "weight_bits": 8, "act_dtype": "bfloat16",
            "act_bits": None, "weight_bytes": 1000, "fifo_bytes": 64,
            "scratch_bytes": 32, "predicted_latency_s": 1e-3,
            "measured_latency_s": None, "agreement": 0.99}


@pytest.mark.parametrize("corrupt", [
    {"name": ""},                          # empty name
    {"name": 7},                           # wrong-typed name
    {"weight_bits": 0},                    # below minimum
    {"weight_bits": 4.5},                  # fractional
    {"weight_bytes": -1},                  # negative bytes
    {"weight_bytes": float("nan")},        # non-finite int field
    {"fifo_bytes": True},                  # bool is not an int here
    {"predicted_latency_s": float("inf")},  # non-finite float
    {"predicted_latency_s": None},         # required float missing
    {"agreement": "high"},                 # wrong-typed float
    {"measured_latency_s": -0.5},          # negative optional float
])
def test_pareto_point_rejects_corrupted_fields(corrupt):
    d = good_point_dict() | corrupt
    with pytest.raises(FrontFormatError):
        ParetoPoint.from_dict(d)


def test_pareto_front_round_trips_and_rejects_garbage():
    p = ParetoPoint.from_dict(good_point_dict())
    front = ParetoFront("g", [p])
    again = ParetoFront.from_json(front.to_json())
    assert len(again) == 1
    assert again.points[0].to_dict() == p.to_dict()
    with pytest.raises(FrontFormatError, match="'points' must be a list"):
        ParetoFront.from_dict(front.to_dict() | {"points": {"w8": {}}})
    with pytest.raises(FrontFormatError, match="must be a dict"):
        ParetoFront.from_dict(front.to_dict() | {"points": ["w8"]})


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _both(inits, with_views=True, align=PACK_ALIGN):
    """One PackedWeights per package from the same numpy initializers, with
    the W4/W2 views derived in the same order."""
    tw = PackedWeights.from_initializers(inits, "cpu")
    jw = j_pack.PackedWeights.from_initializers(inits)
    if with_views:
        for name in tw.tensors:
            for bits in (4, 2):
                tw.tensors[name].packed_view(bits, align)
                jw.tensors[name].packed_view(bits, align)
    return tw, jw


def _small_inits():
    rng = np.random.default_rng(0)
    return {"fc/w": rng.standard_normal((16, 24)).astype(np.float32),
            "out/w": rng.standard_normal((24, 8)).astype(np.float32)}


def _separable_inits():
    p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(0))
    return j_sep_to_ir(J_SEP, {k: np.asarray(v) for k, v in p.items()}
                       ).initializers


def _region_table(pw):
    return [(r.label(), r.kind, r.bits, r.align, r.nbytes,
             pw.tensors[r.tensor]._sealed_crc(r)) for r in pw.regions()]


@pytest.mark.parametrize("inits", [_small_inits, _separable_inits],
                         ids=["small", "separable-cnn"])
def test_regions_and_sealed_crcs_equal_the_reference(inits):
    tw, jw = _both(inits())
    # same list, same order: the injector's seeded draw indexes into it
    assert _region_table(tw) == _region_table(jw)
    for bits in (None, 8, 4, 2):
        assert [r.label() for r in tw.regions(bits)] == \
            [r.label() for r in jw.regions(bits)]


@pytest.mark.parametrize("kinds", [("codes", "view", "scale"), ("view",),
                                   ("codes",)])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_bit_flip_sequence_and_corrupted_bytes_equal_the_reference(seed,
                                                                   kinds):
    tw, jw = _both(_separable_inits())
    ti = BitFlipInjector(tw, seed=seed, kinds=kinds)
    ji = j_integrity.BitFlipInjector(jw, seed=seed, kinds=kinds)
    for step in range(6):
        tr, jr = ti.flip(step), ji.flip(step)
        assert (tr.step, tr.region.label(), tr.byte, tr.bit) == \
            (jr.step, jr.region.label(), jr.byte, jr.bit)
    # the flipped buffers hold the same bytes, so they hash the same
    assert _region_table(tw) == _region_table(jw)
    assert [(m.region.label(), m.expected_crc, m.actual_crc)
            for m in tw.verify()] == \
        [(m.region.label(), m.expected_crc, m.actual_crc)
         for m in jw.verify()]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_scrubber_telemetry_after_the_same_flips_equals_the_reference(seed):
    tw, jw = _both(_separable_inits())
    ti = BitFlipInjector(tw, rate=0.5, seed=seed)
    ji = j_integrity.BitFlipInjector(jw, rate=0.5, seed=seed)
    ts, js = Scrubber(tw), j_integrity.Scrubber(jw)
    for step in range(12):
        ti.maybe_flip(step)
        ji.maybe_flip(step)
        if step % 3 == 2:
            ts.scrub_once()
            js.scrub_once()
    assert ti.injected_flips == ji.injected_flips > 0
    assert ts.telemetry() == js.telemetry()
    assert ts.telemetry()["detected_flips"] > 0
    # repaired views are the reference's bytes again
    assert _region_table(tw) == _region_table(jw)


def test_rate_bounded_walk_equals_the_reference():
    tw, jw = _both(_separable_inits())
    tc, jc = FakeClock(), FakeClock()
    per_pass = Scrubber(tw).period_bytes()
    assert per_pass == j_integrity.Scrubber(jw).period_bytes()
    ts = Scrubber(tw, rate_bytes_s=per_pass / 3, clock=tc)
    js = j_integrity.Scrubber(jw, rate_bytes_s=per_pass / 3, clock=jc)
    for dt in (0.0, 0.2, 0.5, 0.05, 1.3, 0.7):
        tc.advance(dt)
        jc.advance(dt)
        assert ts._tick() == js._tick()
        assert (ts._cursor, ts.scrubbed_bytes) == (js._cursor,
                                                   js.scrubbed_bytes)
    assert ts.telemetry() == js.telemetry()


# ---------------------------------------------------------------------------
# the port's live buffers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["codes", "scale", "view"])
def test_flip_replaces_the_live_tensor_and_leaves_the_old_one(kind):
    pw = make_packed()
    region = next(r for r in pw.regions() if r.kind == kind)
    t = pw.tensors[region.tensor]
    old = t._buffer(region)
    before = old.clone()
    BitFlipInjector(pw, seed=11).flip(region=region)
    new = t._buffer(region)
    assert new is not old
    assert torch.equal(old, before)      # a queued reader still sees it whole
    assert (new.dtype, new.shape, new.device) == (old.dtype, old.shape,
                                                  old.device)
    diff = np.bitwise_xor(to_numpy(new).reshape(-1).view(np.uint8),
                          to_numpy(old).reshape(-1).view(np.uint8))
    assert int(np.unpackbits(diff).sum()) == 1


def test_batch_running_at_quarantine_is_withheld():
    # the executable reads the live master codes, so the flip reaches its
    # result; the scrubber detects it while the batch runs, and the ticket
    # must resolve to the fatal error, never to the corrupted rows
    pw = make_packed()
    sc = Scrubber(pw)
    codes = next(r for r in pw.regions() if r.kind == "codes")
    inner = shared_exe(pw)
    fired = []

    def exe(x):
        if not fired:
            fired.append(BitFlipInjector(pw, seed=12).flip(region=codes))
        out = inner(x)                  # computed from the flipped codes
        sc.scrub_once()                 # detection while the batch runs
        return out

    srv = AccelServer(exe, max_batch=4, max_wait=0.001)
    srv.attach_scrubber(sc)
    tk = srv.submit(np.ones((1, 16), np.float32))
    srv.pump(flush=True)       # dispatch, detection, then the batch's finish
    with pytest.raises(RuntimeError) as ei:
        srv.result(tk)
    assert isinstance(srv.fatal, IntegrityError)
    assert isinstance(ei.value.__cause__, IntegrityError)
    assert srv.stats()["executed_batches"] == 0


def test_no_batch_finishes_after_quarantine_under_contention():
    # stress: 8 submitters (more than this box's cores) keep a pumped server
    # busy while a master-code flip is scrubbed mid-traffic, with a short
    # thread switch interval; the server must finish no batch after the
    # scrubber's detection, and every ticket must resolve
    import sys
    pw = make_packed()
    sc = Scrubber(pw)
    inner = shared_exe(pw)

    def exe(x):
        time.sleep(0.002)                   # keep batches in flight
        return inner(x)

    srv = AccelServer(exe, max_batch=4, max_wait=0.0005)
    srv.attach_scrubber(sc)
    at_detection = []
    sc.add_on_quarantine(lambda m: at_detection.append(srv.executed_batches))
    outcomes, stop = [], threading.Event()

    def submitter():
        while not stop.is_set():
            try:
                tk = srv.submit(np.ones((1, 16), np.float32))
            except RuntimeError:
                return                      # dead server refuses new work
            try:
                srv.result(tk, timeout=10)
                outcomes.append("served")
            except RuntimeError:
                outcomes.append("failed")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with srv:
            threads = [threading.Thread(target=submitter) for _ in range(8)]
            for th in threads:
                th.start()
            time.sleep(0.2)
            codes = next(r for r in pw.regions() if r.kind == "codes")
            BitFlipInjector(pw, seed=13).flip(region=codes)
            sc.scrub_once()
            time.sleep(0.2)
            stop.set()
            for th in threads:
                th.join(10.0)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert isinstance(srv.fatal, IntegrityError)
    assert at_detection == [srv.executed_batches]
    assert "served" in outcomes
