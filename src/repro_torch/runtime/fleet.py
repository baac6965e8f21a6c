"""Fault-tolerant replicated serving: a front-end router over N AccelServers
(counterpart of ``repro.runtime.fleet``).

:class:`FleetRouter` fronts N :class:`~repro_torch.runtime.serve.AccelServer`
replicas (each with its own pump thread, all serving point executables over
the SAME shared :class:`~repro_torch.quant.pack.PackedWeights` buffer on the
card) and makes the ensemble survive replica death, hangs, latency spikes
and weight-memory corruption without losing a ticket:

* **health layer** — per-replica heartbeat probes plus EWMA latency/error
  scoring drive a :class:`HealthState` machine (healthy -> suspect ->
  ejected -> probing -> readmitted), with
  :class:`~repro_torch.runtime.ft.StragglerWatchdog` flagging latency spikes;
* **failure handling** — per-request deadline budgets, bounded retries with
  exponential backoff + jitter routed to a *different* replica, optional
  tail-latency hedging (first result wins, the loser is ``drop()``-ed), and
  a per-replica :class:`CircuitBreaker` that sheds load instead of queueing
  onto a dead pump;
* **graceful degradation** — a fleet-level
  :class:`~repro_torch.core.adaptive.BrownoutSelector` walks every replica
  down the W8 -> W4 -> W2 ladder together when aggregate p95 or backlog
  crosses the :class:`~repro_torch.core.adaptive.ServiceObjective`;
* **integrity** — a replica whose attached
  :class:`~repro_torch.runtime.integrity.Scrubber` quarantined the weights
  dies with an :class:`~repro_torch.runtime.integrity.IntegrityError` and is
  ejected ``quarantined``; semantic
  :class:`~repro_torch.runtime.integrity.CanarySet` probes eject ``canary``;
* **chaos layer** — :class:`ChaosExecutable` wraps any point executable to
  deterministically inject delays, exceptions and pump-killing crashes.

Every submitted request resolves — to its output, or to a *typed* failure
(:class:`RequestFailed`, :class:`DeadlineExceeded`,
:class:`NoReplicaAvailable`) — never to a silent hang.  The router is host
code; the device work is the replicas' executables.
"""
from __future__ import annotations

import enum
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core.adaptive import BrownoutSelector
from repro_torch.runtime.ft import FailureInjector, StragglerWatchdog
from repro_torch.runtime.integrity import CanarySet, IntegrityError
from repro_torch.runtime.scheduler import QueueFull
from repro_torch.runtime.serve import AccelServer, Ticket

__all__ = [
    "ChaosExecutable", "CircuitBreaker", "DeadlineExceeded", "FleetRouter",
    "FleetTicket", "HealthState", "NoReplicaAvailable", "Replica",
    "ReplicaCrash", "RequestFailed",
]


# ---------------------------------------------------------------------------
# typed outcomes — a fleet ticket resolves to a value or to ONE of these
# ---------------------------------------------------------------------------

class FleetError(RuntimeError):
    """Base class of every typed fleet-level failure."""


class NoReplicaAvailable(FleetError):
    """No routable replica (all ejected, breaker-open, or queue-full):
    the router sheds the request instead of queueing onto a dead pump."""


class DeadlineExceeded(FleetError):
    """The request's deadline budget ran out across all attempts."""


class RequestFailed(FleetError):
    """Every attempt failed and the retry budget is exhausted; the last
    replica error is chained as ``__cause__``."""


class ReplicaCrash(BaseException):
    """Chaos: raised from inside an executable to KILL the replica's pump.

    Deliberately a ``BaseException`` so it escapes the pump's per-batch
    ``except Exception`` containment and triggers the fatal pump-death path
    (every outstanding ticket on that replica resolves with the error) —
    exactly what a segfaulting device runtime would do to a real host.
    """


# ---------------------------------------------------------------------------
# chaos layer
# ---------------------------------------------------------------------------

class ChaosExecutable:
    """Wrap any (point) executable with a deterministic fault schedule.

    Faults come from a generalized :class:`~repro_torch.runtime.ft.FailureInjector`
    (fire-once ``fail_at`` steps, seeded ``rate`` failures, ``delay_at`` /
    ``delay_rate`` latency injection) plus ``crash_at``: call indices that
    raise :class:`ReplicaCrash` and kill the whole pump thread.  The call
    counter is shared across every wrapper holding the same ``counter``
    list, so one schedule can span a replica's W8/W4/W2 point executables.

    Telemetry attributes of the wrapped executable (``bits``, ``packed``,
    ``cached_batches``, ``telemetry`` ...) pass through untouched.
    """

    def __init__(self, inner: Callable, injector: Optional[FailureInjector]
                 = None, *, crash_at: Sequence[int] = (),
                 counter: Optional[List[int]] = None):
        self.inner = inner
        self.injector = injector or FailureInjector()
        self.crash_at = set(crash_at)
        self.crashed: Set[int] = set()
        self.counter = counter if counter is not None else [0]
        self._lock = threading.Lock()

    def __call__(self, *args):
        with self._lock:
            step = self.counter[0]
            self.counter[0] += 1
            crash = step in self.crash_at and step not in self.crashed
            if crash:
                self.crashed.add(step)
        self.injector.maybe_delay(step)
        if crash:
            raise ReplicaCrash(f"injected pump crash at call {step}")
        self.injector.maybe_fail(step)
        return self.inner(*args)

    @property
    def calls(self) -> int:
        return self.counter[0]

    def __getattr__(self, item):
        # only reached for attributes not set on the wrapper: delegate the
        # executable telemetry surface (bits, packed, cached_batches, ...)
        return getattr(self.inner, item)


# ---------------------------------------------------------------------------
# health layer
# ---------------------------------------------------------------------------

class HealthState(enum.Enum):
    HEALTHY = "healthy"    # full traffic
    SUSPECT = "suspect"    # routable but deprioritized; probed by sentinel
    EJECTED = "ejected"    # no traffic; healed + probed after cooldown
    PROBING = "probing"    # rebuilt/suspect replica awaiting probe verdict


@dataclass
class CircuitBreaker:
    """Per-replica breaker: ``threshold`` consecutive failures open it; an
    open breaker sheds routing for ``cooldown_s``, then half-opens to let a
    trickle through — one success closes it, one failure re-opens it."""
    threshold: int = 3
    cooldown_s: float = 0.25
    clock: Callable[[], float] = time.monotonic
    failures: int = 0
    opened_at: Optional[float] = None
    half_open: bool = False
    trips: int = 0

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None
        self.half_open = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.opened_at is None:
            if self.failures >= self.threshold:
                self.opened_at = self.clock()
                self.trips += 1
        elif self.half_open:
            self.opened_at = self.clock()   # probe failed: re-open
            self.half_open = False

    @property
    def open(self) -> bool:
        return self.opened_at is not None and not self.half_open and \
            self.clock() - self.opened_at < self.cooldown_s

    def allows(self) -> bool:
        if self.opened_at is None:
            return True
        if self.clock() - self.opened_at >= self.cooldown_s:
            self.half_open = True   # cooldown over: let probes through
            return True
        return False


EWMA_ALPHA = 0.25        # latency / error-rate smoothing
ERR_SUSPECT = 0.5        # error EWMA above this marks a replica suspect


class Replica:
    """One AccelServer replica plus its health bookkeeping.

    Mutable health state is guarded by the router lock; the server itself
    has its own locking."""

    def __init__(self, name: str, factory: Callable[[], AccelServer], *,
                 breaker: Optional[CircuitBreaker] = None,
                 straggler_factor: float = 3.0):
        self.name = name
        self.factory = factory
        self.server: Optional[AccelServer] = None
        self.state = HealthState.HEALTHY
        self.breaker = breaker or CircuitBreaker()
        self.watchdog = StragglerWatchdog(factor=straggler_factor)
        self.lat_ewma: Optional[float] = None
        self.err_ewma = 0.0
        self.outstanding = 0
        self.steps = 0
        self.served = 0
        self.failures = 0
        self.ejections = 0
        self.readmissions = 0
        self.generation = 0      # how many times the server was (re)built
        self.ejected_at: Optional[float] = None
        self.eject_cause: Optional[str] = None   # why the LAST ejection fired

    # -- scoring (caller holds the router lock) ------------------------------
    def record_success(self, latency_s: float) -> bool:
        """Feed one successful request; returns True when the watchdog
        flagged it as a straggler sample."""
        self.served += 1
        self.lat_ewma = (latency_s if self.lat_ewma is None else
                         (1 - EWMA_ALPHA) * self.lat_ewma
                         + EWMA_ALPHA * latency_s)
        self.err_ewma *= (1 - EWMA_ALPHA)
        self.breaker.record_success()
        self.steps += 1
        return self.watchdog.observe(self.steps, latency_s)

    def record_failure(self) -> None:
        self.failures += 1
        self.err_ewma = (1 - EWMA_ALPHA) * self.err_ewma + EWMA_ALPHA
        self.breaker.record_failure()

    def routable(self) -> bool:
        return (self.state in (HealthState.HEALTHY, HealthState.SUSPECT)
                and self.server is not None and self.server.alive
                and self.breaker.allows())

    def snapshot(self) -> Dict[str, Any]:
        srv = self.server
        return {
            "state": self.state.value,
            "lat_ewma_s": self.lat_ewma,
            "err_ewma": round(self.err_ewma, 4),
            "outstanding": self.outstanding,
            "served": self.served,
            "failures": self.failures,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "generation": self.generation,
            "eject_cause": self.eject_cause,
            "breaker": {"open": self.breaker.open,
                        "trips": self.breaker.trips},
            "straggler_flags": len(self.watchdog.flagged),
            "alive": bool(srv is not None and srv.alive),
            "queue_depth": (srv.queue_depth()
                            if srv is not None and srv.fatal is None else 0),
        }


# ---------------------------------------------------------------------------
# request lifecycle
# ---------------------------------------------------------------------------

@dataclass
class _Attempt:
    """One in-flight submission.  ``server`` is the exact AccelServer
    instance the ticket was submitted to: a replica may be healed (rebuilt)
    while the attempt is outstanding, and the fresh server restarts its rid
    counter — settling against ``replica.server`` could then claim or drop
    an UNRELATED request's result on the new generation."""
    replica: Replica
    server: AccelServer
    ticket: Ticket
    t0: float
    hedge: bool = False


class FleetTicket:
    """Future-style handle for one fleet request.

    ``result()`` drives failover in the calling thread: it waits on the
    current attempt, retries failures on a different replica (bounded, with
    backoff), hedges stragglers, and ALWAYS terminates by the request
    deadline — returning the output or raising a typed fleet error."""

    __slots__ = ("rid", "inputs", "budget", "tenant", "deadline", "_router",
                 "live", "attempts", "hedges", "retries_left", "_terminal",
                 "_claimed", "_resolving", "_result_value")

    def __init__(self, router: "FleetRouter", rid: int, inputs: tuple,
                 budget: float, tenant: str, deadline: float):
        self.rid = rid
        self.inputs = inputs
        self.budget = budget
        self.tenant = tenant
        self.deadline = deadline
        self._router = router
        self.live: List[_Attempt] = []
        self.attempts = 0
        self.hedges = 0
        self.retries_left = router.retries
        self._terminal: Optional[Exception] = None
        self._claimed = False
        self._resolving = False

    def done(self) -> bool:
        return (self._terminal is not None or self._claimed
                or any(a.ticket.done() for a in self.live))

    def result(self, timeout: Optional[float] = None):
        return self._router.result(self, timeout=timeout)

    def __repr__(self) -> str:
        state = ("failed" if self._terminal is not None else
                 "claimed" if self._claimed else
                 f"pending({len(self.live)} attempts)")
        return f"FleetTicket(rid={self.rid}, {state})"


class FleetRouter:
    """Health-checked, failover-routing front end over N AccelServer replicas.

    ``replicas`` maps replica names to zero-argument factories building a
    ready-to-start :class:`~repro_torch.runtime.serve.AccelServer` (each replica's
    point executables should read the ONE shared
    :class:`~repro_torch.quant.pack.PackedWeights` buffer — replication multiplies
    pumps, not weight memory).  The factory is re-invoked to *heal* a
    replica whose pump died, so it must be safe to call repeatedly.

    A sentinel thread heartbeats the fleet every ``probe_interval_s``:
    suspect replicas are probed (``probe`` inputs, served end-to-end) and
    readmitted on success; ejected replicas are healed (rebuilt when their
    pump died) after ``heal_cooldown_s`` and probed back in; the aggregate
    queue depth feeds the shared ``brownout`` selector, which every
    replica's tenant consults — the whole fleet walks the precision ladder
    together.
    """

    def __init__(self, replicas: Dict[str, Callable[[], AccelServer]], *,
                 brownout: Optional[BrownoutSelector] = None,
                 retries: int = 2,
                 backoff_s: float = 0.01,
                 backoff_jitter: float = 0.5,
                 hedge_after_s: Optional[float] = None,
                 default_deadline_s: float = 30.0,
                 probe: Optional[Sequence[Any]] = None,
                 canaries: Optional[CanarySet] = None,
                 probe_interval_s: float = 0.05,
                 probe_timeout_s: float = 2.0,
                 heal_cooldown_s: float = 0.25,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 0.25,
                 straggler_factor: float = 3.0,
                 seed: int = 0):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        if retries < 0:
            raise ValueError("retries must be >= 0")
        if default_deadline_s <= 0:
            raise ValueError("default_deadline_s must be > 0")
        self.replicas: Dict[str, Replica] = {
            name: Replica(name, factory,
                          breaker=CircuitBreaker(threshold=breaker_threshold,
                                                 cooldown_s=breaker_cooldown_s),
                          straggler_factor=straggler_factor)
            for name, factory in replicas.items()}
        self.brownout = brownout
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_jitter = backoff_jitter
        self.hedge_after_s = hedge_after_s
        self.default_deadline_s = default_deadline_s
        self.probe_inputs = tuple(probe) if probe is not None else None
        # semantic canaries: probes with known-good expected outputs (any
        # working point's fingerprint within tolerance passes) — corruption
        # the checksums can't see becomes eject-worthy
        self.canaries = canaries
        if canaries is not None and self.probe_inputs is None:
            self.probe_inputs = canaries.inputs(0)
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.heal_cooldown_s = heal_cooldown_s
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._rids = 0
        self._running = False
        self._sentinel: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._rr = 0                       # round-robin tiebreak cursor
        # fleet counters
        self.submitted = 0
        self.succeeded = 0
        self.failed = 0
        self.retried = 0
        self.hedged = 0
        self.hedge_wins = 0
        self.shed = 0
        self.deadlines_exceeded = 0
        self.probes = 0
        self.canary_failures = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetRouter":
        with self._lock:
            if self._running:
                raise RuntimeError("fleet router already running")
            for rep in self.replicas.values():
                if rep.server is None or not rep.server.alive:
                    self._build_server(rep)
            self._running = True
            self._stop_evt.clear()
            self._sentinel = threading.Thread(
                target=self._sentinel_loop, name="fleet-sentinel", daemon=True)
            self._sentinel.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 10.0) -> None:
        with self._lock:
            if not self._running:
                return
            self._running = False
            self._stop_evt.set()
            sentinel = self._sentinel
            self._sentinel = None
        if sentinel is not None:
            sentinel.join(timeout)
        for rep in self.replicas.values():
            srv = rep.server
            if srv is None:
                continue
            try:
                srv.stop(drain=drain, timeout=timeout)
            except RuntimeError:
                # a wedged or already-dead pump: its tickets were resolved
                # with typed errors by AccelServer.stop / _die
                pass

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    def _build_server(self, rep: Replica) -> None:
        """(Re)build and start a replica's server (caller holds the lock)."""
        srv = rep.factory()
        if self.brownout is not None:
            for tenant in srv.tenants:
                srv.set_selector(self.brownout, tenant=tenant)
        srv.start()
        rep.server = srv
        rep.generation += 1

    # -- routing -------------------------------------------------------------
    def _route(self, exclude: Set[str] = frozenset()) -> Optional[Replica]:
        """Pick the routing target (caller holds the lock): healthy before
        suspect, then least outstanding, then lowest latency EWMA, with a
        rotating tiebreak so equal replicas share load."""
        names = list(self.replicas)
        candidates = []
        for i, name in enumerate(names):
            rep = self.replicas[name]
            if name in exclude or not rep.routable():
                continue
            rank = (rep.state != HealthState.HEALTHY, rep.outstanding,
                    rep.lat_ewma or 0.0, (i - self._rr) % len(names))
            candidates.append((rank, rep))
        if not candidates:
            return None
        rep = min(candidates, key=lambda c: c[0])[1]
        self._rr = (self._rr + 1) % len(names)
        return rep

    def _dispatch(self, ft: FleetTicket, exclude: Set[str] = frozenset(),
                  hedge: bool = False) -> _Attempt:
        """Route + submit one attempt; raises NoReplicaAvailable when every
        routable replica rejected it (shed, not queued).

        ``exclude`` is a soft preference (avoid the replica that just
        failed); it is relaxed once when nobody else is routable.  A replica
        that REJECTED during this dispatch pass (queue-full / dead pump) is
        a hard exclusion — it is never re-tried within the pass, so a fleet
        whose every queue is full sheds instead of busy-spinning."""
        tried: Set[str] = set()      # hard: rejected during THIS pass
        avoid = set(exclude)         # soft: retry-ring preference
        while True:
            with self._lock:
                rep = self._route(tried | avoid)
                if rep is None and avoid:
                    avoid = set()                 # any port in a storm
                    rep = self._route(tried)
                # bind to the exact server instance we submit to: rep.server
                # may be swapped by a heal while this attempt is in flight
                srv = rep.server if rep is not None else None
            if rep is None or srv is None:
                raise NoReplicaAvailable(
                    f"no routable replica (states: "
                    f"{ {n: r.state.value for n, r in self.replicas.items()} })")
            try:
                tk = srv.submit(*ft.inputs, budget=ft.budget,
                                tenant=ft.tenant)
            except QueueFull:
                tried.add(rep.name)           # backpressure: try a sibling
                continue
            except RuntimeError:
                # dead pump hit between health checks: score + try a sibling
                with self._lock:
                    rep.record_failure()
                    if rep.server is srv and srv.fatal is not None:
                        self._eject(rep, cause=self._fatal_cause(srv))
                tried.add(rep.name)
                continue
            with self._lock:
                rep.outstanding += 1
                att = _Attempt(rep, srv, tk, time.monotonic(), hedge)
                ft.live.append(att)
                ft.attempts += 1
                if hedge:
                    ft.hedges += 1
                    self.hedged += 1
            return att

    # -- request lifecycle ---------------------------------------------------
    def submit(self, *inputs, budget: float = 1.0,
               deadline_s: Optional[float] = None,
               tenant: str = "default") -> FleetTicket:
        """Route one request to a replica; returns a :class:`FleetTicket`.

        Raises :class:`NoReplicaAvailable` when the whole fleet is
        unroutable (typed load shedding — nothing is queued onto dead
        pumps)."""
        with self._lock:
            if not self._running:
                raise RuntimeError(
                    "fleet router is not running; start() it first")
            rid = self._rids
            self._rids += 1
        ft = FleetTicket(self, rid, tuple(inputs), budget, tenant,
                         time.monotonic()
                         + (deadline_s if deadline_s is not None
                            else self.default_deadline_s))
        try:
            self._dispatch(ft)
        except NoReplicaAvailable:
            with self._lock:
                self.shed += 1
            raise
        with self._lock:
            self.submitted += 1
        return ft

    def _settle_attempts(self, ft: FleetTicket, keep: Optional[_Attempt]
                         ) -> None:
        """Drop every live attempt except ``keep`` (hedge losers, deadline
        cleanup).  Caller holds the lock."""
        for att in ft.live:
            if att is keep:
                continue
            att.replica.outstanding = max(0, att.replica.outstanding - 1)
            try:
                # always the server the ticket was SUBMITTED to — a healed
                # replica's fresh server reuses rids for other requests
                att.server.drop(att.ticket)
            except Exception:           # dead server: nothing left to drop
                pass
        ft.live = [keep] if keep is not None else []

    def _terminate(self, ft: FleetTicket, err: Exception) -> None:
        with self._lock:
            self._settle_attempts(ft, None)
            ft._terminal = err
            self.failed += 1
            if isinstance(err, DeadlineExceeded):
                self.deadlines_exceeded += 1

    def result(self, ticket: FleetTicket, timeout: Optional[float] = None):
        """Resolve one fleet ticket: the output rows, or a typed error.

        Runs the failover loop in the calling thread — bounded waits, retry
        on a different replica with backoff+jitter, optional hedging — and
        is GUARANTEED to return or raise by ``min(deadline, timeout)``:
        a fleet ticket can time out (claimable again later) but never hang.

        Single consumption, like AccelServer: a second ``result()`` call —
        after a claim OR concurrently with another resolving thread —
        raises ``KeyError`` rather than racing on the attempt list.
        """
        ft = ticket
        with self._lock:
            if ft._terminal is not None:
                raise ft._terminal
            if ft._claimed or ft._resolving:
                raise KeyError(ft.rid)
            ft._resolving = True
        try:
            return self._resolve(ft, timeout)
        finally:
            # a TimeoutError exit leaves the ticket claimable again; a
            # claim / terminal exit is already recorded on the ticket
            ft._resolving = False

    def _resolve(self, ft: FleetTicket, timeout: Optional[float]):
        caller_deadline = (None if timeout is None
                           else time.monotonic() + timeout)
        while True:
            now = time.monotonic()
            if now >= ft.deadline:
                self._terminate(ft, DeadlineExceeded(
                    f"fleet request {ft.rid} exceeded its deadline after "
                    f"{ft.attempts} attempt(s)"))
                raise ft._terminal
            if caller_deadline is not None and now >= caller_deadline:
                raise TimeoutError(
                    f"fleet request {ft.rid} not served within {timeout}s "
                    "(ticket still claimable)")
            att = next((a for a in ft.live if a.ticket.done()), None)
            if att is not None:
                if self._settle_one(ft, att, now):
                    return self._claim(ft)
                continue           # failure consumed: retry was dispatched
            if (self.hedge_after_s is not None and len(ft.live) == 1
                    and ft.hedges == 0
                    and now - ft.live[0].t0 >= self.hedge_after_s):
                try:
                    self._dispatch(ft, exclude={ft.live[0].replica.name},
                                   hedge=True)
                except NoReplicaAvailable:
                    ft.hedges = 1      # nobody to hedge to: don't retry it
            remaining = ft.deadline - now
            if caller_deadline is not None:
                remaining = min(remaining, caller_deadline - now)
            if self.hedge_after_s is not None and len(ft.live) == 1 \
                    and ft.hedges == 0:
                remaining = min(
                    remaining, self.hedge_after_s - (now - ft.live[0].t0))
            if ft.live:
                # waits on the newest attempt but re-polls every slice so a
                # sibling attempt's resolution is seen promptly
                ft.live[-1].ticket.wait(min(max(remaining, 0.0), 0.005))
            else:
                # no live attempt (all replicas rejected a retry): re-try
                # dispatch until the deadline shuts the request down
                try:
                    self._dispatch(ft)
                except NoReplicaAvailable as e:
                    if ft.retries_left <= 0:
                        self._terminate(ft, RequestFailed(
                            f"fleet request {ft.rid} found no replica after "
                            f"{ft.attempts} attempt(s)"))
                        raise ft._terminal from e
                    ft.retries_left -= 1
                    self._stop_evt.wait(min(0.005, max(remaining, 0.0)))

    def _settle_one(self, ft: FleetTicket, att: _Attempt, now: float) -> bool:
        """Claim one resolved attempt.  True -> success (value stashed in
        ``ft``); False -> failure consumed and, when budget allows, a retry
        dispatched."""
        rep = att.replica
        try:
            val = att.server.result(att.ticket, timeout=self.probe_timeout_s)
        except TimeoutError:
            return False               # raced done(): just poll again
        except Exception as e:
            with self._lock:
                rep.outstanding = max(0, rep.outstanding - 1)
                ft.live.remove(att)
                rep.record_failure()
                # eject only when the CURRENT server is the one that died —
                # a failure from a pre-heal generation must not eject the
                # freshly rebuilt replica
                if rep.server is att.server and att.server.fatal is not None:
                    self._eject(rep, cause=self._fatal_cause(att.server))
                elif (rep.err_ewma > ERR_SUSPECT or rep.breaker.open) \
                        and rep.state == HealthState.HEALTHY:
                    rep.state = HealthState.SUSPECT
                can_retry = ft.retries_left > 0 and not ft.live
            if ft.live:
                return False           # a hedge sibling is still running
            if not can_retry:
                self._terminate(ft, RequestFailed(
                    f"fleet request {ft.rid} failed after {ft.attempts} "
                    f"attempt(s): {e}"))
                raise ft._terminal from e
            ft.retries_left -= 1
            with self._lock:
                self.retried += 1
            backoff = self.backoff_s * (2 ** (ft.attempts - 1))
            backoff *= 1.0 + self.backoff_jitter * self._rng.random()
            self._stop_evt.wait(min(backoff, max(ft.deadline - now, 0.0)))
            try:
                self._dispatch(ft, exclude={rep.name})
            except NoReplicaAvailable as e2:
                self._terminate(ft, RequestFailed(
                    f"fleet request {ft.rid} failed and no replica was "
                    f"available to retry: {e}"))
                raise ft._terminal from e2
            return False
        # success
        with self._lock:
            rep.outstanding = max(0, rep.outstanding - 1)
            ft.live.remove(att)
            self._settle_attempts(ft, None)    # drop hedge losers
            slow = rep.record_success(now - att.t0)
            if slow and rep.state == HealthState.HEALTHY:
                rep.state = HealthState.SUSPECT   # latency spike: watch it
            if rep.state == HealthState.PROBING:
                self._readmit(rep)
            elif rep.state == HealthState.SUSPECT and not rep.breaker.open \
                    and rep.err_ewma < ERR_SUSPECT / 2:
                rep.state = HealthState.HEALTHY
            if att.hedge:
                self.hedge_wins += 1
            self.succeeded += 1
        ft._result_value = val
        return True

    def _claim(self, ft: FleetTicket):
        val = ft._result_value
        del ft._result_value
        ft._claimed = True
        return val

    def drop(self, ticket: FleetTicket) -> None:
        """Release an abandoned fleet ticket: every live attempt is dropped
        on its replica so no output stays resident."""
        with self._lock:
            self._settle_attempts(ticket, None)
            ticket._terminal = RequestFailed(
                f"fleet request {ticket.rid} was dropped")

    def __call__(self, *inputs, budget: float = 1.0,
                 deadline_s: Optional[float] = None, tenant: str = "default"):
        return self.result(self.submit(*inputs, budget=budget,
                                       deadline_s=deadline_s, tenant=tenant))

    # -- health machine ------------------------------------------------------
    @staticmethod
    def _fatal_cause(srv: Optional[AccelServer]) -> str:
        """Name a dead pump's ejection: ``quarantined`` when the scrubber's
        typed IntegrityError killed it (weight-memory corruption), else the
        generic ``dead-pump``."""
        if srv is not None and isinstance(srv.fatal, IntegrityError):
            return "quarantined"
        return "dead-pump"

    def _eject(self, rep: Replica, cause: str = "dead-pump") -> None:
        """Caller holds the lock."""
        if rep.state != HealthState.EJECTED:
            rep.state = HealthState.EJECTED
            rep.ejections += 1
            rep.eject_cause = cause
        rep.ejected_at = time.monotonic()

    def _readmit(self, rep: Replica) -> None:
        """Caller holds the lock."""
        rep.state = HealthState.HEALTHY
        rep.readmissions += 1
        rep.err_ewma = 0.0
        rep.ejected_at = None
        rep.breaker.record_success()

    def _probe(self, rep: Replica) -> Optional[str]:
        """Serve one probe request end-to-end through the replica (outside
        the router lock — probes ride the real request path).  Returns None
        on success, or the failure cause: ``probe`` (the request errored)
        or ``canary`` (it answered, but outside every working point's
        captured fingerprint — semantic corruption)."""
        srv = rep.server
        if srv is None or not srv.alive:
            return "probe"
        with self._lock:
            self.probes += 1
            idx = self.probes - 1
        if self.probe_inputs is None and self.canaries is None:
            return None                 # aliveness-only probe
        inputs = (self.canaries.inputs(idx) if self.canaries is not None
                  else self.probe_inputs)
        tk = None
        try:
            tk = srv.submit(*inputs)
            val = srv.result(tk, timeout=self.probe_timeout_s)
        except Exception:
            if tk is not None:
                try:
                    # release the canary so repeated probes of a persistently
                    # suspect replica never accumulate unclaimed results
                    srv.drop(tk)
                except Exception:       # dead server / already consumed
                    pass
            return "probe"
        if self.canaries is not None and not self.canaries.check(idx, val):
            with self._lock:
                self.canary_failures += 1
            return "canary"
        return None

    def _sentinel_loop(self) -> None:
        while not self._stop_evt.wait(self.probe_interval_s):
            self._sentinel_tick()

    def _sentinel_tick(self) -> None:
        """One heartbeat pass: detect dead pumps, heal + probe ejected
        replicas after cooldown, probe suspects, feed the brownout backlog."""
        now = time.monotonic()
        with self._lock:
            reps = list(self.replicas.values())
        for rep in reps:
            with self._lock:
                srv = rep.server
                dead = srv is None or srv.fatal is not None or not srv.alive
                if dead and rep.state not in (HealthState.EJECTED,
                                              HealthState.PROBING):
                    self._eject(rep, cause=self._fatal_cause(srv))
                state, ejected_at = rep.state, rep.ejected_at
            if state == HealthState.EJECTED:
                if ejected_at is None or now - ejected_at < self.heal_cooldown_s:
                    continue
                with self._lock:
                    if rep.server is None or not rep.server.alive:
                        try:
                            self._build_server(rep)    # heal: fresh pump
                        except Exception:
                            rep.ejected_at = time.monotonic()
                            continue
                    rep.state = HealthState.PROBING
                state = HealthState.PROBING
            if state in (HealthState.PROBING, HealthState.SUSPECT):
                cause = self._probe(rep)
                ok = cause is None
                with self._lock:
                    if ok and rep.state == HealthState.PROBING:
                        self._readmit(rep)
                    elif ok and rep.state == HealthState.SUSPECT \
                            and not rep.breaker.open:
                        rep.state = HealthState.HEALTHY
                    elif not ok:
                        rep.record_failure()
                        srv2 = rep.server
                        if srv2 is None or srv2.fatal is not None:
                            # the pump died under the probe: name the death,
                            # not the probe (quarantined beats probe)
                            cause = self._fatal_cause(srv2)
                        self._eject(rep, cause=cause)
        if self.brownout is not None:
            depth = 0
            for rep in reps:
                srv = rep.server
                if srv is not None and srv.fatal is None:
                    depth += srv.queue_depth()
            self.brownout.observe_depth(depth)

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Fleet counters, per-replica health snapshots, and the brownout
        trajectory (when a shared selector is attached)."""
        with self._lock:
            resolved = self.succeeded + self.failed
            s: Dict[str, Any] = {
                "running": self._running,
                "submitted": self.submitted,
                "succeeded": self.succeeded,
                "failed": self.failed,
                "retries": self.retried,
                "hedges": self.hedged,
                "hedge_wins": self.hedge_wins,
                "shed": self.shed,
                "deadlines_exceeded": self.deadlines_exceeded,
                "probes": self.probes,
                "canary_failures": self.canary_failures,
                "availability": (self.succeeded / resolved if resolved
                                 else 1.0),
                "replicas": {n: r.snapshot()
                             for n, r in self.replicas.items()},
            }
            # aggregate weight-memory integrity telemetry across every
            # replica server with an attached scrubber; a scrubber shared by
            # several replicas (one per buffer) counts once
            scrubs = list({id(rep.server.scrubber): rep.server.scrubber
                           for rep in self.replicas.values()
                           if rep.server is not None
                           and rep.server.scrubber is not None}.values())
        if scrubs:
            tels = [sc.telemetry() for sc in scrubs]
            s["integrity"] = {
                key: sum(t[key] for t in tels)
                for key in ("scrubbed_bytes", "scrub_passes",
                            "detected_flips", "repaired_views",
                            "quarantines")}
            s["integrity"]["quarantined"] = sorted(
                {lbl for t in tels for lbl in t["quarantined"]})
        if self.brownout is not None:
            s["brownout"] = self.brownout.telemetry()
        return s
