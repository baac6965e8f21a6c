"""Batch-coalescing request scheduler for the accelerator serving runtime
(the port's own copy of ``repro.runtime.scheduler``, which uses no framework).

One compiled streaming accelerator serves an evolving request stream (the
paper's CPS story): requests of varying leading-dim sizes arrive
asynchronously, and the scheduler packs them into batches executed through a
batch-polymorphic :class:`~repro_torch.core.writers.torch_writer.BatchedExecutable`.

Three cooperating pieces:

* :class:`CoalescingScheduler` — a bounded FIFO request queue plus the packing
  rule: pop requests in arrival order while the running total stays within
  ``max_batch``; flush when the packed batch is as full as it can get, when
  the oldest request has waited ``max_wait`` seconds, or on an explicit
  flush.  The clock is injected so tests drive time deterministically.
* :class:`BucketPolicy` — maps a packed size to the leading-dim size actually
  executed.  Candidate sizes come from a bucket ladder (powers of two up to
  ``max_batch`` by default) so the jit cache stays small.  With a
  :class:`LatencyEWMA` attached the choice is *measured*: among candidates
  with latency observations, the lowest-EWMA bucket wins; the static
  pads-no-worse-than-ladder heuristic survives only as the cold-start
  fallback (and as the explorer — an unmeasured heuristic choice executes
  once so it gains an estimate).
* :class:`ScheduledBatch` — the unit handed to the executor: member requests
  in arrival order, the bucket to pad to, and the batch budget (the most
  constrained member, so the precision policy never over-serves a request).

The scheduler never touches arrays; splitting, padding and demux live in the
executor (:class:`repro_torch.runtime.serve.AccelServer`).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Collection,
    Deque,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)


class QueueFull(RuntimeError):
    """The bounded request queue rejected a submission (backpressure)."""


# per-input (trailing shape, dtype) pairs — what must agree for requests to
# share a padded batch column
RequestSignature = Tuple[Tuple[Tuple[int, ...], str], ...]


def request_signature(inputs: Sequence[Any]) -> RequestSignature:
    return tuple((tuple(int(d) for d in x.shape[1:]), str(x.dtype)) for x in inputs)


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) — the one convention shared by
    server stats and the throughput benchmark."""
    if not samples:
        raise ValueError("percentile of no samples")
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))]


@dataclass
class Request:
    """One inference request: a tuple of arrays sharing the leading dim.

    A submission larger than ``max_batch`` is *split*: the queue holds its
    chunk requests and the caller gets back a parent whose ``children`` lists
    the chunk rids in order — the executor demuxes them back to one ticket."""

    rid: int
    inputs: Tuple[Any, ...]
    size: int
    arrival: float
    budget: float = 1.0
    children: Optional[List[int]] = None


@dataclass
class ScheduledBatch:
    """A packed group of requests plus the bucket they execute at."""

    requests: List[Request]
    bucket: int

    @property
    def size(self) -> int:
        """Total useful rows (sum of member request sizes)."""
        return sum(r.size for r in self.requests)

    @property
    def padding(self) -> int:
        """Zero rows appended to reach the bucket (wasted work)."""
        return self.bucket - self.size

    @property
    def budget(self) -> float:
        """Batch energy budget: the most constrained member's budget."""
        return min(r.budget for r in self.requests)


class LatencyEWMA:
    """Per-bucket execution-latency EWMA — the measurement side of the
    closed bucket-selection loop.

    The executor observes how long each bucket actually takes on the device
    (:class:`~repro_torch.runtime.serve.BatchReport.exec_s`); the policy consults
    the estimates when choosing the next bucket.  An exponentially weighted
    moving average keeps the estimate fresh under drift (retraces, cache
    evictions, thermal/clock changes) without storing a window per bucket.
    """

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._est: dict = {}
        self._count: dict = {}

    def observe(self, bucket: int, seconds: float) -> None:
        prev = self._est.get(bucket)
        self._est[bucket] = (
            seconds if prev is None else (1 - self.alpha) * prev + self.alpha * seconds
        )
        self._count[bucket] = self._count.get(bucket, 0) + 1

    def estimate(self, bucket: int) -> Optional[float]:
        """EWMA execution seconds for ``bucket``, or None if never measured."""
        return self._est.get(bucket)

    def snapshot(self) -> dict:
        """{bucket: ewma_seconds} for telemetry."""
        return dict(self._est)


def _pow2_ladder(max_batch: int) -> Tuple[int, ...]:
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class BucketPolicy:
    """Choose the executed leading-dim size for a packed request group.

    ``buckets`` is the ladder of sizes worth owning a trace for (default:
    powers of two capped at ``max_batch``).  When ``latency`` (a
    :class:`LatencyEWMA` fed by the executor) holds measurements, the choice
    is closed-loop: among every fitting candidate (ladder plus LRU-resident
    sizes) with an estimate, the lowest measured execution latency wins.
    The static rule — smallest fitting ladder bucket, preferring an
    LRU-resident size that pads no worse (a cache hit costs a few padded
    rows; a miss costs a fresh trace and may evict a hot one) — is demoted
    to the cold-start fallback: it picks the bucket only while that bucket
    has no measurement yet, which is exactly what routes one execution
    through it and gives the loop its estimate.

    ``packing`` selects how many queued requests a batch takes: ``"fifo"``
    (default) packs the maximal arrival-order prefix fitting ``max_batch``;
    ``"best_fit"`` picks the arrival-order *prefix* whose padded waste is
    minimal (ties favor the longer prefix).  Both are prefixes of the queue,
    so neither reorders requests or starves the head — best-fit only trades
    batch fullness for padding efficiency.
    """

    PACKINGS = ("fifo", "best_fit")

    def __init__(
        self,
        buckets: Optional[Sequence[int]] = None,
        max_batch: int = 8,
        packing: str = "fifo",
        latency: Optional[LatencyEWMA] = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if packing not in self.PACKINGS:
            raise ValueError(f"packing must be one of {self.PACKINGS}, got {packing!r}")
        self.max_batch = max_batch
        self.packing = packing
        self.latency = latency
        ladder = tuple(sorted(set(buckets))) if buckets else _pow2_ladder(max_batch)
        if any(b < 1 for b in ladder):
            raise ValueError(f"buckets must be positive, got {ladder}")
        if ladder[-1] > max_batch:
            # packed totals never exceed max_batch, so a larger bucket would
            # only ever add silent padding waste
            raise ValueError(f"buckets {ladder} exceed max_batch {max_batch}")
        if ladder[-1] < max_batch:
            ladder = ladder + (max_batch,)
        self.buckets = ladder

    def ladder_bucket(self, size: int) -> int:
        """Smallest configured bucket that fits ``size``."""
        for b in self.buckets:
            if b >= size:
                return b
        return size  # size exceeds the ladder: execute at exact size

    def fallback_bucket(self, size: int, cached: Collection[int] = ()) -> int:
        """The static heuristic: smallest fitting ladder bucket, preferring
        an already-traced size in ``cached`` that pads no worse."""
        ladder = self.ladder_bucket(size)
        fits = [c for c in cached if size <= c <= ladder]
        return min(fits) if fits else ladder

    def bucket_for(self, size: int, cached: Collection[int] = ()) -> int:
        """Executed size for a packed total of ``size`` rows.

        Measured mode (``latency`` attached and warm): the fitting candidate
        with the lowest latency EWMA, ties to the smaller bucket.  Cold
        start — no latency model, or the heuristic's own choice is still
        unmeasured — falls back to :meth:`fallback_bucket`; executing that
        choice is what produces its first measurement, so every bucket the
        heuristic would ever pick gets measured before being argued with.
        """
        fallback = self.fallback_bucket(size, cached)
        lat = self.latency
        if lat is None or lat.estimate(fallback) is None:
            return fallback
        measured = [
            (est, b)
            for b in {*self.buckets, *cached}
            if b >= size and (est := lat.estimate(b)) is not None
        ]
        return min(measured)[1]

    def best_fit_take(
        self, sizes: Sequence[int], cached: Collection[int] = ()
    ) -> Tuple[int, int]:
        """(#requests, total rows) of the arrival-order prefix with minimal
        padded waste under the bucket rule; ties prefer the longer prefix
        (more requests served per dispatch at equal waste)."""
        best_take, best_total, best_waste = 0, 0, None
        total = 0
        for take, size in enumerate(sizes, start=1):
            if total + size > self.max_batch:
                break
            total += size
            waste = self.bucket_for(total, cached) - total
            if best_waste is None or waste <= best_waste:
                best_take, best_total, best_waste = take, total, waste
        return best_take, best_total


class CoalescingScheduler:
    """Bounded FIFO queue + continuous-batching packing rule.

    Requests are packed strictly in arrival order (no reordering, so no
    starvation): a batch closes when adding the next request would overflow
    ``max_batch``, when it reaches ``max_batch`` exactly, when the oldest
    member has waited ``max_wait`` seconds, or on an explicit flush.  A
    submission *larger* than ``max_batch`` is split into back-to-back chunk
    requests and returned as a parent carrying their rids (``children``) —
    the executor concatenates the chunk outputs back into one result.  The
    clock is injected (``clock=FakeClock()`` in tests) and only ever read —
    the scheduler never sleeps; the serving loop decides when to poll.
    """

    def __init__(
        self,
        max_batch: int = 8,
        max_wait: float = 0.005,
        queue_depth: int = 1024,
        buckets: Optional[Sequence[int]] = None,
        clock: Callable[[], float] = time.monotonic,
        signature: Optional[RequestSignature] = None,
        packing: str = "fifo",
        latency: Optional[LatencyEWMA] = None,
    ):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.policy = BucketPolicy(buckets, max_batch, packing=packing, latency=latency)
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.queue_depth = queue_depth
        self.clock = clock
        self._queue: Deque[Request] = deque()
        self._rids = itertools.count()
        # the signature every request must match to coalesce: taken from the
        # served artifact when provided (FlowResult.serve passes the graph's
        # input spec), else locked in by the first submission — the artifact
        # form is safer, since a malformed first request cannot poison the
        # lock for everyone after it
        self._sig = signature
        self._sig_source = "served artifact's" if signature else None
        # telemetry
        self.submitted = 0
        self.split_requests = 0
        self.split_chunks = 0
        self.scheduled = 0
        self.scheduled_rows = 0
        self.padded_rows = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending_rows(self) -> int:
        return sum(r.size for r in self._queue)

    def submit(self, inputs: Sequence[Any], budget: float = 1.0) -> Request:
        """Enqueue one request (a tuple of arrays sharing the leading dim)."""
        inputs = tuple(inputs)
        if not inputs:
            raise ValueError("request has no inputs")
        sizes = {int(x.shape[0]) for x in inputs}
        if len(sizes) != 1:
            raise ValueError(f"request inputs disagree on leading dim: {sizes}")
        size = sizes.pop()
        if size < 1:
            raise ValueError("request leading dim must be >= 1")
        sig = request_signature(inputs)
        if self._sig is None:
            self._sig = sig
            self._sig_source = "first submitted request's"
        elif sig != self._sig:
            # arity / trailing-shape / dtype mismatches cannot share a padded
            # column; rejecting here keeps a bad request from poisoning the
            # batch it would have coalesced into
            raise ValueError(
                f"request signature {sig} does not match the "
                f"{self._sig_source} {self._sig}"
            )
        n_chunks = -(-size // self.max_batch)
        if len(self._queue) + n_chunks > self.queue_depth:
            raise QueueFull(
                f"queue_depth {self.queue_depth} reached; retry after a pump"
            )
        if size <= self.max_batch:
            req = Request(next(self._rids), inputs, size, self.clock(), budget)
            self._queue.append(req)
            self.submitted += 1
            return req
        # oversize request: split into max_batch-sized chunk requests (queued
        # back to back, so FIFO packing keeps them contiguous) and hand back
        # a parent the executor demuxes to one ticket
        arrival = self.clock()
        parent = Request(next(self._rids), inputs, size, arrival, budget, children=[])
        for off in range(0, size, self.max_batch):
            chunk = tuple(x[off : off + self.max_batch] for x in inputs)
            child = Request(
                next(self._rids), chunk, int(chunk[0].shape[0]), arrival, budget
            )
            self._queue.append(child)
            parent.children.append(child.rid)
        self.submitted += 1
        self.split_requests += 1
        self.split_chunks += n_chunks
        return parent

    def _packable(self) -> Tuple[int, int]:
        """(#requests, total rows) the head of the queue packs into."""
        total = take = 0
        for r in self._queue:
            if total + r.size > self.max_batch:
                break
            total += r.size
            take += 1
        return take, total

    def ready(
        self, cached: Collection[int] = (), flush: bool = False
    ) -> Optional[ScheduledBatch]:
        """Pop the next executable batch, or None to keep waiting.

        ``cached`` is the executable's set of already-traced leading-dim
        sizes (see ``BatchedExecutable.cached_batches``), consulted by the
        bucket policy.
        """
        if not self._queue:
            return None
        take, total = self._packable()
        full = total == self.max_batch or take < len(self._queue)
        waited = self.clock() - self._queue[0].arrival
        if not (full or flush or waited >= self.max_wait):
            return None
        if self.policy.packing == "best_fit" and take > 1:
            # a batch is due (by the maximal prefix); best-fit may dispatch a
            # shorter prefix whose bucket pads less — the rest stays queued
            take, total = self.policy.best_fit_take(
                [r.size for r in self._queue], cached
            )
        reqs = [self._queue.popleft() for _ in range(take)]
        batch = ScheduledBatch(reqs, self.policy.bucket_for(total, cached))
        self.scheduled += 1
        self.scheduled_rows += batch.size
        self.padded_rows += batch.padding
        return batch

    def drain(
        self, cached: Collection[int] = (), flush: bool = True
    ) -> Iterator[ScheduledBatch]:
        """Yield batches while the queue has something ready."""
        while True:
            batch = self.ready(cached, flush=flush)
            if batch is None:
                return
            yield batch

    def abandon(self) -> List[Request]:
        """Empty the queue without executing, returning the popped requests
        so the caller (server shutdown / pump death) can resolve their
        tickets with an error instead of leaving them queued forever."""
        popped = list(self._queue)
        self._queue.clear()
        return popped

    def stats(self) -> dict:
        rows = self.scheduled_rows + self.padded_rows
        return {
            "submitted": self.submitted,
            "split_requests": self.split_requests,
            "split_chunks": self.split_chunks,
            "scheduled_batches": self.scheduled,
            "scheduled_rows": self.scheduled_rows,
            "padded_rows": self.padded_rows,
            "padding_waste": self.padded_rows / rows if rows else 0.0,
            "pending": len(self._queue),
        }
