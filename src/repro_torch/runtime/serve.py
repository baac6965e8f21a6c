"""Serving runtime (counterpart of ``repro.runtime.serve``): the LM half —
prefill/decode steps, ``greedy_generate`` and the adaptive mixed-precision
``AdaptiveLMServer`` — and the batch-coalescing ``AccelServer``.

The adaptive LM server is the paper's CPS story for an LM: one int8 master
weight tree, a working point chosen per decode step by an energy policy, and
switching precision moves no weights (each step dequantizes the master codes
at the chosen point's view, as the reference's jitted step does).

Asynchronously arriving requests of varying sizes are coalesced into padded
bucket-sized batches executed through one batch-polymorphic artifact
(:class:`~repro_torch.core.writers.torch_writer.BatchedExecutable`), with an
optional :class:`~repro_torch.core.adaptive.PointSelector` choosing a
precision working point per scheduled batch.  Batches are assembled as numpy
columns on the host; the executables move them to the device and return
device tensors, and the demux copies each batch's outputs back to the host
once (``_finish``, the one synchronisation point) before the NaN/Inf guard.

A :class:`~repro_torch.runtime.integrity.Scrubber` attached with
:meth:`AccelServer.attach_scrubber` makes unrepairable weight corruption
fatal: the port's executables read the live weight buffers, so from the
moment the server dies no batch's result is resolved any more.

On a device mesh, ``make_prefill_step(cfg, mesh=, tp_total=)`` and
``make_decode_step`` run the model on DTensor parameters placed by
:func:`repro_torch.sharding.param_sharding`, and
:func:`decode_state_shardings` gives the decode state's layout.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from dataclasses import dataclass
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import to_numpy
from repro_torch.core.adaptive import (PointSelector, RuntimePolicy,
                                       ServiceObjective, SLOController,
                                       WorkingPoint)
from repro_torch.quant.ptq import dequantize_tree, quantize_tree_native
from repro_torch.runtime import model_api
from repro_torch.runtime.scheduler import (CoalescingScheduler, LatencyEWMA,
                                           QueueFull, RequestSignature,
                                           ScheduledBatch, percentile)
from repro_torch.sharding import P, NamedSharding, batch_axes, tp_size

__all__ = [
    "AccelServer", "AdaptiveLMServer", "BatchReport", "NumericalFault",
    "QueueFull", "ServeMetrics", "ServerStopped", "ServiceObjective",
    "Ticket", "decode_state_shardings", "greedy_generate",
    "make_decode_step", "make_prefill_step",
]


class ServerStopped(RuntimeError):
    """Typed shutdown error: the server stopped (or its stop timed out)
    before this request was served.  Callers that retry elsewhere (the fleet
    router) can distinguish it from an execution failure."""


class NumericalFault(RuntimeError):
    """Typed demux error: a request's output rows contained non-finite
    values (NaN/Inf — corrupted weights, a numerically unstable trace, an
    SEU the checksums have not caught yet).  The poisoned rows are withheld:
    the member ticket resolves to this error instead of silently returning
    garbage, and the tenant's ``numerical_faults`` counter increments.
    Like :class:`ServerStopped` it survives :meth:`AccelServer.result`
    un-wrapped so the fleet router can retry the request elsewhere."""


def decode_state_shardings(cfg: ModelConfig, state, mesh):
    """Shardings for a DecodeState / EncDecDecodeState (flat kv dims):
    batch over the data axes, the last dim over 'model' where it divides
    it; the index (a host int in the port) gets ``P()``, as in the
    reference."""
    from repro_torch.models import encdec, transformer
    dp = batch_axes(mesh)
    tp = tp_size(mesh)

    def spec_for(x):
        if x is None:
            return None
        if x.ndim == 0:
            return NamedSharding(mesh, P())
        # (L, B, ..., feat): batch over dp; last dim over model when divisible
        parts = [None] * x.ndim
        parts[1] = dp
        if x.shape[-1] % tp == 0 and x.shape[-1] >= tp:
            parts[-1] = "model"
        return NamedSharding(mesh, P(*parts))

    if isinstance(state, transformer.DecodeState):
        return transformer.DecodeState(
            cache_k=spec_for(state.cache_k),
            cache_v=spec_for(state.cache_v),
            ssm_ssd=(None if state.ssm_ssd is None else NamedSharding(
                mesh, P(None, dp, "model", None))),
            ssm_conv=(None if state.ssm_conv is None else NamedSharding(
                mesh, P(None, dp, None, None))),
            index=NamedSharding(mesh, P()))
    return encdec.EncDecDecodeState(
        cache_k=spec_for(state.cache_k),
        cache_v=spec_for(state.cache_v),
        cross_k=NamedSharding(mesh, P(None, dp, None, None, None)),
        cross_v=NamedSharding(mesh, P(None, dp, None, None, None)),
        index=NamedSharding(mesh, P()))


def make_prefill_step(cfg: ModelConfig, *, mesh=None, tp_total: int = 1):
    def prefill(params, batch):
        logits, _ = model_api.forward_logits(params, batch, cfg, mesh=mesh,
                                             tp_total=tp_total)
        return logits

    return prefill


def make_decode_step(cfg: ModelConfig, *, mesh=None, tp_total: int = 1):
    def step(params, tokens, state):
        return model_api.decode_step(params, tokens, state, cfg, mesh=mesh,
                                     tp_total=tp_total)

    return step


def _next_token(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return torch.argmax(logits[:, -1:, : cfg.vocab], dim=-1)


def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    max_new: int, seq_len: int,
                    batch_extras: Optional[Dict] = None) -> torch.Tensor:
    """Host-loop greedy decoding.

    Always returns ``max_new`` generated tokens after the prompt.  A
    zero-length prompt is legal: with nothing to condition on, generation is
    seeded with token 0 (BOS convention) and that seed counts as the first
    generated token.  The decode state is this function's own, so every
    step donates it (``decode_step(..., donate=True)``): each layer's cache
    is held once and written in place."""
    B, S0 = prompt.shape
    batch = {"tokens": prompt, **(batch_extras or {})}
    state = model_api.init_decode_state(params, batch, cfg, B, seq_len)
    out = [prompt]
    if S0:
        # feed the prompt token by token (cache warmup), then generate
        for i in range(S0):
            logits, state = model_api.decode_step(params, prompt[:, i:i + 1],
                                                  state, cfg, donate=True)
        tok = _next_token(logits, cfg).to(prompt.dtype)
    else:
        tok = torch.zeros((B, 1), dtype=prompt.dtype, device=prompt.device)
    for _ in range(max_new):
        out.append(tok)
        logits, state = model_api.decode_step(params, tok, state, cfg,
                                              donate=True)
        tok = _next_token(logits, cfg).to(prompt.dtype)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Adaptive mixed-precision LM server
# ---------------------------------------------------------------------------

@dataclass
class ServeMetrics:
    point: str
    weight_bytes_read: int
    est_step_energy_uj: float


class AdaptiveLMServer:
    """Batched decode serving with runtime-switchable weight precision.

    One int8 master + scales (the shared substrate, quantized once); each
    decode step dequantizes the master codes at the chosen working point's
    view and runs the step, so switching points never touches the codes."""

    def __init__(self, params, cfg: ModelConfig,
                 points: Sequence[WorkingPoint] = (
                     WorkingPoint("w8", 8), WorkingPoint("w4", 4),
                     WorkingPoint("w2", 2)),
                 policy: Optional[RuntimePolicy] = None):
        self.cfg = cfg
        self.points = list(points)
        self.policy = policy or RuntimePolicy(self.points)
        self.qparams = quantize_tree_native(params)
        self._code_elems = sum(c.numel() for c in self.qparams.codes.values())

    def decode(self, tokens, state, energy_budget_frac: float = 1.0):
        """One decode step at the point the policy picks for the budget ->
        (logits, new state, ServeMetrics)."""
        pt = self.policy.select(energy_budget_frac)
        params = dequantize_tree(self.qparams, pt.weight_bits, torch.bfloat16)
        logits, state = model_api.decode_step(params, tokens, state, self.cfg)
        wbytes = self._code_elems * pt.weight_bits // 8
        # energy model: pJ/byte of weights read
        metrics = ServeMetrics(pt.name, wbytes, wbytes * 2.0e-6)
        return logits, state, metrics



# ---------------------------------------------------------------------------
# Batch-coalescing accelerator server (async, multi-tenant)
# ---------------------------------------------------------------------------

@dataclass
class _BatchFailure:
    """Stored per ticket when its batch's executable raised: the ticket
    resolves to an error instead of silently disappearing."""
    error: Exception


@dataclass
class BatchReport:
    """Telemetry for one executed batch."""
    bucket: int          # leading-dim size actually executed (after padding)
    rows: int            # useful rows (sum of member request sizes)
    padding: int         # zero rows appended to reach the bucket
    requests: int        # member request count
    point: Optional[str]  # precision working point, if a policy is attached
    bits: Optional[int] = None   # weight-bits view the executed artifact used
    tenant: str = "default"      # which resident graph served the batch
    exec_s: Optional[float] = None  # device execution seconds (feeds LatencyEWMA)


class Ticket:
    """Future-style handle for one submitted request.

    ``submit`` returns immediately; the ticket resolves when the pump (the
    background thread, or a synchronous ``pump()`` call) executes the batch
    the request coalesced into.  ``result()`` blocks until then (optionally
    bounded by ``timeout`` when the background pump is running) and raises
    the batch's error if execution failed.  Results are single-consumption;
    an abandoned ticket is released with :meth:`AccelServer.drop`.
    """

    __slots__ = ("tenant", "rid", "_server", "_event")

    def __init__(self, server: "AccelServer", tenant: str, rid: int):
        self.tenant = tenant
        self.rid = rid
        self._server = server
        self._event = threading.Event()

    def done(self) -> bool:
        """True once the request resolved (result or error ready)."""
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the ticket resolves (True) or ``timeout`` elapses
        (False) without claiming the result — the fleet router's hedging
        loop waits on several replicas' tickets this way."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        return self._server.result(self, timeout=timeout)

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"Ticket(tenant={self.tenant!r}, rid={self.rid}, {state})"


@dataclass
class _Pending:
    """A dispatched-but-unforced batch: the device may still be executing
    while the pump assembles and dispatches the next one (host batch assembly
    overlapping device execution)."""
    tenant: "_Tenant"
    batch: ScheduledBatch
    outs: tuple
    multi: bool
    point: Optional[str]
    bits: Optional[int]
    t0: float


class _Tenant:
    """One resident graph: scheduler, executables, QoS class, SLO loop."""

    def __init__(self, name: str, executable: Callable, *,
                 max_batch: int = 8, max_wait: float = 0.005,
                 queue_depth: int = 1024,
                 buckets: Optional[Sequence[int]] = None,
                 policy: Optional[PointSelector] = None,
                 point_executables: Optional[Dict[str, Callable]] = None,
                 signature: Optional[RequestSignature] = None,
                 packing: str = "fifo", weight: int = 1,
                 slo: Optional[ServiceObjective] = None,
                 latency: Optional[LatencyEWMA] = None,
                 selector: Optional[PointSelector] = None,
                 clock: Callable[[], float] = time.monotonic,
                 history: int = 4096):
        if weight < 1:
            raise ValueError(f"tenant weight must be >= 1, got {weight}")
        self.name = name
        self.executable = executable
        self.point_executables: Dict[str, Callable] = dict(point_executables or {})
        self.weight = int(weight)
        # the measurement side of the closed bucket loop: the executor feeds
        # per-bucket execution seconds in, the BucketPolicy reads them back
        self.latency = latency if latency is not None else LatencyEWMA()
        self.scheduler = CoalescingScheduler(
            max_batch=max_batch, max_wait=max_wait, queue_depth=queue_depth,
            buckets=buckets, clock=clock, signature=signature,
            packing=packing, latency=self.latency)
        # ONE point-selection surface: the legacy policy=/slo= pair is
        # normalized into a PointSelector here, so the dispatch/feedback
        # paths below speak only the protocol
        if selector is not None:
            if policy is not None or slo is not None:
                raise ValueError(
                    "pass either selector= or the legacy policy=/slo= pair, "
                    "not both")
        elif slo is not None:
            if policy is None:
                raise ValueError(
                    "an SLO tenant needs a RuntimePolicy: its working points "
                    "are the precision ladder the controller walks")
            selector = SLOController(policy.points, slo)
        else:
            selector = policy
        self.selector: Optional[PointSelector] = selector
        # per-ticket state (guarded by the server lock)
        self.results: Dict[int, Any] = {}
        self.dropped: set = set()
        self.split: Dict[int, List[int]] = {}
        self.child_parent: Dict[int, int] = {}
        self.parent_left: Dict[int, int] = {}
        self.tickets: Dict[int, Ticket] = {}
        # bounded telemetry windows: a long-running server keeps the last
        # ``history`` entries (the scheduler's totals stay cumulative)
        self.reports: Deque[BatchReport] = deque(maxlen=history)
        self.latencies: Deque[float] = deque(maxlen=history)
        self.executed_batches = 0
        self.numerical_faults = 0   # requests withheld by the NaN/Inf guard

    # legacy views of the unified selector, kept for telemetry/test surfaces
    @property
    def controller(self) -> Optional[SLOController]:
        sel = self.selector
        return sel if isinstance(sel, SLOController) else None

    @property
    def policy(self) -> Optional[PointSelector]:
        sel = self.selector
        return None if isinstance(sel, SLOController) else sel

    def executables(self) -> List[Callable]:
        uniq, seen = [], set()
        for exe in (self.executable, *self.point_executables.values()):
            if id(exe) not in seen:
                seen.add(id(exe))
                uniq.append(exe)
        return uniq

    def cached(self) -> Tuple[int, ...]:
        """Union of traced leading-dim sizes across the default and every
        per-point executable (the bucket is chosen before the point is)."""
        sizes = set()
        for exe in self.executables():
            sizes.update(getattr(exe, "cached_batches", ()))
        return tuple(sorted(sizes))


class AccelServer:
    """Async, multi-tenant batch-coalescing serving front-end.

    Several resident graphs (*tenants*) are multiplexed onto one device.
    Each tenant owns a :class:`~repro_torch.runtime.scheduler.CoalescingScheduler`
    (bounded queue — per-tenant :class:`QueueFull` admission control — FIFO
    packing, ``max_wait`` flush, measured-latency bucket selection) over a
    batch-polymorphic executable (plus optional per-precision-point
    executables sharing one weight substrate).  Member inputs are
    concatenated along the leading dim, zero-padded to the chosen bucket,
    executed once, and the outputs sliced back per request — coalescing is
    invisible to callers.

    Two drive modes:

    * **Synchronous** (default, fully deterministic under an injected
      clock): the caller drives :meth:`pump`, exactly the pre-async
      behaviour.
    * **Background pump** (:meth:`start` / :meth:`stop`): ``submit`` returns
      a :class:`Ticket` immediately and a pump thread assembles and
      dispatches batches, keeping up to ``pipeline_depth`` batches dispatched
      but unforced so host batch assembly overlaps device execution.
      Tenants share the device via weighted round-robin (``weight`` = QoS
      class: how many batches a tenant may dispatch per cycle while
      backlogged).  ``stop()`` drains every queue before the thread exits; a
      batch failure resolves its member tickets to per-ticket errors and the
      pump keeps serving; an unexpected pump crash resolves *every*
      outstanding and queued ticket with the error so no caller blocks
      forever.

    Two control loops close over measured latency:

    * per-bucket execution time feeds each tenant's
      :class:`~repro_torch.runtime.scheduler.LatencyEWMA`, which the
      :class:`~repro_torch.runtime.scheduler.BucketPolicy` consults — the static
      pads-no-worse heuristic is only the cold-start fallback;
    * end-to-end request latency feeds the tenant's
      :class:`~repro_torch.core.adaptive.SLOController` (when an ``slo`` is set),
      which walks the precision ladder W8 -> W4 -> W2 down under p95
      pressure and back up when there is headroom — the paper's
      no-weight-reload precision switch, driven by a real signal.
    """

    def __init__(self, executable: Optional[Callable] = None, *,
                 max_batch: int = 8, max_wait: float = 0.005,
                 queue_depth: int = 1024,
                 buckets: Optional[Sequence[int]] = None,
                 policy: Optional[PointSelector] = None,
                 point_executables: Optional[Dict[str, Callable]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 history: int = 4096,
                 signature: Optional[RequestSignature] = None,
                 packing: str = "fifo",
                 weight: int = 1,
                 slo: Optional[ServiceObjective] = None,
                 latency: Optional[LatencyEWMA] = None,
                 selector: Optional[PointSelector] = None,
                 pipeline_depth: int = 2):
        self.clock = clock
        self.pipeline_depth = max(0, int(pipeline_depth))
        self.tenants: Dict[str, _Tenant] = {}
        self._order: List[str] = []          # WRR ring, registration order
        self._rr_pos = 0
        self._rr_credit = 0
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._ever_started = False
        self._stopping = False
        self._drain_on_stop = True
        self._fatal: Optional[BaseException] = None
        self._scrubber = None   # attach_scrubber: weight-memory integrity
        # per-batch executable failures survive here in async mode, where no
        # caller frame exists for pump() to re-raise into
        self.pump_errors: Deque[BaseException] = deque(maxlen=64)
        if executable is not None:
            self.add_tenant("default", executable, max_batch=max_batch,
                            max_wait=max_wait, queue_depth=queue_depth,
                            buckets=buckets, policy=policy,
                            point_executables=point_executables,
                            signature=signature, packing=packing,
                            weight=weight, slo=slo, latency=latency,
                            selector=selector, history=history)

    # -- tenant registry -----------------------------------------------------
    def add_tenant(self, name: str, executable: Callable, **kwargs) -> str:
        """Register a resident graph under ``name``; returns the name.

        Keyword arguments mirror the constructor's per-tenant set:
        ``max_batch``, ``max_wait``, ``queue_depth``, ``buckets``,
        ``policy``, ``point_executables``, ``signature``, ``packing``,
        ``weight`` (QoS: batches per WRR cycle while backlogged), ``slo`` (a
        :class:`~repro_torch.core.adaptive.ServiceObjective` — requires a
        ``policy`` whose points form the precision ladder), ``latency``,
        ``selector`` (any :class:`~repro_torch.core.adaptive.PointSelector` — the
        unified surface; mutually exclusive with ``policy``/``slo``) and
        ``history``."""
        with self._lock:
            if name in self.tenants:
                raise ValueError(f"tenant {name!r} already registered")
            ten = _Tenant(name, executable, clock=self.clock, **kwargs)
            self.tenants[name] = ten
            self._order.append(name)
            if len(self._order) == 1:
                self._rr_credit = ten.weight
        return name

    def _tenant(self, name: str) -> _Tenant:
        try:
            return self.tenants[name]
        except KeyError:
            raise KeyError(f"no tenant {name!r}; have {tuple(self.tenants)}")

    # -- single-tenant compatibility surface ---------------------------------
    @property
    def _default(self) -> _Tenant:
        return self._tenant("default")

    @property
    def scheduler(self) -> CoalescingScheduler:
        return self._default.scheduler

    @property
    def executable(self) -> Callable:
        return self._default.executable

    @property
    def point_executables(self) -> Dict[str, Callable]:
        return self._default.point_executables

    @property
    def policy(self) -> Optional[PointSelector]:
        return self._default.policy

    @property
    def selector(self) -> Optional[PointSelector]:
        return self._default.selector

    @property
    def reports(self) -> Deque[BatchReport]:
        return self._default.reports

    @property
    def latencies(self) -> Deque[float]:
        return self._default.latencies

    @property
    def executed_batches(self) -> int:
        return self._default.executed_batches

    @property
    def _results(self) -> Dict[int, Any]:
        return self._default.results

    @property
    def _dropped(self) -> set:
        return self._default.dropped

    @property
    def _split(self) -> Dict[int, List[int]]:
        return self._default.split

    # -- request lifecycle ---------------------------------------------------
    def submit(self, *inputs, budget: float = 1.0,
               tenant: str = "default") -> Ticket:
        """Enqueue one request; returns a :class:`Ticket` immediately.

        Raises the tenant's :class:`QueueFull` when its bounded queue is at
        depth (admission control — other tenants are unaffected).  A request
        whose leading dim exceeds the tenant's ``max_batch`` is transparently
        split into chunk requests and demuxed back to this one ticket."""
        with self._cond:
            if self._fatal is not None:
                raise RuntimeError(
                    "server pump died; no new requests accepted"
                ) from self._fatal
            ten = self._tenant(tenant)
            req = ten.scheduler.submit(inputs, budget=budget)
            tk = Ticket(self, ten.name, req.rid)
            ten.tickets[req.rid] = tk
            if req.children:
                ten.split[req.rid] = list(req.children)
                ten.parent_left[req.rid] = len(req.children)
                for c in req.children:
                    ten.child_parent[c] = req.rid
            self._cond.notify_all()
        return tk

    # -- batch selection (weighted round-robin across tenants) ---------------
    def _next_batch(self, flush: bool) -> Optional[Tuple[_Tenant, ScheduledBatch]]:
        """Pop the next due batch under WRR, or None.  Caller holds the lock.

        Each tenant may dispatch up to ``weight`` batches per turn while it
        has work ready; an idle or exhausted tenant forfeits the rest of its
        turn, so QoS ratios only bind under contention (work-conserving)."""
        names = self._order
        for _ in range(len(names) + 1):
            if not names:
                return None
            ten = self.tenants[names[self._rr_pos % len(names)]]
            if self._rr_credit > 0:
                batch = ten.scheduler.ready(ten.cached(), flush=flush)
                if batch is not None:
                    self._rr_credit -= 1
                    return ten, batch
            self._rr_pos = (self._rr_pos + 1) % len(names)
            self._rr_credit = self.tenants[names[self._rr_pos]].weight
        return None

    # -- execution -----------------------------------------------------------
    def _select(self, ten: _Tenant, batch: ScheduledBatch
                ) -> Tuple[Callable, Optional[str], Optional[int]]:
        exe, point, pt = ten.executable, None, None
        if ten.selector is not None:
            # one protocol call: open-loop selectors read the batch budget,
            # closed-loop ones (SLOController) ignore it and use observe()
            pt = ten.selector.select(batch.budget)
        if pt is not None:
            point = pt.name
            exe = ten.point_executables.get(pt.name, exe)
        # which weight-bits view served this batch: the artifact's own stamp
        # (packed-weight executables carry it), else the selected point's
        bits = getattr(exe, "bits", None)
        if bits is None and pt is not None:
            bits = pt.weight_bits
        return exe, point, bits

    def _dispatch(self, ten: _Tenant, batch: ScheduledBatch) -> _Pending:
        exe, point, bits = self._select(ten, batch)
        # batch assembly and demux stay on the host: the executable takes the
        # padded numpy columns and moves each to the device in one copy
        cols = []
        for j in range(len(batch.requests[0].inputs)):
            parts = [to_numpy(r.inputs[j]) for r in batch.requests]
            col = np.zeros((batch.bucket, *parts[0].shape[1:]),
                           parts[0].dtype)
            off = 0
            for p in parts:
                col[off:off + p.shape[0]] = p
                off += p.shape[0]
            cols.append(col)
        t0 = self.clock()
        out = exe(*cols)
        multi = isinstance(out, tuple)
        return _Pending(ten, batch, tuple(out if multi else (out,)), multi,
                        point, bits, t0)

    @staticmethod
    def _finite(sliced: Tuple[np.ndarray, ...]) -> bool:
        """True when every float output slice is NaN/Inf-free (integer
        outputs — token ids — vacuously pass).  bf16 outputs reach here as
        f32 (``to_numpy``), so they are guarded too: a deliberate departure
        from the reference, whose ``ml_dtypes`` bfloat16 arrays are not
        ``np.floating`` and pass unchecked."""
        return all(np.isfinite(o).all()
                   for o in sliced if np.issubdtype(o.dtype, np.floating))

    def _finish(self, pending: _Pending) -> None:
        # the one force point: copying the outputs to the host waits for the
        # device; everything after is host work
        outs = tuple(to_numpy(o) for o in pending.outs)
        done = self.clock()
        ten, batch = pending.tenant, pending.batch
        exec_s = done - pending.t0
        with self._lock:
            if self._fatal is not None:
                # the server died while this batch ran (its scrubber may
                # have quarantined the weights it read): every member ticket
                # already holds the fatal error, and no result computed
                # after that point is served
                return
            off = 0
            for r in batch.requests:
                sliced = tuple(o[off:off + r.size] for o in outs)
                if r.rid in ten.dropped:
                    ten.dropped.discard(r.rid)   # abandoned pre-execution
                elif not self._finite(sliced):
                    # poisoned rows are withheld per request, not per batch:
                    # a NaN in one member's slice must not fail its batch
                    # neighbours (padding made them share an execution only)
                    ten.numerical_faults += 1
                    self._resolve(ten, r.rid, _BatchFailure(NumericalFault(
                        f"request {r.rid} (tenant {ten.name!r}) produced "
                        "non-finite outputs; rows withheld")))
                else:
                    self._resolve(ten, r.rid,
                                  sliced if pending.multi else sliced[0])
                    lat = done - r.arrival
                    ten.latencies.append(lat)
                    if ten.selector is not None:
                        ten.selector.observe(lat)
                off += r.size
            # close the bucket loop: this bucket's measured execution time
            ten.latency.observe(batch.bucket, exec_s)
            ten.executed_batches += 1
            ten.reports.append(BatchReport(
                batch.bucket, batch.size, batch.padding, len(batch.requests),
                pending.point, pending.bits, ten.name, exec_s))

    def _fail_batch(self, ten: _Tenant, batch: ScheduledBatch,
                    err: BaseException) -> None:
        """Resolve every member ticket of a failed batch to its error — the
        requests already left the queue, and losing them would leave their
        result() callers waiting on tickets that can never be served."""
        with self._lock:
            for r in batch.requests:
                if r.rid in ten.dropped:
                    ten.dropped.discard(r.rid)
                else:
                    self._resolve(ten, r.rid, _BatchFailure(err))

    def _run_batch(self, ten: _Tenant, batch: ScheduledBatch) -> None:
        """Synchronous execute: dispatch + force, re-raising on failure
        (after resolving the member tickets)."""
        try:
            self._finish(self._dispatch(ten, batch))
        except Exception as e:
            self._fail_batch(ten, batch, e)
            raise

    def _resolve(self, ten: _Tenant, rid: int, value: Any) -> None:
        """Store a leaf result and fire ticket events.  Caller holds the
        lock.  A chunk resolution decrements its split parent; the parent's
        ticket fires when the last chunk lands."""
        ten.results[rid] = value
        parent = ten.child_parent.pop(rid, None)
        if parent is not None:
            left = ten.parent_left.get(parent, 1) - 1
            if left > 0:
                ten.parent_left[parent] = left
                return
            ten.parent_left.pop(parent, None)
            rid = parent
        tk = ten.tickets.get(rid)
        if tk is not None:
            tk._event.set()

    # -- synchronous pump ----------------------------------------------------
    def pump(self, flush: bool = False) -> int:
        """Execute every batch the schedulers deem ready (weighted
        round-robin across tenants); ``flush=True`` forces out partial
        batches (stream end / result demand).  Returns the number of batches
        executed.  Only valid while no background pump is running."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "background pump running: results arrive via result()/"
                "tickets; stop() the server to drive it synchronously")
        n = 0
        while True:
            with self._lock:
                nxt = self._next_batch(flush)
            if nxt is None:
                return n
            ten, batch = nxt
            self._run_batch(ten, batch)
            n += 1

    # -- background pump -----------------------------------------------------
    def start(self) -> "AccelServer":
        """Spawn the background pump thread; ``submit`` now overlaps host
        batch assembly with device execution.  Idempotent lifecycle:
        ``start`` -> ``stop(drain=True)``; usable as a context manager."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError("pump thread already running")
            if self._fatal is not None:
                raise RuntimeError(
                    "server pump died; create a fresh server") from self._fatal
            self._stopping = False
            self._drain_on_stop = True
            self._ever_started = True
            self._thread = threading.Thread(
                target=self._pump_loop, name="accel-server-pump", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the pump thread.  ``drain=True`` (default) serves everything
        still queued first; ``drain=False`` abandons the queues, resolving
        their tickets with an error so no caller blocks forever.

        A ``timeout`` that expires with the pump still running (a hung device
        call, a wedged executable) marks the server fatal, resolves *every*
        outstanding and queued ticket with a typed :class:`ServerStopped`
        error — no caller may block on a pump that will never answer — and
        then raises.  Repeated ``stop()`` calls are safe no-ops."""
        with self._cond:
            t = self._thread
            if t is None or self._fatal is not None:
                return   # never started, already stopped, or already fatal
            self._stopping = True
            self._drain_on_stop = drain
            self._cond.notify_all()
        t.join(timeout)
        if t.is_alive():
            # the pump is wedged: its tickets can never be served.  Resolve
            # them all with the typed shutdown error (idempotently — if the
            # pump un-wedges later, already-resolved rids are left alone) and
            # refuse further work so a repeated stop() is a no-op.
            err = ServerStopped(
                f"pump thread did not exit within {timeout}s; outstanding "
                "tickets resolved with this error")
            with self._cond:
                self._fatal = err
                self.pump_errors.append(err)
                self._resolve_all_outstanding(err)
                self._cond.notify_all()
            raise RuntimeError("pump thread did not exit within timeout")
        with self._cond:
            self._thread = None
            self._stopping = False
            if not drain and self._fatal is None:
                err = ServerStopped(
                    "server stopped before serving this request")
                for ten in self.tenants.values():
                    for r in ten.scheduler.abandon():
                        if r.rid in ten.dropped:
                            ten.dropped.discard(r.rid)
                        else:
                            self._resolve(ten, r.rid, _BatchFailure(err))

    def __enter__(self) -> "AccelServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # -- fleet hooks (health probes / drain / brownout) ----------------------
    @property
    def alive(self) -> bool:
        """True while the background pump thread is running and the server
        has not failed fatally — the fleet router's aliveness probe."""
        t = self._thread
        return self._fatal is None and t is not None and t.is_alive()

    @property
    def fatal(self) -> Optional[BaseException]:
        """The error that killed the pump (None while healthy)."""
        return self._fatal

    def queue_depth(self) -> int:
        """Total queued requests across all tenants — the fleet brownout
        selector's backlog signal."""
        with self._lock:
            return sum(len(t.scheduler) for t in self.tenants.values())

    def attach_scrubber(self, scrubber) -> None:
        """Wire a :class:`~repro_torch.runtime.integrity.Scrubber` over this
        server's weight buffer: unrepairable corruption (master codes or
        scales) becomes a fatal typed
        :class:`~repro_torch.runtime.integrity.IntegrityError` — the pump
        dies, every outstanding ticket resolves to the error, a batch still
        running is withheld, new work is refused — and the fleet sentinel
        sees ``fatal`` and ejects the replica with a ``quarantined`` cause.
        The scrubber's telemetry surfaces under ``stats()["integrity"]``.
        Lifecycle stays the caller's: attach does not start it.  One
        scrubber over a buffer may be attached to every server that reads
        it; its first detection then kills them all at once."""
        from repro_torch.runtime.integrity import IntegrityError

        def _quarantine(mismatch):
            self._die(IntegrityError(
                f"weight memory quarantined: {mismatch}", [mismatch]))

        self._scrubber = scrubber
        scrubber.add_on_quarantine(_quarantine)

    @property
    def scrubber(self):
        return self._scrubber

    def set_selector(self, selector: Optional[PointSelector],
                     tenant: str = "default") -> None:
        """Swap a tenant's point selector at runtime.  The fleet router uses
        this to wire ONE shared
        :class:`~repro_torch.core.adaptive.BrownoutSelector` into every
        replica so the whole fleet walks the precision ladder together."""
        with self._lock:
            self._tenant(tenant).selector = selector

    def _any_queued(self) -> bool:
        return any(len(t.scheduler) for t in self.tenants.values())

    def _poll_s(self) -> float:
        waits = [t.scheduler.max_wait for t in self.tenants.values()]
        w = min(waits) if waits else 0.005
        return min(max(w / 2, 1e-4), 0.05)

    def _pump_loop(self) -> None:
        try:
            while True:
                with self._cond:
                    while (not self._stopping and self._fatal is None
                           and not self._any_queued()):
                        self._cond.wait(timeout=self._poll_s())
                    if self._fatal is not None:
                        # a timed-out stop() already resolved every ticket
                        # and marked the server dead: a late-unwedged pump
                        # must not keep serving a server callers gave up on
                        return
                    if self._stopping and (not self._drain_on_stop
                                           or not self._any_queued()):
                        return
                    flush = self._stopping
                executed = self._pump_async(flush)
                if not executed and not self._stopping:
                    # work is queued but not yet due (max_wait still
                    # running): nap instead of spinning
                    with self._cond:
                        self._cond.wait(timeout=self._poll_s())
        except BaseException as e:   # noqa: BLE001 — the pump must not die silently
            self._die(e)

    def _pump_async(self, flush: bool) -> int:
        """One pass over the due batches, pipelined: up to
        ``pipeline_depth`` batches stay dispatched-but-unforced, so the host
        assembles batch k+1 while the device executes batch k.  A batch
        failure resolves its member tickets and the pump keeps serving."""
        inflight: Deque[_Pending] = deque()
        executed = 0
        while True:
            with self._lock:
                nxt = self._next_batch(flush)
            if nxt is None:
                break
            ten, batch = nxt
            try:
                inflight.append(self._dispatch(ten, batch))
                executed += 1
            except Exception as e:
                self._fail_batch(ten, batch, e)
                self.pump_errors.append(e)
                continue
            if len(inflight) > self.pipeline_depth:
                self._finish_safe(inflight.popleft())
        while inflight:
            self._finish_safe(inflight.popleft())
        return executed

    def _finish_safe(self, pending: _Pending) -> None:
        try:
            self._finish(pending)
        except Exception as e:
            self._fail_batch(pending.tenant, pending.batch, e)
            self.pump_errors.append(e)

    def _resolve_all_outstanding(self, err: BaseException) -> None:
        """Resolve every outstanding and queued ticket with ``err`` (caller
        holds the lock).  Idempotent: already-resolved rids keep their
        results, so a wedged pump that finishes late cannot double-resolve
        split-parent bookkeeping."""
        for ten in self.tenants.values():
            ten.scheduler.abandon()
            for rid in list(ten.child_parent):
                if rid not in ten.results:
                    self._resolve(ten, rid, _BatchFailure(err))
            for rid, tk in list(ten.tickets.items()):
                if rid not in ten.split and rid not in ten.results:
                    self._resolve(ten, rid, _BatchFailure(err))
                tk._event.set()

    def _die(self, err: BaseException) -> None:
        """Pump-thread crash: resolve EVERY outstanding and queued ticket
        with the error so no caller blocks forever, and refuse new work."""
        with self._cond:
            self._fatal = err
            self.pump_errors.append(err)
            self._resolve_all_outstanding(err)
            self._cond.notify_all()

    # -- results -------------------------------------------------------------
    def _locate(self, ticket: Union[Ticket, int]) -> Tuple[_Tenant, int]:
        if isinstance(ticket, Ticket):
            return self._tenant(ticket.tenant), ticket.rid
        return self._default, ticket

    def result(self, ticket: Union[Ticket, int],
               timeout: Optional[float] = None):
        """The output rows for ``ticket``.

        With the background pump running this blocks until the ticket
        resolves (``TimeoutError`` after ``timeout`` seconds, with the
        ticket left claimable); synchronously it flushes the pump on demand.
        Results are single-consumption: each ticket must be claimed exactly
        once (or released with :meth:`drop`), else its output stays
        resident."""
        ten, rid = self._locate(ticket)
        if isinstance(ticket, Ticket) and self._thread is not None:
            # wait in bounded slices, re-checking pump liveness: a pump
            # thread that died without resolving this ticket (a crashed
            # start, a wedged stop) must fail fast instead of blocking a
            # timeout=None caller forever
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while not ticket._event.is_set():
                with self._lock:
                    th, stopping = self._thread, self._stopping
                if th is None:
                    break   # pump stopped meanwhile: sync claim below
                if not th.is_alive() and not stopping:
                    raise RuntimeError(
                        f"ticket {rid} (tenant {ten.name!r}) cannot be "
                        "served: the background pump thread is not running "
                        "(it exited without resolving this ticket); create "
                        "a fresh server and resubmit")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"ticket {rid} (tenant {ten.name!r}) not served "
                        f"within {timeout}s")
                ticket._event.wait(0.05 if remaining is None
                                   else min(0.05, remaining))
        return self._claim(ten, rid)

    def _claim(self, ten: _Tenant, rid: int):
        with self._lock:
            children = ten.split.pop(rid, None)
            if children is not None:
                ten.tickets.pop(rid, None)
        if children is not None:
            parts = []
            try:
                for c in children:
                    parts.append(self._claim(ten, c))
            except Exception:
                # a chunk claim failed: release every unclaimed chunk so no
                # output stays resident forever, and unwind the parent's
                # split bookkeeping.  A still-queued chunk (child_parent
                # entry alive) is marked dropped so its output is discarded
                # at demux; a resolved-but-unclaimed chunk has its result
                # popped; a chunk with NO remaining state was already fully
                # consumed (the raising chunk's usual fate) — dropping it
                # would only grow the dropped set with a rid that can never
                # be demuxed again, so it is skipped.
                with self._lock:
                    ten.parent_left.pop(rid, None)
                    for c in children[len(parts):]:
                        queued = ten.child_parent.pop(c, None) is not None
                        if queued or c in ten.results or c in ten.tickets:
                            self._drop_rid(ten, c)
                raise
            if parts and isinstance(parts[0], tuple):
                return tuple(np.concatenate(col) for col in zip(*parts))
            return np.concatenate(parts)
        async_pump = self._thread is not None
        if not async_pump:
            with self._lock:
                resolved = rid in ten.results
            if not resolved:
                try:
                    self.pump(flush=True)
                except Exception:
                    # the pump's batch may have been ours: if our ticket was
                    # resolved (to a _BatchFailure) fall through and raise
                    # the per-ticket error; else it was someone else's problem
                    with self._lock:
                        if rid not in ten.results:
                            raise
        with self._lock:
            if rid not in ten.results and rid in ten.tickets:
                # a live ticket with no result and nobody pumping: name the
                # un-started pump instead of a bare KeyError (or blocking a
                # caller forever on a pump nobody is running)
                state = ("was never start()ed"
                         if not self._ever_started else "is not running")
                raise RuntimeError(
                    f"ticket {rid} (tenant {ten.name!r}) is unresolved and "
                    f"the background pump {state}; a synchronous pump did "
                    "not produce it (taken by a concurrent pump?) — "
                    "start() the server or retry")
            res = ten.results.pop(rid)   # double claim / dropped: KeyError
            ten.tickets.pop(rid, None)
        if isinstance(res, _BatchFailure):
            if isinstance(res.error, (ServerStopped, NumericalFault)):
                raise res.error    # typed errors must survive the claim
            raise RuntimeError(
                f"batch execution failed for ticket {rid}: {res.error}"
            ) from res.error
        return res

    def _drop_rid(self, ten: _Tenant, rid: int) -> None:
        """Caller holds the lock."""
        tk = ten.tickets.pop(rid, None)
        if tk is not None:
            tk._event.set()   # a dropped ticket must never block a waiter
        children = ten.split.pop(rid, None)
        if children is not None:
            ten.parent_left.pop(rid, None)
            for c in children:
                ten.child_parent.pop(c, None)
                self._drop_rid(ten, c)
            return
        if ten.results.pop(rid, None) is None:
            ten.dropped.add(rid)

    def drop(self, ticket: Union[Ticket, int]) -> None:
        """Release an abandoned ticket (client gave up / timed out) so its
        result does not stay resident forever — whether it already executed
        or is still queued (the batch still runs; the output is discarded
        at demux).  Dropping a split parent releases every chunk."""
        ten, rid = self._locate(ticket)
        with self._lock:
            self._drop_rid(ten, rid)

    def __call__(self, *inputs, budget: float = 1.0,
                 tenant: str = "default"):
        """Synchronous convenience: submit + resolve one request (drives the
        pump inline, or waits on the background pump when running)."""
        return self.result(self.submit(*inputs, budget=budget, tenant=tenant))

    # -- telemetry -----------------------------------------------------------
    def _tenant_stats(self, ten: _Tenant) -> Dict[str, Any]:
        s = ten.scheduler.stats()
        tels = [exe.telemetry() for exe in ten.executables()
                if hasattr(exe, "telemetry")]
        if tels:
            hits = sum(t["hits"] for t in tels)
            misses = sum(t["misses"] for t in tels)
            s["hits"], s["misses"] = hits, misses
            s["hit_rate"] = hits / (hits + misses) if hits + misses else 0.0
            s["cached_batches"] = tuple(sorted(
                {b for t in tels for b in t["cached_batches"]}))
        if ten.latencies:
            s["p50_latency_s"] = percentile(ten.latencies, 0.50)
            s["p95_latency_s"] = percentile(ten.latencies, 0.95)
        s["executed_batches"] = ten.executed_batches
        s["numerical_faults"] = ten.numerical_faults
        s["weight"] = ten.weight
        s["points"] = dict(Counter(r.point for r in ten.reports
                                   if r.point is not None))
        # per-bits batch counts: lets the adaptive-switch benchmark attribute
        # latency to weight working points (W8/W4/W2) over the same window
        s["bits_views"] = dict(Counter(r.bits for r in ten.reports
                                       if r.bits is not None))
        # per-bits resident weight bytes: packed-weight executables stream
        # sub-byte packed buffers at W4/W2, so the bytes actually moving
        # from device memory per view are what this reports (not bucket counts)
        s["bits_bytes"] = {
            exe.bits: exe.packed.view_bytes(exe.bits)
            for exe in ten.executables()
            if getattr(exe, "packed", None) is not None
            and getattr(exe, "bits", None) is not None}
        # the closed loops' state: measured per-bucket execution EWMAs and
        # the SLO controller's point/shift telemetry
        s["bucket_latency_s"] = ten.latency.snapshot()
        if ten.controller is not None:
            s["slo"] = ten.controller.telemetry()
        return s

    def stats(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Scheduler counters + executable hit/miss telemetry + latency
        percentiles, per-point batch counts, measured bucket latencies and
        SLO-controller state.  ``tenant=None`` keeps the single-tenant shape
        when only one tenant is registered; with several it returns
        aggregate counters plus a per-tenant breakdown under ``tenants``."""
        if tenant is not None:
            with self._lock:
                return self._tenant_stats(self._tenant(tenant))
        with self._lock:
            s = self._server_stats()
            scrubber = self._scrubber
        # the scrubber's lock is taken with the server's released: its
        # quarantine callback takes the server's lock (``_die``)
        if scrubber is not None:
            s["integrity"] = scrubber.telemetry()
        return s

    def _server_stats(self) -> Dict[str, Any]:
        """:meth:`stats` with no tenant named, less the scrubber's
        telemetry.  Caller holds the lock."""
        if len(self.tenants) == 1:
            s = self._tenant_stats(next(iter(self.tenants.values())))
            s["pump_errors"] = len(self.pump_errors)
            return s
        per = {n: self._tenant_stats(t) for n, t in self.tenants.items()}
        agg: Dict[str, Any] = {"tenants": per}
        for key in ("submitted", "split_requests", "split_chunks",
                    "scheduled_batches", "scheduled_rows", "padded_rows",
                    "pending", "executed_batches", "numerical_faults"):
            agg[key] = sum(p.get(key, 0) for p in per.values())
        rows = agg["scheduled_rows"] + agg["padded_rows"]
        agg["padding_waste"] = agg["padded_rows"] / rows if rows else 0.0
        all_lat = [lat for t in self.tenants.values()
                   for lat in t.latencies]
        if all_lat:
            agg["p50_latency_s"] = percentile(all_lat, 0.50)
            agg["p95_latency_s"] = percentile(all_lat, 0.95)
        agg["pump_errors"] = len(self.pump_errors)
        return agg
