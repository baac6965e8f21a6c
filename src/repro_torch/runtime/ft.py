"""Fault-tolerant training loop and fault sources (counterpart of
``repro.runtime.ft``): checkpoint/restart, failure injection, the straggler
watchdog.

``run_training`` resumes params, optimizer state and the data cursor from
the latest atomic checkpoint after a failure; the token stream is a pure
function of ``(seed, step)``, so a restarted run sees the batches an
uninterrupted one would and ends bit for bit where it ends.  On a real
deployment the failure signal is a missing heartbeat or a collective
timeout; here failures are injected (``FailureInjector``), which takes the
same restart path.  ``FailureInjector`` also drives the chaos layer of the
fleet (:class:`~repro_torch.runtime.fleet.ChaosExecutable`) and
``StragglerWatchdog`` flags latency spikes per replica.  Both draw from
seeded numpy generators exactly as the reference does, so one seed gives
the same fault schedule in both packages.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.device import is_dtensor


class FailureInjector:
    """Deterministic fault source for soak/chaos harnesses.

    Three orthogonal modes, all usable together:

    * ``fail_at`` — raise at exactly these steps, each at most once;
    * ``rate``/``seed`` — seeded probabilistic failures: each ``maybe_fail``
      call draws from its own ``numpy`` generator, so a given seed produces
      the same fault sequence run after run;
    * ``delay_at``/``delay_rate``/``delay_s`` — injectable latency: a
      ``maybe_delay`` call sleeps ``delay_s`` when the step is scheduled
      (fire-once, like ``fail_at``) or the seeded draw hits ``delay_rate``.
      The sleep function is injectable so tests can observe delays without
      waiting them out.
    """

    def __init__(self, fail_at: Optional[List[int]] = None, *,
                 rate: float = 0.0, seed: int = 0,
                 delay_at: Optional[List[int]] = None,
                 delay_rate: float = 0.0, delay_s: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if not 0.0 <= delay_rate <= 1.0:
            raise ValueError(f"delay_rate must be in [0, 1], got {delay_rate}")
        if delay_s < 0.0:
            raise ValueError(f"delay_s must be >= 0, got {delay_s}")
        self.fail_at = set(fail_at or [])
        self.fired = set()
        self.rate = rate
        self.delay_at = set(delay_at or [])
        self.delay_fired = set()
        self.delay_rate = delay_rate
        self.delay_s = delay_s
        self.sleep = sleep
        # independent streams so interleaving fail/delay draws cannot shift
        # each other's schedules
        self._fail_rng = np.random.default_rng(seed)
        self._delay_rng = np.random.default_rng(seed + 1)
        self.injected_failures = 0
        self.injected_delays = 0

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            self.injected_failures += 1
            raise RuntimeError(f"injected node failure at step {step}")
        if self.rate and float(self._fail_rng.random()) < self.rate:
            self.injected_failures += 1
            raise RuntimeError(
                f"injected probabilistic failure at step {step}")

    def maybe_delay(self, step: int) -> bool:
        """Sleep ``delay_s`` when this step draws a delay; True if it did."""
        hit = False
        if step in self.delay_at and step not in self.delay_fired:
            self.delay_fired.add(step)
            hit = True
        if (not hit and self.delay_rate
                and float(self._delay_rng.random()) < self.delay_rate):
            hit = True
        if hit:
            self.injected_delays += 1
            self.sleep(self.delay_s)
        return hit


@dataclass
class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the running median of the last
    ``window`` samples (the fleet marks a flagged replica suspect)."""
    factor: float = 3.0
    window: int = 20
    times: Deque[float] = field(default_factory=deque)
    flagged: List[int] = field(default_factory=list)

    def __post_init__(self):
        # only the last ``window`` samples ever feed the median: bound the
        # buffer so a long run does not grow host memory without limit
        self.times = deque(self.times, maxlen=self.window)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        med = float(np.median(self.times))
        slow = len(self.times) >= 5 and dt > self.factor * med
        if slow:
            self.flagged.append(step)
        return slow


@dataclass
class LoopResult:
    final_step: int
    restarts: int
    metrics_log: List[Dict]
    flagged_steps: List[int]


def run_training(step_fn: Callable, init_state, data_cfg: DataConfig,
                 total_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                 injector: Optional[FailureInjector] = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 state_shardings=None, max_restarts: int = 10) -> LoopResult:
    """Run ``total_steps`` of ``step_fn(state, batch) -> (state, metrics)``
    with checkpoint/restart until completion.  Batches come from
    ``data.tokens.batch_at`` on the device of ``init_state``'s parameters;
    a restored state lands beside ``init_state``'s tensors and must match
    them leaf for leaf (names, shapes, dtypes), else ``ValueError``.
    ``float(metrics["loss"])`` waits for each step.  A step that raises
    ``RuntimeError`` restarts from the latest checkpoint, at most
    ``max_restarts`` times.  ``state_shardings`` (a TrainState of
    :class:`repro_torch.sharding.NamedSharding`, as
    ``train.state_shardings`` gives) places a restored state onto a device
    mesh, whatever mesh wrote it: the reference's elastic re-mesh.  On a
    mesh every rank runs the loop, and rank 0 writes the checkpoints."""
    injector = injector or FailureInjector()
    watchdog = watchdog or StragglerWatchdog()
    saver = ckpt.AsyncCheckpointer(ckpt_dir)
    device = next(iter(init_state.params.values())).device
    restarts = 0
    log: List[Dict] = []

    shardings = None if state_shardings is None else _to_tree(state_shardings)
    latest = ckpt.latest_step(ckpt_dir)
    if latest is not None:
        tree, step0, _ = ckpt.restore(ckpt_dir, latest, shardings)
        state, step = _to_state(init_state, tree), step0
    else:
        state, step = init_state, 0
        saver.save(_to_tree(state), 0, {"data_step": 0})

    while step < total_steps:
        try:
            t0 = time.monotonic()
            injector.maybe_fail(step)
            batch = batch_at(data_cfg, step, device)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            watchdog.observe(step, dt)
            log.append({"step": step, "loss": loss, "dt": dt})
            step += 1
            if step % ckpt_every == 0:
                saver.save(_to_tree(state), step, {"data_step": step})
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            saver.wait()
            latest = ckpt.latest_step(ckpt_dir)
            tree, step, _ = ckpt.restore(ckpt_dir, latest, shardings)
            state = _to_state(init_state, tree)
    saver.wait()
    saver.save(_to_tree(state), step, {"data_step": step})
    saver.wait()
    return LoopResult(step, restarts, log, watchdog.flagged)


def _to_tree(state) -> Dict:
    """TrainState -> plain nested dict for the checkpointer."""
    d = {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu,
         "count": {"count": state.opt.count}}
    if state.err_fb is not None:
        d["err_fb"] = state.err_fb
    return d


def _to_state(proto, tree):
    """A restored tree -> TrainState, each leaf on the device of its
    counterpart in ``proto`` (the state the run started from).  Raises
    ``ValueError`` when the checkpoint is not a state of the same model and
    options: other leaf names, shapes or dtypes, or error feedback present
    in one and not the other."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.runtime.train import TrainState

    def beside(part, leaves, like):
        if set(leaves) != set(like):
            raise ValueError(
                f"checkpoint's {part} leaves differ from the run's: only in "
                f"the checkpoint {sorted(set(leaves) - set(like))}, only in "
                f"the run {sorted(set(like) - set(leaves))}")
        for k, v in leaves.items():
            if v.shape != like[k].shape or v.dtype != like[k].dtype:
                raise ValueError(
                    f"checkpoint's {part}[{k!r}] is {v.dtype} "
                    f"{tuple(v.shape)}, the run's {like[k].dtype} "
                    f"{tuple(like[k].shape)}")
        # a leaf restored onto a mesh is placed already
        return {k: v if is_dtensor(v) else v.to(like[k].device)
                for k, v in leaves.items()}

    if ("err_fb" in tree) != (proto.err_fb is not None):
        raise ValueError("checkpoint and run differ in error feedback "
                         "(grad_compress)")
    count = beside("count", tree["count"],
                   {"count": proto.opt.count})["count"]
    return TrainState(
        params=beside("params", tree["params"], proto.params),
        opt=OptState(mu=beside("mu", tree["mu"], proto.opt.mu),
                     nu=beside("nu", tree["nu"], proto.opt.nu),
                     count=count),
        err_fb=(None if proto.err_fb is None else
                beside("err_fb", tree["err_fb"], proto.err_fb)))
