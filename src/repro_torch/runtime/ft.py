"""Fault sources and the straggler watchdog (counterpart of the serving half
of ``repro.runtime.ft``).

``FailureInjector`` drives the chaos layer of the fleet
(:class:`~repro_torch.runtime.fleet.ChaosExecutable`) and
``StragglerWatchdog`` flags latency spikes per replica.  Both draw from
seeded numpy generators exactly as the reference does, so one seed gives the
same fault schedule in both packages.

Not ported yet: the training loop (``run_training``, ``LoopResult`` and its
state helpers), which needs the checkpointer and the token stream; it comes
with the training slice.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

import numpy as np


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
