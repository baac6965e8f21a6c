"""Weight-memory integrity: SDC detection, scrubbing, self-healing buffers
(counterpart of ``repro.runtime.integrity``).

One shared :class:`~repro_torch.quant.pack.PackedWeights` buffer backs every
W8/W4/W2 working point on every replica, so a single-event upset there
corrupts them all at once.  This module closes that gap:

* :class:`Scrubber` — a rate-bounded daemon (bytes/sec cap) that walks the
  buffer's checksummed regions round-robin.  Corrupted W4/W2 packed views
  are repaired in place (re-derived bit-exactly from the intact master
  codes); master-code or scale corruption is unrepairable and escalates
  through ``on_quarantine`` — :meth:`AccelServer.attach_scrubber
  <repro_torch.runtime.serve.AccelServer.attach_scrubber>` turns that into a
  fatal typed :class:`IntegrityError` and the fleet sentinel ejects the
  replica with a ``quarantined`` cause and heals it through its factory.
* :class:`CanarySet` — K calibration input → output pairs fingerprinted per
  working point and replayed through the real submit/result path by the
  fleet sentinel, catching corruption the checksums cannot see.
* :class:`BitFlipInjector` — seeded SEU chaos over the live buffers: one
  seed flips the same (region, byte, bit) sequence as the reference's.

The port's executables read the live buffers on every call
(``PackedTensor.codes_2d()`` / ``packed_view(bits)``), where a reference
executable keeps the arrays its trace captured.  So a flip here reaches
served results until the scrubber detects it; from detection on, the server
is fatal and serves nothing (see ``AccelServer._finish``).  On the GPU each
region hash is one copy of the region to the host, on the default stream,
behind the serving work queued ahead of it; ``rate_bytes_s`` counts region
bytes, as in the reference.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import to_numpy
from repro_torch.quant.pack import PackedWeights, Region, RegionMismatch

__all__ = [
    "BitFlipInjector", "CanarySet", "FlipRecord", "IntegrityError",
    "Scrubber",
]


class IntegrityError(RuntimeError):
    """Typed fatal: unrepairable weight-memory corruption was detected
    (master codes or scales — no redundant source to re-derive from).  A
    server whose scrubber raises this refuses further work, so no
    post-detection corrupted result is ever served; the fleet sentinel
    ejects it with a ``quarantined`` cause and heals via the factory."""

    def __init__(self, message: str,
                 mismatches: Sequence[RegionMismatch] = ()):
        super().__init__(message)
        self.mismatches = list(mismatches)


# ---------------------------------------------------------------------------
# background scrubber
# ---------------------------------------------------------------------------

class Scrubber:
    """Rate-bounded background memory scrubber over ONE shared
    :class:`~repro_torch.quant.pack.PackedWeights` buffer.

    Regions (master codes, per-channel scales, each cached sub-byte packed
    view) are walked round-robin; each pass over the full region list is one
    *scrub period*.  ``rate_bytes_s`` caps how many bytes are re-hashed per
    second so scrubbing never starves the serving pump; ``interval_s`` is
    the daemon's tick.  Any flip in a region is caught the next time the
    cursor reaches it, i.e. within one full period of the flip.

    On mismatch the region is quarantined, then:

    * **view** regions are repaired in place (re-derived from the master
      codes after verifying the master is itself intact) and released from
      quarantine — ``on_repair(mismatch)`` fires;
    * **codes** / **scale** regions stay quarantined and
      ``on_quarantine(mismatch)`` fires exactly once per region.

    Drive it as a daemon (:meth:`start`/:meth:`stop`) or deterministically
    with :meth:`scrub_once` (tests).  All state is lock-guarded.
    """

    def __init__(self, packed: PackedWeights, *,
                 rate_bytes_s: float = 8e6,
                 interval_s: float = 0.005,
                 on_repair: Optional[Callable[[RegionMismatch], None]] = None,
                 on_quarantine: Optional[Callable[[RegionMismatch], None]]
                 = None,
                 clock: Callable[[], float] = time.monotonic):
        if rate_bytes_s <= 0:
            raise ValueError(f"rate_bytes_s must be > 0, got {rate_bytes_s}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.packed = packed
        self.rate_bytes_s = float(rate_bytes_s)
        self.interval_s = float(interval_s)
        self.clock = clock
        self._on_repair = [on_repair] if on_repair else []
        self._on_quarantine = [on_quarantine] if on_quarantine else []
        self._lock = threading.RLock()
        self._cursor = 0
        self._budget = 0.0           # accumulated byte allowance
        self._last_tick: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # telemetry
        self.scrubbed_bytes = 0
        self.scrub_passes = 0        # completed full walks of the region list
        self.detected_flips = 0
        self.repaired_views = 0
        self.quarantines = 0         # unrepairable regions quarantined
        self.quarantined: Dict[str, RegionMismatch] = {}

    # -- observer registration ----------------------------------------------
    def add_on_repair(self, fn: Callable[[RegionMismatch], None]) -> None:
        with self._lock:
            self._on_repair.append(fn)

    def add_on_quarantine(self, fn: Callable[[RegionMismatch], None]) -> None:
        with self._lock:
            self._on_quarantine.append(fn)

    @property
    def fatal(self) -> Optional[IntegrityError]:
        """The unrepairable-corruption error, once any region is
        permanently quarantined (None while the buffer is servable)."""
        with self._lock:
            if not self.quarantined:
                return None
            return IntegrityError(
                "unrepairable weight-memory corruption: "
                + "; ".join(str(m) for m in self.quarantined.values()),
                list(self.quarantined.values()))

    # -- one region ----------------------------------------------------------
    def _handle(self, mismatch: RegionMismatch
                ) -> List[Callable[[RegionMismatch], None]]:
        """Quarantine + repair-or-escalate one detected mismatch.  Caller
        holds the lock; returns the callbacks to run once it is released,
        so a callback may take its own locks (a server's ``_die``) while a
        thread holding those calls :meth:`telemetry`."""
        label = mismatch.region.label()
        self.detected_flips += 1
        if mismatch.repairable:
            # repair only from a verified-intact master: re-deriving from a
            # corrupted master would launder the corruption
            master = Region(mismatch.region.tensor, "codes")
            if self.packed.verify_region(master) is None:
                self.packed.repair(mismatch)
                self.repaired_views += 1
                return list(self._on_repair)
            # master is corrupt too: escalate the view as collateral (the
            # master's own walk quarantines it as well)
        if label not in self.quarantined:
            self.quarantined[label] = mismatch
            self.quarantines += 1
            return list(self._on_quarantine)
        return []

    # -- scrub passes --------------------------------------------------------
    def scrub_once(self, max_bytes: Optional[float] = None) -> int:
        """Verify regions from the round-robin cursor until ``max_bytes``
        is spent (None = one full pass).  Returns the number of regions
        verified.  The deterministic entry point the daemon ticks call.
        The lock is held one region at a time, and a detection's callbacks
        run between regions with it released."""
        regions = self.packed.regions()
        if not regions:
            return 0
        n = len(regions)
        budget = float("inf") if max_bytes is None else float(max_bytes)
        verified = 0
        # cap at one full pass per call: the cursor wrapping to its
        # start means every live region was checked once
        for _ in range(n):
            if budget <= 0:
                break
            fire: List[Callable[[RegionMismatch], None]] = []
            with self._lock:
                region = regions[self._cursor % n]
                self._cursor = (self._cursor + 1) % n
                if self._cursor == 0:
                    self.scrub_passes += 1
                if region.label() in self.quarantined:
                    continue   # off-duty: unrepairable, already escalated
                mismatch = self.packed.verify_region(region)
                self.scrubbed_bytes += region.nbytes
                budget -= region.nbytes
                verified += 1
                if mismatch is not None:
                    fire = self._handle(mismatch)
            for fn in fire:
                fn(mismatch)
        return verified

    def _tick(self) -> int:
        """One daemon tick: accrue byte allowance from elapsed wall time
        (the rate bound) and spend it."""
        now = self.clock()
        with self._lock:
            if self._last_tick is None:
                self._last_tick = now
                return 0
            elapsed, self._last_tick = now - self._last_tick, now
            # cap the accrued budget at ~2 full passes so a long stall does
            # not burst an unbounded scan into one tick
            total = sum(r.nbytes for r in self.packed.regions()) or 1
            self._budget = min(self._budget + elapsed * self.rate_bytes_s,
                               2.0 * total)
            budget = self._budget
            before = self.scrubbed_bytes
        verified = self.scrub_once(max_bytes=budget)
        with self._lock:
            self._budget = max(0.0, self._budget
                               - (self.scrubbed_bytes - before))
        return verified

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            self._tick()

    def start(self) -> "Scrubber":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError("scrubber already running")
            self._stop_evt.clear()
            self._last_tick = None
            self._thread = threading.Thread(
                target=self._run, name="weight-scrubber", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
        self._stop_evt.set()
        if t is not None:
            t.join(timeout)

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def __enter__(self) -> "Scrubber":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- telemetry -----------------------------------------------------------
    def period_bytes(self) -> int:
        """Bytes in one full scrub period (the current region list)."""
        return sum(r.nbytes for r in self.packed.regions())

    def telemetry(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "scrubbed_bytes": self.scrubbed_bytes,
                "scrub_passes": self.scrub_passes,
                "detected_flips": self.detected_flips,
                "repaired_views": self.repaired_views,
                "quarantines": self.quarantines,
                "quarantined": sorted(self.quarantined),
                "rate_bytes_s": self.rate_bytes_s,
            }


# ---------------------------------------------------------------------------
# semantic canaries
# ---------------------------------------------------------------------------

@dataclass
class _Canary:
    inputs: Tuple[np.ndarray, ...]
    # point name -> expected outputs (tuple of arrays, len 1 if single)
    expected: Dict[str, Tuple[np.ndarray, ...]]


def _host(out: Any) -> Tuple[np.ndarray, ...]:
    """An executable's output (one tensor/array or a tuple) as host arrays."""
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(to_numpy(o) for o in outs)


@dataclass
class CanarySet:
    """K calibration input → output pairs fingerprinted per working point.

    Checksums see *storage* corruption; canaries see *semantic* corruption —
    a kernel regression, scale drift — by replaying known inputs through the
    real submit/result path and comparing against the outputs captured at
    build time.  A probe's serving point depends on the live selector
    (brownout may have downshifted the fleet), so :meth:`check` accepts a
    result that matches ANY captured point's fingerprint within tolerance.
    Device outputs are copied to the host for the comparison.
    """

    canaries: List[_Canary] = field(default_factory=list)
    rtol: float = 1e-4
    atol: float = 1e-5

    @classmethod
    def capture(cls, point_executables: Dict[str, Callable],
                calib_inputs: Sequence[Sequence[Any]], *, k: int = 2,
                rtol: float = 1e-4, atol: float = 1e-5) -> "CanarySet":
        """Fingerprint ``k`` calibration requests through every point
        executable at build time.  ``calib_inputs`` is a sequence of
        argument tuples (one per request, each the positional inputs a
        submit would take)."""
        cs = cls(rtol=rtol, atol=atol)
        for args in list(calib_inputs)[:k]:
            args = tuple(np.array(to_numpy(a)) for a in args)
            expected = {name: tuple(np.array(o) for o in _host(exe(*args)))
                        for name, exe in point_executables.items()}
            cs.canaries.append(_Canary(args, expected))
        if not cs.canaries:
            raise ValueError("CanarySet.capture needs at least one "
                             "calibration request")
        return cs

    def __len__(self) -> int:
        return len(self.canaries)

    def inputs(self, i: int) -> Tuple[np.ndarray, ...]:
        return self.canaries[i % len(self.canaries)].inputs

    def check(self, i: int, result: Any) -> bool:
        """True when ``result`` matches any captured working point's
        fingerprint for canary ``i`` within tolerance (and is finite)."""
        outs = _host(result)
        for o in outs:
            if np.issubdtype(o.dtype, np.floating) and not np.isfinite(o).all():
                return False
        for expected in self.canaries[i % len(self.canaries)].expected.values():
            if len(expected) != len(outs):
                continue
            if all(np.allclose(o, e, rtol=self.rtol, atol=self.atol)
                   for o, e in zip(outs, expected)):
                return True
        return False


# ---------------------------------------------------------------------------
# SEU chaos
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FlipRecord:
    """One injected bit flip (for the detection accounting)."""
    step: int
    region: Region
    byte: int
    bit: int


class BitFlipInjector:
    """Seeded single-event-upset source for the live packed buffers.

    ``flip_at`` steps fire once each, a seeded ``rate`` draws continuous
    soak flips, and every flip picks a region (master codes / cached packed
    view / scales, filtered by ``kinds``), a byte and a bit from the same
    seeded stream — a given seed produces the identical flip sequence run
    after run, and the reference's sequence over the same regions.  Flips
    replace the buffers the scrubber hashes and the executables read, NOT
    copies, so detection and repair are exercised end to end.
    """

    def __init__(self, packed: PackedWeights, *,
                 flip_at: Optional[List[int]] = None,
                 rate: float = 0.0, seed: int = 0,
                 kinds: Sequence[str] = ("codes", "view", "scale")):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        bad = set(kinds) - {"codes", "view", "scale"}
        if bad:
            raise ValueError(f"unknown region kinds: {sorted(bad)}")
        self.packed = packed
        self.flip_at = set(flip_at or [])
        self.fired: set = set()
        self.rate = rate
        self.kinds = tuple(kinds)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.flips: List[FlipRecord] = []

    @property
    def injected_flips(self) -> int:
        return len(self.flips)

    def _candidates(self) -> List[Region]:
        return [r for r in self.packed.regions() if r.kind in self.kinds]

    def _corrupt(self, region: Region, byte: int, bit: int) -> None:
        """Flip one bit of one region's live buffer.  The tensor is replaced
        by a flipped copy on its own device (same dtype and shape, one bit
        off); the old tensor is never written, since a kernel queued on the
        device may still be reading it."""
        t = self.packed.tensors[region.tensor]
        if region.kind == "codes":
            old = t.codes
        elif region.kind == "scale":
            old = t.scale
        else:
            with t._lock:
                old = t._packed[(region.bits, region.align)]
        buf = np.array(to_numpy(old))          # a private host copy
        flat = buf.reshape(-1).view(np.uint8)
        flat[byte % flat.size] ^= np.uint8(1 << bit)
        new = torch.from_numpy(buf).to(old.device)
        if region.kind == "codes":
            t.codes = new
        elif region.kind == "scale":
            t.scale = new
        else:
            with t._lock:
                t._packed[(region.bits, region.align)] = new

    def flip(self, step: int = -1, region: Optional[Region] = None
             ) -> Optional[FlipRecord]:
        """Inject one bit flip (into ``region``, or a seeded-random
        candidate).  Returns the record, or None when no candidate region
        exists yet (no views cached and ``kinds`` excludes the master)."""
        with self._lock:
            if region is None:
                cands = self._candidates()
                if not cands:
                    return None
                region = cands[int(self._rng.integers(len(cands)))]
            byte = int(self._rng.integers(max(region.nbytes, 1)))
            bit = int(self._rng.integers(8))
            self._corrupt(region, byte, bit)
            rec = FlipRecord(step, region, byte, bit)
            self.flips.append(rec)
            return rec

    def maybe_flip(self, step: int) -> Optional[FlipRecord]:
        """The FailureInjector-style entry: fire scheduled ``flip_at`` steps
        once each, then seeded ``rate`` draws."""
        with self._lock:
            scheduled = step in self.flip_at and step not in self.fired
            if scheduled:
                self.fired.add(step)
            drawn = (not scheduled and self.rate
                     and float(self._rng.random()) < self.rate)
        if scheduled or drawn:
            return self.flip(step)
        return None
