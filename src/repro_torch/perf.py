"""Performance flags (the port's own copy of ``repro.perf``).

Defaults are the optimized configuration; :func:`set_baseline` restores the
first-cut behaviour.  The port holds the flags its code reads:
``ssd_bf16_intra`` (the SSD oracle's intra-chunk math in bf16 when its input
is bf16).  The reference's mesh and attention flags arrive with the slices
that port that code.  Read the flags as ``perf.FLAGS`` at call time:
:func:`set_baseline` rebinds the module attribute.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PerfFlags:
    # intra-chunk SSD math in bf16 (states stay f32)
    ssd_bf16_intra: bool = True


FLAGS = PerfFlags()


def set_baseline() -> None:
    global FLAGS
    FLAGS = PerfFlags(ssd_bf16_intra=False)
