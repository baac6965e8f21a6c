"""Performance flags (the port's own copy of ``repro.perf``).

Defaults are the optimized configuration; :func:`set_baseline` restores the
first-cut behaviour.  The port holds the flags its code reads: the SSD
oracle's ``ssd_bf16_intra`` and attention's ``gqa_grouped``, ``swa_banded``
and ``attn_bf16_scores``.  The reference's mesh flags
(``attn_head_constraint``, ``ssd_constraint``) arrive with the distributed
slice.  Read the flags as ``perf.FLAGS`` at call time: :func:`set_baseline`
rebinds the module attribute.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PerfFlags:
    # intra-chunk SSD math in bf16 (states stay f32)
    ssd_bf16_intra: bool = True
    # GQA attention without materializing repeated kv heads
    gqa_grouped: bool = True
    # sliding-window prefill computes only the key band
    swa_banded: bool = True
    # attention score tensors in bf16 when activations are bf16
    attn_bf16_scores: bool = True


FLAGS = PerfFlags()


def set_baseline() -> None:
    global FLAGS
    FLAGS = PerfFlags(ssd_bf16_intra=False, gqa_grouped=False,
                      swa_banded=False, attn_bf16_scores=False)
