"""Performance flags (the port's own copy of ``repro.perf``).

Defaults are the optimized configuration; :func:`set_baseline` restores the
first-cut behaviour.  The port holds the flags its code reads: the SSD
oracle's ``ssd_bf16_intra``, attention's ``gqa_grouped``, ``swa_banded``
and ``attn_bf16_scores``, and the mesh layout pins ``attn_head_constraint``
and ``ssd_constraint`` (read only when a model runs on a device mesh).
Read the flags as ``perf.FLAGS`` at call time: :func:`set_baseline`
rebinds the module attribute.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PerfFlags:
    # on a mesh: pin q/k/v to head-sharded layouts so the d_head contraction
    # is never split across the model axis
    attn_head_constraint: bool = True
    # intra-chunk SSD math in bf16 (states stay f32)
    ssd_bf16_intra: bool = True
    # on a mesh: pin the SSD inner activations to model-sharded layouts
    ssd_constraint: bool = True
    # GQA attention without materializing repeated kv heads
    gqa_grouped: bool = True
    # sliding-window prefill computes only the key band
    swa_banded: bool = True
    # attention score tensors in bf16 when activations are bf16
    attn_bf16_scores: bool = True


FLAGS = PerfFlags()


def set_baseline() -> None:
    global FLAGS
    FLAGS = PerfFlags(attn_head_constraint=False, ssd_bf16_intra=False,
                      ssd_constraint=False, gqa_grouped=False,
                      swa_banded=False, attn_bf16_scores=False)
