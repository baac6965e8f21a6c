"""Deterministic, resumable synthetic token stream (counterpart of
``repro.data.tokens``).

Every batch is a pure function of ``(seed, step)``: a counter-based draw,
so restarting from a checkpoint at step k reproduces exactly the batches a
run that never failed would have seen, with no loader state beyond the
step.  The draw runs on a CPU ``torch.Generator`` seeded from a 64-bit mix
of ``(seed, step)`` and is then moved to the device, so the stream is the
same on the CPU and on the card (a CUDA generator's Philox stream is not
the CPU's).  The data has the reference's shape: a Zipf-ish marginal (the
inverse CDF on ``u**3``), tokens in ``[1, vocab-1]``, every 4th position
repeating the token three before it (a learnable signal), and labels the
tokens shifted by one.

The tokens are not the reference's bit for bit: it draws with jax's
threefry (``fold_in(PRNGKey(seed), step)``).  A parity test that needs the
same batches feeds the reference's ``host_batch_at`` to both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _mix(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step): splitmix64's finalizer
    over the two words, so neighbouring steps get unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 0x632BE59BD9B4E019) & _MASK64
    for shift, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        z = ((z ^ (z >> shift)) * mul) & _MASK64
    return (z ^ (z >> 31)) >> 1


def batch_at(cfg: DataConfig, step: int,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The full global batch of ``step`` (int32 tokens and labels, each
    (global_batch, seq_len)) on ``device`` (default: the card)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(_mix(cfg.seed, step))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    u = torch.rand((B, S + 1), generator=g)
    base = (u ** 3 * (V - 2)).to(torch.int32) + 1
    rep = torch.roll(base, 3, dims=1)
    every4 = (torch.arange(S + 1) % 4 == 0)[None, :]
    toks = torch.where(every4, rep, base).to(dev)
    return {"tokens": toks[:, :S], "labels": toks[:, 1:]}


def host_batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """:func:`batch_at` as host numpy arrays (drawn on the CPU)."""
    return {k: v.numpy() for k, v in batch_at(cfg, step, "cpu").items()}


class TokenStream:
    """Iterator with an explicit cursor (for a fault-tolerant loop)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = batch_at(self.cfg, self.step, self.device)
        self.step += 1
        return b

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: Dict[str, int],
                device: DeviceLike = None) -> "TokenStream":
        if state["seed"] != cfg.seed:
            raise ValueError(f"data seed mismatch on restore: state has "
                             f"{state['seed']}, config {cfg.seed}")
        return cls(cfg, start_step=state["step"], device=device)
