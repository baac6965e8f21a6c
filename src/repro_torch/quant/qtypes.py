"""Quantization types (counterpart of ``repro.quant.qtypes``).

* **Fixed point** (Vivado ``ap_fixed`` analogue): ``QType(bits, frac)`` —
  signed Qm.n with m = bits-frac integer bits.
* **Native storage**: int8 master codes with W4/W2 as nested views.  torch has
  no usable int4, so every sub-8-bit width is held in int8 codes (or in the
  split-row packed uint8 buffers of :mod:`repro_torch.quant.pack`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dataclasses_field
from typing import Mapping, Optional

import torch


@dataclass(frozen=True)
class QType:
    bits: int
    frac: Optional[int] = None   # None => float passthrough
    signed: bool = True

    @property
    def is_float(self) -> bool:
        return self.frac is None

    @property
    def scale(self) -> float:
        assert self.frac is not None
        return 2.0 ** (-self.frac)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.signed else 2 ** self.bits - 1

    def __str__(self) -> str:
        if self.is_float:
            return "float"
        return f"Q{self.bits - (self.frac or 0)}.{self.frac}"


FLOAT = QType(32, None)


def fixed_for_range(bits: int, max_abs: float) -> QType:
    """Pick the Qm.n split so [-max_abs, max_abs] fits: integer bits cover the
    calibrated range, the remaining bits are fractional (integer bits may be
    negative, as ap_fixed allows)."""
    max_abs = max(float(max_abs), 1e-8)
    int_bits = math.ceil(math.log2(max_abs + 1e-12))   # qmax*scale >= max_abs
    frac = bits - 1 - int_bits                         # 1 sign bit
    return QType(bits, frac)


@dataclass(frozen=True)
class DatatypeConfig:
    """The paper's ``Dx-Wy`` mixed-precision working point."""
    act_bits: int      # x — activation bits (32 = float)
    weight_bits: int   # y — weight bits (32 = float)

    @property
    def name(self) -> str:
        return f"D{self.act_bits}-W{self.weight_bits}"


@dataclass(frozen=True)
class PrecisionMap:
    """Per-layer precision: a default ``Dx-Wy`` point plus node-name
    overrides, stamped onto IR nodes by the precision-assignment pass."""
    default: DatatypeConfig
    per_node: Mapping[str, DatatypeConfig] = dataclasses_field(default_factory=dict)

    def for_node(self, name: str) -> DatatypeConfig:
        return self.per_node.get(name, self.default)

    @property
    def min_act_bits(self) -> int:
        return min([self.default.act_bits] +
                   [c.act_bits for c in self.per_node.values()])

    @property
    def min_weight_bits(self) -> int:
        return min([self.default.weight_bits] +
                   [c.weight_bits for c in self.per_node.values()])

    @property
    def name(self) -> str:
        if not self.per_node:
            return self.default.name
        ov = ",".join(f"{n}:{c.name}" for n, c in sorted(self.per_node.items()))
        return f"{self.default.name}[{ov}]"


# Table II exploration points
TABLE2_POINTS = (
    DatatypeConfig(32, 32),
    DatatypeConfig(16, 16),
    DatatypeConfig(8, 16),
    DatatypeConfig(16, 8),
    DatatypeConfig(16, 4),
    DatatypeConfig(16, 2),
)


def storage_dtype(bits: int) -> torch.dtype:
    """Storage dtype for a weight bit-width (sub-byte widths live in int8
    codes or in split-row packed uint8 buffers)."""
    if bits >= 16:
        return torch.bfloat16
    return torch.int8
