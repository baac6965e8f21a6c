"""Packed weight storage: the one-copy-many-points artifact (counterpart of
``repro.quant.pack``).

* :class:`PackedWeights` / :class:`PackedTensor` — every >=2-D initializer of
  a graph quantized ONCE to int8 master codes + per-output-channel f32 scales,
  held on the writer's device.  W4/W2 working points are nested truncations
  of the same codes, so every working point reads ONE buffer.
* sub-byte residency: ``PackedTensor.packed_view(bits)`` stores the W4/W2
  views packed into ``uint8`` with the *split-row* layout (:func:`pack_rows`),
  cached once on the same device; the kernels unpack each tile in registers.
* CRC32 seals over every region (codes, scales, each cached view), hashed over
  the buffers' host bytes, so a seal taken on the GPU equals the reference's
  (on the GPU each hash is one copy of the region to the host); a corrupted
  view re-derives from the master codes (:meth:`PackedWeights.repair`).
* generic bit-packing helpers (int4: 2/byte, int2: 4/byte) along the last
  dim (:func:`pack_int4` / :func:`pack_int2`).

Split-row layout: ``pack_rows(codes, bits)`` pads K (the reduction dim) up to
``align``, splits the rows into ``r = 8 // bits`` contiguous chunks of
``Kp / r`` rows, and packs row ``i`` of every chunk into one byte (chunk
``j`` occupies bit field ``j*bits``).  The stored field is the true
``bits``-bit integer ``q = view / 2^(8-bits)``.
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import as_tensor, to_numpy

# K-dim alignment of the packed buffers the qgemm path streams (the
# reference's matmul tile; kept so packed bytes match the reference's)
PACK_ALIGN = 128

# working points with a sub-byte packed representation
SUB_BYTE_BITS = (4, 2)


def _crc32(arr) -> int:
    """CRC32 of a buffer's raw host bytes (the per-region checksum)."""
    return zlib.crc32(np.ascontiguousarray(to_numpy(arr)).tobytes())


@dataclass(frozen=True)
class Region:
    """One independently-checksummed buffer of a :class:`PackedWeights`:
    a tensor's int8 master codes, its f32 per-channel scales, or one cached
    sub-byte packed view (identified by ``(bits, align)``)."""
    tensor: str
    kind: str                  # "codes" | "scale" | "view"
    bits: Optional[int] = None     # view regions only
    align: Optional[int] = None    # view regions only
    nbytes: int = 0

    def label(self) -> str:
        if self.kind == "view":
            return f"{self.tensor}:view(w{self.bits},align={self.align})"
        return f"{self.tensor}:{self.kind}"


@dataclass(frozen=True)
class RegionMismatch:
    """A failed region verification: the buffer's bytes no longer hash to
    the checksum sealed at pack time.  View regions re-derive from the
    master codes; master-code or scale corruption has no redundant source."""
    region: Region
    expected_crc: int
    actual_crc: int

    @property
    def repairable(self) -> bool:
        return self.region.kind == "view"

    def __str__(self) -> str:
        fix = "repairable from master" if self.repairable else "UNREPAIRABLE"
        return (f"checksum mismatch in {self.region.label()} "
                f"({self.region.nbytes} bytes, expected "
                f"{self.expected_crc:#010x}, got {self.actual_crc:#010x}; "
                f"{fix})")


def _pad_rows(codes: torch.Tensor, align: int) -> torch.Tensor:
    r = (-codes.shape[0]) % align
    if r == 0:
        return codes
    pad = torch.zeros((r, *codes.shape[1:]), dtype=codes.dtype,
                      device=codes.device)
    return torch.cat([codes, pad], dim=0)


def pack_rows(codes, bits: int, align: int = PACK_ALIGN) -> torch.Tensor:
    """int8 master codes (K, N) -> split-row packed uint8 (Kp/r, N), on the
    codes' device.  ``q`` is the rounded nested truncation — identical to
    ``derive_view(codes, bits) / 2^(8-bits)``."""
    if bits not in SUB_BYTE_BITS:
        raise ValueError(f"no sub-byte packing for bits={bits}")
    r = 8 // bits
    step = 1 << (8 - bits)
    half = 1 << (bits - 1)
    cp = _pad_rows(as_tensor(codes), align)
    kp = cp.shape[0]
    q = torch.clamp(torch.round(cp.to(torch.float32) / step),
                    -half, half - 1).to(torch.int32)
    chunks = q.reshape(r, kp // r, *cp.shape[1:])
    mask = (1 << bits) - 1
    out = torch.zeros(chunks.shape[1:], dtype=torch.int32, device=cp.device)
    for j in range(r):
        out = out | ((chunks[j] & mask) << (j * bits))
    return out.to(torch.uint8)


def unpack_rows(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Split-row packed uint8 (Kp/r, N) -> int8 codes (Kp, N) in the *view*
    domain (``q * 2^(8-bits)``, i.e. exactly ``derive_view`` of the master)."""
    if bits not in SUB_BYTE_BITS:
        raise ValueError(f"no sub-byte packing for bits={bits}")
    r = 8 // bits
    step = 1 << (8 - bits)
    half = 1 << (bits - 1)
    mask = (1 << bits) - 1
    p = packed.to(torch.int32)
    chunks = []
    for j in range(r):
        f = (p >> (j * bits)) & mask
        q = torch.where(f >= half, f - (1 << bits), f)
        chunks.append(q * step)
    return torch.cat(chunks, dim=0).to(torch.int8)


@dataclass
class PackedTensor:
    """One weight, quantized once: int8 master codes + per-out-channel scale,
    both on the writer's device.

    ``codes`` keeps the original weight shape (HWIO for conv, (K, N) for
    Gemm); ``scale`` is f32 with keepdims over every axis but the last.  The
    W4/W2 views cache one sub-byte packed buffer each (:meth:`packed_view`).
    Every region is sealed with a CRC32 of its host bytes."""

    codes: torch.Tensor     # int8, original weight shape
    scale: torch.Tensor     # f32, per-output-channel (last dim), keepdims
    # cache key: (bits, K-alignment) — one resident buffer per view
    _packed: Dict[tuple, torch.Tensor] = field(default_factory=dict,
                                               repr=False, compare=False)
    # sealed checksums: "codes" / "scale" / ("view", bits, align) -> CRC32
    _crc: Dict[object, int] = field(default_factory=dict, repr=False,
                                    compare=False)
    # guards first-touch view derivation AND checksum sealing
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    def __post_init__(self):
        self.seal()

    def seal(self) -> None:
        """(Re)seal the master-code and scale checksums from the CURRENT
        buffers."""
        with self._lock:
            self._crc["codes"] = _crc32(self.codes)
            self._crc["scale"] = _crc32(self.scale)

    def view(self, bits: int) -> torch.Tensor:
        """The ``bits``-bit nested-truncation view of the master codes."""
        from repro_torch.quant.ptq import derive_view
        return derive_view(self.codes, bits)

    def dequant(self, bits: int = 8,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        from repro_torch.quant.ptq import dequant
        return dequant(self.codes, self.scale, bits, dtype)

    def codes_2d(self) -> torch.Tensor:
        """Codes flattened to (K, N) for the kernels (N = out channels)."""
        return self.codes.reshape(-1, self.codes.shape[-1])

    def scale_1d(self) -> torch.Tensor:
        return self.scale.reshape(-1)

    def packed_view(self, bits: int, align: int = PACK_ALIGN) -> torch.Tensor:
        """Split-row sub-byte packed W4/W2 buffer (cached on the codes'
        device; K padded to ``align``).  The qgemm path uses the default
        alignment, the depthwise kernel a small one so a 3x3 window (K = 9)
        is not padded 14x."""
        if bits not in SUB_BYTE_BITS:
            raise ValueError(f"packed_view is for bits in {SUB_BYTE_BITS}, "
                             f"got {bits} (the W8 view IS the master codes)")
        key = (bits, int(align))
        with self._lock:
            buf = self._packed.get(key)
            if buf is None:
                buf = pack_rows(self.codes_2d(), bits, align=align)
                self._packed[key] = buf
                self._crc[("view", *key)] = _crc32(buf)
        return buf

    # -- integrity -----------------------------------------------------------
    def regions(self, name: str, bits: Optional[int] = None) -> List[Region]:
        """The checksummed regions of this tensor: ``None`` = every region;
        ``8`` = master codes + scales; ``4``/``2`` = that point's cached packed
        views + the scales."""
        regs: List[Region] = []
        with self._lock:
            views = {k: int(v.numel()) for k, v in self._packed.items()}
        if bits is None or bits == 8:
            regs.append(Region(name, "codes", nbytes=int(self.codes.numel())))
        regs.append(Region(name, "scale", nbytes=4 * int(self.scale.numel())))
        for (b, align), nb in views.items():
            if bits is None or b == bits:
                regs.append(Region(name, "view", bits=b, align=align,
                                   nbytes=nb))
        return regs

    def _buffer(self, region: Region) -> Optional[torch.Tensor]:
        if region.kind == "codes":
            return self.codes
        if region.kind == "scale":
            return self.scale
        with self._lock:
            return self._packed.get((region.bits, region.align))

    def _sealed_crc(self, region: Region) -> Optional[int]:
        key = (region.kind if region.kind != "view"
               else ("view", region.bits, region.align))
        with self._lock:
            return self._crc.get(key)

    def verify_region(self, region: Region) -> Optional[RegionMismatch]:
        """Re-hash one region against its sealed checksum; ``None`` = clean."""
        buf = self._buffer(region)
        expected = self._sealed_crc(region)
        if buf is None or expected is None:
            return None
        actual = _crc32(buf)
        if actual == expected:
            return None
        return RegionMismatch(region, expected, actual)

    def verify(self, name: str, bits: Optional[int] = None
               ) -> List[RegionMismatch]:
        return [m for m in (self.verify_region(r)
                            for r in self.regions(name, bits))
                if m is not None]

    def repair_view(self, bits: int, align: int = PACK_ALIGN) -> torch.Tensor:
        """Re-derive one packed view bit-exactly from the master codes into a
        NEW tensor and reseal its checksum (the old buffer is left untouched
        for any kernel still reading it).  The caller must have verified the
        master codes first: repairing from a corrupted master would launder
        the corruption into a 'clean' checksum."""
        if bits not in SUB_BYTE_BITS:
            raise ValueError(f"only sub-byte views are repairable, got "
                             f"bits={bits}")
        key = (bits, int(align))
        with self._lock:
            fresh = pack_rows(self.codes_2d(), bits, align=align)
            self._packed[key] = fresh
            self._crc[("view", *key)] = _crc32(fresh)
        return fresh

    @property
    def nbytes(self) -> int:
        """Master storage: 1 byte/code + 4 bytes/scale (shared by all points)."""
        return int(self.codes.numel()) + 4 * int(self.scale.numel())

    def view_nbytes(self, bits: int, align: int = PACK_ALIGN) -> int:
        """Resident bytes of the ``bits``-bit view on the kernel path: the
        streamed weight buffer (K padded to ``align``, sub-byte packed below
        W8) plus the f32 channel scales."""
        k, n = self.codes_2d().shape
        kp = k + ((-k) % align)
        if bits in SUB_BYTE_BITS:
            buf = (kp // (8 // bits)) * n
        else:
            buf = kp * n
        return buf + 4 * int(self.scale.numel())


@dataclass
class PackedWeights:
    """All of a graph's quantizable initializers packed to shared master
    codes on one device; ``passthrough`` holds everything that stays float
    (biases, norm stats, 1-D tensors)."""

    tensors: Dict[str, PackedTensor]
    passthrough: Dict[str, torch.Tensor]

    @classmethod
    def from_initializers(cls, initializers: Dict,
                          device=None) -> "PackedWeights":
        """Quantize on the host (so the codes are the same bytes whatever the
        device) and place codes, scales and passthrough tensors ONCE on
        ``device`` (default: the CPU)."""
        from repro_torch.quant.ptq import is_quantizable, quantize_channelwise
        dev = torch.device("cpu") if device is None else torch.device(device)
        tensors, passthrough = {}, {}
        for name, arr in initializers.items():
            w = as_tensor(arr).detach().cpu()
            if is_quantizable(name, w):
                codes, scale = quantize_channelwise(w)
                tensors[name] = PackedTensor(codes.to(dev), scale.to(dev))
            else:
                passthrough[name] = w.to(dev)
        return cls(tensors, passthrough)

    def dequantized(self, bits: int = 8,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
        """Fake-quant float copies at a working point (the pre-packed-engine
        baseline: what each per-point executable used to hold)."""
        out = dict(self.passthrough)
        for name, t in self.tensors.items():
            out[name] = t.dequant(bits, dtype)
        return out

    def code_bytes(self) -> int:
        """Bytes of the shared master buffer (codes + scales)."""
        return sum(t.nbytes for t in self.tensors.values())

    # -- integrity -----------------------------------------------------------
    def regions(self, bits: Optional[int] = None) -> List[Region]:
        """Every checksummed region across all tensors, in the reference's
        order (per tensor: codes, scale, then each view as it was first
        derived) — the scrubber's round-robin walk list."""
        return [r for name, t in self.tensors.items()
                for r in t.regions(name, bits)]

    def verify_region(self, region: Region) -> Optional[RegionMismatch]:
        t = self.tensors.get(region.tensor)
        if t is None:
            return None
        return t.verify_region(region)

    def verify(self, bits: Optional[int] = None) -> List[RegionMismatch]:
        """Re-hash every region (or one working point's regions) against the
        checksums sealed at pack time; ``[]`` means the buffer is clean."""
        return [m for name, t in self.tensors.items()
                for m in t.verify(name, bits)]

    def repair(self, mismatch: RegionMismatch) -> torch.Tensor:
        """Repair one *view* mismatch by re-deriving the packed buffer from
        the (intact) master codes; raises ``ValueError`` for master-code or
        scale corruption, which has no redundant source here — callers
        escalate those (replica ejection / rebuild from the original
        initializers)."""
        r = mismatch.region
        if not mismatch.repairable:
            raise ValueError(f"cannot repair {r.label()}: only derived "
                             "views re-derive from the master codes")
        return self.tensors[r.tensor].repair_view(r.bits, align=r.align)

    def view_bytes(self, bits: int,
                   caps: Optional[Dict[str, int]] = None) -> int:
        """Resident streamed weight bytes at a working point; ``caps`` bounds
        individual initializers below the runtime view (per-layer caps)."""
        caps = caps or {}
        return sum(t.view_nbytes(min(bits, caps.get(name, bits)))
                   for name, t in self.tensors.items())

    def sharing_report(self, n_points: int = 3) -> Dict[str, float]:
        """Merged-vs-separate weight storage for ``n_points`` working points:
        the shared master vs per-point int8 copies and vs per-point f32
        copies, plus the streamed bytes per view."""
        shared = self.code_bytes()
        n_elems = sum(int(t.codes.numel()) for t in self.tensors.values())
        f32_copies = n_points * 4 * n_elems
        return {
            "n_points": n_points,
            "shared_bytes": shared,
            "per_point_copy_bytes": n_points * shared,
            "per_point_f32_bytes": f32_copies,
            "sharing_ratio": f32_copies / max(shared, 1),
            "view_bytes": {b: self.view_bytes(b) for b in (8, *SUB_BYTE_BITS)},
        }


def pack_int4(codes) -> torch.Tensor:
    """int8 codes in [-8, 7], last dim even -> uint8 packed (..., n/2)."""
    codes = as_tensor(codes)
    if codes.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last dim, got "
                         f"{tuple(codes.shape)}")
    u = (codes.to(torch.int32) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., n/2) -> int8 (..., n) in [-8, 7]."""
    fields = [((packed >> sh) & 0xF).to(torch.int8) for sh in (0, 4)]
    out = torch.stack([torch.where(f >= 8, f - 16, f) for f in fields], -1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def pack_int2(codes) -> torch.Tensor:
    """int8 codes in [-2, 1], last dim % 4 == 0 -> uint8 packed (..., n/4)."""
    codes = as_tensor(codes)
    if codes.shape[-1] % 4:
        raise ValueError(f"pack_int2 needs a last dim divisible by 4, got "
                         f"{tuple(codes.shape)}")
    u = (codes.to(torch.int32) & 0x3).to(torch.uint8)
    return (u[..., 0::4] | (u[..., 1::4] << 2) | (u[..., 2::4] << 4)
            | (u[..., 3::4] << 6))


def unpack_int2(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., n/4) -> int8 (..., n) in [-2, 1]."""
    fields = [((packed >> sh) & 0x3).to(torch.int8) for sh in (0, 2, 4, 6)]
    out = torch.stack([torch.where(f >= 2, f - 4, f) for f in fields], -1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 4)
