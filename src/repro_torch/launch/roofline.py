"""Roofline terms (counterpart of ``repro.launch.roofline``): the dry-run's
report and its collective accounting, and the CNN flow's byte and MAC
models.

:func:`im2col_scratch_bytes` is the patch tensor an im2col conv lowering
materializes, :func:`graph_mac_count` the multiply-accumulates of every
weighted node, and :func:`predict_latency_s` the max of a compute and a
memory term.  The design-space explorer costs its candidates with them.

:class:`RooflineReport` prices one dry-run cell (``launch.dryrun``): the
per-rank FLOPs over the bf16 peak, the per-rank bytes over HBM and the
collectives' ring wire bytes over the slowest link of their group.
:func:`parse_collectives` is the reference's parser of XLA HLO text, kept
as it is; the dry-run fills the same :class:`CollectiveStats` from the
collectives DTensor runs, each with its process group's ranks
(:meth:`CollectiveStats.add`).

The hardware constants are an NVIDIA H100 SXM's, from NVIDIA's datasheet
(https://www.nvidia.com/en-us/data-center/h100/): 989 TFLOP/s of dense
bf16 and 1,979 TOP/s of dense int8 tensor-core operations, 67 TFLOP/s of
f32 on CUDA cores, 3.35 TB/s of HBM3 bandwidth, and NVLink at 900 GB/s
bidirectional, 450 GB/s a direction, between the 8 GPUs of one HGX/DGX
node; between nodes each GPU has one 400 Gb/s NDR InfiniBand port
(ConnectX-7, DGX H100 datasheet), 50 GB/s.  The reference prices every
collective at one TPU ICI link; here a collective's time depends on
whether its group spans nodes, which comes from the hardware, not from a
new feature: a group whose ranks all share ``rank // GPUS_PER_NODE`` is
priced at NVLink, any other at InfiniBand.
"""
from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

# H100 SXM, dense (no sparsity), per NVIDIA's datasheet:
# https://www.nvidia.com/en-us/data-center/h100/ (1,979 TFLOP/s of bf16
# with sparsity, 989 dense)
PEAK_FLOPS_BF16 = 989e12
PEAK_OPS_INT8 = 1979e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s bidirectional per GPU, 450 GB/s each way, inside one
# 8-GPU HGX/DGX H100 node
NVLINK_BW = 450e9
GPUS_PER_NODE = 8
# between nodes: one 400 Gb/s NDR InfiniBand ConnectX-7 per GPU (DGX H100
# datasheet), 50 GB/s
IB_BW = 50e9

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "s4": 0.5, "u4": 0.5, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[(\d+)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


def _shape_bytes(type_str: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 2


def _group_ranks(line: str) -> List[int]:
    """The ranks of the line's first replica group: ``[G,n]<=[N]`` is G
    groups of n consecutive ranks, ``{{a,b,..},..}`` lists them; without
    either, :func:`_group_size`'s default pair ``[0, 1]``."""
    m = _GROUPS_RE.search(line)
    if m:
        return list(range(int(m.group(2))))
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        return [int(r) for r in m.group(1).split(",")]
    return [0, 1]


def wire_bytes(op: str, size: float, n: int) -> float:
    """Per-rank bytes on the slowest link of a ring schedule for one
    collective of ``n`` ranks whose result (HLO's shape) is ``size``
    bytes: 2(n-1)/n for all-reduce, (n-1)/n for all-gather and all-to-all,
    (n-1) times the scattered result for reduce-scatter, 1x for
    collective-permute."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * size
    if op == "all-gather":
        return (n - 1) / n * size          # result is the gathered shape
    if op == "reduce-scatter":
        return (n - 1) * size              # result is the scattered shape
    if op == "all-to-all":
        return (n - 1) / n * size
    return size                            # collective-permute


def spans_nodes(ranks: Sequence[int]) -> bool:
    """Whether a group's ranks lie on more than one 8-GPU node."""
    return len({r // GPUS_PER_NODE for r in ranks}) > 1


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    wire_bytes: float = 0.0          # per-device, slowest-link, ring-adjusted
    raw_bytes: float = 0.0           # sum of operand/result sizes
    nvlink_wire_bytes: float = 0.0   # the part whose group is one node
    ib_wire_bytes: float = 0.0       # the part whose group spans nodes

    def add(self, op: str, size: float, ranks: Sequence[int]) -> None:
        """One collective over the group ``ranks`` whose HLO-shaped result
        is ``size`` bytes (a group of one rank moves nothing)."""
        n = len(ranks)
        if n <= 1:
            return
        wire = wire_bytes(op, size, n)
        self.counts[op] = self.counts.get(op, 0) + 1
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + wire
        self.wire_bytes += wire
        self.raw_bytes += size
        if spans_nodes(ranks):
            self.ib_wire_bytes += wire
        else:
            self.nvlink_wire_bytes += wire


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """The collectives of XLA HLO text, the reference's parser; each is
    also put on NVLink or InfiniBand by its first replica group's ranks
    (:func:`_group_ranks`)."""
    st = CollectiveStats(counts=Counter(), bytes_by_op=Counter())
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        type_str, op = m.group(1), m.group(2)
        size = _shape_bytes(type_str)
        n = _group_size(line)
        if n <= 1:
            continue
        wire = wire_bytes(op, size, n)
        st.counts[op] += 1
        st.bytes_by_op[op] += wire
        st.wire_bytes += wire
        st.raw_bytes += size
        if spans_nodes(_group_ranks(line)):
            st.ib_wire_bytes += wire
        else:
            st.nvlink_wire_bytes += wire
    return st


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective: CollectiveStats
    model_flops: float               # 6ND / 2ND useful-model flops (global)
    peak_flops: float = PEAK_FLOPS_BF16

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        """The ring wire bytes at NVLink for groups inside one node and at
        InfiniBand for groups that span nodes."""
        return (self.collective.nvlink_wire_bytes / NVLINK_BW
                + self.collective.ib_wire_bytes / IB_BW)

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips * per-rank flops): remat/dispatch/pad waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline step time."""
        denom = self.step_s * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_wire_bytes": self.collective.wire_bytes,
            "collective_counts": dict(self.collective.counts),
            "collective_bytes_by_op": dict(self.collective.bytes_by_op),
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "step_s": self.step_s, "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


def model_flops_for(cfg, shape, n_params_active: int) -> float:
    """Useful model FLOPs per executed step (global)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_params_active * shape.global_batch

_IM2COL_OPS = ("Conv", "FusedConv")
_DW_OPS = ("DepthwiseConv", "FusedDepthwiseConv")
_GEMM_OPS = ("Gemm", "FusedGemm", "MatMul")


def _window(graph, n):
    """(weight HWIO, kh, kw, oh, ow) of a windowed conv node."""
    w = graph.initializers[n.inputs[1]]
    ks = n.attrs.get("kernel_shape") or w.shape[:2]
    oshape = graph.value_info[n.outputs[0]].shape
    return w, int(ks[0]), int(ks[1]), int(oshape[1]), int(oshape[2])


def im2col_scratch_bytes(graph, *, batch: int = 1,
                         act_bytes: int = 1) -> Dict[str, int]:
    """Patch-tensor bytes each conv's im2col lowering materializes: a
    ``(B*OH*OW, KH*KW*Cin)`` matrix.  A depthwise conv's dense block-diagonal
    expansion keeps the patch row at ``KH*KW*C``; the direct ``qconv_dw``
    kernel reads the padded activation in place and has no such term.

    ``act_bytes`` is the patch element width (1 for int8 codes, 4 for f32).
    Returns per-node bytes keyed by node name plus a ``"_total"`` sum; the
    graph's ``value_info`` must be populated (run ``infer_shapes`` first)."""
    out: Dict[str, int] = {}
    total = 0
    for n in graph.topo_order():
        dw = n.op in _DW_OPS
        if not dw and n.op not in _IM2COL_OPS:
            continue
        w, kh, kw, oh, ow = _window(graph, n)
        # HWIO: a conv reduces over w[2] = Cin; a depthwise conv has
        # w[2] == 1 but its dense expansion spans all C = w[3] channels
        cin = int(w.shape[3] if dw else w.shape[2])
        nbytes = batch * oh * ow * kh * kw * cin * act_bytes
        out[n.name] = nbytes
        total += nbytes
    out["_total"] = total
    return out


def graph_mac_count(graph, *, batch: int = 1) -> Dict[str, int]:
    """Multiply-accumulates per weighted node: Conv ``B*OH*OW*KH*KW*Cin*Cout``,
    depthwise ``B*OH*OW*KH*KW*C``, Gemm/MatMul ``B*K*N``.  Returns per-node
    MACs keyed by node name plus a ``"_total"`` sum; ``value_info`` must be
    populated.  FLOPs = 2 * MACs."""
    out: Dict[str, int] = {}
    total = 0
    for n in graph.topo_order():
        dw = n.op in _DW_OPS
        if dw or n.op in _IM2COL_OPS:
            w, kh, kw, oh, ow = _window(graph, n)
            cin = 1 if dw else int(w.shape[2])
            macs = batch * oh * ow * kh * kw * cin * int(w.shape[3])
        elif n.op in _GEMM_OPS:
            init = next((i for i in n.inputs[1:]
                         if i in graph.initializers), None)
            if init is None:
                continue
            w = graph.initializers[init]
            macs = batch * int(w.shape[-2]) * int(w.shape[-1])
        else:
            continue
        out[n.name] = macs
        total += macs
    out["_total"] = total
    return out


def predict_latency_s(flops: float, hbm_bytes: float, *,
                      peak_flops: float = PEAK_OPS_INT8,
                      hbm_bw: float = HBM_BW) -> float:
    """Roofline latency: the max of the compute and memory terms.  ``flops``
    is 2 * :func:`graph_mac_count`, ``hbm_bytes`` the streamed weight and
    scratch bytes of a candidate; the defaults are the int8 path's peak."""
    return max(flops / peak_flops, hbm_bytes / hbm_bw)
