"""Roofline terms of the CNN flow (counterpart of ``repro.launch.roofline``,
its CNN-side half).

:func:`im2col_scratch_bytes` is the patch tensor an im2col conv lowering
materializes, :func:`graph_mac_count` the multiply-accumulates of every
weighted node, and :func:`predict_latency_s` the max of a compute and a
memory term.  The design-space explorer costs its candidates with them.

The hardware constants are an NVIDIA H100 SXM's, from NVIDIA's datasheet
(https://www.nvidia.com/en-us/data-center/h100/): 1,979 TOP/s of dense int8
tensor-core operations, 67 TFLOP/s of f32 on CUDA cores and 3.35 TB/s of
HBM3 bandwidth.

Not ported yet: ``parse_collectives``, ``CollectiveStats``,
``RooflineReport`` and ``model_flops_for``, which read XLA HLO text and
dry-run shapes; they come with the dry-run slice (ROADMAP Queue 1 item
6b), from collectives counted by DTensor's ``CommDebugMode``.
"""
from __future__ import annotations

from typing import Dict

# H100 SXM, dense (no sparsity), per NVIDIA's datasheet:
# https://www.nvidia.com/en-us/data-center/h100/
PEAK_OPS_INT8 = 1979e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12

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
