"""Writer 4: IR -> packed-weight quantized executable, target ``"qtorch"``
(counterpart of ``repro.core.writers.qjax_writer``).

Every >=2-D initializer is quantized ONCE to int8 master codes + per-channel
scales (:class:`~repro_torch.quant.pack.PackedWeights`, on the writer's
device) and the hot-path ops run the hand-written kernels over those codes:

* ``Gemm`` / ``MatMul`` / ``FusedGemm`` call ``qmatmul_int8_act`` on int8
  activation codes, or ``qgemm_float`` on float activations
  (``csrc/qgemm.cu`` on the GPU, in its int8 or f32 mode);
* ``Conv`` / ``FusedConv`` lower to im2col + the same matmul, with the
  folded ReLU in its epilogue;
* ``DepthwiseConv`` / ``FusedDepthwiseConv`` call the direct
  ``qconv_dw_int8_act`` / ``qconv_dw_float`` (``csrc/qconv_dw.cu``) — no
  patch tensor — or, with ``dw_mode="im2col"``, the reference's dense
  block-diagonal baseline: im2col + the same matmul over
  ``expand_dw_codes`` (bit-exact against direct at D8);
* ``MaxPool`` / ``Relu`` / ``Flatten`` work on int8 codes directly.

Fully-integer mode (``int8_act``, on by default when the activation
precision fits int8, ``Dx <= 8``): inter-layer tensors are :class:`ActCode`
— the producer FIFO's int8 codes plus a static power-of-two scale from
calibration; each hot op MACs the codes in int32, folds ``2^-frac`` into its
channel scale and re-quantizes to the consumer's code in its epilogue, so
codes, never floats, cross layers.  Above 8 bits (the D16 points), or with
``int8_act=False``, activations stay float and each hot op fuses the
consumer's fixed-point fake-quant into its epilogue.  The working point
``bits`` is a parameter of ``build`` / ``build_batched``: every point
executable reads the SAME packed buffer, and at W4/W2 the split-row sub-byte
views (``PackedTensor.packed_view``) stream unpacked in registers.

On a CUDA device the ops launch the kernels; on the CPU they run the kernels'
plain PyTorch versions — the choice follows the tensors' device, there is no
``use_kernel``/``interpret`` knob.
"""
from __future__ import annotations

from collections import ChainMap
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ir import Graph, Node
from repro_torch.core.writers.registry import OP_REGISTRY, register_op, resolve
from repro_torch.core.writers.torch_writer import BatchedExecutable, TorchWriter
from repro_torch.device import DeviceLike
from repro_torch.kernels.qconv_dw.ops import (DW_PACK_ALIGN, qconv_dw_float,
                                              qconv_dw_int8_act)
from repro_torch.kernels.qconv_dw.ref import (expand_dw_codes, normalize_pads,
                                              out_spatial)
from repro_torch.kernels.qmatmul.ops import qgemm_float, qmatmul_int8_act
from repro_torch.quant.fixedpoint import quantize
from repro_torch.quant.pack import SUB_BYTE_BITS, PackedTensor, PackedWeights
from repro_torch.quant.ptq import act_code_qtype
from repro_torch.quant.qtypes import DatatypeConfig, QType, fixed_for_range

# reserved env key carrying the writer context into the qtorch op impls;
# graph tensor names are ONNX-style identifiers and cannot collide with it
QCTX = "__qctx__"


@dataclass
class ActCode:
    """One inter-layer tensor of the fully-integer path: int8 codes plus
    their static power-of-two qtype (``value = codes * 2^-frac``)."""

    codes: torch.Tensor   # int8, the tensor's shape
    qt: QType             # bits <= 8, power-of-two scale 2^-frac

    @property
    def shape(self):
        return self.codes.shape

    @property
    def dtype(self):
        return self.codes.dtype

    @classmethod
    def encode(cls, x: torch.Tensor, qt: QType) -> "ActCode":
        """Float -> codes on the ``qt`` grid: exactly ``fixedpoint.quantize``,
        narrowed to int8."""
        if qt.bits > 8:
            raise ValueError(f"activation codes need bits <= 8, got {qt}")
        return cls(quantize(x.to(torch.float32), qt).to(torch.int8), qt)

    def to_float(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.codes.to(dtype) * self.qt.scale


def _decoded(node: Node, env):
    """Env view with this node's ActCode inputs decoded to float — lets any
    reference op impl run mid-integer-graph."""
    over = {}
    for name in node.inputs:
        v = env.get(name)
        if isinstance(v, ActCode):
            over[name] = v.to_float()
    return ChainMap(over, env) if over else env


def _float_fallback(op: str, node: Node, env):
    return resolve(op, "torch")(node, _decoded(node, env))


@dataclass
class QTorchContext:
    """Per-build context the qtorch op impls read from the env: the active
    working point and the writer's precision/calibration state."""

    writer: "QTorchWriter"
    bits: int

    def weight_bits(self, node: Optional[Node]) -> int:
        """The runtime working point, capped by the node's per-layer weight
        precision when one is below it."""
        dt = self.writer.node_dt(node)
        if dt.weight_bits < 32:
            return min(self.bits, dt.weight_bits)
        return self.bits

    def act_qt(self, name: str, node: Optional[Node]
               ) -> Optional[Tuple[int, int, int]]:
        """Static epilogue spec of the output's fixed-point activation quant."""
        dt = self.writer.node_dt(node)
        if dt.act_bits >= 32:
            return None
        qt = fixed_for_range(dt.act_bits,
                             self.writer.act_ranges.get(name, 8.0))
        return (qt.frac, qt.qmin, qt.qmax)

    def code_qt(self, name: str, node: Optional[Node]) -> Optional[QType]:
        """The output FIFO's int8 code qtype when this node emits codes
        (fully-integer mode, activation precision fits int8)."""
        if not self.writer.int8_act_on:
            return None
        dt = self.writer.node_dt(node)
        if dt.act_bits > 8:
            return None
        return act_code_qtype(dt.act_bits,
                              self.writer.act_ranges.get(name, 8.0))

    def out_spec(self, node: Node):
        """(code qtype or None, epilogue act_qt) of the node's output."""
        out = node.outputs[0]
        oqt = self.code_qt(out, node)
        aqt = (oqt.frac, oqt.qmin, oqt.qmax) if oqt is not None \
            else self.act_qt(out, node)
        return oqt, aqt

    def weight_codes(self, w: PackedTensor, bits: int,
                     align: Optional[int] = None):
        """(codes argument, packed flag): the sub-byte packed view at W4/W2
        when packed storage is on, else the int8 master."""
        if self.writer.packed_storage and bits in SUB_BYTE_BITS:
            if align is None:
                return w.packed_view(bits), True
            return w.packed_view(bits, align=align), True
        return w.codes_2d(), False

    def mark_fused(self, name: str) -> None:
        self.writer._fused_act.add(name)


# ---------------------------------------------------------------------------
# im2col (the conv as a packed matmul)
# ---------------------------------------------------------------------------

def im2col(x: torch.Tensor, kh: int, kw: int, strides, pads):
    """x (B, H, W, C) -> patches (B, OH, OW, kh*kw*C), dy-major then dx then
    channel — the order HWIO weights flatten to for the (K, N) matmul.  Works
    on int8 code tensors (zero padding is the zero code)."""
    sh, sw = strides
    _, H, W, _ = x.shape
    oh, ow, (ph0, ph1), (pw0, pw1) = out_spatial(H, W, kh, kw, strides,
                                                 normalize_pads(pads))
    if kh == kw == 1 and sh == sw == 1 and ph0 == ph1 == pw0 == pw1 == 0:
        return x, oh, ow          # a pointwise conv IS the matmul
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    cols = [xp[:, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw, :]
            for dy in range(kh) for dx in range(kw)]
    return torch.cat(cols, dim=-1), oh, ow


# ---------------------------------------------------------------------------
# qtorch op implementations
# ---------------------------------------------------------------------------

def _int8_act_gemm(ctx: QTorchContext, node: Node, x: ActCode,
                   w: PackedTensor, bias, relu: bool):
    """Producer codes in, consumer codes out (float only when the output has
    no int8 code qtype)."""
    bits = ctx.weight_bits(node)
    oqt, aqt = ctx.out_spec(node)
    codes_arg, packed = ctx.weight_codes(w, bits)
    y = qmatmul_int8_act(x.codes, x.qt.scale, codes_arg, w.scale_1d(), bias,
                         bits=bits, relu=relu, act_qt=aqt,
                         out_code=oqt is not None, packed=packed)
    ctx.mark_fused(node.outputs[0])
    return ActCode(y, oqt) if oqt is not None else y


def _float_gemm(ctx: QTorchContext, node: Node, x: torch.Tensor,
                w: PackedTensor, bias, relu: bool) -> torch.Tensor:
    """Float activations in, the consumer's fixed-point fake-quant fused
    into the epilogue."""
    bits = ctx.weight_bits(node)
    codes_arg, packed = ctx.weight_codes(w, bits)
    y = qgemm_float(x, codes_arg, w.scale_1d(), bias, bits=bits, relu=relu,
                    act_qt=ctx.act_qt(node.outputs[0], node), packed=packed)
    ctx.mark_fused(node.outputs[0])
    return y


def _gemm(ctx: QTorchContext, node: Node, x, w: PackedTensor, bias,
          relu: bool):
    if isinstance(x, ActCode):
        return _int8_act_gemm(ctx, node, x, w, bias, relu)
    return _float_gemm(ctx, node, x, w, bias, relu)


def _qgemm_node(node: Node, env, relu: bool = False):
    """Shared Gemm/MatMul/FusedGemm lowering; None when the weight is not
    packed (activation x activation matmul) so the caller falls back."""
    ctx = env.get(QCTX)
    w = env.get(node.inputs[1])
    if ctx is None or not isinstance(w, PackedTensor):
        return None
    bias = env[node.inputs[2]] if len(node.inputs) > 2 else None
    return _gemm(ctx, node, env[node.inputs[0]], w, bias, relu)


@register_op("Gemm", target="qtorch")
def _op_gemm_qtorch(node: Node, env):
    y = _qgemm_node(node, env)
    return y if y is not None else _float_fallback("Gemm", node, env)


@register_op("MatMul", target="qtorch")
def _op_matmul_qtorch(node: Node, env):
    y = _qgemm_node(node, env)
    return y if y is not None else _float_fallback("MatMul", node, env)


@register_op("FusedGemm", target="qtorch")
def _op_fused_gemm_qtorch(node: Node, env):
    y = _qgemm_node(node, env, relu=bool(node.attrs.get("relu")))
    return y if y is not None else _float_fallback("FusedGemm", node, env)


def _qconv_node(node: Node, env, relu: bool):
    """Conv/FusedConv: im2col over the producer's codes (or float
    activations) + the quantized matmul with the fused epilogue."""
    ctx = env.get(QCTX)
    w = env.get(node.inputs[1])
    if ctx is None or not isinstance(w, PackedTensor):
        return None
    x = env[node.inputs[0]]
    bias = env[node.inputs[2]] if len(node.inputs) > 2 else None
    kh, kw, _, cout = w.codes.shape
    strides = tuple(int(s) for s in node.attrs.get("strides", (1, 1)))
    pads = node.attrs.get("pads", "SAME")
    src = x.codes if isinstance(x, ActCode) else x
    patches, oh, ow = im2col(src, kh, kw, strides, pads)
    flat = patches.reshape(-1, patches.shape[-1])
    if isinstance(x, ActCode):
        flat = ActCode(flat, x.qt)
    y = _gemm(ctx, node, flat, w, bias, relu)
    B = src.shape[0]
    if isinstance(y, ActCode):
        return ActCode(y.codes.reshape(B, oh, ow, cout), y.qt)
    return y.reshape(B, oh, ow, cout)


def _qdwconv_node(node: Node, env, relu: bool):
    """DepthwiseConv/FusedDepthwiseConv lowering over the producer's codes or
    float activations.

    ``dw_mode="direct"`` (default) calls the direct channel-parallel kernel,
    sub-byte W4/W2 streamed at the depthwise packing alignment.
    ``dw_mode="im2col"`` runs the reference's baseline: the taps expanded to
    a dense block-diagonal (kh*kw*C, C) matrix through im2col + qgemm, with
    the unpacked int8 expansion truncated to ``bits`` in the kernel (never
    packed, as in the reference) — bit-exact against direct in
    fully-integer mode (same integer accumulators, same power-of-two
    folds)."""
    ctx = env.get(QCTX)
    w = env.get(node.inputs[1])
    if ctx is None or not isinstance(w, PackedTensor):
        return None
    x = env[node.inputs[0]]
    bias = env[node.inputs[2]] if len(node.inputs) > 2 else None
    kh, kw, _, c = w.codes.shape
    strides = tuple(int(s) for s in node.attrs.get("strides", (1, 1)))
    pads = normalize_pads(node.attrs.get("pads", "SAME"))
    bits = ctx.weight_bits(node)
    ctx.mark_fused(node.outputs[0])
    if ctx.writer.dw_mode == "im2col":
        dense = expand_dw_codes(w.codes)
        src = x.codes if isinstance(x, ActCode) else x
        patches, oh, ow = im2col(src, kh, kw, strides, pads)
        flat = patches.reshape(-1, patches.shape[-1])
        if isinstance(x, ActCode):
            oqt, aqt = ctx.out_spec(node)
            y = qmatmul_int8_act(flat, x.qt.scale, dense, w.scale_1d(), bias,
                                 bits=bits, relu=relu, act_qt=aqt,
                                 out_code=oqt is not None)
        else:
            oqt = None
            y = qgemm_float(flat, dense, w.scale_1d(), bias, bits=bits,
                            relu=relu,
                            act_qt=ctx.act_qt(node.outputs[0], node))
        y = y.reshape(src.shape[0], oh, ow, c)
        return ActCode(y, oqt) if oqt is not None else y
    codes_arg, packed = ctx.weight_codes(w, bits, align=DW_PACK_ALIGN)
    common = dict(kh=kh, kw=kw, strides=strides, pads=pads, bits=bits,
                  relu=relu, packed=packed)
    if not isinstance(x, ActCode):
        return qconv_dw_float(x, codes_arg, w.scale_1d(), bias,
                              act_qt=ctx.act_qt(node.outputs[0], node),
                              **common)
    oqt, aqt = ctx.out_spec(node)
    y = qconv_dw_int8_act(x.codes, x.qt.scale, codes_arg, w.scale_1d(), bias,
                          act_qt=aqt, out_code=oqt is not None, **common)
    return ActCode(y, oqt) if oqt is not None else y


@register_op("DepthwiseConv", target="qtorch")
def _op_dwconv_qtorch(node: Node, env):
    y = _qdwconv_node(node, env, relu=False)
    return y if y is not None else _float_fallback("DepthwiseConv", node, env)


@register_op("FusedDepthwiseConv", target="qtorch")
def _op_fused_dwconv_qtorch(node: Node, env):
    y = _qdwconv_node(node, env, relu=bool(node.attrs.get("relu")))
    return y if y is not None else _float_fallback("FusedDepthwiseConv",
                                                   node, env)


@register_op("Conv", target="qtorch")
def _op_conv_qtorch(node: Node, env):
    y = _qconv_node(node, env, relu=False)
    return y if y is not None else _float_fallback("Conv", node, env)


@register_op("FusedConv", target="qtorch")
def _op_fused_conv_qtorch(node: Node, env):
    y = _qconv_node(node, env, relu=bool(node.attrs.get("relu")))
    return y if y is not None else _float_fallback("FusedConv", node, env)


# -- code-domain actors: exact integer semantics, no dequant ----------------

@register_op("MaxPool", target="qtorch")
def _op_maxpool_qtorch(node: Node, env):
    x = env[node.inputs[0]]
    if not isinstance(x, ActCode):
        return _float_fallback("MaxPool", node, env)
    kh, kw = (int(k) for k in node.attrs["kernel_shape"])
    sh, sw = (int(s) for s in node.attrs.get("strides", (kh, kw)))
    c = x.codes
    oh = (c.shape[1] - kh) // sh + 1
    ow = (c.shape[2] - kw) // sw + 1
    # max commutes with the monotone positive-scale dequant: pooling the int8
    # codes IS pooling the values.  torch has no int8 max-pool on CUDA, so
    # the VALID window max is taken over its kh*kw strided views
    out = None
    for dy in range(kh):
        for dx in range(kw):
            v = c[:, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw, :]
            out = v if out is None else torch.maximum(out, v)
    return ActCode(out.contiguous(), x.qt)


@register_op("Relu", target="qtorch")
def _op_relu_qtorch(node: Node, env):
    x = env[node.inputs[0]]
    if not isinstance(x, ActCode):
        return _float_fallback("Relu", node, env)
    # relu(c * s) == max(c, 0) * s for s > 0, and 0 is exactly the zero code
    return ActCode(torch.clamp_min(x.codes, 0), x.qt)


@register_op("Flatten", target="qtorch")
def _op_flatten_qtorch(node: Node, env):
    x = env[node.inputs[0]]
    if not isinstance(x, ActCode):
        return _float_fallback("Flatten", node, env)
    return ActCode(x.codes.reshape(x.codes.shape[0], -1), x.qt)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

class QTorchWriter(TorchWriter):
    """Packed-weight quantized execution engine (see module docstring).

    Writer options (``DesignFlow.run(writer_kwargs={"qtorch": {...}})``):

    * ``default_bits`` — working point used when ``build(bits=None)``;
    * ``int8_act`` — None (auto: fully-integer inter-layer dataflow whenever
      the default activation precision fits int8), True/False to force;
    * ``packed_weights`` — sub-byte packed W4/W2 buffers (default on; off
      streams the int8 master truncated in registers — bit-identical);
    * ``dw_mode`` — ``"direct"`` (default: the ``qconv_dw`` kernel, no patch
      tensor) or ``"im2col"`` (the dense block-diagonal baseline through
      ``qgemm``).
    """

    target = "qtorch"

    def __init__(self, graph: Graph,
                 dtconfig: Optional[DatatypeConfig] = None,
                 act_ranges: Optional[Dict[str, float]] = None, *,
                 device: DeviceLike = None,
                 default_bits: Optional[int] = None,
                 int8_act: Optional[bool] = None,
                 packed_weights: Optional[bool] = None,
                 dw_mode: str = "direct"):
        if dw_mode not in ("direct", "im2col"):
            raise ValueError(f"dw_mode must be 'direct' or 'im2col', "
                             f"got {dw_mode!r}")
        self.dw_mode = dw_mode
        self._default_bits = default_bits
        self._int8_act = int8_act
        self._packed_weights = packed_weights
        super().__init__(graph, dtconfig, act_ranges, device=device)

    def _prepare_weights(self) -> Dict[str, Any]:
        """Quantize once to shared int8 master codes on the writer's device;
        the active ``bits`` view is selected per build, not here."""
        self.packed = PackedWeights.from_initializers(self.graph.initializers,
                                                      self.device)
        out: Dict[str, Any] = dict(self.packed.passthrough)
        out.update(self.packed.tensors)
        return out

    @property
    def default_bits(self) -> int:
        if self._default_bits is not None:
            return int(self._default_bits)
        if self.dt.weight_bits < 32:
            return min(8, self.dt.weight_bits)
        return 8

    def weight_bytes(self) -> int:
        """Bytes of the shared master buffer (all working points included)."""
        return self.packed.code_bytes()

    @property
    def int8_act_on(self) -> bool:
        """Fully-integer inter-layer dataflow: on by default when the default
        working point's activation precision fits int8 codes."""
        if self._int8_act is not None:
            return bool(self._int8_act)
        return self.dt.act_bits <= 8

    @property
    def packed_storage(self) -> bool:
        if self._packed_weights is not None:
            return bool(self._packed_weights)
        return True

    def _act_q(self, name: str, x, node: Optional[Node] = None):
        """In fully-integer mode the FIFO boundary *encodes* to int8 codes
        (graph inputs; outputs of ops without an integer impl); values
        already on a code grid pass through untouched.  Float activations
        are fake-quantized as in the float target."""
        if isinstance(x, ActCode):
            return x
        if (self.int8_act_on and name not in self._fused_act
                and torch.is_floating_point(x)):
            dt = self.node_dt(node)
            if dt.act_bits <= 8:
                qt = act_code_qtype(dt.act_bits, self.act_ranges.get(name, 8.0))
                return ActCode.encode(x, qt)
        return super()._act_q(name, x, node)

    def _materialize(self, value):
        """Graph outputs are the one place floats materialize."""
        if isinstance(value, ActCode):
            return value.to_float()
        return value

    def op_impl(self, op: str) -> Callable:
        """Ops registered for the qtorch target are code-aware; anything else
        gets the decode shim so reference impls run mid-integer-graph."""
        impl = super().op_impl(op)
        if op in OP_REGISTRY.get(self.target, {}):
            return impl

        def shim(node, env, _impl=impl):
            return _impl(node, _decoded(node, env))

        return shim

    def _env_seed(self, bits: Optional[int] = None) -> Dict[str, Any]:
        env: Dict[str, Any] = dict(self.weights)
        env[QCTX] = QTorchContext(self, self.default_bits if bits is None
                                  else int(bits))
        return env

    def build_batched(self, max_entries: int = 8,
                      on_compile: Optional[Callable] = None,
                      bits: Optional[int] = None) -> BatchedExecutable:
        exe = super().build_batched(max_entries=max_entries,
                                    on_compile=on_compile,
                                    bits=self.default_bits if bits is None
                                    else int(bits))
        exe.packed = self.packed   # buffer-identity accounting in tests/serve
        return exe
