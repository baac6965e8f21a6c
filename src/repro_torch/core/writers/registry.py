"""Target-keyed op registry shared by every writer (counterpart of
``repro.core.writers.registry``).

An implementation is registered for an ``(op, target)`` pair; lookup falls
back to the ``"torch"`` reference target, so a writer only registers the ops
it retargets.  An impl has signature ``impl(node, env) -> tensor | tuple``
where ``env`` maps tensor names to values; multi-output ops return a tuple
aligned with ``node.outputs``.

The reference impls keep the IR's NHWC activations and HWIO weights at the
op boundary and permute to PyTorch's NCHW/OIHW only around ``F.conv2d``
(``groups=C`` for depthwise) and ``F.max_pool2d`` — the counterpart of the
XLA conv the JAX package leaves outside any Pallas kernel.  The float
reference runs with TF32 off on the GPU: calibration ranges come from it,
and a range a few ulps off a power of two moves every activation code
downstream.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.ir import Node
from repro_torch.kernels.qconv_dw.ref import normalize_pads, out_spatial

OP_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_op(op: str, target: str = "torch"):
    def deco(fn: Callable) -> Callable:
        OP_REGISTRY.setdefault(target, {})[op] = fn
        return fn
    return deco


def resolve(op: str, target: str = "torch") -> Callable:
    impl = OP_REGISTRY.get(target, {}).get(op)
    if impl is None:
        impl = OP_REGISTRY.get("torch", {}).get(op)
    if impl is None:
        raise KeyError(f"no implementation for op {op!r} (target {target!r})")
    return impl


def registered_ops(target: str = "torch") -> Dict[str, Callable]:
    """Effective op table for a target (the ``"torch"`` impls with the
    target's own merged over them)."""
    table = dict(OP_REGISTRY.get("torch", {}))
    if target != "torch":
        table.update(OP_REGISTRY.get(target, {}))
    return table


def _full_f32(x: torch.Tensor) -> None:
    """Float reference in full f32 on the GPU (PyTorch's cuDNN default is
    TF32)."""
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Reference ("torch") implementations
# ---------------------------------------------------------------------------

def conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides, pads,
              groups: int = 1) -> torch.Tensor:
    """x (B, H, W, C) NHWC, w (kh, kw, Cin/groups, Cout) HWIO -> NHWC, with
    XLA's SAME/VALID/explicit padding.  Like the reference's XLA conv it
    takes one dtype for both operands and promotes nothing."""
    if x.dtype != w.dtype:
        raise TypeError(f"conv requires arguments to have the same dtypes, "
                        f"got {x.dtype}, {w.dtype}")
    _full_f32(x)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    _, _, (pt, pb), (pl, pr) = out_spatial(
        int(x.shape[1]), int(x.shape[2]), kh, kw, strides,
        normalize_pads(pads))
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(strides),
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


@register_op("Conv")
def _op_conv(node: Node, env):
    x, w = env[node.inputs[0]], env[node.inputs[1]]
    y = conv_nhwc(x, w, tuple(node.attrs.get("strides", (1, 1))),
                  node.attrs.get("pads", "SAME"))
    if len(node.inputs) > 2:
        y = y + env[node.inputs[2]]
    return y


@register_op("FusedConv")
def _op_fused_conv(node: Node, env):
    """Conv with BatchNormalization folded into W/b by the fusion pass;
    attrs["relu"] applies the folded trailing activation."""
    y = _op_conv(node, env)
    if node.attrs.get("relu"):
        y = torch.relu(y)
    return y


@register_op("DepthwiseConv")
def _op_depthwise_conv(node: Node, env):
    x, w = env[node.inputs[0]], env[node.inputs[1]]
    y = conv_nhwc(x, w, tuple(node.attrs.get("strides", (1, 1))),
                  node.attrs.get("pads", "SAME"), groups=int(x.shape[-1]))
    if len(node.inputs) > 2:
        y = y + env[node.inputs[2]]
    return y


@register_op("FusedDepthwiseConv")
def _op_fused_depthwise_conv(node: Node, env):
    y = _op_depthwise_conv(node, env)
    if node.attrs.get("relu"):
        y = torch.relu(y)
    return y


@register_op("MaxPool")
def _op_maxpool(node: Node, env):
    x = env[node.inputs[0]]
    k = tuple(node.attrs["kernel_shape"])
    s = tuple(node.attrs.get("strides", k))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=k, stride=s)
    return y.permute(0, 2, 3, 1).contiguous()


@register_op("BatchNormalization")
def _op_batchnorm(node: Node, env):
    x, scale, bias, mean, var = (env[i] for i in node.inputs)
    eps = node.attrs.get("epsilon", 1e-5)
    inv = scale * torch.rsqrt(var + eps)
    return x * inv + (bias - mean * inv)


@register_op("Relu")
def _op_relu(node: Node, env):
    return torch.relu(env[node.inputs[0]])


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the reference's dtype promotion (bf16 with f32 -> f32),
    which torch's matmul does not do itself."""
    _full_f32(x)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


@register_op("Gemm")
def _op_gemm(node: Node, env):
    y = _matmul(env[node.inputs[0]], env[node.inputs[1]])
    if len(node.inputs) > 2:
        y = y + env[node.inputs[2]]
    return y


@register_op("FusedGemm")
def _op_fused_gemm(node: Node, env):
    """Gemm with a trailing Relu folded in by the fusion pass."""
    y = _op_gemm(node, env)
    if node.attrs.get("relu"):
        y = torch.relu(y)
    return y


@register_op("MatMul")
def _op_matmul(node: Node, env):
    return _matmul(env[node.inputs[0]], env[node.inputs[1]])


@register_op("Add")
def _op_add(node: Node, env):
    return env[node.inputs[0]] + env[node.inputs[1]]


@register_op("Flatten")
def _op_flatten(node: Node, env):
    x = env[node.inputs[0]]
    return x.reshape(x.shape[0], -1)


@register_op("Reshape")
def _op_reshape(node: Node, env):
    return env[node.inputs[0]].reshape(list(node.attrs["shape"]))


@register_op("Softmax")
def _op_softmax(node: Node, env):
    return torch.softmax(env[node.inputs[0]], dim=-1)


@register_op("Identity")
def _op_identity(node: Node, env):
    return env[node.inputs[0]]


@register_op("Split")
def _op_split(node: Node, env):
    x = env[node.inputs[0]]
    axis = node.attrs.get("axis", -1)
    n = len(node.outputs)
    return tuple(torch.split(x, x.shape[axis] // n, dim=axis))
