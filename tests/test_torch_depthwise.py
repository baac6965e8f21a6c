"""``tests/test_depthwise.py`` on the port: the direct depthwise conv in the
integer code domain (W8/W4/W2 nested views, sub-byte packed tap rows,
strides and pads, the code-emitting epilogue, the float mode), grouped Conv
ingest (reader normalization, shape inference), DW+BN+Relu fusion and the
Relu->MaxPool reorder, and the writer's direct-vs-im2col differential.

Each case draws the reference's inputs once (its ``PRNGKey`` draws, as
numpy) and feeds them to both packages on the CPU, where the port's entry
points run the plain version (the kernel is held to it on the card,
``tests/test_torch_kernels_cuda.py``).  Integer outputs are held bit for bit
to the reference's eager oracle and, where it agrees with it, to its
interpret-mode kernel: the reference's two ``[4-*]`` kernel cases fail on
its own fma contraction of ``acc*s + bias`` (ROADMAP Queue 3), so with a
bias the port is held to the eager oracle, which rounds twice as the port
does.  Float outputs are held within the reference's ``max|y|*2^-22``.
The writer's D8 im2col differential at the fixture seed, ``dw_mode``
validation and ``expand_dw_codes`` are in ``tests/test_torch_dw_im2col.py``;
the ``qconv_dw:`` autotune keys in ``tests/test_torch_autotune.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core import ir as j_ir
from repro.core.flow import DesignFlow as JFlow
from repro.core.passes import PassManager as JPM
from repro.core.passes import structural_pipeline as j_structural
from repro.core.reader import normalize_groups as j_normalize_groups
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.core.writers.jax_writer import JaxWriter
from repro.kernels.qconv_dw.ops import DW_PACK_ALIGN as J_DW_PACK_ALIGN
from repro.kernels.qconv_dw.ops import qconv_dw as j_qconv_dw
from repro.kernels.qconv_dw.ops import qconv_dw_int8_act as j_qconv_dw_i8
from repro.kernels.qconv_dw.ref import qconv_dw_int8_act_ref as j_dw_i8_ref
from repro.kernels.qconv_dw.ref import qconv_dw_ref as j_dw_ref
from repro.models import cnn as j_models
from repro.quant.pack import pack_rows as j_pack_rows
from repro.quant.qtypes import DatatypeConfig as JDT

from repro_torch.configs.separable_cnn import CONFIG as SEP
from repro_torch.core.flow import DesignFlow, WriterOptions
from repro_torch.core.ir import BATCH, Graph, Node, TensorInfo
from repro_torch.core.passes import PassManager, structural_pipeline
from repro_torch.core.passes.fusion import reorder_relu_maxpool
from repro_torch.core.passes.shape_infer import infer_shapes
from repro_torch.core.reader import normalize_groups, separable_cnn_to_ir
from repro_torch.core.writers.torch_writer import TorchWriter
from repro_torch.kernels.qconv_dw.ops import (DW_PACK_ALIGN, qconv_dw_float,
                                              qconv_dw_int8_act)
from repro_torch.kernels.qconv_dw.ref import (out_spatial,
                                              qconv_dw_int8_act_ref,
                                              qconv_dw_ref)
from repro_torch.quant.pack import pack_rows, unpack_rows
from repro_torch.quant.ptq import derive_view
from repro_torch.quant.qtypes import DatatypeConfig


def _t(a):
    return torch.from_numpy(np.array(a))


def _dw_problem(seed=0, B=2, H=9, W=9, C=8, k=3):
    """The reference test's draws, as numpy."""
    key = jax.random.PRNGKey(seed)
    kx, kw_, ks, kb = jax.random.split(key, 4)
    x_codes = jax.random.randint(kx, (B, H, W, C), -127, 128, jnp.int8)
    codes = jax.random.randint(kw_, (k * k, C), -127, 128, jnp.int8)
    scale = (jax.random.uniform(ks, (C,)) * 0.05 + 0.01).astype(jnp.float32)
    bias = (jax.random.normal(kb, (C,)) * 0.1).astype(jnp.float32)
    return (np.asarray(x_codes), 2.0 ** -6, np.asarray(codes),
            np.asarray(scale), np.asarray(bias))


def _sep_params(seed=0):
    p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


def _sep_graphs(seed=0):
    p = _sep_params(seed)
    return j_sep_to_ir(J_SEP, p), separable_cnn_to_ir(SEP, p)


def _port_i8(x, xs, codes, scale, bias, **kw):
    return qconv_dw_int8_act(_t(x), xs, _t(codes), _t(scale),
                             None if bias is None else _t(bias), **kw)


# ---------------------------------------------------------------------------
# kernel vs ref: the integer code domain is bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,packed", [
    (8, False), (4, False), (2, False), (4, True), (2, True)])
def test_dw_int8_act_kernel_bitexact_vs_ref(bits, packed):
    """The port against the reference's eager oracle, array_equal; the
    packed tap rows are the reference's byte for byte.  (The reference's
    jitted kernel fma-contracts ``acc*s + bias`` at W4, the two cases that
    fail on it; the port rounds twice, as the oracle does.)"""
    x, xs, codes, scale, bias = _dw_problem(bits)
    w_arg = pack_rows(_t(codes), bits, align=DW_PACK_ALIGN) if packed \
        else _t(codes)
    if packed:
        np.testing.assert_array_equal(
            w_arg.numpy(),
            np.asarray(j_pack_rows(codes, bits, align=J_DW_PACK_ALIGN)))
    kw = dict(kh=3, kw=3, strides=(1, 1), pads="SAME", bits=bits,
              relu=True, act_qt=(10, -(2 ** 15), 2 ** 15 - 1))
    y_t = qconv_dw_int8_act(_t(x), xs, w_arg, _t(scale), _t(bias),
                            packed=packed, **kw)
    y_r = j_dw_i8_ref(x, xs, codes, scale, bias, **kw)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_r))
    assert torch.equal(y_t, qconv_dw_int8_act_ref(
        _t(x), xs, _t(codes), _t(scale), _t(bias), **kw))


@pytest.mark.parametrize("strides,pads", [
    ((1, 1), "VALID"), ((2, 2), "SAME"), ((2, 2), "VALID"), ((1, 2), "SAME")])
def test_dw_int8_act_strides_and_pads_bitexact(strides, pads):
    """No bias: the spatial indexing alone, against the reference's oracle
    and its interpret-mode kernel."""
    x, xs, codes, scale, _ = _dw_problem(7, H=11, W=10)
    kw = dict(kh=3, kw=3, strides=strides, pads=pads, bits=8)
    y_t = _port_i8(x, xs, codes, scale, None, **kw)
    y_r = j_dw_i8_ref(x, xs, codes, scale, None, **kw)
    y_k = j_qconv_dw_i8(x, xs, codes, scale, None, interpret=True,
                        use_kernel=True, **kw)
    assert tuple(y_t.shape) == y_r.shape == (
        2, *out_spatial(11, 10, 3, 3, strides, pads)[:2], 8)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_r))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_k))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_dw_out_code_emits_consumer_int8_codes(bits):
    x, xs, codes, scale, bias = _dw_problem(3)
    kw = dict(kh=3, kw=3, bits=bits, relu=True, act_qt=(4, -127, 127),
              out_code=True)
    y_t = _port_i8(x, xs, codes, scale, bias, **kw)
    y_r = j_dw_i8_ref(x, xs, codes, scale, bias, **kw)
    assert y_t.dtype == torch.int8
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_r))


def test_dw_fallback_path_is_the_ref():
    """Dispatch on a CPU tensor: the packed W4 tap rows unpacked, then the
    oracle, equal to the reference's fallback path."""
    x, xs, codes, scale, _ = _dw_problem(5)
    packed = pack_rows(_t(codes), 4, align=DW_PACK_ALIGN)
    y_t = qconv_dw_int8_act(_t(x), xs, packed, _t(scale), None, kh=3, kw=3,
                            bits=4, packed=True)
    y_f = j_qconv_dw_i8(x, xs, np.asarray(j_pack_rows(codes, 4,
                                                      align=J_DW_PACK_ALIGN)),
                        scale, None, kh=3, kw=3, bits=4, packed=True,
                        use_kernel=False)
    y_r = qconv_dw_int8_act_ref(_t(x), xs, _t(codes), _t(scale), None, kh=3,
                                kw=3, bits=4)
    assert torch.equal(y_t, y_r)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_f))


@pytest.mark.parametrize("bits", [8, 4])
def test_dw_float_kernel_matches_ref_to_ulp(bits):
    """The float mode: every tap product exact (fixed-point operands), so
    the port equals its oracle bit for bit and both references within
    ``max|y|*2^-22``."""
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (2, 9, 9, 8),
                                      jnp.float32))
    _, _, codes, scale, bias = _dw_problem(11)
    kw = dict(kh=3, kw=3, bits=bits, relu=True)
    y_t = qconv_dw_float(_t(x), _t(codes), _t(scale), _t(bias), **kw)
    assert torch.equal(y_t, qconv_dw_ref(_t(x), _t(codes), _t(scale),
                                         _t(bias), **kw))
    y_r = np.asarray(j_dw_ref(x, codes, scale, bias, **kw))
    y_k = np.asarray(j_qconv_dw(x, codes, scale, bias, interpret=True,
                                use_kernel=True, **kw))
    tol = float(np.abs(y_r).max()) * 2 ** -22 + 1e-9
    np.testing.assert_allclose(y_t.numpy(), y_r, rtol=0, atol=tol)
    np.testing.assert_allclose(y_t.numpy(), y_k, rtol=0, atol=tol)


def test_dw_nested_views_truncate_master_codes():
    x, xs, codes, scale, _ = _dw_problem(9)
    for bits in (4, 2):
        view = derive_view(_t(codes), bits)
        y_b = _port_i8(x, xs, codes, scale, None, kh=3, kw=3, bits=bits)
        y_v = qconv_dw_int8_act(_t(x), xs, view, _t(scale), None, kh=3, kw=3,
                                bits=8)
        assert torch.equal(y_b, y_v)
        np.testing.assert_array_equal(
            y_b.numpy(), np.asarray(j_dw_i8_ref(x, xs, codes, scale, None,
                                                kh=3, kw=3, bits=bits)))


def test_dw_pack_rows_align8_byte_accounting():
    codes = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (9, 8),
                                          -127, 128, jnp.int8))
    for bits, rows in ((4, 8), (2, 4)):
        p = pack_rows(_t(codes), bits, align=DW_PACK_ALIGN)
        assert tuple(p.shape) == (rows, 8)
        np.testing.assert_array_equal(
            p.numpy(), np.asarray(j_pack_rows(codes, bits,
                                              align=J_DW_PACK_ALIGN)))
        got = unpack_rows(p, bits)[:9]
        assert torch.equal(got, derive_view(_t(codes), bits))


# ---------------------------------------------------------------------------
# reader: ONNX group attribute normalization
# ---------------------------------------------------------------------------

def _group_graph(ir, w_shape, group, weight_as_input=False):
    inits = {"w": np.random.default_rng(0).normal(
        size=w_shape).astype(np.float32)}
    inputs = [ir.TensorInfo("input", (ir.BATCH, 8, 8, w_shape[2] * group
                                      if w_shape[2] != 1 else w_shape[3]))]
    if weight_as_input:
        inputs.append(ir.TensorInfo("w", w_shape))
        inits = {}
    return ir.Graph("grp", [
        ir.Node("Conv", "c", ["input", "w"], ["out"],
                {"kernel_shape": [w_shape[0], w_shape[1]], "pads": "SAME",
                 "strides": [1, 1], "group": group}),
    ], inputs, ["out"], inits)


def _both_groups(w_shape, group, **kw):
    from repro_torch.core import ir as t_ir
    return (_group_graph(j_ir, w_shape, group, **kw),
            _group_graph(t_ir, w_shape, group, **kw))


def test_reader_group_one_is_plain_conv():
    jg, tg = _both_groups((3, 3, 4, 8), 1)
    (node,) = normalize_groups(tg).nodes
    assert node.op == "Conv" and "group" not in node.attrs
    assert normalize_groups(tg).to_json() == \
        j_normalize_groups(jg).to_json()


def test_reader_group_cin_becomes_depthwise():
    jg, tg = _both_groups((3, 3, 1, 16), 16)
    (node,) = normalize_groups(tg).nodes
    assert node.op == "DepthwiseConv" and "group" not in node.attrs
    assert normalize_groups(tg).to_json() == \
        j_normalize_groups(jg).to_json()


def test_reader_rejects_general_grouped_conv():
    for g, fn in zip(_both_groups((3, 3, 2, 8), 4),
                     (j_normalize_groups, normalize_groups)):
        with pytest.raises(ValueError, match="not depthwise"):
            fn(g)


def test_reader_rejects_activation_fed_grouped_weight():
    for g, fn in zip(_both_groups((3, 3, 1, 16), 16, weight_as_input=True),
                     (j_normalize_groups, normalize_groups)):
        with pytest.raises(ValueError, match="activation-fed"):
            fn(g)


# ---------------------------------------------------------------------------
# shape inference: grouped rule, symbolic batch
# ---------------------------------------------------------------------------

def test_depthwise_shape_inference_symbolic_batch():
    inits = {"w": np.zeros((3, 3, 1, 16), np.float32),
             "b": np.zeros((16,), np.float32)}
    g = Graph("dw", [
        Node("DepthwiseConv", "d", ["input", "w", "b"], ["out"],
             {"kernel_shape": [3, 3], "pads": "SAME", "strides": [2, 2]}),
    ], [TensorInfo("input", (BATCH, 15, 15, 16))], ["out"], inits)
    infer_shapes(g)
    assert g.value_info["out"].shape == (BATCH, 8, 8, 16)


def test_depthwise_shape_inference_rejects_channel_mismatch():
    inits = {"w": np.zeros((3, 3, 1, 8), np.float32)}
    g = Graph("dw", [
        Node("DepthwiseConv", "d", ["input", "w"], ["out"],
             {"kernel_shape": [3, 3], "pads": "SAME", "strides": [1, 1]}),
    ], [TensorInfo("input", (BATCH, 8, 8, 16))], ["out"], inits)
    with pytest.raises(ValueError):
        infer_shapes(g)


def test_shape_inference_rejects_unnormalized_grouped_conv():
    inits = {"w": np.zeros((3, 3, 1, 16), np.float32)}
    g = Graph("grp", [
        Node("Conv", "c", ["input", "w"], ["out"],
             {"kernel_shape": [3, 3], "pads": "SAME", "strides": [1, 1],
              "group": 16}),
    ], [TensorInfo("input", (BATCH, 8, 8, 16))], ["out"], inits)
    with pytest.raises(ValueError, match="normalize_groups"):
        infer_shapes(g)


# ---------------------------------------------------------------------------
# passes: DW+BN+Relu fusion, Relu->MaxPool reordering
# ---------------------------------------------------------------------------

def test_separable_pipeline_fuses_and_reorders():
    jg, g = _sep_graphs()
    g2 = PassManager(structural_pipeline()).run(g)
    ops = [n.op for n in g2.topo_order()]
    assert ops.count("FusedDepthwiseConv") == len(SEP.blocks)
    assert "BatchNormalization" not in ops
    order = [n.name for n in g2.topo_order()]
    assert order.index("stem_pool") < order.index("stem_relu")
    assert g2.to_json() == JPM(j_structural()).run(jg).to_json()
    x = np.random.default_rng(0).random((2, 28, 28, 1)).astype(np.float32)
    y_raw = TorchWriter(g, device="cpu").build()(x).numpy()
    y_opt = TorchWriter(g2, device="cpu").build()(x).numpy()
    np.testing.assert_allclose(y_opt, y_raw,
                               atol=1e-5 * max(1.0, np.abs(y_raw).max()))
    np.testing.assert_allclose(y_raw, np.asarray(JaxWriter(jg).build()(x)),
                               atol=1e-5 * max(1.0, np.abs(y_raw).max()))


def test_reorder_relu_maxpool_is_exact():
    inits = {"w": np.random.default_rng(1).normal(
        size=(3, 3, 2, 4)).astype(np.float32)}
    g = Graph("rm", [
        Node("Conv", "c", ["input", "w"], ["c_out"],
             {"kernel_shape": [3, 3], "pads": "SAME", "strides": [1, 1]}),
        Node("Relu", "r", ["c_out"], ["r_out"]),
        Node("MaxPool", "p", ["r_out"], ["p_out"],
             {"kernel_shape": [2, 2], "strides": [2, 2]}),
    ], [TensorInfo("input", (BATCH, 8, 8, 2))], ["p_out"], inits)
    x = np.random.default_rng(2).standard_normal((3, 8, 8, 2)).astype(
        np.float32)
    y_raw = TorchWriter(g, device="cpu").build()(x)
    g2 = reorder_relu_maxpool(g)
    order = [(n.op, n.name) for n in g2.topo_order()]
    assert order == [("Conv", "c"), ("MaxPool", "p"), ("Relu", "r")]
    y_sw = TorchWriter(infer_shapes(g2), device="cpu").build()(x)
    assert torch.equal(y_sw, y_raw)


def test_reorder_skips_fanout_relu():
    inits = {"w": np.random.default_rng(1).normal(
        size=(3, 3, 2, 2)).astype(np.float32)}
    g = Graph("fan", [
        Node("Conv", "c", ["input", "w"], ["c_out"],
             {"kernel_shape": [3, 3], "pads": "SAME", "strides": [1, 1]}),
        Node("Relu", "r", ["c_out"], ["r_out"]),
        Node("MaxPool", "p", ["r_out"], ["p_out"],
             {"kernel_shape": [2, 2], "strides": [2, 2]}),
        Node("Flatten", "f", ["r_out"], ["flat"]),
    ], [TensorInfo("input", (BATCH, 8, 8, 2))], ["p_out", "flat"], inits)
    g2 = reorder_relu_maxpool(g)
    assert [(n.op, n.name) for n in g2.topo_order()] == \
        [("Conv", "c"), ("Relu", "r"), ("MaxPool", "p"), ("Flatten", "f")]


# ---------------------------------------------------------------------------
# writer: direct vs im2col differential at D8
# ---------------------------------------------------------------------------

def test_writer_direct_kernel_vs_im2col_bitexact_forced_interpret():
    """The reference's forced interpret-mode kernels (seed 1), direct and
    im2col, against the port's direct and im2col lowerings on the
    reference's calibration: every output bit equal."""
    jg, tg = _sep_graphs(1)
    rng = np.random.default_rng(1)
    calib = rng.random((2, 28, 28, 1), np.float32)
    x = rng.random((1, 28, 28, 1), np.float32)
    outs = {}
    for mode in ("direct", "im2col"):
        jres = JFlow(jg).run(
            targets=("qjax",), dtconfig=JDT(8, 8), calib_inputs=(calib,),
            writer_kwargs={"qjax": {"dw_mode": mode, "use_kernel": True,
                                    "interpret": True}})
        res = DesignFlow(tg, device="cpu").run(
            ("qtorch",), DatatypeConfig(8, 8), act_ranges=jres.act_ranges,
            options=WriterOptions(dw_mode=mode))
        outs[mode] = res.batched["qtorch"](x).numpy()
        np.testing.assert_array_equal(outs[mode],
                                      np.asarray(jres.batched["qjax"](x)))
    np.testing.assert_array_equal(outs["direct"], outs["im2col"])


def test_separable_d8_agrees_with_float_reference():
    """The fully-integer separable network tracks the f32 fake-quant
    reference to quantization tolerance, with the reference's calibration
    and outputs equal to its plain path."""
    jg, tg = _sep_graphs()
    rng = np.random.default_rng(3)
    calib = rng.random((2, 28, 28, 1), np.float32)
    jres = JFlow(jg).run(targets=("jax", "qjax"), dtconfig=JDT(8, 8),
                         calib_inputs=(calib,),
                         writer_kwargs={"qjax": {"use_kernel": False}})
    res = DesignFlow(tg, device="cpu").run(
        ("torch", "qtorch"), DatatypeConfig(8, 8), act_ranges=jres.act_ranges)
    x = rng.random((4, 28, 28, 1), np.float32)
    y_ref = res.batched["torch"](x).numpy()
    y_int = res.batched["qtorch"](x).numpy()
    scale = np.max(np.abs(y_ref)) + 1e-9
    assert np.max(np.abs(y_ref - y_int)) / scale < 0.12
    np.testing.assert_array_equal(y_int, np.asarray(jres.batched["qjax"](x)))
