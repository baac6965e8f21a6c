"""``tests/test_qpath.py`` on the port: the packed-weight engine's
kernel-level epilogue, nested-view truncation, shared weight buffers across
working points, the fully-integer hot path, sub-byte packed residency and
the server's bits telemetry.  Each case feeds the same numpy inputs (the
reference's ``PRNGKey`` draws, made once and handed to both packages) to the
reference and to the port on the CPU (target ``qjax`` -> ``qtorch``,
``jax`` -> ``torch``, flows and writers on ``device="cpu"``), asserts what
the reference asserts on the port, and holds the port to the reference:
integer paths and the reference's plain (``use_kernel=False``) outputs bit
for bit; float outputs within 1e-6 of the largest output (the two
frameworks' f32 convolutions sum in other orders); the reference's
interpret-mode Pallas kernel, which casts activations to bf16, within its
own ``max|y|*2^-7 + 1e-6``.  On the CPU the port's entry points run the
plain version; the kernels are held to it on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.core.flow import DesignFlow as JFlow
from repro.core.ir import Graph as JGraph
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import mlp_to_ir as j_mlp_to_ir
from repro.core.writers.jax_writer import JaxWriter
from repro.core.writers.qjax_writer import QJaxWriter
from repro.core.writers.qjax_writer import im2col as j_im2col
from repro.kernels.qmatmul import ops as j_qops
from repro.kernels.qmatmul.ops import qgemm as j_qgemm
from repro.kernels.qmatmul.ops import qmatmul_int8_act as j_qmm
from repro.kernels.qmatmul.ref import qgemm_ref as j_qgemm_ref
from repro.kernels.qmatmul.ref import qmatmul_int8_act_ref as j_qmm_ref
from repro.models import cnn as j_models
from repro.quant.pack import PackedWeights as JPacked
from repro.quant.pack import pack_rows as j_pack_rows
from repro.quant.qtypes import DatatypeConfig as JDT

from repro_torch.configs.mnist_cnn import CONFIG as CNN
from repro_torch.core.adaptive import (RuntimePolicy, WorkingPoint,
                                       shared_point_executables)
from repro_torch.core.flow import DesignFlow
from repro_torch.core.ir import Graph
from repro_torch.core.reader import cnn_to_ir, mlp_to_ir
from repro_torch.core.writers.qtorch_writer import (ActCode, QTorchContext,
                                                    QTorchWriter, im2col)
from repro_torch.core.writers.torch_writer import TorchWriter
from repro_torch.device import resolve_device
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.kernels.qmatmul.ops import (pick_blocks, pick_tiles,
                                             qgemm_float, qmatmul_int8_act)
from repro_torch.kernels.qmatmul.ref import (epilogue_ref, qgemm_ref,
                                             qmatmul_int8_act_ref)
from repro_torch.quant.fixedpoint import fake_quant
from repro_torch.quant.pack import PackedWeights, pack_rows, unpack_rows
from repro_torch.quant.ptq import derive_view
from repro_torch.quant.qtypes import DatatypeConfig, QType

POINTS = [WorkingPoint("w8", 8), WorkingPoint("w4", 4), WorkingPoint("w2", 2)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _quantize(w):
    s = np.maximum(np.abs(w).max(0), 1e-8) / np.float32(127.0)
    codes = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return codes, s.astype(np.float32)


def _params(seed=0):
    return {k: np.asarray(v) for k, v in
            j_models.init_params(J_CNN, jax.random.PRNGKey(seed)).items()}


def _graphs(seed=0):
    """(reference graph, port graph) of mnist-cnn from the same params."""
    p = _params(seed)
    return j_cnn_to_ir(J_CNN, p), cnn_to_ir(CNN, p)


def _uniform(seed, shape):
    """The reference test's ``jax.random.uniform`` draw, as numpy."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape),
                      np.float32)


def _float_copy_reference(qwriter, bits, act_ranges=None):
    """The fake-quant baseline over the SAME quantizer: a plain TorchWriter
    whose initializers are the packed weights dequantized at ``bits``."""
    g = qwriter.graph
    deq = {k: v.numpy() for k, v in qwriter.packed.dequantized(bits).items()}
    g2 = Graph(g.name, g.nodes, g.inputs, g.outputs, deq)
    return TorchWriter(g2, DatatypeConfig(qwriter.dt.act_bits, 32),
                       act_ranges or qwriter.act_ranges,
                       device="cpu").build()


def _j_float_copy_reference(qwriter, bits):
    g = qwriter.graph
    deq = {k: np.asarray(v)
           for k, v in qwriter.packed.dequantized(bits).items()}
    g2 = JGraph(g.name, g.nodes, g.inputs, g.outputs, deq)
    return JaxWriter(g2, JDT(qwriter.dt.act_bits, 32),
                     qwriter.act_ranges).build()


def _close(got, want, rel=1e-6):
    """Within ``rel`` of the largest |want| (cross-framework f32 order)."""
    want = np.asarray(want, np.float32)
    tol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# ops / kernel level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("relu,with_bias,with_aqt", [
    (False, False, False), (True, True, True), (False, True, True),
    (True, False, True)])
def test_qgemm_kernel_epilogue_matches_ref(bits, relu, with_bias, with_aqt):
    """The port's float-mode entry point (its plain version on the CPU)
    against both oracles (1e-6 of max|y|, 2^-frac where an activation
    quant may round a summation-order difference to the next step) and
    the reference's interpret-mode kernel (bf16 activations: its own
    1-ulp-of-max bf16 tolerance)."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(bits), (128, 256),
                                     jnp.float32))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (256, 128),
                                     jnp.float32))
    codes, s = _quantize(w)
    bias = (np.asarray(jax.random.normal(jax.random.PRNGKey(2), (128,)))
            * 0.1).astype(np.float32) if with_bias else None
    aqt = (10, -(2 ** 15), 2 ** 15 - 1) if with_aqt else None
    y_t = qgemm_float(_t(x), _t(codes), _t(s),
                      None if bias is None else _t(bias), bits=bits,
                      relu=relu, act_qt=aqt).numpy()
    y_r = np.asarray(j_qgemm_ref(x, codes, s, bias, bits=bits, relu=relu,
                                 act_qt=aqt), np.float32)
    assert torch.equal(_t(y_t), qgemm_ref(_t(x), _t(codes), _t(s),
                                          None if bias is None else _t(bias),
                                          bits=bits, relu=relu, act_qt=aqt))
    tol = 1e-6 * float(np.abs(y_r).max()) + (2.0 ** -10 if with_aqt else 0)
    np.testing.assert_allclose(y_t, y_r, rtol=0, atol=tol)
    y_k = np.asarray(j_qgemm(x, codes, s, bias, bits=bits, relu=relu,
                             act_qt=aqt, interpret=True, use_kernel=True),
                     np.float32)
    np.testing.assert_allclose(y_t, y_k, rtol=0,
                               atol=float(np.abs(y_r).max()) * 2 ** -7 + 1e-6)


def test_epilogue_matches_fixedpoint_fake_quant():
    """The fused activation quant is bit-identical to fake_quant, and to
    the reference's epilogue."""
    from repro.kernels.qmatmul.ref import epilogue_ref as j_epilogue
    qt = QType(16, 10)
    y = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 64))) * 40.0
    fused = epilogue_ref(_t(y), relu=True, act_qt=(qt.frac, qt.qmin, qt.qmax))
    manual = fake_quant(torch.clamp_min(_t(y), 0.0), qt)
    assert torch.equal(fused, manual)
    np.testing.assert_array_equal(
        fused.numpy(), np.asarray(j_epilogue(y, relu=True,
                                             act_qt=(10, qt.qmin, qt.qmax))))


def test_resolve_interpret_is_backend_aware():
    """The reference picks interpret mode off the TPU; the port picks its
    device: None means the card (raising without one), an explicit device
    always wins."""
    assert j_qops.resolve_interpret(None) == (jax.default_backend() != "tpu")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)


def test_pick_blocks_caches_and_divides(monkeypatch):
    """An untimed pick is the static rule, keyed apart from timed picks (an
    untimed entry must not pin the rule for later timed calls of the shape);
    its tiles are ones the kernel takes, and the reference's blocks divide
    the padded problem."""
    monkeypatch.setattr(qops, "_BLOCK_CACHE", {})
    j_qops._BLOCK_CACHE.clear()
    bm, bn, bk = j_qops.pick_blocks(256, 512, 384, 8, interpret=True)
    assert 256 % bm == 0 and 384 % bn == 0 and 512 % bk == 0
    t = pick_blocks(256, 512, 384, 8)
    assert t == pick_tiles(256, 512, 384) and qops._legal(t, 256, 512, 384,
                                                          False)
    assert (256, 512, 384, 8, True, False, False) in qops._BLOCK_CACHE
    assert (256, 512, 384, 8, True, False, True) not in qops._BLOCK_CACHE
    assert pick_blocks(256, 512, 384, 8) is t


def test_qgemm_small_shapes_fall_back_to_ref():
    """Below 8 rows the reference takes its oracle; the port's plain
    version is that oracle at every size, bit for bit with the reference's."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 6)))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (6, 4)))
    codes, s = _quantize(w)
    y_j = np.asarray(j_qgemm(x, codes, s, bits=8, use_kernel=True,
                             interpret=True))
    y_t = qgemm_float(_t(x), _t(codes), _t(s), bits=8).numpy()
    np.testing.assert_array_equal(y_j, np.asarray(j_qgemm_ref(x, codes, s,
                                                              bits=8)))
    _close(y_t, y_j)
    assert torch.equal(_t(y_t), qgemm_ref(_t(x), _t(codes), _t(s), bits=8))


def test_im2col_matches_xla_conv():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 9, 9, 3)))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (3, 3, 3, 5))) \
        * 0.2
    patches, oh, ow = im2col(_t(x), 3, 3, (1, 1), "SAME")
    j_patches, _, _ = j_im2col(x, 3, 3, (1, 1), "SAME")
    np.testing.assert_array_equal(patches.numpy(), np.asarray(j_patches))
    y = patches.reshape(-1, 27) @ _t(w).reshape(27, 5)
    ref = jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(y.reshape(2, oh, ow, 5).numpy(),
                               np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# PackedWeights: nested views, one buffer
# ---------------------------------------------------------------------------

def test_nested_view_truncation_property():
    """W4 codes are the truncation of the W8 master (and W2 of it), equal
    to the reference's codes and views."""
    jg, tg = _graphs()
    packed = PackedWeights.from_initializers(tg.initializers, "cpu")
    j_packed = JPacked.from_initializers(jg.initializers)
    assert packed.tensors and set(packed.tensors) == set(j_packed.tensors)
    for name, t in packed.tensors.items():
        assert torch.equal(t.view(8), t.codes)
        np.testing.assert_array_equal(t.codes.numpy(),
                                      np.asarray(j_packed.tensors[name].codes))
        for bits in (4, 2):
            assert torch.equal(t.view(bits), derive_view(t.codes, bits))
            np.testing.assert_array_equal(
                t.view(bits).numpy(),
                np.asarray(j_packed.tensors[name].view(bits)), err_msg=name)
            step = 1 << (8 - bits)
            assert int((t.view(bits).to(torch.int32).abs() % step).max()) == 0


def test_biases_and_norm_stats_pass_through():
    _, tg = _graphs()
    packed = PackedWeights.from_initializers(tg.initializers, "cpu")
    assert "conv0/b" in packed.passthrough
    assert "bn0/mean" in packed.passthrough
    assert "conv0/w" in packed.tensors and "fc/w" in packed.tensors


# ---------------------------------------------------------------------------
# writer-level differential: packed path == fake-quant reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4, 2])
def test_qjax_ref_path_bitexact_vs_fake_quant_reference(bits):
    """The port's packed path equals its fake-quant copy over the same
    quantizer bit for bit, and the reference's plain path within f32
    order."""
    jg, tg = _graphs()
    x = _uniform(1, (3, 28, 28, 1))
    w = QTorchWriter(tg, DatatypeConfig(16, 8), device="cpu")
    got = w.build(bits=bits)(x).numpy()
    np.testing.assert_array_equal(got,
                                  _float_copy_reference(w, bits)(x).numpy())
    jw = QJaxWriter(jg, JDT(16, 8), use_kernel=False)
    _close(got, jw.build(bits=bits)(x))


@pytest.mark.parametrize("bits", [8, 4])
def test_qjax_kernel_path_matches_fake_quant_reference(bits):
    """The reference's forced interpret-mode kernels end to end (bf16
    activations in the MXU tiles) against the port: within the reference's
    ulp-of-max tolerance of its fake-quant copy."""
    jg, tg = _graphs()
    x = _uniform(2, (1, 28, 28, 1))
    jw = QJaxWriter(jg, JDT(16, 8), use_kernel=True, interpret=True)
    j_kernel = np.asarray(jw.build(bits=bits)(x))
    ref = np.asarray(_j_float_copy_reference(jw, bits)(x))
    w = QTorchWriter(tg, DatatypeConfig(16, 8), device="cpu")
    got = w.build(bits=bits)(x).numpy()
    tol = np.max(np.abs(ref)) * 2 ** -7 + 1e-6
    np.testing.assert_allclose(got, ref, atol=tol)
    np.testing.assert_allclose(got, j_kernel, atol=tol)
    np.testing.assert_array_equal(got,
                                  _float_copy_reference(w, bits)(x).numpy())


def _mlp(seed, sizes, wscale=1.0, bscale=1.0):
    rng = np.random.default_rng(seed)
    params = {}
    for i in range(len(sizes) - 1):
        params[f"fc{i}/w"] = rng.normal(
            size=(sizes[i], sizes[i + 1])).astype(np.float32) * wscale
        params[f"fc{i}/b"] = rng.normal(
            size=(sizes[i + 1],)).astype(np.float32) * bscale
    return params, rng


def test_qjax_mlp_gemm_chain_bitexact():
    sizes = [12, 16, 8, 4]
    params, rng = _mlp(0, sizes)
    x = rng.random((5, 12), np.float32)
    w = QTorchWriter(mlp_to_ir(sizes, params), DatatypeConfig(16, 8),
                     device="cpu")
    jw = QJaxWriter(j_mlp_to_ir(sizes, params), JDT(16, 8), use_kernel=False)
    for bits in (8, 4, 2):
        got = w.build(bits=bits)(x).numpy()
        np.testing.assert_array_equal(
            got, _float_copy_reference(w, bits)(x).numpy())
        _close(got, jw.build(bits=bits)(x))


def test_act_quant_fused_into_epilogue_not_reapplied():
    _, tg = _graphs()
    x = _uniform(3, (2, 28, 28, 1))
    w = QTorchWriter(tg, DatatypeConfig(16, 8), device="cpu")
    y = w.build()(x)
    fused_ops = {n.outputs[0] for n in w.graph.topo_order()
                 if n.op in ("Conv", "FusedConv", "Gemm", "MatMul")}
    assert fused_ops <= w._fused_act
    w._fused_act.clear()
    node = next(n for n in w.graph.topo_order() if n.op == "Gemm")
    assert torch.equal(w._act_q(node.outputs[0], y, node), y)


def test_default_bits_follows_dtconfig():
    _, g = _graphs()
    assert QTorchWriter(g, device="cpu").default_bits == 8
    assert QTorchWriter(g, DatatypeConfig(16, 4),
                        device="cpu").default_bits == 4
    assert QTorchWriter(g, DatatypeConfig(16, 16),
                        device="cpu").default_bits == 8
    w = QTorchWriter(g, DatatypeConfig(16, 4), device="cpu")
    assert QTorchContext(w, 8).weight_bits(None) == 4
    assert QTorchContext(w, 2).weight_bits(None) == 2


def test_reference_writers_reject_bits_parameter():
    jg, tg = _graphs()
    with pytest.raises(ValueError, match="packed-weight"):
        TorchWriter(tg, device="cpu").build(bits=8)
    with pytest.raises(ValueError, match="packed-weight"):
        JaxWriter(jg).build(bits=8)


# ---------------------------------------------------------------------------
# shared weight buffer across working points (the MDC merge, acceptance)
# ---------------------------------------------------------------------------

def test_point_executables_share_one_packed_buffer():
    jg, tg = _graphs()
    res = DesignFlow(tg, device="cpu").run(targets=("qtorch",),
                                           dtconfig=DatatypeConfig(16, 8))
    writer = res.writers["qtorch"]
    pts = shared_point_executables(writer, POINTS)
    for name, t in writer.packed.tensors.items():
        ptrs = {pts[p.name].packed.tensors[name].codes.data_ptr()
                for p in POINTS}
        assert len(ptrs) == 1, f"{name} duplicated across points"
    assert [pts[p.name].bits for p in POINTS] == [8, 4, 2]
    rep = writer.packed.sharing_report(len(POINTS))
    assert rep["shared_bytes"] * 3 == rep["per_point_copy_bytes"]
    assert rep["shared_bytes"] / rep["per_point_copy_bytes"] <= 0.34
    assert rep["sharing_ratio"] * rep["shared_bytes"] == \
        rep["per_point_f32_bytes"]
    assert rep["sharing_ratio"] > 3.0
    j_rep = JFlow(jg).run(targets=("qjax",), dtconfig=JDT(16, 8)).writers[
        "qjax"].packed.sharing_report(3)
    assert rep == j_rep


def test_shared_points_require_packed_writer():
    _, tg = _graphs()
    res = DesignFlow(tg, device="cpu").run(targets=("torch",))
    with pytest.raises(TypeError, match="packed"):
        shared_point_executables(res.writers["torch"], POINTS)
    with pytest.raises(KeyError, match="qtorch"):
        res.serve_adaptive(POINTS)


def test_serve_adaptive_switches_bits_with_zero_weight_copies():
    jg, tg = _graphs()
    res = DesignFlow(tg, device="cpu").run(targets=("qtorch",),
                                           dtconfig=DatatypeConfig(16, 8))
    srv = res.serve_adaptive(
        POINTS, policy=RuntimePolicy(POINTS, thresholds=[0.66, 0.33]),
        max_batch=4, max_wait=0.0)
    x = _uniform(4, (2, 28, 28, 1))
    outs = {}
    for budget, point in ((1.0, "w8"), (0.5, "w4"), (0.1, "w2")):
        t = srv.submit(x, budget=budget)
        srv.pump(flush=True)
        outs[point] = np.asarray(srv.result(t))
    stats = srv.stats()
    assert stats["points"] == {"w8": 1, "w4": 1, "w2": 1}
    assert stats["bits_views"] == {8: 1, 4: 1, 2: 1}
    assert [r.bits for r in srv.reports] == [8, 4, 2]
    writer = res.writers["qtorch"]
    jw = JFlow(jg).run(targets=("qjax",), dtconfig=JDT(16, 8)).writers["qjax"]
    for point, bits in (("w8", 8), ("w4", 4), ("w2", 2)):
        np.testing.assert_allclose(
            outs[point], writer.build(bits=bits)(x).numpy(), atol=1e-6)
        _close(outs[point], jw.build(bits=bits)(x))


# ---------------------------------------------------------------------------
# fully-integer hot path: int8 activation codes end-to-end
# ---------------------------------------------------------------------------

def _mk_int8_inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xs = 2.0 ** -4
    xc = np.clip(np.round(x / xs), -128, 127).astype(np.int8)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.3
    s = (np.maximum(np.abs(w).max(0), 1e-8) / 127.0).astype(np.float32)
    wc = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return xc, xs, wc, s, b


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (64, 200, 48),
                                   (130, 130, 130)])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_int8_act_kernel_bitexact_vs_ref(M, K, N, bits):
    """The fully-integer entry point equals the reference's oracle and its
    interpret-mode kernel bit for bit across shapes and working points."""
    xc, xs, wc, s, b = _mk_int8_inputs(M, K, N, seed=bits)
    aqt = (10, -128, 127)
    for out_code in (False, True):
        y_t = qmatmul_int8_act(_t(xc), xs, _t(wc), _t(s), _t(b), bits=bits,
                               relu=True, act_qt=aqt, out_code=out_code)
        y_r = j_qmm_ref(xc, xs, wc, s, bits, bias=b, relu=True, act_qt=aqt,
                        out_code=out_code, out_dtype=jnp.float32)
        y_k = j_qmm(xc, xs, wc, s, b, bits=bits, relu=True, act_qt=aqt,
                    out_code=out_code, interpret=True, use_kernel=True,
                    out_dtype=jnp.float32)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_r))
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_k))
        assert torch.equal(y_t, qmatmul_int8_act_ref(
            _t(xc), xs, _t(wc), _t(s), bits, bias=_t(b), relu=True,
            act_qt=aqt, out_code=out_code))
        if out_code:
            assert y_t.dtype == torch.int8


@pytest.mark.parametrize("bits", [4, 2])
def test_int8_act_kernel_packed_weights_bitexact(bits):
    """Sub-byte packed weights: the port's split-row buffer equals the
    reference's byte for byte, and the packed path equals the unpacked
    oracle."""
    xc, xs, wc, s, b = _mk_int8_inputs(64, 200, 48, seed=bits + 10)
    packed = pack_rows(_t(wc), bits)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_pack_rows(wc, bits)))
    kw = dict(bits=bits, relu=True, act_qt=(9, -128, 127), out_code=True)
    y_t = qmatmul_int8_act(_t(xc), xs, packed, _t(s), _t(b), packed=True,
                           **kw)
    y_r = j_qmm_ref(xc, xs, wc, s, bits, bias=b, relu=True,
                    act_qt=(9, -128, 127), out_code=True)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_r))


def test_int8_act_per_row_scale_legacy_path():
    xc, _, wc, s, _ = _mk_int8_inputs(128, 256, 128, seed=3)
    xs = np.random.default_rng(3).uniform(0.001, 0.1, 128).astype(np.float32)
    for t_dt, j_dt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        y_t = qmatmul_int8_act(_t(xc), _t(xs), _t(wc), _t(s), bits=8,
                               out_dtype=t_dt)
        y_k = j_qmm(xc, xs, wc, s, bits=8, interpret=True, use_kernel=True,
                    out_dtype=j_dt)
        y_r = j_qmm_ref(xc, xs, wc, s, 8, out_dtype=j_dt)
        np.testing.assert_array_equal(y_t.float().numpy(),
                                      np.asarray(y_r, np.float32))
        np.testing.assert_array_equal(np.asarray(y_k, np.float32),
                                      np.asarray(y_r, np.float32))


@pytest.mark.parametrize("bits", [4, 2])
def test_pack_rows_roundtrip_and_padding(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(-127, 128, (200, 40)).astype(np.int8)
    up = unpack_rows(pack_rows(_t(codes), bits), bits).numpy()
    assert up.shape == (256, 40)
    np.testing.assert_array_equal(up[:200],
                                  derive_view(_t(codes), bits).numpy())
    assert (up[200:] == 0).all()


def test_packed_view_byte_accounting():
    jg, tg = _graphs()
    packed = PackedWeights.from_initializers(tg.initializers, "cpu")
    j_packed = JPacked.from_initializers(jg.initializers)
    for name, t in packed.tensors.items():
        w8 = t.view_nbytes(8)
        assert t.view_nbytes(4) <= 0.55 * w8
        assert t.view_nbytes(2) <= 0.30 * w8
        for bits in (4, 2):
            pv = t.packed_view(bits)
            assert pv.dtype == torch.uint8
            assert pv.numel() + 4 * t.scale.numel() == t.view_nbytes(bits) \
                == j_packed.tensors[name].view_nbytes(bits)
    rep = packed.sharing_report(3)
    vb = rep["view_bytes"]
    assert vb[4] <= 0.55 * vb[8] and vb[2] <= 0.30 * vb[8]
    assert vb == j_packed.sharing_report(3)["view_bytes"]


def test_packed_view_is_cached_one_buffer():
    _, tg = _graphs()
    packed = PackedWeights.from_initializers(tg.initializers, "cpu")
    t = next(iter(packed.tensors.values()))
    assert t.packed_view(4) is t.packed_view(4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_int8_act_codes_flow_between_layers(use_kernel):
    """At D8 every inter-layer tensor is an int8 ActCode, floats only at the
    outputs; the codes equal the reference's (its plain path, or its
    forced interpret-mode kernels) FIFO by FIFO."""
    jg, tg = _graphs()
    rng = np.random.default_rng(0)
    calib = rng.random((2, 28, 28, 1), np.float32)
    jres = JFlow(jg).run(targets=("qjax",), dtconfig=JDT(8, 8),
                         calib_inputs=(calib,),
                         writer_kwargs={"qjax": {"use_kernel": use_kernel,
                                                 "interpret": True}})
    res = DesignFlow(tg, device="cpu").run(
        targets=("qtorch",), dtconfig=DatatypeConfig(8, 8),
        act_ranges=jres.act_ranges)
    w = res.writers["qtorch"]
    assert w.int8_act_on
    x = rng.random((2, 28, 28, 1), np.float32)
    out, env = w.build(capture=True)(x)
    j_out, j_env = jres.writers["qjax"].build(capture=True)(x)
    outputs = set(w.graph.outputs)
    for node in w.graph.topo_order():
        for o in node.outputs:
            if o in outputs:
                continue
            assert isinstance(env[o], ActCode), \
                f"{node.op} output {o} materialized {type(env[o]).__name__}"
            assert env[o].codes.dtype == torch.int8
            np.testing.assert_array_equal(env[o].codes.numpy(),
                                          np.asarray(j_env[o].codes))
    assert isinstance(env["input"], ActCode)
    assert torch.is_floating_point(out)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))


def test_int8_act_e2e_within_quantized_tolerance():
    """CNN + MLP: the port's fully-integer executable agrees with its float
    fake-quant reference to quantization tolerance (top-1 flips only inside
    the margin), and equals the reference's integer outputs bit for bit on
    the reference's calibration."""
    rng = np.random.default_rng(1)
    sizes = [64, 32, 16, 8]
    mlp_params = {}
    for i in range(len(sizes) - 1):
        mlp_params[f"fc{i}/w"] = rng.standard_normal(
            (sizes[i], sizes[i + 1])).astype(np.float32) * 0.3
        mlp_params[f"fc{i}/b"] = rng.standard_normal(
            sizes[i + 1]).astype(np.float32) * 0.1
    jg, tg = _graphs()
    cases = [(jg, tg, rng.random((3, 28, 28, 1), np.float32)),
             (j_mlp_to_ir(sizes, mlp_params), mlp_to_ir(sizes, mlp_params),
              rng.random((5, 64), np.float32))]
    for j_g, t_g, x in cases:
        jres = JFlow(j_g).run(targets=("qjax",), dtconfig=JDT(8, 8),
                              calib_inputs=(x[:2],),
                              writer_kwargs={"qjax": {"use_kernel": False}})
        res = DesignFlow(t_g, device="cpu").run(
            targets=("torch", "qtorch"), dtconfig=DatatypeConfig(8, 8),
            act_ranges=jres.act_ranges)
        y_ref = res.batched["torch"](x).numpy()
        y_int = res.batched["qtorch"](x).numpy()
        scale = np.max(np.abs(y_ref)) + 1e-9
        assert np.max(np.abs(y_ref - y_int)) / scale < 0.06
        for row in np.where(np.argmax(y_ref, -1) != np.argmax(y_int, -1))[0]:
            top2 = np.sort(y_ref[row])[-2:]
            assert top2[1] - top2[0] < 0.12 * scale
        w = res.writers["qtorch"]
        for bits in (8, 4, 2):
            np.testing.assert_array_equal(
                w.build(bits=bits)(x).numpy(),
                np.asarray(jres.writers["qjax"].build(bits=bits)(x)))


def test_int8_act_disabled_above_8_bit_activations():
    _, g = _graphs()

    def on(dt=None, **kw):
        return QTorchWriter(g, dt, device="cpu", **kw).int8_act_on

    assert not on(DatatypeConfig(16, 8))
    assert not on()
    assert on(DatatypeConfig(8, 8))
    assert not on(DatatypeConfig(8, 8), int8_act=False)
    assert on(DatatypeConfig(16, 8), int8_act=True)


def test_serve_adaptive_reports_packed_bits_bytes():
    jg, tg = _graphs()
    rng = np.random.default_rng(2)
    res = DesignFlow(tg, device="cpu").run(
        targets=("qtorch",), dtconfig=DatatypeConfig(8, 8),
        calib_inputs=(rng.random((2, 28, 28, 1), np.float32),))
    srv = res.serve_adaptive(POINTS, max_batch=4, max_wait=0.0)
    x = rng.random((1, 28, 28, 1), np.float32)
    t = srv.submit(x)
    srv.pump(flush=True)
    srv.result(t)
    bb = srv.stats()["bits_bytes"]
    packed = res.writers["qtorch"].packed
    assert bb == {b: packed.view_bytes(b) for b in (8, 4, 2)}
    assert bb[4] <= 0.55 * bb[8] and bb[2] <= 0.30 * bb[8]
    j_packed = JPacked.from_initializers(jg.initializers)
    assert bb == {b: j_packed.view_bytes(b) for b in (8, 4, 2)}


def test_autotune_cache_persists_across_processes(tmp_path, monkeypatch):
    """The port's timed picks survive the process, as the reference's do
    (the full set of cache cases: ``tests/test_torch_autotune.py``)."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(qops.AUTOTUNE_CACHE_ENV, str(path))
    monkeypatch.setattr(qops, "_BLOCK_CACHE", {})
    key = (6272, 9, 8, 8, True, False, True)
    tuned = qops.candidate_tiles(6272, 9, 8)[1]
    qops._disk_put(key, tuned)
    qops._BLOCK_CACHE.clear()
    qops._disk_state["path"] = False
    assert pick_blocks(6272, 9, 8, 8, timed=True) == tuned
    assert qops._BLOCK_CACHE[key] == tuned


def test_autotune_cache_disable_and_corrupt(tmp_path, monkeypatch):
    monkeypatch.setenv(qops.AUTOTUNE_CACHE_ENV, "off")
    assert qops.autotune_cache_path() is None
    qops._disk_put((1, 2, 3, 8, True, False, True), pick_tiles(1, 2, 3))
    path = tmp_path / "autotune.json"
    path.write_text("{not json")
    monkeypatch.setenv(qops.AUTOTUNE_CACHE_ENV, str(path))
    assert qops._disk_cache() == {}
    assert not path.read_text().startswith("{\"schema")


def test_qjax_flow_agrees_with_float_reference():
    """The packed engine at W8/D32 stays close to the float pipeline, and
    its outputs equal the reference's plain path within f32 order."""
    jg, tg = _graphs()
    x = _uniform(5, (4, 28, 28, 1))
    res = DesignFlow(tg, device="cpu").run(targets=("torch", "qtorch"))
    y_f = res.batched["torch"](x).numpy()
    y_q = res.batched["qtorch"](x).numpy()
    scale = np.max(np.abs(y_f)) + 1e-9
    assert np.max(np.abs(y_f - y_q)) / scale < 0.05
    assert np.mean(np.argmax(y_f, -1) == np.argmax(y_q, -1)) == 1.0
    jres = JFlow(jg).run(targets=("qjax",),
                         writer_kwargs={"qjax": {"use_kernel": False}})
    _close(y_q, jres.batched["qjax"](x))
