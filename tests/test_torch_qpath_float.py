"""The float-activation modes of the port's quantized kernels and the D16
working points of the ``qtorch`` target, against the reference on the CPU:

* float ``qgemm`` (plain version) against the reference's ``qgemm_ref`` over
  bits {8,4,2} x packed x ReLU x bias x act_qt, within ``max|y|*2^-7 + 1e-6``
  (the reference's own float-path contract);
* the per-row activation-scale mode of ``qmatmul_int8_act`` against the
  reference's ``qmatmul_int8_act_ref``: array_equal;
* float ``qconv_dw`` against the reference's ``qconv_dw_ref`` within
  ``max|y|*2^-22 + 1e-9``;
* the ``qtorch`` writer at D16-W8 against the reference's ``qjax`` ref path
  on both CNNs at W8/W4/W2, and the ``int8_act`` option;
* on the card, each kernel mode against its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core.flow import DesignFlow as JFlow
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.core.writers.qjax_writer import QJaxWriter
from repro.kernels.qconv_dw.ref import qconv_dw_ref as j_qconv_dw_ref
from repro.kernels.qmatmul.ref import qgemm_ref as j_qgemm_ref
from repro.kernels.qmatmul.ref import \
    qmatmul_int8_act_ref as j_int8_act_ref
from repro.models import cnn as j_models
from repro.quant.qtypes import DatatypeConfig as JDT

from repro_torch.configs.mnist_cnn import CONFIG as T_CNN
from repro_torch.configs.separable_cnn import CONFIG as T_SEP
from repro_torch.core.flow import DesignFlow as TFlow
from repro_torch.core.flow import WriterOptions
from repro_torch.core.reader import cnn_to_ir as t_cnn_to_ir
from repro_torch.core.reader import separable_cnn_to_ir as t_sep_to_ir
from repro_torch.core.writers.qtorch_writer import ActCode, QTorchWriter
from repro_torch.kernels import checks
from repro_torch.kernels.qconv_dw.ops import DW_PACK_ALIGN, qconv_dw_float
from repro_torch.kernels.qmatmul.ops import qgemm_float, qmatmul_int8_act
from repro_torch.models import cnn as t_models
from repro_torch.quant.pack import PACK_ALIGN, pack_rows
from repro_torch.quant.qtypes import DatatypeConfig as TDT

MODELS = ["separable-cnn", "mnist-cnn"]

WEIGHTS = [(8, False), (4, False), (2, False), (4, True), (2, True)]
EPILOGUES = [(relu, bias, aqt) for relu in (False, True)
             for bias in (False, True)
             for aqt in (None, (10, -(2 ** 15), 2 ** 15 - 1))]


def _weights(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32)
    s = np.maximum(np.abs(w).max(0), 1e-8) / 127.0
    codes = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return codes, s.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("relu,bias,aqt", EPILOGUES)
@pytest.mark.parametrize("bits,packed", WEIGHTS)
def test_float_qgemm_matches_reference(bits, packed, relu, bias, aqt):
    rng = np.random.default_rng(bits * 10 + packed)
    x = rng.standard_normal((37, 200)).astype(np.float32)
    codes, s = _weights(rng, 200, 24)
    b = (rng.standard_normal(24) * 0.1).astype(np.float32) if bias else None
    want = np.asarray(j_qgemm_ref(x, codes, s, b, bits=bits, relu=relu,
                                  act_qt=aqt))
    w = pack_rows(_t(codes), bits, PACK_ALIGN) if packed else _t(codes)
    got = qgemm_float(_t(x), w, _t(s), None if b is None else _t(b),
                      bits=bits, relu=relu, act_qt=aqt, packed=packed)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = np.abs(want).max() * 2.0 ** -7 + 1e-6
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


@pytest.mark.parametrize("out_code", [False, True])
@pytest.mark.parametrize("bits,packed", WEIGHTS)
def test_per_row_xscale_equals_reference(bits, packed, out_code):
    rng = np.random.default_rng(40 + bits)
    x = rng.standard_normal((29, 150)).astype(np.float32)
    xs = (np.abs(x).max(1) / 127.0).astype(np.float32)
    xc = np.clip(np.round(x / xs[:, None]), -127, 127).astype(np.int8)
    codes, s = _weights(rng, 150, 20)
    b = (rng.standard_normal(20) * 0.1).astype(np.float32)
    aqt = (5, -128, 127)
    want = np.asarray(j_int8_act_ref(xc, xs, codes, s, bits, bias=b,
                                     relu=True, act_qt=aqt, out_code=out_code,
                                     out_dtype=jnp.float32))
    w = pack_rows(_t(codes), bits, PACK_ALIGN) if packed else _t(codes)
    got = qmatmul_int8_act(_t(xc), _t(xs), w, _t(s), _t(b), bits=bits,
                           relu=True, act_qt=aqt, out_code=out_code,
                           packed=packed)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pads", ["SAME", "VALID"])
@pytest.mark.parametrize("strides", [(1, 1), (2, 2), (1, 2)])
@pytest.mark.parametrize("bits,packed", WEIGHTS)
def test_float_qconv_dw_matches_reference(bits, packed, strides, pads):
    rng = np.random.default_rng(60 + bits)
    x = rng.standard_normal((2, 11, 10, 13)).astype(np.float32)
    codes, s = _weights(rng, 9, 13)
    b = (rng.standard_normal(13) * 0.1).astype(np.float32)
    w = pack_rows(_t(codes), bits, DW_PACK_ALIGN) if packed else _t(codes)
    for relu, bias, aqt in EPILOGUES:
        bb = b if bias else None
        want = np.asarray(j_qconv_dw_ref(
            x, codes, s, bb, kh=3, kw=3, strides=strides, pads=pads,
            bits=bits, relu=relu, act_qt=aqt))
        got = qconv_dw_float(_t(x), w, _t(s), None if bb is None else _t(bb),
                             kh=3, kw=3, strides=strides, pads=pads,
                             bits=bits, relu=relu, act_qt=aqt, packed=packed)
        assert got.shape == want.shape
        tol = np.abs(want).max() * 2.0 ** -22 + 1e-9
        np.testing.assert_allclose(got.numpy(), want, atol=tol)


# -- the qtorch writer at the D16 working points -----------------------------

def _graphs(which):
    """(reference graph, port graph) from the reference's seed-pinned
    parameters."""
    if which == "separable-cnn":
        p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(0))
        p = {k: np.asarray(v) for k, v in p.items()}
        return j_sep_to_ir(J_SEP, p), t_sep_to_ir(
            T_SEP, t_models.params_from_jax(p, "cpu"))
    p = j_models.init_params(J_CNN, jax.random.PRNGKey(0))
    p = {k: np.asarray(v) for k, v in p.items()}
    return j_cnn_to_ir(J_CNN, p), t_cnn_to_ir(
        T_CNN, t_models.params_from_jax(p, "cpu"))


_RUNS = {}


def _runs(which, dt=(16, 8), int8_act=None):
    """(reference qjax ref-path result, the port's result with the
    reference's act_ranges) for one model and datatype."""
    key = (which, dt, int8_act)
    if key not in _RUNS:
        jg, tg = _graphs(which)
        rng = np.random.default_rng(0)
        calib = rng.random((3, 28, 28, 1), np.float32)
        kw = {"use_kernel": False}
        if int8_act is not None:
            kw["int8_act"] = int8_act
        jres = JFlow(jg).run(("qjax",), JDT(*dt), calib_inputs=(calib,),
                             writer_kwargs={"qjax": kw})
        tres = TFlow(tg, device="cpu").run(
            ("qtorch",), TDT(*dt), act_ranges=jres.act_ranges,
            options=WriterOptions(int8_act=int8_act))
        _RUNS[key] = (jres.writers["qjax"], tres.writers["qtorch"])
    return _RUNS[key]


def _x():
    return np.random.default_rng(1).random((3, 28, 28, 1), np.float32)


def _assert_close(got, want):
    tol = np.abs(want).max() * 2.0 ** -7 + 1e-6
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("which", MODELS)
def test_qtorch_d16_matches_qjax_reference(which, bits):
    jw, tw = _runs(which)
    assert not tw.int8_act_on and not jw.int8_act_on
    y, env = tw.build(capture=True, bits=bits)(_x())
    _assert_close(y.numpy(), np.asarray(jw.build(bits=bits)(_x())))
    assert not any(isinstance(v, ActCode) for v in env.values())
    # every hot op ran its fused float epilogue
    hot = [n.outputs[0] for n in tw.graph.nodes
           if n.op in ("FusedConv", "FusedDepthwiseConv", "Gemm", "Conv",
                       "FusedGemm", "DepthwiseConv")]
    assert hot and set(hot) <= tw._fused_act


def test_qtorch_d16_packed_weights_off_is_the_same():
    _, tw = _runs("mnist-cnn")
    off = QTorchWriter(tw.graph, TDT(16, 8), tw.act_ranges, device="cpu",
                       packed_weights=False)
    for bits in (4, 2):
        np.testing.assert_array_equal(off.build(bits=bits)(_x()).numpy(),
                                      tw.build(bits=bits)(_x()).numpy())


@pytest.mark.parametrize("dt,int8_act,on", [
    ((8, 8), False, False), ((16, 8), True, True)])
@pytest.mark.parametrize("which", MODELS)
def test_int8_act_option_matches_reference(which, dt, int8_act, on):
    """``int8_act`` forces the dataflow as the reference's writer option
    does: off at D8 runs the float modes with an 8-bit fake-quant; on at D16
    sets the flag, yet no FIFO fits int8 codes, so the D16 path stays
    float."""
    jw, tw = _runs(which, dt, int8_act)
    assert tw.int8_act_on is on and jw.int8_act_on is on
    for bits in (8, 2):
        y, env = tw.build(capture=True, bits=bits)(_x())
        _assert_close(y.numpy(), np.asarray(jw.build(bits=bits)(_x())))
        assert not any(isinstance(v, ActCode) for v in env.values())


def test_int8_act_defaults_follow_activation_precision():
    g = _graphs("mnist-cnn")[1]
    assert not QTorchWriter(g, TDT(16, 8), device="cpu").int8_act_on
    assert not QTorchWriter(g, device="cpu").int8_act_on
    assert QTorchWriter(g, TDT(8, 8), device="cpu").int8_act_on
    assert not QTorchWriter(g, TDT(8, 8), device="cpu",
                            int8_act=False).int8_act_on
    assert QTorchWriter(g, TDT(16, 8), device="cpu", int8_act=True).int8_act_on
    jg = _graphs("mnist-cnn")[0]
    assert QJaxWriter(jg, JDT(16, 8), int8_act=True).int8_act_on


def test_float_sweeps_run_their_cases_on_the_cpu():
    r = checks.qgemm_float_sweep("cpu", shapes=[(3, 9, 10)])
    assert r["cases"] == 5 * 3 * 2 * 2 and r["failures"] == []
    r = checks.qconv_dw_float_sweep("cpu", shapes=[(1, 5, 6, 3)],
                                    strides=[(2, 2)], pads=["SAME"])
    assert r["cases"] == 5 * 3 * 2 * 2 and r["failures"] == []
    r = checks.qgemm_sweep("cpu", shapes=[(3, 9, 10)], per_row=True)
    assert r["cases"] == 5 * 3 * 2 * 2 and r["max_abs_err"] == 0.0


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_float_qgemm_kernel_within_contract(cuda):
    from repro_torch.kernels.qmatmul.ops import qgemm_f32
    before = qgemm_f32.launches
    res = checks.qgemm_float_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert qgemm_f32.launches - before == res["cases"]


@pytest.mark.cuda
def test_per_row_xscale_kernel_equals_plain_version(cuda):
    res = checks.qgemm_sweep(cuda, per_row=True)
    torch.cuda.synchronize()
    assert res["failures"] == [] and res["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_float_qconv_dw_kernel_equals_plain_version(cuda):
    from repro_torch.kernels.qconv_dw.ops import qconv_dw_f32
    before = qconv_dw_f32.launches
    res = checks.qconv_dw_float_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [] and res["max_abs_err"] == 0.0
    assert qconv_dw_f32.launches - before == res["cases"]
