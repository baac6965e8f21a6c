"""The im2col depthwise baseline (``dw_mode="im2col"``) of the port's
``qtorch`` writer: the depthwise taps expanded to a dense block-diagonal
matrix and run through im2col + ``qgemm``, against the direct ``qconv_dw``
lowering and against the reference's qjax im2col output (the differential of
``tests/test_depthwise.py``'s writer tests).  At D8 both lowerings share
their integer accumulators and power-of-two folds, so every output bit
matches, at W8/W4/W2 with packed storage on and off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core.flow import DesignFlow as JFlow
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.kernels.qconv_dw.ref import expand_dw_codes as j_expand
from repro.models import cnn as j_models
from repro.quant.qtypes import DatatypeConfig as JDT

from repro_torch.configs.separable_cnn import CONFIG as SEP
from repro_torch.core.flow import DesignFlow, WriterOptions
from repro_torch.core.reader import separable_cnn_to_ir
from repro_torch.core.writers import qtorch_writer
from repro_torch.core.writers.qtorch_writer import QTorchWriter
from repro_torch.kernels.qconv_dw.ref import expand_dw_codes
from repro_torch.models import cnn
from repro_torch.quant.ptq import derive_view
from repro_torch.quant.qtypes import DatatypeConfig


class _Case:
    """test_depthwise.py's D8 fixture: separable-cnn from PRNGKey(0), two
    calibration images and three inputs, the same numpy arrays in both
    packages; the reference's qjax im2col outputs on its plain path."""

    def __init__(self):
        p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(0))
        p = {k: np.asarray(v) for k, v in p.items()}
        self.tg = separable_cnn_to_ir(SEP, cnn.params_from_jax(p, "cpu"))
        rng = np.random.default_rng(0)
        self.calib = rng.random((2, 28, 28, 1), np.float32)
        self.x = rng.random((3, 28, 28, 1), np.float32)
        self.jres = {}
        for dt in (8, 16):
            self.jres[dt] = JFlow(j_sep_to_ir(J_SEP, p)).run(
                ("qjax",), JDT(dt, 8), calib_inputs=(self.calib,),
                writer_kwargs={"qjax": {"dw_mode": "im2col",
                                        "use_kernel": False}})
        w = self.jres[8].writers["qjax"]
        self.jout = {b: np.asarray(w.build(bits=b)(self.x)) for b in (8, 4, 2)}

    def port(self, dw_mode, act_bits=8, **opts):
        """The port's writer on the CPU with the reference's act_ranges."""
        return DesignFlow(self.tg, device="cpu").run(
            ("qtorch",), DatatypeConfig(act_bits, 8),
            act_ranges=self.jres[act_bits].act_ranges,
            options=WriterOptions(dw_mode=dw_mode, **opts)).writers["qtorch"]


@pytest.fixture(scope="module")
def case():
    return _Case()


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_direct_vs_im2col_bitexact_at_d8(case, bits, packed):
    direct = case.port("direct", packed_weights=packed)
    im2col = case.port("im2col", packed_weights=packed)
    assert im2col.dw_mode == "im2col" and im2col.packed_storage is packed
    y_dir = direct.build(bits=bits)(case.x).numpy()
    y_im = im2col.build(bits=bits)(case.x).numpy()
    np.testing.assert_array_equal(y_dir, y_im)
    np.testing.assert_array_equal(y_im, case.jout[bits])


def test_direct_vs_im2col_bitexact_with_own_calibration(case):
    """The differential holds with the port's own calibration as well
    (``DesignFlow.run(calib_inputs=...)``, the batched executable)."""
    outs = []
    for mode in ("direct", "im2col"):
        res = DesignFlow(case.tg, device="cpu").run(
            ("qtorch",), DatatypeConfig(8, 8), calib_inputs=(case.calib,),
            options=WriterOptions(dw_mode=mode))
        outs.append(res.batched["qtorch"](case.x).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_im2col_at_d16_within_the_float_tolerance(case):
    """Float activations (D16): the dense matmul sums the same taps with
    zeros between them, so it stays within the float path's
    ``max|y|*2^-7 + 1e-6`` of direct and of the reference's im2col."""
    jw = case.jres[16].writers["qjax"]
    for bits in (8, 4, 2):
        y_dir = case.port("direct", 16).build(bits=bits)(case.x).numpy()
        y_im = case.port("im2col", 16).build(bits=bits)(case.x).numpy()
        y_ref = np.asarray(jw.build(bits=bits)(case.x))
        tol = float(np.abs(y_dir).max()) * 2.0 ** -7 + 1e-6
        assert np.abs(y_im - y_dir).max() <= tol
        assert np.abs(y_im - y_ref).max() <= tol


def test_im2col_runs_qgemm_on_unpacked_dense_codes(case, monkeypatch):
    """No depthwise op reaches ``qconv_dw`` in im2col mode: each runs one
    ``qmatmul_int8_act`` over the unpacked (kh*kw*C, C) int8 expansion,
    truncated to ``bits`` in the matmul even with packed storage on; a
    forward runs two more matmuls than in direct mode."""
    calls = []
    real = qtorch_writer.qmatmul_int8_act

    def spy(x, xs, codes, *a, **kw):
        calls.append((tuple(x.shape), tuple(codes.shape), codes.dtype,
                      kw["bits"], kw.get("packed", False)))
        return real(x, xs, codes, *a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("qconv_dw ran in im2col mode")

    monkeypatch.setattr(qtorch_writer, "qmatmul_int8_act", spy)
    case.port("direct", packed_weights=True).build(bits=4)(case.x)
    n_direct = len(calls)
    calls.clear()
    monkeypatch.setattr(qtorch_writer, "qconv_dw_int8_act", refuse)
    case.port("im2col", packed_weights=True).build(bits=4)(case.x)
    assert len(calls) == n_direct + 2
    dense = [c for c in calls if c[1] in ((72, 8), (144, 16))]
    assert [c[:2] for c in dense] == [((3 * 14 * 14, 72), (72, 8)),
                                      ((3 * 7 * 7, 144), (144, 16))]
    assert all(c[2] == torch.int8 and c[3] == 4 and c[4] is False
               for c in dense)


def test_writer_validates_dw_mode(case):
    with pytest.raises(ValueError, match="dw_mode"):
        QTorchWriter(case.tg, DatatypeConfig(8, 8), device="cpu",
                     dw_mode="magic")
    with pytest.raises(ValueError, match="dw_mode"):
        WriterOptions(dw_mode="magic")


@pytest.mark.parametrize("shape", [(3, 3, 1, 8), (3, 3, 1, 16), (1, 3, 1, 5),
                                   (5, 5, 1, 3), (3, 3, 1, 4)])
def test_expand_dw_codes_equals_the_reference(shape):
    """(3, 3, 1, 4) is ``test_depthwise.py``'s block-diagonal case, drawn
    as it draws it."""
    if shape == (3, 3, 1, 4):
        codes = np.array(jax.random.randint(jax.random.PRNGKey(1), shape,
                                            -127, 128, jnp.int8))
    else:
        rng = np.random.default_rng(sum(shape))
        codes = rng.integers(-127, 128, shape).astype(np.int8)
    got = expand_dw_codes(torch.from_numpy(codes))
    want = np.asarray(j_expand(jnp.asarray(codes)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # block-diagonal: tap t's C x C block holds the tap's codes on its
    # diagonal and nothing else
    kh, kw, _, C = shape
    taps = codes.reshape(kh * kw, C)
    assert tuple(got.shape) == (kh * kw * C, C)
    for t in range(kh * kw):
        block = got.numpy()[t * C:(t + 1) * C]
        np.testing.assert_array_equal(np.diag(block), taps[t])
        assert np.count_nonzero(block - np.diag(np.diag(block))) == 0
    # the bits-bit view of the expansion is the expansion of the view
    for bits in (4, 2):
        np.testing.assert_array_equal(
            derive_view(got, bits).numpy(),
            expand_dw_codes(derive_view(torch.from_numpy(codes), bits)).numpy())


def test_expand_dw_codes_refuses_a_regular_conv():
    with pytest.raises(ValueError, match="depthwise"):
        expand_dw_codes(torch.zeros((3, 3, 2, 8), dtype=torch.int8))
