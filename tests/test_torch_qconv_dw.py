"""The port's fully-integer direct depthwise conv (its plain version, which
the CUDA kernel is held to on the card) against the reference oracle:
array_equal over bits {8,4,2} x packed x strides (1,1)/(2,2)/(1,2) x
SAME/VALID x bias/ReLU/out_code."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qconv_dw.ops import qconv_dw_int8_act as j_dw
from repro.kernels.qconv_dw.ref import out_spatial as j_out_spatial
from repro.kernels.qconv_dw.ref import qconv_dw_int8_act_ref as j_ref

from repro_torch.kernels import checks
from repro_torch.kernels.qconv_dw.ops import DW_PACK_ALIGN, qconv_dw_int8_act
from repro_torch.kernels.qconv_dw.ref import normalize_pads, out_spatial
from repro_torch.quant.pack import pack_rows


def _problem(seed=0, B=2, H=9, W=9, C=8, k=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (B, H, W, C)).astype(np.int8)
    codes = rng.integers(-127, 128, (k * k, C)).astype(np.int8)
    scale = (rng.random(C) * 0.05 + 0.01).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, 2.0 ** -6, codes, scale, bias


EPILOGUES = [  # (out_code, relu, with_bias, act_qt)
    (True, True, True, (4, -127, 127)),
    (True, False, False, (6, -128, 127)),
    (False, True, True, (10, -(2 ** 15), 2 ** 15 - 1)),
    (False, False, False, None),
]


@pytest.mark.parametrize("strides,pads", [((1, 1), "SAME"), ((2, 2), "SAME"),
                                          ((1, 2), "SAME"), ((1, 1), "VALID"),
                                          ((2, 2), "VALID"), ((1, 2), "VALID")])
@pytest.mark.parametrize("bits,packed", [(8, False), (4, False), (2, False),
                                         (4, True), (2, True)])
def test_plain_equals_reference_oracle(bits, packed, strides, pads):
    x, xs, codes, scale, bias = _problem(bits + 3 * packed, H=11, W=10, C=10)
    w = torch.from_numpy(codes)
    if packed:
        w = pack_rows(w, bits, align=DW_PACK_ALIGN)
    for out_code, relu, with_bias, aqt in EPILOGUES:
        b = bias if with_bias else None
        kw = dict(kh=3, kw=3, strides=strides, pads=pads, bits=bits,
                  relu=relu, act_qt=aqt, out_code=out_code)
        got = qconv_dw_int8_act(torch.from_numpy(x), xs, w,
                                torch.from_numpy(scale),
                                None if b is None else torch.from_numpy(b),
                                packed=packed, **kw)
        want = j_ref(jnp.asarray(x), xs, jnp.asarray(codes),
                     jnp.asarray(scale), None if b is None else jnp.asarray(b),
                     **kw)
        assert tuple(got.shape) == tuple(want.shape) == (
            2, *j_out_spatial(11, 10, 3, 3, strides, pads)[:2], 10)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [8, 2])
def test_plain_equals_reference_interpret_kernel_without_bias(bits):
    """Against the reference's interpret-mode Pallas kernel where that kernel
    agrees with its own oracle (bias-free: with a bias it fma-contracts the
    epilogue, which the port must not do)."""
    x, xs, codes, scale, _ = _problem(bits)
    kw = dict(kh=3, kw=3, strides=(1, 1), pads="SAME", bits=bits, relu=True,
              act_qt=(10, -(2 ** 15), 2 ** 15 - 1))
    want = j_dw(jnp.asarray(x), xs, jnp.asarray(codes), jnp.asarray(scale),
                None, interpret=True, use_kernel=True, **kw)
    got = qconv_dw_int8_act(torch.from_numpy(x), xs, torch.from_numpy(codes),
                            torch.from_numpy(scale), None, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pads", ["SAME", "VALID", [1, 0, 2, 1],
                                  ((0, 1), (2, 0))])
def test_padding_math_matches_reference(pads):
    for strides in ((1, 1), (2, 2), (1, 2)):
        j_pads = pads
        if isinstance(pads, list):
            j_pads = normalize_pads(pads)
        assert out_spatial(11, 10, 3, 3, strides, pads) == \
            j_out_spatial(11, 10, 3, 3, strides, j_pads)


def test_entry_point_checks_operands():
    x, xs, codes, scale, bias = _problem()
    args = (torch.from_numpy(x), xs)
    with pytest.raises(ValueError, match="do not cover"):
        qconv_dw_int8_act(*args, torch.zeros((1, 8), dtype=torch.uint8),
                          torch.from_numpy(scale), kh=3, kw=3, bits=4,
                          packed=True)
    with pytest.raises(ValueError, match="out_code needs"):
        qconv_dw_int8_act(*args, torch.from_numpy(codes),
                          torch.from_numpy(scale), kh=3, kw=3, out_code=True)


def test_sweep_runs_its_cases_on_the_cpu():
    res = checks.qconv_dw_sweep("cpu", shapes=[(1, 5, 6, 3)],
                                strides=[(2, 2)], pads=["SAME"])
    assert res["cases"] == 5 * 3 * 2 * 2
    assert res["failures"] == [] and res["max_abs_err"] == 0.0


@pytest.mark.parametrize("window", checks.DW_WINDOWS)
def test_sweep_covers_every_window(window):
    """Each window the card's sweep runs, its 2x2 under VALID only."""
    res = checks.qconv_dw_float_sweep("cpu", shapes=[(1, 6, 7, 4)],
                                      strides=[(1, 2)], windows=[window])
    assert res["cases"] == len(window[2] or checks.DW_PADS) * 5 * 3 * 2 * 2
    assert res["failures"] == [] and res["max_abs_err"] == 0.0


@pytest.mark.parametrize("kh,kw,pads", [(1, 3, "SAME"), (1, 3, "VALID"),
                                        (5, 5, "SAME"), (5, 5, "VALID"),
                                        (2, 2, "VALID")])
@pytest.mark.parametrize("bits,packed", [(8, False), (4, False), (2, False),
                                         (4, True), (2, True)])
def test_plain_equals_reference_oracle_other_windows(kh, kw, pads, bits,
                                                     packed):
    """The windows that run the kernel's generic instance on the card, in
    the plain version it is held to there, against the reference oracle."""
    x, xs, _, scale, bias = _problem(bits + kh + packed, H=11, W=10, C=8)
    codes = np.random.default_rng(kh * kw + bits).integers(
        -127, 128, (kh * kw, 8)).astype(np.int8)
    w = torch.from_numpy(codes)
    if packed:
        w = pack_rows(w, bits, align=DW_PACK_ALIGN)
    for out_code, relu, with_bias, aqt in EPILOGUES:
        b = bias if with_bias else None
        kw_ = dict(kh=kh, kw=kw, strides=(1, 2), pads=pads, bits=bits,
                   relu=relu, act_qt=aqt, out_code=out_code)
        got = qconv_dw_int8_act(torch.from_numpy(x), xs, w,
                                torch.from_numpy(scale),
                                None if b is None else torch.from_numpy(b),
                                packed=packed, **kw_)
        want = j_ref(jnp.asarray(x), xs, jnp.asarray(codes),
                     jnp.asarray(scale), None if b is None else jnp.asarray(b),
                     **kw_)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
