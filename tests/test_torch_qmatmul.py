"""The port's fully-integer matmul (its plain version, which the CUDA kernel
is held to on the card) against the reference: ``qmatmul_int8_act`` on CPU
tensors is array_equal to the reference oracle over bits {8,4,2} x packed x
out_code x ReLU x bias at shapes with M < 8, K = 9 and K = 1568, and to the
reference's interpret-mode Pallas kernel; im2col matches too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.writers.qjax_writer import im2col as j_im2col
from repro.kernels.qmatmul.ops import qmatmul_int8_act as j_qmm
from repro.kernels.qmatmul.ref import qmatmul_int8_act_ref as j_ref
from repro.quant.pack import pack_rows as j_pack_rows

from repro_torch.core.writers.qtorch_writer import im2col as t_im2col
from repro_torch.kernels import checks
from repro_torch.kernels.qmatmul.ops import (SKINNY_CLUSTER, SKINNY_MAX_M,
                                             SKINNY_MIN_K, pick_tiles,
                                             qmatmul_int8_act)
from repro_torch.kernels.qmatmul.ref import exact_in_f32, int_dot
from repro_torch.quant.pack import pack_rows


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xs = 2.0 ** -4
    xc = np.clip(np.round(x / xs), -128, 127).astype(np.int8)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.3
    s = (np.maximum(np.abs(w).max(0), 1e-8) / 127.0).astype(np.float32)
    wc = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return xc, xs, wc, s, b


def _port(xc, xs, wc, s, b, bits, packed, **kw):
    w = torch.from_numpy(wc)
    if packed:
        w = pack_rows(w, bits)
    return qmatmul_int8_act(torch.from_numpy(xc), xs, w, torch.from_numpy(s),
                            None if b is None else torch.from_numpy(b),
                            bits=bits, packed=packed, **kw)


WEIGHTS = [(8, False), (4, False), (2, False), (4, True), (2, True)]
EPILOGUES = [  # (out_code, relu, with_bias, act_qt)
    (True, True, True, (9, -128, 127)),
    (True, False, False, (7, -128, 127)),
    (False, True, True, (10, -(2 ** 15), 2 ** 15 - 1)),
    (False, False, True, None),
]


@pytest.mark.parametrize("M,K,N", [(1, 9, 8), (7, 8, 16), (5, 1568, 10),
                                   (33, 1100, 130)])
@pytest.mark.parametrize("bits,packed", WEIGHTS)
def test_plain_equals_reference_oracle(M, K, N, bits, packed):
    xc, xs, wc, s, b = _inputs(M, K, N, seed=M + K + bits)
    for out_code, relu, with_bias, aqt in EPILOGUES:
        bias = b if with_bias else None
        got = _port(xc, xs, wc, s, bias, bits, packed, relu=relu, act_qt=aqt,
                    out_code=out_code)
        want = j_ref(jnp.asarray(xc), xs, jnp.asarray(wc), jnp.asarray(s), bits,
                     bias=None if bias is None else jnp.asarray(bias),
                     relu=relu, act_qt=aqt, out_code=out_code,
                     out_dtype=jnp.float32)
        assert got.dtype == (torch.int8 if out_code else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M", [1, 16, 63, 64, 65])
@pytest.mark.parametrize("K", [8, 1568, 4100])
@pytest.mark.parametrize("bits,packed", WEIGHTS)
def test_plain_equals_reference_oracle_across_the_mapping_switch(M, K, bits,
                                                                 packed):
    """The shapes on both sides of the kernel's switch between its tiled and
    skinny mappings, where the card holds the kernel to this plain
    version."""
    xc, xs, wc, s, b = _inputs(M, K, 10, seed=M + K + bits + packed)
    aqt = (9, -128, 127)
    got = _port(xc, xs, wc, s, b, bits, packed, relu=True, act_qt=aqt,
                out_code=True)
    want = j_ref(jnp.asarray(xc), xs, jnp.asarray(wc), jnp.asarray(s), bits,
                 bias=jnp.asarray(b), relu=True, act_qt=aqt, out_code=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("float_mode", [False, True])
@pytest.mark.parametrize("shape", checks.QGEMM_PATH_SHAPES)
def test_pick_tiles_maps_each_path_shape(shape, float_mode):
    """The classifier FC (M=8, K=1568) takes the skinny mapping, every other
    call of the two CNNs the tiled one, with BN fitted to N."""
    M, K, N = shape
    t = pick_tiles(M, K, N, float_mode=float_mode)
    if shape == (8, 1568, 10):
        assert (t.mapping, t.bm, t.bn, t.splits) == ("skinny", 16, 16,
                                                     SKINNY_CLUSTER)
    else:
        assert t.mapping == "tiled"
        assert t.bn == {8: 8, 16: 16, 32: 32}[N]
        assert t.bk == (min(32, max(8, 1 << (K - 1).bit_length()))
                        if float_mode else 32)


@pytest.mark.parametrize("float_mode", [False, True])
@pytest.mark.parametrize("shape", checks.QGEMM_SHAPES)
def test_pick_tiles_covers_the_call(shape, float_mode):
    """Every choice is one the kernels take and its grid covers M, K and
    N: the skinny mapping holds M in one padded tile, N in clusters of bn
    columns and splits K over each cluster's CTAs, every one of which has
    a step when K >= SKINNY_MIN_K; the tiled one's grid of bm x bn tiles
    covers M x N."""
    M, K, N = shape
    t = pick_tiles(M, K, N, float_mode=float_mode)
    skinny = M <= SKINNY_MAX_M and K >= SKINNY_MIN_K
    assert t.mapping == ("skinny" if skinny else "tiled")
    if skinny:
        assert t.bn in (8, 16, 32) and t.bk == 32
        assert M <= t.bm <= SKINNY_MAX_M and t.bm % 16 == 0
        # the launch grid: (the cluster's CTAs, clusters of bn columns)
        assert t.splits == SKINNY_CLUSTER and K >= 32 * t.splits
        gn = -(-N // t.bn)
        assert gn * t.bn >= N > (gn - 1) * t.bn
    else:
        # the launch grid: (tiles along M, tiles along N)
        assert t.bn in (8, 16, 32, 64) and t.splits == 1
        gm, gn = -(-M // t.bm), -(-N // t.bn)
        assert gm * t.bm >= M > (gm - 1) * t.bm
        assert gn * t.bn >= N > (gn - 1) * t.bn
        if float_mode:
            assert t.bm * t.bn == 512 and t.bk in (8, 16, 32)
            assert t.bk >= min(K, 32)
        else:
            assert t.bm in (16, 32, 64) and t.bk == 32


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (64, 200, 48),
                                   (130, 130, 130)])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_plain_equals_reference_interpret_kernel(M, K, N, bits):
    """The reference's own Pallas kernel (interpret mode) at the shapes its
    bit-exactness tests use — codes and floats out, ReLU, bias."""
    xc, xs, wc, s, b = _inputs(M, K, N, seed=bits)
    aqt = (10, -128, 127)
    for out_code in (False, True):
        want = j_qmm(jnp.asarray(xc), xs, jnp.asarray(wc), jnp.asarray(s),
                     jnp.asarray(b), bits=bits, relu=True, act_qt=aqt,
                     out_code=out_code, interpret=True, use_kernel=True,
                     out_dtype=jnp.float32)
        got = _port(xc, xs, wc, s, b, bits, False, relu=True, act_qt=aqt,
                    out_code=out_code)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [4, 2])
def test_packed_plain_equals_reference_packed_interpret_kernel(bits):
    xc, xs, wc, s, b = _inputs(64, 200, 48, seed=bits + 10)
    want = j_qmm(jnp.asarray(xc), xs, j_pack_rows(jnp.asarray(wc), bits),
                 jnp.asarray(s), jnp.asarray(b), bits=bits, relu=True,
                 act_qt=(9, -128, 127), out_code=True, packed=True,
                 interpret=True, use_kernel=True)
    got = _port(xc, xs, wc, s, b, bits, True, relu=True,
                act_qt=(9, -128, 127), out_code=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [8, 1568, 4096])
def test_int_dot_exact_both_branches(K):
    rng = np.random.default_rng(K)
    x = rng.integers(-128, 128, (4, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, 3)).astype(np.int8)
    want = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32)
    got = int_dot(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert exact_in_f32(K) == (K * 128 * 127 <= 2 ** 24)


@pytest.mark.parametrize("strides,pads", [((1, 1), "SAME"), ((2, 2), "SAME"),
                                          ((1, 2), "VALID"), ((1, 1),
                                                              [1, 0, 2, 1])])
def test_im2col_matches_reference(strides, pads):
    x = np.random.default_rng(0).integers(-128, 128, (2, 9, 8, 3)).astype(
        np.int8)
    jp, joh, jow = j_im2col(jnp.asarray(x), 3, 3, strides,
                            pads if isinstance(pads, str)
                            else ((pads[0], pads[2]), (pads[1], pads[3])))
    tp, toh, tow = t_im2col(torch.from_numpy(x), 3, 3, strides, pads)
    assert (toh, tow) == (joh, jow)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_entry_point_checks_operands():
    xc, xs, wc, s, b = _inputs(4, 9, 8)
    with pytest.raises(ValueError, match="out_code needs"):
        _port(xc, xs, wc, s, b, 8, False, out_code=True, act_qt=None)
    with pytest.raises(ValueError, match="does not fit int8"):
        _port(xc, xs, wc, s, b, 8, False, out_code=True, act_qt=(4, -129, 127))
    with pytest.raises(ValueError, match="per-row x_scale has 3"):
        qmatmul_int8_act(torch.from_numpy(xc), torch.ones(3), torch.from_numpy(
            wc), torch.from_numpy(s), bits=8)
    with pytest.raises(ValueError, match="do not cover"):
        qmatmul_int8_act(torch.from_numpy(xc), xs, torch.zeros(
            (2, 8), dtype=torch.uint8), torch.from_numpy(s), bits=4,
            packed=True)


def test_sweep_runs_its_cases_on_the_cpu():
    """The kernel-vs-plain sweep that the card runs, at tiny shapes: on CPU
    tensors it exercises the sweep itself (both sides are the plain path)."""
    res = checks.qgemm_sweep("cpu", shapes=[(3, 9, 10), (17, 40, 8)])
    assert res["cases"] == 2 * 5 * 3 * 2 * 2
    assert res["failures"] == [] and res["max_abs_err"] == 0.0
