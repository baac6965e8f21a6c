"""The qmatmul half of the reference's ``tests/test_kernels.py`` on the port:
the dequant matmul ``qmatmul`` (its plain version on CPU tensors, which the
CUDA kernel's bf16-in mode is held to on the card) against the reference's
``qmatmul`` (its interpret-mode Pallas kernel on the CPU) and against the
port's oracle ``qmatmul_ref``, each within one bf16 ulp of max|y|
(``max|y| * 2^-7``, the reference's own tolerance: the kernel computes
``(x . codes) * s``, the oracle ``x . (codes * s)``, and a bf16 output
rounds once more); the ``min(M, K, N) < 8`` branch exactly."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul.kernel import build_call as j_build_call
from repro.kernels.qmatmul.ops import qmatmul as j_qmatmul
from repro.kernels.qmatmul.ref import qmatmul_ref as j_qmatmul_ref

from repro_torch.kernels import checks
from repro_torch.kernels.qmatmul.ops import qmatmul, qmatmul_plain
from repro_torch.kernels.qmatmul.ref import qmatmul_ref
from repro_torch.quant.ptq import derive_view


def _quantize(w):
    s = (np.maximum(np.abs(w).max(0), 1e-8) / 127.0).astype(np.float32)
    codes = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return codes, s


def _operands(shape_x, K, N, seed, dtype=torch.bfloat16):
    """x (numpy f32 rounded to ``dtype``) as a torch tensor and as the
    reference's array of the same dtype, with codes and scale."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape_x).astype(np.float32))
    x = x.to(dtype)
    codes, s = _quantize(rng.standard_normal((K, N)).astype(np.float32))
    jx = jnp.asarray(x.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return x, jx, codes, s


def _f32(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.to(torch.float32).numpy()
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 512, 384),
                                   (128, 1024, 256), (384, 256, 128)])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_qmatmul_shapes_bits(M, K, N, bits):
    x, jx, codes, s = _operands((M, K), K, N, M * K + N + bits)
    y = qmatmul(x, torch.from_numpy(codes), torch.from_numpy(s), bits=bits)
    y_ref = qmatmul_ref(x, torch.from_numpy(codes), torch.from_numpy(s), bits)
    y_j = j_qmatmul(jx, jnp.asarray(codes), jnp.asarray(s), bits=bits)
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    # bf16 output: <= 1 ulp of the largest magnitude
    tol = float(np.abs(_f32(y_ref)).max()) * 2 ** -7
    np.testing.assert_allclose(_f32(y), _f32(y_ref), atol=tol, rtol=0)
    np.testing.assert_allclose(_f32(y), _f32(y_j), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_dtypes(dtype):
    x, jx, codes, s = _operands((128, 256), 256, 128, 0, dtype)
    y = qmatmul(x, torch.from_numpy(codes), torch.from_numpy(s), bits=8)
    assert y.dtype == dtype and y.shape == (128, 128)
    y_j = j_qmatmul(jx, jnp.asarray(codes), jnp.asarray(s), bits=8)
    assert np.dtype(y_j.dtype) == np.dtype(
        ml_dtypes.bfloat16 if dtype == torch.bfloat16 else np.float32)
    tol = float(np.abs(_f32(y_j)).max()) * 2 ** -7
    np.testing.assert_allclose(_f32(y), _f32(y_j), atol=tol, rtol=0)


def test_qmatmul_batched_and_ragged():
    x, jx, codes, s = _operands((2, 3, 100), 100, 50, 1)
    c, sc = torch.from_numpy(codes), torch.from_numpy(s)
    y = qmatmul(x, c, sc, bits=8)
    assert y.shape == (2, 3, 50) and y.dtype == torch.bfloat16
    y_r = qmatmul_ref(x.reshape(6, 100), c, sc, 8).reshape(2, 3, 50)
    np.testing.assert_allclose(_f32(y), _f32(y_r), atol=1.0)
    # 6 rows: both packages take their oracle
    y_j = j_qmatmul(jx, jnp.asarray(codes), jnp.asarray(s), bits=8)
    tol = float(np.abs(_f32(y_j)).max()) * 2 ** -7
    np.testing.assert_allclose(_f32(y), _f32(y_j), atol=tol, rtol=0)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_qmatmul_plain_against_the_reference_interpret_kernel(bits):
    """One small case against the reference's Pallas call itself
    (``interpret=True``, as its own tests run it), on x rounded to bf16 as
    its ``qmatmul`` feeds it, f32 out: the same f32 dot of the bf16 x with
    the truncated codes, scaled once, so within f32 summation order."""
    x, _, codes, s = _operands((128, 128), 128, 128, 40 + bits)
    call = j_build_call(128, 128, 128, bits=bits, int8_act=False, bm=128,
                        bn=128, bk=128, out_dtype=jnp.float32, interpret=True)
    xb = jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16)
    want = np.asarray(call(xb, jnp.asarray(codes),
                           jnp.asarray(s).reshape(1, -1)))
    got = qmatmul(x.to(torch.float32), torch.from_numpy(codes),
                  torch.from_numpy(s), bits=bits).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("M,K,N", [(6, 100, 50), (64, 7, 32), (16, 40, 3)])
def test_small_dims_take_the_oracle_with_no_bf16_rounding(M, K, N):
    """Where ``min(M, K, N) < 8`` the f32 activations reach the oracle as
    they are (the reference skips its bf16 cast there too): exactly the
    port's ``qmatmul_ref``, which differs from the bf16-rounded product."""
    x, _, codes, s = _operands((M, K), K, N, 7, torch.float32)
    c, sc = torch.from_numpy(codes), torch.from_numpy(s)
    want = qmatmul_ref(x, c, sc, 4, out_dtype=torch.float32)
    for fn in (qmatmul, qmatmul_plain):
        got = fn(x, c, sc, bits=4)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    rounded = qmatmul_ref(x.to(torch.bfloat16).to(torch.float32), c, sc, 4,
                          out_dtype=torch.float32)
    assert not torch.equal(want, rounded)
    w = derive_view(c, 4).to(torch.float64) * sc.to(torch.float64)
    np.testing.assert_allclose(want.numpy(), (x.double() @ w).numpy(),
                               rtol=1e-5, atol=1e-6)
    y_j = j_qmatmul_ref(jnp.asarray(x.numpy()), jnp.asarray(codes),
                        jnp.asarray(s), 4, out_dtype=jnp.float32)
    np.testing.assert_allclose(want.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-6 * float(np.abs(y_j).max()))


def test_qmatmul_refuses_mismatched_codes():
    with pytest.raises(ValueError, match="reduction dim"):
        qmatmul(torch.zeros((8, 16)), torch.zeros((8, 16), dtype=torch.int8),
                torch.ones(16))


def test_qmatmul_sweep_runs_its_cases_on_the_cpu():
    """The kernel-vs-plain sweep the card runs, at its shapes: on CPU
    tensors both sides are the plain version."""
    res = checks.qmatmul_sweep("cpu")
    assert res["cases"] == len(checks.QMATMUL_SHAPES) * 3 * 2
    assert res["failures"] == [] and res["max_abs_err"] == 0.0
