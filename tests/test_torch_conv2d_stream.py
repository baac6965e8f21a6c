"""The port's streaming line-buffer convolution against the reference: its
plain version against the reference's Pallas kernel (interpret mode) and its
oracle over the reference's test shapes at atol = rtol = 1e-4, in f32 and in
the mixed bf16/f32 dtypes ``compose_adaptive`` produces; against the port's
model conv; the stride/pads contract; and, on the card, the CUDA kernel
against the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_stream.ops import conv2d_stream as j_stream
from repro.kernels.conv2d_stream.ref import conv2d_ref as j_ref

from repro_torch.core.ir import Graph, Node, TensorInfo
from repro_torch.core.writers.stream_writer import StreamWriter
from repro_torch.kernels import checks
from repro_torch.kernels.conv2d_stream.ops import (conv2d_stream,
                                                   require_stream_window)
from repro_torch.kernels.conv2d_stream.ref import (conv2d_ref,
                                                   conv2d_stream_plain)
from repro_torch.models.cnn import conv2d as t_model_conv

# the reference's test shapes (tests/test_kernels.py): B, H, W, Cin, Cout, k
SHAPES = [(2, 28, 28, 1, 16, 3), (1, 14, 14, 16, 32, 3), (3, 8, 8, 4, 8, 5),
          (2, 7, 7, 32, 16, 3), (1, 28, 28, 3, 8, 1)]
# compose_adaptive's (x, w) dtypes: bf16 input and weights into the first
# conv, an f32 stream (after BatchNormalization promotes) into later ones
MIXED = [("bfloat16", "bfloat16"), ("float32", "bfloat16"),
         ("bfloat16", "float32")]


def _inputs(B, H, W, cin, cout, k, seed=0):
    rng = np.random.default_rng(seed + B + H)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.to(torch.float32).numpy()


@pytest.mark.parametrize("B,H,W,cin,cout,k", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, H, W, cin, cout, k):
    x, w, b = _inputs(B, H, W, cin, cout, k)
    got = conv2d_stream_plain(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, cout)
    for want in (j_stream(x, w, b), j_ref(x, w, b)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4,
                                   rtol=1e-4)
    # the oracle itself, and the dispatcher on a CPU tensor
    np.testing.assert_allclose(
        conv2d_ref(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b)).numpy(), _np(j_ref(x, w, b)),
        atol=1e-4, rtol=1e-4)
    assert torch.equal(conv2d_stream(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b)), got)


@pytest.mark.parametrize("xdt,wdt", MIXED)
@pytest.mark.parametrize("B,H,W,cin,cout,k", SHAPES)
def test_plain_matches_reference_kernel_in_mixed_dtypes(B, H, W, cin, cout,
                                                        k, xdt, wdt):
    """Both sides cast to f32 inside and round once to x's dtype at the end:
    a bf16 output may differ by one bf16 ulp (2^-7 relative) where the f32
    sums differ in their last bits; an f32 output stays within 1e-4."""
    x, w, b = _inputs(B, H, W, cin, cout, k, seed=7)
    jx, jw = jnp.asarray(x, xdt), jnp.asarray(w, wdt)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    tw = torch.from_numpy(w).to(getattr(torch, wdt))
    want = j_stream(jx, jw, jnp.asarray(b))
    got = conv2d_stream_plain(tx, tw, torch.from_numpy(b))
    assert str(want.dtype) == xdt and got.dtype == getattr(torch, xdt)
    rtol = 2.0 ** -7 if xdt == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=rtol)
    # jnp's and torch's bf16 x f32 -> f32 promotion agree
    assert str(jnp.promote_types(jnp.bfloat16, jnp.float32)) == "float32"
    assert torch.promote_types(torch.bfloat16, torch.float32) == torch.float32


def test_plain_matches_model_conv():
    """The stream conv has the CNN model's conv semantics (mirror of the
    reference's test_conv2d_stream_matches_model_conv)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 28, 28, 1)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 1, 16)) * 0.3).astype(
        np.float32))
    b = torch.zeros(16)
    np.testing.assert_allclose(conv2d_stream(x, w, b).numpy(),
                               t_model_conv(x, w, b).numpy(), atol=1e-4)


@pytest.mark.parametrize("k,strides,pads,ok", [
    (3, (1, 1), "SAME", True), (1, (1, 1), "VALID", True),
    (1, (1, 1), "SAME", True), (3, (1, 1), [1, 1, 1, 1], True),
    (3, (2, 2), "SAME", False), (3, (1, 1), "VALID", False),
    (2, (1, 1), "SAME", False), (3, (1, 1), [0, 1, 2, 1], False)])
def test_stream_window_contract(k, strides, pads, ok):
    """The stream conv takes no strides and pads (neither does the
    reference's): a node asking for others is refused.  An even window's
    XLA SAME pads (0, 1) differ from the kernel's (1, 0)."""
    if ok:
        require_stream_window("c", k, k, strides, pads)
    else:
        with pytest.raises(ValueError, match="stream conv"):
            require_stream_window("c", k, k, strides, pads)


def test_stream_writer_refuses_a_strided_conv():
    rng = np.random.default_rng(0)
    inits = {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)}
    g = Graph("strided", [Node("Conv", "c", ["input", "w", "b"], ["out"],
                               {"pads": "SAME", "strides": [2, 2]})],
              [TensorInfo("input", ("N", 8, 8, 2))], ["out"], inits)
    run = StreamWriter(g, device="cpu").build()
    with pytest.raises(ValueError, match="stride 1 only"):
        run(rng.random((1, 8, 8, 2), np.float32))


def test_sweep_runs_its_cases_on_the_cpu():
    res = checks.conv2d_stream_sweep("cpu", shapes=[(1, 5, 6, 3, 7, 3),
                                                   (2, 4, 3, 2, 5, 1)])
    assert res["cases"] == 2 * 4 * 2
    assert res["failures"] == [] and res["max_abs_err"] == 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_version(cuda):
    from repro_torch.kernels.conv2d_stream.ops import conv2d_stream_cuda
    before = conv2d_stream_cuda.launches
    res = checks.conv2d_stream_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_tol_frac"] <= 1.0
    assert conv2d_stream_cuda.launches - before == res["cases"]
