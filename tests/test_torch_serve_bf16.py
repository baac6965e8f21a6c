"""``AccelServer`` with bf16 tensors, on the CPU.

numpy has no bfloat16, and the port cannot count on ``ml_dtypes`` (which
the reference's ``np.asarray`` returns), so the port's host copies
(``runtime.serve._host``, ``device.to_numpy``) upcast bf16 to f32, which is
exact.  A bf16 output is served as its f32 values; a bf16 request input
reaches the executable as an f32 column that casts back to the same bf16
values; and, unlike the reference (whose ``ml_dtypes`` arrays are not
``np.floating``), a non-finite bf16 output resolves to ``NumericalFault``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.serve import AccelServer as JAccelServer

from repro_torch.device import to_numpy
from repro_torch.runtime.serve import AccelServer, NumericalFault


def _rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 3)).astype(
        np.float32)


def _serve(srv, reqs, threaded):
    if threaded:
        with srv:
            tks = [srv.submit(r) for r in reqs]
            return [t.result(timeout=10) for t in tks]
    return [srv(r) for r in reqs]


@pytest.mark.parametrize("threaded", [False, True])
def test_bf16_output_is_served_as_its_f32_values(threaded):
    """An executable returning a bf16 tensor: each request gets the f32
    upcast of its rows, equal to what the reference serves (its
    ``ml_dtypes`` bfloat16 rows, upcast)."""
    def exe(x):
        return (torch.as_tensor(x) * 3.0).to(torch.bfloat16)

    def j_exe(x):
        return (jnp.asarray(x) * 3.0).astype(jnp.bfloat16)

    reqs = [_rows(1 + i % 3, i) for i in range(6)]
    outs = _serve(AccelServer(exe, max_batch=4, max_wait=0.001), reqs,
                  threaded)
    j_outs = _serve(JAccelServer(j_exe, max_batch=4, max_wait=0.001), reqs,
                    threaded)
    for r, o, jo in zip(reqs, outs, j_outs):
        want = (torch.from_numpy(r) * 3.0).to(torch.bfloat16).float().numpy()
        assert o.dtype == np.float32 and o.shape == r.shape
        np.testing.assert_array_equal(o, want)
        np.testing.assert_array_equal(o, np.asarray(jo).astype(np.float32))


@pytest.mark.parametrize("threaded", [False, True])
def test_bf16_request_input_is_served(threaded):
    """A bf16 request tensor reaches the executable as an f32 column; its
    cast back to bf16 is the request's own values."""
    seen = []

    def exe(x):
        seen.append(x.dtype)
        xb = torch.as_tensor(x).to(torch.bfloat16)
        return xb * 2

    reqs = [torch.from_numpy(_rows(2, i)).to(torch.bfloat16)
            for i in range(4)]
    outs = _serve(AccelServer(exe, max_batch=4, max_wait=0.001), reqs,
                  threaded)
    assert seen and all(d == np.float32 for d in seen)
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, (r * 2).float().numpy())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("threaded", [False, True])
def test_non_finite_bf16_output_is_a_numerical_fault(bad, threaded):
    """Rows whose marker is 13 come back non-finite in bf16: that request
    resolves to ``NumericalFault`` and its batch neighbour is served."""
    def exe(x):
        out = torch.as_tensor(x).to(torch.bfloat16) * 2
        out[torch.as_tensor(x)[:, 0] == 13.0] = bad
        return out

    srv = AccelServer(exe, max_batch=8, max_wait=0.05)
    bad_req = np.full((1, 3), 13.0, np.float32)
    good_req = np.full((1, 3), 2.0, np.float32)
    if threaded:
        with srv:
            tb, tg = srv.submit(bad_req), srv.submit(good_req)
            assert float(tg.result(timeout=10)[0, 0]) == 4.0
            with pytest.raises(NumericalFault):
                tb.result(timeout=10)
    else:
        with pytest.raises(NumericalFault):
            srv(bad_req)
        assert float(srv(good_req)[0, 0]) == 4.0
    assert srv.stats()["numerical_faults"] == 1


def test_to_numpy_upcasts_every_bf16_value_exactly():
    """All 65536 bf16 bit patterns: the f32 copy has the same value (NaNs
    stay NaN), as the upcast of the bits would give."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    b = bits.view(torch.bfloat16)
    got = to_numpy(b)
    assert got.dtype == np.float32
    want = (bits.to(torch.int32) << 16).view(torch.float32).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert to_numpy(torch.ones(3)).dtype == np.float32
    assert to_numpy(torch.ones(3, dtype=torch.int8)).dtype == np.int8
