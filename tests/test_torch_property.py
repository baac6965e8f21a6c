"""``tests/test_property.py`` on the port: hypothesis property tests of the
system's invariants (sub-byte packing round trips, split-row packing,
fixed-point error bounds and monotonicity, nested-view truncation, the data
stream, padded-vocab cross entropy, topological order).  Each example feeds
the same numpy input to the reference and to the port on the CPU: integer
results are held bit for bit to the reference's; float results within the
property's own bound, and the loss within 1e-6 relative of the reference's.
The data stream case uses the port's own ``data/tokens.py`` (a counter-based
draw of its own, not the reference's threefry bits) and holds its shape of
data to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import ir as j_ir  # noqa: E402
from repro.data.tokens import DataConfig as JDataConfig  # noqa: E402
from repro.data.tokens import batch_at as j_batch_at  # noqa: E402
from repro.models.common import cross_entropy as j_cross_entropy  # noqa: E402
from repro.quant.fixedpoint import quantize as j_quantize  # noqa: E402
from repro.quant.pack import pack_int2 as j_pack_int2  # noqa: E402
from repro.quant.pack import pack_int4 as j_pack_int4  # noqa: E402
from repro.quant.pack import pack_rows as j_pack_rows  # noqa: E402
from repro.quant.ptq import derive_view as j_derive_view  # noqa: E402
from repro.quant.qtypes import fixed_for_range as j_ffr  # noqa: E402

from repro_torch.core import ir as t_ir  # noqa: E402
from repro_torch.data.tokens import (DataConfig, TokenStream,  # noqa: E402
                                     batch_at, host_batch_at)
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.quant.fixedpoint import dequantize, quantize  # noqa: E402
from repro_torch.quant.pack import (pack_int2, pack_int4,  # noqa: E402
                                    pack_rows, unpack_int2, unpack_int4,
                                    unpack_rows)
from repro_torch.quant.ptq import derive_view  # noqa: E402
from repro_torch.quant.qtypes import fixed_for_range  # noqa: E402

SETTINGS = dict(max_examples=25, deadline=None)


@given(st.lists(st.integers(-8, 7), min_size=2, max_size=64).filter(
    lambda v: len(v) % 2 == 0))
@settings(**SETTINGS)
def test_pack4_roundtrip(codes):
    c = torch.tensor(codes, dtype=torch.int8).reshape(1, -1)
    p = pack_int4(c)
    assert torch.equal(unpack_int4(p), c)
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(j_pack_int4(jnp.array(codes, jnp.int8)
                                          .reshape(1, -1))))


@given(st.lists(st.integers(-2, 1), min_size=4, max_size=64).filter(
    lambda v: len(v) % 4 == 0))
@settings(**SETTINGS)
def test_pack2_roundtrip(codes):
    c = torch.tensor(codes, dtype=torch.int8).reshape(1, -1)
    p = pack_int2(c)
    assert torch.equal(unpack_int2(p), c)
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(j_pack_int2(jnp.array(codes, jnp.int8)
                                          .reshape(1, -1))))


@given(st.integers(1, 300), st.integers(1, 8), st.sampled_from([4, 2]),
       st.integers(0, 2 ** 31 - 1))
@settings(**SETTINGS)
def test_pack_rows_roundtrip_property(k, n, bits, seed):
    """For ANY int8 code matrix ``unpack(pack(c))`` is the nested view on
    the original rows and zero on the padding rows; the packed bytes are
    the reference's."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-127, 128, (k, n)).astype(np.int8)
    p = pack_rows(torch.from_numpy(c), bits)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j_pack_rows(c, bits)))
    up = unpack_rows(p, bits).numpy()
    assert up.shape[0] % 128 == 0 and up.shape[0] >= k
    np.testing.assert_array_equal(
        up[:k], derive_view(torch.from_numpy(c), bits).numpy())
    assert not up[k:].any()


@given(st.floats(0.01, 100.0), st.sampled_from([4, 8, 16]))
@settings(**SETTINGS)
def test_fixed_for_range_quantization_error_bound(max_abs, bits):
    qt = fixed_for_range(bits, max_abs)
    assert (qt.bits, qt.frac) == (j_ffr(bits, max_abs).bits,
                                  j_ffr(bits, max_abs).frac)
    xs = torch.linspace(-max_abs, max_abs, 33)
    deq = dequantize(quantize(xs, qt), qt)
    assert float((deq - xs).abs().max()) <= qt.scale * 1.001
    np.testing.assert_array_equal(
        quantize(xs, qt).numpy(),
        np.asarray(j_quantize(jnp.asarray(xs.numpy()), j_ffr(bits, max_abs))))


@given(st.integers(-127, 127), st.sampled_from([2, 4, 8]))
@settings(**SETTINGS)
def test_derive_view_idempotent_and_bounded(code, bits):
    c = torch.tensor([code], dtype=torch.int8)
    v = derive_view(c, bits)
    assert torch.equal(derive_view(v, bits), v)
    assert abs(int(v[0]) - code) <= (1 << (8 - bits))
    assert int(v[0]) == int(j_derive_view(jnp.array([code], jnp.int8),
                                          bits)[0])


@given(st.integers(0, 10_000), st.integers(0, 10_000))
@settings(**SETTINGS)
def test_data_stream_deterministic_and_step_unique(s1, s2):
    """The port's stream: a pure function of (seed, step), distinct steps
    distinct, with the reference's shape of data (shapes, dtype, tokens in
    [1, V-1], every 4th position repeating the token three before it,
    labels the tokens shifted by one)."""
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=2, seed=1)
    b1 = batch_at(cfg, s1, "cpu")
    b1b = batch_at(cfg, s1, "cpu")
    assert torch.equal(b1["tokens"], b1b["tokens"])
    if s1 != s2:
        b2 = batch_at(cfg, s2, "cpu")
        assert not torch.equal(b1["tokens"], b2["tokens"])
    ref = j_batch_at(JDataConfig(vocab=128, seq_len=16, global_batch=2,
                                 seed=1), s1)
    toks = b1["tokens"].numpy()
    assert toks.shape == np.asarray(ref["tokens"]).shape
    assert toks.dtype == np.asarray(ref["tokens"]).dtype
    assert toks.min() >= 1 and toks.max() <= 127
    full = np.concatenate([toks, b1["labels"].numpy()[:, -1:]], axis=1)
    np.testing.assert_array_equal(b1["labels"].numpy(), full[:, 1:])
    for t in range(4, full.shape[1], 4):
        np.testing.assert_array_equal(full[:, t], full[:, t - 3])
    np.testing.assert_array_equal(host_batch_at(cfg, s1)["tokens"], toks)


@given(st.integers(2, 64))
@settings(**SETTINGS)
def test_cross_entropy_ignores_padded_vocab(vocab):
    """Logits in the padded region do not move the loss, which equals the
    reference's on the same logits."""
    pad = 16
    key = jax.random.PRNGKey(vocab)
    logits = np.array(jax.random.normal(key, (2, 3, vocab + pad)))
    labels = np.array(jax.random.randint(key, (2, 3), 0, vocab))
    l1 = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                       vocab)
    noised = logits.copy()
    noised[..., vocab:] += 100.0
    l2 = cross_entropy(torch.from_numpy(noised), torch.from_numpy(labels),
                       vocab)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(float(l1), float(j_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), vocab)), rtol=1e-6)


@given(st.integers(1, 6), st.integers(1, 6))
@settings(**SETTINGS)
def test_ir_random_dag_topo_valid(n_gemm, n_relu):
    def chain(ir):
        nodes, prev, inits = [], "input", {}
        for i in range(n_gemm):
            w = f"w{i}"
            inits[w] = np.zeros((4, 4), np.float32)
            nodes.append(ir.Node("MatMul", f"g{i}", [prev, w], [f"t{i}"]))
            prev = f"t{i}"
            for j in range(min(n_relu, 2)):
                nodes.append(ir.Node("Relu", f"r{i}_{j}", [prev],
                                     [f"t{i}_{j}"]))
                prev = f"t{i}_{j}"
        return ir.Graph("rand", nodes[::-1], [ir.TensorInfo("input", (1, 4))],
                        [prev], inits), inits

    g, inits = chain(t_ir)
    seen = {"input"} | set(inits)
    for n in g.topo_order():
        assert all(i in seen for i in n.inputs)
        seen.update(n.outputs)
    assert [n.name for n in g.topo_order()] == \
        [n.name for n in chain(j_ir)[0].topo_order()]


@given(st.sampled_from([2, 4, 8, 16]), st.floats(0.05, 4.0))
@settings(**SETTINGS)
def test_quantize_monotone(bits, scale):
    qt = fixed_for_range(bits, scale)
    xs = np.sort(np.asarray(jax.random.normal(jax.random.PRNGKey(bits),
                                              (32,))) * scale)
    q = quantize(torch.from_numpy(xs), qt)
    assert bool((torch.diff(q) >= 0).all())
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(j_quantize(jnp.asarray(xs),
                                         j_ffr(bits, scale))))


def test_token_stream_resumes_from_its_state():
    """``TokenStream``: a restored stream yields exactly the batches the
    never-failed one would have; a seed mismatch is refused."""
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=3, seed=7)
    s = TokenStream(cfg, device="cpu")
    first = [next(s) for _ in range(3)]
    state = s.state_dict()
    assert state == {"step": 3, "seed": 7}
    rest = [next(s)["tokens"] for _ in range(2)]
    again = TokenStream.restore(cfg, state, device="cpu")
    for want in rest:
        assert torch.equal(next(again)["tokens"], want)
    assert torch.equal(first[1]["tokens"], batch_at(cfg, 1, "cpu")["tokens"])
    with pytest.raises(ValueError, match="seed"):
        TokenStream.restore(DataConfig(64, 8, 3, seed=8), state)
