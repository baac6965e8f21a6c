"""The port's attention (``repro_torch.models.attention``) against the
reference's ``repro.models.attention``: the unchunked, chunked and banded
prefill schedules (``Q_CHUNK`` patched small in both modules so a short
sequence reaches them), grouped and repeated GQA, each perf flag on and
off, the QKV bias, ``kv_override``, and ``decode_attention`` through a ring
buffer that wraps.  Weights and inputs are made with numpy from a seed and
handed to both.  Tolerances: f32 within 1e-5 * max|ref|; bf16 within the
2^-5 gate of the LM tests (measured 0: the reference's eager attention and
the port round at the same places)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.perf
from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn

from repro_torch import perf
from repro_torch.configs import get_config
from repro_torch.models import attention

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(window=None, bias=False, kv=2, dtype="float32"):
    """hymba's smoke config (d 64, 4 heads of 16) with ``kv`` kv heads."""
    kw = dict(sliding_window=window, qkv_bias=bias, n_kv_heads=kv,
              dtype=dtype)
    return (dataclasses.replace(j_get_config("hymba-1.5b").smoke(), **kw),
            dataclasses.replace(get_config("hymba-1.5b").smoke(), **kw))


def _weights(cfg, bias: bool, seed=0):
    rng = np.random.default_rng(seed)
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    w = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}
    out = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
           for k, s in w.items()}
    if bias:
        for k, n in (("bq", q), ("bk", kv), ("bv", kv)):
            out[k] = (0.5 * rng.standard_normal(n)).astype(np.float32)
    return out


def _params(w, dtype):
    jp = j_attn.LayerAttnParams(**{k: jnp.asarray(v, JDT[dtype])
                                   for k, v in w.items()})
    tp = attention.LayerAttnParams(**{k: torch.from_numpy(v).to(TDT[dtype])
                                      for k, v in w.items()})
    return jp, tp


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


@pytest.fixture
def small_chunks(monkeypatch):
    """Q_CHUNK = 8 in both packages, so S = 32 takes the chunked and banded
    schedules."""
    monkeypatch.setattr(j_attn, "Q_CHUNK", 8)
    monkeypatch.setattr(attention, "Q_CHUNK", 8)


def _flag(monkeypatch, name, value):
    """Set a perf flag on both sides.  The reference binds ``FLAGS`` by
    name at import, so its object is edited in place."""
    monkeypatch.setattr(repro.perf.FLAGS, name, value)
    monkeypatch.setattr(perf.FLAGS, name, value)


# (S, window, route): S = 30 is ragged (unchunked whatever the window), a
# window of 12 is not a multiple of Q_CHUNK (chunked under SWA), 16 is
# (banded)
ROUTES = [(30, 16, "unchunked"), (32, None, "chunked"), (32, 12, "chunked"),
          (32, 16, "banded")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("S,window,route", ROUTES)
def test_attention_matches_reference(small_chunks, monkeypatch, S, window,
                                     route, grouped, dtype):
    """Prefill output and the k/v it returns for the cache, on each
    schedule, with grouped and repeated GQA (4 heads over 2 kv heads) and
    the QKV bias."""
    _flag(monkeypatch, "gqa_grouped", grouped)
    jc, tc = _cfgs(window, bias=True, dtype=dtype)
    assert attention.prefill_route(tc, S) == route
    jp, tp = _params(_weights(jc, True), dtype)
    xj, xt = _x((2, S, jc.d_model), dtype)
    oj, kj, vj = j_attn.attention(xj, jp, jc)
    ot, kt, vt = attention.attention(xt, tp, tc)
    assert ot.dtype == TDT[dtype] and ot.shape == oj.shape
    assert kt.shape == kj.shape == (2, S, 2, 16)
    assert _rel(ot, oj) < TOL[dtype]
    assert _rel(kt, kj) < TOL[dtype] and _rel(vt, vj) < TOL[dtype]


@pytest.mark.parametrize("flag", ["gqa_grouped", "swa_banded",
                                  "attn_bf16_scores"])
@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_perf_flag_on_and_off(small_chunks, monkeypatch, flag, on,
                                   dtype):
    """Each flag set on both sides, on the banded call (S = 32, window 16):
    with ``swa_banded`` off the schedule falls back to chunked, and the
    result does not change beyond the tolerance."""
    _flag(monkeypatch, flag, on)
    jc, tc = _cfgs(16, bias=False, dtype=dtype)
    want_route = "chunked" if flag == "swa_banded" and not on else "banded"
    assert attention.prefill_route(tc, 32) == want_route
    jp, tp = _params(_weights(jc, False, seed=2), dtype)
    xj, xt = _x((2, 32, jc.d_model), dtype, seed=3)
    oj, _, _ = j_attn.attention(xj, jp, jc)
    ot, _, _ = attention.attention(xt, tp, tc)
    assert _rel(ot, oj) < TOL[dtype]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("kv", [4, 1])
def test_qkv_bias_and_head_groupings(bias, kv):
    """QKV bias on and off, with as many kv heads as heads (no grouping)
    and one kv head for all four (f32, unchunked)."""
    jc, tc = _cfgs(None, bias=bias, kv=kv)
    jp, tp = _params(_weights(jc, bias, seed=4), "float32")
    xj, xt = _x((2, 12, jc.d_model), "float32", seed=5)
    oj, kj, _ = j_attn.attention(xj, jp, jc)
    ot, kt, _ = attention.attention(xt, tp, tc)
    assert kt.shape == (2, 12, kv, 16)
    assert _rel(ot, oj) < 1e-5 and _rel(kt, kj) < 1e-5


@pytest.mark.parametrize("S", [12, 32])
def test_attention_kv_override(small_chunks, S):
    """Cross-attention: q from x (no RoPE), k, v and their positions given;
    non-causal, unchunked (S = 12) and chunked (S = 32, never banded)."""
    jc, tc = _cfgs(None, bias=True)
    assert attention.prefill_route(tc, S, causal=False, cross=True) == (
        "unchunked" if S == 12 else "chunked")
    jp, tp = _params(_weights(jc, True, seed=6), "float32")
    xj, xt = _x((2, S, jc.d_model), "float32", seed=7)
    rng = np.random.default_rng(8)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    kpos = np.arange(10)
    oj, kj, _ = j_attn.attention(
        xj, jp, jc, causal=False,
        kv_override=(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos)))
    ot, kt, _ = attention.attention(
        xt, tp, tc, causal=False,
        kv_override=(torch.from_numpy(k), torch.from_numpy(v),
                     torch.from_numpy(kpos)))
    assert np.array_equal(kt.numpy(), k)
    assert _rel(ot, oj) < 1e-5


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ring_buffer_wraps(monkeypatch, grouped, dtype):
    """20 decode steps through an 8-slot SWA ring buffer (window 8): every
    step's output and both caches against the reference's, and in f32 every
    step against the prefill's SWA output at that position."""
    _flag(monkeypatch, "gqa_grouped", grouped)
    jc, tc = _cfgs(8, bias=True, dtype=dtype)
    S = 20
    smax = attention.cache_size(tc, S)
    assert smax == j_attn.cache_size(jc, S) == 8
    jp, tp = _params(_weights(jc, True, seed=9), dtype)
    xj, xt = _x((2, S, jc.d_model), dtype, seed=10)
    ck_j = cv_j = jnp.zeros((2, smax, jc.kv_dim), JDT[dtype])
    ck_t = cv_t = torch.zeros((2, smax, tc.kv_dim), dtype=TDT[dtype])
    full, _, _ = attention.attention(xt, tp, tc)
    for t in range(S):
        before = ck_t.clone()
        oj, ck_j, cv_j = j_attn.decode_attention(
            xj[:, t:t + 1], jp, jc, ck_j, cv_j, jnp.asarray(t, jnp.int32))
        ot_, nk, nv = attention.decode_attention(xt[:, t:t + 1], tp, tc,
                                                 ck_t, cv_t, t)
        assert torch.equal(ck_t, before)       # the caches passed in stay
        ck_t, cv_t = nk, nv
        assert _rel(ot_, oj) < TOL[dtype]
        assert _rel(ck_t, ck_j) < TOL[dtype] and _rel(cv_t, cv_j) < TOL[dtype]
        if dtype == "float32":
            assert _rel(ot_[:, 0], full[:, t]) < 1e-5


def test_decode_attention_past_the_cache_end_clamps_like_the_reference():
    """Without a window the cache is not a ring: a step at index >= Smax
    writes the last slot, as the reference's dynamic_update_slice clamps
    its start."""
    jc, tc = _cfgs(None, bias=False)
    jp, tp = _params(_weights(jc, False, seed=11), "float32")
    xj, xt = _x((1, 6, jc.d_model), "float32", seed=12)
    ck_j = cv_j = jnp.zeros((1, 4, jc.kv_dim))
    ck_t = cv_t = torch.zeros((1, 4, tc.kv_dim))
    for t in range(6):
        oj, ck_j, cv_j = j_attn.decode_attention(
            xj[:, t:t + 1], jp, jc, ck_j, cv_j, jnp.asarray(t, jnp.int32))
        ot_, ck_t, cv_t = attention.decode_attention(xt[:, t:t + 1], tp, tc,
                                                     ck_t, cv_t, t)
        assert _rel(ot_, oj) < 1e-5 and _rel(ck_t, ck_j) < 1e-5


def test_decode_attention_kv_override():
    """Cross-attention decode: the given k, v (cast to q's dtype), no
    causal mask, the caches returned as they came."""
    jc, tc = _cfgs(None, bias=True)
    jp, tp = _params(_weights(jc, True, seed=13), "float32")
    xj, xt = _x((2, 1, jc.d_model), "float32", seed=14)
    rng = np.random.default_rng(15)
    k, v = (rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
            for _ in range(2))
    ck = torch.zeros((2, 3, tc.kv_dim))
    ot, ck2, _ = attention.decode_attention(
        xt, tp, tc, ck, ck, 0,
        kv_override=(torch.from_numpy(k).to(torch.bfloat16),
                     torch.from_numpy(v).to(torch.bfloat16), None))
    assert ck2 is ck
    oj2, _, _ = j_attn.decode_attention(
        xj, jp, jc, jnp.zeros((2, 3, jc.kv_dim)), jnp.zeros((2, 3, jc.kv_dim)),
        jnp.asarray(0, jnp.int32),
        kv_override=(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                     None))
    assert _rel(ot, oj2) < 1e-5


@pytest.mark.parametrize("arch,seq", [("hymba-1.5b", 100), ("hymba-1.5b", 4096),
                                      ("qwen1.5-0.5b", 100),
                                      ("h2o-danube-3-4b", 5000)])
def test_cache_size_matches_reference(arch, seq):
    assert attention.cache_size(get_config(arch), seq) == \
        j_attn.cache_size(j_get_config(arch), seq)


def test_mask_and_expand_kv_match_reference():
    q = np.arange(6) + 4
    k = np.concatenate([[-10 ** 9], np.arange(10)])
    for window in (None, 3):
        for causal in (True, False):
            np.testing.assert_array_equal(
                attention._mask(torch.from_numpy(q), torch.from_numpy(k),
                                window, causal).numpy(),
                np.asarray(j_attn._mask(jnp.asarray(q), jnp.asarray(k),
                                        window, causal)))
    kv = np.random.default_rng(0).standard_normal((1, 3, 2, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        attention._expand_kv(torch.from_numpy(kv), 6).numpy(),
        np.asarray(j_attn._expand_kv(jnp.asarray(kv), 6)))


def test_set_baseline_turns_the_attention_flags_off(monkeypatch):
    """``set_baseline`` rebinds ``perf.FLAGS``; the port reads the flags at
    call time, so the baseline reaches attention (the reference's bound
    name does not see it)."""
    monkeypatch.setattr(perf, "FLAGS", perf.FLAGS)
    assert perf.FLAGS.gqa_grouped and perf.FLAGS.swa_banded \
        and perf.FLAGS.attn_bf16_scores
    perf.set_baseline()
    assert not (perf.FLAGS.gqa_grouped or perf.FLAGS.swa_banded
                or perf.FLAGS.attn_bf16_scores or perf.FLAGS.ssd_bf16_intra)
    _, tc = _cfgs(2048)
    assert attention.prefill_route(dataclasses.replace(tc), 4096) == \
        "chunked"
