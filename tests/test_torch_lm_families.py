"""The port's LM serving path on the hybrid (hymba-1.5b), dense
(qwen1.5-0.5b, phi3-mini-3.8b, h2o-danube-3-4b, codeqwen1.5-7b), MoE
(granite-moe-3b-a800m, mixtral-8x7b), encoder-decoder (whisper-base) and
vision-stub (phi-3-vision-4.2b) families against the reference: configs and
parameter trees, the full-width parameter counts (active MoE ones
included), ``forward_logits`` (with the MoE aux losses) and
``decode_step`` (with the encoder-decoder's cross k/v), decode against
forward (chunked and banded prefill, a wrapping ring buffer; MoE at
``capacity_factor`` 8, where no slot drops), ``collect_cache``,
``greedy_generate`` (whisper with frames), ``AdaptiveLMServer``, the
vision patches and the launcher, plus the config registry's helpers.
Weights come from the reference's ``init_params`` and cross with
``params_from_jax``; tokens, frames and patches are made with numpy from a
seed.  The model tests use the reduced ``smoke()`` configs on
the CPU; each states its tolerance: f32 within 1e-5 * max|logit|, bf16
within 2^-5 * max|logit| (the gate of test_torch_lm.py: the reference's
compiled layer scan keeps bf16 intermediates in f32 where the port rounds
them), decode against forward within the reference's 5e-3 * max|logit|."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core.adaptive import RuntimePolicy as JPolicy
from repro.core.adaptive import WorkingPoint as JPoint
from repro.models.params import count_params_analytic as j_count
from repro.models.params import init_params as j_init
from repro.models.params import param_shapes as j_shapes
from repro.quant.ptq import quantize_tree_native as j_quantize
from repro.models import transformer as j_transformer
from repro.runtime import model_api as j_api
from repro.runtime import serve as j_serve

from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.core.adaptive import RuntimePolicy, WorkingPoint
from repro_torch.models import attention, encdec, transformer
from repro_torch.models.params import (count_params_analytic, init_params,
                                       param_dtype, param_shapes,
                                       params_from_jax)
from repro_torch.runtime import model_api, serve

ARCHS = ["hymba-1.5b", "qwen1.5-0.5b", "phi3-mini-3.8b", "h2o-danube-3-4b",
         "codeqwen1.5-7b", "granite-moe-3b-a800m", "mixtral-8x7b",
         "whisper-base", "phi-3-vision-4.2b"]
MOE = ("granite-moe-3b-a800m", "mixtral-8x7b")
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
POINTS = [("w8", 8), ("w4", 4), ("w2", 2)]


def _cfgs(arch, dtype="float32", capacity_factor=None, **kw):
    out = []
    for c in (j_configs.get_config(arch).smoke(), get_config(arch).smoke()):
        if capacity_factor is not None:
            kw["moe"] = dataclasses.replace(c.moe,
                                            capacity_factor=capacity_factor)
        out.append(dataclasses.replace(c, dtype=dtype, **kw))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32", seed=0):
    jc, tc = _cfgs(arch, dtype)
    jp = j_init(jc, jax.random.PRNGKey(seed), max_seq=32)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    return jc, tc, jp, tp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _extras(cfg, B, seed=0, patches=True):
    """The family's inputs beside the tokens, as numpy f32: frames for the
    encoder-decoder, patches for the vision stub (unless ``patches`` is
    off)."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches and patches:
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _batches(cfg, toks, extras):
    """The same batch for both packages, extras in the model's dtype."""
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks).long()}
    for k, v in extras.items():
        jb[k] = jnp.asarray(v, JDT[cfg.dtype])
        tb[k] = torch.from_numpy(v).to(TDT[cfg.dtype])
    return jb, tb


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _j_step(jc):
    return jax.jit(lambda p, t, s: j_api.decode_step(p, t, s, jc))


# -- configs and parameter trees -----------------------------------------------

FULL_COUNTS = {"qwen1.5-0.5b": 464_118_784, "hymba-1.5b": 1_641_636_096,
               "codeqwen1.5-7b": 8_190_038_016,
               "granite-moe-3b-a800m": 3_299_182_080,
               "mixtral-8x7b": 46_702_792_704, "whisper-base": 98_074_624,
               "phi-3-vision-4.2b": 3_831_696_384}
# the reference's test_full_param_counts_match_published (no vision or
# whisper entry there: their stubbed frontends are not counted)
PUBLISHED = {"phi3-mini-3.8b": 3.8e9, "h2o-danube-3-4b": 4.0e9,
             "codeqwen1.5-7b": 8.2e9, "qwen1.5-0.5b": 0.46e9,
             "hymba-1.5b": 1.64e9, "granite-moe-3b-a800m": 3.3e9,
             "mixtral-8x7b": 46.7e9}
# active (top-k of E experts) counts, and the reference's
# test_moe_active_params bounds
ACTIVE = {"granite-moe-3b-a800m": (883_262_976, 0, 1.0e9),
          "mixtral-8x7b": (12_879_925_248, 12e9, 14e9)}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_shapes_equal_the_reference(arch):
    """Full and smoke configs field for field, the parameter shapes, and
    the full-width analytic count (the reference's, and within 5% of the
    published size: the port's mirror of the reference's
    test_full_param_counts_match_published), and the active count (for MoE
    its mirror of test_moe_active_params)."""
    cfg, ref = get_config(arch), j_configs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(ref.smoke())
    assert param_shapes(cfg) == j_shapes(ref)
    assert param_shapes(cfg.smoke(), max_seq=32) == \
        j_shapes(ref.smoke(), max_seq=32)
    n = count_params_analytic(cfg)
    assert n == j_count(ref) == cfg.param_count()
    if arch in PUBLISHED:
        assert abs(n - PUBLISHED[arch]) / PUBLISHED[arch] < 0.05
    if arch in FULL_COUNTS:
        assert n == FULL_COUNTS[arch]
    active = cfg.active_param_count()
    assert active == j_count(ref, active_only=True)
    if arch in ACTIVE:
        want, lo, hi = ACTIVE[arch]
        assert active == want and lo < active < hi
    else:
        assert active == n


def test_registry_helpers_match_the_reference():
    """``get_shape``, ``shapes_for``, ``get_cnn_config`` and ``all_cells``
    against the reference; the port's registry is the reference's, in its
    order."""
    for s in j_configs.ALL_SHAPES:
        assert dataclasses.asdict(configs.get_shape(s.name)) == \
            dataclasses.asdict(j_configs.get_shape(s.name))
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("no-such-shape")
    for arch in configs.ARCH_IDS:
        assert [s.name for s in configs.shapes_for(get_config(arch))] == \
            [s.name for s in j_configs.shapes_for(j_configs.get_config(arch))]
    assert dataclasses.asdict(configs.get_cnn_config()) == \
        dataclasses.asdict(j_configs.get_cnn_config())
    assert list(configs.all_cells()) == list(j_configs.all_cells())
    assert configs.ARCH_IDS == j_configs.ARCH_IDS
    assert sorted(configs.ARCH_IDS) == sorted(ARCHS + ["mamba2-1.3b"])


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen1.5-0.5b",
                                  "granite-moe-3b-a800m", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_init_params_follows_the_reference_tree(arch):
    """Same names, shapes and dtypes as the reference's tree (the 5-D
    expert tensors, the encoder stack and positions, the vision projection
    included); zero QKV and MLP biases and unit norms as the reference
    draws them."""
    _, tc = _cfgs(arch, "bfloat16")
    tp = init_params(tc, torch.Generator().manual_seed(0), max_seq=32,
                     device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        param_shapes(tc, max_seq=32)
    for k, v in tp.items():
        assert v.dtype == param_dtype(k, torch.bfloat16), k
    assert torch.all(tp["layers/attn_norm/w"] == 1)
    if tc.qkv_bias:
        assert all(torch.all(tp[f"layers/attn/b{n}"] == 0) for n in "qkv")
    if tc.enc_layers:
        assert torch.all(tp["enc_final_norm/w"] == 1)
        assert torch.all(tp["enc/mlp/b_up"] == 0)
        assert tp["dec_pos"].shape == (32, tc.d_model)
    w = tp["layers/attn/wq"].float()
    assert abs(float(w.std()) * 8.0 - 1.0) < 0.05    # std 1/sqrt(d=64)


# -- forward and decode against the reference ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_matches_reference(arch, dtype):
    """f32 within 1e-5 * max|logit| (measured 6.0e-7 to 1.3e-6), bf16
    within 2^-5 (measured 1.0e-2 to 2.4e-2) on (2, 32), with whisper's
    frames and the vision stub's patches.  The MoE aux losses within the
    same relative bounds of the reference's (measured f32 at most 1.1e-7,
    bf16 4.1e-4); zero for the other families."""
    jc, tc, jp, tp = _params(arch, dtype)
    toks = _tokens(2, 32, jc.vocab, seed=1)
    jb, tb = _batches(jc, toks, _extras(jc, 2, seed=1))
    want, jaux = j_api.forward_logits(jp, jb, jc)
    got, aux = model_api.forward_logits(tp, tb, tc)
    assert got.shape == want.shape and got.dtype == TDT[dtype]
    assert _rel(got, want) < TOL[dtype]
    for k in ("lb_loss", "z_loss"):
        assert aux[k].dtype == torch.float32 and aux[k].shape == ()
        if arch in MOE:
            assert float(aux[k]) > 0 and _rel(aux[k], jaux[k]) < TOL[dtype]
        else:
            assert float(aux[k]) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, dtype):
    """Six decode steps from the empty state (whisper's from its encoder's
    state): every step's logits within the forward test's bound (measured
    f32 at most 1.0e-6, bf16 1.0e-2 to 1.7e-2), the KV caches (hymba's SSM
    state, whisper's cross k and v) too.  MoE decodes at capacity factor 1,
    where at T = B = 2 tokens each expert keeps one slot."""
    jc, tc, jp, tp = _params(arch, dtype)
    toks = _tokens(2, 6, jc.vocab, seed=2)
    jb, tb = _batches(jc, toks[:, :1], _extras(jc, 2, seed=2))
    st_j = j_api.init_decode_state(jp, jb, jc, 2, 16, dtype=JDT[dtype])
    st_t = model_api.init_decode_state(tp, tb, tc, 2, 16, dtype=TDT[dtype])
    assert type(st_t).__name__ == type(st_j).__name__
    assert st_t.cache_k.shape == st_j.cache_k.shape
    assert st_t.cache_k.dtype == TDT[dtype]
    if arch == "whisper-base":
        assert st_t.cross_k.shape == st_j.cross_k.shape == (
            tc.n_layers, 2, tc.enc_seq, tc.n_kv_heads, tc.head_dim)
        assert st_t.cross_k.dtype == st_t.cross_v.dtype == TDT[dtype]
        assert _rel(st_t.cross_k, st_j.cross_k) < TOL[dtype]
        assert _rel(st_t.cross_v, st_j.cross_v) < TOL[dtype]
    else:
        assert (st_t.ssm_ssd is None) == (st_j.ssm_ssd is None)
    step = _j_step(jc)
    for t in range(6):
        lj, st_j = step(jp, jnp.asarray(toks[:, t:t + 1]), st_j)
        lt, st_t = model_api.decode_step(
            tp, torch.from_numpy(toks[:, t:t + 1]).long(), st_t, tc)
        assert lt.shape == lj.shape and _rel(lt, lj) < TOL[dtype]
    assert st_t.index == int(st_j.index) == 6
    assert _rel(st_t.cache_k, st_j.cache_k) < TOL[dtype]
    assert _rel(st_t.cache_v, st_j.cache_v) < TOL[dtype]
    if getattr(st_j, "ssm_ssd", None) is not None:
        assert _rel(st_t.ssm_ssd, st_j.ssm_ssd) < TOL[dtype]


# (arch, S, window, Q_CHUNK): every arch at S = 16; then S = 32 with
# Q_CHUNK = 8 so the prefill is chunked (no window) or banded (window 16,
# where decode wraps the 16-slot ring twice)
DECODE_CASES = [(a, 16, None, None) for a in ARCHS] + [
    ("qwen1.5-0.5b", 32, None, 8), ("hymba-1.5b", 32, 16, 8),
    ("h2o-danube-3-4b", 32, 16, 8), ("mixtral-8x7b", 32, 16, 8),
    ("whisper-base", 32, None, 8)]


@pytest.mark.parametrize("arch,S,window,q_chunk", DECODE_CASES)
def test_decode_matches_forward(monkeypatch, arch, S, window, q_chunk):
    """Port of the reference's test_decode_matches_forward: feeding tokens
    one by one through the KV (and SSM) cache reproduces the teacher-forced
    logits (f32 smoke config, 5e-3 * max|logit|).  MoE at capacity factor
    8, as the reference's test does (no slot drops at T = B or T = B*S);
    whisper with frames (its cross-attention takes the chunked prefill at
    Q_CHUNK 8); the vision stub without patches, which decode never sees."""
    kw = {} if window is None else {"sliding_window": window}
    _, tc = _cfgs(arch, capacity_factor=8.0 if arch in MOE else None, **kw)
    if q_chunk is not None:
        monkeypatch.setattr(attention, "Q_CHUNK", q_chunk)
        assert attention.prefill_route(tc, S) == (
            "chunked" if window is None else "banded")
    tp = init_params(tc, torch.Generator().manual_seed(0), max_seq=S,
                     device="cpu")
    B = 2
    _, batch = _batches(tc, _tokens(B, S, tc.vocab),
                        _extras(tc, B, patches=False))
    toks = batch["tokens"]
    fwd, _ = model_api.forward_logits(tp, batch, tc)
    st = model_api.init_decode_state(tp, batch, tc, B, S, dtype=torch.float32)
    if window is not None:
        assert st.cache_k.shape[2] == window < S
    step = serve.make_decode_step(tc)
    errs = []
    for t in range(S):
        logits, st = step(tp, toks[:, t:t + 1], st)
        errs.append(float((logits[:, 0] - fwd[:, t]).abs().max()))
    scale = float(fwd.abs().max()) + 1e-6
    assert max(errs) / scale < 5e-3


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen1.5-0.5b"])
def test_collect_cache_equals_the_decode_state(arch):
    """The prefill's per-layer k and v (after RoPE) and hymba's final SSM
    states against what token-by-token decoding builds: each within 1e-5 of
    its max.  A dense model has no SSM state."""
    _, tc, _, tp = _params(arch)
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(B, S, tc.vocab, seed=3)).long()
    logits, _, (k, v, ssm_st) = transformer.forward(tp, toks, tc,
                                                    collect_cache=True)
    L = tc.n_layers
    assert k.shape == v.shape == (L, B, S, tc.kv_dim)   # the cache's layout
    st = model_api.init_decode_state(tp, {}, tc, B, S, dtype=torch.float32)
    for t in range(S):
        _, st = model_api.decode_step(tp, toks[:, t:t + 1], st, tc)
    assert _rel(k, st.cache_k) < 1e-5
    assert _rel(v, st.cache_v) < 1e-5
    if tc.hybrid:
        H, P, N = tc.n_ssm_heads, tc.ssm.d_head, tc.ssm.d_state
        assert _rel(ssm_st.ssd, st.ssm_ssd.reshape(L, B, H, P, N)) < 1e-5
        assert _rel(ssm_st.conv, st.ssm_conv) < 1e-5
    else:
        assert ssm_st is None and st.ssm_ssd is None
    assert torch.equal(serve.make_prefill_step(tc)(tp, {"tokens": toks}),
                       logits)


def test_encdec_collect_cache_equals_the_decode_state():
    """whisper: the teacher-forced pass's per-layer self-attention k and v
    against what token-by-token decoding builds, and its cross k and v
    against ``EncDecDecodeState``'s, each within 1e-5 of its max; the
    prefill step returns the same logits."""
    _, tc, _, tp = _params("whisper-base")
    B, S = 2, 24
    _, batch = _batches(tc, _tokens(B, S, tc.vocab, seed=3),
                        _extras(tc, B, seed=3))
    toks = batch["tokens"]
    logits, _, (k, v, ck, cv) = encdec.forward(tp, toks, batch["frames"], tc,
                                               collect_cache=True)
    L = tc.n_layers
    assert k.shape == v.shape == (L, B, S, tc.kv_dim)   # the cache's layout
    assert ck.shape == cv.shape == (L, B, tc.enc_seq, tc.n_kv_heads,
                                    tc.head_dim)
    st = model_api.init_decode_state(tp, batch, tc, B, S, dtype=torch.float32)
    assert _rel(ck, st.cross_k) < 1e-5 and _rel(cv, st.cross_v) < 1e-5
    for t in range(S):
        _, st = model_api.decode_step(tp, toks[:, t:t + 1], st, tc)
    assert _rel(k, st.cache_k) < 1e-5
    assert _rel(v, st.cache_v) < 1e-5
    assert torch.equal(serve.make_prefill_step(tc)(tp, batch), logits)


def test_encdec_decode_clamps_past_the_position_table():
    """A decode step past ``dec_pos``'s last row reads that row, as the
    reference's ``dynamic_slice_in_dim`` clamps (table of 8 rows, step 9):
    the logits equal the reference's within the f32 bound."""
    jc, tc = _cfgs("whisper-base")
    jp = j_init(jc, jax.random.PRNGKey(5), max_seq=8)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    assert tp["dec_pos"].shape[0] == 8
    toks = _tokens(2, 10, jc.vocab, seed=5)
    jb, tb = _batches(jc, toks[:, :1], _extras(jc, 2, seed=5))
    st_j = j_api.init_decode_state(jp, jb, jc, 2, 16, dtype=jnp.float32)
    st_t = model_api.init_decode_state(tp, tb, tc, 2, 16, dtype=torch.float32)
    step = _j_step(jc)
    for t in range(10):
        lj, st_j = step(jp, jnp.asarray(toks[:, t:t + 1]), st_j)
        lt, st_t = model_api.decode_step(
            tp, torch.from_numpy(toks[:, t:t + 1]).long(), st_t, tc)
    assert st_t.index == int(st_j.index) == 10
    assert _rel(lt, lj) < TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_equals_reference(arch):
    """f32: the generated tokens equal the reference's (whisper with frames
    in ``batch_extras``; the vision stub with patches, which neither
    package's decode reads)."""
    jc, tc, jp, tp = _params(arch)
    prompt = _tokens(2, 3, jc.vocab, seed=4)
    jb, tb = _batches(jc, prompt, _extras(jc, 2, seed=4))
    jx = {k: v for k, v in jb.items() if k != "tokens"} or None
    tx = {k: v for k, v in tb.items() if k != "tokens"} or None
    want = j_serve.greedy_generate(jp, jc, jnp.asarray(prompt), max_new=4,
                                   seq_len=16, batch_extras=jx)
    got = serve.greedy_generate(tp, tc, torch.from_numpy(prompt).long(),
                                max_new=4, seq_len=16, batch_extras=tx)
    assert got.shape == (2, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the adaptive server --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_adaptive_server_codes_and_scales_equal_the_reference(arch):
    """Master codes and scales byte-identical to the reference's
    ``quantize_tree_native`` on the same bf16 weights (the 5-D expert
    tensors, the encoder tree, the vision projection included); the QKV
    biases, norms, whisper's position tables and the (tied, for qwen)
    embedding table pass through."""
    jc, tc, jp, tp = _params(arch, "bfloat16")
    jq = j_quantize(jp)
    srv = serve.AdaptiveLMServer(tp, tc)
    assert sorted(srv.qparams.codes) == sorted(jq.codes)
    assert sorted(srv.qparams.passthrough) == sorted(jq.passthrough)
    for k in jq.codes:
        assert np.array_equal(srv.qparams.codes[k].numpy(),
                              np.asarray(jq.codes[k])), k
        assert np.array_equal(srv.qparams.scales[k].numpy(),
                              np.asarray(jq.scales[k])), k
    assert "embed/table" in srv.qparams.passthrough
    assert "layers/attn/wq" in srv.qparams.codes
    if tc.qkv_bias:
        assert {f"layers/attn/b{n}" for n in "qkv"} <= \
            set(srv.qparams.passthrough)
    if tc.moe is not None:
        assert srv.qparams.codes["layers/moe/w_gate"].ndim == 5
    if tc.enc_layers:
        assert {"enc/attn/wq", "layers/cross/wk"} <= set(srv.qparams.codes)
        assert {"enc_pos", "dec_pos"} <= set(srv.qparams.passthrough)
    if tc.n_patches:
        assert "vision_proj/w" in srv.qparams.codes


@pytest.mark.parametrize("arch", ARCHS)
def test_adaptive_server_switches_points_over_shared_codes(arch):
    """Budgets 1.0/0.5/0.1 at thresholds 0.66/0.33 walk w8 -> w4 -> w2
    beside the reference's server: the same points and weight bytes, every
    logit finite and within 2^-5 * max|logit| of the reference's (bf16 on
    both sides), the master codes the same tensors, unchanged."""
    jc, tc, jp, tp = _params(arch, "bfloat16", seed=1)
    points = [WorkingPoint(n, b) for n, b in POINTS]
    srv = serve.AdaptiveLMServer(
        tp, tc, points, RuntimePolicy(points, thresholds=[0.66, 0.33]))
    jpts = [JPoint(n, b) for n, b in POINTS]
    jsrv = j_serve.AdaptiveLMServer(jp, jc, jpts,
                                    JPolicy(jpts, thresholds=[0.66, 0.33]))
    codes = {k: v.clone() for k, v in srv.qparams.codes.items()}
    ids = {k: id(v) for k, v in srv.qparams.codes.items()}
    toks = _tokens(2, 1, jc.vocab, seed=5)
    jb, tb = _batches(jc, toks, _extras(jc, 2, seed=5))
    st_t = model_api.init_decode_state(tp, tb, tc, 2, 16)
    st_j = j_api.init_decode_state(jp, jb, jc, 2, 16)
    seen, nbytes = [], []
    for budget in (1.0, 0.5, 0.1):
        lt, st_t, m = srv.decode(torch.from_numpy(toks).long(), st_t, budget)
        lj, st_j, mj = jsrv.decode(jnp.asarray(toks), st_j, budget)
        seen.append(m.point)
        nbytes.append(m.weight_bytes_read)
        assert (m.point, m.weight_bytes_read) == (mj.point,
                                                  mj.weight_bytes_read)
        assert torch.isfinite(lt.float()).all()
        assert _rel(lt, lj) < 2.0 ** -5
    assert seen == ["w8", "w4", "w2"]
    assert nbytes[0] > nbytes[1] > nbytes[2]
    assert {k: id(v) for k, v in srv.qparams.codes.items()} == ids
    assert all(torch.equal(codes[k], srv.qparams.codes[k]) for k in codes)


def test_launch_serve_defaults_to_the_reference_arch(monkeypatch, capsys):
    """The CLI's default arch is the reference's, qwen1.5-0.5b (its smoke
    config), walking the points on the CPU."""
    from repro_torch.launch import serve as launch_serve
    asked = []

    def spy(arch):
        asked.append(arch)
        return get_config(arch)

    monkeypatch.setattr(launch_serve, "get_config", spy)
    switches = launch_serve.main(["--device", "cpu", "--steps", "6",
                                  "--batch", "2"])
    assert asked == ["qwen1.5-0.5b"]
    assert [p for _, p in switches] == ["w8", "w4", "w2"]
    assert "served 6 decode steps, 2 streams" in capsys.readouterr().out


def test_launch_serve_runs_the_encoder_decoder(capsys):
    """``--arch whisper-base``: the launcher draws bf16 frames on its
    device, runs the encoder into the decode state and walks the points."""
    from repro_torch.launch import serve as launch_serve
    switches = launch_serve.main(["--device", "cpu", "--arch", "whisper-base",
                                  "--steps", "6", "--batch", "2"])
    assert [p for _, p in switches] == ["w8", "w4", "w2"]
    assert "served 6 decode steps, 2 streams" in capsys.readouterr().out


# -- the vision stub --------------------------------------------------------------

def test_vlm_patches_change_output():
    """Port of the reference's test: moving the patches moves the logits
    (phi-3-vision-4.2b smoke, bf16, S = 64), and with patches the logits
    hold the bf16 bound against the reference's; a prompt shorter than
    ``n_patches`` comes out ``n_patches`` long in both packages."""
    jc, tc, jp, tp = _params("phi-3-vision-4.2b", "bfloat16")
    toks = _tokens(2, 64, jc.vocab, seed=6)
    ex = _extras(jc, 2, seed=6)
    jb, tb = _batches(jc, toks, ex)
    _, tb2 = _batches(jc, toks, {"patches": ex["patches"] + 1.0})
    l1, _ = model_api.forward_logits(tp, tb, tc)
    l2, _ = model_api.forward_logits(tp, tb2, tc)
    assert float((l1.float() - l2.float()).abs().max()) > 1e-3
    want, _ = j_api.forward_logits(jp, jb, jc)
    assert _rel(l1, want) < TOL["bfloat16"]
    short = transformer.embed_inputs(tp, tc, tb["tokens"][:, :2],
                                     tb["patches"])
    j_short = j_transformer.embed_inputs(jp, jc, jb["tokens"][:, :2],
                                         jb["patches"])
    assert short.shape == j_short.shape == (2, tc.n_patches, tc.d_model)


# -- the sliding window ----------------------------------------------------------

def test_sliding_window_masks_distant_tokens():
    """Port of the reference's test: SWA must differ from full attention
    beyond the window (h2o-danube-3-4b smoke, window 32, S = 64)."""
    _, tc = _cfgs("h2o-danube-3-4b", "bfloat16")
    assert tc.sliding_window == 32
    full = dataclasses.replace(tc, sliding_window=None)
    tp = init_params(tc, torch.Generator().manual_seed(3), max_seq=64,
                     device="cpu")
    toks = torch.from_numpy(_tokens(1, 64, tc.vocab, seed=3)).long()
    l_swa, _ = model_api.forward_logits(tp, {"tokens": toks}, tc)
    l_full, _ = model_api.forward_logits(tp, {"tokens": toks}, full)
    early = float((l_swa[:, :31] - l_full[:, :31]).abs().max())
    late = float((l_swa[:, 40:] - l_full[:, 40:]).abs().max())
    assert early < 1e-2 and late > 1e-3

