"""The port's LM serving path on mamba2-1.3b against the reference: config
and parameter tree, the carry-over of the reference's weights, ``ssm_block``
on each scan route, ``forward_logits``/``decode_step``, decode against
forward, ``greedy_generate``, ``AdaptiveLMServer`` and the CLI, plus the
other archs' configs and each family's forward.  Weights come
from the reference's ``init_params`` (a PRNG key) and cross with
``params_from_jax``; tokens are made with numpy from a seed.  The model
tests use the reduced ``smoke()`` config on the CPU; each states its
tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.adaptive import RuntimePolicy as JPolicy
from repro.core.adaptive import WorkingPoint as JPoint
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.models.params import count_params_analytic as j_count
from repro.models.params import init_params as j_init
from repro.models.params import param_shapes as j_shapes
from repro.quant.ptq import quantize_tree_native as j_quantize
from repro.runtime import model_api as j_api
from repro.runtime import serve as j_serve

from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core.adaptive import RuntimePolicy, WorkingPoint
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ssm, transformer
from repro_torch.models.params import (count_params_analytic, init_params,
                                       param_dtype, param_shapes,
                                       params_from_jax)
from repro_torch.quant.ptq import quantize_tree_native
from repro_torch.runtime import model_api, serve

ARCH = "mamba2-1.3b"
POINTS = [("w8", 8), ("w4", 4), ("w2", 2)]


def _cfgs(dtype="float32"):
    jc = dataclasses.replace(j_get_config(ARCH).smoke(), dtype=dtype)
    tc = dataclasses.replace(get_config(ARCH).smoke(), dtype=dtype)
    return jc, tc


def _params(dtype="float32", seed=0):
    jc, tc = _cfgs(dtype)
    jp = j_init(jc, jax.random.PRNGKey(seed), max_seq=16)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    return jc, tc, jp, tp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


# -- config and parameter tree -------------------------------------------------

def test_full_width_config_and_shapes_equal_the_reference():
    cfg, ref = get_config(ARCH), j_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(ref.smoke())
    assert param_shapes(cfg) == j_shapes(ref)
    assert (cfg.d_inner, cfg.n_ssm_heads, cfg.vocab_padded) == \
        (4096, 64, 50432)
    assert count_params_analytic(cfg) == j_count(ref) == 1_343_843_328
    assert cfg.param_count() == 1_343_843_328


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi-3-vision-4.2b",
                                  "granite-moe-3b-a800m", "whisper-base"])
def test_other_archs_resolve_to_the_reference_configs(arch):
    """The MoE, vision and encoder-decoder archs resolve to configs equal
    to the reference's, full and smoke, and their smoke configs initialize
    and run forward (finite logits of the padded vocab); an unknown arch
    still raises."""
    cfg, ref = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    tc = cfg.smoke()
    assert dataclasses.asdict(tc) == dataclasses.asdict(ref.smoke())
    tp = init_params(tc, torch.Generator().manual_seed(0), max_seq=16,
                     device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(2, 16, tc.vocab)).long()}
    g = torch.Generator().manual_seed(1)
    if tc.enc_layers:
        batch["frames"] = torch.randn((2, tc.enc_seq, tc.d_model),
                                      generator=g).to(torch.bfloat16)
    if tc.n_patches:
        batch["patches"] = torch.randn((2, tc.n_patches, tc.d_model),
                                       generator=g).to(torch.bfloat16)
    logits, aux = model_api.forward_logits(tp, batch, tc)
    assert logits.shape == (2, 16, tc.vocab_padded)
    assert torch.isfinite(logits.float()).all()
    assert torch.isfinite(aux["lb_loss"]) and torch.isfinite(aux["z_loss"])
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_params_from_jax_carries_bf16_bit_for_bit_and_checks():
    jc, tc = _cfgs("bfloat16")
    jp = {k: np.asarray(v) for k, v in
          j_init(jc, jax.random.PRNGKey(3), max_seq=16).items()}
    tp = params_from_jax(jp, tc, "cpu")
    for k, v in jp.items():
        assert tp[k].dtype == param_dtype(k, torch.bfloat16)
        if v.dtype.name == "bfloat16":
            assert np.array_equal(tp[k].view(torch.int16).numpy(),
                                  v.view(np.int16))
        else:
            assert np.array_equal(tp[k].numpy(), v)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in jp.items() if k != "embed/table"},
                        tc, "cpu")
    bad = dict(jp, **{"layers/ssm/w_x": jp["layers/ssm/w_x"].astype(
        np.float32)})
    with pytest.raises(ValueError, match="expected bfloat16"):
        params_from_jax(bad, tc, "cpu")
    bad = dict(jp, **{"final_norm/w": jp["final_norm/w"][:-1]})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tc, "cpu")


def test_init_params_follows_the_reference_distributions():
    """Same shapes, dtypes and distributions as the reference's init (the
    numbers differ: a torch generator, not jax.random)."""
    _, tc = _cfgs("bfloat16")
    tp = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == param_shapes(tc)
    for k, v in tp.items():
        assert v.dtype == param_dtype(k, torch.bfloat16), k
    assert torch.all(tp["layers/ssm/norm_w"] == 1)
    assert torch.all(tp["layers/ssm/D"] == 1)
    a = torch.exp(tp["layers/ssm/A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    u = torch.nn.functional.softplus(tp["layers/ssm/dt_bias"])
    assert float(u.min()) >= 1e-3 - 1e-7 and float(u.max()) <= 0.1 + 1e-7
    w = tp["layers/ssm/w_x"].float()
    assert abs(float(w.std()) * 8.0 - 1.0) < 0.05    # std 1/sqrt(d=64)
    again = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)


def test_lm_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(tc, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({}, tc, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main([])


# -- the SSM block on each scan route ----------------------------------------

@pytest.mark.parametrize("use_kernel", [None, False, True])
def test_ssm_block_matches_reference(use_kernel):
    """``use_kernel=None`` (auto: the oracle on the CPU) and ``False``
    against the reference's default oracle route; ``True`` (the kernel's
    entry point: on the CPU its plain version) against the reference's
    Pallas kernel in interpret mode.  f32, tolerance 1e-5 * max|y| and the
    state within 1e-5 (measured about 1e-7)."""
    jc, tc, jp, tp = _params()
    lp_j = {k: v[0] for k, v in j_tf.layer_tree(jp).items()}
    lp_t = transformer._layer(transformer.layer_tree(tp), 0)
    x = np.random.default_rng(1).standard_normal((2, 64, 64)).astype(
        np.float32)
    y_j, st_j = j_ssm.ssm_block(jnp.asarray(x), j_tf._ssm_params(lp_j), jc,
                                use_kernel=bool(use_kernel))
    y_t, st_t = ssm.ssm_block(torch.from_numpy(x), transformer._ssm_params(
        lp_t), tc, use_kernel=use_kernel)
    assert _rel(y_t, y_j) < 1e-5
    np.testing.assert_allclose(st_t.ssd.numpy(), np.asarray(st_j.ssd),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(st_t.conv.numpy(), np.asarray(st_j.conv),
                               atol=1e-6, rtol=0)


def test_ssm_block_routes_ragged_lengths_through_the_kernel_entry():
    """On a ragged length (S=100, chunk 32) the kernel's entry point takes
    the plain version on the CPU and agrees with the oracle (1e-5 *
    max|y|); the reference's kernel wrapper would assert here."""
    _, tc, _, tp = _params()
    lp = transformer._ssm_params(transformer._layer(
        transformer.layer_tree(tp), 1))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 100, 64)).astype(np.float32))
    y_k, s_k = ssm.ssm_block(x, lp, tc, use_kernel=True)
    y_o, s_o = ssm.ssm_block(x, lp, tc, use_kernel=False)
    assert _rel(y_k, y_o) < 1e-5
    assert float((s_k.ssd - s_o.ssd).abs().max()) < 1e-5


# -- forward and decode against the reference ---------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2.0 ** -5)])
def test_forward_logits_matches_reference(dtype, tol):
    """f32: within 1e-5 * max|logit| (measured 1.3e-6).  bf16: within
    2^-5 * max|logit| (measured 1.8e-2): the two frameworks round bf16 at
    different places over two layers of 100 tokens."""
    jc, tc, jp, tp = _params(dtype)
    toks = _tokens(2, 100, jc.vocab)
    want, aux_j = j_api.forward_logits(jp, {"tokens": jnp.asarray(toks)}, jc)
    got, aux_t = model_api.forward_logits(
        tp, {"tokens": torch.from_numpy(toks).long()}, tc)
    assert got.shape == want.shape and got.dtype == {
        "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert _rel(got, want) < tol
    assert float(aux_t["lb_loss"]) == float(aux_j["lb_loss"]) == 0.0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2.0 ** -5)])
def test_decode_step_matches_reference(dtype, tol):
    """Six decode steps from the empty state; logits of every step within
    the forward test's bound (measured f32 8.7e-7, bf16 1.4e-2), the final
    SSM state within the same bound relative to its max."""
    jc, tc, jp, tp = _params(dtype)
    sdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    toks = _tokens(2, 6, jc.vocab, seed=4)
    st_j = j_api.init_decode_state(jp, {}, jc, 2, 16, dtype=sdt[0])
    st_t = model_api.init_decode_state(tp, {}, tc, 2, 16, dtype=sdt[1])
    assert st_t.ssm_ssd.shape == st_j.ssm_ssd.shape
    assert st_t.ssm_conv.shape == st_j.ssm_conv.shape
    for t in range(6):
        lj, st_j = j_api.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), st_j,
                                     jc)
        lt, st_t = model_api.decode_step(
            tp, torch.from_numpy(toks[:, t:t + 1]).long(), st_t, tc)
        assert lt.shape == lj.shape and _rel(lt, lj) < tol
    assert st_t.index == int(st_j.index) == 6
    assert _rel(st_t.ssm_ssd, st_j.ssm_ssd) < tol


def test_decode_matches_forward():
    """Port of the reference's test_decode_matches_forward for mamba2:
    feeding tokens one by one through the SSM state reproduces the
    teacher-forced logits (f32 smoke config, 5e-3 * max|logit|)."""
    _, tc = _cfgs()
    tp = init_params(tc, torch.Generator().manual_seed(0), max_seq=16,
                     device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(B, S, tc.vocab)).long()
    fwd, _ = model_api.forward_logits(tp, {"tokens": toks}, tc)
    st = model_api.init_decode_state(tp, {"tokens": toks}, tc, B, S,
                                     dtype=torch.float32)
    step = serve.make_decode_step(tc)
    errs = []
    for t in range(S):
        logits, st = step(tp, toks[:, t:t + 1], st)
        errs.append(float((logits[:, 0] - fwd[:, t]).abs().max()))
    scale = float(fwd.abs().max()) + 1e-6
    assert max(errs) / scale < 5e-3


def test_collect_cache_final_state_equals_the_decode_state():
    """The prefill's stacked final SSM states (forward with collect_cache,
    on a ragged length through the kernel's entry point) against the state
    token-by-token decoding reaches: ssd and the conv window each within
    1e-5 of their max (measured 1e-6: later layers see a residual stream that
    differs in the last bits)."""
    _, tc, _, tp = _params()
    B, S = 2, 40
    toks = torch.from_numpy(_tokens(B, S, tc.vocab, seed=7)).long()
    logits, _, (k, v, cache) = transformer.forward(tp, toks, tc,
                                                   collect_cache=True)
    assert k is None and v is None
    L, H, P, N = tc.n_layers, tc.n_ssm_heads, tc.ssm.d_head, tc.ssm.d_state
    assert cache.ssd.shape == (L, B, H, P, N)
    st = model_api.init_decode_state(tp, {}, tc, B, S, dtype=torch.float32)
    for t in range(S):
        _, st = model_api.decode_step(tp, toks[:, t:t + 1], st, tc)
    want = st.ssm_ssd.reshape(L, B, H, P, N)
    assert float((cache.ssd - want).abs().max()) / float(want.abs().max()) \
        < 1e-5
    assert float((cache.conv - st.ssm_conv).abs().max()) \
        / float(st.ssm_conv.abs().max()) < 1e-5
    prefill = serve.make_prefill_step(tc)(tp, {"tokens": toks})
    assert torch.equal(prefill, logits)


@pytest.mark.parametrize("prompt_len", [3, 0])
def test_greedy_generate_equals_reference(prompt_len):
    """f32: the generated tokens equal the reference's, the empty prompt
    included (seeded with the BOS token 0)."""
    jc, tc, jp, tp = _params(seed=1)
    prompt = _tokens(2, prompt_len, jc.vocab, seed=2)
    want = j_serve.greedy_generate(jp, jc, jnp.asarray(prompt), max_new=5,
                                   seq_len=16)
    got = serve.greedy_generate(tp, tc, torch.from_numpy(prompt).long(),
                                max_new=5, seq_len=16)
    assert got.shape == (2, prompt_len + 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if prompt_len == 0:
        assert int(got[0, 0]) == 0


# -- the adaptive server --------------------------------------------------------

def test_adaptive_server_codes_and_scales_equal_the_reference():
    """The master codes and scales are byte-identical to the reference's
    ``quantize_tree_native`` on the same bf16 weights, and the passthrough
    params are the same tensors."""
    jc, tc, jp, tp = _params("bfloat16")
    jq = j_quantize(jp)
    srv = serve.AdaptiveLMServer(tp, tc)
    assert sorted(srv.qparams.codes) == sorted(jq.codes)
    assert sorted(srv.qparams.passthrough) == sorted(jq.passthrough)
    for k in jq.codes:
        assert np.array_equal(srv.qparams.codes[k].numpy(),
                              np.asarray(jq.codes[k])), k
        assert np.array_equal(srv.qparams.scales[k].numpy(),
                              np.asarray(jq.scales[k])), k
    assert srv.qparams.codes["layers/ssm/w_x"].shape[0] == tc.n_layers
    assert srv.qparams.scales["layers/ssm/w_x"].shape == \
        (1, 1, tc.d_inner)     # one scale per channel over all layers


def test_adaptive_server_switches_points_over_shared_codes():
    """Budgets 1.0/0.5/0.1 at thresholds 0.66/0.33 walk w8 -> w4 -> w2;
    weight bytes fall with the point; the master codes are the same tensors,
    unchanged, afterwards; every logit is finite and within 2^-5 *
    max|logit| of the reference server's (bf16 on both sides)."""
    jc, tc, jp, tp = _params("bfloat16", seed=1)
    points = [WorkingPoint(n, b) for n, b in POINTS]
    srv = serve.AdaptiveLMServer(
        tp, tc, points, RuntimePolicy(points, thresholds=[0.66, 0.33]))
    jpts = [JPoint(n, b) for n, b in POINTS]
    jsrv = j_serve.AdaptiveLMServer(jp, jc, jpts,
                                    JPolicy(jpts, thresholds=[0.66, 0.33]))
    codes = {k: v.clone() for k, v in srv.qparams.codes.items()}
    ids = {k: id(v) for k, v in srv.qparams.codes.items()}
    toks = _tokens(2, 1, jc.vocab, seed=3)
    st_t = model_api.init_decode_state(tp, {}, tc, 2, 16)
    st_j = j_api.init_decode_state(jp, {}, jc, 2, 16)
    seen, nbytes = [], []
    for budget in (1.0, 0.5, 0.1):
        lt, st_t, m = srv.decode(torch.from_numpy(toks).long(), st_t, budget)
        lj, st_j, mj = jsrv.decode(jnp.asarray(toks), st_j, budget)
        seen.append(m.point)
        nbytes.append(m.weight_bytes_read)
        assert m.point == mj.point and m.weight_bytes_read == \
            mj.weight_bytes_read
        assert torch.isfinite(lt.float()).all()
        assert _rel(lt, lj) < 2.0 ** -5
    assert seen == ["w8", "w4", "w2"]
    assert nbytes[0] > nbytes[1] > nbytes[2]
    assert {k: id(v) for k, v in srv.qparams.codes.items()} == ids
    assert all(torch.equal(codes[k], srv.qparams.codes[k]) for k in codes)


def test_quantize_tree_native_matches_reference_in_f32():
    jc, tc, jp, tp = _params("float32", seed=2)
    jq, tq = j_quantize(jp), quantize_tree_native(tp)
    for k in jq.codes:
        assert np.array_equal(tq.codes[k].numpy(), np.asarray(jq.codes[k]))
        assert np.array_equal(tq.scales[k].numpy(), np.asarray(jq.scales[k]))


def test_launch_serve_walks_the_points_on_the_cpu(capsys):
    switches = launch_serve.main(["--device", "cpu", "--steps", "12",
                                  "--batch", "2"])
    assert [p for _, p in switches] == ["w8", "w4", "w2"]
    assert "served 12 decode steps, 2 streams" in capsys.readouterr().out


@pytest.mark.parametrize("family", ["moe", "vlm", "audio"])
def test_every_family_initializes_and_runs_forward(family):
    """The MoE, vision-stub and encoder-decoder blocks on mamba2's smoke
    widths (its SSM swapped for the family's fields, as the refusal test
    these cases replace built them): the reference's weights carry over,
    and the f32 forward holds 1e-5 * max|logit| against the reference's,
    the MoE aux losses 1e-5 relative."""
    extra = {"moe": dict(moe=MoEConfig(4, 2, 32)),
             "vlm": dict(n_patches=4),
             # the reference's encoder-decoder always reads lm_head/w
             "audio": dict(enc_layers=2, enc_seq=16,
                           tie_embeddings=False)}[family]
    jc, tc = (dataclasses.replace(c, family=family, ssm=None, **extra)
              for c in _cfgs())
    jp = j_init(jc, jax.random.PRNGKey(2), max_seq=16)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    toks = _tokens(2, 16, tc.vocab, seed=2)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks).long()}
    rng = np.random.default_rng(3)
    if family == "audio":
        f = rng.standard_normal((2, 16, tc.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(f), torch.from_numpy(f)
    if family == "vlm":
        f = rng.standard_normal((2, 4, tc.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(f), torch.from_numpy(f)
    want, jaux = j_api.forward_logits(jp, jb, jc)
    got, aux = model_api.forward_logits(tp, tb, tc)
    assert got.shape == want.shape and _rel(got, want) < 1e-5
    for k in ("lb_loss", "z_loss"):
        if family == "moe":
            assert _rel(aux[k], jaux[k]) < 1e-5
        else:
            assert float(aux[k]) == float(jaux[k]) == 0.0


@pytest.mark.parametrize("fn", ["rmsnorm", "layernorm", "rope", "swiglu",
                                "gelu", "cross_entropy", "unembed"])
def test_common_blocks_match_reference(fn):
    """The building blocks copied from ``repro.models.common``, in f32,
    within 1e-6 relative (measured at most a few f32 ulps)."""
    from repro.models import common as jc
    from repro_torch.models import common as tc
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if fn == "rmsnorm":
        got, want = tc.rmsnorm(tx, tw), jc.rmsnorm(x, w)
    elif fn == "layernorm":
        got, want = tc.layernorm(tx, tw, tw), jc.layernorm(x, w, w)
    elif fn == "rope":
        pos = np.arange(5)
        cos, sin = tc.rope_angles(torch.from_numpy(pos), 16, 10000.0)
        jcos, jsin = jc.rope_angles(jnp.asarray(pos), 16, 10000.0)
        got, want = tc.apply_rope(tx, cos, sin), jc.apply_rope(x, jcos, jsin)
    elif fn == "swiglu":
        got, want = tc.swiglu(tx, tx * 2), jc.swiglu(x, x * 2)
    elif fn == "gelu":
        got, want = tc.gelu(tx), jc.gelu(x)
    elif fn == "cross_entropy":
        labels = rng.integers(0, 12, (2, 5, 4))
        got = tc.cross_entropy(tx, torch.from_numpy(labels), 12)
        want = jc.cross_entropy(x, jnp.asarray(labels), 12)
    else:
        table = rng.standard_normal((32, 16)).astype(np.float32)
        got = tc.unembed(tx, torch.from_numpy(table), True)
        want = jc.unembed(x, table, True)
        assert _rel(tc.unembed(tx, torch.from_numpy(table.T.copy()), False),
                    want) < 1e-6
    assert tuple(got.shape) == tuple(np.shape(want))
    assert _rel(got, want) < 1e-6
