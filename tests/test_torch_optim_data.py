"""The port's optimizer, token stream and gradient compression: the eight
tests of ``tests/test_optim_data.py`` under the port's mapping (the two
token-stream tests on the port's own draw, which is counter-based, not
jax's threefry), then parity with the reference on the same numpy inputs:
``apply_updates`` over five steps on bf16 and f32 parameters, decayed and
undecayed paths (moments within 1e-6 relative to each tensor's max, bf16
parameters bit for bit, f32 parameters within one f32 ulp of the update's
scale), ``schedule`` and ``global_norm``, and ``compress_tree`` with its
error feedback, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.quant import gradcomp as j_gradcomp

from repro_torch.data.tokens import DataConfig, TokenStream, batch_at
from repro_torch.optim.adamw import (OptConfig, apply_updates, global_norm,
                                     init_opt_state, schedule)
from repro_torch.quant import gradcomp


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.2, weight_decay=0.0, warmup_steps=1, total_steps=200,
                    clip_norm=100.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(params, grads, state, cfg)
    assert float(torch.max(torch.abs(params["w"]))) < 0.1


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    state = init_opt_state(params)
    cfg = OptConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0, warmup_steps=0,
                    total_steps=10)
    _, _, metrics = apply_updates(params, {"w": torch.full((3,), 1e6)},
                                  state, cfg)
    assert float(metrics["grad_norm"]) > 1e5  # raw norm reported


def test_schedule_warmup_and_cosine():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(schedule(cfg, 5)) < float(schedule(cfg, 10))
    assert abs(float(schedule(cfg, 10)) - 1.0) < 1e-6
    assert abs(float(schedule(cfg, 100)) - 0.1) < 1e-6


def test_weight_decay_skips_norms():
    params = {"a/norm/w": torch.ones(4), "a/w_up": torch.ones((2, 2))}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=10)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _ = apply_updates(params, zeros, state, cfg)
    assert torch.equal(p2["a/norm/w"], torch.ones(4))
    assert float(p2["a/w_up"][0, 0]) < 1.0  # decayed


def test_token_stream_cursor_resume():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2, seed=3)
    s1 = TokenStream(cfg, device="cpu")
    batches = [next(s1) for _ in range(5)]
    s2 = TokenStream.restore(cfg, {"step": 3, "seed": 3}, device="cpu")
    b3 = next(s2)
    assert torch.equal(b3["tokens"], batches[3]["tokens"])


def test_labels_are_next_tokens():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2, seed=3)
    b = batch_at(cfg, 0, "cpu")
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_gradcomp_error_feedback_unbiased():
    """With error feedback, the accumulated compressed sum tracks the true
    sum."""
    g_true = torch.randn((256,), generator=torch.Generator().manual_seed(0))
    err = torch.zeros((256,), dtype=torch.bfloat16)
    acc = torch.zeros((256,))
    for _ in range(50):
        deq, err = gradcomp.compress_decompress(g_true, err)
        acc = acc + deq
    rel = float(torch.linalg.norm(acc - 50 * g_true)
                / torch.linalg.norm(50 * g_true))
    assert rel < 0.01, rel


def test_gradcomp_tree():
    grads = {"a": torch.ones(8), "b": torch.full((4,), -2.0)}
    err = gradcomp.init_error_state(grads)
    g2, e2 = gradcomp.compress_tree(grads, err)
    assert set(g2) == set(grads)
    np.testing.assert_allclose(g2["a"].numpy(), 1.0, atol=0.02)


# -- parity with the reference on the same numpy inputs ------------------------

# decayed and undecayed paths (by suffix), 1-D to 3-D
SHAPES = {"layers/mlp/w_up": (2, 8, 16), "layers/attn_norm/w": (2, 8),
          "layers/attn/bq": (2, 16), "embed/table": (32, 8),
          "layers/ssm/A_log": (2, 4)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _to_torch(tree, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _to_jax(tree, dtype):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.view(torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_apply_updates_equals_the_reference_over_five_steps(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jcfg = j_adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    tp, jp = _to_torch(p0, tdt), _to_jax(p0, jdt)
    ts, js = init_opt_state(tp), j_adamw.init_opt_state(jp)
    for step in range(5):
        g = _tree(rng, scale=0.5)
        tp, ts, tm = apply_updates(tp, _to_torch(g, tdt), ts, cfg)
        jp, js, jm = j_adamw.apply_updates(jp, _to_jax(g, jdt), js, jcfg)
        assert int(ts.count) == int(js.count) == step + 1
        assert ts.count.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
        for k in SHAPES:
            for t, j in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
                j = np.asarray(j)
                assert t.dtype == torch.float32
                assert np.abs(t.numpy() - j).max() <= 1e-6 * np.abs(j).max()
            assert tp[k].dtype == tdt
            if dtype == "bfloat16":
                assert np.array_equal(_bits(tp[k]), _jbits(jp[k])), (step, k)
            else:
                # the update's scale is lr: within one f32 ulp of it
                d = np.abs(tp[k].numpy() - np.asarray(jp[k])).max()
                assert d <= np.spacing(np.float32(1.0)) * \
                    (np.abs(np.asarray(jp[k])).max() + 1e-2), (step, k, d)


def test_schedule_and_global_norm_equal_the_reference():
    cfg = OptConfig(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_frac=0.2)
    jcfg = j_adamw.OptConfig(lr=3e-4, warmup_steps=7, total_steps=40,
                             min_lr_frac=0.2)
    for step in (0, 1, 6, 7, 8, 20, 39, 40, 55):
        t = float(schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        j = float(j_adamw.schedule(jcfg, jnp.int32(step)))
        assert abs(t - j) <= 1e-6 * max(abs(j), 1e-12), step
    g = _tree(np.random.default_rng(1))
    t = float(global_norm(_to_torch(g, torch.float32)))
    j = float(j_adamw.global_norm(_to_jax(g, jnp.float32)))
    assert abs(t - j) <= 1e-6 * j


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_compress_tree_equals_the_reference_bit_for_bit(dtype):
    """The same gradients and residuals in -> the same dequantized gradients
    and bf16 residuals out, over three rounds of error feedback (ties of
    ``round`` included: some inputs sit exactly on half quanta)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(2)
    terr = gradcomp.init_error_state(
        {k: torch.zeros(s) for k, s in SHAPES.items()})
    jerr = j_gradcomp.init_error_state(
        {k: jnp.zeros(s) for k, s in SHAPES.items()})
    for _ in range(3):
        g = _tree(rng)
        # exact half quanta: x = (n + 0.5) * max/127 for some elements
        w = g["layers/mlp/w_up"].reshape(-1)
        w[:5] = (np.arange(5) + 0.5) * (np.abs(w).max() / 127.0)
        tg, terr = gradcomp.compress_tree(_to_torch(g, tdt), terr)
        jg, jerr = j_gradcomp.compress_tree(_to_jax(g, jdt), jerr)
        for k in SHAPES:
            assert tg[k].dtype == tdt and terr[k].dtype == torch.bfloat16
            assert np.array_equal(_bits(tg[k]), _jbits(jg[k])), k
            assert np.array_equal(_bits(terr[k]), _jbits(jerr[k])), k
