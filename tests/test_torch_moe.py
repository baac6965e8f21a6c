"""The port's MoE block (``repro_torch.models.moe``) against the reference's
``repro.models.moe``: ``route``, ``aux_losses``, ``moe_shard_body`` and
``moe_block`` on inputs drawn with numpy from a seed, at the smoke config's
widths (d = 64, expert d_ff = 32) and at granite's 40 experts top-8.

The cases reach every branch of the capacity dispatch: capacity dropping
(an expert routed more slots than ``cap``; at ``capacity_factor`` 0.5 more
slots than all experts' capacity), a clamped start (the last expert's
segment shorter than ``cap``), an expert no token chose, decode calls of
T = 1 and T = B tokens, and one model rank's share of sharded weights.
Each case states what it reaches and asserts it did.

The routing decisions are held equal exactly: the chosen experts, and each
expert's gathered rows (the tokens it kept, in slot order, dropped slots
zeroed), captured where both packages call ``_expert_ffn``.  Tolerances:
the router logits and probabilities and the aux losses within 1e-6
relative (f32 on both sides, the same inputs); the block's output within
1e-5 * max|y| in f32 and 2^-7 * max|y| in bf16 (measured below each).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as j_moe

from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.params import moe_factors

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _cfgs(n_experts=4, top_k=2, capacity_factor=1.0):
    """The reference's and the port's granite smoke config with the MoE
    fields set."""
    out = []
    for get in (j_get_config, get_config):
        c = get("granite-moe-3b-a800m").smoke()
        out.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, n_experts=n_experts, top_k=top_k,
            capacity_factor=capacity_factor)))
    return out


def _weights(cfg, seed, tp_total=1, column=None):
    """Numpy arrays of one layer's MoE params in the layout of
    ``param_shapes``; ``column`` = (expert, value) sets that expert's router
    column to one value: with positive x, -10 makes an expert no token
    chooses, -0.1/sqrt(d) one that few tokens choose."""
    m = cfg.moe
    ep, tp = moe_factors(m.n_experts, tp_total)
    el, fl = m.n_experts // ep, m.d_ff_expert // tp
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    router = rng.standard_normal((d, m.n_experts)).astype(np.float32) * d ** -0.5
    if column is not None:
        router[:, column[0]] = column[1]
    wg = rng.standard_normal((tp_total, el, d, fl)).astype(np.float32) * d ** -0.5
    wu = rng.standard_normal((tp_total, el, d, fl)).astype(np.float32) * d ** -0.5
    wd = rng.standard_normal((tp_total, el, fl, d)).astype(np.float32) * fl ** -0.5
    return router, wg, wu, wd


def _params(arrays, dtype, rank=None):
    """Both packages' MoELayerParams over the same values; ``rank`` keeps
    that rank's block (1, E/ep, ...), as shard_map hands it to the body."""
    if rank is not None:
        arrays = (arrays[0],) + tuple(a[rank:rank + 1] for a in arrays[1:])
    jp = j_moe.MoELayerParams(*(jnp.asarray(a, JDT[dtype]) for a in arrays))
    tp = moe.MoELayerParams(*(torch.from_numpy(a).to(TDT[dtype])
                              for a in arrays))
    return jp, tp


def _x(T, d, seed, dtype, positive=False):
    x = np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)
    if positive:
        x = np.abs(x)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _spy(monkeypatch, module, seen):
    """Record every ``_expert_ffn`` input of ``module`` (as f32 numpy)."""
    ffn = module._expert_ffn

    def spy(xe, wg, wu, wd):
        seen.append(_np(xe))
        return ffn(xe, wg, wu, wd)

    monkeypatch.setattr(module, "_expert_ffn", spy)


def _cap(cfg, T):
    m = cfg.moe
    return min(max(int(np.ceil(T * m.top_k * m.capacity_factor
                               / m.n_experts)), 1), T)


# -- route and the aux losses ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,E,k", [(1, 4, 2), (4, 8, 2), (37, 4, 2),
                                   (64, 40, 8)])
def test_route_matches_reference(T, E, k, dtype):
    """The chosen experts equal exactly; logits and probabilities within
    1e-6 relative."""
    jc, tc = _cfgs(E, k)
    arrays = _weights(tc, seed=T)
    jp, tp = _params(arrays, dtype)
    jx, tx = _x(T, tc.d_model, seed=T + 1, dtype=dtype)
    jprobs, jexp, jlog = j_moe.route(jx, jp.router, k)
    probs, exp, logits = moe.route(tx, tp.router, k)
    assert exp.shape == (T, k) and exp.dtype == torch.int64
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))
    assert probs.dtype == logits.dtype == torch.float32
    assert _rel(logits, jlog) < 1e-6 and _rel(probs, jprobs) < 1e-6


def test_route_breaks_ties_to_the_lower_index():
    """Equal logits (duplicated router columns, small integers so every dot
    product is exact): the lower expert index comes first, as in
    ``jax.lax.top_k``, at every k."""
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (32, 8)).astype(np.float32)
    cols = rng.integers(-3, 4, (8, 3)).astype(np.float32)
    router = cols[:, [0, 1, 0, 2, 1, 0, 2, 1]]          # E = 8, 3 distinct
    for k in (1, 2, 3, 5, 8):
        _, jexp, _ = j_moe.route(jnp.asarray(x), jnp.asarray(router), k)
        _, exp, _ = moe.route(torch.from_numpy(x), torch.from_numpy(router), k)
        np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))
    logits = x @ router
    assert (logits[:, 0] == logits[:, 2]).all()            # ties did occur


@pytest.mark.parametrize("T,E,k", [(1, 4, 2), (16, 4, 2), (64, 40, 8)])
def test_aux_losses_match_reference(T, E, k):
    """The load-balance and z losses within 1e-6 relative, on the
    reference's own routing of the same inputs."""
    jc, tc = _cfgs(E, k)
    jp, tp = _params(_weights(tc, seed=5), "float32")
    jx, tx = _x(T, tc.d_model, seed=6, dtype="float32")
    _, jexp, jlog = j_moe.route(jx, jp.router, k)
    jlb, jz = j_moe.aux_losses(jlog, jexp, E)
    lb, z = moe.aux_losses(torch.from_numpy(np.array(jlog)),
                           torch.from_numpy(np.array(jexp)).long(), E)
    assert lb.dtype == z.dtype == torch.float32 and lb.shape == ()
    assert _rel(lb, jlb) < 1e-6 and _rel(z, jz) < 1e-6


# -- the capacity dispatch --------------------------------------------------------

# (name, T, E, k, capacity_factor, tp_total, rank, router column, positive x)
CASES = [
    ("drop", 16, 4, 2, 1.0, 1, None, None, False),
    ("over_capacity", 16, 4, 2, 0.5, 1, None, None, False),
    ("clamp", 24, 4, 2, 1.0, 1, None, (3, -0.0125), True),
    ("empty_expert", 16, 4, 2, 1.0, 1, None, (1, -10.0), True),
    ("decode_T1", 1, 4, 2, 1.0, 1, None, None, False),
    ("decode_TB", 4, 8, 2, 1.0, 1, None, None, False),
    ("granite_40x8", 24, 40, 8, 1.0, 1, None, None, False),
    ("cf8_no_drop", 16, 4, 2, 8.0, 1, None, None, False),
    ("rank_share", 16, 4, 2, 1.0, 2, 1, None, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_shard_body_matches_reference(monkeypatch, case, dtype):
    """Every expert's gathered rows equal the reference's exactly (so the
    same tokens kept in the same order, the same slots dropped); the output
    within 1e-5 * max|y| in f32 (measured at most 3.3e-7) and 2^-7 in bf16
    (measured 0: equal on this box); lb and z within 1e-6 relative
    (measured at most 2.1e-7)."""
    name, T, E, k, cf, tp_total, rank, column, positive = case
    jc, tc = _cfgs(E, k, cf)
    arrays = _weights(tc, seed=T + E, tp_total=tp_total, column=column)
    jp, tp = _params(arrays, dtype, rank=rank)
    jx, tx = _x(T, tc.d_model, seed=T + 7, dtype=dtype, positive=positive)
    r = 0 if rank is None else rank
    j_seen, t_seen = [], []
    _spy(monkeypatch, j_moe, j_seen)
    _spy(monkeypatch, moe, t_seen)
    jy, jlb, jz = j_moe.moe_shard_body(jx, jp, jc, tp_total, r)
    y, lb, z = moe.moe_shard_body(tx, tp, tc, tp_total, r)

    ep, _ = moe_factors(E, tp_total)
    assert len(t_seen) == len(j_seen) == E // ep
    for j, (a, b) in enumerate(zip(t_seen, j_seen)):
        assert a.shape == b.shape == (_cap(tc, T), tc.d_model)
        np.testing.assert_array_equal(a, b, err_msg=f"expert {j}")
    assert y.shape == (T, tc.d_model) and y.dtype == TDT[dtype]
    assert _rel(y, jy) < OUT_TOL[dtype]
    assert _rel(lb, jlb) < 1e-6 and _rel(z, jz) < 1e-6

    # what the case reaches, read from the routing both packages agreed on
    _, exp, _ = moe.route(tx, tp.router, k)
    counts = np.bincount(exp.numpy().reshape(-1), minlength=E)
    cap = _cap(tc, T)
    kept = sum(int((s != 0).any(axis=1).sum()) for s in t_seen)
    if name in ("drop", "over_capacity", "granite_40x8"):
        assert counts.max() > cap and kept < T * k
    if name == "over_capacity":
        assert T * k > E * cap
    if name == "clamp":
        assert 0 < counts[-1] < cap                 # start clamped to n - cap
    if name == "empty_expert":
        assert counts[1] == 0 and not t_seen[1].any()
    if name == "decode_TB":
        assert cap == 1
    if name == "cf8_no_drop":
        assert cap == T and kept == T * k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_reference(dtype):
    """``moe_block`` on (B, S, d) against the reference's one-device path
    (``mesh=None``), within the body's tolerance."""
    jc, tc = _cfgs()
    jp, tp = _params(_weights(tc, seed=11), dtype)
    x = np.random.default_rng(12).standard_normal((2, 8, tc.d_model)).astype(
        np.float32)
    jy, jlb, jz = j_moe.moe_block(jnp.asarray(x, JDT[dtype]), jp, jc, None, 1)
    y, lb, z = moe.moe_block(torch.from_numpy(x).to(TDT[dtype]), tp, tc)
    assert y.shape == (2, 8, tc.d_model)
    assert _rel(y, jy) < OUT_TOL[dtype]
    assert _rel(lb, jlb) < 1e-6 and _rel(z, jz) < 1e-6


def test_moe_block_refuses_weights_stored_for_more_ranks():
    """Expert weights laid out for two model ranks need a mesh with two
    ranks on 'model' (``ValueError`` without one, or on a one-rank mesh);
    on a one-rank (1, 1) mesh (``make_local_mesh`` starts a gloo group in
    this process) the sharded path runs the body on its local shards and
    equals the one-device block bit for bit.  (Two and more model ranks:
    ``tests/test_torch_distributed.py``.)"""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_local_mesh
    _, tc = _cfgs()
    _, tp2 = _params(_weights(tc, seed=13, tp_total=2), "float32")
    with pytest.raises(ValueError, match="mesh"):
        moe.moe_block(torch.zeros((1, 4, tc.d_model)), tp2, tc)
    _, tp = _params(_weights(tc, seed=11), "float32")
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 8, tc.d_model)).astype(np.float32))
    want = moe.moe_block(x, tp, tc)
    mesh = make_local_mesh(device="cpu")
    try:
        rep = [Replicate(), Replicate()]
        with pytest.raises(ValueError, match="2 model ranks"):
            moe.moe_block(distribute_tensor(x, mesh, rep),
                          moe.MoELayerParams(*(distribute_tensor(w, mesh, rep)
                                               for w in tp2)), tc, mesh)
        got = moe.moe_block(distribute_tensor(x, mesh, rep),
                            moe.MoELayerParams(*(distribute_tensor(w, mesh, rep)
                                                 for w in tp)), tc, mesh)
        for g, w in zip(got, want):
            assert torch.equal(g.full_tensor(), w)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_runs_under_fake_tensor_mode(dtype):
    """The block traces on fake tensors (the dry-run's mode, real tensors
    refused): its per-expert counts have a fixed size, where
    ``torch.bincount``'s depends on the data and raises there.  Outputs
    have the block's shapes and dtypes; nothing is computed."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    _, tc = _cfgs()
    shapes = [a.shape for a in _weights(tc, seed=11)]
    with FakeTensorMode(allow_non_fake_inputs=False):
        p = moe.MoELayerParams(*(torch.empty(s, dtype=TDT[dtype])
                                 for s in shapes))
        x = torch.empty((2, 8, tc.d_model), dtype=TDT[dtype])
        y, lb, z = moe.moe_block(x, p, tc)
    assert isinstance(y, FakeTensor)
    assert y.shape == (2, 8, tc.d_model) and y.dtype == TDT[dtype]
    assert lb.shape == () and z.shape == ()
    assert lb.dtype == torch.float32 and z.dtype == torch.float32
