"""The one-token SSD update on flat channel shards, against
``ssd_decode_step``, the reference and the reference's dry-run.

Where the model axis does not divide the SSD heads (hymba-1.5b's 50 at
model 16), the decode state's flat (B, H*P, N) channel dim lies over
'model' in shards that cross head boundaries (200 channels a rank, heads
of 64).  ``ssm_decode`` then updates each rank's own channels
(``ssm._decode_on_channels`` over ``ssm.ssd_decode_channels``): dt, A and
D spread over their heads' channels, B and C whole, the state taken and
returned flat, y left on its channel shards.  No view of the state or of
y as heads gathers them over 'model'.

The rank-local update equals ``ssd_decode_step``'s new state bit for bit
on every channel shard, y within 1e-6 of its max |value| (the sum over N
may round otherwise at another shape); ``mesh=None``'s ``ssm_decode``
equals the reference's within 1e-5 of each max |value| (the LM tests' f32
tolerance), the weights carried over by ``params_from_jax``.

The dry-run, per rank on fake meshes, cut to 2 layers: hymba-1.5b
long_500k on 16x16 and 2x16x16 and decode_32k on 16x16 take the flat
route in both layers and have no all-gather site in ``ssm_step`` or
``ssm_decode`` itself, and long_500k all-gathers at most the reference's
bytes a rank (``scripts/dryrun_parity.py --reference-only`` in
subprocesses); mamba2-1.3b, whose 64 heads model 16 divides, keeps the
head route.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.models.params import init_params as j_init

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import ssm, transformer
from repro_torch.models.params import params_from_jax
from repro_torch.sharding import P, mesh_scope, place

from test_torch_distributed import REPO

# (B, H, P, N, tp): hymba-1.5b's heads at batch 1 (long_500k) and 8, the
# 2x4 tests' uneven cases (10 heads of 16, 2 heads of 64) over model 4
UPDATE_CASES = ((1, 50, 64, 16, 16), (8, 50, 64, 16, 16),
                (2, 10, 16, 16, 4), (2, 2, 64, 16, 4))
DRY_LAYERS = 2
# the reference's cells the dry-run tests hold the port's to: (cell, mesh)
REF_CELLS = (("hymba-1.5b:long_500k", "16x16"),
             ("hymba-1.5b:long_500k", "2x16x16"))


def _update_inputs(B, H, Pd, N, G, seed=0):
    """numpy-seeded (x (B,H,P), dt (B,H) > 0, A (H,) < 0, Bm/C (B,G,N),
    D (H,), state (B,H,P,N)) as f32 tensors."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return (t(rng.standard_normal((B, H, Pd))),
            t(np.log1p(np.exp(rng.standard_normal((B, H))))),
            t(-np.exp(rng.standard_normal(H))),
            t(rng.standard_normal((B, G, N))),
            t(rng.standard_normal((B, G, N))),
            t(rng.standard_normal(H)),
            t(rng.standard_normal((B, H, Pd, N))))


def _close(got, want, tol):
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("B,H,Pd,N,tp", UPDATE_CASES,
                         ids=["x".join(map(str, c)) for c in UPDATE_CASES])
def test_channel_update_equals_the_head_update_on_every_shard(B, H, Pd, N,
                                                              tp, G):
    """``ssd_decode_channels`` on each of ``tp`` channel shards (C / tp
    channels, crossing head boundaries where tp does not divide H), its
    per-head inputs spread over the channels and B/C one group's or each
    channel's group's: the new state is ``ssd_decode_step``'s bit for bit,
    y within 1e-6 of its max |value|."""
    x, dt, A, Bm, C, D, state = _update_inputs(B, H, Pd, N, G)
    y, new_state = ssm.ssd_decode_step(x, dt, A, Bm, C, D, state)
    Cn = H * Pd
    assert Cn % tp == 0
    y, new_state = y.reshape(B, Cn), new_state.reshape(B, Cn, N)
    xc, st = x.reshape(B, Cn), state.reshape(B, Cn, N)
    dtc = dt.repeat_interleave(Pd, 1)
    Ac, Dc = A.repeat_interleave(Pd), D.repeat_interleave(Pd)
    if G == 1:
        Bc, Cc = Bm[:, 0], C[:, 0]
    else:
        Bc, Cc = (t.repeat_interleave(Cn // G, 1) for t in (Bm, C))
    w = Cn // tp
    for r in range(tp):
        c = slice(r * w, (r + 1) * w)
        bc = (Bc, Cc) if G == 1 else (Bc[:, c], Cc[:, c])
        got_y, got_st = ssm.ssd_decode_channels(xc[:, c], dtc[:, c], Ac[c],
                                                *bc, Dc[c], st[:, c])
        assert torch.equal(got_st, new_state[:, c]), r
        _close(got_y, y[:, c], 1e-6)


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("G", [1, 2])
def test_channel_route_on_one_rank_matches_the_head_update(one_rank_mesh, G):
    """``_decode_on_channels`` (the spreads of dt, A, D and, for G > 1, of
    B/C, and the map over the state's channel shards) on a one-rank mesh:
    the flat new state is ``ssd_decode_step``'s bit for bit, y within 1e-6
    of its max |value|, both on the state's layout."""
    B, H, Pd, N = 2, 10, 16, 16
    x, dt, A, Bm, C, D, state = _update_inputs(B, H, Pd, N, G, seed=1)
    y, new_state = ssm.ssd_decode_step(x, dt, A, Bm, C, D, state)
    mesh = one_rank_mesh
    spec = P("data", "model", None)

    def put(t, *s):
        return place(t, mesh, P(*s))

    with torch.no_grad(), mesh_scope(mesh):
        got_y, got_st = ssm._decode_on_channels(
            mesh, put(x.reshape(B, -1), "data", None), put(dt, "data", None),
            put(A, None), put(Bm, "data", None, None),
            put(C, "data", None, None), put(D, None),
            put(state.reshape(B, H * Pd, N), *spec), Pd)
    assert tuple(got_st.placements) == tuple(
        place(state.reshape(B, H * Pd, N), mesh, spec).placements)
    assert torch.equal(got_st.full_tensor(), new_state.reshape(B, -1, N))
    _close(got_y.full_tensor(), y.reshape(B, -1), 1e-6)


@pytest.mark.parametrize("arch,d_model,d_head",
                         [("hymba-1.5b", 80, None),
                          ("mamba2-1.3b", None, 64)],
                         ids=["hymba-10-heads", "mamba2-2-heads"])
def test_mesh_none_decode_matches_the_reference(arch, d_model, d_head):
    """``mesh=None``'s ``ssm_decode`` on an f32 smoke config's layer
    (the 2x4 tests' uneven-head ones), the weights carried over from the
    reference's by ``params_from_jax``, a seeded token and seeded conv and
    SSD states: the output and both new states within 1e-5 of the
    reference's ``ssm_decode``'s max |value|."""
    def cfg_of(get):
        c = dataclasses.replace(get(arch).smoke(), dtype="float32",
                                n_layers=1)
        if d_model is not None:
            c = dataclasses.replace(c, d_model=d_model)
        if d_head is not None:
            c = dataclasses.replace(c, ssm=dataclasses.replace(
                c.ssm, d_head=d_head))
        return c

    jc, tc = cfg_of(j_get_config), cfg_of(get_config)
    jp = j_init(jc, jax.random.PRNGKey(3), max_seq=16)
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc,
                             "cpu")
    s = tc.ssm
    B, H = 2, tc.n_ssm_heads
    conv_dim = tc.d_inner + 2 * s.n_groups * s.d_state
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 1, tc.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, s.d_conv - 1, conv_dim)).astype(np.float32)
    ssd = rng.standard_normal((B, H, s.d_head, s.d_state)).astype(np.float32)
    jl = {k: v[0] for k, v in j_tf.layer_tree(jp).items()}
    want = j_ssm.ssm_decode(jnp.asarray(x), j_tf._ssm_params(jl), jc,
                            j_ssm.SSMState(ssd=jnp.asarray(ssd),
                                           conv=jnp.asarray(conv)))
    lp = transformer._layer(transformer.layer_tree(params), 0)
    got = ssm.ssm_decode(torch.from_numpy(x), transformer._ssm_params(lp), tc,
                         ssm.SSMState(ssd=torch.from_numpy(ssd),
                                      conv=torch.from_numpy(conv)))
    for g, w in ((got[0], want[0]), (got[1].ssd, want[1].ssd),
                 (got[1].conv, want[1].conv)):
        _close(g, torch.from_numpy(np.array(w, np.float32)), 1e-5)


# -- the dry-run -------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's :data:`REF_CELLS` cut to 2 layers, one subprocess a
    mesh, all started when the first test asks: ``get(cell, mesh)``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    procs = {(cell, mesh): subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "dryrun_parity.py"),
         "--reference-only", "--layers", str(DRY_LAYERS), f"--cell={cell}"]
        + (["--multi-pod"] if mesh == "2x16x16" else []),
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for cell, mesh in REF_CELLS}
    result = {}

    def get(cell: str, mesh: str):
        if (cell, mesh) not in result:
            proc = procs[(cell, mesh)]
            out, err = proc.communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.startswith("REF ")]
            assert proc.returncode == 0 and lines, err[-4000:]
            result[(cell, mesh)] = json.loads(lines[-1][4:])[cell]
        return result[(cell, mesh)]

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _trace(arch, shape, mesh_shape, monkeypatch):
    """The port's cell cut to 2 layers on a fake mesh, every site kept ->
    (traced, flat-route calls, head-route calls)."""
    calls = {"flat": 0, "heads": 0}

    def counting(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    for name, fn in (("flat", "_decode_on_channels"),
                     ("heads", "_decode_on_shards")):
        monkeypatch.setattr(ssm, fn, counting(name, getattr(ssm, fn)))
    cfg = dataclasses.replace(get_config(arch), n_layers=DRY_LAYERS)
    traced = D.trace_cell(cfg, get_shape(shape), mesh_shape, n_sites=None)
    return traced, calls["flat"], calls["heads"]


def _decode_gathers(traced):
    """The all-gather sites whose innermost model frame is ``ssm_step``
    (the state's head views) or ``ssm_decode`` and the flat route (y's
    head view, the update)."""
    own = ("ssm_step", "ssm_decode", "_decode_on_channels", "_spread")
    return [s for s in traced["sites"] if s["op"] == "all-gather"
            and s["site"].split(" < ")[0].split()[-1] in own]


@pytest.mark.parametrize("shape,mesh_shape",
                         [("long_500k", (16, 16)), ("long_500k", (2, 16, 16)),
                          ("decode_32k", (16, 16))],
                         ids=["long_500k-16x16", "long_500k-2x16x16",
                              "decode_32k-16x16"])
def test_hymba_decode_gathers_no_ssd_state(shape, mesh_shape, monkeypatch,
                                           reference_dryrun):
    """hymba-1.5b's decode at 2 layers on a fake mesh: the flat route in
    both layers, the head route in none, no all-gather at ``ssm_step`` or
    in ``ssm_decode``'s update, and at long_500k at most the reference's
    all-gather bytes a rank."""
    traced, flat, heads = _trace("hymba-1.5b", shape, mesh_shape,
                                 monkeypatch)
    assert (flat, heads) == (DRY_LAYERS, 0)
    assert not _decode_gathers(traced), _decode_gathers(traced)
    mesh = "x".join(map(str, mesh_shape))
    cell = f"hymba-1.5b:{shape}"
    if (cell, mesh) in REF_CELLS:
        got = traced["collective"].bytes_by_op.get("all-gather", 0.0)
        ref = reference_dryrun(cell, mesh)["all_gather"]
        assert got <= ref, (got, ref)


def test_mamba2_decode_keeps_the_head_route(monkeypatch):
    """mamba2-1.3b decode_32k at 2 layers on a fake (16, 16) mesh: its 64
    heads divide the model axis, so every layer takes the head route and
    none the flat one."""
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model"))
    assert not ssm.decodes_flat(get_config("mamba2-1.3b"), mesh)
    assert ssm.decodes_flat(get_config("hymba-1.5b"), mesh)
    _, flat, heads = _trace("mamba2-1.3b", "decode_32k", (16, 16),
                            monkeypatch)
    assert (flat, heads) == (0, DRY_LAYERS)
