"""The Mamba-2 mixer on each rank's own channels, against ``mesh=None``,
the reference and the reference's dry-run.

``ssm_block`` and ``ssm_decode`` convolve the x channels and the B/C
channels apart (``ssm._conv_channels``): the x channels stay on ``w_x``'s
model-sharded layout from the projection to the scan, and no (B, S, .)
activation is gathered for the conv.  Where the model axis does not
divide the SSD heads, ``ssm_block`` pads them with zero heads to a
multiple of it (``ssm.ssd_heads``, ``ssm._pad_heads``), as the reference
does.  Five small f32 configs whose conv weight's shard boundaries do not
fall on d_inner: mamba2's smoke config (8 heads on model 4, 160 conv
channels, 40 a rank against d_inner = 128), the same 80 wide (10 heads,
padded to 12: 3 a rank), the same with heads of 64 (2 heads, padded to
4: one a rank, where unpadded ranks 2 and 3 would hold none), hymba's
(the SSM half beside attention, 8 heads) and hymba's 80 wide (10 heads).
On 2x4 gloo ranks (the helpers of ``test_torch_distributed.py``) the
prefill, six decode steps and the loss and gradients of the train step
equal ``mesh=None``'s within 1e-5 of each max |value|, the conv states
too and the first layer's bit for bit (a copy of inputs that later
layers receive with the partial sums of the layers before reordered);
the prefill also equals the reference's within 1e-5 of its max |logit|
(the LM tests' f32 tolerance), the weights carried over by
``params_from_jax``; the three cases whose heads model 4 does not
divide decode on flat channel shards (``ssm._decode_on_channels``) in
every layer, the other two on whole heads.  On a one-rank mesh every one
of them is ``mesh=None``'s bit for bit (``mesh=None`` convolves the two parts as
one, as before; one rank pads no head).  The padding alone, for 2, 10
and 50 heads over 4 and 16 ranks: at least one head a rank, zero outputs
and states in the padded heads, the real heads' block output that of the
unpadded block.

The dry-run, per rank on a fake (16, 16) mesh, cut to 2 layers:
mamba2-1.3b prefill_32k and hymba-1.5b train_4k (50 heads padded to 64)
all-gather at most the reference's bytes a rank
(``scripts/dryrun_parity.py --reference-only`` in a subprocess), and no
all-gather site in ``models/ssm.py`` moves as much as one rank's (B_l, S,
d_inner / 16) bf16 x activation; mamba2's peaks at most the reference's
argument + temp bytes a rank.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.models.params import init_params as j_init
from repro.runtime import model_api as j_api

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import ssm
from repro_torch.models.common import rmsnorm
from repro_torch.models.params import params_from_jax

from test_torch_distributed import REPO, _run_ranks

# (case, arch, d_model or None for the smoke config's, SSD head width or
# None for the smoke config's)
CASES = (("mamba2", "mamba2-1.3b", None, None),
         ("mamba2-uneven-heads", "mamba2-1.3b", 80, None),
         ("mamba2-two-heads", "mamba2-1.3b", None, 64),
         ("hymba", "hymba-1.5b", None, None),
         ("hymba-uneven-heads", "hymba-1.5b", 80, None))
B, S = 2, 64
DRY_LAYERS = 2
# the reference's dry-run cells the tests below hold the port's to
DRY_CELLS = ("mamba2-1.3b:prefill_32k", "hymba-1.5b:train_4k")


def _cfg(get, arch: str, d_model, d_head=None):
    """The f32 smoke config, ``d_model`` wide and with SSD heads
    ``d_head`` wide if given."""
    import dataclasses
    c = dataclasses.replace(get(arch).smoke(), dtype="float32")
    if d_model is not None:
        c = dataclasses.replace(c, d_model=d_model)
    if d_head is not None:
        c = dataclasses.replace(c, ssm=dataclasses.replace(c.ssm,
                                                           d_head=d_head))
    return c


def _inputs(arch: str, d_model, d_head=None, seed: int = 0):
    """(port config, port params carried from the reference's, tokens,
    labels, the reference's f32 logits)."""
    jc = _cfg(j_get_config, arch, d_model, d_head)
    tc = _cfg(get_config, arch, d_model, d_head)
    jp = j_init(jc, jax.random.PRNGKey(seed), max_seq=S)
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc,
                             "cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    want, _ = j_api.forward_logits(jp, {"tokens": toks}, jc)
    return (tc, params, torch.from_numpy(toks).long(),
            torch.from_numpy(np.roll(toks, -1, 1)).long(),
            torch.from_numpy(np.array(want)))


def _run(params, toks, labels, cfg, mesh=None):
    """-> (prefill logits, prefill conv states (L, B, K-1, conv_dim), the
    decode steps' logits, the last decode state, the loss and the
    gradients), the inputs placed on ``mesh`` if given (the parameters by
    the sharding rules, the decode state by ``decode_state_shardings``).
    The decode steps run again donated from an equal state: every step's
    logits and the last state equal the undonated ones bit for bit, and
    every step returns the state's own storages (a rank's own shards on a
    mesh), which so hold each new slot and SSM state.  Self-contained:
    the rank processes run its source."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.models import transformer
    from repro_torch.runtime import model_api, serve
    from repro_torch.runtime.train import _grads_of
    from repro_torch.sharding import (batch_spec, mesh_scope, param_sharding,
                                      place, place_tree)
    B, SMAX, STEPS = toks.shape[0], 16, 6
    batch = {"tokens": toks, "labels": labels}
    if mesh is not None:
        params = place_tree(params, param_sharding(params, mesh))
        batch = {k: place(v, mesh, batch_spec(mesh, None))
                 for k, v in batch.items()}
    with torch.no_grad(), mesh_scope(mesh):
        logits, _, (_, _, st) = transformer.forward(
            params, batch["tokens"], cfg, mesh=mesh, collect_cache=True)
        states = []
        for _ in range(2):
            s0 = model_api.init_decode_state(params, {}, cfg, B, SMAX,
                                             torch.float32)
            if mesh is not None:
                s0 = place_tree(s0, serve.decode_state_shardings(
                    cfg, s0, mesh))
            states.append(s0)
        state, donated = states

        def storages(s0):
            return [(t.to_local() if isinstance(t, DTensor) else t
                     ).untyped_storage().data_ptr()
                    for t in s0 if isinstance(t, torch.Tensor)]

        def whole(x):
            return x.full_tensor() if isinstance(x, DTensor) else x

        held = storages(donated)
        steps = []
        for t in range(STEPS):
            tok = batch["tokens"][:, t:t + 1]
            out, state = model_api.decode_step(params, tok, state, cfg,
                                               mesh=mesh)
            steps.append(out)
            out, donated = model_api.decode_step(params, tok, donated, cfg,
                                                 mesh=mesh, donate=True)
            assert storages(donated) == held, t
            assert torch.equal(whole(out), whole(steps[-1])), t
        for got, want in zip(donated, state):
            if isinstance(want, torch.Tensor):
                assert torch.equal(whole(got), whole(want))
            else:
                assert got == want
    with mesh_scope(mesh):          # as the train step runs it
        metrics, grads = _grads_of(params, batch, cfg, remat=False,
                                   mesh=mesh)
    return logits, st.conv, steps, state, metrics["loss"], grads


def _full(t):
    """A DTensor's global value; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


# -- 2x4 gloo ranks ---------------------------------------------------------------

@pytest.mark.parametrize("case,arch,d_model,d_head", CASES,
                         ids=[c[0] for c in CASES])
def test_ssm_on_2x4_ranks_matches_one_device(tmp_path, case, arch, d_model,
                                             d_head):
    """The mesh prefill, six decode steps and the train step's loss and
    gradients within 1e-5 of ``mesh=None``'s max |value|; the conv states
    (prefill and decode) too, the first layer's bit for bit; the prefill
    logits within 1e-5 of the reference's max |logit|.  Every decode layer
    of the cases whose heads model 4 does not divide takes the flat
    channel route (``ssm._decode_on_channels``), donated or not, and no
    layer of the others does; the donated decode equals the undonated one
    bit for bit on the state's own shards (``_run``)."""
    cfg, params, toks, labels, ref = _inputs(arch, d_model, d_head)
    conv_dim = cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    assert conv_dim % 4 == 0 and cfg.d_inner % (conv_dim // 4)
    want = _run(params, toks, labels, cfg)
    err = float((want[0] - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err
    g = torch.Generator().manual_seed(5)
    K = cfg.ssm.d_conv
    w = torch.randn(K, conv_dim, generator=g)
    st = torch.randn(B, K - 1, conv_dim, generator=g)
    # a prefill of 9 steps and a decode step
    conv_inputs = [torch.randn(B, n, conv_dim, generator=g) for n in (9, 1)]
    conv_want = [ssm._conv_channels(u[..., :cfg.d_inner],
                                    u[..., cfg.d_inner:], w, st, cfg, None)
                 for u in conv_inputs]
    torch.save({"params": params, "toks": toks, "labels": labels,
                "want": want, "conv_inputs": conv_inputs, "conv_w": w,
                "conv_state": st, "conv_want": conv_want},
               tmp_path / "in.pt")
    helpers = "".join(textwrap.dedent(inspect.getsource(f)) + "\n"
                      for f in (_cfg, _run, _full))
    out = _run_ranks(tmp_path, 8, helpers + textwrap.dedent(f"""
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import compat_make_mesh
        d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
        cfg = _cfg(get_config, {arch!r}, {d_model!r}, {d_head!r})
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        from repro_torch.models import ssm
        flat, route = [], ssm._decode_on_channels

        def counted(*a, **k):
            flat.append(1)
            return route(*a, **k)

        ssm._decode_on_channels = counted
        got = _run(d["params"], d["toks"], d["labels"], cfg, mesh)
        want = d["want"]
        # every layer of the undonated and of the donated decode steps
        assert len(flat) == (2 * len(got[2]) * cfg.n_layers
                             if cfg.n_ssm_heads % 4 else 0), len(flat)

        def close(g, w, what):
            g = _full(g)
            err = float((g - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()), (what, err)

        close(got[0], want[0], "prefill")
        close(got[1], want[1], "prefill conv state")
        for t, (g, w) in enumerate(zip(got[2], want[2])):
            close(g, w, ("decode", t))
        close(got[3].ssm_conv, want[3].ssm_conv, "decode conv state")
        close(got[3].ssm_ssd, want[3].ssm_ssd, "ssd state")
        close(got[4], want[4], "loss")
        for k, w in want[5].items():
            g = _full(got[5][k])
            err = float((g - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()) + 1e-12, (k, err)
        # the conv alone, on the same inputs: its new state (a copy of its
        # inputs) is the one-device one bit for bit, its outputs within 1e-6
        # of their max (the CPU's vectorised silu rounds an element by its
        # place in the tensor, which a shard moves)
        from repro_torch.models import ssm
        from repro_torch.sharding import P, mesh_scope, place
        for u, st in zip(d["conv_inputs"], d["conv_want"]):
            di = cfg.d_inner
            shard = P("data", None, "model")
            with mesh_scope(mesh):
                out = ssm._conv_channels(
                    place(u[..., :di], mesh, shard),
                    place(u[..., di:], mesh, shard),
                    place(d["conv_w"], mesh, P(None, "model")),
                    place(d["conv_state"], mesh, P("data", None, None)),
                    cfg, mesh)
            steps = u.shape[1]
            assert torch.equal(_full(out[2]), st[2]), ("conv state", steps)
            for g, w in zip(out[:2], st[:2]):
                err = float((_full(g) - w).abs().max())
                assert err <= 1e-6 * float(w.abs().max()), ("conv", steps,
                                                            err)
        if RANK == 0:
            print("OK ssm sharding")
    """))
    assert "OK ssm sharding" in out


# -- one rank: bit for bit ---------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("case,arch,d_model,d_head", CASES,
                         ids=[c[0] for c in CASES])
def test_ssm_on_one_rank_is_bit_for_bit(one_rank_mesh, case, arch, d_model,
                                        d_head):
    """At (1, 1) the prefill, its conv states, the decode steps and state,
    and the loss and every gradient equal ``mesh=None``'s bit for bit."""
    cfg, params, toks, labels, _ = _inputs(arch, d_model, d_head, seed=2)
    want = _run(params, toks, labels, cfg)
    got = _run(params, toks, labels, cfg, one_rank_mesh)
    assert torch.equal(_full(got[0]), want[0])
    assert torch.equal(_full(got[1]), want[1])
    for g, w in zip(got[2], want[2]):
        assert torch.equal(_full(g), w)
    for g, w in zip(got[3][:-1], want[3][:-1]):
        if w is not None:
            assert torch.equal(_full(g), w)
    assert torch.equal(_full(got[4]), want[4])
    for k, w in want[5].items():
        assert torch.equal(_full(got[5][k]), w), k


@pytest.mark.parametrize("steps", [1, 2, 3, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv_state_is_the_convs_own(steps, with_state):
    """``ssm._conv_state``, which rejoins the new state on a mesh from the
    inputs' last K-1 steps, equals the state ``_causal_conv`` returns bit
    for bit: shorter inputs than K-1 steps keep the old state's tail."""
    g = torch.Generator().manual_seed(steps)
    K, C = 4, 12
    u = torch.randn(2, steps, C, generator=g)
    state = torch.randn(2, K - 1, C, generator=g) if with_state else None
    _, want = ssm._causal_conv(u, torch.randn(K, C, generator=g), state)
    assert torch.equal(ssm._conv_state(u, state, K), want)


@pytest.mark.parametrize("tp", [4, 16])
@pytest.mark.parametrize("n_heads", [2, 10, 50])
def test_padded_heads_are_zero_and_leave_the_real_ones(n_heads, tp):
    """``ssd_heads`` gives every one of ``tp`` model ranks the same number
    of whole heads, at least one; ``_pad_heads`` appends zero heads to
    every head-indexed leaf.  Through the block's steps (projections, the
    x conv with its columns padded as ``_conv_channels`` pads them, the
    scan, the gated norm over the d_inner real channels, the
    out-projection) the padded heads' x, outputs and final states are
    exactly zero, the real heads' outputs and states those of the
    unpadded block within 1e-6 of their max, and the block's output too."""
    Hp = ssm.ssd_heads(n_heads, tp)
    assert Hp % tp == 0 and Hp // tp >= 1 and 0 <= Hp - n_heads < tp
    Pd, N, K = 4, 8, 4
    base = get_config("mamba2-1.3b").smoke()
    cfg = dataclasses.replace(
        base, dtype="float32", d_model=n_heads * Pd // 2,
        ssm=dataclasses.replace(base.ssm, d_head=Pd, d_state=N, chunk=8,
                                d_conv=K))
    d, di, H = cfg.d_model, cfg.d_inner, n_heads
    assert cfg.n_ssm_heads == H
    g = torch.Generator().manual_seed(H * tp)

    def rnd(*shape, scale=0.5):
        return scale * torch.randn(*shape, generator=g)

    p = ssm.SSMLayerParams(
        w_z=rnd(d, di), w_x=rnd(d, di), w_bc=rnd(d, 2 * N), w_dt=rnd(d, H),
        conv=rnd(K, di + 2 * N), A_log=rnd(H), D=rnd(H), dt_bias=rnd(H),
        norm_w=1 + rnd(di), w_out=rnd(di, d))
    pp = ssm._pad_heads(p, cfg, Hp, None)
    pad = (Hp - H) * Pd
    for name, dim, n in (("w_z", 1, di), ("w_x", 1, di), ("w_dt", 1, H),
                         ("A_log", 0, H), ("D", 0, H), ("dt_bias", 0, H),
                         ("norm_w", 0, di), ("w_out", 0, di)):
        got, leaf = getattr(pp, name), getattr(p, name)
        assert got.shape[dim] == n + (pad if n == di else Hp - H), name
        assert torch.equal(got.narrow(dim, 0, n), leaf), name
        assert not got.narrow(dim, n, got.shape[dim] - n).any(), name
    x = rnd(2, 20, d, scale=1.0)

    def block(q, heads, n_real):
        """ssm_block's steps on ``heads`` heads, ``n_real`` of them real."""
        z, xv, bc, dt = ssm._project_in(x, q)
        wx = q.conv[:, :di]
        if heads * Pd > di:
            wx = ssm._zero_pad(wx, -1, heads * Pd - di, None)
        xi = ssm._causal_conv(xv, wx)[0]
        BC = ssm._causal_conv(bc, q.conv[:, di:])[0]
        dt = torch.nn.functional.softplus(dt + q.dt_bias)
        y, st = ssm.ssd_chunked(xi.reshape(2, 20, heads, Pd), dt,
                                -torch.exp(q.A_log),
                                BC[..., :N].reshape(2, 20, 1, N),
                                BC[..., N:].reshape(2, 20, 1, N), q.D, 8)
        yf = y.reshape(2, 20, heads * Pd)
        out = rmsnorm(yf * torch.nn.functional.silu(z), q.norm_w,
                      n=None if heads == n_real else di) @ q.w_out
        return xi, y, st, out

    xi0, y0, st0, out0 = block(p, H, H)
    xi1, y1, st1, out1 = block(pp, Hp, H)
    assert not xi1[..., di:].any()
    assert not y1[:, :, H:].any() and not st1[:, H:].any()

    def close(a, b):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())

    close(y1[:, :, :H], y0)
    close(st1[:, :H], st0)
    close(out1, out0)


# -- the dry-run against the reference's -----------------------------------------

@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's :data:`DRY_CELLS` cut to 2 layers, each compiled in
    a subprocess of its own, all started when the first test asks for
    one: ``get(arch)`` waits for that arch's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    procs = {cell.split(":")[0]: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "dryrun_parity.py"),
         "--reference-only", "--layers", str(DRY_LAYERS), f"--cell={cell}"],
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for cell in DRY_CELLS}
    result = {}

    def get(arch: str):
        if arch not in result:
            proc = procs[arch]
            out, err = proc.communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.startswith("REF ")]
            assert proc.returncode == 0 and lines, err[-4000:]
            result.update(json.loads(lines[-1][4:]))
        return result[arch]

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _ssm_gathers(traced, shape, cfg):
    """The all-gather sites in ``models/ssm.py`` of a trace made with
    every site kept, each checked to move (per call) less than a rank's
    (B_l, S, d_inner / 16) bf16 x activation."""
    x_shard = shape.global_batch // 16 * shape.seq_len * cfg.d_inner // 16 * 2
    sites = [s for s in traced["sites"]
             if s["op"] == "all-gather" and "models/ssm.py" in s["site"]]
    for s in sites:
        assert s["wire_bytes"] / s["count"] < x_shard, s
    return sites


@pytest.fixture(scope="module")
def mamba2_prefill():
    """mamba2-1.3b prefill_32k at 2 layers traced on a fake (16, 16) mesh,
    every collective site kept -> (cfg, shape, traced)."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=DRY_LAYERS)
    shape = get_shape("prefill_32k")
    return cfg, shape, D.trace_cell(cfg, shape, (16, 16), n_sites=None)


def test_mamba2_prefill_gathers_at_most_the_reference(reference_dryrun,
                                                      mamba2_prefill):
    """mamba2-1.3b prefill_32k at 2 layers on a fake (16, 16) mesh: the
    port's all-gather wire bytes a rank are at most the reference's, and
    no all-gather site in ``models/ssm.py`` moves (per call) as much as a
    rank's (B_l, S, d_inner / 16) bf16 x activation."""
    cfg, shape, traced = mamba2_prefill
    got = traced["collective"].bytes_by_op.get("all-gather", 0.0)
    ref = reference_dryrun("mamba2-1.3b")["all_gather"]
    assert got <= ref, (got, ref)
    _ssm_gathers(traced, shape, cfg)


def test_mamba2_prefill_peaks_at_most_the_reference(reference_dryrun,
                                                    mamba2_prefill):
    """The same trace's peak a rank is at most the reference's argument +
    temp bytes (XLA's CPU buffer assignment of the same cut cell), though
    it holds the outputs, the full-position logits, which those leave
    out.  Where torch has no sharding strategy for softplus (2.11), its
    propagation through the decomposition on global-shape meta tensors
    counts nowhere (``launch.dryrun._Marks``)."""
    _, _, traced = mamba2_prefill
    got = traced["memory"]["peak_bytes"]
    ref = reference_dryrun("mamba2-1.3b")["args_temps"]
    assert got <= ref, (got, ref)


def test_hymba_train_pads_heads_and_gathers_at_most_the_reference(
        reference_dryrun, monkeypatch):
    """hymba-1.5b train_4k at 2 layers on a fake (16, 16) mesh: its 50 SSD
    heads padded to 64, the traced rank's scans each run on 4 heads; the
    port's all-gather wire bytes a rank are at most the reference's, and
    no all-gather site in ``models/ssm.py`` moves (per call) as much as a
    rank's x activation."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=DRY_LAYERS)
    shape = get_shape("train_4k")
    assert ssm.ssd_heads(cfg.n_ssm_heads, 16) == 64
    heads = []
    scan = ssm.ssd_chunked

    def counted(x, *args, **kwargs):
        heads.append(x.shape[2])
        return scan(x, *args, **kwargs)

    monkeypatch.setattr(ssm, "ssd_chunked", counted)
    traced = D.trace_cell(cfg, shape, (16, 16), n_sites=None)
    # each layer's forward, and again in its backward (remat)
    assert heads == [4] * (2 * DRY_LAYERS), heads
    got = traced["collective"].bytes_by_op.get("all-gather", 0.0)
    ref = reference_dryrun("hymba-1.5b")["all_gather"]
    assert got <= ref, (got, ref)
    assert _ssm_gathers(traced, shape, cfg)
