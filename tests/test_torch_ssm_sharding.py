"""The Mamba-2 mixer on each rank's own channels, against ``mesh=None``,
the reference and the reference's dry-run.

``ssm_block`` and ``ssm_decode`` convolve the x channels and the B/C
channels apart (``ssm._conv_channels``): where the SSD heads divide the
model axis the x channels stay on ``w_x``'s model-sharded layout from the
projection to the scan, and no (B, S, .) activation is gathered for the
conv.  Three small f32 configs whose conv weight's shard boundaries (160
channels, 40 a rank on model 4) do not fall on d_inner = 128: mamba2's
smoke config (8 heads, on shards), the same 80 wide (10 heads that
model 4 does not divide, 3, 3, 3 and 1 a rank: the conv runs on the
weight's own shards, 48 of 192 channels a rank against d_inner = 160)
and hymba's (the SSM half beside attention).  On 2x4 gloo ranks (the
helpers of ``test_torch_distributed.py``) the prefill, six decode steps
and the loss and gradients of the train step equal ``mesh=None``'s
within 1e-5 of each max |value|, the conv states too and the first
layer's bit for bit (a copy of inputs that later layers receive with the
partial sums of the layers before reordered); the prefill also equals the reference's within 1e-5 of its max |logit| (the
LM tests' f32 tolerance), the weights carried over by ``params_from_jax``.
On a one-rank mesh every one of them is ``mesh=None``'s bit for bit
(``mesh=None`` convolves the two parts as one, as before).

The dry-run: mamba2-1.3b prefill_32k cut to 2 layers on a fake (16, 16)
mesh all-gathers at most the reference's bytes a rank
(``scripts/dryrun_parity.py --reference-only`` in a subprocess), and no
all-gather site in ``models/ssm.py`` moves as much as one rank's (B_l, S,
d_inner / 16) bf16 x activation.
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
from repro_torch.models.params import params_from_jax

from test_torch_distributed import REPO, _run_ranks

# (case, arch, d_model or None for the smoke config's)
CASES = (("mamba2", "mamba2-1.3b", None),
         ("mamba2-uneven-heads", "mamba2-1.3b", 80),
         ("hymba", "hymba-1.5b", None))
B, S = 2, 64
DRY_LAYERS = 2


def _cfg(get, arch: str, d_model):
    """The f32 smoke config, ``d_model`` wide if given."""
    import dataclasses
    c = dataclasses.replace(get(arch).smoke(), dtype="float32")
    return c if d_model is None else dataclasses.replace(c, d_model=d_model)


def _inputs(arch: str, d_model, seed: int = 0):
    """(port config, port params carried from the reference's, tokens,
    labels, the reference's f32 logits)."""
    jc, tc = _cfg(j_get_config, arch, d_model), _cfg(get_config, arch, d_model)
    jp = j_init(jc, jax.random.PRNGKey(seed), max_seq=S)
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc,
                             "cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    want, _ = j_api.forward_logits(jp, {"tokens": toks}, jc)
    return (tc, params, torch.from_numpy(toks).long(),
            torch.from_numpy(np.roll(toks, -1, 1)).long(),
            torch.from_numpy(np.array(want)))


def _run(params, toks, labels, cfg, mesh=None, train: bool = True):
    """-> (prefill logits, prefill conv states (L, B, K-1, conv_dim), the
    decode steps' logits, the last decode state, and unless ``train`` is
    False the loss and the gradients), the inputs
    placed on ``mesh`` if given (the parameters by the sharding rules, the
    decode state by ``decode_state_shardings``).  Self-contained: the rank
    processes run its source."""
    import torch
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
        state = model_api.init_decode_state(params, {}, cfg, B, SMAX,
                                            torch.float32)
        if mesh is not None:
            state = place_tree(state, serve.decode_state_shardings(
                cfg, state, mesh))
        steps = []
        for t in range(STEPS):
            out, state = model_api.decode_step(
                params, batch["tokens"][:, t:t + 1], state, cfg, mesh=mesh)
            steps.append(out)
    if not train:
        return logits, st.conv, steps, state, None, None
    with mesh_scope(mesh):          # as the train step runs it
        metrics, grads = _grads_of(params, batch, cfg, remat=False,
                                   mesh=mesh)
    return logits, st.conv, steps, state, metrics["loss"], grads


def _full(t):
    """A DTensor's global value; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


# -- 2x4 gloo ranks ---------------------------------------------------------------

@pytest.mark.parametrize("case,arch,d_model", CASES,
                         ids=[c[0] for c in CASES])
def test_ssm_on_2x4_ranks_matches_one_device(tmp_path, case, arch, d_model):
    """The mesh prefill, six decode steps and the train step's loss and
    gradients within 1e-5 of ``mesh=None``'s max |value|; the conv states
    (prefill and decode) too, the first layer's bit for bit; the prefill
    logits within 1e-5 of the reference's max |logit|."""
    cfg, params, toks, labels, ref = _inputs(arch, d_model)
    conv_dim = cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    assert conv_dim % 4 == 0 and cfg.d_inner % (conv_dim // 4)
    train = d_model is None
    want = _run(params, toks, labels, cfg, train=train)
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
        cfg = _cfg(get_config, {arch!r}, {d_model!r})
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        got = _run(d["params"], d["toks"], d["labels"], cfg, mesh,
                   train={train!r})
        want = d["want"]

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
        if {train!r}:
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


@pytest.mark.parametrize("case,arch,d_model", CASES,
                         ids=[c[0] for c in CASES])
def test_ssm_on_one_rank_is_bit_for_bit(one_rank_mesh, case, arch, d_model):
    """At (1, 1) the prefill, its conv states, the decode steps and state,
    and the loss and every gradient equal ``mesh=None``'s bit for bit."""
    cfg, params, toks, labels, _ = _inputs(arch, d_model, seed=2)
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


# -- the dry-run against the reference's -----------------------------------------

@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's mamba2 prefill_32k cut to 2 layers, compiled in a
    subprocess started when the first test asks for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "dryrun_parity.py"),
         "--reference-only", "--layers", str(DRY_LAYERS),
         "--cell=mamba2-1.3b:prefill_32k"],
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    result = {}

    def get():
        if not result:
            out, err = proc.communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.startswith("REF ")]
            assert proc.returncode == 0 and lines, err[-4000:]
            result.update(json.loads(lines[-1][4:]))
        return result

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_mamba2_prefill_gathers_at_most_the_reference(reference_dryrun):
    """mamba2-1.3b prefill_32k at 2 layers on a fake (16, 16) mesh: the
    port's all-gather wire bytes a rank are at most the reference's, and
    no all-gather site in ``models/ssm.py`` moves (per call) as much as a
    rank's (B_l, S, d_inner / 16) bf16 x activation."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=DRY_LAYERS)
    shape = get_shape("prefill_32k")
    traced = D.trace_cell(cfg, shape, (16, 16))
    got = traced["collective"].bytes_by_op.get("all-gather", 0.0)
    ref = reference_dryrun()["mamba2-1.3b"]["all_gather"]
    assert got <= ref, (got, ref)
    x_shard = shape.global_batch // 16 * shape.seq_len * cfg.d_inner // 16 * 2
    for s in traced["sites"]:
        if s["op"] == "all-gather" and "models/ssm.py" in s["site"]:
            assert s["wire_bytes"] / s["count"] < x_shard, s
