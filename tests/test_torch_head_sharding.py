"""The LM head and the decode core on a mesh against the reference.

``unembed`` on a mesh returns vocab-sharded logits, ``cross_entropy`` on a
mesh is vocab-parallel (no rank holds a tensor of the whole vocab), and
``decode_attention`` on a cache whose slots are sharded over the data axes
attends over each rank's own slots.  On 2x4 gloo ranks (the helpers of
``test_torch_distributed.py``) the logits equal the one-device product,
the loss and its gradient the reference's ``cross_entropy`` within f32
tolerance (1e-6 of the loss, 1e-6 of the gradient's max), and the decode
core the ``mesh=None`` decode within 1e-5 of the output's max (f32, the
LM tests' tolerance); on a one-rank mesh each is the one-device path's
bit for bit.

The dry-run is held against the reference's: qwen1.5-0.5b train_4k on a
fake (16, 16) mesh, cut to 2 layers, peaks at or under the reference's
argument + temp bytes (XLA's CPU buffer assignment of the same cut
program, computed on the host), and no collective moves a tensor the size
of a rank's full-vocab bf16 logits; hymba-1.5b long_500k, cut to 2 layers,
all-gathers at most the reference's bytes.  The reference's figures
come from ``scripts/dryrun_parity.py`` in a subprocess:
``repro.launch.dryrun`` forces 512 host devices through ``XLA_FLAGS`` when
it is imported.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import common as j_common

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as tr
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention
from repro_torch.models.common import cross_entropy, unembed
from repro_torch.sharding import P, mesh_scope, place

from test_torch_distributed import REPO, _run_ranks

# (name, vocab, vocab_real): 64 columns split 16 a model rank, the last
# three padded; 62 columns the 4 model ranks do not divide (left whole)
CE_CASES = (("sharded", 64, 61), ("whole", 62, 60))
DRY_LAYERS = 2


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _ce_inputs(vocab: int, vocab_real: int, seed: int):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((4, 8, vocab))).astype(np.float32)
    labels = rng.integers(0, vocab_real, (4, 8)).astype(np.int32)
    return logits, labels


def _reference_ce(logits, labels, vocab_real):
    """The reference's loss and its gradient with respect to the logits."""
    return jax.value_and_grad(j_common.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), vocab_real)


# -- 2x4 gloo ranks --------------------------------------------------------------

def test_vocab_sharded_head_and_cross_entropy_on_2x4_ranks(tmp_path):
    """``unembed`` (tied and untied) returns ``P("data", None, "model")``
    logits equal to the one-device product (whole over 'model' where 4
    does not divide the vocab); the vocab-parallel ``cross_entropy`` and
    its gradient match the reference's, with padded columns and labels on
    every model rank's shard."""
    cases = {}
    for i, (name, vocab, vocab_real) in enumerate(CE_CASES):
        logits, labels = _ce_inputs(vocab, vocab_real, seed=i)
        if name == "sharded":
            owners = set(labels.ravel() // (vocab // 4))
            assert owners == {0, 1, 2, 3}
        loss, grad = _reference_ce(logits, labels, vocab_real)
        cases[name] = {"logits": torch.from_numpy(logits),
                       "labels": torch.from_numpy(labels),
                       "vocab_real": vocab_real, "loss": float(loss),
                       "grad": torch.from_numpy(np.array(grad))}
    rng = np.random.default_rng(7)
    torch.save({"cases": cases,
                "x": torch.from_numpy(rng.standard_normal((4, 8, 16))
                                      .astype(np.float32)),
                "w": {v: torch.from_numpy(rng.standard_normal((v, 16))
                                          .astype(np.float32))
                      for v in (64, 62)}}, tmp_path / "in.pt")
    out = _run_ranks(tmp_path, 8, """
        from repro_torch.launch.mesh import compat_make_mesh
        from repro_torch.models.common import cross_entropy, unembed
        from repro_torch.sharding import P, mesh_scope, place, to_placements
        d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        x = d["x"]
        with mesh_scope(mesh):
            dx = place(x, mesh, P("data", None, None))
            for vocab, w in d["w"].items():
                vspec = "model" if vocab % 4 == 0 else None
                for tied, wt, spec in ((True, w, P("model", None)),
                                       (False, w.t().contiguous(),
                                        P(None, "model"))):
                    got = unembed(dx, place(wt, mesh, spec), tied, mesh)
                    assert tuple(got.placements) == to_placements(
                        P("data", None, vspec), mesh), got.placements
                    want = unembed(x, wt, tied)
                    err = float((got.full_tensor() - want).abs().max())
                    assert err <= 1e-6 * float(want.abs().max()), (vocab,
                                                                    tied, err)
            for name, c in d["cases"].items():
                vspec = "model" if name == "sharded" else None
                lg = place(c["logits"], mesh, P("data", None, vspec)
                           ).detach().requires_grad_(True)
                loss = cross_entropy(lg, place(c["labels"], mesh,
                                               P("data", None)),
                                     c["vocab_real"], mesh)
                loss.backward()
                got = float(loss.full_tensor())
                assert abs(got - c["loss"]) <= 1e-6 * abs(c["loss"]), (
                    name, got, c["loss"])
                g = lg.grad.full_tensor()
                err = float((g - c["grad"]).abs().max())
                assert err <= 1e-6 * float(c["grad"].abs().max()), (name, err)
        if RANK == 0:
            print("OK head")
    """)
    assert "OK head" in out


def _decode_setup(window, seed: int = 0):
    """An f32 smoke-width attention layer and its inputs: (cfg, params,
    xs (steps, 1, 1, d), smax)."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                              dtype="float32", sliding_window=window)
    g = torch.Generator().manual_seed(seed)
    d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = attention.LayerAttnParams(
        *(0.2 * torch.randn(s, generator=g)
          for s in ((d, qd), (d, kd), (d, kd), (qd, d))))
    steps = 6
    smax = attention.cache_size(cfg, 8)
    xs = torch.randn(steps, 1, 1, d, generator=g)
    return cfg, p, xs, smax


def test_decode_on_sequence_sharded_cache_on_2x4_ranks(tmp_path):
    """Batch 1 on 2x4 ranks, the cache's slots over 'data' (as
    ``decode_state_sharding`` lays out long_500k): six decode steps with a
    full cache of 8 slots and with a ring of 4 slots that wraps equal the
    ``mesh=None`` decode within 1e-5 of the output's max, the caches
    included, and the cache stays sharded over the slots."""
    cases = {}
    for window in (None, 4):
        cfg, p, xs, smax = _decode_setup(window)
        ck = torch.zeros(1, smax, cfg.kv_dim)
        cv = torch.zeros_like(ck)
        outs = []
        for i, x in enumerate(xs):
            o, ck, cv = attention.decode_attention(x, p, cfg, ck, cv, i)
            outs.append(o)
        cases[window] = {"params": tuple(p[:4]), "xs": xs, "smax": smax,
                         "outs": torch.stack(outs), "ck": ck, "cv": cv}
    torch.save(cases, tmp_path / "in.pt")
    out = _run_ranks(tmp_path, 8, """
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import compat_make_mesh
        from repro_torch.models import attention
        from repro_torch.sharding import P, mesh_scope, place, to_placements
        d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        for window, c in d.items():
            cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                                      dtype="float32", sliding_window=window)
            specs = (P(None, "model"), P(None, "model"), P(None, "model"),
                     P("model", None))
            p = attention.LayerAttnParams(
                *(place(w, mesh, s) for w, s in zip(c["params"], specs)))
            cspec = P(None, "data", "model")
            z = torch.zeros(1, c["smax"], cfg.kv_dim)
            ck, cv = place(z, mesh, cspec), place(z.clone(), mesh, cspec)
            with mesh_scope(mesh):
                for i, x in enumerate(c["xs"]):
                    o, ck, cv = attention.decode_attention(
                        place(x, mesh, P()), p, cfg, ck, cv, i, mesh=mesh)
                    want = c["outs"][i]
                    err = float((o.full_tensor() - want).abs().max())
                    assert err <= 1e-5 * float(want.abs().max()), (
                        window, i, err)
            assert tuple(ck.placements) == to_placements(cspec, mesh)
            for got, want in ((ck, c["ck"]), (cv, c["cv"])):
                err = float((got.full_tensor() - want).abs().max())
                assert err <= 1e-5 * float(want.abs().max()), (window, err)
        if RANK == 0:
            print("OK decode")
    """)
    assert "OK decode" in out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 5, 32])
def test_cross_entropy_in_row_chunks_matches_the_reference(monkeypatch,
                                                           rows, dtype):
    """``cross_entropy`` (``mesh=None``) with chunks of 1, 5 and all 32
    rows: the loss and its gradient match the reference's within 1e-6 of
    the loss and of the gradient's max (f32 logits; bf16 logits against
    the reference on their f32 values, the gradient within a bf16 ulp)."""
    from repro_torch.models import common
    monkeypatch.setattr(common, "CE_CHUNK_ELEMS", rows * 64)
    logits, labels = _ce_inputs(64, 61, seed=4)
    x = torch.from_numpy(logits).to(dtype)
    loss, grad = _reference_ce(x.float().numpy(), labels, 61)
    a = x.clone().requires_grad_(True)
    got = cross_entropy(a, torch.from_numpy(labels), 61)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-6 * abs(float(loss))
    want = torch.from_numpy(np.array(grad))
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    assert a.grad.dtype == dtype
    err = float((a.grad.float() - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


# -- one rank: bit for bit -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_on_one_rank_is_bit_for_bit(one_rank_mesh, dtype):
    """At (1, 1) the vocab-parallel loss and its gradient equal
    ``mesh=None``'s bit for bit (``logz`` is ``lse_0``, its gradient
    factor 1.0), as does the sharded ``unembed``."""
    mesh = one_rank_mesh
    logits, labels = _ce_inputs(64, 61, seed=3)
    a = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    want = cross_entropy(a, torch.from_numpy(labels), 61)
    want.backward()
    with mesh_scope(mesh):
        b = place(torch.from_numpy(logits).to(dtype), mesh,
                  P("data", None, "model")).detach().requires_grad_(True)
        got = cross_entropy(b, place(torch.from_numpy(labels), mesh,
                                     P("data", None)), 61, mesh)
        got.backward()
        assert torch.equal(got.full_tensor(), want)
        assert torch.equal(b.grad.full_tensor(), a.grad)
        x = torch.from_numpy(logits[..., :16]).to(dtype)
        w = torch.from_numpy(logits[0, :, :16].copy()).to(dtype)
        out = unembed(place(x, mesh, P("data", None, None)),
                      place(w, mesh, P("model", None)), True, mesh)
        assert torch.equal(out.full_tensor(), unembed(x, w, True))


@pytest.mark.parametrize("window", [None, 4])
def test_sequence_sharded_decode_on_one_rank_is_bit_for_bit(one_rank_mesh,
                                                           window):
    """At (1, 1), a cache laid out over its slots on 'data' takes the
    sequence-sharded core, whose all-reduces return their inputs: the
    outputs and caches equal ``mesh=None``'s bit for bit."""
    mesh = one_rank_mesh
    cfg, p, xs, smax = _decode_setup(window, seed=1)
    ck = torch.zeros(1, smax, cfg.kv_dim)
    cv = torch.zeros_like(ck)
    cspec = P(None, "data", "model")
    dk, dv = place(ck, mesh, cspec), place(cv, mesh, cspec)
    assert attention._seq_sharded(dk, mesh)
    dp = attention.LayerAttnParams(*(place(w, mesh, P()) for w in p[:4]))
    with mesh_scope(mesh):
        for i, x in enumerate(xs):
            o1, ck, cv = attention.decode_attention(x, p, cfg, ck, cv, i)
            o2, dk, dv = attention.decode_attention(
                place(x, mesh, P()), dp, cfg, dk, dv, i, mesh=mesh)
            assert torch.equal(o2.full_tensor(), o1), i
            assert torch.equal(dk.full_tensor(), ck), i
            assert torch.equal(dv.full_tensor(), cv), i


# -- the dry-run against the reference's -----------------------------------------

@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's cut cells (``scripts/dryrun_parity.py
    --reference-only``), compiled in a subprocess started when the first
    test asks for them; the port's traces run meanwhile."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "dryrun_parity.py"),
         "--reference-only", "--layers", str(DRY_LAYERS),
         "--cell=qwen1.5-0.5b:train_4k", "--cell=hymba-1.5b:long_500k"],
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


def _trace(arch: str, shape: str, monkeypatch):
    """The port's cut cell on a fake (16, 16) mesh -> (traced, largest
    tensor a collective moved: an all-gather's or all-reduce's result, a
    reduce-scatter's input)."""
    largest = []
    add = tr.CollectiveStats.add

    def recording(self, op, size, ranks):
        moved = size * len(ranks) if op == "reduce-scatter" else size
        largest.append(moved if len(ranks) > 1 else 0)
        return add(self, op, size, ranks)

    monkeypatch.setattr(tr.CollectiveStats, "add", recording)
    cfg = dataclasses.replace(get_config(arch), n_layers=DRY_LAYERS)
    traced = D.trace_cell(cfg, get_shape(shape), (16, 16))
    return traced, max(largest)


def test_train_cell_fits_under_the_references_memory(reference_dryrun,
                                                     monkeypatch):
    """qwen1.5-0.5b train_4k at 2 layers: the port's per-rank peak is at
    or under the reference's argument + temp bytes, and no collective
    moves a tensor of ``tokens_per_rank * vocab`` bf16 values."""
    shape = get_shape("train_4k")
    traced, largest = _trace("qwen1.5-0.5b", "train_4k", monkeypatch)
    cfg = get_config("qwen1.5-0.5b")
    tokens_per_rank = shape.global_batch * shape.seq_len // 16
    assert largest < tokens_per_rank * cfg.vocab_padded * 2, largest
    ref = reference_dryrun()["qwen1.5-0.5b"]
    peak = traced["memory"]["peak_bytes"]
    assert peak <= ref["args_temps"], (peak, ref)


def test_long_context_decode_gathers_at_most_the_reference(
        reference_dryrun, monkeypatch):
    """hymba-1.5b long_500k at 2 layers (batch 1, the cache's slots over
    'data'): the port's all-gather wire bytes a rank are at most the
    reference's, and the dry-run's sites (``collective_sites``) show no
    gather of the cache's slots at the decode core."""
    traced, _ = _trace("hymba-1.5b", "long_500k", monkeypatch)
    got = traced["collective"].bytes_by_op.get("all-gather", 0.0)
    ref = reference_dryrun()["hymba-1.5b"]["all_gather"]
    assert got <= ref, (got, ref)
    # no gather at the decode core's entry reaches a layer's k cache (its
    # slots over 16 data ranks are each rank's 1/16)
    cfg = get_config("hymba-1.5b")
    smax = attention.cache_size(cfg, get_shape("long_500k").seq_len)
    sites = [s for s in traced["sites"] if s["op"] == "all-gather"
             and "models/attention.py" in s["site"]]
    assert sites, traced["sites"]
    for s in sites:
        assert s["wire_bytes"] / s["count"] < smax * cfg.kv_dim * 2 / 16, s
