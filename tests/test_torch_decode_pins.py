"""The one-token decode's residual stream pinned as the forward pins it
(``sharding.pin_residual`` on the embedding and after every residual add
of ``transformer._decode_step`` and ``encdec._decode_step``), and a batch
dim left whole on data axes of one rank (``sharding.batch_entry``).

* On the fake production meshes, cut to 2 layers and traced through
  ``launch.dryrun.trace_pair``: qwen1.5-0.5b decode_32k on 16x16,
  whisper-base decode_32k and h2o-danube-3-4b and mamba2-1.3b long_500k
  on 2x16x16 have no all-reduce at a norm of the residual stream and move
  no more wire bytes a rank than the reference's program at the same depth
  (``chip_smoke.DRYRUN_SWEEP_REFERENCE``: ``scripts/dryrun_parity.py
  --reference-only --layers 2``, XLA's HLO on the host).
* On a real one-rank gloo mesh (``make_local_mesh(device="cpu")``): a
  prefill and a train step of batch 1, and decode steps of the dense and
  the encoder-decoder families, land where ``mesh=None`` lands, bit for
  bit (one rank runs the same local ops).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.specs import decode_state_sharding
from repro_torch.models.params import init_params
from repro_torch.runtime import model_api
from repro_torch.sharding import (P, batch_spec, param_sharding, place,
                                  place_tree)

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 2
NORMS = ("rmsnorm", "layernorm", "norm")


def _sweep_reference() -> dict:
    """``chip_smoke.DRYRUN_SWEEP_REFERENCE`` (the reference's figures a
    rank at ``chip_smoke.DRYRUN_SWEEP_LAYERS`` layers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.DRYRUN_SWEEP_LAYERS == LAYERS
    return cs.DRYRUN_SWEEP_REFERENCE


REFERENCE = _sweep_reference()


def _residual_norm_all_reduces(traced: dict) -> list:
    """The all-reduce sites, of the largest ``trace_pair`` reports, at a
    norm of the residual stream: the innermost port frame a norm, called
    from a decode step (the SSM's gated norm over its own channel shards,
    inside ``ssm_decode``, is not one)."""
    def funcs(site):
        return [f.rsplit(" ", 1)[-1] for f in site.split(" < ")]

    return [s for s in traced["sites"] if s["op"] == "all-reduce"
            and funcs(s["site"])[0] in NORMS
            and "_decode_step" in funcs(s["site"])[1:]]


@pytest.mark.parametrize("arch, shape, mesh", [
    ("qwen1.5-0.5b", "decode_32k", "16x16"),
    ("whisper-base", "decode_32k", "2x16x16"),
    ("h2o-danube-3-4b", "long_500k", "2x16x16"),
    ("mamba2-1.3b", "long_500k", "2x16x16"),
])
def test_decode_moves_no_more_wire_than_the_reference(arch, shape, mesh):
    """Each pair, cut to 2 layers: wire bytes a rank at or under the
    reference's; no all-reduce at a norm of the residual stream (it
    reaches every norm whole over 'model'), and at least one collective."""
    traced = D.trace_pair(arch, shape, mesh, LAYERS)
    assert sum(traced["counts"].values()) > 0, traced["counts"]
    ref_wire = REFERENCE[f"{arch} {shape} {mesh}"][2]
    assert traced["wire_bytes"] <= ref_wire, (traced["counts"],
                                              traced["sites"])
    assert not _residual_norm_all_reduces(traced), traced["sites"]


def test_dense_decode_all_reduces_once_a_row_parallel_product():
    """qwen1.5-0.5b decode_32k on 16x16 at 2 layers: the residual pins
    reduce each layer's two row-parallel products once, and the vocab
    lookup once: 5 all-reduces, at the residual adds and the embedding,
    no all-gather."""
    traced = D.trace_pair("qwen1.5-0.5b", "decode_32k", "16x16", LAYERS)
    assert traced["counts"] == {"all-reduce": 2 * LAYERS + 1}, traced
    where = {s["site"].split(" < ")[0].rsplit(" ", 1)[-1]
             for s in traced["sites"]}
    assert where == {"_decode_step", "embed_lookup"}, traced["sites"]


# -- a real one-rank mesh -------------------------------------------------------


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _smoke(arch: str):
    """``arch``'s smoke config in f32 and its seeded weights."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _tokens(cfg, shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, shape))


def test_batch1_prefill_is_bit_for_bit(one_rank_mesh):
    """qwen1.5-0.5b's smoke prefill of (1, 32) tokens on the (1, 1) mesh,
    the tokens over the data axes: the logits equal ``mesh=None``'s."""
    from repro_torch.runtime.serve import make_prefill_step
    mesh = one_rank_mesh
    cfg, params = _smoke("qwen1.5-0.5b")
    toks = _tokens(cfg, (1, 32), 1)
    with torch.no_grad():
        want = make_prefill_step(cfg)(params, {"tokens": toks})
        got = make_prefill_step(cfg, mesh=mesh)(
            place_tree(params, param_sharding(params, mesh)),
            {"tokens": place(toks, mesh, batch_spec(mesh, None))})
    assert torch.equal(got.full_tensor(), want)


def test_batch1_train_step_is_bit_for_bit(one_rank_mesh):
    """One train step of qwen1.5-0.5b's smoke config on a global batch of
    1 through ``jit_train_step`` on the (1, 1) mesh: the loss, gradient
    norm and every updated parameter equal ``make_train_step``'s."""
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train import (init_train_state, jit_train_step,
                                           make_train_step)
    cfg, params = _smoke("qwen1.5-0.5b")
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=1,
                                seed=0), 0, "cpu")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=1)
    state = init_train_state(params)
    s1, m1 = make_train_step(cfg, opt)(state, batch)
    s2, m2 = jit_train_step(cfg, opt, one_rank_mesh, state, batch)(state,
                                                                  batch)
    for k in ("loss", "grad_norm"):
        assert torch.equal(m2[k], m1[k]), k
    for k, v in s1.params.items():
        assert torch.equal(s2.params[k].full_tensor(), v), k


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base"])
def test_decode_steps_are_bit_for_bit(one_rank_mesh, arch, batch):
    """Three decode steps of the dense (qwen1.5-0.5b) and the
    encoder-decoder (whisper-base) smoke configs on the (1, 1) mesh, the
    state laid out by ``decode_state_sharding``: every step's logits and
    the final caches equal ``mesh=None``'s."""
    mesh = one_rank_mesh
    cfg, params = _smoke(arch)
    extras = {}
    if cfg.family == "audio":
        rng = np.random.default_rng(2)
        extras["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    toks = _tokens(cfg, (batch, 3), 3)
    with torch.no_grad():
        st1 = model_api.init_decode_state(params, extras, cfg, batch, 8,
                                          torch.float32)
        st2 = place_tree(st1, decode_state_sharding(cfg, st1, mesh))
        dparams = place_tree(params, param_sharding(params, mesh))
        for i in range(toks.shape[1]):
            want, st1 = model_api.decode_step(params, toks[:, i:i + 1], st1,
                                              cfg)
            got, st2 = model_api.decode_step(
                dparams, place(toks[:, i:i + 1], mesh, P()), st2, cfg,
                mesh=mesh)
            assert torch.equal(got.full_tensor(), want), i
    assert torch.equal(st2.cache_k.full_tensor(), st1.cache_k)
    assert torch.equal(st2.cache_v.full_tensor(), st1.cache_v)
