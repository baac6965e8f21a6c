"""The donated decode step: ``decode_step(..., donate=True)``, the port's
form of the reference's ``donate_argnums=(2,)`` on the decode state.

* On the CPU, for the smoke config of every family (dense with QKV
  biases, dense with a sliding window whose ring wraps, MoE, ssm, hybrid,
  encoder-decoder, vision): several donated steps and as many undonated
  ones from equal states give the same logits and final states bit for
  bit; every donated step returns the storages it was given, and an
  undonated step leaves the state it was given as it was.
* On a one-rank gloo mesh, a state laid out otherwise than the decode's
  cores take it (its batch replicated over 'data'): the kv-group core
  reads a redistributed copy and the SSD update gets one, and the donated
  step still writes each new slot and SSM state into the stored tensors,
  bit for bit.
* ``attention._write_slot`` writes a slot into a cache whose slots lie
  evenly over the data ranks and raises on an uneven split.
* ``greedy_generate`` donates the state it builds: every step is called
  with ``donate=True``, and its f32 tokens equal the reference's on the
  same weights (``params_from_jax``).
* The dry-run's decode cells donate: qwen1.5-0.5b decode_32k on 16x16
  peaks at most 240 MB a rank at 2 layers (425,524,512 B when each step
  copied every layer's cache), hymba-1.5b decode_32k on 16x16 under the
  reference's argument + temp bytes (``chip_smoke.DRYRUN_SWEEP_REFERENCE``),
  no storage a cache clone or a stack of the layers made is held at the
  peak, and ``alias_bytes`` is the donated state's local bytes.
"""
import dataclasses
import importlib.util
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.configs import get_config as j_get_config
from repro.models.params import init_params as j_init
from repro.runtime import serve as j_serve

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.runtime import model_api, serve
from repro_torch.sharding import (P, NamedSharding, mesh_scope,
                                  param_sharding, place_tree)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense-qkv-bias": "qwen1.5-0.5b",
            "dense-sliding-window": "h2o-danube-3-4b",
            "moe": "granite-moe-3b-a800m", "ssm": "mamba2-1.3b",
            "hybrid": "hymba-1.5b", "encoder-decoder": "whisper-base",
            "vision": "phi-3-vision-4.2b"}
B, STEPS = 2, 6
LAYERS = 2


def _setup(arch: str, seed: int = 0, dtype=None):
    """(smoke config, in ``dtype`` if given, its parameters from ``seed``,
    the batch's extras, tokens (steps, B, 1), the state's length): past
    the window, so the ring wraps, for a sliding-window config."""
    cfg = get_config(arch).smoke()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed + 1)
    extras = {}
    if cfg.family == "audio":
        frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
        extras["frames"] = torch.from_numpy(frames).to(getattr(torch,
                                                               cfg.dtype))
    win = cfg.sliding_window
    steps = STEPS if win is None else win + STEPS
    seq = 16 if win is None else win + 16
    toks = rng.integers(0, cfg.vocab, (steps, B, 1))
    return cfg, params, extras, torch.from_numpy(toks).long(), seq


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _storages(state) -> list:
    return [_local(t).untyped_storage().data_ptr() for t in state
            if isinstance(t, torch.Tensor)]


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _assert_states_equal(got, want):
    assert type(got) is type(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert torch.equal(_whole(g), _whole(w))
        else:
            assert g == w


@pytest.mark.parametrize("dtype", [None, "float32"],
                         ids=["config-dtype", "f32-model-bf16-state"])
@pytest.mark.parametrize("arch", FAMILIES.values(), ids=FAMILIES.keys())
def test_donated_decode_equals_the_undonated_bit_for_bit(arch, dtype):
    """Donated and undonated steps from equal states (bf16, as
    ``greedy_generate`` makes them; the model in its config's dtype or in
    f32): the same logits every step and the same final state, bit for
    bit; each donated step returns the state's own storages with ``index
    + 1`` (but the first step of an f32 model, which casts a bf16 conv
    state to f32 once, as the undonated step's new state is), and each
    undonated step leaves its input state unchanged."""
    cfg, params, extras, toks, seq = _setup(arch, dtype=dtype)
    state = model_api.init_decode_state(params, extras, cfg, B, seq)
    donated = model_api.init_decode_state(params, extras, cfg, B, seq)
    if cfg.sliding_window is not None:
        assert state.cache_k.shape[2] == cfg.sliding_window < len(toks)
    for t, tok in enumerate(toks):
        before = [x.clone() if isinstance(x, torch.Tensor) else x
                  for x in state]
        want, new = model_api.decode_step(params, tok, state, cfg)
        _assert_states_equal(state, type(state)(*before))
        state = new
        held = [(f, _storages([x]), x.dtype) for f, x in
                zip(donated._fields, donated) if isinstance(x, torch.Tensor)]
        got, donated = model_api.decode_step(params, tok, donated, cfg,
                                             donate=True)
        for f, ptr, dt in held:
            x = getattr(donated, f)
            cast = f == "ssm_conv" and dt != x.dtype == getattr(torch,
                                                                cfg.dtype)
            assert (_storages([x]) == ptr) != cast, (t, f)
        assert donated.index == state.index == t + 1
        assert torch.equal(got, want), t
    _assert_states_equal(donated, state)


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_donated_state_off_the_cores_layout(one_rank_mesh, arch):
    """A state whose batch is replicated over 'data', where the kv-group
    core and the SSD head update take it sharded there: the cores get
    redistributed copies, and the donated step still leaves each new k/v
    slot and SSM state in the stored tensors, bit for bit against the
    undonated step on the same layout."""
    mesh = one_rank_mesh
    cfg, params, extras, toks, seq = _setup(arch, seed=2)
    params = place_tree(params, param_sharding(params, mesh))

    def placed():
        st = model_api.init_decode_state(params, extras, cfg, B, seq)
        return place_tree(st, type(st)(*(
            None if not isinstance(x, torch.Tensor) else NamedSharding(
                mesh, P(*([None] * (x.ndim - 1)), "model"))
            for x in st)))

    state, donated = placed(), placed()
    held = _storages(donated)
    with torch.no_grad(), mesh_scope(mesh):
        for tok in toks:
            want, state = model_api.decode_step(params, tok, state, cfg,
                                                mesh=mesh)
            got, donated = model_api.decode_step(params, tok, donated, cfg,
                                                 mesh=mesh, donate=True)
            assert _storages(donated) == held
            assert torch.equal(_whole(got), _whole(want))
    _assert_states_equal(donated, state)


@pytest.mark.parametrize("slots, uneven", [(6, False), (5, True)])
def test_write_slot_takes_only_an_even_slot_split(slots, uneven):
    """``attention._write_slot`` on a cache whose slots lie over 'data'
    (2 ranks of a fake (2, 4) mesh): an even split is written, and one
    that does not split evenly raises, since the rank offset of the slot
    would be wrong."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import attention
    from repro_torch.sharding import place
    with D.fake_group(8):
        mesh = D._make_mesh((2, 4))
        with FakeTensorMode(allow_non_fake_inputs=False), mesh_scope(mesh):
            cache = place(torch.zeros(1, slots, 32), mesh,
                          P(None, "data", None))
            new = place(torch.zeros(1, 1, 2, 16), mesh, P())
            if uneven:
                with pytest.raises(ValueError, match="split evenly"):
                    attention._write_slot(cache, new, 3)
            else:
                attention._write_slot(cache, new, 3)


def test_greedy_generate_donates_and_equals_the_reference(monkeypatch):
    """hymba-1.5b's f32 smoke config (attention cache and SSM state): every
    decode step of ``greedy_generate`` donates, and its tokens equal the
    reference's on the same weights."""
    jc = dataclasses.replace(j_get_config("hymba-1.5b").smoke(),
                             dtype="float32")
    tc = dataclasses.replace(get_config("hymba-1.5b").smoke(),
                             dtype="float32")
    jp = j_init(jc, jax.random.PRNGKey(3), max_seq=32)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    prompt = np.random.default_rng(3).integers(0, jc.vocab, (2, 5)).astype(
        np.int32)
    want = j_serve.greedy_generate(jp, jc, jnp.asarray(prompt), max_new=6,
                                   seq_len=16)
    donates, step = [], model_api.decode_step

    def recorded(*args, **kwargs):
        donates.append(kwargs.get("donate", False))
        return step(*args, **kwargs)

    monkeypatch.setattr(model_api, "decode_step", recorded)
    got = serve.greedy_generate(tp, tc, torch.from_numpy(prompt).long(),
                                max_new=6, seq_len=16)
    assert donates == [True] * 11
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _sweep_reference() -> dict:
    """``chip_smoke.DRYRUN_SWEEP_REFERENCE`` (the reference's figures a
    rank at ``chip_smoke.DRYRUN_SWEEP_LAYERS`` layers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.DRYRUN_SWEEP_LAYERS == LAYERS
    return cs.DRYRUN_SWEEP_REFERENCE


def _state_local_bytes(arch: str, shape: str, mesh_name: str) -> int:
    """One rank's bytes of the decode state of ``arch`` x ``shape`` cut to
    :data:`LAYERS` layers, as ``launch.specs.decode_state_sharding`` lays
    it out on the production mesh (every sharded dim divides evenly)."""
    dims = D.PRODUCTION_MESHES[mesh_name]
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    mesh = types.SimpleNamespace(shape=dict(zip(names, dims)),
                                 axis_names=names)
    cfg = D.cut_layers(get_config(arch), LAYERS)
    state = specs.abstract_decode_state(cfg, get_shape(shape))
    total = 0
    for x, sh in zip(state, specs.decode_state_sharding(cfg, state, mesh)):
        if not isinstance(x, torch.Tensor):
            continue
        split = 1
        for entry in sh.spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                split *= mesh.shape[a]
        assert x.numel() % split == 0
        total += x.numel() * x.element_size() // split
    return total


@pytest.mark.parametrize("arch, peak_at_most", [
    ("qwen1.5-0.5b", 240_000_000), ("hymba-1.5b", None)])
def test_dryrun_decode_donates_its_state(arch, peak_at_most):
    """decode_32k on 16x16 at 2 layers, per rank: the peak at most
    ``peak_at_most`` (None: under the reference's argument + temp bytes),
    no storage made by a cache clone or a stack of the layers held at the
    peak, and the new state all alias bytes: ``alias_bytes`` equals the
    state's local bytes, and the state's collectives are unchanged
    (hymba's gathers stay under the reference's)."""
    key = f"{arch} decode_32k 16x16"
    ref_mem, ref_ag, ref_wire = _sweep_reference()[key]
    probe = D.PeakProbe()
    traced = D.trace_pair(arch, "decode_32k", "16x16", LAYERS, probe=probe)
    mem = traced["memory"]
    assert mem["peak_bytes"] <= (ref_mem if peak_at_most is None
                                 else peak_at_most), mem
    assert mem["alias_bytes"] == _state_local_bytes(arch, "decode_32k",
                                                    "16x16") > 0
    assert mem["temp_bytes"] == max(0, mem["peak_bytes"] - (
        mem["argument_bytes"] + mem["output_bytes"] - mem["alias_bytes"]))
    for h in mem["peak_detail"]["held"]:
        # a decode core's copy of a layer's cache, or the layers' stack
        inner = h.get("site", "").split(" < ")[0].rsplit(" ", 1)[-1]
        assert h["op"] != "aten.stack.default", h
        assert (h["op"], inner) not in {("aten.clone.default", "core"),
                                        ("aten.clone.default", "body")}, h
    assert traced["all_gather"] <= ref_ag and traced["wire_bytes"] <= ref_wire
    assert math.isfinite(traced["trace_s"])
