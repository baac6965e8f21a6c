"""Multi-pod dry-run (counterpart of ``repro.launch.dryrun``).

Traces the production step of every (arch x shape x mesh) cell on fake
tensors over a fake process group of 256 or 512 ranks, so nothing is
allocated on any device, counts what one rank does, and prices it in a
:class:`~repro_torch.launch.roofline.RooflineReport`.  JSON artifacts land
in ``artifacts/dryrun_torch/`` (the reference writes ``artifacts/dryrun/``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--force]

Where the reference lowers and compiles one XLA program per cell, the port
runs its eager step once under ``FakeTensorMode`` on DTensors
(``torch.testing``'s ``fake`` backend, ``FakeStore``), with the state and
inputs of :mod:`repro_torch.launch.specs` placed by
:func:`repro_torch.sharding.place`, and :class:`StepCounter` beside it in
place of XLA's analyses:

* FLOPs per rank (``cost_analysis()["flops"]``): ``torch.utils.flop_counter``'s
  formulas over the local ops each rank runs.  DTensor's sharding
  propagation also runs every op once at its global shape on the same fake
  mode; those ops are marked while they run and left out
  (``FlopCounterMode`` alone counts them, a factor of the rank count too
  many).  An op with no sharding strategy of its own (softplus on torch
  2.11, hardswish on 2.13) is propagated through its decomposition, run
  on meta tensors at the global shape on a one-rank mesh of DTensor's
  own, once a process for each op and placements: marked and left out
  too.
* Bytes per rank (``"bytes accessed"``): every tensor input and output of
  every local op, views and collectives left out.  This is the port's
  eager, unfused traffic: larger than XLA's fused figure, and what the
  port's step really moves.
* Collectives (``parse_collectives(compiled.as_text())``): each
  ``_c10d_functional`` op DTensor runs, with its process group's ranks,
  sized as HLO sizes them (an all-gather by its gathered result, a
  reduce-scatter by its scattered result).  Each is also charged to its
  site, the two innermost frames of the port's own code (not this
  module's or ``sharding.py``'s) that asked for it: the report's
  ``collective_sites`` lists the largest by wire bytes, which names the
  op behind a cell's gathers.
* Memory (``memory_analysis()``): the peak of
  ``torch.distributed._tools.mem_tracker.MemTracker`` over the step (local
  storages, the state included), the local shards of the arguments and of
  the outputs; ``alias_bytes``, the local bytes of the outputs that share
  a storage with an argument.  A decode cell donates its state, as the
  reference jits its decode with ``donate_argnums=(2,)``: the step writes
  each layer's k/v slot and SSM state into the state it was given
  (``decode_step(..., donate=True)``), so its new state is all alias
  bytes and the peak holds each layer's cache once.  A train cell's
  ``donate`` stays a no-op (the eager step drops the old state).

The port's layer loops are Python, so every layer is traced and counted:
the reference's ``_layer_points`` / ``_analyze_extrapolated``, which exist
because XLA's cost model counts a scan body once, have no counterpart.
The fake group's mesh has device type ``cpu``, so an SSM layer takes the
plain SSD scan, as the reference's dry-run lowers it (its ``ssm_block``
defaults to ``use_kernel=False``).  On the card the mesh is NCCL's and the
scan runs ``ssd_scan.cu``, so an SSM cell's report prices a program the
card does not run: its ``step_s`` (and ``mfu``) is a model of the plain,
unfused step, not a lower bound on the card's time.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import heapq
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import perf
from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig, shapes_for
from repro_torch.launch import specs as S
from repro_torch.launch.roofline import (CollectiveStats, RooflineReport,
                                         model_flops_for, wire_bytes)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

PRODUCTION_MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------

class _Marks:
    """Marks two stretches of DTensor's own code while a counter is active
    (installed on entry, restored on exit):

    * ``propagating``: sharding propagation running an op at its global
      shape (``ShardingPropagator._propagate_tensor_meta_non_cached``, and
      ``DecompShardingStrategy.propagate_strategy`` where this torch
      propagates an op through its decomposition), which the counters
      leave out;
    * ``alltoall``: a Shard(i) -> Shard(j) reshard (``shard_dim_alltoall``).
      On a mesh of device type ``cpu``, the fake group's, DTensor runs it
      as an all-gather and a local chunk (gloo has no all-to-all); on an
      NCCL mesh it is one all-to-all of the local shard.  Each active
      counter records that all-to-all and leaves out the collectives
      inside."""
    propagating = 0
    alltoall = 0
    counters: List["StepCounter"] = []
    _users = 0
    _saved: List[Tuple[object, str, object]] = []

    @classmethod
    def _install(cls):
        from torch.distributed.tensor import _collective_utils, placement_types
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        a2a = _collective_utils.shard_dim_alltoall
        try:
            from torch.distributed.tensor._decompositions import \
                DecompShardingStrategy as decomp
        except ImportError:         # a torch that does not decompose
            decomp = None
        if decomp is not None and not hasattr(decomp, "propagate_strategy"):
            raise RuntimeError(
                "torch.distributed.tensor._decompositions.DecompShardingStrategy"
                " no longer has propagate_strategy; the dry-run would count "
                "the global-shape ops of its decompositions on this torch "
                f"{torch.__version__}")
        if getattr(placement_types, "shard_dim_alltoall", None) is not a2a:
            # Shard.redistribute would go round the patch, and a Shard->Shard
            # reshard would be counted as the cpu mesh's all-gather
            raise RuntimeError(
                "torch.distributed.tensor.placement_types no longer calls "
                "_collective_utils.shard_dim_alltoall by that name; the "
                "dry-run cannot count all-to-alls on this torch "
                f"{torch.__version__}")

        def marked(fn):
            def propagate(self, *args, **kwargs):
                cls.propagating += 1
                try:
                    return fn(self, *args, **kwargs)
                finally:
                    cls.propagating -= 1
            return propagate

        def reshard(x, gather_dim, shard_dim, mesh, mesh_dim):
            if not cls.alltoall:
                ranks = dist.get_process_group_ranks(mesh.get_group(mesh_dim))
                for c in cls.counters:
                    c.record("all-to-all", _nbytes(x), ranks)
            cls.alltoall += 1
            try:
                return a2a(x, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                cls.alltoall -= 1

        cls._saved = [(ShardingPropagator,
                       "_propagate_tensor_meta_non_cached", prop)]
        if decomp is not None:
            cls._saved.append((decomp, "propagate_strategy",
                               decomp.propagate_strategy))
        for obj, name, fn in cls._saved:
            setattr(obj, name, marked(fn))
        for mod in (_collective_utils, placement_types):
            cls._saved.append((mod, "shard_dim_alltoall", a2a))
            mod.shard_dim_alltoall = reshard

    @classmethod
    @contextlib.contextmanager
    def active(cls, counter: Optional["StepCounter"] = None):
        if cls._users == 0:
            cls._install()
        cls._users += 1
        if counter is not None:
            cls.counters.append(counter)
        try:
            yield
        finally:
            if counter is not None:
                cls.counters.remove(counter)
            cls._users -= 1
            if cls._users == 0:
                for obj, name, orig in cls._saved:
                    setattr(obj, name, orig)
                cls._saved = []


# the _c10d_functional ops DTensor runs -> the HLO collective each is
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
# ops that move no data of their own (``_unsafe_view`` is a view whose
# schema does not say so)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "_unsafe_view"}


def _tensors(tree) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# frames of the port that only carry a collective to DTensor: a site is
# the frame that called them
_NOT_SITES = ("/repro_torch/launch/dryrun.py", "/repro_torch/sharding.py")
# the counters' own frames, never a site
_COUNTING = ("_site", "record", "_count", "__torch_dispatch__", "reshard")
# sites kept in a report, the largest by wire bytes
N_SITES = 12


def _site(depth: int = 2) -> str:
    """``path:line function`` of the ``depth`` innermost frames of the
    port's code on the stack outside :data:`_NOT_SITES` (or, without one,
    inside them: the dry-run's own placing of a step's outputs), innermost
    first, joined by `` < ``."""
    ours, carriers = [], []
    f = sys._getframe(1)
    while f is not None and len(ours) < depth:
        path = f.f_code.co_filename.replace(os.sep, "/")
        if "/repro_torch/" in path and f.f_code.co_name not in _COUNTING:
            where = (f"{path.rsplit('/repro_torch/', 1)[-1]}:{f.f_lineno} "
                     f"{f.f_code.co_name}")
            (carriers if path.endswith(_NOT_SITES) else ours).append(where)
        f = f.f_back
    return " < ".join(ours or carriers[:depth]) or "?"


def _group_ranks(group_name: str) -> List[int]:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(group_name))


class StepCounter:
    """A ``TorchDispatchMode`` (entered as a context) that counts one rank's
    FLOPs, bytes and collectives over the ops run inside it (see the
    module docstring).  ``flops``, ``bytes`` and ``collective`` (a
    :class:`CollectiveStats`) hold the sums; ``ops`` the local ops
    counted; ``sites`` {(op, site): [count, wire bytes]} the collectives
    by the frame that asked for them (:func:`_site`)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented   # let DTensor run its local ops
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not _Marks.propagating:
                    counter._count(func, args, kwargs, out, flop_registry)
                return out

        self._mode = _Mode()
        self._stack = contextlib.ExitStack()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collective = CollectiveStats()
        self.sites: Dict[Tuple[str, str], List[float]] = {}

    def record(self, op: str, size: float, ranks: Sequence[int]) -> None:
        """One collective (as :meth:`CollectiveStats.add`), also charged to
        its site."""
        self.collective.add(op, size, ranks)
        if len(ranks) > 1:
            entry = self.sites.setdefault((op, _site()), [0, 0.0])
            entry[0] += 1
            entry[1] += wire_bytes(op, size, len(ranks))

    def top_sites(self, n: Optional[int] = N_SITES) -> List[Dict]:
        """The ``n`` sites with the most wire bytes (None: every site)."""
        top = sorted(self.sites.items(), key=lambda kv: -kv[1][1])[:n]
        return [{"op": op, "site": site, "count": c, "wire_bytes": w}
                for (op, site), (c, w) in top]

    def __enter__(self):
        self._stack.enter_context(_Marks.active(self))
        self._stack.enter_context(self._mode)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def _count(self, func, args, kwargs, out, flop_registry) -> None:
        name = func._schema.name.split("::")[-1]
        if func.namespace == "_c10d_functional":
            if _Marks.alltoall:
                return              # counted as one all-to-all (_Marks)
            if name in _COLLECTIVES:
                group = [a for a in (*args, *kwargs.values())
                         if isinstance(a, str)][-1]
                self.record(_COLLECTIVES[name],
                            sum(_nbytes(t) for t in _tensors(out)),
                            _group_ranks(group))
                return
            if name == "wait_tensor":
                return
        if "c10d" in func.namespace:
            raise NotImplementedError(f"{func}: a collective the counter "
                                      "does not size")
        outs = _tensors(out)
        if not outs or name in _NO_TRAFFIC:
            return
        returns = func._schema.returns
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in returns):
            return                                       # a view
        self.ops += 1
        pkt = func._overloadpacket
        if pkt in flop_registry:
            self.flops += int(flop_registry[pkt](*args, **kwargs,
                                                 out_val=out))
        nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        if not any(r.alias_info is not None for r in returns):
            nbytes += sum(_nbytes(t) for t in outs)      # not in place
        self.bytes += nbytes


def _locals(tree) -> List[torch.Tensor]:
    """One rank's shards of the tensors in ``tree``."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def _local_bytes(tree, within=None) -> int:
    """Bytes of one rank's shards of the tensors in ``tree`` (each storage
    once); with ``within``, only of those that share a storage with one of
    ``within``'s (the outputs a donated argument's storage holds)."""
    owned = (None if within is None else
             {t.untyped_storage()._cdata for t in _locals(within)})
    seen, total = set(), 0
    for t in _locals(tree):
        key = t.untyped_storage()._cdata
        if key not in seen and (owned is None or key in owned):
            seen.add(key)
            total += _nbytes(t)
    return total


class PeakProbe:
    """What the memory tracker holds when its total first reaches its
    peak: the op and the port's frames (:func:`_site`) there, and the
    :attr:`TOP` largest storages it holds then, each with the shape, dtype and
    device of the tensor that brought it in, the op and frames that made
    it, and the fake mode it was made under (``step``: the step's own;
    ``other``; ``none``: not a fake tensor).  ``external`` and ``resize``
    off leave out the tracker's tracking of the step's arguments
    (``track_external``) and of storage resizes."""

    TOP = 8

    def __init__(self, external: bool = True, resize: bool = True):
        from torch.utils.weak import WeakIdKeyDictionary
        self.external, self.resize = external, resize
        self._made = WeakIdKeyDictionary()
        self.step_mode = None
        self.peak = 0
        self.at: Dict = {}

    def arguments(self, tracker) -> None:
        """Marks what the tracker holds before the step: its arguments."""
        for st in list(tracker._WINFO.keys()):
            self._made.setdefault(st, {"op": "argument", "mode": "argument"})

    def _mode(self, t) -> str:
        mode = getattr(t, "fake_mode", None)
        return ("none" if mode is None else
                "step" if mode is self.step_mode else "other")

    def seen(self, tracker, func, res) -> None:
        """After the tracker took ``func``'s outputs ``res``."""
        from torch._guards import active_fake_mode
        from torch.distributed._tools.common_utils import get_untyped_storages
        op = str(func)
        for t in _tensors(res):
            for st in get_untyped_storages(t):
                if st not in self._made:
                    self._made[st] = {
                        "shape": list(t.shape), "dtype": str(t.dtype),
                        "device": str(t.device), "op": op, "site": _site(),
                        "mode": self._mode(t)}
        total = sum(s.get("Total", 0)
                    for s in tracker._curr_mem_snap.values())
        if total <= self.peak:
            return
        live = [(winfo.mem_consumed, i, st)
                for i, (st, (winfo, _)) in enumerate(tracker._WINFO.items())]
        kinds: Dict[str, List[int]] = {}
        for b, _, st in live:
            made = self._made.get(st, {})
            kind = " ".join(made.get(k, "") for k in ("mode", "device"))
            kind = kind.strip() or "untracked"
            kinds.setdefault(kind, [0, 0])
            kinds[kind][0] += 1
            kinds[kind][1] += b
        self.peak = total
        self.at = {
            "op": op, "site": _site(), "total": total,
            "under_step_mode": active_fake_mode() is self.step_mode,
            "by_device": {str(d): s.get("Total", 0) for d, s in
                          tracker._curr_mem_snap.items()},
            "by_kind": {k: {"storages": n, "bytes": b}
                        for k, (n, b) in kinds.items()},
            "held": [{"bytes": b, **self._made.get(st, {"op": "untracked"})}
                     for b, _, st in heapq.nlargest(self.TOP, live)]}


def _mem_tracker(probe: Optional[PeakProbe] = None):
    """``MemTracker`` that leaves out the global-shape ops of DTensor's
    sharding propagation (marked while they run, since their fake mode is
    the step's own here); ``probe`` sees each op it tracks."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class _LocalMemTracker(MemTracker):
        def _track_resize(self):
            if probe is None or probe.resize:
                super()._track_resize()

        def _restore_resize(self):
            if probe is None or probe.resize:
                super()._restore_resize()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _Marks.propagating and not any(issubclass(t, DTensor)
                                              for t in types):
                return func(*args, **(kwargs or {}))
            res = super().__torch_dispatch__(func, types, args, kwargs)
            if probe is not None and res is not NotImplemented:
                probe.seen(self, func, res)
            return res

    return _LocalMemTracker()


def measure(fn, *args, probe: Optional[PeakProbe] = None):
    """Run ``fn(*args)`` under :class:`StepCounter` and the memory tracker
    -> (result, counter, memory dict with the reference's
    ``memory_analysis`` keys and ``peak_bytes``; ``peak_detail`` with a
    :class:`PeakProbe`)."""
    counter = StepCounter()
    mem = _mem_tracker(probe)
    if probe is not None:
        from torch._guards import active_fake_mode
        probe.step_mode = active_fake_mode()
    ext = _tensors(args)
    if ext and (probe is None or probe.external):
        mem.track_external(*ext)
    if probe is not None:
        probe.arguments(mem)
    with _Marks.active(), mem, counter:
        out = fn(*args)
    snap = mem.get_tracker_snapshot("peak")
    if len(snap) > 1:
        # one device's peaks added to another's: a stretch of DTensor's
        # own that makes tensors elsewhere and that _Marks does not mark
        raise RuntimeError("the memory tracker counted tensors on "
                           f"{sorted(map(str, snap))}; a step's lie on one")
    peak = sum(v["Total"] for v in snap.values())
    arg_b, out_b = _local_bytes(args), _local_bytes(out)
    alias_b = _local_bytes(out, within=args)
    memory = {"argument_bytes": arg_b, "output_bytes": out_b,
              "temp_bytes": max(0, peak - arg_b - (out_b - alias_b)),
              "alias_bytes": alias_b, "peak_bytes": peak}
    if probe is not None:
        memory["peak_detail"] = probe.at
    return out, counter, memory


# ---------------------------------------------------------------------------
# The traced cell
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks (this process is
    rank 0), destroyed on exit.  A group that exists already must be a
    fake one of that size, and is kept."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"the dry-run needs a fake group of {world} ranks; this "
                f"process has a {dist.get_backend()} group of "
                f"{dist.get_world_size()} (run it in a process of its own)")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _make_mesh(mesh_shape: Sequence[int]):
    """``make_production_mesh`` for (16, 16) and (2, 16, 16); another shape
    (a test's small mesh) over the same axis names."""
    from repro_torch.launch.mesh import compat_make_mesh, make_production_mesh
    shape = tuple(mesh_shape)
    if shape in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(shape) == 3)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return compat_make_mesh(shape, axes)


@contextlib.contextmanager
def _train_flags(shape: ShapeConfig):
    """The reference's: banded-SWA, grouped-GQA and bf16-score layouts are
    inference wins, so train cells keep baseline attention."""
    saved = dataclasses.replace(perf.FLAGS)
    if shape.kind == "train":
        perf.FLAGS.gqa_grouped = False
        perf.FLAGS.swa_banded = False
        perf.FLAGS.attn_bf16_scores = False
    try:
        yield
    finally:
        perf.FLAGS.__dict__.update(saved.__dict__)


def _fake_like(tree, device: str):
    """Meta tensors -> fake tensors of the same shapes and dtypes (under
    the active ``FakeTensorMode``); other leaves stay."""
    if isinstance(tree, dict):
        return {k: _fake_like(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = (_fake_like(v, device) for v in tree)
        return (type(tree)(*leaves) if hasattr(tree, "_fields")
                else tuple(leaves))
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    return tree


def _quantized(cfg: ModelConfig, params, p_sh, qbits: int, mesh):
    """The reference's weight-only quantized serving tree: int8 codes (W8)
    or the port's packed nibbles (W4, ``quant.pack.pack_int4``'s layout,
    (..., N/2) uint8) with (..., 1, N) f32 scales, and its shardings."""
    from repro_torch.quant.ptq import is_quantizable
    qparams, q_sh = {}, {}
    for k, v in params.items():
        if is_quantizable(k, v) and not k.startswith(("embed/", "lm_head/")):
            if qbits <= 4:
                qparams[k] = torch.empty(
                    tuple(v.shape[:-1]) + (v.shape[-1] // 2,),
                    dtype=torch.uint8, device="meta")
            else:
                qparams[k] = torch.empty(v.shape, dtype=torch.int8,
                                         device="meta")
            scale = torch.empty(tuple(v.shape[:-2]) + (1, v.shape[-1]),
                                dtype=torch.float32, device="meta")
            qparams[k + "@scale"] = scale
            q_sh[k + "@scale"] = S.param_sharding_for(
                cfg, {k: scale}, mesh)[k]
        else:
            qparams[k] = v
        q_sh[k] = p_sh[k]
    return qparams, q_sh


def _dequant_params(cfg: ModelConfig, qbits: int):
    """The in-step dequant of :func:`_quantized`'s tree (identity without
    quantization)."""
    from repro_torch.models.params import _dtype
    from repro_torch.quant.pack import unpack_int4
    dt = _dtype(cfg.dtype)

    def dequant(qp):
        if not qbits:
            return qp
        out = {}
        for k, v in qp.items():
            if k.endswith("@scale"):
                continue
            if k + "@scale" in qp:
                codes = unpack_int4(v) if qbits <= 4 else v
                out[k] = (codes.to(torch.float32) * qp[k + "@scale"]).to(dt)
            else:
                out[k] = v
        return out

    return dequant


def _build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *, remat: bool,
                grad_compress: bool, extra: Dict):
    """-> (step fn, its abstract arguments as meta tensors, their
    shardings on ``mesh``)."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime import model_api
    from repro_torch.runtime.train import jit_train_step, state_shardings
    from repro_torch.sharding import place_tree, tp_size
    tp_total = tp_size(mesh)
    if shape.kind == "train":
        state = S.abstract_train_state(cfg, shape, tp_total, grad_compress)
        batch = S.input_specs(cfg, shape)
        step = jit_train_step(cfg, OptConfig(), mesh, state, batch,
                              remat=remat, grad_compress=grad_compress,
                              microbatches=extra.get("microbatches", 1))
        return step, (state, batch), (state_shardings(cfg, state, mesh),
                                      S.batch_sharding(batch, mesh))
    params = S.abstract_inference_params(cfg, shape, tp_total)
    qbits = int(extra.get("quant_bits", 0) or 0)
    p_sh = S.param_sharding_for(cfg, params, mesh)
    if qbits:
        params, p_sh = _quantized(cfg, params, p_sh, qbits, mesh)
    dequant = _dequant_params(cfg, qbits)
    if shape.kind == "prefill":
        batch = S.input_specs(cfg, shape)

        def prefill(p, b):
            logits, _ = model_api.forward_logits(
                dequant(p), b, cfg, mesh=mesh, tp_total=tp_total,
                ssd_kernel=False)
            return logits

        return prefill, (params, batch), (p_sh, S.batch_sharding(batch, mesh))
    state = S.abstract_decode_state(cfg, shape, extra.get("kv_dtype"))
    toks = S.input_specs(cfg, shape)["tokens"]
    st_sh = S.decode_state_sharding(cfg, state, mesh)

    def decode(p, t, st):
        # the state donated, as the reference's decode cell donates it:
        # ``new`` holds the state's own tensors, which place_tree keeps
        logits, new = model_api.decode_step(dequant(p), t, st, cfg,
                                            mesh=mesh, tp_total=tp_total,
                                            donate=True)
        return logits, place_tree(new, st_sh)

    return decode, (params, toks, state), (
        p_sh, S.batch_sharding({"tokens": toks}, mesh)["tokens"], st_sh)


def cut_layers(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg`` cut to ``layers`` layers, and as many encoder layers where
    it has an encoder: the depth of a cut dry-run."""
    enc = {"enc_layers": layers} if cfg.enc_layers else {}
    return dataclasses.replace(cfg, n_layers=layers, **enc)


def trace_cell(cfg: ModelConfig, shape: ShapeConfig,
               mesh_shape: Sequence[int], *, remat: bool = True,
               grad_compress: bool = False,
               extra: Optional[Dict] = None,
               n_sites: Optional[int] = N_SITES,
               probe: Optional[PeakProbe] = None) -> Dict:
    """Trace one step of ``cfg`` x ``shape`` on a fake mesh of
    ``mesh_shape`` under the counters (and ``probe``).
    -> {flops, bytes, collective (CollectiveStats), sites (the
    ``n_sites`` largest of :meth:`StepCounter.top_sites`, None: all),
    memory, lower_s, trace_s, ops}.  Nothing is allocated: the fake mode
    takes no real tensor (``allow_non_fake_inputs=False``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.sharding import place_tree
    extra = extra or {}
    with fake_group(math.prod(mesh_shape)), _train_flags(shape):
        t0 = time.perf_counter()
        mesh = _make_mesh(mesh_shape)
        step, abstract, shardings = _build_step(
            cfg, shape, mesh, remat=remat, grad_compress=grad_compress,
            extra=extra)
        with FakeTensorMode(allow_non_fake_inputs=False):
            args = tuple(place_tree(a, s) for a, s in
                         zip(_fake_like(abstract, mesh.device_type),
                             shardings))
            lower_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, counter, memory = measure(step, *args, probe=probe)
            trace_s = time.perf_counter() - t0
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collective": counter.collective,
            "sites": counter.top_sites(n_sites), "memory": memory,
            "ops": counter.ops, "lower_s": lower_s, "trace_s": trace_s}


def trace_pair(arch: str, shape_name: str, mesh_name: str,
               layers: int = 0, probe: Optional[PeakProbe] = None) -> Dict:
    """``arch`` x ``shape_name`` on the production mesh ``mesh_name``, cut
    to ``layers`` layers (0: the config's depth), traced -> one rank's
    {peak_bytes, argument_bytes, memory (:func:`measure`'s), all_gather,
    wire_bytes, counts, sites (the :data:`N_SITES` largest collective
    sites), trace_s}."""
    cfg = get_config(arch)
    if layers:
        cfg = cut_layers(cfg, layers)
    traced = trace_cell(cfg, get_shape(shape_name),
                        PRODUCTION_MESHES[mesh_name], probe=probe)
    coll = traced["collective"]
    return {"peak_bytes": traced["memory"]["peak_bytes"],
            "argument_bytes": traced["memory"]["argument_bytes"],
            "memory": traced["memory"],
            "all_gather": float(coll.bytes_by_op.get("all-gather", 0.0)),
            "wire_bytes": float(coll.wire_bytes),
            "counts": dict(coll.counts), "sites": traced["sites"],
            "trace_s": traced["trace_s"]}


def report_for(arch: str, shape: ShapeConfig, mesh_name: str, chips: int,
               traced: Dict, cfg: ModelConfig) -> RooflineReport:
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=float(traced["flops"]),
        bytes_per_device=float(traced["bytes"]),
        collective=traced["collective"],
        model_flops=model_flops_for(cfg, shape, cfg.active_param_count()))


def cell_path(out_dir: str, arch: str, shape_name: str, mesh_name: str,
              tag: str = "") -> str:
    suffix = f"_{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}"
                                 f"{suffix}.json")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             remat: bool = True, grad_compress: bool = False,
             extra: Optional[Dict] = None, out_dir: str = ARTIFACT_DIR,
             tag: str = "", verbose: bool = True,
             n_sites: Optional[int] = N_SITES) -> Dict:
    """Trace one cell on the production mesh (``PRODUCTION_MESHES``) and
    write its report (``collective_sites``: the ``n_sites`` largest, None:
    all)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    mesh_shape = PRODUCTION_MESHES[mesh_name]
    chips = math.prod(mesh_shape)
    traced = trace_cell(cfg, shape, mesh_shape, remat=remat,
                        grad_compress=grad_compress, extra=extra,
                        n_sites=n_sites)
    rep = report_for(arch, shape, mesh_name, chips, traced, cfg)
    mem = traced["memory"]
    coll = traced["collective"]
    result = {**rep.to_dict(), "memory_analysis": mem,
              "lower_s": round(traced["lower_s"], 1),
              "trace_s": round(traced["trace_s"], 1),
              "kind": shape.kind, "remat": remat,
              "grad_compress": grad_compress, "extra": extra or {},
              "n_params": cfg.param_count(),
              "n_active": cfg.active_param_count(),
              "collective_nvlink_wire_bytes": coll.nvlink_wire_bytes,
              "collective_ib_wire_bytes": coll.ib_wire_bytes,
              "collective_sites": traced["sites"],
              "ops": traced["ops"], "status": "ok"}
    os.makedirs(out_dir, exist_ok=True)
    with open(cell_path(out_dir, arch, shape_name, mesh_name, tag), "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        suffix = f"_{tag}" if tag else ""
        print(f"[ok] {arch} x {shape_name} x {mesh_name}{suffix}: "
              f"trace={traced['trace_s']:.0f}s bound={result['bound']} "
              f"compute={result['compute_s']:.2e}s "
              f"memory={result['memory_s']:.2e}s "
              f"collective={result['collective_s']:.2e}s "
              f"useful={result['useful_flops_ratio']:.2f} "
              f"mfu={result['mfu']:.3f}", flush=True)
        print(f"     mem/device: args={mem['argument_bytes'] / 2**30:.2f}GiB "
              f"temps={mem['temp_bytes'] / 2**30:.2f}GiB", flush=True)
    return result


def _cells(args) -> List[Tuple[str, str]]:
    if args.all:
        return [(arch, shape.name) for arch in ARCH_IDS
                for shape in shapes_for(get_config(arch))]
    if not (args.arch and args.shape):
        raise SystemExit("--arch/--shape or --all")
    return [(args.arch, args.shape)]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="disable repro_torch.perf optimizations "
                         "(paper-faithful run)")
    ap.add_argument("--quant-bits", type=int, default=0,
                    help="weight-quantized serving (8/4): decode/prefill cells")
    ap.add_argument("--kv-dtype", default=None,
                    help="KV-cache dtype for decode cells (a torch dtype "
                         "name, e.g. float8_e4m3fn)")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)
    if args.baseline:
        perf.set_baseline()

    cells = _cells(args)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            suffix = f"_{args.tag}" if args.tag else ""
            path = cell_path(args.out, arch, shape, mesh_name, args.tag)
            if not args.force and os.path.exists(path):
                print(f"[skip] {arch} x {shape} x {mesh_name}{suffix} "
                      "(cached)", flush=True)
                continue
            extra = {}
            if args.microbatches > 1:
                extra["microbatches"] = args.microbatches
            if args.quant_bits:
                extra["quant_bits"] = args.quant_bits
            if args.kv_dtype:
                extra["kv_dtype"] = args.kv_dtype
            try:
                run_cell(arch, shape, multi_pod=mp, remat=not args.no_remat,
                         grad_compress=args.grad_compress,
                         extra=extra or None, out_dir=args.out, tag=args.tag)
            except Exception as e:  # noqa: BLE001 -- report every cell
                failures.append((arch, shape, mesh_name, repr(e)))
                print(f"[FAIL] {arch} x {shape} x {mesh_name}: {e}",
                      flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nall requested cells traced OK")


if __name__ == "__main__":
    main()
