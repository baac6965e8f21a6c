"""Async, atomic, elastic checkpointing with numpy files (counterpart of
``repro.ckpt.checkpoint``).

The on-disk layout and manifest are the reference's, so a checkpoint
written by either package restores in the other:

  * ``<dir>/step_<8 digits>/`` holds one ``.npy`` per leaf (the leaf's path
    with ``/`` as ``__``) and ``manifest.json`` (step, extra, and each
    leaf's file, shape and logical dtype); nested dicts flatten to paths
    joined by ``|``;
  * numpy has no bfloat16 (nor float8): such a leaf is stored as its
    same-width unsigned view, the logical dtype in the manifest;
  * writes go to ``<dir>.tmp`` and then ``os.replace``, so a crash
    mid-save never shadows the latest good checkpoint;
  * ``AsyncCheckpointer.save`` copies the tree to host memory before it
    returns (the caller may go on to change its tensors) and writes on a
    daemon thread;
  * ``restore`` returns CPU tensors, or places each leaf where its entry
    in ``shardings`` says: a ``torch.device``, or a
    :class:`repro_torch.sharding.NamedSharding` (the reference's elastic
    re-mesh: the leaf becomes a DTensor on that mesh, whatever mesh wrote
    it);
  * on a device mesh a DTensor leaf is saved as its global value; every
    rank of the process group makes the same calls, rank 0 writes the
    files, and ``AsyncCheckpointer.wait`` ends with a barrier so no rank
    reads a checkpoint before it is written.  Only rank 0 assembles global
    values: each rank holding a distinct shard sends it to rank 0 (one
    shard at a time into a buffer on rank 0's device), which pastes it
    into a host tensor; the other ranks keep no copy.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import is_dtensor

# logical dtype name -> (torch dtype, the unsigned numpy view it is stored as)
_VIEWED = {"bfloat16": (torch.bfloat16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8)}
# the unsigned view -> the torch and numpy dtypes that carry its bits
# between the two (torch's uint16 support varies with its version)
_CARRIER = {np.uint16: (torch.int16, np.int16), np.uint8: (torch.uint8,
                                                            np.uint8)}


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}|"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("|")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _storage_view(v, copy: bool = True) -> Tuple[np.ndarray, str]:
    """A leaf (tensor on any device, array or scalar) -> (a host array
    ``np.save`` round-trips, its logical dtype name).  The array is a copy
    (``copy=False`` for a CPU tensor no one else holds): later writes to
    the tensor do not reach it."""
    if not isinstance(v, torch.Tensor):
        a = np.array(v)
        if a.dtype.name in _VIEWED:          # an ml_dtypes array
            return a.view(_VIEWED[a.dtype.name][1]), a.dtype.name
        return a, a.dtype.name
    t = v.detach().to("cpu", copy=copy)
    name = str(t.dtype).removeprefix("torch.")
    if name in _VIEWED:
        view = _VIEWED[name][1]
        return t.view(_CARRIER[view][0]).numpy().view(view), name
    return t.numpy(), name


def _logical_view(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """A loaded array and its manifest dtype -> a CPU tensor of that dtype,
    bit for bit."""
    if dtype_str in _VIEWED:
        dt, view = _VIEWED[dtype_str]
        if arr.dtype != view:
            raise ValueError(f"a {dtype_str} leaf stored as {arr.dtype}, "
                             f"expected {np.dtype(view)}")
        ndt = _CARRIER[view][1]
        return torch.from_numpy(np.asarray(arr, order="C").view(ndt)).view(dt)
    if arr.dtype.name != dtype_str:
        raise ValueError(f"leaf stored as {arr.dtype}, manifest says "
                         f"{dtype_str}")
    return torch.from_numpy(np.asarray(arr, order="C"))


def _group_size() -> int:
    """Ranks of the default process group (1 without one)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _writes() -> bool:
    """Whether this rank writes checkpoint files (rank 0, or no group)."""
    return _group_size() == 1 or torch.distributed.get_rank() == 0


def _local_box(shape: Sequence[int], mesh_shape: Sequence[int],
               placements, coord: Sequence[int]
               ) -> Tuple[List[int], List[int]]:
    """(offset, size) of the shard the mesh position ``coord`` holds of a
    tensor of ``shape``: each ``Shard(d)`` mesh dim, in mesh order, cuts
    the piece left so far along ``d`` as ``torch.chunk`` does (pieces of
    ceil(n / k), the last ones shorter or empty)."""
    off, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d = p.dim
            step = -(-size[d] // mesh_shape[i])
            start = min(coord[i] * step, size[d])
            off[d] += start
            size[d] = min(start + step, size[d]) - start
    return off, size


def _gather_to_writer(v) -> Optional[torch.Tensor]:
    """A DTensor's global value as a CPU tensor on rank 0, None elsewhere.
    Each shard is sent once, by the rank at position 0 on every mesh dim
    that replicates it; rank 0 receives the shards one at a time."""
    from torch.distributed.tensor import Replicate
    dist = torch.distributed
    if any(p.is_partial() for p in v.placements):
        v = v.redistribute(placements=[Replicate() if p.is_partial() else p
                                       for p in v.placements])
    mesh, local = v.device_mesh, v.to_local()
    ranks = mesh.mesh.reshape(-1).tolist()
    coords = list(itertools.product(*(range(n) for n in mesh.shape)))
    if 0 not in ranks:
        raise ValueError("rank 0 writes checkpoints; this mesh has no rank 0")
    repl = [i for i, p in enumerate(v.placements) if not p.is_shard()]
    me = dist.get_rank()
    if me != 0:
        c = coords[ranks.index(me)]
        if local.numel() and not any(c[i] for i in repl):
            dist.send(local.contiguous().reshape(-1).view(torch.uint8), dst=0)
        return None
    out = torch.empty(tuple(v.shape), dtype=v.dtype)
    for r, c in zip(ranks, coords):
        off, size = _local_box(v.shape, mesh.shape, v.placements, c)
        if any(c[i] for i in repl) or 0 in size:
            continue
        if r == 0:
            part = local
        else:
            part = torch.empty(int(np.prod(size)) * v.element_size(),
                               dtype=torch.uint8, device=local.device)
            dist.recv(part, src=r)
            part = part.view(v.dtype).reshape(size)
        out[tuple(slice(o, o + n) for o, n in zip(off, size))] = part.cpu()
    return out


def _host(tree: Dict[str, Any]
          ) -> Optional[Dict[str, Tuple[np.ndarray, str]]]:
    """The tree's leaves as host arrays on the writing rank, None on the
    others (which only send their DTensor shards to it)."""
    writes = _writes()
    out = {}
    for k, v in _flatten(tree).items():
        gathered = isinstance(v, torch.Tensor) and is_dtensor(v)
        if gathered:
            v = _gather_to_writer(v)
        if writes:
            out[k] = _storage_view(v, copy=not gathered)
    return out if writes else None


def save(tree: Dict[str, Any], directory: str, step: int,
         extra: Optional[Dict] = None) -> str:
    """Synchronous checkpoint write.  Returns the checkpoint path."""
    host = _host(tree)
    path = os.path.join(directory, f"step_{step:08d}")
    if _writes():
        _write(host, directory, step, extra)
    if _group_size() > 1:
        torch.distributed.barrier()
    return path


def _write(host: Dict[str, Tuple[np.ndarray, str]], directory: str, step: int,
           extra: Optional[Dict]) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "arrays": {}}
    for k, (v, dtype) in host.items():
        fname = k.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), v)
        manifest["arrays"][k] = {"file": fname, "shape": list(v.shape),
                                 "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


class AsyncCheckpointer:
    """Saves on a daemon thread, one save in flight at a time, keeping the
    newest ``keep`` checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, tree: Dict[str, Any], step: int,
             extra: Optional[Dict] = None) -> None:
        self.wait()  # one in-flight save at a time
        host = _host(tree)
        if not _writes():
            return

        def work():
            _write(host, self.directory, step, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _group_size() > 1:
            torch.distributed.barrier()

    def _gc(self) -> None:
        steps = sorted(list_steps(self.directory))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None,
            shardings: Optional[Dict[str, Any]] = None):
    """Load a checkpoint -> (tree of tensors, step, extra).  Leaves are CPU
    tensors unless ``shardings`` (a tree like the checkpoint's, of
    ``torch.device``, ``NamedSharding`` or None) places them: on a device,
    or as DTensors on a mesh (every rank of the mesh restores)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_sh = _flatten(shardings) if shardings else {}
    flat = {}
    for k, meta in manifest["arrays"].items():
        t = _logical_view(np.load(os.path.join(path, meta["file"])),
                          meta["dtype"])
        sh = flat_sh.get(k)
        if hasattr(sh, "place"):
            t = sh.place(t.to(sh.mesh.device_type))
        elif sh is not None:
            t = t.to(sh)
        flat[k] = t
    return _unflatten(flat), manifest["step"], manifest["extra"]
