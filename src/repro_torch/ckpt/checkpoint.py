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
  * ``restore`` returns CPU tensors, or places each leaf on the device its
    entry in ``shardings`` names (a tree of ``torch.device`` or None: the
    single-device case of the reference's elastic re-mesh).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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


def _storage_view(v) -> Tuple[np.ndarray, str]:
    """A leaf (tensor on any device, array or scalar) -> (a host array
    ``np.save`` round-trips, its logical dtype name).  The array is a copy:
    later writes to the tensor do not reach it."""
    if not isinstance(v, torch.Tensor):
        a = np.array(v)
        if a.dtype.name in _VIEWED:          # an ml_dtypes array
            return a.view(_VIEWED[a.dtype.name][1]), a.dtype.name
        return a, a.dtype.name
    t = v.detach().to("cpu", copy=True)
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


def _host(tree: Dict[str, Any]) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _storage_view(v) for k, v in _flatten(tree).items()}


def save(tree: Dict[str, Any], directory: str, step: int,
         extra: Optional[Dict] = None) -> str:
    """Synchronous checkpoint write.  Returns the checkpoint path."""
    return _write(_host(tree), directory, step, extra)


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

        def work():
            _write(host, self.directory, step, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
    ``torch.device`` or None) names a device for them."""
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
        if flat_sh.get(k) is not None:
            t = t.to(flat_sh[k])
        flat[k] = t
    return _unflatten(flat), manifest["step"], manifest["extra"]
