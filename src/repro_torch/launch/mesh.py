"""Device meshes (counterpart of ``repro.launch.mesh``) as
``torch.distributed`` ``DeviceMesh``es with named dims.

Functions, not module-level constants, so importing never touches the
process group.  Single pod: 16x16 = 256 ranks ("data", "model"); multi-pod:
2x16x16 = 512 ranks ("pod", "data", "model").  A mesh covers the ranks of
the default process group: the caller starts the group (a launcher such as
``torchrun``, or ``init_process_group`` with an address, world size and
rank), except that :func:`make_local_mesh` starts a one-rank group itself
when none exists.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def _device_type() -> str:
    """The device type of the default group's backend: ``cuda`` under NCCL,
    ``cpu`` otherwise (gloo, or a test's fake backend)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def compat_make_mesh(shape, axes):
    """``init_device_mesh`` over the default group: ``shape`` must multiply
    out to its world size."""
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           "group; none is initialized")
    return compat_make_mesh(shape, axes)


def start_local_group(device: DeviceLike = None) -> None:
    """A one-rank default group from an in-process store: NCCL on the CUDA
    device (the default; no CUDA raises, as every entry point of the port
    does), gloo when the caller asks for the CPU.  No launcher and no
    address are needed.  A group that exists already must be on
    ``device``'s type."""
    dev = resolve_device(device)
    if dist.is_initialized():
        if _device_type() != dev.type:
            raise ValueError(f"the process group runs on {_device_type()} "
                             f"({dist.get_backend()}), not {dev.type}")
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_local_mesh(model: int = 1, device: DeviceLike = None):
    """(ranks // model, model) mesh over the ranks that are there (one
    process on one card: (1, 1)), on ``device``'s type (the CUDA device
    unless the caller asks for the CPU)."""
    start_local_group(device)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    return compat_make_mesh((n // model, model), ("data", "model"))
