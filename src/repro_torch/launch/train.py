"""Training launcher (counterpart of ``repro.launch.train``): the mesh,
seeded weights, the sharded train state, and the fault-tolerant loop
(checkpoint/restart, straggler watchdog, resumable data).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --batch 8 --seq 2048 --microbatches 2 --steps 6
    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \\
        --arch qwen1.5-0.5b

The arguments are the reference's plus ``--device`` (``cuda`` unless the
caller asks for the CPU).  Under a launcher such as ``torchrun`` (``WORLD_SIZE`` > 1 in the
environment) each rank joins the launcher's group (``env://``; NCCL on
``cuda:LOCAL_RANK``, gloo under ``--device cpu``) before it picks its mesh.
``--smoke`` takes the reduced config and ``launch.mesh.make_local_mesh``
(the ranks there are: one process is a (1, 1) mesh), as the reference
does.  Without it the reference always takes the 16x16 production mesh;
the port takes it (2x16x16 for 512 ranks) on a group of 256 or 512 ranks,
raises on a group of another size, as the reference does without a pod,
and runs the full config on one device, without a mesh, only when one
process runs alone (:func:`launch_mesh`).  On a mesh the state is placed
by ``train.state_shardings`` and stepped by ``train.jit_train_step``, and
rank 0 writes the checkpoints.  A run resumes from the latest checkpoint
in ``--ckpt-dir`` when there is one, as the reference's does.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import DataConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime import ft
from repro_torch.runtime.train import (init_train_state, jit_train_step,
                                       make_train_step, state_shardings)
from repro_torch.sharding import mesh_shape, place_tree, tp_size

PRODUCTION_WORLDS = (256, 512)


def launched_world() -> int:
    """The world size a launcher set in the environment (``WORLD_SIZE``);
    1 for a process that runs alone."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def _check_world(world: int) -> None:
    if world not in PRODUCTION_WORLDS:
        raise ValueError(f"the production mesh needs {PRODUCTION_WORLDS[0]} "
                         f"or {PRODUCTION_WORLDS[1]} ranks; the launcher "
                         f"started {world} (use --smoke for a local mesh)")


def join_launched_group(device: DeviceLike = None) -> torch.device:
    """Join the default group a launcher described in the environment
    (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo when the caller
    asks for the CPU.  Returns this rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return dev


def launch_mesh(smoke: bool, device: DeviceLike = None):
    """The launcher's mesh: ``make_local_mesh`` under ``--smoke``; else the
    production mesh on a default group of 256 or 512 ranks, ``ValueError``
    on a group of another size, and None (one device, no mesh) when there
    is no group or one of a single rank."""
    if smoke:
        return make_local_mesh(device=device)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    _check_world(dist.get_world_size())
    return make_production_mesh(multi_pod=dist.get_world_size() == 512)


def main(argv: Optional[List[str]] = None) -> ft.LoopResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    started = not dist.is_initialized()
    world = launched_world()
    if started and world > 1 and not args.smoke:
        _check_world(world)             # before any rank waits on the others
    try:
        if started and world > 1:
            dev = join_launched_group(dev)
        mesh = launch_mesh(args.smoke, dev)
        return _train(args, cfg, dev, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, dev, mesh) -> ft.LoopResult:
    tp_total = 1 if mesh is None else tp_size(mesh)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, g, max_seq=args.seq, tp_total=tp_total,
                         device=dev)
    n_params = sum(p.numel() for p in params.values())
    where = "none" if mesh is None else mesh_shape(mesh)
    print(f"arch={cfg.name} params={n_params:,} device={dev} mesh={where}")

    state = init_train_state(params, grad_compress=args.grad_compress)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    st_sh = None
    if mesh is None:
        step = make_train_step(cfg, opt_cfg, remat=True,
                               grad_compress=args.grad_compress,
                               microbatches=args.microbatches)
    else:
        batch = input_specs(cfg, ShapeConfig("launch", args.seq, args.batch,
                                             "train"))
        step = jit_train_step(cfg, opt_cfg, mesh, state, batch, remat=True,
                              grad_compress=args.grad_compress,
                              microbatches=args.microbatches)
        st_sh = state_shardings(cfg, state, mesh)
        state = place_tree(state, st_sh)
    result = ft.run_training(step, state, data_cfg, args.steps,
                             args.ckpt_dir, ckpt_every=args.ckpt_every,
                             state_shardings=st_sh)
    log = result.metrics_log
    first = log[0]["loss"] if log else float("nan")
    last = log[-1]["loss"] if log else float("nan")
    print(f"done: steps={result.final_step} restarts={result.restarts} "
          f"loss {first:.4f} -> {last:.4f} "
          f"stragglers_flagged={len(result.flagged_steps)}")
    return result


if __name__ == "__main__":
    main()
