"""Training launcher (counterpart of ``repro.launch.train``): seeded
weights, the train state, and the fault-tolerant loop (checkpoint/restart,
straggler watchdog, resumable data) on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --batch 8 --seq 2048 --microbatches 2 --steps 6

The arguments are the reference's plus ``--device`` (``cuda`` unless the
caller asks for the CPU).  ``--smoke`` takes the reduced config; without
it the full config runs on the one device (``tp_total`` 1).  The
reference's 16x16 production mesh (``launch.mesh.make_production_mesh``
with ``train.jit_train_step``) is launched by the dry-run slice, ROADMAP
Queue 1 item 6b.  A run resumes from the latest checkpoint in
``--ckpt-dir`` when there is one, as the reference's does.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime import ft
from repro_torch.runtime.train import init_train_state, make_train_step


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
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, g, max_seq=args.seq, device=dev)
    n_params = sum(p.numel() for p in params.values())
    print(f"arch={cfg.name} params={n_params:,} device={dev}")

    state = init_train_state(params, grad_compress=args.grad_compress)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    step = make_train_step(cfg, opt_cfg, remat=True,
                           grad_compress=args.grad_compress,
                           microbatches=args.microbatches)
    result = ft.run_training(step, state, data_cfg, args.steps,
                             args.ckpt_dir, ckpt_every=args.ckpt_every)
    log = result.metrics_log
    first = log[0]["loss"] if log else float("nan")
    last = log[-1]["loss"] if log else float("nan")
    print(f"done: steps={result.final_step} restarts={result.restarts} "
          f"loss {first:.4f} -> {last:.4f} "
          f"stragglers_flagged={len(result.flagged_steps)}")
    return result


if __name__ == "__main__":
    main()
