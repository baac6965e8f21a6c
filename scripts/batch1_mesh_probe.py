#!/usr/bin/env python3
"""Whether a batch of 1 runs on a one-rank (1, 1) mesh with this torch.

    PYTHONPATH=src python3 scripts/batch1_mesh_probe.py [--device cpu]

qwen1.5-0.5b's smoke config at (1, 32) tokens: the prefill
(``make_prefill_step(cfg, mesh=mesh)``) and one train step
(``jit_train_step``) on a real one-rank mesh (``make_local_mesh``: NCCL on
the card, gloo with ``--device cpu``), then the same prefill and train step
traced on a fake (1, 1) mesh (``launch.dryrun.trace_cell``).  Prints the
torch version, one line a case (``runs``, or where it raises, the error and
its innermost frame in the port) and a last JSON line.  Exits 0 either way:
the answer is the output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback


def _where(exc: BaseException) -> str:
    """The innermost frame of ``exc``'s traceback inside ``repro_torch``."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename]
    if not frames:
        return "?"
    f = frames[-1]
    return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} {f.name}"


def _case(name: str, fn, out: dict) -> None:
    try:
        fn()
        out[name] = "runs"
    except Exception as exc:  # noqa: BLE001 -- the probe reports it
        out[name] = (f"raises {type(exc).__name__} at {_where(exc)}: "
                     f"{str(exc).splitlines()[0][:200]}")
    print(f"{name}: {out[name]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.serve import make_prefill_step
    from repro_torch.runtime.train import init_train_state, jit_train_step
    from repro_torch.sharding import (batch_spec, param_sharding, place,
                                      place_tree)

    dev = args.device
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                              dtype="float32")
    B, S = 1, 32
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    out = {"torch": torch.__version__}
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
    batch = batch_at(data, 0, dev)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=1)
    mesh = make_local_mesh(device=dev)
    try:
        def prefill():
            with torch.no_grad():
                make_prefill_step(cfg, mesh=mesh)(
                    place_tree(params, param_sharding(params, mesh)),
                    {"tokens": place(batch["tokens"], mesh,
                                     batch_spec(mesh, None))})

        def train():
            state = init_train_state(params)
            jit_train_step(cfg, opt, mesh, state, batch)(state, batch)

        _case("real (1, 1) mesh prefill", prefill, out)
        _case("real (1, 1) mesh train step", train, out)
    finally:
        dist.destroy_process_group()
    for kind in ("prefill", "train"):
        _case(f"fake (1, 1) mesh {kind}",
              lambda kind=kind: dryrun.trace_cell(
                  cfg, ShapeConfig("b1", S, B, kind), (1, 1)), out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
