"""Serving launcher: batched decode with the adaptive mixed-precision server
(counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --smoke --batch 4 --steps 32

The energy budget drains over the run and the RuntimePolicy drops the
working point (W8 -> W4 -> W2) without reloading weights.  The arguments are
the reference's, default arch included, plus ``--device`` (``cuda`` unless
the caller asks for the CPU).  As in the reference,
``--smoke`` is a ``store_true`` flag that defaults to on, so the CLI always
runs the smoke config; full width is reached through the functions.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.adaptive import RuntimePolicy, WorkingPoint
from repro_torch.device import resolve_device
from repro_torch.models.params import init_params
from repro_torch.runtime import model_api
from repro_torch.runtime.serve import AdaptiveLMServer


def main(argv: Optional[List[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, g, max_seq=args.seq, device=dev)

    points = [WorkingPoint("w8", 8), WorkingPoint("w4", 4), WorkingPoint("w2", 2)]
    server = AdaptiveLMServer(params, cfg, points,
                              RuntimePolicy(points, thresholds=[0.66, 0.33]))

    tok = torch.randint(0, cfg.vocab, (args.batch, 1), generator=g, device=dev)
    batch = {"tokens": tok}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((args.batch, cfg.enc_seq, cfg.d_model),
                                      generator=g, device=dev,
                                      dtype=torch.bfloat16)
    state = model_api.init_decode_state(params, batch, cfg, args.batch,
                                        args.seq)
    budget = 1.0
    switches = []
    last_pt = None
    for i in range(args.steps):
        logits, state, m = server.decode(tok, state, energy_budget_frac=budget)
        tok = torch.argmax(logits[:, -1:, : cfg.vocab], dim=-1)
        budget -= 1.0 / args.steps
        if m.point != last_pt:
            switches.append((i, m.point))
            last_pt = m.point
        if i % 8 == 0:
            print(f"step {i:3d} point={m.point} budget={budget:.2f} "
                  f"weight_bytes_read={m.weight_bytes_read:,}")
    print("working-point switches:", switches)
    print("served", args.steps, "decode steps,", args.batch, "streams")
    return switches


if __name__ == "__main__":
    main()
