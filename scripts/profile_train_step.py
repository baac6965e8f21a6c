#!/usr/bin/env python3
"""Where one LM train step of the port spends its time, on the GPU.

    PYTHONPATH=src python3 scripts/profile_train_step.py [--arch qwen1.5-0.5b]
        [--batch 4] [--seq 2048] [--out chiprun_out/profile_train.json]

At full width with seeded bf16 weights (``chip_smoke.lm_params``, as in
phase q), on one microbatch of ``batch`` x ``seq`` tokens of the port's
token stream, each timed with ``chip_smoke._event_ms``: the mean of
``--reps`` back-to-back calls between CUDA events, after one warm-up:

* ``grads``: ``loss_fn`` and its gradients with remat, as one microbatch of
  the train step; ``forward``: ``loss_fn`` alone, no graph;
* ``attention_fwd``/``attention_fwd_bwd``: one layer's ``attention.attend``
  (q, k, v after RoPE to the output before ``wo``) alone and with its
  backward, at this call;
* ``head_fwd_bwd``: the final norm, the unembedding and the f32
  cross-entropy over the padded vocab, with their backward;
* ``apply_updates``: one AdamW update of the whole tree;

then the shares they imply (each layer's attention runs its forward twice
under remat, and its backward once) and the profiler's device time per
kernel over one ``grads`` call.  Prints one JSON object (also written to
``--out``), with the card's name and power limit.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import _event_ms, header, lm_params  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "profile_train.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: needs a CUDA device", file=sys.stderr)
        return 2
    card = header()
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.models import transformer
    from repro_torch.models.attention import attend, prefill_route
    from repro_torch.models.common import cross_entropy
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
    from repro_torch.runtime import model_api

    dev = "cuda"
    cfg = get_config(args.arch)
    B, S = args.batch, args.seq
    params = lm_params(cfg, dev)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B),
                     0, dev)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}

    def grads():
        loss, _ = model_api.loss_fn(leaves, batch, cfg, remat=True)
        return torch.autograd.grad(loss, list(leaves.values()),
                                   allow_unused=True)

    def forward():
        with torch.no_grad():
            model_api.loss_fn(params, batch, cfg, remat=True)

    g = torch.Generator(device=dev).manual_seed(1)
    dt = params["embed/table"].dtype
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn((B, S, h, Dh), generator=g, device=dev, dtype=dt,
                           requires_grad=True) for h in (H, Hkv, Hkv))
    pos = torch.arange(S, device=dev)
    dout = torch.randn((B, S, H, Dh), generator=g, device=dev, dtype=dt)

    def attn_fwd():
        with torch.no_grad():
            attend(q, k, v, pos, pos, cfg)

    def attn_fwd_bwd():
        torch.autograd.grad(attend(q, k, v, pos, pos, cfg), (q, k, v), dout)

    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev, dtype=dt,
                    requires_grad=True)

    def head_fwd_bwd():
        logits = transformer._logits(leaves, x, cfg)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab)
        torch.autograd.grad(loss, [x] + [leaves[n] for n in
                                         ("final_norm/w", "embed/table")
                                         if n in leaves])

    opt = init_opt_state(params)
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for k, p in params.items()}

    def update():
        apply_updates(params, zeros, opt, OptConfig())

    fns = {"grads": grads, "forward": forward, "attention_fwd": attn_fwd,
           "attention_fwd_bwd": attn_fwd_bwd, "head_fwd_bwd": head_fwd_bwd,
           "apply_updates": update}
    ms = {k: _event_ms(fn, iters=args.reps, warmup=1)
          for k, fn in fns.items()}
    L = cfg.n_layers
    attn = L * (ms["attention_fwd"] + ms["attention_fwd_bwd"])
    shares = {"attention_in_grads": attn / ms["grads"],
              "head_in_grads": ms["head_fwd_bwd"] / ms["grads"],
              "rest_in_grads": 1 - (attn + ms["head_fwd_bwd"]) / ms["grads"]}

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grads()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # kernels and copies only: an op's row repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append({"name": e.key, "device_ms": dev_us / 1e3,
                         "calls": e.count})
    rows.sort(key=lambda r: -r["device_ms"])
    total = sum(r["device_ms"] for r in rows)
    out = {"card": card, "arch": cfg.name, "shape": [B, S],
           "attention_route": prefill_route(cfg, S), "ms": ms,
           "shares": shares, "profiled_device_ms": total,
           "top_kernels": rows[:args.top],
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "arch", "shape",
                                           "attention_route", "ms", "shares",
                                           "profiled_device_ms")}))
    for r in rows[:args.top]:
        print(f"{r['device_ms']:10.3f} ms {r['calls']:6d}  {r['name'][:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
