"""``greedy_generate``'s decode memory and speed on the card.

    python scripts/decode_memory.py [--arch qwen1.5-0.5b ...] [--batch 4] \
        [--seq-len 32768] [--prompt 16] [--new 16] [--src build/parent/src]

runs ``runtime.serve.greedy_generate`` at full width on seeded weights on
the card, once to warm up and then timed: one JSON line an arch with its
tokens/s (prompt and new tokens over the call's seconds), its peak device
memory above what was held before it, and the card's name and power
limit.  ``--src`` runs another tree's ``repro_torch`` (a parent commit
unpacked with ``git archive``), so two trees compare in one call.  The
dry-run's decode pairs print their peak and alias bytes in phase t's
sweep (``chip_smoke.dryrun_sweep``) and one at a time through
``scripts/dryrun_parity.py --port-only``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "hymba-1.5b", "mamba2-1.3b")


def _use(src: Path) -> None:
    sys.path.insert(0, str(src.resolve()))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def greedy(args) -> int:
    _use(args.src)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.runtime.serve import greedy_generate
    card = _card()
    for arch in args.arch:
        cfg = get_config(arch)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                               generator=gen, device="cuda")
        greedy_generate(params, cfg, prompt, max_new=2, seq_len=args.seq_len)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = greedy_generate(params, cfg, prompt, max_new=args.new,
                              seq_len=args.seq_len)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        assert tuple(out.shape) == (args.batch, args.prompt + args.new)
        print(json.dumps({
            "arch": arch, "batch": args.batch, "seq_len": args.seq_len,
            "prompt": args.prompt, "new": args.new, "seconds": secs,
            "tokens_per_s": args.batch * (args.prompt + args.new) / secs,
            "peak_bytes_above_held": peak, "held_bytes": held,
            "card": card, "torch": torch.__version__,
            "src": str(args.src)}), flush=True)
        del params, out
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32768)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    return greedy(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
