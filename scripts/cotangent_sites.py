#!/usr/bin/env python3
"""Which residual pins need to hold their cotangent: the port's dry-run of
train pairs with ``sharding.pin_residual`` holding it at every call site,
and with it released (a forward-only ``constrain``) at one site at a time.

    PYTHONPATH=src python3 scripts/cotangent_sites.py --layers 2 \\
        --pair qwen1.5-0.5b:train_4k:16x16 --pair mamba2-1.3b:train_4k:16x16 \\
        --free transformer.py:166 --free transformer.py:169 [-j 4]

A site is ``file:line`` of a ``pin_residual`` call in ``models/`` (the
line the call starts on; several joined by ``,`` release them together).
Each (site, pair) is traced by ``launch.dryrun.trace_pair`` on the fake
production mesh in a fresh process: an SSM's traced peak depends on what
the process traced before.  Prints one line a trace: the released sites
(``-`` for none), the pair, and per rank the peak, all-gather and wire
bytes and the calls at each site; counts on fake tensors, not device
figures.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MODULES = ("transformer", "attention", "ssm", "encdec")


def trace(pair: str, free: str, layers: int) -> dict:
    """The pair traced with the pins at ``free``'s sites released (in this
    process)."""
    import collections
    import importlib

    from repro_torch import sharding
    from repro_torch.launch import dryrun as D
    released = {s for s in free.split(",") if s}
    calls = collections.Counter()

    def pin_residual(x, mesh):
        f = sys._getframe(1)
        site = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
        calls[site] += 1
        if mesh is not None and site in released:
            return sharding.constrain(
                x, mesh, sharding.residual_spec(x.shape[0], mesh))
        return sharding.pin_residual(x, mesh)

    for name in MODULES:
        mod = importlib.import_module(f"repro_torch.models.{name}")
        mod.pin_residual = pin_residual
    arch, shape, mesh = pair.split(":")
    r = D.trace_pair(arch, shape, mesh, layers)
    missing = released - set(calls)
    if missing:
        raise ValueError(f"no pin_residual call at {sorted(missing)}")
    return {"free": free or "-", "pair": pair, "peak_bytes": r["peak_bytes"],
            "all_gather": r["all_gather"], "wire_bytes": r["wire_bytes"],
            "calls": dict(calls)}


def _child(pair: str, free: str, layers: int) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--layers", str(layers), "--pair", pair, "--free", free],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("SITE ")]
    if proc.returncode or not lines:
        return {"free": free or "-", "pair": pair,
                "error": proc.stderr.strip().splitlines()[-1:]}
    return json.loads(lines[-1][5:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--pair", action="append", required=True,
                    help="arch:shape:mesh")
    ap.add_argument("--free", action="append", default=[],
                    help="file:line[,file:line...] released together")
    ap.add_argument("-j", type=int, default=1, help="processes at once")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        sys.path.insert(0, SRC)
        print("SITE " + json.dumps(trace(args.pair[0], args.free[0],
                                         args.layers)))
        return 0
    jobs = [(p, f) for f in [""] + args.free for p in args.pair]
    with ThreadPoolExecutor(args.j) as pool:
        for r in pool.map(lambda j: _child(j[0], j[1], args.layers), jobs):
            if "error" in r:
                print(f"{r['free']} | {r['pair']} | raised {r['error']}")
                continue
            print(f"{r['free']} | {r['pair']} | peak "
                  f"{r['peak_bytes'] / 1e9:.3f} GB all-gather "
                  f"{r['all_gather'] / 1e6:.1f} MB wire "
                  f"{r['wire_bytes'] / 1e9:.4f} GB | calls {r['calls']}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
