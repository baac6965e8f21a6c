#!/usr/bin/env python3
"""Both packages' dry-runs of one cell, side by side, on the host's CPU.

    PYTHONPATH=src python3 scripts/dryrun_parity.py --arch qwen1.5-0.5b \\
        --shape train_4k [--layers 2] [--multi-pod]

The reference (``repro.launch.dryrun``) lowers and compiles the cell's step
for 256 (or 512) forced host devices, in a process of its own: importing
it sets ``XLA_FLAGS``.  Its memory is XLA's CPU-backend buffer assignment
of that program (``memory_analysis()``: argument + temp bytes), computed
on the host, not a device figure; its collectives are
``parse_collectives`` of the compiled HLO, the layers unrolled.  The port
(``repro_torch.launch.dryrun.trace_cell``) traces the same cut cell on
fake tensors over a fake process group.  Both are per rank.  ``--layers``
cuts the depth, an encoder's too (2 by default; 0 keeps the config's,
whose compile takes the reference minutes and several GB).

Prints one line a figure and a last JSON line ``{"reference": {...},
"port": {...}}``.  ``--reference-only`` prints the reference's JSON line
alone (``REF {...}``) for one or more ``--cell arch:shape``, as
``tests/test_torch_head_sharding.py`` reads it; ``--port-only`` the
port's (``PORT {...}``: ``trace_pair``'s report, its ``memory`` with the
peak, argument, output, temp and alias bytes) for ``--arch``/``--shape``.  Needs jax for the
reference; the port's half needs torch only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def reference_cells(cells, layers: int, multi_pod: bool) -> dict:
    """{arch: {args_temps, argument_bytes, temp_bytes, all_gather,
    wire_bytes, counts}} of the reference's cut cells, each also under
    ``"arch:shape"`` (two cells of one arch: ``arch`` holds the last), in
    this process: run it in one of its own."""
    from repro.launch import dryrun as J            # forces the host devices
    from repro.configs import get_config, get_shape
    from repro.launch.mesh import make_production_mesh
    from repro.launch.roofline import parse_collectives
    out = {}
    for arch, shape in cells:
        cfg = get_config(arch)
        if layers:
            enc = {"enc_layers": layers} if cfg.enc_layers else {}
            cfg = dataclasses.replace(cfg, n_layers=layers, **enc)
        compiled = J._lower_cell(cfg, get_shape(shape),
                                 make_production_mesh(multi_pod=multi_pod),
                                 unroll=True).compile()
        ma = compiled.memory_analysis()
        st = parse_collectives(compiled.as_text())
        out[arch] = out[f"{arch}:{shape}"] = {
            "argument_bytes": int(ma.argument_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes),
            "args_temps": int(ma.argument_size_in_bytes
                              + ma.temp_size_in_bytes),
            "all_gather": float(st.bytes_by_op.get("all-gather", 0.0)),
            "wire_bytes": float(st.wire_bytes),
            "counts": dict(st.counts)}
    return out


def reference_in_subprocess(cells, layers: int, multi_pod: bool) -> dict:
    """:func:`reference_cells` in a fresh ``python``."""
    args = [sys.executable, os.path.abspath(__file__), "--reference-only",
            "--layers", str(layers)]
    args += [f"--cell={a}:{s}" for a, s in cells]
    if multi_pod:
        args.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(args, env=env, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("REF ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"the reference's dry-run failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(lines[-1][4:])


def port_cell(arch: str, shape: str, layers: int, multi_pod: bool) -> dict:
    """The port's cut cell, per rank."""
    from repro_torch.launch import dryrun as D
    return D.trace_pair(arch, shape, "2x16x16" if multi_pod else "16x16",
                        layers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reference-only", action="store_true")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--cell", action="append", default=[],
                    help="arch:shape (with --reference-only)")
    args = ap.parse_args(argv)
    if args.reference_only:
        cells = [tuple(c.split(":")) for c in args.cell] or [
            (args.arch, args.shape)]
        print("REF " + json.dumps(reference_cells(cells, args.layers,
                                                  args.multi_pod)))
        return 0
    sys.path.insert(0, SRC)
    if args.port_only:
        print("PORT " + json.dumps(port_cell(args.arch, args.shape,
                                             args.layers, args.multi_pod)))
        return 0
    ref = reference_in_subprocess([(args.arch, args.shape)], args.layers,
                                  args.multi_pod)[args.arch]
    port = port_cell(args.arch, args.shape, args.layers, args.multi_pod)
    name = (f"{args.arch} x {args.shape} x "
            f"{'2x16x16' if args.multi_pod else '16x16'}, "
            f"{args.layers or 'all'} layers, per rank")
    print(f"{name}:")
    print(f"  memory: reference args + temps {ref['args_temps'] / 1e9:.4f} GB"
          f" (XLA CPU buffer assignment), port peak "
          f"{port['peak_bytes'] / 1e9:.4f} GB = {port['peak_bytes']} B, of "
          f"which {port['memory']['alias_bytes']} B alias an argument (a "
          f"decode cell's donated state)")
    print(f"  all-gather wire bytes: reference {ref['all_gather'] / 1e6:.3f}"
          f" MB, port {port['all_gather'] / 1e6:.3f} MB")
    print(f"  wire bytes: reference {ref['wire_bytes'] / 1e9:.4f} GB, port "
          f"{port['wire_bytes'] / 1e9:.4f} GB")
    print(f"  counts: reference {ref['counts']}, port {port['counts']}")
    print(json.dumps({"cell": name, "reference": ref, "port": port}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
