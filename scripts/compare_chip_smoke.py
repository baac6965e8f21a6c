#!/usr/bin/env python3
"""Side-by-side kernel times from ``chip_smoke.py`` runs.

    python3 scripts/compare_chip_smoke.py A.json [B.json ...]

Each argument is the ``build/chip_smoke/chip_smoke.json`` of one run of
``chip_smoke.py``, or the file a ``chip_smoke.py --conv2d-stream`` run
writes (for example a parent commit's and a change's, run in turn on one
card).  Prints, for every timed call of ``qgemm``,
``qgemm_f32``, ``qconv_dw``, ``qconv_dw_f32``, ``conv2d_stream`` and
``ssd_scan`` in the first run, the kernel's device time per call in each
run that timed the same call (the profiler's CUDA activity; "-" where a run
did not), its CUDA-graph time where the run has one, and the plain
version's and the library call's device times and the bound from the first
run, in ms; then each ``ssd_scan`` phase's time in the runs that time its
phases, and each run's LM prefill tokens/s.  Put a run that has the library
times first (runs before the padded ``torch._int_mm`` yardstick have none
for most int8 shapes).
"""
from __future__ import annotations

import json
import sys

KERNELS = ("qgemm", "qgemm_f32", "qconv_dw", "qconv_dw_f32", "conv2d_stream",
           "ssd_scan")


def _key(row) -> tuple:
    return tuple(row["shape"]) + tuple(row.get("strides", []))


def _ms(m):
    if m is None:
        return None
    return m["device_ms"] if m.get("device_ms") is not None else m["event_ms"]


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.5f}"


def main(paths) -> int:
    runs = [json.load(open(p)) for p in paths]
    head = ["kernel", "shape"] + [f"ms[{i}]" for i in range(len(runs))] + [
        f"graph_ms[{i}]" for i in range(len(runs))] + [
        "plain_ms", "library_ms", "library_graph_ms", "bound_ms"]
    print(" | ".join(head))
    for name in KERNELS:
        by_run = [{_key(row): row for row in r["times"].get(name, [])}
                  for r in runs]
        for row in runs[0]["times"].get(name, []):
            rows = [m.get(_key(row)) for m in by_run]
            lib = row["library"]
            cells = [name, "x".join(map(str, _key(row)))]
            cells += [_fmt(r and _ms(r["kernel"])) for r in rows]
            cells += [_fmt(r and r["kernel"].get("graph_ms")) for r in rows]
            cells += [_fmt(_ms(row["plain"])), _fmt(_ms(lib)),
                      _fmt(None if lib is None else lib.get("graph_ms")),
                      f"{row['bound_ms']:.7f} ({row['bound_by']})"]
            print(" | ".join(cells))
    ssd = [r["times"].get("ssd_scan", [{}])[0] for r in runs]
    phases = next((s["phases"] for s in ssd if "phases" in s), {})
    for name, first in phases.items():
        cells = [f"ssd_scan.{name}", "-"] + [
            _fmt(_ms(s.get("phases", {}).get(name, {}).get("kernel")))
            for s in ssd]
        print(" | ".join(cells + [f"{first['bound_ms']:.7f} "
                                  f"({first['bound_by']})"]))
    for i, r in enumerate(runs):
        tps = [f"{p['tokens_per_s']:.1f}" for p in r.get("main_paths", [])
               if "tokens_per_s" in p]
        total = r.get("total_s")
        print(f"[{i}] {paths[i]}: card {r.get('card')}, total "
              f"{'-' if total is None else f'{total:.1f}'} s, prefill "
              f"tokens/s {tps}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
