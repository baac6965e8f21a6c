#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. header — PyTorch/CUDA versions, the card's name and power limit;
2. build — compiles the hand-written kernels (``src/repro_torch/csrc``) with
   nvcc into ``build/repro_torch/`` and loads them;
3. kernels — each kernel against its plain PyTorch version on the card, over
   bits {8,4,2} x packed x epilogue x ReLU x bias (x strides x pads for the
   depthwise conv) at the main path's shapes and ragged ones: exact equality;
4. main path — separable-cnn at its published config (28x28, stem 8, blocks
   ((16,1),(32,2)), 10 classes) through ``DesignFlow.run(("qtorch",), D8-W8)``
   and ``serve_adaptive`` with the pump running: 66 requests of 1-8 rows
   whose budgets walk W8 -> W4 -> W2, every result held bit for bit against
   the port's plain path on the CPU; the kernels' launch counters are zeroed
   just before and read just after.  mnist-cnn takes the same steps after it;
5. times — each kernel, its plain version and the nearest PyTorch library
   call at the main path's batch-8 shapes: device time per call from the
   profiler's CUDA activity (and the per-call time of back-to-back calls
   between CUDA events, host overhead included), beside the least time the
   card could take (bytes over 3.35 TB/s or int8 operations over 1,979
   TOP/s, whichever is larger).

It prints one ``{"kernels": [...]}`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository's
``src/`` beside it, it exits non-zero and prints no result.  Details go to
``build/chip_smoke/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
SEED = 0


def log(*parts) -> None:
    print(*parts, flush=True)


def header() -> str:
    import torch
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi unavailable (rc={smi.returncode})"
    log(line)
    return line


def build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load_kernels()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s (cached={_build.build_info.get('cached')}) "
        f"-> {_build.build_info.get('path')}")
    for ln in str(_build.build_info.get("log", "")).splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("=="):
            log("  " + ln.strip())
    return secs


def kernels_vs_plain() -> dict:
    import torch
    from repro_torch.kernels import checks
    out = {}
    for name, sweep in (("qgemm", checks.qgemm_sweep),
                        ("qconv_dw", checks.qconv_dw_sweep)):
        t0 = time.perf_counter()
        res = sweep("cuda")
        torch.cuda.synchronize()
        log(f"{name} vs plain ({time.perf_counter() - t0:.1f} s): "
            + "\n  ".join(checks.summarize(res)))
        if res["failures"] or res["max_abs_err"] != 0.0:
            raise AssertionError(f"{name} disagrees with its plain version")
        out[name] = res
    return out


# -- main path ----------------------------------------------------------------

def _params(cfg, separable: bool, device: str):
    """Seeded random weights; BN statistics drawn too, so the folded biases
    are non-zero and the epilogue's bias path is exercised."""
    import torch
    from repro_torch.models import cnn
    g = torch.Generator().manual_seed(SEED)
    init = cnn.init_separable_params if separable else cnn.init_params
    p = init(cfg, g)
    for k in list(p):
        if k.endswith("/scale") or k.endswith("/var"):
            p[k] = 0.5 + torch.rand(p[k].shape, generator=g)
        elif k.endswith("/bias") or k.endswith("/mean"):
            p[k] = 0.1 * torch.randn(p[k].shape, generator=g)
    return {k: v.to(device) for k, v in p.items()}


def main_path(name: str, cfg, separable: bool, device: str = "cuda") -> dict:
    """DesignFlow -> serve_adaptive on ``device`` (the card); every served
    result equal to the port's plain CPU path.  Returns launch counts and
    serving stats."""
    import numpy as np
    import torch
    from repro_torch.core.adaptive import RuntimePolicy
    from repro_torch.core.flow import DEFAULT_POINTS, DesignFlow
    from repro_torch.core.reader import cnn_to_ir, separable_cnn_to_ir
    from repro_torch.kernels.qconv_dw.ops import qconv_dw
    from repro_torch.kernels.qmatmul.ops import qgemm
    from repro_torch.quant.qtypes import DatatypeConfig

    to_ir = separable_cnn_to_ir if separable else cnn_to_ir
    params = _params(cfg, separable, device)
    g = torch.Generator().manual_seed(SEED + 1)
    h, w = cfg.image_hw
    calib = torch.rand((16, h, w, cfg.in_channels), generator=g).to(device)
    sizes = [1 + (i * 5) % 8 for i in range(66)]
    reqs = [torch.rand((n, h, w, cfg.in_channels), generator=g).numpy()
            for n in sizes]
    budgets = (1.0, 0.5, 0.1)                     # -> w8, w4, w2
    phase_of = [min(i * 3 // len(reqs), 2) for i in range(len(reqs))]

    qgemm.launches = 0
    qconv_dw.launches = 0
    t0 = time.perf_counter()
    res = DesignFlow(to_ir(cfg, params), device=device).run(
        ("qtorch",), DatatypeConfig(8, 8), calib_inputs=(calib,))
    srv = res.serve_adaptive(
        DEFAULT_POINTS,
        policy=RuntimePolicy(list(DEFAULT_POINTS), thresholds=[0.66, 0.33]),
        max_batch=8, max_wait=0.002)
    srv.start()
    outs = [None] * len(reqs)
    t_serve = time.perf_counter()
    try:
        for ph in range(3):
            idx = [i for i in range(len(reqs)) if phase_of[i] == ph]
            tickets = [(i, srv.submit(reqs[i], budget=budgets[ph]))
                       for i in idx]
            for i, tk in tickets:
                outs[i] = np.asarray(tk.result(timeout=300))
    finally:
        srv.stop(drain=True, timeout=300)
    serve_s = time.perf_counter() - t_serve
    launches = {"qgemm": qgemm.launches, "qconv_dw": qconv_dw.launches}
    stats = srv.stats()
    wall = time.perf_counter() - t0

    # the port's plain path on the CPU, same params and same act_ranges
    cpu = DesignFlow(to_ir(cfg, {k: v.cpu() for k, v in params.items()}),
                     device="cpu").run(("qtorch",), DatatypeConfig(8, 8),
                                       act_ranges=res.act_ranges)
    writer = cpu.writers["qtorch"]
    for ph, bits in enumerate((8, 4, 2)):
        idx = [i for i in range(len(reqs)) if phase_of[i] == ph]
        want = writer.build(bits=bits)(np.concatenate([reqs[i] for i in idx]))
        want = want.numpy()
        off = 0
        for i in idx:
            got = outs[i]
            exp = want[off:off + sizes[i]]
            off += sizes[i]
            if got.shape != exp.shape:
                raise AssertionError(f"{name}: request {i} at W{bits}: shape "
                                     f"{got.shape} != {exp.shape}")
            if not np.array_equal(got, exp):
                raise AssertionError(
                    f"{name}: request {i} at W{bits} differs from the CPU "
                    f"plain path (max |diff| {np.abs(got - exp).max()})")
            if not np.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite logits")
    views = stats.get("bits_views", {})
    if sorted(views) != [2, 4, 8]:
        raise AssertionError(f"{name}: bits_views {views} lacks W8/W4/W2")
    # on the card the path must have gone through the kernels (a CPU
    # rehearsal runs their plain versions and launches nothing)
    if device == "cuda" and launches["qgemm"] <= 0:
        raise AssertionError(f"{name}: qgemm never launched on the main path")
    if device == "cuda" and separable and launches["qconv_dw"] <= 0:
        raise AssertionError(f"{name}: qconv_dw never launched")
    info = {
        "model": name, "requests": len(reqs), "rows": sum(sizes),
        "launches": launches, "bits_views": views,
        "batches": stats.get("executed_batches"),
        "requests_per_s": len(reqs) / serve_s,
        "p50_latency_ms": 1e3 * stats.get("p50_latency_s", float("nan")),
        "p95_latency_ms": 1e3 * stats.get("p95_latency_s", float("nan")),
        "flow_and_serve_s": wall,
        "equal_to_cpu_plain": True,
        "logits_max_abs": float(max(np.abs(o).max() for o in outs)),
    }
    log(f"main path {name}: " + json.dumps(info))
    return info


# -- times ----------------------------------------------------------------------

def _event_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Per-call time of back-to-back calls between two CUDA events: what a
    caller pays, host launch overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 50):
    """Per-call device busy time (every kernel and copy the call enqueues)
    from the profiler's CUDA activity, or None when it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        total_us += float(getattr(ev, "self_device_time_total",
                                  getattr(ev, "self_cuda_time_total", 0.0)))
    return total_us / 1e3 / iters if total_us > 0 else None


def _measure(fn) -> dict:
    return {"event_ms": _event_ms(fn), "device_ms": _device_ms(fn)}


def _bound(nbytes: int, ops: int) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_us": 1e6 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _ms(m: dict) -> float:
    """The number a row reports: device time when the profiler measured it,
    else the event time."""
    return m["device_ms"] if m["device_ms"] is not None else m["event_ms"]


def times() -> dict:
    """Each kernel's launch wrapper at every batch-8 call of the main path
    (W8 unpacked, int8 codes out with bias and ReLU, as the path runs them),
    its plain version on the same inputs, and the nearest library call:
    ``torch._int_mm`` where its shape rules allow, ``F.conv2d(groups=C)`` in
    f32 with TF32 off."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import checks
    from repro_torch.kernels.qconv_dw.ops import (qconv_dw,
                                                  qconv_dw_int8_act_plain)
    from repro_torch.kernels.qmatmul.ops import (qgemm,
                                                 qmatmul_int8_act_plain)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    rows = {"qgemm": [], "qconv_dw": []}
    aqt = (4, -128, 127)

    for M, K, N in checks.QGEMM_PATH_SHAPES:
        x = torch.randint(-128, 128, (M, K), generator=g,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (K, N), generator=g,
                          dtype=torch.int8).to(dev)
        s = (torch.rand((N,), generator=g) * 1e-2).to(dev)
        b = (torch.randn((N,), generator=g) * 0.1).to(dev)
        epi = dict(relu=True, act_qt=aqt, out_code=True)
        kern = _measure(lambda: qgemm(x, w, s, b, bits=8, packed=False, **epi))
        plain = _measure(lambda: qmatmul_int8_act_plain(
            x, 1.0, w, s, b, bits=8, packed=False, **epi))
        lib = None
        if hasattr(torch, "_int_mm") and M > 16 and K % 8 == 0 \
                and N % 8 == 0:
            try:
                torch._int_mm(x, w)
                torch.cuda.synchronize()
            except RuntimeError as e:   # cuBLASLt refuses some int8 shapes
                log(f"torch._int_mm refused {M}x{K}x{N}: {str(e)[:120]}")
            else:
                lib = _measure(lambda: torch._int_mm(x, w))
        row = dict(shape=[M, K, N], kernel=kern, plain=plain, library=lib,
                   **_bound(M * K + K * N + 8 * N + M * N, 2 * M * K * N))
        rows["qgemm"].append(row)
    for (B, H, W, C), stride in (((8, 14, 14, 8), (1, 1)),
                                 ((8, 14, 14, 16), (2, 2))):
        x = torch.randint(-128, 128, (B, H, W, C), generator=g,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (9, C), generator=g,
                          dtype=torch.int8).to(dev)
        s = (torch.rand((C,), generator=g) * 1e-2).to(dev)
        b = (torch.randn((C,), generator=g) * 0.1).to(dev)
        epi = dict(kh=3, kw=3, strides=stride, pads="SAME", bits=8,
                   packed=False, relu=True, act_qt=aqt, out_code=True)
        kern = _measure(lambda: qconv_dw(x, w, s, b, **epi))
        plain = _measure(lambda: qconv_dw_int8_act_plain(x, 1.0, w, s, b,
                                                         **epi))
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wf = w.t().reshape(C, 1, 3, 3).float().contiguous()
        lib = _measure(lambda: F.conv2d(xf, wf, stride=stride, padding=1,
                                        groups=C))
        oh, ow = -(-H // stride[0]), -(-W // stride[1])
        row = dict(shape=[B, H, W, C], strides=list(stride), kernel=kern,
                   plain=plain, library=lib,
                   **_bound(B * H * W * C + 9 * C + 8 * C + B * oh * ow * C,
                            2 * 9 * B * oh * ow * C))
        rows["qconv_dw"].append(row)
    for name, rs in rows.items():
        for r in rs:
            log(f"time {name} {json.dumps(r)}")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs one GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.mnist_cnn import CNNConfig
    from repro_torch.configs.separable_cnn import SeparableCNNConfig

    t_all = time.perf_counter()
    card = header()
    build_s = build()
    sweeps = kernels_vs_plain()
    sep = main_path("separable-cnn", SeparableCNNConfig(), separable=True)
    mnist = main_path("mnist-cnn", CNNConfig(), separable=False)
    rows = times()

    # the JSON row of each kernel: its separable-cnn call with a library
    # counterpart (qgemm pw0, qconv_dw dw0)
    pick = {"qgemm": rows["qgemm"][1], "qconv_dw": rows["qconv_dw"][0]}
    meta = {
        "qgemm": ("src/repro_torch/csrc/qgemm.cu",
                  "src/repro/kernels/qmatmul/kernel.py:68"),
        "qconv_dw": ("src/repro_torch/csrc/qconv_dw.cu",
                     "src/repro/kernels/qconv_dw/kernel.py:51"),
    }
    kernels = []
    for name in ("qgemm", "qconv_dw"):
        r = pick[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sep["launches"][name],
            "max_abs_err": sweeps[name]["max_abs_err"],
            "ms": _ms(r["kernel"]), "plain_ms": _ms(r["plain"]),
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None if r["library"] is None else _ms(r["library"]),
        })
    detail = {"card": card, "build_s": build_s,
              "sweeps": {k: {"cases": v["cases"],
                             "max_abs_err": v["max_abs_err"]}
                         for k, v in sweeps.items()},
              "main_path": [sep, mnist], "times": rows,
              "total_s": time.perf_counter() - t_all}
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(f"serve separable-cnn: {sep['requests_per_s']:.1f} req/s, "
        f"p50 {sep['p50_latency_ms']:.3f} ms, p95 {sep['p95_latency_ms']:.3f} ms"
        f"; mnist-cnn: {mnist['requests_per_s']:.1f} req/s, "
        f"p50 {mnist['p50_latency_ms']:.3f} ms, "
        f"p95 {mnist['p95_latency_ms']:.3f} ms")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
