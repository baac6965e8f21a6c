#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. header — PyTorch/CUDA versions, the card's name and power limit;
2. build — compiles the hand-written kernels (``src/repro_torch/csrc``) with
   nvcc into ``build/repro_torch/`` and loads them, printing each kernel's
   registers, static shared memory, stack and spill bytes (``-Xptxas -v``),
   for each of ``ssd_scan``'s three phases its dynamic shared memory a
   block and blocks per SM at the full-width prefill calls of mamba2-1.3b
   and hymba-1.5b, and for each
   timed ``conv2d_stream`` call and wide row the mapping ``stream_tiles``
   gives it, its instance's registers, dynamic shared memory and blocks per
   SM;
3. kernels — each kernel and mode against its plain PyTorch version on the
   card: ``qgemm`` (int8 activations, scalar and per-row activation scale;
   shapes on both sides of its tiled/skinny switch) and ``qconv_dw`` (int8;
   the 3x3 window and 1x3, 5x5, 2x2) over
   bits {8,4,2} x packed x epilogue x ReLU x bias (x strides x pads),
   exactly; ``qconv_dw`` in f32, exactly;
   ``qgemm`` in f32 within the reference's ``max|y|*2^-7 + 1e-6`` (or one
   requant quantum); ``conv2d_stream`` over the stream target's shapes at
   batch 8 and 32, the reference's test shapes, ragged ones and rows wider
   than 48 KB of line buffer in f32, bf16 and mixed dtypes with and without
   bias, within 1e-4 (f32 out) or one bf16 ulp (bf16 out);
   ``ssd_scan`` over the reference's test shapes, ragged lengths, G > 1 and
   the full-width prefill calls of mamba2-1.3b and of hymba-1.5b's SSM half
   (H = 50, N = 16), f32 and bf16, contiguous and
   strided, from a zero and from a given initial state, y within ``1e-5*max|y|`` (plus one bf16 ulp in bf16) and the
   state within ``1e-4*max(1, max|state|)``, with the plain version's and
   the kernel's own errors against an f64 run at full width; then each of
   its three phases (chunk_state, state_pass, chunk_scan) fed the plain
   version of the phase before it, at both full-width calls and a ragged
   length, f32 and bf16, from a given initial state: the chunk states and
   y within the same bounds, state_pass exactly;
4. main paths, each with the launch counters zeroed just before it and read
   just after, on separable-cnn and mnist-cnn at their published widths:
   a. the fully-integer ``qtorch`` target at D8-W8 through
      ``serve_adaptive`` with the pump running: 66 requests of 1-8 rows
      whose budgets walk W8 -> W4 -> W2, every result equal bit for bit to
      the port's plain path on the CPU;
   b. the stream target at D16-W8 (``DesignFlow.run(("stream",), ...)``)
      through ``FlowResult.serve("stream")`` with the pump running, every
      result within ``max|y|*2^-7 + 1e-6`` of the CPU plain path, the
      topology identical to the CPU's;
   c. ``compose_adaptive`` with points hi/mid/lo (mnist-cnn: on
      separable-cnn the reference's own call fails), static and dynamic
      switching equal on the card, both within the bf16 tolerance of the
      CPU plain path;
   d. the ``qtorch`` target at D16-W8 (float activations) through
      ``serve_adaptive`` walking W8 -> W4 -> W2, within
      ``max|y|*2^-7 + 1e-6`` of the CPU plain path;
   e. the LM prefill of mamba2-1.3b at full width (48 layers, seeded random
      weights from a CUDA generator): ``make_prefill_step`` on (4, 2048)
      tokens in bf16, 48 ``ssd_scan`` launches per prefill (and 48 of
      each of its three phases), finite logits,
      tokens/s; then in f32 ``forward``
      through the kernel on a ragged length (2, 100) against
      ``decode_step`` fed token by token, every logit within the
      reference's ``5e-3*max|logit|``;
   f. ``AdaptiveLMServer`` at full width in bf16, batch 4: 12 decode steps
      with the budget walking 1.0 -> 0 (points w8, w4, w2 in order, weight
      bytes falling, master codes unchanged, logits finite, tokens/s per
      point), then ``greedy_generate`` of 8 tokens after a 16-token prompt;
   g. the design-space explorer on separable-cnn and mnist-cnn
      (:func:`dse_path`): ``DesignFlow.explore`` on 32 seeded images, its
      front equal to the CPU's in every field of ``to_json()``, with
      ``qgemm`` (and on separable-cnn ``qconv_dw``) launched by its
      agreement runs; a weight-byte ceiling one byte under the top point
      drops it; ``ResourceBudget(weight_bytes=1)`` raises
      ``BudgetInfeasibleError``; ``run(("qtorch",), **front.run_kwargs())``
      -> ``serve_adaptive(points=front, selector=front.selector(slo))`` with
      the pump running, every result equal bit for bit to the CPU plain
      path; a second ``explore`` fed that tenant's ``LatencyEWMA`` carries
      the latency measured on the card (printed with the card's name and
      power limit);
   h. the im2col depthwise baseline on separable-cnn at D8 and D16
      (:func:`im2col_path`): ``WriterOptions(dw_mode="im2col")`` served
      walking W8 -> W4 -> W2 beside direct mode on one calibration, equal to
      it and to the CPU plain path bit for bit at D8 (within the float-path
      contract at D16), with no ``qconv_dw`` launch and two more ``qgemm``
      launches a batch;
   i. fault-tolerant fleet serving on separable-cnn at D8-W8
      (:func:`fleet_path`): W8/W4/W2 point executables over one packed
      buffer, three ``AccelServer`` replicas behind a ``FleetRouter`` with
      canaries captured on the card, one ``Scrubber`` over the buffer
      attached to every replica; every result equal bit for bit to its CPU
      golden; a W4 view bit flip repaired in place; a master-code bit flip
      under paced sequential W8 requests, whose first detection kills every
      replica (no batch finished after it, no corrupted result for a
      request submitted after it, the corrupted results served before it
      counted), each ejected ``quarantined``, healed and readmitted; a pump
      crash ejected ``dead-pump`` with no ticket lost; a shared
      ``BrownoutSelector`` walking the fleet to W4/W2 under a burst; then
      requests/s with the scrubber off and on in alternating runs, the
      bytes/s it re-hashed against its rate, and one region's hash time;
   j. hymba-1.5b at full width (32 layers, seeded random weights from a
      CUDA generator; :func:`lm_paths`, as e and f): the bf16 prefill of (4, 2048)
      tokens, banded attention beside the SSM half, exactly 32 ``ssd_scan``
      launches (and 32 of each phase), finite logits, tokens/s; the f32
      ``forward`` against token-by-token ``decode_step`` within
      ``5e-3*max|logit|`` on a cut config, named in the output (4 layers,
      window 64, ``attention.Q_CHUNK`` 64, tokens (2, 256)), whose prefill
      takes the banded schedule and whose decode wraps the 64-slot ring
      buffer; then ``AdaptiveLMServer`` and ``greedy_generate`` as in f;
   k. qwen1.5-0.5b at full width (24 layers; :func:`lm_paths`): the same
      prefill (chunked attention, no ``ssd_scan`` launch), the f32 check at
      full width on (2, 100), the server and ``greedy_generate``;
5. times — each kernel and mode, its plain version and the nearest PyTorch
   library call at the main paths' batch-8 shapes: device time per call
   from the profiler's CUDA activity (and the per-call time of back-to-back
   calls between CUDA events, host overhead included), beside the least
   time the card could take (bytes over 3.35 TB/s, or operations over
   1,979 int8 TOP/s or 67 f32 TFLOP/s, whichever is larger); every
   ``qgemm`` call of both CNNs in both modes (``torch._int_mm`` on
   zero-padded operands as the int8 yardstick, the FC's 8 x 1568 x 10 as
   32 x 1568 x 16; ``torch.matmul`` in f32), reported for pw0 and the FC in
   the kernels line; ``qconv_dw`` at dw0 and dw1 in both modes -- each of
   these also as ``graph_ms``, the per-call time of 100 calls replayed from
   one CUDA graph, where no host work separates the calls;
   ``conv2d_stream`` at the stream target's five calls at batch 8 and 32
   against ``F.conv2d`` on channels-last views, graphs included; ``ssd_scan``
   at the (4, 2048) prefill calls of mamba2-1.3b and hymba-1.5b against its
   plain version with the bf16 intra flag off and on, and each of its
   phases alone beside the bound of its own work; one layer's attention
   prefill (``attention.attend``, q, k, v to output) at hymba's (banded)
   and qwen's (chunked) call beside ``F.scaled_dot_product_attention`` on
   the same q, k and v, a yardstick the port never calls;
   ``qgemm``'s per-row x-scale mode at pw0; the im2col
   baseline's two ``qgemm`` calls (dw0 1568 x 72 x 8, dw1 392 x 144 x 16)
   in both modes, beside ``torch._int_mm`` / ``torch.matmul`` on the same
   patches, reported with the direct ``qconv_dw`` calls in the kernels line.

It prints one ``{"kernels": [...]}`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository's
``src/`` beside it, it exits non-zero and prints no result.  Details go to
``build/chip_smoke/chip_smoke.json``.

    python3 chip_smoke.py --conv2d-stream [--src DIR]

runs only the header, the build and ``conv2d_stream``'s times
(:func:`times_conv2d_stream`, without the mapping, which a parent's package
may not have) on the ``repro_torch`` under ``--src``: a parent commit's,
unpacked with ``git archive``, is timed so beside the change in one call.
Its details go to ``build/chip_smoke/conv2d_stream.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 on CUDA cores (no tensor cores)
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
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


def ptxas_report(log_text: str) -> list:
    """Each kernel's registers, shared memory, stack and spill bytes from the
    build's ``nvcc -Xptxas -v`` output, with demangled names."""
    import re
    rows, cur, src = [], None, None
    for ln in log_text.splitlines():
        if ln.startswith("== nvcc "):
            src = ln[len("== nvcc "):].strip()
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"source": src, "mangled": m.group(1), "registers": None,
                   "smem_bytes": 0, "stack_bytes": None,
                   "spill_store_bytes": None, "spill_load_bytes": None}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    names = [r["mangled"] for r in rows]
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        demangled = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        demangled = []
    for i, r in enumerate(rows):
        name = demangled[i] if len(demangled) == len(rows) else r["mangled"]
        name = name.replace("(anonymous namespace)::", "")
        # "void kernel<args>(params)" -> "kernel<args>"
        r["kernel"] = name.split("(")[0].removeprefix("void ").strip()
    return rows


def build() -> dict:
    from repro_torch.kernels import _build, checks
    t0 = time.perf_counter()
    _build.load_kernels()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s (cached={_build.build_info.get('cached')}) "
        f"-> {_build.build_info.get('path')}")
    report = ptxas_report(str(_build.build_info.get("log", "")))
    for r in report:
        log(f"  ptxas {r['source']} {r['kernel']}: {r['registers']} "
            f"registers, {r['smem_bytes']} B static smem, "
            f"{r['stack_bytes']} B stack, spill {r['spill_store_bytes']} B "
            f"stores / {r['spill_load_bytes']} B loads")
    return {"seconds": secs, "ptxas": report,
            "ssd_phases": ssd_phase_info(report),
            "ssd_phases_hymba": ssd_phase_info(
                report, checks.SSD_HYMBA_FULL_WIDTH)}


def conv2d_stream_instances() -> list:
    """For each timed ``conv2d_stream`` call and the wide rows, the mapping
    ``stream_tiles`` gives it, and its kernel instance's registers, dynamic
    shared memory and blocks per SM (the occupancy calculator)."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.conv2d_stream import ops
    out = []
    for shape in (conv2d_stream_timed_shapes()
                  + list(checks.CONV_STREAM_WIDE_SHAPES)):
        B, H, W, cin, cout, k = shape
        t = ops.stream_tiles(B, H, W, cin, cout, k, k)
        info = ops.conv2d_stream_info(t)
        out.append({"shape": list(shape), "tiles": t._asdict(), **info})
        log(f"  conv2d_stream {list(shape)}: rows {t.rows}, tw {t.tw}, ct "
            f"{t.ct}, {t.px}x{t.co} tile, ks {t.ks}, window {t.window}, ci_vec "
            f"{t.ci_vec}, {t.threads} threads, grid {list(t.grid)}: "
            f"{info['registers']} registers, {info['dynamic_smem_bytes']} B "
            f"dynamic smem a block, {info['blocks_per_sm']} blocks per SM")
    return out


def ssd_phase_info(report: list, shape=None) -> dict:
    """Each ``ssd_scan`` phase's registers (from the ptxas report), dynamic
    shared memory per block and blocks per SM at a full-width prefill call
    (``shape``, mamba2-1.3b's by default), in f32 and bf16."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_phase_info
    _, _, _, P, _, N, Q = shape or checks.SSD_FULL_WIDTH
    regs = {r["kernel"]: r["registers"] for r in report}
    out = {}
    for dtype, t in (("float32", "float"), ("bfloat16", "__nv_bfloat16")):
        out[dtype] = ssd_scan_phase_info(Q, P, N, dtype == "bfloat16")
        for phase, v in out[dtype].items():
            kernel = (f"{phase}_kernel" if phase == "state_pass"
                      else f"{phase}_kernel<{t}>")
            v["registers"] = regs.get(kernel)
            log(f"  ssd_scan {phase} {dtype} at Q={Q}, P={P}, N={N}: "
                f"{v['registers']} registers, {v['dynamic_smem_bytes']} B "
                f"dynamic smem a block, {v['blocks_per_sm']} blocks per SM")
    return out


def kernels_vs_plain() -> dict:
    """Every kernel and mode against its plain version; the exact ones must
    agree to the bit, the others within their stated tolerance
    (``failures`` empty)."""
    import torch
    from repro_torch.kernels import checks
    sweeps = (("qgemm", checks.qgemm_sweep, {}, True),
              ("qgemm_xscale", checks.qgemm_sweep, {"per_row": True}, True),
              ("qconv_dw", checks.qconv_dw_sweep,
               {"windows": checks.DW_WINDOWS}, True),
              ("qgemm_f32", checks.qgemm_float_sweep, {}, False),
              ("qconv_dw_f32", checks.qconv_dw_float_sweep,
               {"windows": checks.DW_WINDOWS}, True),
              ("conv2d_stream", checks.conv2d_stream_sweep, {}, False),
              ("ssd_scan", checks.ssd_scan_sweep, {}, False))
    out = {}
    for name, sweep, kw, exact in sweeps:
        t0 = time.perf_counter()
        res = sweep("cuda", **kw)
        torch.cuda.synchronize()
        log(f"{name} vs plain ({time.perf_counter() - t0:.1f} s"
            f"{', exact' if exact else ''}): "
            + "\n  ".join(checks.summarize(res))
            + (f" max_tol_frac={res['max_tol_frac']}"
               if "max_tol_frac" in res else ""))
        if name == "ssd_scan":
            res["vs_f64"] = checks.ssd_scan_f64_gap("cuda")
            log(f"ssd_scan at {list(checks.SSD_FULL_WIDTH)} against an f64 "
                f"run of the plain version: {json.dumps(res['vs_f64'])}; "
                f"worst fraction of the bound: "
                f"{json.dumps(res['max_tol_frac_by'])}")
            t0 = time.perf_counter()
            res["phases"] = checks.ssd_scan_phase_check("cuda")
            torch.cuda.synchronize()
            log(f"ssd_scan phases vs plain at "
                f"{[list(s) for s in checks.SSD_PHASE_SHAPES]} "
                f"({time.perf_counter() - t0:.1f} s): "
                + "\n  ".join(checks.summarize(res["phases"]))
                + f" worst fraction of the bound: "
                f"{json.dumps(res['phases']['max_tol_frac_by'])}")
            if res["phases"]["failures"]:
                raise AssertionError("an ssd_scan phase disagrees with its "
                                     "plain version")
        if res["failures"] or (exact and res["max_abs_err"] != 0.0):
            raise AssertionError(f"{name} disagrees with its plain version")
        out[name] = res
    return out


# -- main path ----------------------------------------------------------------

def _params(cfg, separable: bool, device: str, bn_stats: bool = True):
    """Seeded random weights; BN statistics drawn too (unless ``bn_stats``
    is off), so the folded biases are non-zero and the epilogue's bias path
    is exercised."""
    import torch
    from repro_torch.models import cnn
    g = torch.Generator().manual_seed(SEED)
    init = cnn.init_separable_params if separable else cnn.init_params
    p = init(cfg, g)
    for k in list(p) if bn_stats else []:
        if k.endswith("/scale") or k.endswith("/var"):
            p[k] = 0.5 + torch.rand(p[k].shape, generator=g)
        elif k.endswith("/bias") or k.endswith("/mean"):
            p[k] = 0.1 * torch.randn(p[k].shape, generator=g)
    return {k: v.to(device) for k, v in p.items()}


def _counters() -> dict:
    """Each kernel's launch wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.conv2d_stream.ops import conv2d_stream_cuda
    from repro_torch.kernels.qconv_dw.ops import qconv_dw, qconv_dw_f32
    from repro_torch.kernels.qmatmul.ops import qgemm, qgemm_f32
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    return {"qgemm": qgemm, "qgemm_f32": qgemm_f32, "qconv_dw": qconv_dw,
            "qconv_dw_f32": qconv_dw_f32, "conv2d_stream": conv2d_stream_cuda,
            "ssd_scan": ssd_scan_cuda, **_ssd_phase_counters()}


SSD_PHASES = ("chunk_state", "state_pass", "chunk_scan")


def _ssd_phase_counters() -> dict:
    """``ssd_scan``'s three phase wrappers, each counting its own kernel's
    launches (``ssd_scan_cuda`` counts one a call)."""
    from repro_torch.kernels.ssd_scan import ops
    return {f"ssd_scan.{p}": getattr(ops, f"ssd_{p}_cuda")
            for p in SSD_PHASES}


def _zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def _expect_launched(name: str, launches: dict, kernels, device: str) -> None:
    """On the card the path must have gone through these kernels (a CPU
    rehearsal runs their plain versions and launches nothing)."""
    for k in kernels:
        if device == "cuda" and launches[k] <= 0:
            raise AssertionError(f"{name}: {k} never launched on its path")


def _workload(cfg, n: int, seed: int):
    """Calibration batch (a tensor) and ``n`` requests of 1-8 rows (numpy),
    from a seed."""
    import torch
    g = torch.Generator().manual_seed(seed)
    h, w = cfg.image_hw
    calib = torch.rand((16, h, w, cfg.in_channels), generator=g)
    sizes = [1 + (i * 5) % 8 for i in range(n)]
    reqs = [torch.rand((k, h, w, cfg.in_channels), generator=g).numpy()
            for k in sizes]
    return calib, reqs


def _check(name: str, got, want, exact: bool) -> float:
    """``got`` against the CPU plain path's ``want``: equal, or within the
    reference's float-path contract ``max|want|*2^-7 + 1e-6``.  Returns the
    max abs difference."""
    import numpy as np
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite outputs")
    d = float(np.abs(got - want).max()) if got.size else 0.0
    if exact and not np.array_equal(got, want):
        raise AssertionError(f"{name} differs from the CPU plain path "
                             f"(max |diff| {d})")
    tol = float(np.abs(want).max()) * 2.0 ** -7 + 1e-6
    if not exact and d > tol:
        raise AssertionError(f"{name}: max |diff| {d} from the CPU plain "
                             f"path exceeds {tol}")
    return d


def _serve_all(srv, reqs, budgets=None):
    """Submit every request with the pump running, one budget group at a
    time in order of first appearance; results in request order."""
    import numpy as np
    budgets = budgets or [1.0] * len(reqs)
    srv.start()
    outs = [None] * len(reqs)
    try:
        for budget in dict.fromkeys(budgets):
            tickets = [(i, srv.submit(r, budget=budget))
                       for i, r in enumerate(reqs) if budgets[i] == budget]
            for i, tk in tickets:
                outs[i] = np.asarray(tk.result(timeout=300))
    finally:
        srv.stop(drain=True, timeout=300)
    return outs


def qtorch_path(name: str, cfg, separable: bool, act_bits: int = 8,
                device: str = "cuda") -> dict:
    """DesignFlow(("qtorch",), D<act_bits>-W8) -> serve_adaptive on
    ``device`` with budgets walking W8 -> W4 -> W2; every served result held
    against the port's plain CPU path (bit for bit on the fully-integer
    D8 path, within the float-path contract at D16)."""
    return _qtorch_serve(name, cfg, separable, act_bits, device, "direct",
                         None)[0]


def _qtorch_serve(name: str, cfg, separable: bool, act_bits: int,
                  device: str, dw_mode: str, act_ranges):
    """:func:`qtorch_path`'s run: (info, served outputs in request order,
    the card's act_ranges).  ``dw_mode`` lowers the depthwise convs direct
    or through the im2col baseline; ``act_ranges`` (default: calibrate on
    the card) lets two runs share one calibration."""
    import numpy as np
    from repro_torch.core.adaptive import RuntimePolicy
    from repro_torch.core.flow import DEFAULT_POINTS, DesignFlow, WriterOptions
    from repro_torch.core.reader import cnn_to_ir, separable_cnn_to_ir
    from repro_torch.quant.qtypes import DatatypeConfig

    to_ir = separable_cnn_to_ir if separable else cnn_to_ir
    dt = DatatypeConfig(act_bits, 8)
    exact = act_bits <= 8
    opts = WriterOptions(dw_mode=dw_mode)
    params = _params(cfg, separable, device)
    calib, reqs = _workload(cfg, 66, SEED + 1)
    budgets = [(1.0, 0.5, 0.1)[min(i * 3 // len(reqs), 2)]
               for i in range(len(reqs))]              # -> w8, w4, w2

    _zero_counts()
    t0 = time.perf_counter()
    res = DesignFlow(to_ir(cfg, params), device=device).run(
        ("qtorch",), dt, calib_inputs=(calib.to(device),), options=opts,
        act_ranges=act_ranges)
    srv = res.serve_adaptive(
        DEFAULT_POINTS,
        policy=RuntimePolicy(list(DEFAULT_POINTS), thresholds=[0.66, 0.33]),
        max_batch=8, max_wait=0.002)
    t_serve = time.perf_counter()
    outs = _serve_all(srv, reqs, budgets)
    serve_s = time.perf_counter() - t_serve
    launches = _read_counts()
    stats = srv.stats()
    wall = time.perf_counter() - t0

    # the port's plain path on the CPU, same params and same act_ranges
    cpu = DesignFlow(to_ir(cfg, {k: v.cpu() for k, v in params.items()}),
                     device="cpu").run(("qtorch",), dt, options=opts,
                                       act_ranges=res.act_ranges)
    writer = cpu.writers["qtorch"]
    worst = 0.0
    for budget, bits in ((1.0, 8), (0.5, 4), (0.1, 2)):
        idx = [i for i in range(len(reqs)) if budgets[i] == budget]
        want = writer.build(bits=bits)(np.concatenate([reqs[i] for i in idx]))
        want = want.numpy()
        off = 0
        for i in idx:
            n = reqs[i].shape[0]
            worst = max(worst, _check(f"{name} D{act_bits} request {i} at "
                                      f"W{bits}", outs[i], want[off:off + n],
                                      exact))
            off += n
    views = stats.get("bits_views", {})
    if sorted(views) != [2, 4, 8]:
        raise AssertionError(f"{name}: bits_views {views} lacks W8/W4/W2")
    suffix = "" if exact else "_f32"
    direct_dw = separable and dw_mode == "direct"
    kernels = [k + suffix for k in (["qgemm", "qconv_dw"] if direct_dw
                                    else ["qgemm"])]
    _expect_launched(f"{name} qtorch D{act_bits}", launches, kernels, device)
    if dw_mode == "im2col" and launches["qconv_dw" + suffix]:
        raise AssertionError(f"{name}: qconv_dw launched in im2col mode")
    info = {
        "path": f"qtorch D{act_bits}-W8"
                + ("" if dw_mode == "direct" else f" dw_mode={dw_mode}"),
        "model": name,
        "requests": len(reqs), "rows": sum(r.shape[0] for r in reqs),
        "launches": launches, "bits_views": views,
        "batches": stats.get("executed_batches"),
        "requests_per_s": len(reqs) / serve_s,
        "p50_latency_ms": 1e3 * stats.get("p50_latency_s", float("nan")),
        "p95_latency_ms": 1e3 * stats.get("p95_latency_s", float("nan")),
        "flow_and_serve_s": wall,
        "vs_cpu_plain": "equal" if exact else f"max |diff| {worst}",
        "logits_max_abs": float(max(np.abs(o).max() for o in outs)),
    }
    log(f"main path {name} {info['path']}: " + json.dumps(info))
    return info, outs, res.act_ranges


def stream_path(name: str, cfg, separable: bool,
                device: str = "cuda") -> dict:
    """DesignFlow(("stream",), D16-W8) -> FlowResult.serve("stream") on
    ``device`` with the pump running; every served result within the
    float-path contract of the CPU plain path, and the same topology."""
    import numpy as np
    from repro_torch.core.flow import DesignFlow
    from repro_torch.core.reader import cnn_to_ir, separable_cnn_to_ir
    from repro_torch.quant.qtypes import DatatypeConfig

    to_ir = separable_cnn_to_ir if separable else cnn_to_ir
    dt = DatatypeConfig(16, 8)
    params = _params(cfg, separable, device)
    calib, reqs = _workload(cfg, 33, SEED + 2)

    _zero_counts()
    t0 = time.perf_counter()
    res = DesignFlow(to_ir(cfg, params), device=device).run(
        ("stream",), dt, calib_inputs=(calib.to(device),))
    srv = res.serve("stream", max_batch=8, max_wait=0.002)
    t_serve = time.perf_counter()
    outs = _serve_all(srv, reqs)
    serve_s = time.perf_counter() - t_serve
    launches = _read_counts()
    stats = srv.stats()
    wall = time.perf_counter() - t0

    cpu = DesignFlow(to_ir(cfg, {k: v.cpu() for k, v in params.items()}),
                     device="cpu").run(("stream",), dt,
                                       act_ranges=res.act_ranges)
    want = cpu.executables["stream"](np.concatenate(reqs)).numpy()
    worst, off = 0.0, 0
    for i, r in enumerate(reqs):
        n = r.shape[0]
        worst = max(worst, _check(f"{name} stream request {i}", outs[i],
                                  want[off:off + n], exact=False))
        off += n
    topo = res.writers["stream"].topology()
    if topo != cpu.writers["stream"].topology():
        raise AssertionError(f"{name}: stream topology differs on the card")
    _expect_launched(f"{name} stream", launches, ["conv2d_stream"], device)
    info = {
        "path": "stream D16-W8", "model": name, "requests": len(reqs),
        "rows": sum(r.shape[0] for r in reqs), "launches": launches,
        "batches": stats.get("executed_batches"),
        "requests_per_s": len(reqs) / serve_s,
        "p50_latency_ms": 1e3 * stats.get("p50_latency_s", float("nan")),
        "p95_latency_ms": 1e3 * stats.get("p95_latency_s", float("nan")),
        "flow_and_serve_s": wall, "vs_cpu_plain": f"max |diff| {worst}",
        "topology_equal": True, "total_fifo_bytes": topo["total_fifo_bytes"],
        "logits_max_abs": float(max(np.abs(o).max() for o in outs)),
    }
    log(f"main path {name} stream: " + json.dumps(info))
    return info


def compose_path(name: str, cfg, separable: bool,
                 device: str = "cuda") -> dict:
    """DesignFlow.compose_adaptive(hi/mid/lo) on ``device``: static and
    dynamic switching equal on the card, both within the bf16 tolerance
    (``max|y|*2^-7 + 1e-6``) of the CPU plain path."""
    import torch
    from repro_torch.core.adaptive import WorkingPoint
    from repro_torch.core.flow import DesignFlow
    from repro_torch.core.reader import cnn_to_ir, separable_cnn_to_ir

    to_ir = separable_cnn_to_ir if separable else cnn_to_ir
    points = [WorkingPoint("hi", 8), WorkingPoint("mid", 4),
              WorkingPoint("lo", 2)]
    params = _params(cfg, separable, device)
    x = _workload(cfg, 0, SEED + 3)[0][:8].numpy()

    _zero_counts()
    t0 = time.perf_counter()
    acc = DesignFlow(to_ir(cfg, params), device=device).compose_adaptive(
        points)
    dyn = acc.build_dynamic()
    static, dynamic = {}, {}
    for i, pt in enumerate(points):
        static[pt.name] = acc(pt.name, x).to(torch.float32).cpu()
        dynamic[pt.name] = dyn(i, acc.qparams.tree(), x).cpu()
    launches = _read_counts()
    wall = time.perf_counter() - t0

    cpu = DesignFlow(to_ir(cfg, {k: v.cpu() for k, v in params.items()}),
                     device="cpu").compose_adaptive(points)
    worst = 0.0
    for pt in points:
        if not torch.equal(static[pt.name], dynamic[pt.name]):
            raise AssertionError(f"{name} compose {pt.name}: dynamic != "
                                 "static")
        want = cpu(pt.name, x).to(torch.float32).numpy()
        worst = max(worst, _check(f"{name} compose {pt.name}",
                                  static[pt.name].numpy(), want, exact=False))
    if acc.sharing_report() != cpu.sharing_report():
        raise AssertionError(f"{name}: sharing_report differs on the card")
    _expect_launched(f"{name} compose", launches, ["conv2d_stream"], device)
    info = {"path": "compose_adaptive hi/mid/lo", "model": name,
            "rows": int(x.shape[0]), "launches": launches,
            "static_equals_dynamic": True,
            "vs_cpu_plain": f"max |diff| {worst}",
            "sharing_report": acc.sharing_report(), "wall_s": wall}
    log(f"main path {name} compose_adaptive: " + json.dumps(info))
    return info


def _explore_calib(cfg):
    """The explorer's calibration batch: 32 seeded images (numpy)."""
    import torch
    h, w = cfg.image_hw
    g = torch.Generator().manual_seed(SEED + 9)
    return torch.rand((32, h, w, cfg.in_channels), generator=g).numpy()


def dse_path(name: str, cfg, separable: bool, card: str = "",
             device: str = "cuda") -> dict:
    """The design-space explorer end to end on ``device``:
    ``DesignFlow.explore`` on 32 seeded images (its front equal, field for
    field, to the CPU plain path's, with the agreement runs launching the
    kernels), a weight-byte ceiling one byte under the top point dropping
    it, an infeasible budget raising, then ``run(**front.run_kwargs())`` and
    ``serve_adaptive(points=front, selector=front.selector(slo))`` with the
    pump running, every result equal bit for bit to the CPU plain path; last
    a second ``explore`` fed that tenant's ``LatencyEWMA``, whose points
    carry the latency measured on ``device``."""
    import numpy as np
    from repro_torch.core.adaptive import ServiceObjective
    from repro_torch.core.flow import DesignFlow
    from repro_torch.core.reader import cnn_to_ir, separable_cnn_to_ir
    from repro_torch.dse import BudgetInfeasibleError, ResourceBudget

    to_ir = separable_cnn_to_ir if separable else cnn_to_ir
    # the models' own initialization: with drawn BN statistics separable-cnn
    # predicts one class for every image and its front is the one point w2
    params = _params(cfg, separable, device, bn_stats=False)
    calib = _explore_calib(cfg)
    reqs = _workload(cfg, 24, SEED + 10)[1]
    flow = DesignFlow(to_ir(cfg, params), device=device)

    _zero_counts()
    t0 = time.perf_counter()
    front = flow.explore((calib,))
    explore_s = time.perf_counter() - t0
    launches = _read_counts()
    cpu_flow = DesignFlow(to_ir(cfg, {k: v.cpu() for k, v in params.items()}),
                          device="cpu")
    t0 = time.perf_counter()
    cpu_front = cpu_flow.explore((calib,))
    cpu_explore_s = time.perf_counter() - t0
    if front.to_json() != cpu_front.to_json():
        raise AssertionError(f"{name}: the card's front differs from the "
                             f"CPU's:\n{front.to_json()}\n"
                             f"{cpu_front.to_json()}")
    _expect_launched(f"{name} explore", launches,
                     ["qgemm", "qconv_dw"] if separable else ["qgemm"],
                     device)

    top = front.points[0]
    ceiling = max(p.weight_bytes for p in front.points) - 1
    tight = flow.explore((calib,), budget=ResourceBudget(weight_bytes=ceiling))
    if top.point.name in [p.point.name for p in tight.points] or \
            max(p.weight_bytes for p in tight.points) > ceiling:
        raise AssertionError(f"{name}: a ceiling of {ceiling} B kept "
                             f"{tight.to_json()}")
    try:
        flow.explore((calib,), budget=ResourceBudget(weight_bytes=1))
        raise AssertionError(f"{name}: weight_bytes=1 did not raise")
    except BudgetInfeasibleError as e:
        if "weight_bytes" not in e.violations:
            raise AssertionError(f"{name}: violations {e.violations}")

    res = flow.run(("qtorch",), calib_inputs=(calib,), **front.run_kwargs())
    srv = res.serve_adaptive(points=front, max_batch=8, max_wait=0.002,
                             selector=front.selector(
                                 ServiceObjective(p95_latency_s=60.0)))
    _zero_counts()
    outs = _serve_all(srv, reqs)
    serve_launches = _read_counts()
    stats = srv.stats()
    bits = sorted({r.bits for r in srv.reports})
    if bits != [top.point.weight_bits] or stats["slo"]["point"] != \
            top.point.name:
        raise AssertionError(f"{name}: served at {bits}, SLO point "
                             f"{stats['slo']['point']}, front top {top}")
    cpu = cpu_flow.run(("qtorch",), act_ranges=res.act_ranges,
                       **front.run_kwargs())
    want = cpu.writers["qtorch"].build(bits=top.point.weight_bits)(
        np.concatenate(reqs)).numpy()
    off = 0
    for i, r in enumerate(reqs):
        _check(f"{name} front request {i}", outs[i],
               want[off:off + r.shape[0]], exact=True)
        off += r.shape[0]
    _expect_launched(f"{name} serve front", serve_launches,
                     ["qgemm", "qconv_dw"] if separable else ["qgemm"],
                     device)

    lat = srv._default.latency
    measured = flow.explore((calib,), latency=lat)
    want_lat = lat.estimate(max(front.buckets))
    got = {p.measured_latency_s for p in measured.points}
    if want_lat is None or got != {want_lat}:
        raise AssertionError(f"{name}: measured_latency_s {got}, the "
                             f"tenant's EWMA at bucket "
                             f"{max(front.buckets)} {want_lat}")
    log(f"{name} front measured_latency_s {want_lat} s at bucket "
        f"{max(front.buckets)} ({card})")
    info = {"path": "explore -> serve_adaptive(front)", "model": name,
            "launches": launches, "serve_launches": serve_launches,
            "explore_s": explore_s, "cpu_explore_s": cpu_explore_s,
            "front": json.loads(front.to_json()),
            "front_equals_cpu": True, "tight_ceiling": ceiling,
            "tight_points": [p.point.name for p in tight.points],
            "served_requests": len(reqs), "served_bits": bits,
            "vs_cpu_plain": "equal",
            "bucket_latency_s": lat.snapshot(),
            "measured_latency_s": want_lat, "card": card}
    log(f"main path {name} explore: " + json.dumps(info))
    return info


def im2col_path(name: str, cfg, act_bits: int, device: str = "cuda") -> dict:
    """The im2col depthwise baseline on separable-cnn: the ``qtorch``
    target with ``WriterOptions(dw_mode="im2col")`` served walking W8 -> W4
    -> W2 (:func:`qtorch_path`) beside direct mode on the same calibration:
    no ``qconv_dw`` launch, two more ``qgemm`` launches a batch, and the
    results equal direct mode's bit for bit at D8 (within the float-path
    contract at D16), as both equal the CPU plain path."""
    suffix = "" if act_bits <= 8 else "_f32"
    direct, d_outs, ranges = _qtorch_serve(name, cfg, True, act_bits, device,
                                           "direct", None)
    im2col, i_outs, _ = _qtorch_serve(name, cfg, True, act_bits, device,
                                      "im2col", ranges)
    worst = 0.0
    for i, (a, b) in enumerate(zip(i_outs, d_outs)):
        worst = max(worst, _check(f"{name} D{act_bits} im2col request {i}",
                                  a, b, exact=act_bits <= 8))
    per_batch = {m: info["launches"]["qgemm" + suffix] / info["batches"]
                 for m, info in (("direct", direct), ("im2col", im2col))}
    if device == "cuda" and per_batch["im2col"] != per_batch["direct"] + 2:
        raise AssertionError(f"{name}: qgemm{suffix} launches a batch "
                             f"{per_batch}, expected direct + 2")
    info = {"path": f"qtorch D{act_bits}-W8 dw_mode=im2col vs direct",
            "model": name, "launches": im2col["launches"],
            "direct_launches": direct["launches"],
            "qgemm_launches_per_batch": per_batch,
            "vs_direct": "equal" if act_bits <= 8 else f"max |diff| {worst}",
            "im2col": im2col, "direct": direct}
    log(f"main path {name} im2col D{act_bits}: " + json.dumps(
        {k: v for k, v in info.items() if k not in ("im2col", "direct")}))
    return info


# -- fleet path: fault-tolerant serving with weight-memory integrity ----------

FLEET_BUDGETS = ((1.0, 8), (0.5, 4), (0.1, 2))   # request budget -> point bits
FLEET_REPLICAS = ("a", "b", "c")                  # "c" carries the chaos
FLEET_SCRUB_RATE = 4e6        # bytes/s the buffer's scrubber re-hashes
FLEET_SCRUB_INTERVAL = 0.002  # the scrubber's tick, s
FLEET_MASTER_FLIPS = 3        # master-code flips in step 3, each healed


def _wait(cond, seconds: float, poll: float = 0.001) -> bool:
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return cond()


class _FleetRig:
    """The fleet phase's fixture: separable-cnn's W8/W4/W2 point executables
    over ONE packed weight buffer on ``device``, a pristine copy of its
    master codes and scales, each request's golden output per point from the
    CPU plain path, and the replicas' factories.

    The buffer has ONE ``Scrubber``, attached to every replica's server:
    every replica reads the same live buffer, so its first detection of a
    master-code flip is fatal to all of them at once.  Each factory call
    builds an ``AccelServer`` whose point is picked per batch from the
    request budget, attaches the scrubber, and records when the scrubber
    quarantined the weights and how many batches the server had finished
    by then.  The first heal after a quarantine restores the pristine
    master and starts a fresh scrubber.  Replica ``c`` serves through one
    ``ChaosExecutable`` per point, sharing a call counter, so a crash can
    be scheduled on it."""

    def __init__(self, name: str, cfg, device: str, n_requests: int):
        import numpy as np
        from repro_torch.core.adaptive import shared_point_executables
        from repro_torch.core.flow import DEFAULT_POINTS, DesignFlow
        from repro_torch.core.reader import separable_cnn_to_ir
        from repro_torch.device import to_numpy
        from repro_torch.quant.qtypes import DatatypeConfig
        from repro_torch.runtime.fleet import ChaosExecutable
        from repro_torch.runtime.integrity import CanarySet

        self.name, self.device = name, device
        dt = DatatypeConfig(8, 8)
        params = _params(cfg, True, device)
        calib, self.reqs = _workload(cfg, n_requests, SEED + 5)
        res = DesignFlow(separable_cnn_to_ir(cfg, params), device=device).run(
            ("qtorch",), dt, calib_inputs=(calib.to(device),))
        self.pts = shared_point_executables(res.writers["qtorch"],
                                            DEFAULT_POINTS)
        self.packed = self.pts["w8"].packed
        for exe in self.pts.values():     # derive and seal every W4/W2 view
            exe(self.reqs[0])
        self.master = {n: (np.array(to_numpy(t.codes)),
                           np.array(to_numpy(t.scale)))
                       for n, t in self.packed.tensors.items()}
        cpu = DesignFlow(separable_cnn_to_ir(
            cfg, {k: v.cpu() for k, v in params.items()}), device="cpu").run(
            ("qtorch",), dt, act_ranges=res.act_ranges).writers["qtorch"]
        offs = np.cumsum([0] + [r.shape[0] for r in self.reqs])
        self.golden = {}
        for _, bits in FLEET_BUDGETS:
            y = cpu.build(bits=bits)(np.concatenate(self.reqs)).numpy()
            self.golden[bits] = [y[offs[i]:offs[i + 1]]
                                 for i in range(len(self.reqs))]
        # request i's budget walks W8/W4/W2
        self.plan = [(i, *FLEET_BUDGETS[i % 3]) for i in range(len(self.reqs))]
        self.canaries = CanarySet.capture(self.pts, [(self.reqs[0],)], k=1)
        counter = [0]
        self.chaos = {n: ChaosExecutable(exe, counter=counter)
                      for n, exe in self.pts.items()}
        self.scrubber = None         # the buffer's scrubber
        self._scrubber_lock = threading.Lock()
        self.built = []              # one record per server built

    def exact(self, i: int, bits: int, out) -> bool:
        import numpy as np
        return np.array_equal(np.asarray(out), self.golden[bits][i])

    def wave(self, router, label: str) -> int:
        """Every request of the plan, one budget group at a time (a batch
        takes its members' least budget).  Each result must equal its
        golden; a ticket not resolved in time is a lost ticket."""
        for budget, _ in FLEET_BUDGETS:
            tickets = [(i, bits, router.submit(self.reqs[i], budget=budget))
                       for i, b, bits in self.plan if b == budget]
            for i, bits, tk in tickets:
                if not self.exact(i, bits, tk.result(timeout=120)):
                    raise AssertionError(
                        f"{self.name} fleet {label}: request {i} at W{bits} "
                        "differs from its golden")
        return len(self.plan)

    def restore_master(self) -> None:
        """Pristine codes and scales, every view re-derived and resealed."""
        import torch
        for n, t in self.packed.tensors.items():
            codes, scale = self.master[n]
            t.codes = torch.from_numpy(codes.copy()).to(self.device)
            t.scale = torch.from_numpy(scale.copy()).to(self.device)
            t.seal()
            for bits, align in list(t._packed):
                t.repair_view(bits, align=align)

    def live_scrubber(self):
        """The buffer's scrubber, started on first use.  Once it has
        quarantined the weights, the pristine master is restored and a
        fresh scrubber takes over."""
        from repro_torch.runtime.integrity import Scrubber
        with self._scrubber_lock:
            sc = self.scrubber
            if sc is not None and not sc.quarantined:
                return sc
            if sc is not None:
                sc.stop()
                self.restore_master()
            self.scrubber = Scrubber(
                self.packed, rate_bytes_s=FLEET_SCRUB_RATE,
                interval_s=FLEET_SCRUB_INTERVAL).start()
            return self.scrubber

    def factory(self, name: str):
        from repro_torch.core.adaptive import BudgetSelector
        from repro_torch.core.flow import DEFAULT_POINTS
        from repro_torch.runtime.serve import AccelServer

        def build():
            sc = self.live_scrubber()
            pts = self.chaos if name == "c" else self.pts
            srv = AccelServer(
                pts["w8"], max_batch=8, max_wait=0.002,
                point_executables=dict(pts),
                selector=BudgetSelector(list(DEFAULT_POINTS),
                                        thresholds=[0.66, 0.33]))
            srv.attach_scrubber(sc)          # quarantine -> fatal server
            rec = {"replica": name, "server": srv, "detected_at": None,
                   "batches_at_detection": None}

            def detected(mismatch):
                # runs after attach_scrubber's own hook has killed the server
                if rec["detected_at"] is None:
                    rec["detected_at"] = time.monotonic()
                    rec["batches_at_detection"] = srv.executed_batches

            sc.add_on_quarantine(detected)
            self.built.append(rec)
            return srv
        return build

    def router(self, **kw):
        """A router over the three replicas."""
        from repro_torch.runtime.fleet import FleetRouter
        return FleetRouter({n: self.factory(n) for n in FLEET_REPLICAS},
                           retries=3, backoff_s=0.002, probe_interval_s=0.005,
                           heal_cooldown_s=0.2, default_deadline_s=60.0,
                           straggler_factor=20.0, seed=SEED, **kw)

    def stop(self) -> None:
        if self.scrubber is not None:
            self.scrubber.stop()


def _healthy(router) -> bool:
    from repro_torch.runtime.fleet import HealthState
    return all(r.state == HealthState.HEALTHY and r.server is not None
               and r.server.alive for r in router.replicas.values())


def _fleet_view_flip(rig, router) -> dict:
    """Step 2: one bit of the largest W4 view flipped; the scrubber repairs
    it in place from the master codes, then every request again."""
    from repro_torch.runtime.integrity import BitFlipInjector
    v4 = max((r for r in rig.packed.regions()
              if r.kind == "view" and r.bits == 4), key=lambda r: r.nbytes)
    t0 = time.monotonic()
    BitFlipInjector(rig.packed, seed=SEED).flip(region=v4)
    if not _wait(lambda: rig.packed.verify() == [], 20.0):
        raise AssertionError(f"{rig.name} fleet: the W4 view flip was not "
                             "repaired")
    repair_ms = 1e3 * (time.monotonic() - t0)
    integ = router.stats()["integrity"]
    if integ["repaired_views"] < 1 or integ["quarantines"]:
        raise AssertionError(f"{rig.name} fleet: view repair telemetry "
                             f"{integ}")
    return {"region": v4.label(), "flip_to_repair_ms": repair_ms,
            "served_after": rig.wave(router, "after the view repair")}


def _fleet_master_flip(rig, router, seed: int) -> dict:
    """Step 3: three clients, each sending sequential W8 requests (the
    point that reads the master codes), so that a master-code bit flips
    under steady traffic with no backlog; they go on until every replica
    is healed and readmitted.  The
    scrubber's first detection must kill every replica's server, and no
    server may finish a batch after it; every replica is ejected
    ``quarantined``, healed and readmitted.  The W8 results served between
    the flip and detection that differ from their golden are counted; no
    request submitted after detection may be served a corrupted result."""
    from repro_torch.runtime.fleet import FleetError, HealthState
    from repro_torch.runtime.integrity import BitFlipInjector, IntegrityError
    if not _wait(lambda: _healthy(router), 20.0):
        raise AssertionError(f"{rig.name} fleet: not healthy before the "
                             "master-code flip")
    poisoned = [r for r in rig.built
                if r["server"] is router.replicas[r["replica"]].server]
    before = {n: (r.ejections, r.readmissions, r.generation)
              for n, r in router.replicas.items()}
    window, ejected_at, readmit_at = [], {}, {}

    def watch() -> bool:
        """Record each replica's ejection and readmission; True once every
        replica is back."""
        now = time.monotonic()
        for n, r in router.replicas.items():
            if r.state == HealthState.EJECTED and n not in ejected_at:
                ejected_at[n] = r.ejected_at
            if n in ejected_at and n not in readmit_at \
                    and r.readmissions > before[n][1]:
                readmit_at[n] = now
        return len(readmit_at) == len(FLEET_REPLICAS) and _healthy(router)

    stop, errors = threading.Event(), []

    def client(c: int) -> None:
        """Sequential W8 requests, one in flight at a time."""
        k = c
        while not stop.is_set():
            i = rig.plan[k % len(rig.plan)][0]
            k += len(FLEET_REPLICAS)
            t_sub = time.monotonic()
            try:
                out = router(rig.reqs[i], budget=1.0)
                ok = rig.exact(i, 8, out)
            except FleetError as e:           # typed shed or failure
                ok = type(e).__name__
                time.sleep(0.002)
            except Exception as e:            # re-raised after the join
                errors.append(e)
                return
            window.append((t_sub, time.monotonic(), ok))

    # one paced client per replica, at most one request each in flight:
    # the bit flips under steady traffic with no backlog
    clients = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(FLEET_REPLICAS))]
    for th in clients:
        th.start()
    time.sleep(0.05)
    t_flip = time.monotonic()
    flip = BitFlipInjector(rig.packed, seed=seed, kinds=("codes",)).flip(3)
    healed = _wait(watch, 30.0)
    stop.set()
    for th in clients:
        th.join(120.0)
    if errors:
        raise errors[0]
    if not healed:
        raise AssertionError(f"{rig.name} fleet: not healed after the "
                             f"master-code flip: {router.stats()}")
    for n, r in router.replicas.items():
        if r.eject_cause != "quarantined" or r.ejections <= before[n][0] \
                or r.generation <= before[n][2]:
            raise AssertionError(f"{rig.name} fleet: replica {n} was not "
                                 "ejected quarantined and rebuilt: "
                                 f"{r.snapshot()}")
    for rec in poisoned:
        srv = rec["server"]
        if not isinstance(srv.fatal, IntegrityError) \
                or rec["detected_at"] is None:
            raise AssertionError(f"{rig.name} fleet: replica "
                                 f"{rec['replica']} did not die of the "
                                 f"quarantine ({srv.fatal!r})")
        if srv.executed_batches != rec["batches_at_detection"]:
            raise AssertionError(
                f"{rig.name} fleet: replica {rec['replica']} finished "
                f"{srv.executed_batches - rec['batches_at_detection']} "
                "batches after its detection")
    detected = sorted(r["detected_at"] for r in poisoned)
    # the window: requests submitted before detection that resolved after
    # the flip (a dead server resolves none, so those served, were served
    # before detection)
    pre = [ok for t, done, ok in window if t < detected[0] and done > t_flip]
    post = [ok for t, _, ok in window if t >= detected[0]]
    if any(ok is False for ok in post):
        raise AssertionError(f"{rig.name} fleet: a request submitted after "
                             "detection was served a corrupted result")
    served = sum(isinstance(ok, bool) for ok in pre)
    return {
        "region": flip.region.label(), "byte": flip.byte, "bit": flip.bit,
        "requests_in_window": len(pre), "served_in_window": served,
        # with nothing served in the window, the count was not measured
        "corrupted_before_detection": (sum(ok is False for ok in pre)
                                       if served else None),
        "typed_failures_in_window": sum(isinstance(ok, str) for ok in pre),
        "requests_after_detection": len(post),
        "served_after_detection": sum(ok is True for ok in post),
        "corrupted_after_detection": 0, "batches_after_detection": 0,
        "flip_to_detection_ms": 1e3 * (detected[0] - t_flip),
        "detection_spread_ms": 1e3 * (detected[-1] - detected[0]),
        "eject_to_readmit_ms": {n: 1e3 * (readmit_at[n] - ejected_at[n])
                                for n in sorted(readmit_at)},
        "served_after": rig.wave(router, "after the heal")}


def _master_flips_summary(flips: list) -> dict:
    """Step 3's flips together: the corrupted results served between a
    flip and its detection, out of those served there (None, not measured,
    while nothing was served there), and each flip's times."""
    served = sum(f["served_in_window"] for f in flips)
    return {
        "flips": flips, "served_in_window": served,
        "corrupted_before_detection": (
            sum(f["corrupted_before_detection"] or 0 for f in flips)
            if served else None),
        "served_after_detection": sum(f["served_after_detection"]
                                      for f in flips),
        "corrupted_after_detection": 0, "batches_after_detection": 0,
        "flip_to_detection_ms": [f["flip_to_detection_ms"] for f in flips],
        "detection_spread_ms": max(f["detection_spread_ms"] for f in flips),
        "eject_to_readmit_ms": {n: [f["eject_to_readmit_ms"][n]
                                    for f in flips]
                                for n in FLEET_REPLICAS},
        "served_after": sum(f["served_after"] for f in flips)}


def _fleet_crash(rig, router) -> dict:
    """Step 4: replica ``c`` crashes its pump; it is ejected ``dead-pump``,
    healed and readmitted, and no ticket is lost or failed."""
    c = router.replicas["c"]
    before = (c.ejections, c.readmissions, router.stats()["failed"])
    for exe in rig.chaos.values():
        exe.crash_at = {exe.counter[0] + 2}
    served = 0
    for _ in range(5):
        served += rig.wave(router, "around the pump crash")
        if any(exe.crashed for exe in rig.chaos.values()):
            break
    else:
        raise AssertionError(f"{rig.name} fleet: the crash never fired")
    if not _wait(lambda: c.readmissions > before[1] and _healthy(router),
                 30.0):
        raise AssertionError(f"{rig.name} fleet: replica c not healed after "
                             f"its crash: {c.snapshot()}")
    if c.eject_cause != "dead-pump" or c.ejections <= before[0]:
        raise AssertionError(f"{rig.name} fleet: the crash was not ejected "
                             f"dead-pump: {c.snapshot()}")
    if router.stats()["failed"] != before[2]:
        raise AssertionError(f"{rig.name} fleet: tickets failed around the "
                             "crash")
    return {"served": served, "eject_cause": c.eject_cause,
            "generation": c.generation}


def _fleet_brownout(rig, n: int = 384) -> dict:
    """Step 5: a fresh router whose replicas share one ``BrownoutSelector``
    takes a burst of ``n`` requests; the backlog walks the fleet down the
    ladder, every result equals one point's golden, and the replicas' stats
    show W4 and W2 batches."""
    from repro_torch.core.adaptive import BrownoutSelector, ServiceObjective
    from repro_torch.core.flow import DEFAULT_POINTS
    sel = BrownoutSelector(list(DEFAULT_POINTS),
                           ServiceObjective(p95_latency_s=5.0, window=16,
                                            min_samples=4, hold=48),
                           max_queue_depth=8)
    router = rig.router(brownout=sel).start()
    try:
        reqs = rig.reqs
        burst = [(i % len(reqs), router.submit(reqs[i % len(reqs)]))
                 for i in range(n)]
        for i, tk in burst:
            out = tk.result(timeout=120)
            if not any(rig.exact(i, bits, out) for _, bits in FLEET_BUDGETS):
                raise AssertionError(f"{rig.name} fleet brownout: request "
                                     f"{i} matches no point's golden")
        views = {}
        for r in router.replicas.values():
            for bits, k in r.server.stats().get("bits_views", {}).items():
                views[bits] = views.get(bits, 0) + k
    finally:
        router.stop()
    if not {4, 2} <= set(views):
        raise AssertionError(f"{rig.name} fleet brownout: bits_views {views} "
                             "lacks W4/W2 batches")
    return {"requests": n, "shifts": sel.shifts, "bits_views": views}


FLEET_RATE_MODES = ("off", "on")


def _fleet_rates(rig, rounds: int) -> dict:
    """Requests/s of a fresh router over every request of the plan with the
    buffer's scrubber off and on, the order alternating each round; and the
    bytes/s the scrubber re-hashed in the runs with it on."""
    import numpy as np
    rates = {m: [] for m in FLEET_RATE_MODES}
    scrubbed = []
    router = rig.router().start()
    sc = rig.live_scrubber()
    try:
        rig.wave(router, "warm-up")
        for rnd in range(rounds):
            for mode in FLEET_RATE_MODES[::1 if rnd % 2 == 0 else -1]:
                sc.stop()
                if mode == "on":
                    sc.start()
                b0 = sc.scrubbed_bytes
                t0 = time.perf_counter()
                n = rig.wave(router, f"rate run (scrubber {mode})")
                secs = time.perf_counter() - t0
                rates[mode].append(n / secs)
                if mode == "on":
                    scrubbed.append((sc.scrubbed_bytes - b0) / secs)
    finally:
        router.stop()
    return {"requests_per_s": rates,
            "median": {m: float(np.median(v)) for m, v in rates.items()},
            "spread": {m: [min(v), max(v)] for m, v in rates.items()},
            "scrubbed_bytes_s": scrubbed, "rate_bytes_s": FLEET_SCRUB_RATE}


def _region_hash_times(packed, device: str, reps: int = 20) -> dict:
    """What one region's check costs with nothing else running: a copy to
    the host and a CRC32 (medians of ``reps``), for the largest and the
    smallest region, and one full pass over every region."""
    import numpy as np
    from repro_torch.runtime.integrity import Scrubber

    def median_s(fn) -> float:
        ts = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    regions = packed.regions()
    out = {}
    for r in (max(regions, key=lambda r: r.nbytes),
              min(regions, key=lambda r: r.nbytes)):
        out[r.label()] = {"bytes": r.nbytes, "us": 1e6 * median_s(
            lambda r=r: packed.verify_region(r))}
    return {"region": out, "regions": len(regions),
            "period_bytes": sum(r.nbytes for r in regions),
            "pass_ms": 1e3 * median_s(Scrubber(packed).scrub_once)}


def fleet_path(name: str, cfg, card: str = "", device: str = "cuda",
               n_requests: int = 66, rate_rounds: int = 4) -> dict:
    """Fault-tolerant fleet serving with weight-memory integrity on
    ``device``: separable-cnn at D8-W8, its W8/W4/W2 point executables over
    ONE packed buffer (``shared_point_executables``), three ``AccelServer``
    replicas behind a ``FleetRouter`` with semantic canaries captured on
    ``device``, and one ``Scrubber`` over the buffer attached to every
    replica's server.
    Every result is held bit for bit against the CPU plain path's golden
    for its request and point.

    1. ``n_requests`` requests of 1-8 rows, their budgets walking W8/W4/W2;
    2. :func:`_fleet_view_flip`; 3. :func:`_fleet_master_flip`, once for
    each of ``FLEET_MASTER_FLIPS`` seeds;
    4. :func:`_fleet_crash`; 5. :func:`_fleet_brownout`.

    The launch counters are zeroed before step 1 and read after step 5.
    Then, outside that count, :func:`_fleet_rates` and
    :func:`_region_hash_times`."""
    t_phase = time.perf_counter()
    rig = _FleetRig(name, cfg, device, n_requests)
    info = {"path": "fleet qtorch D8-W8", "model": name, "card": card,
            "replicas": len(FLEET_REPLICAS), "requests": len(rig.reqs)}
    try:
        _zero_counts()
        t0 = time.perf_counter()
        router = rig.router(canaries=rig.canaries).start()
        try:
            info["served_clean"] = rig.wave(router, "before any flip")
            info["view_flip"] = _fleet_view_flip(rig, router)
            info["master_flip"] = _master_flips_summary(
                [_fleet_master_flip(rig, router, SEED + 1 + k)
                 for k in range(FLEET_MASTER_FLIPS)])
            info["crash"] = _fleet_crash(rig, router)
            stats = router.stats()
        finally:
            router.stop()
        info["brownout"] = _fleet_brownout(rig)
        info["launches"] = _read_counts()
        info["main_path_s"] = time.perf_counter() - t0
        _expect_launched(f"{name} fleet", info["launches"],
                         ["qgemm", "qconv_dw"], device)
        info["integrity"] = stats["integrity"]
        info["replicas_after"] = stats["replicas"]
        info["scrub_on_off"] = _fleet_rates(rig, rate_rounds)
    finally:
        rig.stop()
    info["hash"] = _region_hash_times(rig.packed, device)
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"main path {name} fleet: " + json.dumps(
        {k: v for k, v in info.items() if k != "replicas_after"}))
    mf, rates, h = info["master_flip"], info["scrub_on_off"], info["hash"]
    corrupted = ("not measured (nothing served between the flip and "
                 "detection)" if mf["corrupted_before_detection"] is None
                 else f"{mf['corrupted_before_detection']} of "
                 f"{mf['served_in_window']} served")
    log(f"fleet {name} ({card}): {FLEET_MASTER_FLIPS} master-code flips: "
        f"corrupted results served between a flip and its detection "
        f"{corrupted}, after it 0 of {mf['served_after_detection']} served; "
        f"flip to detection "
        f"{[round(t, 3) for t in mf['flip_to_detection_ms']]} ms, every "
        f"replica dead within {mf['detection_spread_ms']:.3f} ms; eject to "
        "readmission "
        f"{mf['eject_to_readmit_ms']} ms; W4 view repaired in "
        f"{info['view_flip']['flip_to_repair_ms']:.3f} ms; req/s median "
        f"[min, max] with the scrubber off and on {rates['median']} "
        f"{rates['spread']}; scrubbed B/s {rates['scrubbed_bytes_s']} "
        f"against {FLEET_SCRUB_RATE:.0f}; region hash {h['region']}; pass "
        f"{h['pass_ms']:.3f} ms")
    return info


# -- LM paths: mamba2-1.3b, hymba-1.5b, qwen1.5-0.5b ---------------------------

LM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "hymba-1.5b"
DENSE_ARCH = "qwen1.5-0.5b"
LM_POINTS = (("w8", 8), ("w4", 4), ("w2", 2))


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def lm_params(cfg, device: str = "cuda") -> dict:
    """Seeded random weights of ``cfg``, drawn on ``device`` by a generator
    seeded from SEED (the reference's distributions)."""
    import torch
    from repro_torch.models.params import init_params
    g = torch.Generator(device=device).manual_seed(SEED)
    return init_params(cfg, g, device=device)


def _tokens(cfg, shape, seed: int, device: str):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=g, device=device)


def _expect_ssd_launches(name: str, launches: dict, cfg,
                         device: str) -> None:
    """One ``ssd_scan`` launch per layer of a prefill on the card for a
    model with an SSM block, and one of each of its three phases; none for
    a dense model."""
    if device != "cuda":
        return
    n = cfg.n_layers if cfg.ssm is not None else 0
    for k in ("ssd_scan",) + tuple(f"ssd_scan.{p}" for p in SSD_PHASES):
        if launches[k] != n:
            raise AssertionError(f"{name}: {launches[k]} {k} launches, "
                                 f"expected {n}")


def lm_prefill_path(cfg, params, batch: int = 4, seq: int = 2048,
                    device: str = "cuda", reps: int = 3) -> dict:
    """``make_prefill_step(cfg)`` on (batch, seq) tokens: one prefill with
    the counters zeroed just before it and read just after (one
    ``ssd_scan`` launch per layer with an SSM block, none for a dense
    model), finite logits of the padded vocab, then ``reps`` timed prefills
    for tokens/s."""
    import statistics
    import torch
    from repro_torch.models.attention import prefill_route
    from repro_torch.runtime.serve import make_prefill_step
    toks = _tokens(cfg, (batch, seq), SEED + 5, device)
    prefill = make_prefill_step(cfg)
    _zero_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": toks})
    _sync(device)
    first_s = time.perf_counter() - t0
    launches = _read_counts()
    name = f"{cfg.name} prefill"
    if tuple(logits.shape) != (batch, seq, cfg.vocab_padded):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: non-finite logits")
    _expect_ssd_launches(name, launches, cfg, device)
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        prefill(params, {"tokens": toks})
        _sync(device)
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    info = {"path": f"prefill {cfg.dtype} ({batch}, {seq})",
            "model": cfg.name, "launches": launches,
            "attention": None if cfg.attention_free
            else prefill_route(cfg, seq), "first_s": first_s,
            "prefill_s": secs, "tokens_per_s": batch * seq / med,
            "logits_max_abs": float(logits.float().abs().max())}
    log(f"main path {cfg.name} prefill: " + json.dumps(info))
    return info


def lm_f32_decode_check(cfg, batch: int = 2, seq: int = 100,
                        device: str = "cuda", n_layers=None,
                        sliding_window=None, q_chunk=None) -> dict:
    """In an f32 copy of ``cfg``: ``forward`` (through the scan kernel where
    the model has an SSM block) against ``decode_step`` fed token by token,
    every logit within the reference's ``5e-3*max|logit|``
    (tests/test_serve.py).  ``n_layers``, ``sliding_window`` and ``q_chunk``
    (attention's ``Q_CHUNK`` for the run) cut the config so a short run
    reaches the banded prefill and wraps the decode ring buffer, which a
    ``sliding_window`` cut must then do; each cut is named in the output."""
    import dataclasses
    import torch
    from repro_torch.models import attention
    from repro_torch.runtime import model_api
    cuts, reduced = {}, {}
    if n_layers is not None:
        cuts["n_layers"] = n_layers
    if sliding_window is not None:
        cuts["sliding_window"] = sliding_window
    for k, v in cuts.items():
        reduced[k] = f"{getattr(cfg, k)} -> {v}"
    cfg32 = dataclasses.replace(cfg, dtype="float32", **cuts)
    q_chunk_was = attention.Q_CHUNK
    if q_chunk is not None:
        reduced["attention.Q_CHUNK"] = f"{q_chunk_was} -> {q_chunk}"
        attention.Q_CHUNK = q_chunk
    try:
        params = lm_params(cfg32, device)
        toks = _tokens(cfg32, (batch, seq), SEED + 6, device)
        route = None if cfg32.attention_free else \
            attention.prefill_route(cfg32, seq)
        _zero_counts()
        t0 = time.perf_counter()
        fwd, _ = model_api.forward_logits(params, {"tokens": toks}, cfg32)
        _sync(device)
        fwd_s = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        attention.Q_CHUNK = q_chunk_was
    name = f"{cfg.name} f32 forward"
    _expect_ssd_launches(name, launches, cfg32, device)
    st = model_api.init_decode_state(params, {"tokens": toks}, cfg32, batch,
                                     seq, dtype=torch.float32)
    ring = None if st.cache_k is None else st.cache_k.shape[2]
    err = torch.zeros((), device=device)
    t0 = time.perf_counter()
    for t in range(seq):
        logits, st = model_api.decode_step(params, toks[:, t:t + 1], st, cfg32)
        err = torch.maximum(err, (logits[:, 0] - fwd[:, t]).abs().max())
    _sync(device)
    decode_s = time.perf_counter() - t0
    scale = float(fwd.abs().max())
    rel = float(err) / scale
    del params
    if not rel <= 5e-3:
        raise AssertionError(f"{name}: decode/forward mismatch {rel} of "
                             "max|logit| (bound 5e-3)")
    if sliding_window is not None and not (route == "banded" and ring < seq):
        raise AssertionError(f"{name}: {route} prefill and {ring} cache "
                             f"slots for {seq} tokens: the cut config missed "
                             "the banded prefill or the ring wrap")
    info = {"path": f"forward f32 vs decode ({batch}, {seq})",
            "model": cfg.name, "reduced": reduced, "launches": launches,
            "attention": route, "kv_cache_slots": ring,
            "max_err_over_max_logit": rel, "forward_s": fwd_s,
            "decode_s": decode_s}
    log(f"main path {cfg.name} f32 forward vs decode: " + json.dumps(info))
    return info


def lm_serve_path(cfg, params, batch: int = 4, steps: int = 12,
                  prompt_len: int = 16, new: int = 8,
                  device: str = "cuda") -> dict:
    """``AdaptiveLMServer`` with the budget walking 1.0 -> 0 over ``steps``
    decode steps at thresholds 0.66/0.33: the points seen are w8, w4, w2 in
    order, weight bytes fall with the point, the master codes are unchanged
    and every logit is finite; then ``greedy_generate`` of ``new`` tokens
    after a ``prompt_len``-token prompt.  The decode path launches no
    kernel of this slice (the scan kernel runs in the prefill)."""
    import statistics
    import torch
    from repro_torch.core.adaptive import RuntimePolicy, WorkingPoint
    from repro_torch.runtime import model_api
    from repro_torch.runtime.serve import AdaptiveLMServer, greedy_generate
    points = [WorkingPoint(n, b) for n, b in LM_POINTS]
    name = f"{cfg.name} AdaptiveLMServer"
    _zero_counts()
    t0 = time.perf_counter()
    srv = AdaptiveLMServer(params, cfg, points,
                           RuntimePolicy(points, thresholds=[0.66, 0.33]))
    _sync(device)
    quantize_s = time.perf_counter() - t0
    codes = {k: v.clone() for k, v in srv.qparams.codes.items()}
    tok = _tokens(cfg, (batch, 1), SEED + 7, device)
    state = model_api.init_decode_state(params, {"tokens": tok}, cfg, batch,
                                        steps + 1)
    seen, nbytes, step_s = [], {}, {}
    for i in range(steps):
        t1 = time.perf_counter()
        logits, state, m = srv.decode(tok, state, 1.0 - i / steps)
        _sync(device)
        step_s.setdefault(m.point, []).append(time.perf_counter() - t1)
        if not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"{name}: non-finite logits at step {i}")
        tok = torch.argmax(logits[:, -1:, : cfg.vocab], dim=-1)
        seen.append(m.point)
        nbytes[m.point] = m.weight_bytes_read
    order = list(dict.fromkeys(seen))
    if order != [n for n, _ in LM_POINTS]:
        raise AssertionError(f"{name}: points seen {seen}")
    if not nbytes["w8"] > nbytes["w4"] > nbytes["w2"]:
        raise AssertionError(f"{name}: weight bytes {nbytes} do not fall")
    if sorted(codes) != sorted(srv.qparams.codes) or not all(
            torch.equal(codes[k], srv.qparams.codes[k]) for k in codes):
        raise AssertionError(f"{name}: the master codes changed")
    prompt = _tokens(cfg, (batch, prompt_len), SEED + 8, device)
    t1 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, max_new=new,
                          seq_len=prompt_len + new)
    _sync(device)
    gen_s = time.perf_counter() - t1
    if tuple(out.shape) != (batch, prompt_len + new) \
            or not torch.equal(out[:, :prompt_len], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"{name}: greedy_generate gave {out.shape}")
    launches = _read_counts()
    info = {"path": f"AdaptiveLMServer decode bf16 (batch {batch})",
            "model": cfg.name, "launches": launches, "points": seen,
            "weight_bytes_read": nbytes, "quantize_s": quantize_s,
            "decode_step_s": step_s,
            "decode_tokens_per_s": {p: batch / statistics.median(v)
                                    for p, v in step_s.items()},
            "greedy_generate_s": gen_s,
            "greedy_tokens_per_s": batch * (prompt_len + new) / gen_s}
    log(f"main path {name}: " + json.dumps(info))
    return info


def lm_paths(cfg, **check) -> list:
    """One LM at full width on the card: :func:`lm_prefill_path`,
    :func:`lm_f32_decode_check` (``check`` cuts its config) and
    :func:`lm_serve_path`, on seeded weights freed afterwards."""
    import torch
    params = lm_params(cfg)
    out = [lm_prefill_path(cfg, params), lm_f32_decode_check(cfg, **check),
           lm_serve_path(cfg, params)]
    del params
    torch.cuda.empty_cache()
    return out


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


def _graph_ms(fn, iters: int = 100, reps: int = 5):
    """Per-call time of ``iters`` calls captured in one CUDA graph and
    replayed back to back between CUDA events: no host work between the
    calls, so the card stays busy and at its working clock.  None (logged)
    where the calls cannot be captured."""
    import torch
    try:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * reps)
    except RuntimeError as e:
        log(f"CUDA graph capture failed: {str(e)[:200]}")
        return None


def _measure(fn, iters: int = 200, graph: bool = False) -> dict:
    out = {"event_ms": _event_ms(fn, iters, min(20, iters)),
           "device_ms": _device_ms(fn, max(iters // 4, 3))}
    if graph:
        out["graph_ms"] = _graph_ms(fn)
    return out


def _bound(nbytes: int, ops: int, ops_per_s: float = INT8_OPS_PER_S) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_us": 1e6 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _ms(m: dict) -> float:
    """The number a row reports: device time when the profiler measured it,
    else the event time."""
    return m["device_ms"] if m["device_ms"] is not None else m["event_ms"]


def _int_mm_measure(x, w):
    """``torch._int_mm`` on zero-padded copies of the (M, K) and (K, N) int8
    operands, made before the timing: its shape rules want M > 16 and K, N
    multiples of 8 (the FC's 8 x 1568 x 10 runs as 32 x 1568 x 16).  None
    where cuBLASLt refuses the shape."""
    import torch
    M, K = x.shape
    N = w.shape[1]
    Mp, Kp, Np = max(32, -(-M // 8) * 8), -(-K // 8) * 8, -(-N // 8) * 8
    xp = torch.zeros((Mp, Kp), dtype=torch.int8, device=x.device)
    wp = torch.zeros((Kp, Np), dtype=torch.int8, device=x.device)
    xp[:M, :K] = x
    wp[:K, :N] = w
    try:
        torch._int_mm(xp, wp)
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"torch._int_mm refused {Mp}x{Kp}x{Np}: {str(e)[:120]}")
        return None
    res = _measure(lambda: torch._int_mm(xp, wp), graph=True)
    res["padded_shape"] = [Mp, Kp, Np]
    return res


def times() -> dict:
    """Each kernel's launch wrapper at every batch-8 call of the main path
    (W8 unpacked, int8 codes out with bias and ReLU, as the path runs them),
    its plain version on the same inputs, and the nearest library call:
    ``torch._int_mm`` on zero-padded operands, ``F.conv2d(groups=C)`` in
    f32 with TF32 off."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import checks
    from repro_torch.kernels.qconv_dw.ops import (qconv_dw,
                                                  qconv_dw_int8_act_plain)
    from repro_torch.kernels.qmatmul.ops import (pick_tiles, qgemm,
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
        kern = _measure(lambda: qgemm(x, w, s, b, bits=8, packed=False,
                                      **epi), graph=True)
        plain = _measure(lambda: qmatmul_int8_act_plain(
            x, 1.0, w, s, b, bits=8, packed=False, **epi), graph=True)
        lib = _int_mm_measure(x, w)
        row = dict(shape=[M, K, N], tiles=str(pick_tiles(M, K, N)),
                   kernel=kern, plain=plain, library=lib,
                   **_bound(M * K + K * N + 8 * N + M * N, 2 * M * K * N))
        rows["qgemm"].append(row)
        if (M, K, N) == checks.QGEMM_PATH_SHAPES[1]:
            # the per-row x-scale mode at pw0: acc * xs[m] * s[n]
            xs = (torch.rand((M,), generator=g) * 0.05 + 1e-3).to(dev)
            rows["qgemm_xscale"] = [dict(
                shape=[M, K, N], library=lib,
                kernel=_measure(lambda: qgemm(x, w, s, b, bits=8,
                                              packed=False, xs=xs, **epi)),
                plain=_measure(lambda: qmatmul_int8_act_plain(
                    x, xs, w, s, b, bits=8, packed=False, **epi)),
                **_bound(M * K + K * N + 8 * N + 4 * M + M * N,
                         2 * M * K * N))]
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
        kern = _measure(lambda: qconv_dw(x, w, s, b, **epi), graph=True)
        plain = _measure(lambda: qconv_dw_int8_act_plain(x, 1.0, w, s, b,
                                                         **epi), graph=True)
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wf = w.t().reshape(C, 1, 3, 3).float().contiguous()
        lib = _measure(lambda: F.conv2d(xf, wf, stride=stride, padding=1,
                                        groups=C), graph=True)
        oh, ow = -(-H // stride[0]), -(-W // stride[1])
        row = dict(shape=[B, H, W, C], strides=list(stride), kernel=kern,
                   plain=plain, library=lib,
                   **_bound(B * H * W * C + 9 * C + 8 * C + B * oh * ow * C,
                            2 * 9 * B * oh * ow * C))
        rows["qconv_dw"].append(row)
    rows.update(times_im2col(g, dev))
    rows.update(times_float(g, dev))
    rows.update(times_ssd(dev))
    rows.update(times_attention(dev))
    for name, rs in rows.items():
        for r in rs:
            log(f"time {name} {json.dumps(r)}")
    return rows


def times_im2col(g, dev) -> dict:
    """The im2col depthwise baseline's two ``qgemm`` calls at batch 8 (dw0
    as 1568 x 72 x 8, dw1 as 392 x 144 x 16 over the dense block-diagonal
    codes), in both modes as the D8 and D16 paths run them (W8 unpacked,
    bias, ReLU; int8 codes out, or the 16-bit fake-quant), each beside its
    plain version, the library call on the same patches (``torch._int_mm``;
    ``torch.matmul`` in f32, TF32 off) and its bound."""
    import torch
    from repro_torch.kernels import checks
    from repro_torch.kernels.qconv_dw.ref import expand_dw_codes
    from repro_torch.kernels.qmatmul.ops import (pick_tiles, qgemm, qgemm_f32,
                                                 qgemm_float_plain,
                                                 qmatmul_int8_act_plain)
    rows = {"qgemm_im2col": [], "qgemm_f32_im2col": []}
    for M, K, N in checks.QGEMM_DW_IM2COL_SHAPES[:2]:
        taps = torch.randint(-127, 128, (3, 3, 1, N), generator=g,
                             dtype=torch.int8)
        w = expand_dw_codes(taps).to(dev)
        s = (torch.rand((N,), generator=g) * 1e-2).to(dev)
        b = (torch.randn((N,), generator=g) * 0.1).to(dev)
        x = torch.randint(-128, 128, (M, K), generator=g,
                          dtype=torch.int8).to(dev)
        epi = dict(relu=True, act_qt=(4, -128, 127), out_code=True)
        rows["qgemm_im2col"].append(dict(
            shape=[M, K, N], tiles=str(pick_tiles(M, K, N)),
            kernel=_measure(lambda: qgemm(x, w, s, b, bits=8, packed=False,
                                          **epi), graph=True),
            plain=_measure(lambda: qmatmul_int8_act_plain(
                x, 1.0, w, s, b, bits=8, packed=False, **epi), graph=True),
            library=_int_mm_measure(x, w),
            **_bound(M * K + K * N + 8 * N + M * N, 2 * M * K * N)))
        xf = torch.randn((M, K), generator=g).to(dev)
        wf = w.float() * s
        fepi = dict(relu=True, act_qt=(10, -(2 ** 15), 2 ** 15 - 1))
        rows["qgemm_f32_im2col"].append(dict(
            shape=[M, K, N], tiles=str(pick_tiles(M, K, N, float_mode=True)),
            kernel=_measure(lambda: qgemm_f32(xf, w, s, b, bits=8,
                                              packed=False, **fepi),
                            graph=True),
            plain=_measure(lambda: qgemm_float_plain(
                xf, w, s, b, bits=8, packed=False, **fepi), graph=True),
            library=_measure(lambda: torch.matmul(xf, wf), graph=True),
            **_bound(4 * M * K + K * N + 8 * N + 4 * M * N, 2 * M * K * N,
                     F32_FLOPS_PER_S)))
    return rows


def times_float(g, dev) -> dict:
    """The float modes at the batch-8 calls of their paths: ``qgemm_f32``
    and ``qconv_dw_f32`` as the D16 qtorch path runs them (W8 unpacked,
    bias, ReLU, 16-bit fake-quant), against ``x @ w`` and
    ``F.conv2d(groups=C)`` in f32 (TF32 off); then the stream conv
    (:func:`times_conv2d_stream`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import checks
    from repro_torch.kernels.qconv_dw.ops import (qconv_dw_f32,
                                                  qconv_dw_float_plain)
    from repro_torch.kernels.qmatmul.ops import (pick_tiles, qgemm_f32,
                                                 qgemm_float_plain)
    rows = {"qgemm_f32": [], "qconv_dw_f32": []}
    aqt = (10, -(2 ** 15), 2 ** 15 - 1)
    epi = dict(relu=True, act_qt=aqt)

    for M, K, N in checks.QGEMM_PATH_SHAPES:
        x = torch.randn((M, K), generator=g).to(dev)
        w = torch.randint(-127, 128, (K, N), generator=g,
                          dtype=torch.int8).to(dev)
        s = (torch.rand((N,), generator=g) * 1e-2).to(dev)
        b = (torch.randn((N,), generator=g) * 0.1).to(dev)
        wf = w.float() * s
        kern = _measure(lambda: qgemm_f32(x, w, s, b, bits=8, packed=False,
                                          **epi), graph=True)
        plain = _measure(lambda: qgemm_float_plain(x, w, s, b, bits=8,
                                                   packed=False, **epi),
                         graph=True)
        lib = _measure(lambda: torch.matmul(x, wf), graph=True)
        rows["qgemm_f32"].append(dict(
            shape=[M, K, N], tiles=str(pick_tiles(M, K, N, float_mode=True)),
            kernel=kern, plain=plain, library=lib,
            **_bound(4 * M * K + K * N + 8 * N + 4 * M * N, 2 * M * K * N,
                     F32_FLOPS_PER_S)))
    for (B, H, W, C), stride in (((8, 14, 14, 8), (1, 1)),
                                 ((8, 14, 14, 16), (2, 2))):
        x = torch.randn((B, H, W, C), generator=g).to(dev)
        w = torch.randint(-127, 128, (9, C), generator=g,
                          dtype=torch.int8).to(dev)
        s = (torch.rand((C,), generator=g) * 1e-2).to(dev)
        b = (torch.randn((C,), generator=g) * 0.1).to(dev)
        common = dict(kh=3, kw=3, strides=stride, pads="SAME", bits=8,
                      packed=False, **epi)
        kern = _measure(lambda: qconv_dw_f32(x, w, s, b, **common),
                        graph=True)
        plain = _measure(lambda: qconv_dw_float_plain(x, w, s, b, **common),
                         graph=True)
        xf = x.permute(0, 3, 1, 2).contiguous()
        wf = (w.float() * s).t().reshape(C, 1, 3, 3).contiguous()
        lib = _measure(lambda: F.conv2d(xf, wf, stride=stride, padding=1,
                                        groups=C), graph=True)
        oh, ow = -(-H // stride[0]), -(-W // stride[1])
        rows["qconv_dw_f32"].append(dict(
            shape=[B, H, W, C], strides=list(stride), kernel=kern,
            plain=plain, library=lib,
            **_bound(4 * B * H * W * C + 9 * C + 8 * C + 4 * B * oh * ow * C,
                     2 * 9 * B * oh * ow * C, F32_FLOPS_PER_S)))
    rows.update(times_conv2d_stream(g, dev, mapping=True))
    return rows


def conv2d_stream_timed_shapes() -> list:
    """The stream target's five convs at batch 8 (mnist-cnn conv1 and conv2;
    separable-cnn stem, pw0 and pw1), then the same five at batch 32, the
    largest batch the reference's ``benchmarks/qpath_latency.py`` times."""
    from repro_torch.kernels import checks
    b8 = [tuple(s) for s in checks.CONV_STREAM_PATH_SHAPES]
    return b8 + [(32,) + s[1:] for s in b8]


def times_conv2d_stream(g, dev, mapping: bool) -> dict:
    """``conv2d_stream`` in f32 with bias, as the stream target runs it, at
    :func:`conv2d_stream_timed_shapes`: the kernel, its plain version and
    ``F.conv2d`` on channels-last views of the same memory (TF32 off), each
    also replayed from one CUDA graph, beside the bound: every input and
    output byte once over 3.35 TB/s, or 2*kh*kw*Cin operations an output
    over 67 f32 TFLOP/s.  With ``mapping``, each row also gives the call's
    ``stream_tiles`` mapping and its instance's registers and occupancy."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d_stream import ops
    from repro_torch.kernels.conv2d_stream.ref import conv2d_stream_plain
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for B, H, W, cin, cout, k in conv2d_stream_timed_shapes():
        x = torch.randn((B, H, W, cin), generator=g).to(dev)
        w = (torch.randn((k, k, cin, cout), generator=g) * 0.1).to(dev)
        b = (torch.randn((cout,), generator=g) * 0.1).to(dev)
        kern = _measure(lambda: ops.conv2d_stream_cuda(x, w, b), graph=True)
        plain = _measure(lambda: conv2d_stream_plain(x, w, b), graph=True)
        # the same NHWC memory seen as channels-last NCHW: no copy
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = _measure(lambda: F.conv2d(xl, wl, b, padding=k // 2),
                       graph=True)
        row = dict(shape=[B, H, W, cin, cout, k], kernel=kern, plain=plain,
                   library=lib,
                   **_bound(4 * (B * H * W * cin + k * k * cin * cout + cout
                                 + B * H * W * cout),
                            2 * B * H * W * k * k * cin * cout,
                            F32_FLOPS_PER_S))
        if mapping:
            t = ops.stream_tiles(B, H, W, cin, cout, k, k)
            row["tiles"] = t._asdict()
            row["instance"] = ops.conv2d_stream_info(t)
        rows.append(row)
    return {"conv2d_stream": rows}


def ssd_scan_bound(B: int, S: int, H: int, P: int, G: int, N: int, Q: int,
                   itemsize: int) -> dict:
    """The least time for the scan: bytes are x and y (``itemsize`` each),
    B and C, dt f32, A and D, the f32 final state, each once; operations are
    the causal part of C B^T and att @ x (Q(Q+1)/2 pairs per chunk), C times
    the state and (B w)^T x, as multiply-adds over 67 f32 TFLOP/s."""
    nc = -(-S // Q)
    pairs = Q * (Q + 1) // 2
    ops = 2 * B * H * nc * (pairs * (N + P) + 2 * Q * N * P)
    nbytes = (2 * B * S * H * P * itemsize + 2 * B * S * G * N * itemsize
              + 4 * B * S * H + 8 * H + 4 * B * H * P * N)
    return _bound(nbytes, ops, F32_FLOPS_PER_S)


def ssd_phase_bounds(B: int, S: int, H: int, P: int, G: int, N: int,
                     Q: int, itemsize: int) -> dict:
    """The least time for each phase's own work, counted as for
    :func:`ssd_scan_bound`: chunk_state reads x, B and dt and writes the
    (B,H,nc,N,P) f32 chunk states and decays, for (B w)^T x; state_pass
    reads and writes the chunk states and writes the final state, one
    multiply-add an element a chunk; chunk_scan reads x, B, C, dt and the
    entering states and writes y, for the causal part of C B^T and att @ x
    and C times the state."""
    nc = -(-S // Q)
    bh, pairs = B * H, Q * (Q + 1) // 2
    scratch = 4 * bh * nc * N * P
    xb, bcb, dtb = B * S * H * P * itemsize, B * S * G * N * itemsize, 4 * B * S * H
    return {
        "chunk_state": _bound(xb + bcb + dtb + 4 * H + scratch + 4 * bh * nc,
                              2 * bh * nc * Q * N * P, F32_FLOPS_PER_S),
        "state_pass": _bound(2 * scratch + 4 * bh * nc + 4 * bh * P * N,
                             2 * bh * nc * N * P, F32_FLOPS_PER_S),
        "chunk_scan": _bound(2 * xb + 2 * bcb + dtb + 8 * H + scratch,
                             2 * bh * nc * (pairs * (N + P) + Q * N * P),
                             F32_FLOPS_PER_S),
    }


def times_ssd(dev) -> dict:
    """``ssd_scan`` at the prefill calls of mamba2-1.3b and of hymba-1.5b's
    SSM half (:func:`time_ssd_call`)."""
    from repro_torch.kernels import checks
    return {"ssd_scan": [time_ssd_call(dev, checks.SSD_FULL_WIDTH),
                         time_ssd_call(dev, checks.SSD_HYMBA_FULL_WIDTH)]}


def time_ssd_call(dev, shape) -> dict:
    """``ssd_scan`` at one prefill call (batch 4 x 2048 tokens, bf16, x/B/C
    strided views of the fused conv output as the model passes them)
    against its plain version (all f32) and the model oracle with the bf16
    intra-chunk flag on, and each of its three phases on its own beside the
    bound of its own work.  No single PyTorch call computes the scan: no
    library time."""
    import torch
    from repro_torch.kernels import checks
    from repro_torch.kernels.ssd_scan.ops import (ssd_chunk_scan_cuda,
                                                  ssd_chunk_state_cuda,
                                                  ssd_scan_cuda,
                                                  ssd_state_pass_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
    from repro_torch.models.ssm import ssd_chunked
    Q = shape[-1]
    x, dt, A, Bm, C, D = checks.ssd_inputs(shape, 7000, torch.bfloat16, dev,
                                           fused=True)
    row = dict(
        shape=list(shape), dtype="bfloat16", library=None,
        kernel=_measure(lambda: ssd_scan_cuda(x, dt, A, Bm, C, D, Q), 20),
        plain=_measure(lambda: ssd_chunked_plain(x, dt, A, Bm, C, D, Q), 8),
        plain_bf16_intra=_measure(
            lambda: ssd_chunked(x, dt, A, Bm, C, D, Q), 8),
        **ssd_scan_bound(*shape, itemsize=2))
    # each phase alone; state_pass rewrites a copy of the chunk states in
    # place at every call, which changes its values but not its work
    states, decay = ssd_chunk_state_cuda(x, dt, A, Bm, Q)
    scratch = states.clone()
    ssd_state_pass_cuda(states, decay)
    bounds = ssd_phase_bounds(*shape, itemsize=2)
    calls = {
        "chunk_state": lambda: ssd_chunk_state_cuda(x, dt, A, Bm, Q),
        "state_pass": lambda: ssd_state_pass_cuda(scratch, decay),
        "chunk_scan": lambda: ssd_chunk_scan_cuda(x, dt, A, Bm, C, D, states,
                                                  Q),
    }
    row["phases"] = {name: dict(kernel=_measure(fn, 20), **bounds[name])
                     for name, fn in calls.items()}
    for name, r in row["phases"].items():
        log(f"time ssd_scan {list(shape)} phase {name}: {_ms(r['kernel'])} "
            f"ms (bound {r['bound_ms']} ms, {r['bound_by']})")
    return row


def attention_bound(B: int, S: int, H: int, Hkv: int, Dh: int, window,
                    itemsize: int = 2) -> dict:
    """The least time for one layer's prefill attention from q, k, v (after
    RoPE) to its output: bytes are q, k, v and the output, each once;
    operations are q.k and p.v over the (query, key) pairs the causal
    (and window) mask keeps, as multiply-adds over 989 bf16 TFLOP/s."""
    w = S if window is None else min(window, S)
    pairs = sum(min(i + 1, w) for i in range(S))
    nbytes = itemsize * B * S * Dh * (2 * H + 2 * Hkv)
    return _bound(nbytes, 4 * B * H * pairs * Dh, BF16_FLOPS_PER_S)


def times_attention(dev) -> dict:
    """One layer's attention prefill (``attention.attend``, from q, k, v
    after RoPE to the output before ``wo``) at the (4, 2048) bf16 prefill
    calls of hymba-1.5b (GQA 25/5, window 2048: the banded schedule) and
    qwen1.5-0.5b (16 heads: the chunked schedule), beside
    ``F.scaled_dot_product_attention`` on the same q, k and v (a yardstick
    only: the port never calls it) and the bound of the work."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.attention import attend, prefill_route
    rows = []
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    for arch in (HYBRID_ARCH, DENSE_ARCH):
        cfg = get_config(arch)
        B, S, H, Hkv, Dh = 4, 2048, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = (torch.randn((B, S, h, Dh), generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for h in (H, Hkv, Hkv))
        pos = torch.arange(S, device=dev)
        win = cfg.sliding_window
        mask = None
        if win is not None and win < S:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - win)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def lib():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=Hkv != H)

        out = attend(q, k, v, pos, pos, cfg)
        diff = float((out.float() - lib().transpose(1, 2).float()).abs()
                     .max())
        row = dict(model=arch, shape=[B, S, H, Hkv, Dh], window=win,
                   route=prefill_route(cfg, S), dtype="bfloat16",
                   kernel=_measure(lambda: attend(q, k, v, pos, pos, cfg), 10),
                   library=_measure(lib, 20), sdpa_max_abs_diff=diff,
                   **attention_bound(B, S, H, Hkv, Dh, win))
        log(f"time attention {arch} {row['route']} {row['shape']}: "
            f"{_ms(row['kernel'])} ms (SDPA {_ms(row['library'])} ms, bound "
            f"{row['bound_ms']} ms {row['bound_by']}, max |port - SDPA| "
            f"{diff})")
        rows.append(row)
        del q, k, v, qt, kt, vt, out
    return {"attention": rows}


def conv2d_stream_main() -> int:
    """``--conv2d-stream``: the header, the build and
    :func:`times_conv2d_stream`, written to
    ``build/chip_smoke/conv2d_stream.json`` and printed as one
    ``{"conv2d_stream": ...}`` line."""
    import torch
    card = header()
    built = build()
    rows = times_conv2d_stream(torch.Generator().manual_seed(7),
                               torch.device("cuda"), mapping=False)
    for r in rows["conv2d_stream"]:
        log(f"time conv2d_stream {r['shape']}: {_ms(r['kernel'])} ms, graph "
            f"{r['kernel']['graph_ms']} ms (plain {_ms(r['plain'])}, "
            f"F.conv2d {_ms(r['library'])}, bound {r['bound_ms']} "
            f"{r['bound_by']})")
    detail = {"card": card, "src": str(SRC), "build_s": built["seconds"],
              "ptxas": built["ptxas"], "times": rows}
    out_path = ROOT / "build" / "chip_smoke" / "conv2d_stream.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(detail, indent=1))
    log(card)
    log(json.dumps({"conv2d_stream": [
        {"shape": r["shape"], "ms": _ms(r["kernel"]),
         "graph_ms": r["kernel"]["graph_ms"]} for r in rows["conv2d_stream"]]}))
    return 0


def main(argv=None) -> int:
    global SRC
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--conv2d-stream", action="store_true",
                    help="only build and time conv2d_stream")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch to run (for "
                         "example a parent commit's, unpacked with git "
                         "archive)")
    args = ap.parse_args(argv)
    SRC = args.src.resolve()
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
    if args.conv2d_stream:
        return conv2d_stream_main()
    from repro_torch.configs import get_config
    from repro_torch.kernels import checks
    from repro_torch.configs.mnist_cnn import CNNConfig
    from repro_torch.configs.separable_cnn import SeparableCNNConfig

    t_all = time.perf_counter()
    card = header()
    built = build()
    built["conv2d_stream"] = conv2d_stream_instances()
    sweeps = kernels_vs_plain()
    sep_cfg, mnist_cfg = SeparableCNNConfig(), CNNConfig()
    paths = [qtorch_path("separable-cnn", sep_cfg, True, act_bits=8),
             qtorch_path("mnist-cnn", mnist_cfg, False, act_bits=8),
             stream_path("separable-cnn", sep_cfg, separable=True),
             stream_path("mnist-cnn", mnist_cfg, separable=False),
             compose_path("mnist-cnn", mnist_cfg, separable=False),
             qtorch_path("separable-cnn", sep_cfg, True, act_bits=16),
             qtorch_path("mnist-cnn", mnist_cfg, False, act_bits=16),
             dse_path("separable-cnn", sep_cfg, True, card),
             dse_path("mnist-cnn", mnist_cfg, False, card),
             im2col_path("separable-cnn", sep_cfg, act_bits=8),
             im2col_path("separable-cnn", sep_cfg, act_bits=16),
             fleet_path("separable-cnn", sep_cfg, card)]
    paths += lm_paths(get_config(LM_ARCH))
    # hymba's f32 check on 4 layers, window 64 and Q_CHUNK 64: the banded
    # prefill and a decode that wraps the ring buffer, at full width
    paths += lm_paths(get_config(HYBRID_ARCH), seq=256, n_layers=4,
                      sliding_window=64, q_chunk=64)
    paths += lm_paths(get_config(DENSE_ARCH))
    rows = times()

    # the JSON row of each kernel and mode: the path run whose launches it
    # reports and the batch-8 call of that run it is timed at
    table = {
        "qgemm": ("qgemm.cu", "qmatmul/kernel.py:68",
                  "qtorch D8-W8 separable-cnn", 1),            # pw0
        "qgemm_f32": ("qgemm.cu", "qmatmul/kernel.py:68",
                      "qtorch D16-W8 separable-cnn", 1),       # pw0
        "qconv_dw": ("qconv_dw.cu", "qconv_dw/kernel.py:51",
                     "qtorch D8-W8 separable-cnn", 0),         # dw0
        "qconv_dw_f32": ("qconv_dw.cu", "qconv_dw/kernel.py:51",
                         "qtorch D16-W8 separable-cnn", 0),    # dw0
        "conv2d_stream": ("conv2d_stream.cu", "conv2d_stream/kernel.py:25",
                          "stream D16-W8 mnist-cnn", 1),       # mnist conv2
        "ssd_scan": ("ssd_scan.cu", "ssd_scan/kernel.py:20",
                     f"prefill bfloat16 (4, 2048) {LM_ARCH}", 0),
    }
    kernels = []
    for name, (src, tpu, path, row) in table.items():
        r = rows[name][row]
        by_path = {f"{p['path']} {p['model']}": p["launches"][name]
                   for p in paths}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": by_path[path],
            "launches_by_path": by_path,
            "max_abs_err": sweeps[name]["max_abs_err"],
            "ms": _ms(r["kernel"]), "plain_ms": _ms(r["plain"]),
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None if r["library"] is None else _ms(r["library"]),
            "shape": r["shape"],
        })
        if "graph_ms" in r["kernel"]:
            kernels[-1].update(
                graph_ms=r["kernel"]["graph_ms"],
                plain_graph_ms=r["plain"]["graph_ms"],
                library_graph_ms=None if r["library"] is None
                else r["library"]["graph_ms"])
    # the classifier FC (the skinny mapping) beside the pw0 row of each mode
    fc = checks.QGEMM_PATH_SHAPES.index((8, 1568, 10))
    for k in kernels[:2]:
        r = rows[k["name"]][fc]
        k.update(fc_ms=_ms(r["kernel"]), fc_plain_ms=_ms(r["plain"]),
                 fc_library_ms=None if r["library"] is None
                 else _ms(r["library"]),
                 fc_bound_ms=r["bound_ms"], fc_bound_by=r["bound_by"],
                 fc_graph_ms=r["kernel"]["graph_ms"],
                 fc_library_graph_ms=None if r["library"] is None
                 else r["library"]["graph_ms"])
    # the im2col depthwise baseline's two qgemm calls beside each mode's row,
    # with the direct qconv_dw call each replaces and the launches a batch
    # the im2col path adds (its runs in ``paths``)
    for k, suffix in zip(kernels[:2], ("", "_f32")):
        run = next(p for p in paths if p["path"] ==
                   f"qtorch D{8 if not suffix else 16}-W8 dw_mode=im2col "
                   "vs direct")
        per_batch = run["qgemm_launches_per_batch"]
        k["im2col_dw"] = [dict(
            shape=r["shape"], ms=_ms(r["kernel"]), plain_ms=_ms(r["plain"]),
            library_ms=None if r["library"] is None else _ms(r["library"]),
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            graph_ms=r["kernel"]["graph_ms"],
            launches_per_batch=per_batch["im2col"] - per_batch["direct"],
            direct_qconv_dw_ms=_ms(d["kernel"]),
            direct_qconv_dw_bound_ms=d["bound_ms"])
            for r, d in zip(rows[f"qgemm{suffix}_im2col"],
                            rows[f"qconv_dw{suffix}"])]
    # every timed stream conv call (batch 8 and 32) beside the conv2 row
    conv = next(k for k in kernels if k["name"] == "conv2d_stream")
    conv["rows"] = [dict(shape=r["shape"], ms=_ms(r["kernel"]),
                         graph_ms=r["kernel"]["graph_ms"],
                         plain_ms=_ms(r["plain"]),
                         library_ms=_ms(r["library"]),
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         tiles=r.get("tiles"))
                    for r in rows["conv2d_stream"]]
    xr = rows["qgemm_xscale"][0]
    kernels[0].update(xscale_max_abs_err=sweeps["qgemm_xscale"]["max_abs_err"],
                      xscale_ms=_ms(xr["kernel"]),
                      xscale_plain_ms=_ms(xr["plain"]),
                      xscale_bound_ms=xr["bound_ms"],
                      xscale_bound_by=xr["bound_by"])
    ssd = rows["ssd_scan"][0]
    prefill = next(p["launches"] for p in paths
                   if f"{p['path']} {p['model']}" == table["ssd_scan"][2])
    hy = rows["ssd_scan"][1]
    hy_prefill = next(p["launches"] for p in paths if p["model"] == HYBRID_ARCH
                      and p["path"] == "prefill bfloat16 (4, 2048)")
    kernels[-1]["hymba"] = dict(
        shape=hy["shape"], path=f"prefill bfloat16 (4, 2048) {HYBRID_ARCH}",
        launches=hy_prefill["ssd_scan"], ms=_ms(hy["kernel"]),
        plain_ms=_ms(hy["plain"]),
        plain_bf16_intra_ms=_ms(hy["plain_bf16_intra"]),
        bound_ms=hy["bound_ms"], bound_by=hy["bound_by"], library_ms=None,
        phases={name: {"ms": _ms(r["kernel"]), "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"],
                       "launches": hy_prefill[f"ssd_scan.{name}"],
                       **built["ssd_phases_hymba"]["bfloat16"][name]}
                for name, r in hy["phases"].items()})
    kernels[-1].update(
        plain_bf16_intra_ms=_ms(ssd["plain_bf16_intra"]),
        vs_f64=sweeps["ssd_scan"]["vs_f64"],
        phases={name: {"ms": _ms(r["kernel"]), "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"],
                       "launches": prefill[f"ssd_scan.{name}"],
                       **built["ssd_phases"]["bfloat16"][name]}
                for name, r in ssd["phases"].items()},
        phases_max_tol_frac=sweeps["ssd_scan"]["phases"]["max_tol_frac"])
    detail = {"card": card, "build_s": built["seconds"],
              "ptxas": built["ptxas"],
              "conv2d_stream_instances": built["conv2d_stream"],
              "sweeps": {k: {key: v[key] for key in
                             ("cases", "max_abs_err", "max_tol_frac",
                              "max_tol_frac_by", "vs_f64", "phases")
                             if key in v}
                         for k, v in sweeps.items()},
              "main_paths": paths, "times": rows,
              "total_s": time.perf_counter() - t_all}
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    for p in paths:
        if "requests_per_s" in p:
            log(f"serve {p['model']} {p['path']}: "
                f"{p['requests_per_s']:.1f} req/s, "
                f"p50 {p['p50_latency_ms']:.3f} ms, "
                f"p95 {p['p95_latency_ms']:.3f} ms")
        if "tokens_per_s" in p:
            log(f"LM {p['model']} {p['path']}: {p['tokens_per_s']:.1f} "
                "tokens/s")
        if "decode_tokens_per_s" in p:
            log(f"LM {p['model']} decode tokens/s per point: "
                + json.dumps(p["decode_tokens_per_s"]))
    for r in rows["attention"]:
        log(f"attention {r['model']} {r['route']}: {_ms(r['kernel'])} ms, "
            f"SDPA {_ms(r['library'])} ms, bound {r['bound_ms']} ms")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
