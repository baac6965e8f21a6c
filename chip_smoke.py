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
   requant quantum); the dequant matmul ``qmatmul`` (``qgemm``'s f32 mode
   on activations rounded to bf16, no epilogue) at the reference's test
   shapes, the ragged 6-row call and the FC, bits {8,4,2}, bf16 and f32 in,
   within ``max|y|*2^-7 + 1e-6``; ``conv2d_stream`` over the stream target's shapes at
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
4. autotune (:func:`autotune_path`) -- with ``REPRO_TORCH_AUTOTUNE_CACHE``
   at a fresh ``build/chip_smoke/autotune.json``: the ``qtorch`` target on
   separable-cnn and mnist-cnn at D8 and D16, run at W8/W4/W2 at every
   serving bucket (1, 2, 4, 8), so every ``qgemm`` and ``qconv_dw`` call
   of the paths runs its timing sweep once (one ``autotune`` line each:
   every candidate's best window, the static rule's, the pick, the
   spread); at every swept call every candidate mapping or tile held
   against the plain version (int8 and the float depthwise conv bit for
   bit, the float ``qgemm`` within its tolerance); then a second process
   on the same file that must resolve every swept call from the disk with
   no sweep, to the same picks.  The paths below serve on these picks, and
   a direct-mode ``qtorch`` serving run that sweeps a shape fails;
5. main paths, each with the launch counters zeroed just before it and read
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
      point), then ``greedy_generate`` of 8 tokens after a 16-token prompt
      (it donates its decode state), its tokens/s and its peak device
      memory above what was held before it printed (in this and every
      later LM phase);
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
      power limit); the front's ``tuned_tilings`` equals the autotune
      cache's entry count;
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
   l. the paper's Table II on mnist-cnn (:func:`table2_path`; f32
      convolutions and matmuls, deterministic cuDNN): 1,024 procedural
      MNIST images (seed 0) trained 6 epochs of batch 64 at lr 0.05 with
      autograd and running BN statistics from the port's own seeded init
      (seconds per step, images/s; test accuracy on 512 images, seed 99,
      above 0.7), then ``DesignFlow.run(("stream",), ...)`` at the six
      ``TABLE2_POINTS``, the reference benchmark's two per-layer points and
      the ``PrecisionMap`` of ``explore_mixed_precision(tol=0.02)``: one row
      each of zero weights, weight and FIFO bytes, accuracy and the best of
      5 timed forwards per image, ``conv2d_stream`` launched on every
      forward, logits within ``max|y|*2^-7 + 1e-6`` of the CPU plain path
      on the card's weights with the same statistics and bytes; claims C1
      (W16/W8/W4 within 0.1 of the float accuracy) and C3 (zero weights
      rising W16 -> W4 -> W2, W2 above 0.3) gated, C2 (D16-W8 against
      D4-W16) printed; then the trained network served at D8 through
      ``qtorch`` and ``serve_adaptive``, the 512 test images as 115
      requests of 1-8 rows walking W8 -> W4 -> W2, every result equal to
      the CPU plain path, ``qgemm`` launched on every batch, accuracy per
      point;
   m-p. the vision-stub, MoE and encoder-decoder families
      (:func:`lm_family_paths`, each as j and k, seeded weights from a CUDA
      generator freed after its phase, every launch counter 0 on every run
      since no kernel of the port is on their path, the phase's peak device
      memory printed beside the card's name and power limit):
      m. phi-3-vision-4.2b at full width (32 layers, 3.83e9 parameters):
         the bf16 prefill of (4, 2048) tokens with (4, 576, 3072) patches,
         finite logits, tokens/s; the logits move when the patches move;
         the f32 check on 4 layers; the server and ``greedy_generate``;
      n. granite-moe-3b-a800m at full width (32 layers, 40 experts top-8,
         3.30e9 parameters): the same prefill, finite positive
         ``lb_loss``/``z_loss``; the f32 check on 4 layers at capacity
         factor 8 (no slot drops, as the reference's test); the server and
         ``greedy_generate``;
      o. mixtral-8x7b at full width on 4 of its 32 layers (the cut and its
         reason printed: 93.4 GB in bf16 over the card's 80 GB): the
         prefill on the banded schedule, the f32 check on 2 layers at
         capacity factor 8, the server and ``greedy_generate``;
      p. whisper-base in full (6 + 6 layers, ``enc_seq`` 1500, 448 decoder
         positions): frames (4, 1500, 512) bf16, a teacher-forced prefill
         of (4, 448) (decoder tokens/s) and the encoder alone (frames/s);
         the f32 check at full width on (2, 64); the server over
         ``EncDecDecodeState`` and ``greedy_generate`` with the frames in
         ``batch_extras``;
   q. LM training on qwen1.5-0.5b at full width (:func:`train_path`; 24
      layers, 464,118,784 parameters, bf16, seeded on the card):
      ``ft.run_training`` for 6 steps of ``make_train_step(remat=True,
      microbatches=2)`` on the port's token stream, global batch 8 x 2048,
      AdamW, a checkpoint every 4 steps into a temporary directory under
      ``build/chip_smoke/ckpt``: seconds per step (steps 2-6), training
      tokens/s, peak device memory and every step's loss beside the card's
      name and power limit (finite, the last below the first); no kernel
      of the port launched; the last checkpoint restored on the CPU equal
      bit for bit to the last step's state.  Then an f32 copy cut to 2
      layers at full width: ``loss_fn`` and its gradients on the card, TF32
      off, against the CPU plain path (the loss within 1e-5 relative, each
      gradient within 1e-4 of its max); and the restart check in a process
      of its own (``--train-restart``, ``CUBLAS_WORKSPACE_CONFIG=:4096:8``,
      ``torch.use_deterministic_algorithms(True)``): failures injected at
      steps 3 and 5 of a 6-step run of that copy, whose last checkpoint
      must equal the uninterrupted run's bit for bit (an op without a
      deterministic CUDA version would be named and the check held within
      1e-4 instead);
   r. mamba2-1.3b at full width on 4 of its 48 layers (the cut printed;
      :func:`ssm_train_path`), bf16, 4 train steps on (4, 2048): the scan
      takes the oracle, every ``ssd_scan`` counter reads 0 over the steps,
      and a direct ``ssd_chunked_kernel`` call on tensors that require
      grad raises; tokens/s (median of steps 2-4) and peak memory beside
      the card;
   s. SPMD on a device mesh (:func:`spmd_path`): a one-rank NCCL group and
      its (1, 1) ``make_local_mesh()`` (a group that does not start fails
      the phase; it is destroyed at the end): mamba2-1.3b's bf16 prefill
      of (4, 2048) through ``make_prefill_step(cfg, mesh=mesh)`` on
      parameters placed by ``param_sharding``, 48 ``ssd_scan`` launches
      through ``local_map`` (each rank's local heads), logits equal to the
      ``mesh=None`` prefill's bit for bit (or within 2^-5 of max|logit|,
      the difference printed), tokens/s of both routes; qwen1.5-0.5b's 3
      train steps of (8, 2048) in 2 microbatches with remat through
      ``jit_train_step`` from the state ``make_train_step(mesh=None)``
      steps from, losses and gradient norms within 2e-2 relative and
      parameters within 5e-2 of each max (the reference's sharded-step
      tolerances; the largest differences printed), seconds per step of
      both and peak memory beside phase q's; qwen1.5-0.5b's 8 decode
      steps of batch 1 with every layer's cache laid out over its 64 slots
      on the data axes (the sequence-sharded decode core, vocab-sharded
      logits), logits and caches against the ``mesh=None`` decode, the
      same steps donated (``donate=True``) on the mesh, bit for bit
      against the undonated ones and writing into the state's own
      storages, seconds per step of all three; qwen1.5-0.5b's prefill and
      2 train steps
      of batch 1, (1, 2048), on data axes of one rank (the batch left
      whole there); mnist-cnn's ``"dist"`` target on the (1,)
      data mesh behind ``AccelServer``, batches 8, 3 and 1 equal to the
      ``"torch"`` target's bit for bit, then requests/s of both targets.
      On the one rank the prefills, the train steps and the decode
      (donated or not) must equal ``mesh=None``'s bit for bit;
   t. the dry-run (:func:`dryrun_path`, after the times below), its jobs
      in a pool of ``min(os.cpu_count(), 16)`` worker processes, each job
      on a fake process group of its own, its worker's default group:
      the counters' known answers (a sharded MLP's 2^38 FLOPs a
      rank on a fake (16, 16) mesh, one all-reduce's ring wire bytes);
      six production cells at full depth through ``launch.dryrun.run_cell``
      (qwen1.5-0.5b x train_4k, mamba2-1.3b x prefill_32k, hymba-1.5b x
      long_500k, hymba-1.5b x train_4k and mixtral-8x7b x train_4k on
      16x16, mixtral-8x7b x decode_32k on 2x16x16), each report's line
      with ``trace_s`` and its
      collective counts by op, its per-rank peak, all-gather and all wire
      bytes beside the card's last accepted figures and the reference's
      dry-run (``DRYRUN_BEFORE``, ``DRYRUN_REFERENCE``), and the sites of
      its largest collectives;
      hymba's train_4k (50 SSD heads, padded to 64; 25 q heads, padded to
      32) must give every model rank 4 SSD heads and 2 q heads, gather no
      x activation in ``models/ssm.py`` and no q activation in
      ``models/attention.py``, and mixtral's train_4k (32 q heads, 8 kv
      heads) 2 q heads and no such q gather; on a one-rank fake mesh,
      phase q's train
      step and the mamba2 bf16 prefill, their roofline ``step_s`` and
      bound beside the seconds this run measured for them and
      ``model_flops / (measured_s * 989e12)``, the measured share of the
      bf16 peak; and the sweep of the reference's ``--all --both-meshes``
      (:func:`dryrun_pairs`: every shape of every arch on 16x16 and
      2x16x16, 68 pairs), each pair cut to ``DRYRUN_SWEEP_LAYERS`` (2)
      layers, whisper's encoder too, through ``launch.dryrun.trace_cell``,
      one line a pair (``trace_s``, peak, all-gather and wire bytes a
      rank beside the reference's, counts by op) and the sweep's wall
      time.  It fails if a job
      fails, a cell or a pair counts no collective, a term is not finite,
      a cell's peak, all-gather or wire bytes a rank rise above its
      ``DRYRUN_BEFORE``, a pair's above its ``DRYRUN_SWEEP_BEFORE`` or its
      peak a rank above the card's memory (the card's torch 2.11 figures;
      on another torch the pairs are not so gated), qwen1.5-0.5b's,
      hymba-1.5b's or mixtral-8x7b's train_4k peak a rank exceeds the
      card's memory, mamba2's prefill_32k, mixtral's decode_32k or qwen's
      train_4k all-gathers more than the reference a rank, mixtral's decode wire
      bytes a rank exceed 250 MB, hymba's or mixtral's train_4k fails a
      head or gather gate, a pair (on any torch) all-gathers more than the
      reference's pair a rank (``DRYRUN_SWEEP_REFERENCE``; but whisper's
      prefill_32k on 2x16x16, whose query positions are traded over a
      head's ranks, and its decode_32k, ``DRYRUN_SWEEP_GATHER_EXEMPT``) or
      moves more wire bytes, a pair peaks a rank above the reference's
      argument + temp bytes (``DRYRUN_SWEEP_PEAK_HELD``: all 68, the
      decode cells donating their state as the reference's do), or an
      attention core of whisper's train_4k on 16x16 or its prefill_32k on
      2x16x16 scores another count of heads or rows than one head of half
      of the rank's rows, or of its one row (``DRYRUN_SWEEP_HEAD_ROWS``);
      before the sweep, for mamba2's prefill_32k at full depth and at 2
      layers on both meshes (``DRYRUN_PEAK_ENTRIES``), one line each on
      what the memory tracker holds where its total peaks
      (``dryrun.PeakProbe``: the op and frames, the largest storages, the
      peak without the tracked arguments and without resize tracking).
      The sweep alone
      rehearses on a host without a card
      (the dry-run needs none): ``chip_smoke.dryrun_sweep("cpu")``;
6. times — each kernel and mode, its plain version and the nearest PyTorch
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
   and qwen's (chunked) call and whisper's non-causal encoder call (4,
   1500) beside ``F.scaled_dot_product_attention`` on the same q, k and v,
   a yardstick the port never calls; one layer's ``moe_block`` at granite's
   (4, 2048) call beside the bound of the slots its routing keeps;
   ``qgemm``'s per-row x-scale mode at pw0; ``qmatmul`` at mnist-cnn's FC
   (8 x 1568 x 10) and conv1 as im2col (1568 x 144 x 32) beside
   ``torch.matmul`` on the bf16-rounded x and the dequantized weights; the im2col
   baseline's two ``qgemm`` calls (dw0 1568 x 72 x 8, dw1 392 x 144 x 16)
   in both modes, beside ``torch._int_mm`` / ``torch.matmul`` on the same
   patches, reported with the direct ``qconv_dw`` calls in the kernels line.
   Each ``qgemm`` and ``qconv_dw`` call at batch 8 is timed with its tuned
   pick (the row's ``ms``) and with the static rule's mapping
   (``static_ms``), both in the kernels line (``tuned_rows``).

It prints one ``{"kernels": [...]}`` JSON line (``ssd_scan``'s row also
gives phase s's launches on the mesh under ``mesh``), and as its last line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository's
``src/`` beside it, it exits non-zero and prints no result.  Details go to
``build/chip_smoke/chip_smoke.json``.

    python3 chip_smoke.py --conv2d-stream [--src DIR]

runs only the header, the build and ``conv2d_stream``'s times
(:func:`times_conv2d_stream`, without the mapping, which a parent's package
may not have) on the ``repro_torch`` under ``--src``: a parent commit's,
unpacked with ``git archive``, is timed so beside the change in one call.
Its details go to ``build/chip_smoke/conv2d_stream.json``.

    python3 chip_smoke.py --train-restart

runs only phase q's restart check and prints its ``train_restart:`` line
(phase q starts it so, in a process of its own).
"""
from __future__ import annotations

import json
import os
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
              ("qmatmul", checks.qmatmul_sweep, {}, False),
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

# the serving buckets of the CNN paths (max_batch 8: the pow2 ladder)
AUTOTUNE_BUCKETS = (1, 2, 4, 8)
# set once the autotune phase has tuned every bucket shape of the qtorch
# paths: a direct-mode qtorch serving run may then sweep no shape
AUTOTUNED = False


def _sweeps() -> int:
    """Timing sweeps run so far by both kernels' timed picks."""
    from repro_torch.kernels.qconv_dw.ops import pick_blocks_dw
    from repro_torch.kernels.qmatmul.ops import pick_blocks
    return pick_blocks.sweeps + pick_blocks_dw.sweeps


def _report_line(r: dict) -> str:
    """One sweep report as a log line: each candidate's best window, the
    static pick's, the pick and the spread (ms)."""
    best = {tuple(c["tiles"]): c["best_ms"] for c in r["candidates"]}
    shape = r["shape"] + ([f"s{r['strides'][0]}"] if "strides" in r else [])
    cands = ", ".join(f"{list(t)} {v:.6f}" for t, v in best.items())
    return (f"{r['kernel']} {shape} W{r['bits']}"
            f"{' packed' if r['packed'] else ''}: static {r['static']} "
            f"{best.get(tuple(r['static']), float('nan')):.6f} ms, pick "
            f"{r['pick']} {best.get(tuple(r['pick']), float('nan')):.6f} ms, "
            f"spread {r['spread_ms']:.6f} ms; candidates {cands}")


_RELOAD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels.qconv_dw.ops import pick_blocks_dw
from repro_torch.kernels.qmatmul.ops import encode_tiles, pick_blocks
picks = []
for r in json.loads(sys.stdin.read()):
    if r["kernel"].startswith("qgemm"):
        t = pick_blocks(*r["shape"], r["bits"], int8_act=r["kernel"] == "qgemm",
                        packed=r["packed"], timed=True)
        picks.append(list(encode_tiles(t)))
    else:
        t = pick_blocks_dw(*r["shape"], kh=r["window"][0], kw=r["window"][1],
                           strides=r["strides"], pads=r["pads"],
                           bits=r["bits"], int8_act=r["kernel"] == "qconv_dw",
                           packed=r["packed"], timed=True)
        picks.append(list(t))
print(json.dumps({"sweeps": pick_blocks.sweeps + pick_blocks_dw.sweeps,
                  "picks": picks}))
"""


def hold_candidates(reports: list, device: str) -> dict:
    """Phase (b) of :func:`autotune_path`: at every swept call of
    ``reports`` every candidate against the plain version; raises on a
    disagreement."""
    from repro_torch.kernels import checks
    held = {"cases": 0, "max_abs_err": 0.0, "max_tol_frac": 0.0}
    for r in reports:
        int8_act = r["kernel"] in ("qgemm", "qconv_dw")
        if r["kernel"].startswith("qgemm"):
            M, K, N = r["shape"]
            res = checks.qgemm_candidates_check(
                device, M, K, N, bits=r["bits"], packed=r["packed"],
                int8_act=int8_act)
        else:
            res = checks.qconv_dw_candidates_check(
                device, *r["shape"], kh=r["window"][0], kw=r["window"][1],
                strides=r["strides"], pads=r["pads"], bits=r["bits"],
                packed=r["packed"], int8_act=int8_act)
        if res["failures"]:
            raise AssertionError(f"autotune candidates of {r['kernel']} "
                                 f"{r['shape']} W{r['bits']} disagree with "
                                 f"the plain version: {res['failures']}")
        held["cases"] += res["cases"]
        held["max_abs_err"] = max(held["max_abs_err"], res["max_abs_err"])
        held["max_tol_frac"] = max(held["max_tol_frac"], res["max_tol_frac"])
    return held


def reload_picks(reports: list) -> dict:
    """Phase (c) of :func:`autotune_path`: a second process on the same
    cache file resolves every swept call of ``reports``; raises unless it
    ran no sweep and picked what the reports picked."""
    proc = subprocess.run(
        [sys.executable, "-c", _RELOAD, str(SRC)],
        input=json.dumps(reports), capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"autotune reload process failed: "
                             f"{proc.stderr[-2000:]}")
    reload = json.loads(proc.stdout.strip().splitlines()[-1])
    if reload["sweeps"] != 0 or \
            reload["picks"] != [list(r["pick"]) for r in reports]:
        raise AssertionError(f"a second process swept {reload['sweeps']} "
                             f"shapes or picked otherwise: {reload}")
    return reload


def autotune_path(device: str = "cuda") -> dict:
    """The timed tile picks, before the paths: (a) ``qtorch`` on
    separable-cnn and mnist-cnn at D8 and D16 built on ``device`` and run
    at W8/W4/W2 at every serving bucket, so each ``qgemm`` and ``qconv_dw``
    call of the paths sweeps its candidates once (each report logged: every
    candidate's best window, the static pick's, the pick, the spread);
    (b) at every swept call every candidate held against the plain version
    (int8 bit for bit, the float ``qgemm`` within its tolerance, the float
    ``qconv_dw`` bit for bit); (c) a second process on the same cache file
    resolves every swept call from the disk with no sweep, to the same
    picks.  On the CPU nothing is timed (the static rules) and (b) runs the
    plain versions."""
    global AUTOTUNED
    import numpy as np
    import torch
    from repro_torch.core.flow import DesignFlow
    from repro_torch.core.reader import cnn_to_ir, separable_cnn_to_ir
    from repro_torch.configs.mnist_cnn import CNNConfig
    from repro_torch.configs.separable_cnn import SeparableCNNConfig
    from repro_torch.kernels import autotune
    from repro_torch.kernels.qconv_dw import ops as dwops
    from repro_torch.kernels.qmatmul import ops as qops
    from repro_torch.quant.qtypes import DatatypeConfig

    t0 = time.perf_counter()
    qops.sweep_reports.clear()
    dwops.sweep_reports.clear()
    sweeps0 = _sweeps()
    for name, cfg, separable in (("separable-cnn", SeparableCNNConfig(), True),
                                 ("mnist-cnn", CNNConfig(), False)):
        to_ir = separable_cnn_to_ir if separable else cnn_to_ir
        params = _params(cfg, separable, device)
        calib = _workload(cfg, 0, SEED + 1)[0]
        x = calib[:max(AUTOTUNE_BUCKETS)].numpy()
        for act_bits in (8, 16):
            res = DesignFlow(to_ir(cfg, params), device=device).run(
                ("qtorch",), DatatypeConfig(act_bits, 8),
                calib_inputs=(calib.to(device),))
            for bits in (8, 4, 2):
                exe = res.writers["qtorch"].build(bits=bits)
                for b in AUTOTUNE_BUCKETS:
                    y = np.asarray(exe(x[:b]).cpu())
                    if not np.isfinite(y).all():
                        raise AssertionError(f"{name} D{act_bits} W{bits} "
                                             f"batch {b}: non-finite")
    if device == "cuda":
        torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    reports = list(qops.sweep_reports) + list(dwops.sweep_reports)
    if len(reports) != _sweeps() - sweeps0:
        raise AssertionError(f"{len(reports)} reports for "
                             f"{_sweeps() - sweeps0} sweeps")
    for r in reports:
        log("autotune " + _report_line(r))

    t1 = time.perf_counter()
    held = hold_candidates(reports, device)
    if device == "cuda":
        torch.cuda.synchronize()
    held_s = time.perf_counter() - t1
    log(f"autotune candidates vs plain ({held_s:.1f} s): "
        f"{held['cases']} cases, max |diff| {held['max_abs_err']}, "
        f"worst fraction of the float qgemm tolerance "
        f"{held['max_tol_frac']}")
    t2 = time.perf_counter()
    reload = reload_picks(reports)
    entries = autotune.tuned_entries()
    if device == "cuda" and len(entries) != len(reports):
        raise AssertionError(f"{len(entries)} cache entries for "
                             f"{len(reports)} sweeps")
    changed = sum(r["pick"] != r["static"] for r in reports)
    info = {"path": "autotune", "sweeps": len(reports),
            "picks_changed": changed, "cache_entries": len(entries),
            "cache_file": autotune.autotune_cache_path(),
            "tune_s": tune_s, "candidates_vs_plain": held,
            "candidates_s": held_s,
            "reload_sweeps": reload["sweeps"],
            "reload_s": time.perf_counter() - t2, "reports": reports}
    log(f"autotune: {len(reports)} sweeps in {tune_s:.1f} s, {changed} "
        f"picks other than the static rule, {len(entries)} cache entries; "
        f"a second process resolved all {len(reports)} from the disk with "
        f"{reload['sweeps']} sweeps in {info['reload_s']:.1f} s")
    AUTOTUNED = device == "cuda"
    return info


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
    from repro_torch.kernels.qmatmul.ops import qgemm, qgemm_f32, qmatmul
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    return {"qgemm": qgemm, "qgemm_f32": qgemm_f32, "qmatmul": qmatmul,
            "qconv_dw": qconv_dw,
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
                  device: str, dw_mode: str, act_ranges, workload=None):
    """:func:`qtorch_path`'s run: (info, served outputs in request order,
    the card's act_ranges).  ``dw_mode`` lowers the depthwise convs direct
    or through the im2col baseline; ``act_ranges`` (default: calibrate on
    the card) lets two runs share one calibration; ``workload`` (default:
    seeded random weights and images) is (params on ``device``, the
    calibration batch, the requests)."""
    import numpy as np
    from repro_torch.core.adaptive import RuntimePolicy
    from repro_torch.core.flow import DEFAULT_POINTS, DesignFlow, WriterOptions
    from repro_torch.core.reader import cnn_to_ir, separable_cnn_to_ir
    from repro_torch.quant.qtypes import DatatypeConfig

    to_ir = separable_cnn_to_ir if separable else cnn_to_ir
    dt = DatatypeConfig(act_bits, 8)
    exact = act_bits <= 8
    opts = WriterOptions(dw_mode=dw_mode)
    if workload is None:
        workload = (_params(cfg, separable, device),
                    *_workload(cfg, 66, SEED + 1))
    params, calib, reqs = workload
    budgets = [(1.0, 0.5, 0.1)[min(i * 3 // len(reqs), 2)]
               for i in range(len(reqs))]              # -> w8, w4, w2

    _zero_counts()
    sweeps0 = _sweeps()
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
    sweeps = _sweeps() - sweeps0
    stats = srv.stats()
    wall = time.perf_counter() - t0
    if AUTOTUNED and dw_mode == "direct" and sweeps:
        raise AssertionError(f"{name} D{act_bits}: {sweeps} timing sweeps "
                             "while serving shapes the autotune phase tuned")

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
        "launches": launches, "sweeps": sweeps, "bits_views": views,
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
    from repro_torch.kernels.autotune import tuned_entries

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
    entries = len(tuned_entries())
    if front.tuned_tilings != entries:
        raise AssertionError(f"{name}: the front counts "
                             f"{front.tuned_tilings} tuned tilings, the "
                             f"cache holds {entries}")

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
            "tuned_tilings": front.tuned_tilings,
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


# -- Table II: the paper's own table, trained on the card -------------------

TABLE2_TRAIN = (1024, 0)      # training images, seed
TABLE2_TEST = (512, 99)       # test images, seed
TABLE2_EPOCHS, TABLE2_BATCH, TABLE2_LR = 6, 64, 0.05
# the BN running statistics get no gradient; each step moves them toward
# the batch statistics
BN_STATS = ("/mean", "/var")


def table2_hetero_points():
    """The two hand-picked per-layer points of the reference's Table II
    (node names from ``cnn_to_ir``): a W8 backbone with conv1 at W4, and a
    W4 default with conv0 at W8 and the classifier at W2."""
    from repro_torch.quant.qtypes import DatatypeConfig, PrecisionMap
    return (PrecisionMap(DatatypeConfig(16, 8),
                         {"conv1": DatatypeConfig(16, 4)}),
            PrecisionMap(DatatypeConfig(16, 4),
                         {"conv0": DatatypeConfig(16, 8),
                          "fc": DatatypeConfig(16, 2)}))


def train_step(params, x, y, cfg, lr: float = TABLE2_LR):
    """One SGD step with autograd, as the reference trains the CNN: the
    weights move down the gradient of ``cnn.loss_fn`` (batch statistics),
    the BN running statistics (no gradient) to ``0.9*old + 0.1*batch``."""
    import torch
    from repro_torch.models import cnn
    leaves = {k: v.detach().requires_grad_(not k.endswith(BN_STATS))
              for k, v in params.items()}
    loss, aux = cnn.loss_fn(leaves, x, y, cfg)
    names = [k for k, v in leaves.items() if v.requires_grad]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                [leaves[k] for k in names])))
    with torch.no_grad():
        new = {k: v - lr * grads[k] if k in grads else v
               for k, v in params.items()}
        for k, v in aux.items():
            new[k] = 0.9 * new[k] + 0.1 * v.detach()
    return new, loss.detach()


def _train_table2(cfg, device: str):
    """mnist-cnn from the port's own init (seeded), trained on procedural
    MNIST as the reference's Table II benchmark trains it; (params, test
    images and labels on ``device``, the float accuracy, training info)."""
    import torch
    from repro_torch.data.mnist import make_dataset
    from repro_torch.models import cnn
    imgs, labels = make_dataset(TABLE2_TRAIN[0], seed=TABLE2_TRAIN[1])
    test_x, test_y = make_dataset(TABLE2_TEST[0], seed=TABLE2_TEST[1])
    x, y = torch.from_numpy(imgs).to(device), torch.from_numpy(labels).to(
        device)
    params = cnn.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device=device)
    n, bs = len(labels), TABLE2_BATCH
    epoch_s, losses = [], []
    for _ in range(TABLE2_EPOCHS):
        _sync(device)
        t0 = time.perf_counter()
        for i in range(0, n - bs + 1, bs):
            params, loss = train_step(params, x[i:i + bs], y[i:i + bs], cfg)
        _sync(device)
        epoch_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    tx = torch.from_numpy(test_x).to(device)
    acc = float(cnn.accuracy(params, tx, test_y, cfg))
    steps = n // bs
    # steady state: every epoch after the first (which warms up cuDNN)
    steady = sum(epoch_s[1:])
    info = {"train_images": n, "epochs": TABLE2_EPOCHS, "batch": bs,
            "lr": TABLE2_LR, "steps": steps * TABLE2_EPOCHS,
            "epoch_s": epoch_s, "last_loss_per_epoch": losses,
            "s_per_step": steady / (steps * (TABLE2_EPOCHS - 1)),
            "images_per_s": n * (TABLE2_EPOCHS - 1) / steady,
            "test_images": len(test_y), "float_accuracy": acc}
    return params, tx, test_y, acc, info


def _best_us_per_image(exe, tx, device: str, calls: int = 5):
    """Best of ``calls`` forwards on ``tx``, timed between CUDA events after
    a synchronise, per image; None off the card (no device time there)."""
    import torch
    if device != "cuda":
        return None
    exe(tx)
    best = float("inf")
    for _ in range(calls):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        exe(tx)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return 1e3 * best / tx.shape[0]


def table2_weight_bytes(graph, dt) -> int:
    """Packed weight storage of the compiled graph under per-layer bits (the
    reference benchmark's column: a 2-D or larger initializer at its
    consumer's weight bits, the rest at 32)."""
    from repro_torch.quant.ptq import effective_weight_dt
    from repro_torch.quant.qtypes import PrecisionMap
    default = dt.default if isinstance(dt, PrecisionMap) else dt
    n = 0
    for name, v in graph.initializers.items():
        node_dt = effective_weight_dt(graph, name, default)
        bits = node_dt.weight_bits if v.ndim >= 2 else 32
        n += v.size * bits // 8
    return n


def _table2_row(flow, cpu_flow, dt, label, tx, test_y, device):
    """One Table II row: ``run(("stream",), dt)`` on the card, its accuracy
    on the test set, zero weights, weight and FIFO bytes and time per image,
    held against the CPU plain path on the same weights and ranges."""
    import numpy as np
    _zero_counts()
    res = flow.run(("stream",), dtconfig=dt, calib_inputs=(tx[:64],))
    exe = res.batched["stream"]
    logits = exe(tx)
    us = _best_us_per_image(exe, tx, device)
    forwards = 1 + (6 if us is not None else 0)
    launches = _read_counts()
    cpu = cpu_flow.run(("stream",), dtconfig=dt, act_ranges=res.act_ranges)
    want = cpu.batched["stream"](tx.cpu()).numpy()
    got = logits.cpu().numpy()
    err = _check(f"Table II {label}", got, want, exact=False)
    stats = res.stats.get("zero_weight_frac", 0.0)
    wb = table2_weight_bytes(res.graph, dt)
    fifo = res.writers["stream"].topology()["total_fifo_bytes"]
    if (stats, wb, fifo) != (cpu.stats.get("zero_weight_frac", 0.0),
                             table2_weight_bytes(cpu.graph, dt),
                             cpu.writers["stream"].topology()[
                                 "total_fifo_bytes"]):
        raise AssertionError(f"Table II {label}: statistics or bytes differ "
                             "from the CPU plain path")
    per_fwd = launches["conv2d_stream"] / forwards
    if device == "cuda" and per_fwd < 1:
        raise AssertionError(f"Table II {label}: conv2d_stream launched "
                             f"{launches['conv2d_stream']} times in "
                             f"{forwards} forwards")
    acc = float((got.argmax(-1) == test_y).mean())
    return {"datatype": label, "zero_weights_pct": 100 * stats,
            "weight_bytes": wb, "fifo_bytes": fifo,
            "accuracy_pct": 100 * acc,
            "cpu_accuracy_pct": 100 * float((want.argmax(-1) ==
                                             test_y).mean()),
            "us_per_image": us, "conv2d_stream_per_forward": per_fwd,
            "launches": launches, "vs_cpu_plain": f"max |diff| {err}",
            "zero_weight_frac": stats}


def table2_path(cfg, card: str = "", device: str = "cuda") -> dict:
    """The paper's Table II on ``device``: train mnist-cnn (autograd SGD,
    running BN statistics; f32 convolutions and matmuls, deterministic
    cuDNN), then ``DesignFlow.run(("stream",), ...)`` at each of the six
    ``TABLE2_POINTS``, the two hand-picked per-layer points and the
    explorer's ``PrecisionMap`` (``tol=0.02``), every row held against the
    CPU plain path; claims C1 and C3 gated, C2 printed; then the trained
    network served at D8 through ``qtorch`` and ``serve_adaptive`` over the
    test set, W8 -> W4 -> W2, bit for bit against the CPU plain path.  The
    f32 and determinism flags it sets are restored after it."""
    import torch
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        return _table2(cfg, card, device)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _table2(cfg, card: str, device: str) -> dict:
    """:func:`table2_path`'s run, with the f32 and determinism flags set."""
    import numpy as np
    from repro_torch.core.flow import DesignFlow
    from repro_torch.core.reader import cnn_to_ir
    from repro_torch.quant.qtypes import TABLE2_POINTS, DatatypeConfig
    t_phase = time.perf_counter()
    params, tx, test_y, acc_f, train = _train_table2(cfg, device)
    log(f"Table II training mnist-cnn on {device} ({card}): "
        + json.dumps(train))
    if not acc_f > 0.7:
        raise AssertionError(f"Table II: trained accuracy {acc_f} <= 0.7")
    host = {k: v.cpu() for k, v in params.items()}
    flow = DesignFlow(cnn_to_ir(cfg, params), device=device)
    cpu_flow = DesignFlow(cnn_to_ir(cfg, host), device="cpu")
    auto_pm, history = flow.explore_mixed_precision((tx[:64],), tol=0.02)
    points = [(dt, dt.name) for dt in TABLE2_POINTS]
    points += [(pm, pm.name) for pm in table2_hetero_points()]
    per = ",".join(f"{k}:{v.weight_bits}"
                   for k, v in sorted(auto_pm.per_node.items()))
    points.append((auto_pm, f"D{auto_pm.default.act_bits}-Wauto[{per}]"))
    rows = []
    for dt, label in points:
        rows.append(_table2_row(flow, cpu_flow, dt, label, tx, test_y,
                                device))
        r = rows[-1]
        log(f"table2 {label}: zero_weights_pct={r['zero_weights_pct']} "
            f"weight_bytes={r['weight_bytes']} fifo_bytes={r['fifo_bytes']} "
            f"accuracy_pct={r['accuracy_pct']} "
            f"us_per_image={r['us_per_image']} ({card}); conv2d_stream "
            f"{r['conv2d_stream_per_forward']} launches a forward, "
            f"{r['vs_cpu_plain']} from the CPU plain path")
    by = {r["datatype"]: r for r in rows}
    # C2 reads D4-W16, which is no Table II row
    c2 = _table2_row(flow, cpu_flow, DatatypeConfig(4, 16), "D4-W16", tx,
                     test_y, device)
    acc = {k: by[k]["accuracy_pct"] / 100 for k in by}
    zw = {k: by[k]["zero_weight_frac"] for k in by}
    claims = {
        "c1": {k: acc[k] for k in ("D16-W16", "D16-W8", "D16-W4")},
        "c1_float": acc_f,
        "c2": {"D16-W8": acc["D16-W8"], "D4-W16": c2["accuracy_pct"] / 100,
               "gap": acc["D16-W8"] - c2["accuracy_pct"] / 100,
               "holds": acc["D16-W8"] - c2["accuracy_pct"] / 100 > 0.05},
        "c3": {k: zw[k] for k in ("D16-W16", "D16-W4", "D16-W2")},
    }
    log("Table II claims: " + json.dumps(claims))
    for k, a in claims["c1"].items():
        if not a > acc_f - 0.1:
            raise AssertionError(f"C1: {k} accuracy {a} vs float {acc_f}")
    if not (zw["D16-W2"] > zw["D16-W4"] > zw["D16-W16"]
            and zw["D16-W2"] > 0.3):
        raise AssertionError(f"C3: zero-weight fractions {claims['c3']}")

    # serve the trained network: requests of 1-8 rows over the test set
    sizes, off = [], 0
    while off < len(test_y):
        sizes.append(min(1 + (len(sizes) * 5) % 8, len(test_y) - off))
        off += sizes[-1]
    bounds = np.cumsum([0] + sizes)
    host_x = tx.cpu().numpy()
    reqs = [host_x[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    served, outs, _ = _qtorch_serve(
        "mnist-cnn trained", cfg, False, 8, device, "direct", None,
        workload=(params, tx[:64].cpu(), reqs))
    per_batch = served["launches"]["qgemm"] / max(served["batches"], 1)
    if device == "cuda" and per_batch < 1:
        raise AssertionError(f"Table II serving: qgemm launched "
                             f"{served['launches']['qgemm']} times for "
                             f"{served['batches']} batches")
    point_acc = {}
    for j, bits in enumerate((8, 4, 2)):
        idx = [i for i in range(len(reqs))
               if min(i * 3 // len(reqs), 2) == j]
        pred = np.concatenate([outs[i].argmax(-1) for i in idx])
        gold = np.concatenate([test_y[bounds[i]:bounds[i + 1]] for i in idx])
        point_acc[f"w{bits}"] = float((pred == gold).mean())
    served.update(qgemm_per_batch=per_batch, accuracy_per_point=point_acc)
    log(f"Table II serving the trained mnist-cnn at D8 ({card}): "
        f"{len(reqs)} requests, {served['batches']} batches, qgemm "
        f"{per_batch} launches a batch, accuracy per point "
        f"{json.dumps(point_acc)}, results equal to the CPU plain path")
    return {"path": "Table II", "model": "mnist-cnn", "card": card,
            "training": train, "rows": rows, "d4_w16": c2, "claims": claims,
            "explorer_moves": len(history), "serving": served,
            # every run of the phase: the rows, D4-W16 and the serving
            "launches": {k: sum(r["launches"][k]
                                for r in rows + [c2, served])
                         for k in served["launches"]},
            "phase_s": time.perf_counter() - t_phase}


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


# -- LM paths: mamba2-1.3b, hymba-1.5b, qwen1.5-0.5b, phi-3-vision-4.2b,
# granite-moe-3b-a800m, mixtral-8x7b, whisper-base ---------------------------

LM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "hymba-1.5b"
DENSE_ARCH = "qwen1.5-0.5b"
VLM_ARCH = "phi-3-vision-4.2b"
MOE_ARCH = "granite-moe-3b-a800m"
MIXTRAL_ARCH = "mixtral-8x7b"
AUDIO_ARCH = "whisper-base"
# mixtral's 32 layers hold 46.7e9 parameters, 93.4 GB in bf16, over the
# card's 80 GB, and AdaptiveLMServer.decode dequantizes the whole tree at
# every step: the phase runs it at full width on 4 layers
MIXTRAL_LAYERS = 4
WHISPER_MAX_SEQ = 448            # whisper's decoder positions
LM_POINTS = (("w8", 8), ("w4", 4), ("w2", 2))


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def lm_params(cfg, device: str = "cuda", max_seq: int = 0) -> dict:
    """Seeded random weights of ``cfg``, drawn on ``device`` by a generator
    seeded from SEED (the reference's distributions); ``max_seq`` sizes the
    encoder-decoder's decoder positions."""
    import torch
    from repro_torch.models.params import init_params
    g = torch.Generator(device=device).manual_seed(SEED)
    return init_params(cfg, g, max_seq=max_seq, device=device)


def _lm_extras(cfg, batch: int, seed: int, device: str,
               patches: bool = True) -> dict:
    """The family's inputs beside the tokens, in the model's dtype, from a
    generator on ``device`` seeded with ``seed``: whisper's frames (batch,
    enc_seq, d), the vision stub's patches (batch, n_patches, d) unless
    ``patches`` is off."""
    import torch
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    if cfg.family == "audio":
        out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                    generator=g, device=device, dtype=dt)
    if cfg.n_patches and patches:
        out["patches"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                     generator=g, device=device, dtype=dt)
    return out


def _expect_no_stray_launches(name: str, launches: dict, cfg) -> None:
    """An LM path runs no kernel of the port but ``ssd_scan`` (and that only
    with an SSM block): every other counter must read 0, so no stray path
    hides; for the MoE, encoder-decoder and vision families every counter."""
    fired = {k: n for k, n in launches.items()
             if n and not (cfg.ssm is not None and k.startswith("ssd_scan"))}
    if fired:
        raise AssertionError(f"{name}: launched {fired}, expected none")


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
    """The prefill on (batch, seq) tokens, with whisper's frames or the
    vision stub's patches: one ``model_api.forward_logits`` with the
    counters zeroed just before it and read just after (one ``ssd_scan``
    launch per layer with an SSM block, none for a dense model), finite
    logits of the padded vocab and, for MoE, finite positive aux losses;
    then ``reps`` timed ``make_prefill_step(cfg)`` calls for tokens/s.  With
    patches, moving them must move the logits; for whisper the encoder is
    also timed alone (frames/s)."""
    import math
    import statistics
    import torch
    from repro_torch.models import encdec
    from repro_torch.models.attention import prefill_route
    from repro_torch.runtime import model_api
    from repro_torch.runtime.serve import make_prefill_step
    toks = _tokens(cfg, (batch, seq), SEED + 5, device)
    feed = {"tokens": toks, **_lm_extras(cfg, batch, SEED + 10, device)}
    prefill = make_prefill_step(cfg)
    _zero_counts()
    t0 = time.perf_counter()
    logits, aux = model_api.forward_logits(params, feed, cfg)
    _sync(device)
    first_s = time.perf_counter() - t0
    launches = _read_counts()
    name = f"{cfg.name} prefill"
    if tuple(logits.shape) != (batch, seq, cfg.vocab_padded):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: non-finite logits")
    aux = {k: float(v) for k, v in aux.items()}
    if cfg.moe is not None and not all(math.isfinite(v) and v > 0
                                       for v in aux.values()):
        raise AssertionError(f"{name}: MoE aux losses {aux}")
    _expect_ssd_launches(name, launches, cfg, device)

    def timed(fn) -> list:
        secs = []
        for _ in range(reps):
            t1 = time.perf_counter()
            fn()
            _sync(device)
            secs.append(time.perf_counter() - t1)
        return secs

    secs = timed(lambda: prefill(params, feed))
    med = statistics.median(secs)
    info = {"path": f"prefill {cfg.dtype} ({batch}, {seq})",
            "model": cfg.name, "launches": launches,
            "attention": None if cfg.attention_free
            else prefill_route(cfg, seq), "first_s": first_s,
            "prefill_s": secs, "tokens_per_s": batch * seq / med,
            "logits_max_abs": float(logits.float().abs().max()), "aux": aux}
    if "patches" in feed:
        moved = prefill(params, dict(feed, patches=feed["patches"] + 1.0))
        diff = float((moved - logits).abs().max())
        if not diff > 1e-3:
            raise AssertionError(f"{name}: moving the patches moved the "
                                 f"logits by {diff}")
        info["patches_moved_logits_max_abs"] = diff
        del moved
    if "frames" in feed:
        enc = timed(lambda: encdec.encode(params, feed["frames"], cfg))
        info["encoder_s"] = enc
        info["encoder_frames_per_s"] = batch * cfg.enc_seq / \
            statistics.median(enc)
    log(f"main path {cfg.name} prefill: " + json.dumps(info))
    return info


def lm_f32_decode_check(cfg, batch: int = 2, seq: int = 100,
                        device: str = "cuda", n_layers=None,
                        sliding_window=None, q_chunk=None,
                        capacity_factor=None) -> dict:
    """In an f32 copy of ``cfg``: ``forward`` (through the scan kernel where
    the model has an SSM block; whisper with f32 frames; the vision stub
    without patches, which decode never sees) against ``decode_step`` fed
    token by token, every logit within the reference's
    ``5e-3*max|logit|`` (tests/test_serve.py).  ``n_layers``,
    ``sliding_window`` and ``q_chunk`` (attention's ``Q_CHUNK`` for the
    run) cut the config so a short run reaches the banded prefill and wraps
    the decode ring buffer, which a ``sliding_window`` cut must then do;
    ``capacity_factor`` lifts MoE capacity so no slot drops at T = batch or
    T = batch*seq, as the reference's test does; each change is named in
    the output."""
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
    if capacity_factor is not None:
        cuts["moe"] = dataclasses.replace(cfg.moe,
                                          capacity_factor=capacity_factor)
        reduced["moe.capacity_factor"] = \
            f"{cfg.moe.capacity_factor} -> {capacity_factor}"
    cfg32 = dataclasses.replace(cfg, dtype="float32", **cuts)
    q_chunk_was = attention.Q_CHUNK
    if q_chunk is not None:
        reduced["attention.Q_CHUNK"] = f"{q_chunk_was} -> {q_chunk}"
        attention.Q_CHUNK = q_chunk
    try:
        params = lm_params(cfg32, device, max_seq=seq)
        toks = _tokens(cfg32, (batch, seq), SEED + 6, device)
        feed = {"tokens": toks, **_lm_extras(cfg32, batch, SEED + 11, device,
                                             patches=False)}
        route = None if cfg32.attention_free else \
            attention.prefill_route(cfg32, seq)
        _zero_counts()
        t0 = time.perf_counter()
        fwd, _ = model_api.forward_logits(params, feed, cfg32)
        _sync(device)
        fwd_s = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        attention.Q_CHUNK = q_chunk_was
    name = f"{cfg.name} f32 forward"
    _expect_ssd_launches(name, launches, cfg32, device)
    st = model_api.init_decode_state(params, feed, cfg32, batch, seq,
                                     dtype=torch.float32)
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
    after a ``prompt_len``-token prompt.  Whisper's state comes from its
    encoder run on the frames, which ``greedy_generate`` takes in
    ``batch_extras`` (the vision stub's patches too, which decode never
    reads).  The decode path launches no kernel of the port (the scan
    kernel runs in the prefill)."""
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
    extras = _lm_extras(cfg, batch, SEED + 12, device)
    state = model_api.init_decode_state(params, {"tokens": tok, **extras},
                                        cfg, batch, steps + 1)
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
    del state
    gen_peak = phase_peak = None
    if device == "cuda":
        # greedy_generate's own peak, above what is held before it; the
        # phase's peak so far kept for lm_paths
        phase_peak = torch.cuda.max_memory_allocated()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, max_new=new,
                          seq_len=prompt_len + new, batch_extras=extras)
    _sync(device)
    gen_s = time.perf_counter() - t1
    if device == "cuda":
        gen_peak = torch.cuda.max_memory_allocated() - held
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
            "greedy_tokens_per_s": batch * (prompt_len + new) / gen_s,
            "greedy_peak_memory_bytes": gen_peak,
            "phase_peak_before_greedy_bytes": phase_peak}
    log(f"main path {name}: " + json.dumps(info))
    return info


def lm_paths(cfg, card: str = "", seq: int = 2048, max_seq: int = 0,
             device: str = "cuda", check=None) -> list:
    """One LM at full width on the card: :func:`lm_prefill_path` on (4,
    ``seq``), :func:`lm_f32_decode_check` (``check`` cuts its config) and
    :func:`lm_serve_path`, on seeded weights freed afterwards (``max_seq``
    sizes whisper's decoder positions).  No run launches a kernel of the
    port but ``ssd_scan``.  Prints the phase's peak device memory beside
    ``card``."""
    import torch
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_params(cfg, device, max_seq=max_seq)
    out = [lm_prefill_path(cfg, params, seq=seq, device=device),
           lm_f32_decode_check(cfg, device=device, **(check or {})),
           lm_serve_path(cfg, params, device=device)]
    del params
    for p in out:
        _expect_no_stray_launches(f"{cfg.name} {p['path']}", p["launches"],
                                  cfg)
    if device == "cuda":
        peak = max(torch.cuda.max_memory_allocated(),
                   out[2]["phase_peak_before_greedy_bytes"])
        torch.cuda.empty_cache()
        out[0]["peak_memory_bytes"] = peak
        enc = out[0].get("encoder_frames_per_s")
        log(f"phase {cfg.name}: prefill {out[0]['tokens_per_s']:.1f} "
            "tokens/s" + ("" if enc is None else
                          f", encoder {enc:.1f} frames/s")
            + f", peak memory {peak} B ({peak / 2 ** 30:.2f} GiB); "
            f"greedy_generate {out[2]['greedy_tokens_per_s']:.1f} tokens/s, "
            f"its peak {out[2]['greedy_peak_memory_bytes']} B above what "
            f"was held before it; {time.perf_counter() - t0:.1f} s, on "
            f"{card}")
    return out


def lm_family_paths(card: str = "", device: str = "cuda") -> list:
    """Phases m-p: the vision stub, MoE and encoder-decoder families at full
    width, none of which runs a kernel of the port (every counter of every
    run 0).  m: phi-3-vision-4.2b, its prefill with (4, 576, d)
    patches, the f32 check on 4 layers; n: granite-moe-3b-a800m, the f32
    check on 4 layers at capacity factor 8; o: mixtral-8x7b on
    ``MIXTRAL_LAYERS`` of its 32 layers (the banded prefill), the f32 check
    on 2 of them at capacity factor 8; p: whisper-base in full, a (4, 448)
    teacher-forced prefill on (4, 1500, d) frames, the f32 check on (2,
    64)."""
    import dataclasses
    from repro_torch.configs import get_config
    out = lm_paths(get_config(VLM_ARCH), card, device=device,
                   check=dict(n_layers=4))
    out += lm_paths(get_config(MOE_ARCH), card, device=device,
                    check=dict(n_layers=4, seq=64, capacity_factor=8.0))
    full = get_config(MIXTRAL_ARCH)
    cut = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    reduced = {"n_layers": f"{full.n_layers} -> {MIXTRAL_LAYERS}",
               "why": f"{full.param_count() / 1e9:.1f}e9 parameters, "
                      f"{2 * full.param_count() / 1e9:.1f} GB in bf16, over "
                      "the card's 80 GB; AdaptiveLMServer.decode also "
                      "dequantizes the whole tree every step"}
    log(f"{MIXTRAL_ARCH} cut: " + json.dumps(reduced))
    mix = lm_paths(cut, card, device=device,
                   check=dict(n_layers=2, seq=64, capacity_factor=8.0))
    if mix[0]["attention"] != "banded":
        raise AssertionError(f"{MIXTRAL_ARCH} prefill took the "
                             f"{mix[0]['attention']} route, not banded")
    for p in mix:
        p["reduced"] = dict(reduced, **p.get("reduced", {}))
    out += mix
    out += lm_paths(get_config(AUDIO_ARCH), card, seq=WHISPER_MAX_SEQ,
                    max_seq=WHISPER_MAX_SEQ, device=device,
                    check=dict(seq=64))
    return out


# -- training (phases q, r) -------------------------------------------------------

TRAIN_ARCH = DENSE_ARCH
TRAIN_SHAPE = (8, 2048)          # global batch, sequence
TRAIN_MICROBATCHES = 2           # 2 microbatches of 4
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 4
# the f32 copy of the gradient and restart checks: full width, cut depth
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_SHAPE = (2, 128)
TRAIN_RESTART_SHAPE = (4, 256)
TRAIN_RESTART_FAILS = (3, 5)
SSM_TRAIN_LAYERS = 4
SSM_TRAIN_SHAPE = (4, 2048)
SSM_TRAIN_STEPS = 4
GRAD_TOL = 1e-4                  # of each gradient tensor's max|g|
LOSS_RTOL = 1e-5


def _train_opt(steps: int):
    """The training launcher's optimizer settings for a run of ``steps``."""
    from repro_torch.optim.adamw import OptConfig
    return OptConfig(lr=1e-3, warmup_steps=max(steps // 10, 1),
                     total_steps=steps)


def _ckpt_root() -> Path:
    d = ROOT / "build" / "chip_smoke" / "ckpt"
    d.mkdir(parents=True, exist_ok=True)
    return d


def train_path(card: str = "", device: str = "cuda", cfg=None,
               shape=TRAIN_SHAPE, microbatches: int = TRAIN_MICROBATCHES,
               steps: int = TRAIN_STEPS, ckpt_every: int = TRAIN_CKPT_EVERY,
               check=None, restart: bool = True) -> list:
    """Phase q: qwen1.5-0.5b trained at full width (24 layers, bf16,
    seeded on the card) through ``ft.run_training``: ``steps`` steps of
    ``make_train_step(remat=True, microbatches=2)`` on the global batch
    ``shape`` of the port's token stream, AdamW, a checkpoint every
    ``ckpt_every`` steps into a temporary directory under
    ``build/chip_smoke/ckpt``.  Seconds per step (steps 2 on), training
    tokens/s, peak device memory and every step's loss, printed beside the
    card; the losses must be finite and the last below the first; no
    kernel of the port launches; the last checkpoint restores on the CPU
    equal bit for bit to the state the last step returned.  Then
    :func:`train_f32_check` (``check`` cuts it) and, unless ``restart`` is
    off, :func:`train_restart_check`."""
    import math
    import statistics
    import tempfile
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig
    from repro_torch.runtime import ft
    from repro_torch.runtime.train import init_train_state, make_train_step
    cfg = cfg or get_config(TRAIN_ARCH)
    batch, seq = shape
    name = f"{cfg.name} train"
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    state = init_train_state(lm_params(cfg, device))
    n_params = sum(p.numel() for p in state.params.values())
    step_fn = make_train_step(cfg, _train_opt(steps), remat=True,
                              microbatches=microbatches)
    last = {}

    def step(st, b):
        new, metrics = step_fn(st, b)
        last["state"] = new
        return new, metrics

    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=SEED)
    with tempfile.TemporaryDirectory(dir=_ckpt_root()) as d:
        _zero_counts()
        t0 = time.perf_counter()
        res = ft.run_training(step, state, data, steps, d,
                              ckpt_every=ckpt_every)
        _sync(device)
        run_s = time.perf_counter() - t0
        launches = _read_counts()
        saved = ckpt.list_steps(d)
        t0 = time.perf_counter()
        tree, final_step, extra = ckpt.restore(d)
        restore_s = time.perf_counter() - t0
    _expect_no_stray_launches(name, launches, cfg)
    final = ft._to_tree(last.pop("state"))
    for part, leaves in final.items():
        for k, v in leaves.items():
            got = tree[part][k]
            if got.device.type != "cpu" or not torch.equal(got, v.cpu()):
                raise AssertionError(f"{name}: restored {part}/{k} differs "
                                     "from the state of the last step")
    del tree, final
    want = sorted({0, steps} | set(range(ckpt_every, steps, ckpt_every)))
    if final_step != steps or saved != want or extra != {"data_step": steps}:
        raise AssertionError(f"{name}: checkpoints {saved} (expected {want}),"
                             f" final step {final_step}, extra {extra}")
    losses = [m["loss"] for m in res.metrics_log]
    dts = [m["dt"] for m in res.metrics_log]
    if res.restarts or len(losses) != steps or \
            not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses}, restarts "
                             f"{res.restarts}")
    s_step = statistics.median(dts[1:])
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    info = {"path": f"train {cfg.dtype} ({batch}, {seq}) in {microbatches} "
                    "microbatches", "model": cfg.name, "launches": launches,
            "params": n_params, "steps": steps, "losses": losses,
            "step_s": dts, "s_per_step": s_step,
            "tokens_per_s": batch * seq / s_step,
            "peak_memory_bytes": peak, "checkpoints": saved,
            "restore_cpu_s": restore_s, "run_s": run_s,
            "stragglers_flagged": res.flagged_steps}
    log(f"main path {name}: " + json.dumps(info))
    del state, step_fn
    if device == "cuda":
        torch.cuda.empty_cache()
        log(f"phase {name}: {n_params} parameters, {s_step:.3f} s/step "
            f"(median of steps 2-{steps}), {info['tokens_per_s']:.1f} "
            f"training tokens/s, peak memory {peak} B "
            f"({peak / 2 ** 30:.2f} GiB), loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, {time.perf_counter() - t_all:.1f} s, on "
            f"{card}")
    out = [info, train_f32_check(cfg, device, **(check or {}))]
    if restart:
        out.append(train_restart_check())
    return out


def train_f32_check(cfg, device: str = "cuda",
                    n_layers: int = TRAIN_CHECK_LAYERS,
                    shape=TRAIN_CHECK_SHAPE) -> dict:
    """In an f32 copy of ``cfg`` cut to ``n_layers`` at full width, with
    TF32 off: ``loss_fn`` and its gradients on ``device`` against the
    port's CPU plain path on the same weights and batch, the loss within
    1e-5 relative and every gradient tensor within 1e-4 of its own
    max|g|."""
    import dataclasses
    import math
    import torch
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.runtime.train import _grads_of
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n_layers)
    name = f"{cfg.name} f32 loss and gradients"
    batch, seq = shape
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = lm_params(cfg32, device)
        b = batch_at(DataConfig(vocab=cfg32.vocab, seq_len=seq,
                                global_batch=batch, seed=SEED + 13), 0,
                     device)
        _zero_counts()
        t0 = time.perf_counter()
        metrics, grads = _grads_of(params, b, cfg32, remat=True)
        _sync(device)
        dev_s = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    _expect_no_stray_launches(name, launches, cfg32)
    t0 = time.perf_counter()
    metrics_c, grads_c = _grads_of({k: v.cpu() for k, v in params.items()},
                                   {k: v.cpu() for k, v in b.items()}, cfg32,
                                   remat=True)
    cpu_s = time.perf_counter() - t0
    loss, loss_c = float(metrics["loss"]), float(metrics_c["loss"])
    loss_rel = abs(loss - loss_c) / abs(loss_c)
    worst, worst_k = 0.0, None
    for k, gc in grads_c.items():
        scale = float(gc.abs().max())
        err = float((grads[k].cpu() - gc).abs().max())
        frac = err / scale if scale else (0.0 if err == 0 else math.inf)
        if frac > worst:
            worst, worst_k = frac, k
    if not (loss_rel <= LOSS_RTOL and worst <= GRAD_TOL):
        raise AssertionError(f"{name}: loss {loss} vs CPU {loss_c} (rel "
                             f"{loss_rel}); worst gradient {worst_k} at "
                             f"{worst} of its max (bound {GRAD_TOL})")
    info = {"path": f"train f32 loss and gradients vs CPU ({batch}, {seq})",
            "model": cfg.name, "launches": launches,
            "reduced": {"n_layers": f"{cfg.n_layers} -> {n_layers}",
                        "dtype": f"{cfg.dtype} -> float32"},
            "loss": loss, "loss_cpu": loss_c, "loss_rel_err": loss_rel,
            "worst_grad_err_over_max": worst, "worst_grad": worst_k,
            "device_s": dev_s, "cpu_s": cpu_s}
    log(f"main path {name}: " + json.dumps(info))
    return info


def train_restart_check() -> dict:
    """The restart check of phase q in a process of its own (its
    deterministic-algorithm flags and cuBLAS workspace stay out of the
    other phases): :func:`train_restart_main` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``.  Fails unless that process
    reports a restart that ended bit for bit on the uninterrupted run (or,
    where it names an op without a deterministic CUDA version, within
    tolerance of it)."""
    from repro_torch.configs import get_config
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--train-restart",
           "--src", str(SRC)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=900)
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("train_restart: ")]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"restart check: rc {out.returncode}\n"
                             f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    info = json.loads(lines[-1][len("train_restart: "):])
    info["process_s"] = wall
    _expect_no_stray_launches("restart check", info["launches"],
                              get_config(TRAIN_ARCH))
    if info["restarts"] != len(TRAIN_RESTART_FAILS) or not (
            info["bit_equal"] or (info["nondeterministic_ops"]
                                  and info["within_tolerance"])):
        raise AssertionError(f"restart check failed: {json.dumps(info)}")
    log(f"main path {info['model']} restart check: " + json.dumps(info))
    return info


def train_restart_main(device: str = "cuda", cfg=None,
                       shape=TRAIN_RESTART_SHAPE) -> int:
    """The restart check itself (``chip_smoke.py --train-restart``): with
    ``torch.use_deterministic_algorithms(True)``, an f32 copy of
    qwen1.5-0.5b cut to ``TRAIN_CHECK_LAYERS`` layers at full width runs
    ``TRAIN_STEPS`` steps of ``ft.run_training`` with a checkpoint every
    ``TRAIN_CKPT_EVERY`` steps, once uninterrupted and once with failures
    injected at ``TRAIN_RESTART_FAILS``; the two final checkpoints must be
    equal bit for bit.  An op that has no deterministic CUDA version warns
    (``warn_only``): it is named, and the check then holds the moments
    within 1e-4 of each tensor's max instead.  Prints one
    ``train_restart: {json}`` line.  ``cfg`` replaces that copy (a CPU
    rehearsal passes a smoke config)."""
    import dataclasses
    import tempfile
    import warnings
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig
    from repro_torch.runtime import ft
    from repro_torch.runtime.train import init_train_state, make_train_step
    t_start = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    full = get_config(TRAIN_ARCH)
    cfg = cfg or dataclasses.replace(full, dtype="float32",
                                     n_layers=TRAIN_CHECK_LAYERS)
    batch, seq = shape
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=SEED + 17)
    step = make_train_step(cfg, _train_opt(TRAIN_STEPS), remat=True)
    state = init_train_state(lm_params(cfg, device))
    _sync(device)
    setup_s = time.perf_counter() - t_start
    runs = {}
    _zero_counts()
    with warnings.catch_warnings(record=True) as caught, \
            tempfile.TemporaryDirectory(dir=_ckpt_root()) as d:
        warnings.simplefilter("always")
        for label, fails in (("uninterrupted", ()),
                             ("interrupted", TRAIN_RESTART_FAILS)):
            t0 = time.perf_counter()
            res = ft.run_training(
                step, state, data, TRAIN_STEPS, os.path.join(d, label),
                ckpt_every=TRAIN_CKPT_EVERY,
                injector=ft.FailureInjector(fail_at=list(fails)))
            _sync(device)
            tree, final_step, _ = ckpt.restore(os.path.join(d, label))
            runs[label] = dict(res=res, tree=tree, step=final_step,
                               s=time.perf_counter() - t0)
    launches = _read_counts()
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})
    a, b = runs["uninterrupted"]["tree"], runs["interrupted"]["tree"]
    equal, worst = True, 0.0
    for part in ("params", "mu", "nu", "count"):
        for k in a[part]:
            x, y = a[part][k], b[part][k]
            equal &= torch.equal(x, y)
            scale = float(x.abs().max()) if x.is_floating_point() else 1.0
            d = float((x.double() - y.double()).abs().max())
            worst = max(worst, d / scale if scale else d)
    info = {"model": cfg.name,
            "path": f"train f32 restart ({batch}, {seq}), failures at "
                    f"{list(TRAIN_RESTART_FAILS)}",
            "reduced": {"n_layers": f"{full.n_layers} -> {cfg.n_layers}",
                        "dtype": f"{full.dtype} -> {cfg.dtype}"},
            "launches": launches,
            "restarts": runs["interrupted"]["res"].restarts,
            "final_steps": [r["step"] for r in runs.values()],
            "losses": {k: [m["loss"] for m in r["res"].metrics_log]
                       for k, r in runs.items()},
            "bit_equal": bool(equal), "max_err_over_max": worst,
            "within_tolerance": worst <= GRAD_TOL,
            "nondeterministic_ops": nondet,
            "setup_s": setup_s,
            "run_s": {k: r["s"] for k, r in runs.items()},
            "total_s": time.perf_counter() - t_start}
    log("train_restart: " + json.dumps(info))
    return 0


def ssm_train_path(card: str = "", device: str = "cuda", cfg=None,
                   n_layers: int = SSM_TRAIN_LAYERS, shape=SSM_TRAIN_SHAPE,
                   steps: int = SSM_TRAIN_STEPS) -> dict:
    """Phase r: mamba2-1.3b at full width on ``n_layers`` of its 48 layers
    (the cut printed), bf16, ``steps`` train steps on ``shape``: the scan
    runs through the oracle, so every ``ssd_scan`` counter reads 0 over
    the steps; a direct ``ssd_chunked_kernel`` call on tensors that require
    grad raises and launches nothing; tokens/s (the median of steps 2
    onward; the first is warm-up) and peak device memory printed beside
    the card."""
    import dataclasses
    import math
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
    from repro_torch.runtime.train import init_train_state, make_train_step
    full = cfg or get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    reduced = {"n_layers": f"{full.n_layers} -> {n_layers}",
               "why": "the phase shows the training path's scan route; the "
                      "depth adds only time"}
    log(f"{full.name} train cut: " + json.dumps(reduced))
    name = f"{cfg.name} train"
    batch, seq = shape
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(lm_params(cfg, device))
    step = make_train_step(cfg, _train_opt(steps), remat=True)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=SEED)
    losses, dts = [], []
    _zero_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch_at(data, i, device))
        losses.append(float(metrics["loss"]))
        dts.append(time.perf_counter() - t0)
    launches = _read_counts()
    fired = {k: n for k, n in launches.items() if n}
    if fired or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: launches {fired}, losses {losses}")
    g = torch.Generator(device=device).manual_seed(SEED + 19)
    H, P, N = cfg.n_ssm_heads, cfg.ssm.d_head, cfg.ssm.d_state
    x = torch.randn((1, 64, H, P), generator=g, device=device,
                    requires_grad=True)
    dt = torch.rand((1, 64, H), generator=g, device=device) * 0.1
    A = -torch.rand((H,), generator=g, device=device)
    Bm = torch.randn((1, 64, 1, N), generator=g, device=device)
    refused = None
    try:
        ssd_chunked_kernel(x, dt, A, Bm, Bm.clone(),
                           torch.ones((H,), device=device), cfg.ssm.chunk)
    except RuntimeError as e:
        refused = str(e)
    after = _read_counts()
    if refused is None or "no backward" not in refused or any(after.values()):
        raise AssertionError(f"{name}: ssd_chunked_kernel under grad: "
                             f"{refused!r}, launches {after}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    info = {"path": f"train {cfg.dtype} ({batch}, {seq})", "model": cfg.name,
            "launches": launches, "reduced": reduced, "losses": losses,
            "step_s": dts,
            "tokens_per_s": batch * seq / statistics.median(dts[1:]),
            "peak_memory_bytes": peak, "refused_under_grad": refused}
    log(f"main path {name}: " + json.dumps(info))
    del state, step
    if device == "cuda":
        torch.cuda.empty_cache()
        log(f"phase {name}: {info['tokens_per_s']:.1f} training tokens/s "
            f"(median of steps 2-{steps}), 0 ssd_scan launches, peak "
            f"memory {peak} B "
            f"({peak / 2 ** 30:.2f} GiB), on {card}")
    return info


# -- phase s: SPMD on a DeviceMesh ----------------------------------------------

SPMD_PREFILL_SHAPE = (4, 2048)
SPMD_TRAIN_SHAPE = (8, 2048)     # 2 microbatches of 4, remat
SPMD_TRAIN_STEPS = 3
SPMD_TRAIN_RTOL = 2e-2           # the reference's sharded-step tolerances
SPMD_PARAM_TOL = 5e-2            # of each tensor's max (q/k/v biases skipped)
SPMD_DELTA_TOL = 1e-2            # of each update's max, plus a bf16 ulp
SPMD_BF16_GATE = 2.0 ** -5       # tests/test_torch_lm.py's bf16 logits gate
SPMD_DIST_BATCHES = (8, 3, 1)
SPMD_DECODE_SLOTS = 64           # the cache's slots, over the data axes
SPMD_DECODE_STEPS = 8            # batch 1, as long_500k's
# a prefill and a train step of batch 1: data axes of one rank, where the
# port leaves the batch whole (``sharding.batch_entry``)
SPMD_BATCH1_SHAPE = (1, 2048)
SPMD_BATCH1_STEPS = 2


def _mesh_path_name(mesh) -> str:
    from repro_torch.sharding import mesh_shape
    return "mesh " + "x".join(f"{k}={v}" for k, v in mesh_shape(mesh).items())


def spmd_prefill(cfg, mesh, card: str = "", device: str = "cuda",
                 shape=SPMD_PREFILL_SHAPE, reps: int = 3) -> dict:
    """The prefill on the mesh: ``make_prefill_step(cfg, mesh=mesh)`` on
    DTensor parameters placed by ``param_sharding`` and tokens over the
    data axes, the scan run on each rank's local heads under ``local_map``
    (one ``ssd_scan`` launch a layer, counted with the counters zeroed just
    before the mesh run and read just after), its logits against the
    ``mesh=None`` prefill of the same weights (bit for bit on one rank, or
    within ``SPMD_BF16_GATE`` of max|logit| with the difference reported);
    tokens/s of both routes, timed alternately in this process."""
    import statistics
    import torch
    from repro_torch.runtime.serve import make_prefill_step
    from repro_torch.sharding import (batch_spec, param_sharding, place,
                                      place_tree)
    batch, seq = shape
    params = lm_params(cfg, device)
    toks = _tokens(cfg, (batch, seq), SEED + 5, device)
    plain = make_prefill_step(cfg)
    on_mesh = make_prefill_step(cfg, mesh=mesh)
    name = f"{cfg.name} {_mesh_path_name(mesh)} prefill"
    with torch.no_grad():
        want = plain(params, {"tokens": toks})
        t0 = time.perf_counter()
        dparams = place_tree(params, param_sharding(params, mesh))
        dfeed = {"tokens": place(toks, mesh, batch_spec(mesh, None))}
        _sync(device)
        place_s = time.perf_counter() - t0
        _zero_counts()
        t0 = time.perf_counter()
        got = on_mesh(dparams, dfeed)
        _sync(device)
        first_s = time.perf_counter() - t0
        launches = _read_counts()
        full = got.full_tensor()
        if tuple(full.shape) != (batch, seq, cfg.vocab_padded) or \
                not bool(torch.isfinite(full).all()):
            raise AssertionError(f"{name}: logits {tuple(full.shape)}, "
                                 "finite: "
                                 f"{bool(torch.isfinite(full).all())}")
        equal = torch.equal(full, want)
        diff = float((full.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if not equal and diff > SPMD_BF16_GATE * scale:
            raise AssertionError(f"{name}: max |diff| {diff} from the "
                                 f"mesh=None prefill over the gate "
                                 f"{SPMD_BF16_GATE} * {scale}")
        _expect_ssd_launches(name, launches, cfg, device)
        del full, got, want
        secs = {"mesh": [], "none": []}
        for _ in range(reps):
            for route, fn in (("none", lambda: plain(params,
                                                      {"tokens": toks})),
                              ("mesh", lambda: on_mesh(dparams, dfeed))):
                t1 = time.perf_counter()
                fn()
                _sync(device)
                secs[route].append(time.perf_counter() - t1)
    tps = {k: batch * seq / statistics.median(v) for k, v in secs.items()}
    info = {"path": f"{_mesh_path_name(mesh)} prefill {cfg.dtype} "
                    f"({batch}, {seq})", "model": cfg.name,
            "launches": launches, "bit_equal_to_mesh_none": equal,
            "max_abs_diff": diff, "logits_max_abs": scale,
            "place_s": place_s, "first_s": first_s, "prefill_s": secs,
            "tokens_per_s": tps["mesh"], "tokens_per_s_mesh_none": tps["none"],
            "host_cost_s": statistics.median(secs["mesh"])
            - statistics.median(secs["none"])}
    log(f"main path {name}: " + json.dumps(info))
    log(f"phase s {name}: {tps['mesh']:.1f} tokens/s on the mesh, "
        f"{tps['none']:.1f} with mesh=None, {launches['ssd_scan']} ssd_scan "
        f"launches, logits {'bit for bit' if equal else f'max |diff| {diff}'}"
        f", on {card}")
    del dparams, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return info


def spmd_train(cfg, mesh, card: str = "", device: str = "cuda",
               shape=SPMD_TRAIN_SHAPE, steps: int = SPMD_TRAIN_STEPS,
               microbatches: int = 2) -> dict:
    """``steps`` train steps of ``jit_train_step`` on the mesh (remat,
    ``microbatches``) from the state ``make_train_step(mesh=None)`` steps
    from, on the port's token stream: every loss and gradient norm within
    ``SPMD_TRAIN_RTOL`` of the one-device run's and every parameter within
    ``SPMD_PARAM_TOL`` of its tensor's max (the reference's sharded-step
    tolerances), the largest differences reported.  Those gates cannot see
    the update itself (3 steps of lr 1e-3 move a weight by a few tenths of
    a percent of its max), so each parameter's update (new - initial) must
    also equal the one-device run's within ``SPMD_DELTA_TOL`` of that
    update's max plus one bf16 ulp of the parameter per element: a missing
    or reversed update fails.  Seconds per step of both and the mesh run's
    peak memory, beside the card."""
    import statistics
    import torch
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.runtime.train import (init_train_state, jit_train_step,
                                           make_train_step)
    batch, seq = shape
    name = f"{cfg.name} {_mesh_path_name(mesh)} train"
    state = init_train_state(lm_params(cfg, device))
    p0 = {k: v.float().cpu() for k, v in state.params.items()}
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=SEED)
    opt = _train_opt(steps)

    def run(step_fn):
        st, losses, gns, dts = state, [], [], []
        for i in range(steps):
            t0 = time.perf_counter()
            st, m = step_fn(st, batch_at(data, i, device))
            losses.append(float(m["loss"]))
            gns.append(float(m["grad_norm"]))
            dts.append(time.perf_counter() - t0)
        return st.params, losses, gns, dts

    p1, l1, g1, d1 = run(make_train_step(cfg, opt, remat=True,
                                         microbatches=microbatches))
    p1 = {k: v.float().cpu() for k, v in p1.items()}
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    step = jit_train_step(cfg, opt, mesh, state, batch_at(data, 0, device),
                          remat=True, microbatches=microbatches)
    _zero_counts()
    p2, l2, g2, d2 = run(step)
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    _expect_no_stray_launches(name, launches, cfg)
    rel_loss = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
    rel_gn = max(abs(a - b) / abs(a) for a, b in zip(g1, g2))
    worst, worst_k, d_worst, d_worst_k, d_moved = 0.0, None, 0.0, None, 0
    d_max = 0.0
    for k, a in p1.items():
        b = p2[k].full_tensor().float().cpu()
        u1, u2 = a - p0[k], b - p0[k]
        # one bf16 ulp of |a| is at most |a| * 2^-7 (8 significant bits)
        d_bad = (u2 - u1).abs() > (SPMD_DELTA_TOL * u1.abs().max()
                                   + a.abs() * 2.0 ** -7)
        d_rel = float((u2 - u1).abs().max()) / (float(u1.abs().max()) + 1e-30)
        d_moved += int((u1 != 0).sum())
        d_max = max(d_max, d_rel)
        if bool(d_bad.any()) and d_rel >= d_worst:
            d_worst, d_worst_k = d_rel, k
        if k.endswith(("/bq", "/bk", "/bv")):
            continue
        rel = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-6)
        if rel > worst:
            worst, worst_k = rel, k
    if rel_loss >= SPMD_TRAIN_RTOL or rel_gn >= SPMD_TRAIN_RTOL or \
            worst >= SPMD_PARAM_TOL or d_worst_k is not None or not d_moved:
        raise AssertionError(f"{name}: losses {l2} vs {l1}, grad norms {g2} "
                             f"vs {g1}, worst parameter {worst_k} {worst}, "
                             f"update off at {d_worst_k} ({d_worst} of its "
                             f"max), {d_moved} elements moved one-device")
    info = {"path": f"{_mesh_path_name(mesh)} train {cfg.dtype} "
                    f"({batch}, {seq}) in {microbatches} microbatches",
            "model": cfg.name, "launches": launches, "steps": steps,
            "losses": l2, "losses_mesh_none": l1, "grad_norms": g2,
            "grad_norms_mesh_none": g1, "max_loss_rel": rel_loss,
            "max_grad_norm_rel": rel_gn, "max_param_rel": worst,
            "bit_equal_to_mesh_none": l1 == l2 and g1 == g2 and worst == 0.0,
            "max_param_rel_at": worst_k,
            "max_update_rel": d_max, "update_elements_moved": d_moved,
            "step_s": d2,
            "step_s_mesh_none": d1,
            "s_per_step": statistics.median(d2[1:]),
            "s_per_step_mesh_none": statistics.median(d1[1:]),
            "tokens_per_s": batch * seq / statistics.median(d2[1:]),
            "peak_memory_bytes": peak}
    log(f"main path {name}: " + json.dumps(info))
    del p2, state, step
    if device == "cuda":
        torch.cuda.empty_cache()
    return info


def spmd_decode(cfg, mesh, card: str = "", device: str = "cuda",
                slots: int = SPMD_DECODE_SLOTS,
                steps: int = SPMD_DECODE_STEPS) -> dict:
    """``steps`` decode steps of batch 1 on the mesh with every layer's
    cache laid out over its slots on the data axes (``launch.specs.
    decode_state_sharding``'s layout for a batch the data axes do not
    divide, long_500k's), so ``decode_attention`` takes the
    sequence-sharded core and the head returns vocab-sharded logits: each
    step's logits and the final caches against the ``mesh=None`` decode of
    the same weights and tokens, bit for bit on one rank (else within
    ``SPMD_BF16_GATE`` of max|logit|); the same steps again donated
    (``donate=True``) from an equal state on the mesh: each step's logits
    and the final caches bit for bit against the undonated mesh decode's,
    and every step's state the storages it was given; seconds per step of
    all three."""
    import statistics
    import torch
    from repro_torch.runtime import model_api
    from repro_torch.sharding import (P, batch_axes, param_sharding, place,
                                      place_tree, to_placements, tp_size)
    name = f"{cfg.name} {_mesh_path_name(mesh)} decode"
    params = lm_params(cfg, device)
    toks = _tokens(cfg, (1, steps), SEED + 31, device)
    st1 = model_api.init_decode_state(params, {}, cfg, 1, slots)
    feat = "model" if cfg.kv_dim % tp_size(mesh) == 0 else None
    cspec = P(None, None, batch_axes(mesh), feat)      # (L, B, slots, kv)
    dparams = place_tree(params, param_sharding(params, mesh))
    st2 = st1._replace(cache_k=place(st1.cache_k, mesh, cspec),
                       cache_v=place(st1.cache_v, mesh, cspec))
    st3 = st1._replace(cache_k=place(st1.cache_k, mesh, cspec),
                       cache_v=place(st1.cache_v, mesh, cspec))

    def storages(st):
        return [t.to_local().untyped_storage().data_ptr()
                for t in (st.cache_k, st.cache_v)]

    held = storages(st3)
    secs = {"mesh": [], "none": [], "donated": []}
    equal, donated_equal, diff, scale = True, True, 0.0, 0.0
    _zero_counts()
    with torch.no_grad():
        for i in range(steps):
            t0 = time.perf_counter()
            want, st1 = model_api.decode_step(params, toks[:, i:i + 1], st1,
                                              cfg)
            _sync(device)
            t1 = time.perf_counter()
            got, st2 = model_api.decode_step(
                dparams, place(toks[:, i:i + 1], mesh, P()), st2, cfg,
                mesh=mesh)
            full = got.full_tensor()
            _sync(device)
            secs["none"].append(t1 - t0)
            secs["mesh"].append(time.perf_counter() - t1)
            if not bool(torch.isfinite(full).all()):
                raise AssertionError(f"{name}: step {i} logits not finite")
            equal &= torch.equal(full, want)
            diff = max(diff, float((full.float() - want.float()).abs().max()))
            scale = max(scale, float(want.float().abs().max()))
            t2 = time.perf_counter()
            got, st3 = model_api.decode_step(
                dparams, place(toks[:, i:i + 1], mesh, P()), st3, cfg,
                mesh=mesh, donate=True)
            got = got.full_tensor()
            _sync(device)
            secs["donated"].append(time.perf_counter() - t2)
            donated_equal &= torch.equal(got, full)
            if storages(st3) != held:
                raise AssertionError(f"{name}: donated step {i} returned "
                                     f"other storages than its state's")
    launches = _read_counts()
    _expect_no_stray_launches(name, launches, cfg)
    if tuple(st2.cache_k.placements) != to_placements(cspec, mesh):
        raise AssertionError(f"{name}: the cache left its slots' layout: "
                             f"{st2.cache_k.placements}")
    for a, b in ((st2.cache_k, st1.cache_k), (st2.cache_v, st1.cache_v)):
        equal &= torch.equal(a.full_tensor(), b)
    for a, b in ((st3.cache_k, st2.cache_k), (st3.cache_v, st2.cache_v)):
        donated_equal &= torch.equal(a.full_tensor(), b.full_tensor())
    if not donated_equal or st3.index != st2.index:
        raise AssertionError(f"{name}: the donated decode's logits or caches "
                             f"differ from the undonated mesh decode's")
    if not equal and diff > SPMD_BF16_GATE * scale:
        raise AssertionError(f"{name}: max |diff| {diff} from the mesh=None "
                             f"decode over the gate {SPMD_BF16_GATE} * "
                             f"{scale}")
    info = {"path": f"{_mesh_path_name(mesh)} decode {cfg.dtype} batch 1, "
                    f"{slots} slots over the data axes", "model": cfg.name,
            "launches": launches, "steps": steps,
            "bit_equal_to_mesh_none": equal, "max_abs_diff": diff,
            "donated_bit_equal": donated_equal,
            "logits_max_abs": scale, "step_s": secs["mesh"],
            "step_s_mesh_none": secs["none"],
            "step_s_donated": secs["donated"],
            "s_per_step": statistics.median(secs["mesh"][1:]),
            "s_per_step_mesh_none": statistics.median(secs["none"][1:]),
            "s_per_step_donated": statistics.median(secs["donated"][1:])}
    log(f"main path {name}: " + json.dumps(info))
    log(f"phase s {name}: {steps} steps, {info['s_per_step']:.4f} s a step "
        f"on the mesh, {info['s_per_step_donated']:.4f} donated, "
        f"{info['s_per_step_mesh_none']:.4f} with mesh=None, "
        f"logits and caches {'bit for bit' if equal else f'max |diff| {diff}'}"
        f" (donated: bit for bit against the mesh's), on {card}")
    del dparams, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return info


def spmd_dist_serve(cfg, mesh, card: str = "", device: str = "cuda") -> dict:
    """mnist-cnn's ``"dist"`` target on the data mesh behind
    ``AccelServer``: batches 8, 3 and 1 equal to the ``"torch"`` target's
    bit for bit on one rank; then 33 requests of 1-8 rows with the pump
    running through each target's server (each result within 1e-5 of its
    request run alone), requests/s of both."""
    import numpy as np
    from repro_torch.core.passes import PassManager, structural_pipeline
    from repro_torch.core.reader import cnn_to_ir
    from repro_torch.core.writers.dist_writer import DistWriter
    from repro_torch.core.writers.torch_writer import TorchWriter
    from repro_torch.runtime.serve import AccelServer
    name = f"mnist-cnn dist {_mesh_path_name(mesh)}"
    params = _params(cfg, False, device)
    g = PassManager(structural_pipeline()).run(cnn_to_ir(cfg, params))
    dw = DistWriter(g, device=device)
    ref = TorchWriter(g, device=device).build()
    _, reqs = _workload(cfg, 33, SEED + 23)
    x = np.concatenate(reqs)[:max(SPMD_DIST_BATCHES)]
    _zero_counts()
    srv = AccelServer(dw.build_batched(mesh), max_batch=8, max_wait=0.0)
    for b in SPMD_DIST_BATCHES:
        t = srv.submit(x[:b])
        srv.pump(flush=True)
        _check(f"{name} batch {b}", srv.result(t), ref(x[:b]).cpu().numpy(),
               exact=True)
    rates, stats = {}, {}
    for target, exe in (("dist", dw.build_batched(mesh)),
                        ("torch", TorchWriter(g, device=device)
                         .build_batched())):
        srv = AccelServer(exe, max_batch=8, max_wait=0.002)
        t0 = time.perf_counter()
        outs = _serve_all(srv, reqs)
        rates[target] = len(reqs) / (time.perf_counter() - t0)
        stats[target] = srv.stats()
        # coalesced batches round the convolutions' sums in their own
        # order: the reference's serving test holds them within 1e-5
        worst = max(float(np.abs(o - ref(r).cpu().numpy()).max())
                    for o, r in zip(outs, reqs))
        if not worst <= 1e-5:
            raise AssertionError(f"{name} {target}: served results "
                                 f"{worst} from per-request ones")
    launches = _read_counts()
    info = {"path": f"dist {_mesh_path_name(mesh)}", "model": "mnist-cnn",
            "launches": launches, "batches_bit_equal": list(SPMD_DIST_BATCHES),
            "requests": len(reqs), "requests_per_s": rates["dist"],
            "requests_per_s_torch": rates["torch"],
            "p50_latency_ms": 1e3 * stats["dist"].get("p50_latency_s",
                                                      float("nan")),
            "p95_latency_ms": 1e3 * stats["dist"].get("p95_latency_s",
                                                      float("nan"))}
    log(f"main path {name}: " + json.dumps(info))
    log(f"phase s {name}: {rates['dist']:.1f} req/s (torch target "
        f"{rates['torch']:.1f}), batches {SPMD_DIST_BATCHES} bit for bit, "
        f"on {card}")
    return info


def spmd_path(card: str = "", device: str = "cuda", prefill_cfg=None,
              train_cfg=None, prefill_shape=SPMD_PREFILL_SHAPE,
              train_shape=SPMD_TRAIN_SHAPE,
              train_steps: int = SPMD_TRAIN_STEPS,
              batch1_shape=SPMD_BATCH1_SHAPE) -> list:
    """Phase s: a one-rank process group (NCCL on the card) and its
    (1, 1) ``make_local_mesh()``; mamba2-1.3b's prefill on the mesh
    (:func:`spmd_prefill`), qwen1.5-0.5b's train step through
    ``jit_train_step`` (:func:`spmd_train`, the vocab-parallel
    cross-entropy), its decode on a cache sharded over its slots
    (:func:`spmd_decode`), its prefill and a train step (no
    microbatches) of ``batch1_shape``, a batch of 1, and mnist-cnn's
    ``"dist"`` target on the (1,) data mesh (:func:`spmd_dist_serve`).
    On one rank the prefills, the train steps and the decode must equal
    ``mesh=None``'s bit for bit.  The group is destroyed at the end; a
    group that does not start fails the phase."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.mnist_cnn import CNNConfig
    from repro_torch.launch.mesh import compat_make_mesh, make_local_mesh
    t0 = time.perf_counter()
    mesh = make_local_mesh(device=device)
    backend = dist.get_backend()
    if device == "cuda" and backend != "nccl":
        raise AssertionError(f"phase s: the group's backend is {backend}")
    try:
        out = [spmd_prefill(prefill_cfg or get_config(LM_ARCH), mesh, card,
                            device, prefill_shape),
               spmd_train(train_cfg or get_config(TRAIN_ARCH), mesh, card,
                          device, train_shape, train_steps),
               spmd_decode(train_cfg or get_config(TRAIN_ARCH), mesh, card,
                           device),
               spmd_prefill(train_cfg or get_config(TRAIN_ARCH), mesh, card,
                            device, batch1_shape),
               spmd_train(train_cfg or get_config(TRAIN_ARCH), mesh, card,
                          device, batch1_shape, SPMD_BATCH1_STEPS,
                          microbatches=1),
               spmd_dist_serve(CNNConfig(), compat_make_mesh((1,), ("data",)),
                               card, device)]
    finally:
        dist.destroy_process_group()
    if all(n == 1 for n in tuple(mesh.shape)):
        off = [f"{p['model']} {p['path']}" for p in out
               if not p.get("bit_equal_to_mesh_none", True)]
        if off:
            raise AssertionError(f"phase s: on one rank {off} differ from "
                                 "mesh=None")
    log(f"phase s: a one-rank {backend} group, "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# -- phase t: the dry-run on fake meshes ----------------------------------------

# (arch, shape, multi_pod): one cell of each kind on the production meshes
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k", False),
                ("mamba2-1.3b", "prefill_32k", False),
                ("mixtral-8x7b", "decode_32k", True),
                ("hymba-1.5b", "long_500k", False),
                ("hymba-1.5b", "train_4k", False),
                ("mixtral-8x7b", "train_4k", False))
DRYRUN_TIMEOUT_S = 900
# Per rank, for each of DRYRUN_CELLS: (peak bytes, all-gather wire bytes,
# all wire bytes) of the port on the card (phase t, torch 2.11: each from
# the last card run that moved it), and (argument +
# temp bytes, all-gather wire bytes) of the reference's dry-run at full
# depth (``repro.launch.dryrun``, ``scripts/dryrun_parity.py
# --reference-only --layers 0`` for the first four, ``--layers 32`` for
# hymba's train_4k: XLA's CPU-backend buffer assignment, computed on a host
# CPU, not a device figure; None: not computed), printed beside this
# run's.  A cell's figures may not rise above its DRYRUN_BEFORE ones (to
# the digits given there).
DRYRUN_BEFORE = {"qwen1.5-0.5b train_4k": (8.267e9, 54.5e6, 30.8713e9),
                 "mamba2-1.3b prefill_32k": (1.899e9, 1513.7e6, 26.1998e9),
                 "mixtral-8x7b decode_32k": (6.117e9, 2.5e6, 0.0148e9),
                 "hymba-1.5b long_500k": (0.212e9, 5.4e6, 0.0060e9),
                 "hymba-1.5b train_4k": (18.367e9, 9545.4e6, 156.4525e9),
                 "mixtral-8x7b train_4k": (46.067e9, 6549.0e6, 181.1214e9)}
# (unit, decimals) each DRYRUN_BEFORE figure is given to
DRYRUN_BEFORE_DIGITS = ((1e9, 3), (1e6, 1), (1e9, 4))
DRYRUN_REFERENCE = {"qwen1.5-0.5b train_4k": (14.55e9, 58.1e6),
                    "mamba2-1.3b prefill_32k": (1.73e9, 3019.9e6),
                    "mixtral-8x7b decode_32k": (18.30e9, 138.4e6),
                    "hymba-1.5b long_500k": (0.60e9, 13.4e6),
                    "hymba-1.5b train_4k": (277.70e9, 68665.1e6),
                    "mixtral-8x7b train_4k": None}
# cells whose SSD heads the model axis does not divide: the heads a model
# rank must scan once they are padded (hymba's 50 heads, 64 over 16 ranks)
DRYRUN_PADDED_HEADS = {"hymba-1.5b train_4k": 4}
# cells whose attention core runs on each rank's own q heads: the q heads
# a model rank must score (hymba's 25 padded to 32 over 16 ranks;
# mixtral's 32, which 16 ranks divide and its 8 kv heads do not)
DRYRUN_OWN_Q_HEADS = {"hymba-1.5b train_4k": 2, "mixtral-8x7b train_4k": 2}
# cells whose peak a rank must fit one card's memory
DRYRUN_FIT_CELLS = ("qwen1.5-0.5b train_4k", "hymba-1.5b train_4k",
                    "mixtral-8x7b train_4k")
# cells whose all-gather wire bytes a rank must not exceed the reference's
# (qwen's train_4k since its residual pins hold their cotangents; hymba's
# long_500k since its SSM decode runs on the state's flat channel shards)
DRYRUN_GATHER_CELLS = ("mamba2-1.3b prefill_32k", "mixtral-8x7b decode_32k",
                       "qwen1.5-0.5b train_4k", "hymba-1.5b long_500k")
# cells that may have no all-gather site whose innermost model frame is one
# of these functions: hymba's decode keeps its SSD state and the update's
# output on their flat channel shards (``ssm.decodes_flat``)
DRYRUN_NO_GATHER_IN = {"hymba-1.5b long_500k": ("ssm_step", "ssm_decode")}
# cells whose wire bytes a rank must stay under a bound: mixtral's decode
# sums its split heads' scores over the 2 ranks of a head, not all 16
DRYRUN_WIRE_BOUND = {"mixtral-8x7b decode_32k": 250e6}
# the sweep: every (arch, shape) of the reference's ``--all`` on both
# production meshes, each cut to this many layers (whisper's encoder too)
DRYRUN_SWEEP_LAYERS = 2
# Per rank, for each pair of the sweep ("arch shape mesh"): (peak bytes,
# all-gather wire bytes, all wire bytes) of phase t on the card (torch
# 2.11, at DRYRUN_SWEEP_LAYERS layers), each from the last card run that
# moved it, to DRYRUN_BEFORE_DIGITS.  A pair's figures may not rise above
# them where the dry-run runs on the torch they were taken on,
# DRYRUN_SWEEP_TORCH: another torch lays out otherwise.
DRYRUN_SWEEP_TORCH = "2.11."
DRYRUN_SWEEP_BEFORE = {
    "granite-moe-3b-a800m train_4k 16x16": (10.324e9, 595.0e6, 5.4929e9),
    "granite-moe-3b-a800m train_4k 2x16x16": (5.198e9, 343.4e6, 2.9067e9),
    "mixtral-8x7b train_4k 16x16": (17.885e9, 438.1e6, 13.2990e9),
    "mixtral-8x7b train_4k 2x16x16": (9.302e9, 404.6e6, 7.6019e9),
    "whisper-base train_4k 16x16": (4.161e9, 13.4e6, 2.9205e9),
    "whisper-base train_4k 2x16x16": (2.102e9, 13.4e6, 1.4945e9),
    "hymba-1.5b train_4k 16x16": (11.844e9, 607.9e6, 10.5547e9),
    "hymba-1.5b train_4k 2x16x16": (5.953e9, 442.0e6, 5.6580e9),
    "phi3-mini-3.8b train_4k 16x16": (13.103e9, 49.8e6, 9.2145e9),
    "phi3-mini-3.8b train_4k 2x16x16": (6.605e9, 49.8e6, 4.7351e9),
    "h2o-danube-3-4b train_4k 16x16": (15.038e9, 128.0e6, 11.6198e9),
    "h2o-danube-3-4b train_4k 2x16x16": (7.587e9, 96.6e6, 5.9771e9),
    "codeqwen1.5-7b train_4k 16x16": (15.816e9, 143.2e6, 12.5147e9),
    "codeqwen1.5-7b train_4k 2x16x16": (8.047e9, 143.2e6, 6.6249e9),
    "qwen1.5-0.5b train_4k 16x16": (5.270e9, 21.3e6, 3.0891e9),
    "qwen1.5-0.5b train_4k 2x16x16": (2.819e9, 21.3e6, 1.5992e9),
    "phi-3-vision-4.2b train_4k 16x16": (13.183e9, 67.5e6, 9.2676e9),
    "phi-3-vision-4.2b train_4k 2x16x16": (6.657e9, 67.5e6, 4.8071e9),
    "mamba2-1.3b train_4k 16x16": (6.334e9, 177.6e6, 9.4080e9),
    "mamba2-1.3b train_4k 2x16x16": (3.187e9, 98.2e6, 4.7522e9),
    "granite-moe-3b-a800m prefill_32k 16x16": (1.915e9, 269.4e6, 2.1568e9),
    "granite-moe-3b-a800m prefill_32k 2x16x16": (0.975e9, 143.5e6, 1.0872e9),
    "mixtral-8x7b prefill_32k 16x16": (4.742e9, 33.6e6, 5.0667e9),
    "mixtral-8x7b prefill_32k 2x16x16": (2.569e9, 16.8e6, 2.5334e9),
    "whisper-base prefill_32k 16x16": (0.807e9, 0.0e6, 0.9302e9),
    "whisper-base prefill_32k 2x16x16": (0.425e9, 9.2e6, 0.4697e9),
    "hymba-1.5b prefill_32k 16x16": (1.872e9, 242.1e6, 2.2092e9),
    "hymba-1.5b prefill_32k 2x16x16": (0.949e9, 159.5e6, 1.1430e9),
    "phi3-mini-3.8b prefill_32k 16x16": (3.376e9, 0.0e6, 3.7749e9),
    "phi3-mini-3.8b prefill_32k 2x16x16": (1.715e9, 0.0e6, 1.8874e9),
    "h2o-danube-3-4b prefill_32k 16x16": (4.144e9, 31.5e6, 4.7500e9),
    "h2o-danube-3-4b prefill_32k 2x16x16": (2.107e9, 15.7e6, 2.3750e9),
    "codeqwen1.5-7b prefill_32k 16x16": (4.583e9, 0.0e6, 5.0332e9),
    "codeqwen1.5-7b prefill_32k 2x16x16": (2.368e9, 0.0e6, 2.5166e9),
    "qwen1.5-0.5b prefill_32k 16x16": (1.554e9, 0.0e6, 1.2583e9),
    "qwen1.5-0.5b prefill_32k 2x16x16": (0.789e9, 0.0e6, 0.6291e9),
    "phi-3-vision-4.2b prefill_32k 16x16": (3.402e9, 0.0e6, 3.7749e9),
    "phi-3-vision-4.2b prefill_32k 2x16x16": (1.737e9, 0.0e6, 1.8874e9),
    "mamba2-1.3b prefill_32k 16x16": (1.739e9, 63.1e6, 1.5740e9),
    "mamba2-1.3b prefill_32k 2x16x16": (0.879e9, 31.6e6, 0.7870e9),
    "granite-moe-3b-a800m decode_32k 16x16": (0.139e9, 0.1e6, 0.0066e9),
    "granite-moe-3b-a800m decode_32k 2x16x16": (0.089e9, 0.1e6, 0.0033e9),
    "mixtral-8x7b decode_32k 16x16": (0.429e9, 0.3e6, 0.0020e9),
    "mixtral-8x7b decode_32k 2x16x16": (0.547e9, 0.2e6, 0.0010e9),
    "mixtral-8x7b long_500k 16x16": (0.396e9, 0.0e6, 0.0001e9),
    "mixtral-8x7b long_500k 2x16x16": (0.396e9, 0.0e6, 0.0001e9),
    "whisper-base decode_32k 16x16": (0.209e9, 0.1e6, 0.0023e9),
    "whisper-base decode_32k 2x16x16": (0.127e9, 0.1e6, 0.0012e9),
    "hymba-1.5b decode_32k 16x16": (0.093e9, 39.6e6, 0.0398e9),
    "hymba-1.5b decode_32k 2x16x16": (0.059e9, 19.8e6, 0.0199e9),
    "hymba-1.5b long_500k 16x16": (0.026e9, 0.3e6, 0.0004e9),
    "hymba-1.5b long_500k 2x16x16": (0.026e9, 0.2e6, 0.0002e9),
    "phi3-mini-3.8b decode_32k 16x16": (0.861e9, 0.0e6, 0.0005e9),
    "phi3-mini-3.8b decode_32k 2x16x16": (0.457e9, 0.0e6, 0.0002e9),
    "h2o-danube-3-4b decode_32k 16x16": (0.100e9, 0.3e6, 0.0019e9),
    "h2o-danube-3-4b decode_32k 2x16x16": (0.203e9, 0.1e6, 0.0010e9),
    "h2o-danube-3-4b long_500k 16x16": (0.070e9, 0.0e6, 0.0001e9),
    "h2o-danube-3-4b long_500k 2x16x16": (0.070e9, 0.0e6, 0.0001e9),
    "codeqwen1.5-7b decode_32k 16x16": (1.229e9, 0.0e6, 0.0006e9),
    "codeqwen1.5-7b decode_32k 2x16x16": (0.691e9, 0.0e6, 0.0003e9),
    "qwen1.5-0.5b decode_32k 16x16": (0.225e9, 0.0e6, 0.0002e9),
    "qwen1.5-0.5b decode_32k 2x16x16": (0.124e9, 0.0e6, 0.0001e9),
    "phi-3-vision-4.2b decode_32k 16x16": (0.880e9, 0.0e6, 0.0005e9),
    "phi-3-vision-4.2b decode_32k 2x16x16": (0.476e9, 0.0e6, 0.0002e9),
    "mamba2-1.3b decode_32k 16x16": (0.024e9, 0.2e6, 0.0004e9),
    "mamba2-1.3b decode_32k 2x16x16": (0.022e9, 0.1e6, 0.0002e9),
    "mamba2-1.3b long_500k 16x16": (0.020e9, 0.1e6, 0.0001e9),
    "mamba2-1.3b long_500k 2x16x16": (0.020e9, 0.1e6, 0.0001e9),
}
# Per rank, the reference's (argument + temp bytes, all-gather wire bytes,
# all wire bytes) of every pair of the sweep at DRYRUN_SWEEP_LAYERS layers
# (``scripts/dryrun_parity.py --reference-only --layers 2 [--multi-pod]``
# with every ``--cell`` of the sweep: the reference's compiled HLO and
# XLA's CPU buffer assignment, computed on a host CPU with jax 0.9.0, not
# device figures).  On any torch, a pair may not all-gather more than its
# reference (but those of DRYRUN_SWEEP_GATHER_EXEMPT) nor move more wire
# bytes; the pairs of DRYRUN_SWEEP_PEAK_HELD may not peak above its
# argument + temp bytes.
DRYRUN_SWEEP_REFERENCE = {
    "granite-moe-3b-a800m train_4k 16x16": (22586489732, 9111387136, 26782842270),
    "granite-moe-3b-a800m train_4k 2x16x16": (11183794700, 4573150208, 13448617219),
    "granite-moe-3b-a800m prefill_32k 16x16": (52874625664, 1962934272, 6241124352),
    "granite-moe-3b-a800m prefill_32k 2x16x16": (26490225280, 981467136, 3120562176),
    "granite-moe-3b-a800m decode_32k 16x16": (372297076, 71475200, 72083456),
    "granite-moe-3b-a800m decode_32k 2x16x16": (190850916, 35737600, 36041728),
    "mixtral-8x7b train_4k 16x16": (30335636444, 538353664, 38310615209.5),
    "mixtral-8x7b train_4k 2x16x16": (15832961804, 471244800, 19757636747),
    "mixtral-8x7b prefill_32k 16x16": (9793877200, 335544320, 10468982784),
    "mixtral-8x7b prefill_32k 2x16x16": (5429048528, 167772160, 5234491392),
    "mixtral-8x7b decode_32k 16x16": (1215609332, 17302528, 18547712),
    "mixtral-8x7b decode_32k 2x16x16": (1181856228, 8651776, 9274368),
    "mixtral-8x7b long_500k 16x16": (1146299416, 136704, 295712),
    "mixtral-8x7b long_500k 2x16x16": (1146168344, 69120, 228256),
    "whisper-base train_4k 16x16": (9336762540, 14249984, 16905720071),
    "whisper-base train_4k 2x16x16": (4875926988, 14249984, 8475073736),
    "whisper-base prefill_32k 16x16": (17153219784, 0, 19809988864),
    "whisper-base prefill_32k 2x16x16": (8602986696, 0, 9904994432),
    "whisper-base decode_32k 16x16": (335635624, 0, 2408192),
    "whisper-base decode_32k 2x16x16": (192074904, 0, 1204096),
    "hymba-1.5b train_4k 16x16": (20580734596, 4303666400, 33447470746.5),
    "hymba-1.5b train_4k 2x16x16": (10319556020, 2164504160, 16764066473.5),
    "hymba-1.5b prefill_32k 16x16": (9492112560, 1536163840, 9535553536),
    "hymba-1.5b prefill_32k 2x16x16": (4775404720, 768081920, 4767776768),
    "hymba-1.5b decode_32k 16x16": (119839580, 80548480, 81238584),
    "hymba-1.5b decode_32k 2x16x16": (89332300, 40274240, 40619292),
    "hymba-1.5b long_500k 16x16": (26027136, 835760, 938295),
    "hymba-1.5b long_500k 2x16x16": (25823616, 528560, 631095),
    "phi3-mini-3.8b train_4k 16x16": (21258390300, 53114880, 27341457527.5),
    "phi3-mini-3.8b train_4k 2x16x16": (10701302652, 53114880, 13756262488),
    "phi3-mini-3.8b prefill_32k 16x16": (35343071424, 0, 7549747200),
    "phi3-mini-3.8b prefill_32k 2x16x16": (17735252160, 0, 3774873600),
    "phi3-mini-3.8b decode_32k 16x16": (1508505896, 0, 921600),
    "phi3-mini-3.8b decode_32k 2x16x16": (803813656, 0, 460800),
    "h2o-danube-3-4b train_4k 16x16": (23963382748, 203159040, 35011407479.5),
    "h2o-danube-3-4b train_4k 2x16x16": (12069683260, 140244480, 17621552728),
    "h2o-danube-3-4b prefill_32k 16x16": (6623701264, 314572800, 9814671360),
    "h2o-danube-3-4b prefill_32k 2x16x16": (3397888272, 157286400, 4907335680),
    "h2o-danube-3-4b decode_32k 16x16": (235113524, 16253888, 17421248),
    "h2o-danube-3-4b decode_32k 2x16x16": (203592868, 8127424, 8711104),
    "h2o-danube-3-4b long_500k 16x16": (69974424, 128416, 277488),
    "h2o-danube-3-4b long_500k 2x16x16": (69728664, 64928, 214120),
    "codeqwen1.5-7b train_4k 16x16": (24976935428, 152739840, 37318424718),
    "codeqwen1.5-7b train_4k 2x16x16": (13584927228, 152739840, 18597443694.5),
    "codeqwen1.5-7b prefill_32k 16x16": (35331681536, 0, 10066329600),
    "codeqwen1.5-7b prefill_32k 2x16x16": (17841302784, 0, 5033164800),
    "codeqwen1.5-7b decode_32k 16x16": (1963773288, 0, 1228800),
    "codeqwen1.5-7b decode_32k 2x16x16": (1157348696, 0, 614400),
    "qwen1.5-0.5b train_4k 16x16": (15075821252, 22685696, 9336700546.5),
    "qwen1.5-0.5b train_4k 2x16x16": (7594231420, 22685696, 4642840166.5),
    "qwen1.5-0.5b prefill_32k 16x16": (17272548224, 0, 2516582400),
    "qwen1.5-0.5b prefill_32k 2x16x16": (8669899648, 0, 1258291200),
    "qwen1.5-0.5b decode_32k 16x16": (533804008, 0, 307200),
    "qwen1.5-0.5b decode_32k 2x16x16": (298921944, 0, 153600),
    "phi-3-vision-4.2b train_4k 16x16": (21345684316, 71989248, 27365050491.5),
    "phi-3-vision-4.2b train_4k 2x16x16": (10750454652, 71989248, 13779855452),
    "phi-3-vision-4.2b prefill_32k 16x16": (35369023680, 0, 7549747200),
    "phi-3-vision-4.2b prefill_32k 2x16x16": (17757665472, 0, 3774873600),
    "phi-3-vision-4.2b decode_32k 16x16": (1508505896, 0, 921600),
    "phi-3-vision-4.2b decode_32k 2x16x16": (803813656, 0, 460800),
    "mamba2-1.3b train_4k 16x16": (10264186556, 271712256, 14272670422.5),
    "mamba2-1.3b train_4k 2x16x16": (5176805268, 145797120, 7181798081.5),
    "mamba2-1.3b prefill_32k 16x16": (1945979088, 125829120, 3686727680),
    "mamba2-1.3b prefill_32k 2x16x16": (995838160, 62914560, 1843363840),
    "mamba2-1.3b decode_32k 16x16": (61509176, 1059840, 1461880),
    "mamba2-1.3b decode_32k 2x16x16": (60008040, 529920, 730940),
    "mamba2-1.3b long_500k 16x16": (20597340, 132480, 182735),
    "mamba2-1.3b long_500k 2x16x16": (20597340, 132480, 182735),
}
# pairs whose all-gathers are not held to the reference's (their wire is),
# and why
DRYRUN_SWEEP_GATHER_EXEMPT = {
    "whisper-base prefill_32k 2x16x16":
        "query positions traded over a head's 2 model ranks "
        "(attention.query_exchange): one head's k and v gathered, where the "
        "reference splits d_head and all-reduces f32 scores",
    "whisper-base decode_32k 16x16":
        "q, k and v of the one new token gathered over 'model' by "
        "attention._proj_qkv's heads views (8 heads on model 16) and the "
        "split-head decode's output (107,520 B a rank on torch 2.11 and "
        "2.13)",
    "whisper-base decode_32k 2x16x16":
        "as on 16x16 (53,760 B a rank on torch 2.11 and 2.13)"}
# pairs whose peak a rank may not exceed the reference's argument + temp
# bytes: all 68.  The decode cells donate their state, as the reference's
# jits its decode with donate_argnums=(2,): each layer's cache is held
# once, and the new state is the argument's storage (alias bytes, which
# the reference's argument + temp bytes count once too).  A prefill's
# logits are outputs, which the reference's figure leaves out.
DRYRUN_SWEEP_PEAK_HELD = tuple(DRYRUN_SWEEP_REFERENCE)
# pairs whose attention scores each head on one of the model ranks that
# hold its dims (``attention.row_exchange``, ``query_exchange``): (q heads,
# batch rows) every attention core on the traced rank must score
# (whisper-base's 8 heads on model 16: one head of half of the 16 rows a
# data rank holds; one head of the one row, for half of the queries)
DRYRUN_SWEEP_HEAD_ROWS = {"whisper-base train_4k 16x16": (1, 8),
                          "whisper-base prefill_32k 2x16x16": (1, 1)}
# the entries whose memory tracker's peak phase t reports in detail
# (``dryrun.PeakProbe``): (arch, shape, mesh, layers; 0: full depth), each
# traced once as the sweep traces it and, cut to layers, once more for each
# of the tracker's own trackings left out
DRYRUN_PEAK_ENTRIES = (("mamba2-1.3b", "prefill_32k", "16x16", 0),
                       ("mamba2-1.3b", "prefill_32k", "16x16", 2),
                       ("mamba2-1.3b", "prefill_32k", "2x16x16", 2))
DRYRUN_PEAK_VARIANTS = {"as-traced": {}, "no-external": {"external": False},
                        "no-resize": {"resize": False}}


def dryrun_pairs() -> list:
    """The reference's ``launch/dryrun.py --all --both-meshes``: (arch,
    shape, mesh name) for every shape of ``shapes_for`` of every arch of
    ``ARCH_IDS``, on 16x16 and 2x16x16 (68 pairs)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import shapes_for
    from repro_torch.launch.dryrun import PRODUCTION_MESHES
    return [(arch, shape.name, mesh) for arch in ARCH_IDS
            for shape in shapes_for(get_config(arch))
            for mesh in PRODUCTION_MESHES]


def _calibration(which: str):
    """(cfg, ShapeConfig, extra) of the card's own steps: phase q's train
    step and the mamba2 bf16 prefill path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    if which == "train":
        B, S = TRAIN_SHAPE
        return (get_config(TRAIN_ARCH), ShapeConfig("phase_q", S, B, "train"),
                {"microbatches": TRAIN_MICROBATCHES})
    return (get_config(LM_ARCH), ShapeConfig("prefill_4x2048", 2048, 4,
                                             "prefill"), {})


def _counter_check() -> dict:
    """The counters' known answers on a fake (16, 16) mesh, with this
    machine's torch: a sharded MLP's 2^38 FLOPs a rank (not the global
    2^46) and one all-reduce of f32 (16, 1024) over 16 ranks."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch import dryrun
    with dryrun.fake_group(256):
        mesh = dryrun._make_mesh((16, 16))
        with FakeTensorMode(allow_non_fake_inputs=False):
            bf = torch.bfloat16
            x = distribute_tensor(torch.empty(256, 4096, 2048, dtype=bf),
                                  mesh, [Shard(0), Replicate()])
            w1 = distribute_tensor(torch.empty(2048, 8192, dtype=bf), mesh,
                                   [Replicate(), Shard(1)])
            w2 = distribute_tensor(torch.empty(8192, 2048, dtype=bf), mesh,
                                   [Replicate(), Shard(0)])
            _, mlp, _ = dryrun.measure(lambda a, b, c: (a @ b) @ c,
                                       x, w1, w2)
            part = DTensor.from_local(torch.empty(16, 1024), mesh,
                                      [Replicate(), Partial()])
            _, ar, _ = dryrun.measure(lambda t: t.redistribute(
                mesh, [Replicate(), Replicate()]), part)
    out = {"mlp_flops": mlp.flops, "all_reduce": dict(ar.collective.counts),
           "all_reduce_wire_bytes": ar.collective.wire_bytes}
    if mlp.flops != 2 ** 38 or out["all_reduce"] != {"all-reduce": 1} or \
            ar.collective.wire_bytes != 2 * 15 / 16 * 16 * 1024 * 4:
        raise AssertionError(f"the dry-run's counters: {out}")
    return out


def mem_tracker_dispatch() -> dict:
    """This torch's ``MemTracker.__torch_dispatch__``: whether it leaves
    out the ops of a fake mode other than its entry's (torch 2.13's
    ``_fake_mode_on_entry``), and its source."""
    import inspect
    from torch.distributed._tools.mem_tracker import MemTracker
    src = inspect.getsource(MemTracker.__torch_dispatch__)
    return {"fake_mode_filter": "_fake_mode_on_entry" in src, "source": src}


def peak_report(results: dict, card: str) -> list:
    """One line a :data:`DRYRUN_PEAK_ENTRIES` entry from its ``peak`` jobs'
    ``results``: the peak a rank as traced, without the tracked arguments
    and without resize tracking; the op and frames where the tracker's
    total first reaches it; what it holds there by fake mode and device;
    its largest storages -> the entries' records."""
    import torch
    out = []
    for arch, shape, mesh, n in DRYRUN_PEAK_ENTRIES:
        runs = {v: results[f"peak {arch} {shape} {mesh} {n} {v}"]
                for v in DRYRUN_PEAK_VARIANTS
                if f"peak {arch} {shape} {mesh} {n} {v}" in results}
        if not runs:
            continue
        r = runs["as-traced"]
        at = r["memory"]["peak_detail"]
        held = "; ".join(
            f"{h['bytes']} B {h.get('dtype', '?')}{h.get('shape', '')} "
            f"{h.get('mode', '?')} {h['op']} at {h.get('site', '?')}"
            for h in at["held"])
        log(f"phase t peak {arch} x {shape} x {mesh} "
            f"({n or 'all'} layers) per rank [{card}, torch "
            f"{torch.__version__}]: "
            + ", ".join(f"{v} {x['peak_bytes']} B" for v, x in runs.items())
            + f"; by device {json.dumps(at['by_device'])}; outputs "
            f"{r['memory']['output_bytes']} B; first reached at {at['op']} "
            f"at {at['site']} (under the step's fake mode: "
            f"{at['under_step_mode']}); "
            f"held by kind {json.dumps(at['by_kind'], sort_keys=True)}; "
            f"largest held: {held}")
        out.append({"arch": arch, "shape": shape, "mesh": mesh, "layers": n,
                    "peak_bytes": {v: x["peak_bytes"] for v, x in
                                   runs.items()},
                    "output_bytes": r["memory"]["output_bytes"], "at": at})
    return out


def dryrun_job(job: str) -> dict:
    """One job of phase t, in the process that runs it: ``counters``, the
    counters' known answers; ``pair arch shape mesh``, one pair of the
    sweep (``dryrun.trace_pair``); ``calibrate train|prefill``, a card
    step traced on a one-rank fake mesh; else ``arch shape multi_pod``, one
    production cell through ``dryrun.run_cell``."""
    from repro_torch.launch import dryrun
    _zero_counts()
    if job == "counters":
        info = _counter_check()
    elif job.startswith("pair "):
        from repro_torch.models import attention
        _, arch, shape, mesh = job.split()
        cores, attend = [], attention.attend

        def counted_attend(q, *args, **kwargs):
            # (q heads, batch rows) each attention core scores, on the
            # traced rank
            cores.append((q.shape[2], q.shape[0]))
            return attend(q, *args, **kwargs)

        attention.attend = counted_attend
        try:
            traced = dryrun.trace_pair(arch, shape, mesh,
                                       DRYRUN_SWEEP_LAYERS)
        finally:
            attention.attend = attend
        info = {"arch": arch, "shape": shape, "mesh": mesh,
                "layers": DRYRUN_SWEEP_LAYERS, **traced,
                "attn_cores": sorted(set(cores))}
    elif job.startswith("peak "):
        _, arch, shape, mesh, layers, variant = job.split()
        probe = dryrun.PeakProbe(**DRYRUN_PEAK_VARIANTS[variant])
        info = dryrun.trace_pair(arch, shape, mesh, int(layers), probe=probe)
    elif job.startswith("calibrate "):
        cfg, shape, extra = _calibration(job.split()[1])
        traced = dryrun.trace_cell(cfg, shape, (1, 1), extra=extra)
        rep = dryrun.report_for(cfg.name, shape, "1x1", 1, traced, cfg)
        info = {**rep.to_dict(), "memory_analysis": traced["memory"],
                "lower_s": traced["lower_s"], "trace_s": traced["trace_s"],
                "ops": traced["ops"], "extra": extra}
    else:
        from repro_torch.models import attention, ssm
        arch, shape, multi_pod = job.split()
        heads, scan = [], ssm.ssd_chunked
        q_heads, attend = [], attention.attend

        def counted(x, *args, **kwargs):
            # the SSD heads each scan runs on, on the traced rank
            heads.append(x.shape[2])
            return scan(x, *args, **kwargs)

        def counted_attend(q, *args, **kwargs):
            # the q heads each attention core scores, on the traced rank
            q_heads.append(q.shape[2])
            return attend(q, *args, **kwargs)

        ssm.ssd_chunked, attention.attend = counted, counted_attend
        try:
            info = dryrun.run_cell(arch, shape, multi_pod=multi_pod == "1",
                                   out_dir=str(ROOT / "build" / "chip_smoke"
                                               / "dryrun"), n_sites=None)
        finally:
            ssm.ssd_chunked, attention.attend = scan, attend
        info["ssd_local_heads"] = heads
        info["attn_local_heads"] = q_heads
    info["job"] = job
    info["launches"] = _read_counts()
    return info


def _finite_terms(name: str, r: dict) -> None:
    import math
    for k in ("flops_per_device", "bytes_per_device", "collective_wire_bytes",
              "model_flops", "compute_s", "memory_s", "collective_s",
              "step_s", "useful_flops_ratio", "mfu"):
        if not math.isfinite(r[k]):
            raise AssertionError(f"phase t {name}: {k} = {r[k]}")


def _gather_gate(name: str, r: dict, where: str, limit: float,
                 what: str) -> None:
    """Fails if an all-gather site whose frames name ``where`` moves, per
    call, ``limit`` bytes or more (``what``: the tensor that size is)."""
    per_call = [(c["wire_bytes"] / c["count"], c)
                for c in r["collective_sites"] if c["op"] == "all-gather"
                and where in c["site"]]
    largest = max((b for b, _ in per_call), default=0.0)
    log(f"phase t {name}: largest {where} all-gather a call "
        f"{largest / 1e6:.2f} MB against {what} {limit / 1e6:.2f} MB")
    over = [c for b, c in per_call if b >= limit]
    if over:
        raise AssertionError(f"phase t {name}: {where} all-gathers {what}: "
                             f"{over}")


def _heads_gate(name: str, kind: str, per_rank: list, seen: list,
                want: int) -> None:
    """Fails unless every model rank holds ``want`` padded heads and every
    call the traced rank made (``seen``, at least one) ran on ``want``."""
    if per_rank != [want] * len(per_rank) or set(seen) != {want}:
        raise AssertionError(f"phase t {name}: {kind} heads a model rank "
                             f"{per_rank}, calls on the traced rank {seen}; "
                             f"want {want} on each")
    log(f"phase t {name}: {want} {kind} heads on each of {len(per_rank)} "
        f"model ranks ({len(seen)} calls on the traced rank)")


def _padded_heads_gate(name: str, r: dict, cfg, shape, mesh_shape,
                       want: int) -> None:
    """Phase t's gates on a cell whose SSD heads the model axis does not
    divide: every model rank scans ``want`` heads (the padded layout, and
    each scan the traced rank ran), and no all-gather site in
    ``models/ssm.py`` moves, per call, as much as a rank's (B_l, S,
    d_inner / tp) bf16 x activation."""
    import math
    from repro_torch.sharding import padded_heads
    tp = mesh_shape[-1]
    _heads_gate(name, "SSD", [padded_heads(cfg.n_ssm_heads, tp) // tp] * tp,
                r["ssd_local_heads"], want)
    x_shard = (shape.global_batch // math.prod(mesh_shape[:-1])
               * shape.seq_len * (cfg.d_inner // tp) * 2)
    _gather_gate(name, r, "models/ssm.py", x_shard, "a rank's x activation")


def _own_q_heads_gate(name: str, r: dict, cfg, shape, mesh_shape,
                      want: int) -> None:
    """Phase t's gates on a cell whose attention core runs on each rank's
    own q heads (padded where the model axis neither divides nor fits
    under them): every model rank scores ``want`` q heads (the layout, and
    each attention core the traced rank ran), and no all-gather site in
    ``models/attention.py`` moves, per call, as much as a rank's (B_l, S,
    H * Dh) bf16 q activation."""
    import math
    import types
    from repro_torch.models.attention import q_heads
    tp = mesh_shape[-1]
    mesh = types.SimpleNamespace(shape={"data": 1, "model": tp},
                                 axis_names=("data", "model"))
    _heads_gate(name, "q", [q_heads(cfg, mesh) // tp] * tp,
                r["attn_local_heads"], want)
    q_act = (shape.global_batch // math.prod(mesh_shape[:-1])
             * shape.seq_len * cfg.q_dim * 2)
    _gather_gate(name, r, "models/attention.py", q_act,
                 "a rank's q activation")


def _worker_init(out_dir: str) -> None:
    """A phase t worker's output (torch's warnings) goes to a log of its
    own under ``out_dir``."""
    fd = os.open(os.path.join(out_dir, f"worker{os.getpid()}.log"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)


def _pool_job(job: str):
    """:func:`dryrun_job` in a worker -> (job, result or None, the error's
    traceback or None, the job's seconds in the worker)."""
    import traceback
    t0 = time.perf_counter()
    try:
        return job, dryrun_job(job), None, time.perf_counter() - t0
    except Exception:  # noqa: BLE001 -- every job is reported
        return (job, None, traceback.format_exc()[-4000:],
                time.perf_counter() - t0)


def _run_jobs(jobs: list, workers: int, out_dir: Path):
    """Phase t's jobs in a pool of ``workers`` processes (``spawn``), each
    taking the next job when it is done, in the order given; each job
    makes its own fake process group, its worker's default group, and
    destroys it.  -> ({job: result}, {job: why it failed}, {job: seconds
    in its worker}).  Jobs not done within :data:`DRYRUN_TIMEOUT_S` fail,
    and the pool is stopped."""
    import multiprocessing
    results, failures, seconds = {}, {}, {}
    deadline = time.perf_counter() + DRYRUN_TIMEOUT_S
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, _worker_init, (str(out_dir),)) as pool:
        pending = [(job, pool.apply_async(_pool_job, (job,)))
                   for job in jobs]
        for job, res in pending:
            try:
                _, info, err, secs = res.get(
                    max(0.0, deadline - time.perf_counter()))
            except multiprocessing.TimeoutError:
                failures[job] = f"not done within {DRYRUN_TIMEOUT_S} s"
                continue
            seconds[job] = secs
            if err is None:
                results[job] = info
            else:
                failures[job] = err
    return results, failures, seconds


def _rises(name: str, now, before) -> list:
    """The figures of ``now`` (peak, all-gather and wire bytes a rank) that
    rise above ``before``'s, each to its :data:`DRYRUN_BEFORE_DIGITS`."""
    return [f"phase t {name}: {what} {n} B a rank above its "
            f"{b / u:.{d}f} x {u:g} B before"
            for what, n, b, (u, d) in zip(("peak", "all-gather", "wire"),
                                          now, before, DRYRUN_BEFORE_DIGITS)
            if round(n / u, d) > round(b / u, d)]


def dryrun_sweep(card: str, jobs: tuple = (),
                 capacity: int | None = None) -> tuple:
    """Phase t's pool (:func:`_run_jobs`, ``min(os.cpu_count(), 16)``
    workers): ``jobs``, phase t's own, then the
    sweep, a ``pair`` job for each pair of :func:`dryrun_pairs` cut to
    :data:`DRYRUN_SWEEP_LAYERS` layers, the train steps first (the longest
    traces).  Prints one line a pair and the sweep's wall time -> ({job:
    result} for ``jobs``, the sweep's {pairs, wall_s}).  Fails if a job of
    ``jobs`` fails, a pair raises or counts no collective, or, on
    :data:`DRYRUN_SWEEP_TORCH`, a pair's peak, all-gather or wire bytes a
    rank rise above its :data:`DRYRUN_SWEEP_BEFORE` or its peak a rank
    exceeds ``capacity`` bytes (the card's memory, where given); or, on
    any torch, a pair all-gathers more than its
    :data:`DRYRUN_SWEEP_REFERENCE` (but the pairs of
    :data:`DRYRUN_SWEEP_GATHER_EXEMPT`) or moves more wire bytes, a pair of
    :data:`DRYRUN_SWEEP_PEAK_HELD` peaks above the reference's argument +
    temp bytes, or a pair of :data:`DRYRUN_SWEEP_HEAD_ROWS` runs an
    attention core on other (heads, rows) than its own.  With no
    ``jobs`` it is the sweep alone: a rehearsal on a host without a card
    (the dry-run needs none)."""
    import torch
    from repro_torch.configs import get_shape
    workers = min(os.cpu_count(), 16)
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    order = {"train": 0, "prefill": 1}
    pairs = sorted(dryrun_pairs(),
                   key=lambda p: order.get(get_shape(p[1]).kind, 2))
    sweep_jobs = [f"pair {a} {s} {m}" for a, s, m in pairs]
    t0 = time.perf_counter()
    results, failures, seconds = _run_jobs(list(jobs) + sweep_jobs, workers,
                                           out_dir)
    wall = time.perf_counter() - t0
    own = {j: failures[j] for j in jobs if j in failures}
    if own:
        raise AssertionError("phase t " + "\n".join(
            f"{job}: {why}" for job, why in own.items()))
    gated = torch.__version__.startswith(DRYRUN_SWEEP_TORCH)
    rows, bad = [], {j: failures[j] for j in sweep_jobs if j in failures}

    def fail(job: str, why: str) -> None:
        bad[job] = f"{bad[job]}; {why}" if job in bad else why

    for job in sweep_jobs:
        if job in bad:
            continue
        r = {**results[job], "job_s": seconds[job]}
        key = f"{r['arch']} {r['shape']} {r['mesh']}"
        ref_mem, ref_ag, ref_wire = DRYRUN_SWEEP_REFERENCE[key]
        log(f"phase t pair {r['arch']} x {r['shape']} x {r['mesh']} "
            f"({r['layers']} layers) per rank [{card}]: "
            f"trace_s={r['trace_s']:.2f} peak {r['peak_bytes'] / 1e9:.3f} GB "
            f"= {r['peak_bytes']} B, alias {r['memory']['alias_bytes']} B "
            f"(reference args + temps {ref_mem / 1e9:.3f}) all-gather "
            f"{r['all_gather']:.0f} B ({ref_ag:.0f}) wire "
            f"{r['wire_bytes']:.0f} B ({ref_wire:.0f}) "
            f"collectives={json.dumps(r['counts'], sort_keys=True)}")
        if not sum(r["counts"].values()) > 0:
            fail(job, "no collective counted")
        if gated and key in DRYRUN_SWEEP_BEFORE:
            rises = _rises(f"pair {key}", (r["peak_bytes"], r["all_gather"],
                                            r["wire_bytes"]),
                           DRYRUN_SWEEP_BEFORE[key])
            if rises:
                fail(job, "; ".join(rises))
        if key in DRYRUN_SWEEP_GATHER_EXEMPT:
            log(f"phase t pair {key}: all-gathers not held to the "
                f"reference's: {DRYRUN_SWEEP_GATHER_EXEMPT[key]}; attention "
                f"cores on (q heads, rows) {r['attn_cores']}")
        elif r["all_gather"] > ref_ag:
            fail(job, f"all-gathers {r['all_gather']} B a rank over the "
                        f"reference's {ref_ag} B")
        if r["wire_bytes"] > ref_wire:
            fail(job, f"wire {r['wire_bytes']} B a rank over the "
                        f"reference's {ref_wire} B")
        if key in DRYRUN_SWEEP_PEAK_HELD and r["peak_bytes"] > ref_mem:
            fail(job, f"peak {r['peak_bytes']} B a rank over the "
                        f"reference's argument + temp {ref_mem} B")
        if key in DRYRUN_SWEEP_HEAD_ROWS and \
                r["attn_cores"] != [DRYRUN_SWEEP_HEAD_ROWS[key]]:
            fail(job, f"attention cores on (heads, rows) {r['attn_cores']}"
                        f", want {DRYRUN_SWEEP_HEAD_ROWS[key]} each")
        if gated and capacity is not None and r["peak_bytes"] > capacity:
            fail(job, f"peak {r['peak_bytes']} B a rank over the card's "
                        f"{capacity} B")
        rows.append(r)
    gate = ("each held to DRYRUN_SWEEP_BEFORE"
            + ("" if capacity is None else " and under the card's memory")
            if gated else f"no-rise gate off on torch {torch.__version__}")
    log(f"phase t sweep: {len(sweep_jobs) - len(bad)} of {len(sweep_jobs)} "
        f"pairs passed ({gate}) by {workers} worker processes, "
        f"{wall:.1f} s of wall time, "
        f"{sum(seconds.get(j, 0.0) for j in sweep_jobs):.1f} s in the "
        f"pairs' jobs")
    if bad:
        raise AssertionError("phase t sweep: " + "\n".join(
            f"{job}: {why}" for job, why in bad.items()))
    return ({j: results[j] for j in jobs},
            {"pairs": rows, "wall_s": wall})


def dryrun_path(card: str, paths: list, capacity: int) -> dict:
    """Phase t: the dry-run (``repro_torch.launch.dryrun``) on fake meshes,
    its jobs in the pool of :func:`dryrun_sweep`, before the sweep's: the
    counters' known answers, the six
    :data:`DRYRUN_CELLS` on the 16x16 and 2x16x16 meshes (each cell's
    per-rank peak, all-gather and all wire bytes printed beside
    :data:`DRYRUN_BEFORE` and :data:`DRYRUN_REFERENCE`, with the card's
    name and power limit, and its largest collective sites), the card's
    own train step (phase q) and mamba2 prefill traced on a one-rank mesh,
    whose roofline ``step_s`` is printed beside the seconds this run
    measured for them and the measured share of the bf16 peak, and the
    ``peak`` jobs of :data:`DRYRUN_PEAK_ENTRIES` (:func:`peak_report`,
    beside whether this torch's ``MemTracker`` leaves out another fake
    mode's ops).  Fails
    where :func:`dryrun_sweep` fails (a pair's peak a rank over
    ``capacity`` among them), if a cell's collective counts are
    empty, a term is not finite, a cell's peak, all-gather or wire bytes a
    rank rise above its :data:`DRYRUN_BEFORE`, a peak a rank of
    :data:`DRYRUN_FIT_CELLS` exceeds ``capacity`` bytes (the card's
    memory), a cell of :data:`DRYRUN_GATHER_CELLS` all-gathers more than
    the reference a rank, a cell of :data:`DRYRUN_NO_GATHER_IN` has an
    all-gather site in a function it names, a cell's wire bytes a rank
    exceed its :data:`DRYRUN_WIRE_BOUND`, a cell of
    :data:`DRYRUN_PADDED_HEADS` gives
    a model rank another SSD head count or has an all-gather site in
    ``models/ssm.py`` that moves, per call, as much as a rank's (B_l, S,
    d_inner / 16) bf16 x activation, or a cell of
    :data:`DRYRUN_OWN_Q_HEADS` gives a model rank another q head count
    or has an all-gather site in ``models/attention.py`` that moves, per
    call, as much as a rank's (B_l, S, H * Dh) bf16 q activation."""
    import statistics
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import N_SITES, PRODUCTION_MESHES
    from repro_torch.launch.roofline import PEAK_FLOPS_BF16
    t0 = time.perf_counter()
    import torch
    # the peak jobs first, the full depth's the longest trace
    jobs = ([f"peak {a} {s} {m} {n} {v}" for a, s, m, n in DRYRUN_PEAK_ENTRIES
             for v in (DRYRUN_PEAK_VARIANTS if n else ("as-traced",))]
            + [f"{a} {s} {int(mp)}" for a, s, mp in DRYRUN_CELLS]
            + ["calibrate train", "calibrate prefill", "counters"])
    results, sweep = dryrun_sweep(card, jobs, capacity)
    log("phase t counters: " + json.dumps(results["counters"]))
    tracker = mem_tracker_dispatch()
    log(f"phase t MemTracker.__torch_dispatch__ of torch "
        f"{torch.__version__} leaves out another fake mode's ops: "
        f"{tracker['fake_mode_filter']}")
    peaks = peak_report(results, card)
    cells, rises = [], []
    for arch, shape, mp in DRYRUN_CELLS:
        r = results[f"{arch} {shape} {int(mp)}"]
        name = f"{arch} x {shape} x {r['mesh']}"
        if not sum(r["collective_counts"].values()) > 0:
            raise AssertionError(f"phase t {name}: no collective counted")
        _finite_terms(name, r)
        mem = r["memory_analysis"]
        log(f"phase t {name}: trace_s={r['trace_s']} lower_s={r['lower_s']} "
            f"bound={r['bound']} step_s={r['step_s']:.4g} "
            f"compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s "
            f"collective={r['collective_s']:.4g}s mfu={r['mfu']:.4g} "
            f"useful={r['useful_flops_ratio']:.4g} peak/rank="
            f"{mem['peak_bytes'] / 2**30:.2f} GiB ops={r['ops']} "
            f"collectives={json.dumps(r['collective_counts'])}")
        key = f"{arch} {shape}"
        gathered = r["collective_bytes_by_op"].get("all-gather", 0.0)
        wire = r["collective_wire_bytes"]
        ref = DRYRUN_REFERENCE[key]
        b_peak, b_ag, b_wire = (
            f"{v / u:.{d}f} {n}" for v, (u, d), n in zip(
                DRYRUN_BEFORE[key], DRYRUN_BEFORE_DIGITS, ("GB", "MB", "GB")))
        rises += _rises(name, (mem["peak_bytes"], gathered, wire),
                        DRYRUN_BEFORE[key])
        j_mem, j_ag = (("not computed",) * 2 if ref is None else
                       (f"{ref[0] / 1e9:.2f} GB", f"{ref[1] / 1e6:.1f} MB"))
        log(f"phase t {name} per rank [{card}]: peak "
            f"{mem['peak_bytes'] / 1e9:.3f} GB (before {b_peak};"
            f" reference args + temps {j_mem}, XLA's CPU buffer "
            f"assignment on a host, which leaves out the outputs' "
            f"{mem['output_bytes'] / 1e9:.3f} GB: peak less outputs "
            f"{(mem['peak_bytes'] - mem['output_bytes']) / 1e9:.3f} GB), "
            f"all-gather {gathered / 1e6:.1f} MB "
            f"(before {b_ag}; reference {j_ag}), "
            f"wire {wire / 1e9:.4f} GB (before {b_wire})")
        log(f"phase t {name} collective sites (count, wire MB): " + "; ".join(
            f"{c['op']} at {c['site']} ({c['count']}, "
            f"{c['wire_bytes'] / 1e6:.2f})"
            for c in r["collective_sites"][:N_SITES]))
        for gate, wants in ((_padded_heads_gate, DRYRUN_PADDED_HEADS),
                            (_own_q_heads_gate, DRYRUN_OWN_Q_HEADS)):
            if key in wants:
                gate(name, r, get_config(arch), get_shape(shape),
                     PRODUCTION_MESHES[r["mesh"]], wants[key])
        if key in DRYRUN_FIT_CELLS and mem["peak_bytes"] > capacity:
            raise AssertionError(f"phase t {name}: peak {mem['peak_bytes']} "
                                 f"B a rank over the card's {capacity} B")
        own = [c for c in r["collective_sites"] if c["op"] == "all-gather"
               and c["site"].split(" < ")[0].split()[-1]
               in DRYRUN_NO_GATHER_IN.get(key, ())]
        if own:
            raise AssertionError(f"phase t {name}: all-gathers at {own}")
        if key in DRYRUN_GATHER_CELLS and gathered > ref[1]:
            raise AssertionError(f"phase t {name}: all-gathers {gathered} B "
                                 f"a rank over the reference's {ref[1]} B")
        if wire > DRYRUN_WIRE_BOUND.get(key, float("inf")):
            raise AssertionError(f"phase t {name}: wire bytes {wire} a rank "
                                 f"over {DRYRUN_WIRE_BOUND[key]}")
        cells.append(r)
    q_run = next(p for p in paths if p["model"] == TRAIN_ARCH
                 and p["path"].startswith("train "))
    pre = next(p for p in paths if p["model"] == LM_ARCH
               and p["path"] == "prefill bfloat16 (4, 2048)")
    measured = {"train": q_run["s_per_step"],
                "prefill": statistics.median(pre["prefill_s"])}
    calib = {}
    for which in ("train", "prefill"):
        r = results[f"calibrate {which}"]
        _finite_terms(f"calibration {which}", r)
        s = measured[which]
        share = r["model_flops"] / (s * PEAK_FLOPS_BF16)
        calib[which] = {**r, "measured_s": s, "measured_bf16_peak_share": share}
        log(f"phase t calibration {r['arch']} {which} {r['shape']}: roofline "
            f"step_s={r['step_s']:.4g} bound={r['bound']} "
            f"(compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s) "
            f"measured {s:.4g} s; model_flops={r['model_flops']:.4g}, "
            f"measured share of the bf16 peak {share:.4g} "
            f"(roofline mfu {r['mfu']:.4g}); trace_s={r['trace_s']:.1f} "
            f"[{card}]")
    if rises:
        raise AssertionError("\n".join(rises))
    wall = time.perf_counter() - t0
    log(f"phase t: {len(jobs) + len(sweep['pairs'])} jobs, {wall:.1f} s")
    return {"counters": results["counters"], "cells": cells,
            "calibration": calib, "sweep": sweep, "peaks": peaks,
            "mem_tracker": tracker, "phase_s": wall}


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
    from repro_torch.kernels.qconv_dw.ops import (dw_tiles, pick_blocks_dw,
                                                  qconv_dw,
                                                  qconv_dw_int8_act_plain)
    from repro_torch.kernels.qmatmul.ops import (pick_blocks, pick_tiles,
                                                 qgemm,
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
        static = pick_tiles(M, K, N)
        tuned = pick_blocks(M, K, N, 8, int8_act=True, timed=True)
        stat = _measure(lambda: qgemm(x, w, s, b, bits=8, packed=False,
                                      tiles=static, **epi), graph=True)
        kern = _measure(lambda: qgemm(x, w, s, b, bits=8, packed=False,
                                      **epi), graph=True)
        plain = _measure(lambda: qmatmul_int8_act_plain(
            x, 1.0, w, s, b, bits=8, packed=False, **epi), graph=True)
        lib = _int_mm_measure(x, w)
        row = dict(shape=[M, K, N], tiles=str(tuned),
                   static_tiles=str(static), kernel=kern, static=stat,
                   plain=plain, library=lib,
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
        oh, ow = -(-H // stride[0]), -(-W // stride[1])
        static = dw_tiles(C, ow, kh=3, kw=3, sw=stride[1], float_mode=False)
        tuned = pick_blocks_dw(B, H, W, C, kh=3, kw=3, strides=stride,
                               timed=True)
        stat = _measure(lambda: qconv_dw(x, w, s, b, tile=static, **epi),
                        graph=True)
        kern = _measure(lambda: qconv_dw(x, w, s, b, **epi), graph=True)
        plain = _measure(lambda: qconv_dw_int8_act_plain(x, 1.0, w, s, b,
                                                         **epi), graph=True)
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wf = w.t().reshape(C, 1, 3, 3).float().contiguous()
        lib = _measure(lambda: F.conv2d(xf, wf, stride=stride, padding=1,
                                        groups=C), graph=True)
        row = dict(shape=[B, H, W, C], strides=list(stride),
                   tiles=list(tuned), static_tiles=list(static),
                   kernel=kern, static=stat, plain=plain, library=lib,
                   **_bound(B * H * W * C + 9 * C + 8 * C + B * oh * ow * C,
                            2 * 9 * B * oh * ow * C))
        rows["qconv_dw"].append(row)
    rows.update(times_im2col(g, dev))
    rows.update(times_qmatmul(g, dev))
    rows.update(times_float(g, dev))
    rows.update(times_ssd(dev))
    rows.update(times_attention(dev))
    rows.update(times_moe(dev))
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


# (M, K, N) of the dequant matmul's timed calls: mnist-cnn's FC at batch 8
# (the skinny mapping) and its conv1 as an im2col matmul
QMATMUL_TIMED_SHAPES = ((8, 1568, 10), (1568, 144, 32))


def times_qmatmul(g, dev) -> dict:
    """The dequant matmul ``qmatmul`` (f32 activations rounded to bf16, W8
    codes, no epilogue) at :data:`QMATMUL_TIMED_SHAPES`, beside its plain
    version and ``torch.matmul`` on the bf16-rounded x and the dequantized
    weights (TF32 off), with its bound: x, codes and scale read once and
    the f32 output written once, or the product at the f32 rate."""
    import torch
    from repro_torch.kernels.qmatmul.ops import (pick_tiles, qmatmul,
                                                 qmatmul_plain)
    from repro_torch.quant.ptq import derive_view
    rows = {"qmatmul": []}
    for M, K, N in QMATMUL_TIMED_SHAPES:
        x = torch.randn((M, K), generator=g).to(dev)
        w = torch.randint(-127, 128, (K, N), generator=g,
                          dtype=torch.int8).to(dev)
        s = (torch.rand((N,), generator=g) * 1e-2).to(dev)
        xb = x.to(torch.bfloat16).to(torch.float32)
        wf = derive_view(w, 8).to(torch.float32) * s
        rows["qmatmul"].append(dict(
            shape=[M, K, N], tiles=str(pick_tiles(M, K, N, float_mode=True)),
            kernel=_measure(lambda: qmatmul(x, w, s, bits=8), graph=True),
            plain=_measure(lambda: qmatmul_plain(x, w, s, bits=8),
                           graph=True),
            library=_measure(lambda: torch.matmul(xb, wf), graph=True),
            **_bound(4 * M * K + K * N + 4 * N + 4 * M * N, 2 * M * K * N,
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
    from repro_torch.kernels.qconv_dw.ops import (dw_tiles, pick_blocks_dw,
                                                  qconv_dw_f32,
                                                  qconv_dw_float_plain)
    from repro_torch.kernels.qmatmul.ops import (pick_blocks, pick_tiles,
                                                 qgemm_f32,
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
        static = pick_tiles(M, K, N, float_mode=True)
        tuned = pick_blocks(M, K, N, 8, int8_act=False, timed=True)
        stat = _measure(lambda: qgemm_f32(x, w, s, b, bits=8, packed=False,
                                          tiles=static, **epi), graph=True)
        kern = _measure(lambda: qgemm_f32(x, w, s, b, bits=8, packed=False,
                                          **epi), graph=True)
        plain = _measure(lambda: qgemm_float_plain(x, w, s, b, bits=8,
                                                   packed=False, **epi),
                         graph=True)
        lib = _measure(lambda: torch.matmul(x, wf), graph=True)
        rows["qgemm_f32"].append(dict(
            shape=[M, K, N], tiles=str(tuned), static_tiles=str(static),
            kernel=kern, static=stat, plain=plain, library=lib,
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
        oh, ow = -(-H // stride[0]), -(-W // stride[1])
        static = dw_tiles(C, ow, kh=3, kw=3, sw=stride[1], float_mode=True)
        tuned = pick_blocks_dw(B, H, W, C, kh=3, kw=3, strides=stride,
                               int8_act=False, timed=True)
        stat = _measure(lambda: qconv_dw_f32(x, w, s, b, tile=static,
                                             **common), graph=True)
        kern = _measure(lambda: qconv_dw_f32(x, w, s, b, **common),
                        graph=True)
        plain = _measure(lambda: qconv_dw_float_plain(x, w, s, b, **common),
                         graph=True)
        xf = x.permute(0, 3, 1, 2).contiguous()
        wf = (w.float() * s).t().reshape(C, 1, 3, 3).contiguous()
        lib = _measure(lambda: F.conv2d(xf, wf, stride=stride, padding=1,
                                        groups=C), graph=True)
        rows["qconv_dw_f32"].append(dict(
            shape=[B, H, W, C], strides=list(stride), tiles=list(tuned),
            static_tiles=list(static), kernel=kern, static=stat,
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
                    itemsize: int = 2, causal: bool = True) -> dict:
    """The least time for one layer's prefill attention from q, k, v (after
    RoPE) to its output: bytes are q, k, v and the output, each once;
    operations are q.k and p.v over the (query, key) pairs the causal
    (and window) mask keeps, every pair without one, as multiply-adds over
    989 bf16 TFLOP/s."""
    w = S if window is None else min(window, S)
    pairs = sum(min(i + 1, w) for i in range(S)) if causal else S * S
    nbytes = itemsize * B * S * Dh * (2 * H + 2 * Hkv)
    return _bound(nbytes, 4 * B * H * pairs * Dh, BF16_FLOPS_PER_S)


def times_attention(dev) -> dict:
    """One layer's attention prefill (``attention.attend``, from q, k, v
    after RoPE to the output before ``wo``) at the (4, 2048) bf16 prefill
    calls of hymba-1.5b (GQA 25/5, window 2048: the banded schedule) and
    qwen1.5-0.5b (16 heads: the chunked schedule), and at whisper-base's
    non-causal encoder call (4, 1500, 8 heads: unchunked), beside
    ``F.scaled_dot_product_attention`` on the same q, k and v (a yardstick
    only: the port never calls it) and the bound of the work."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.attention import attend, prefill_route
    rows = []
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    for arch, S, causal in ((HYBRID_ARCH, 2048, True),
                            (DENSE_ARCH, 2048, True),
                            (AUDIO_ARCH, 1500, False)):
        cfg = get_config(arch)
        B, H, Hkv, Dh = 4, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
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
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=Hkv != H)

        out = attend(q, k, v, pos, pos, cfg, causal)
        diff = float((out.float() - lib().transpose(1, 2).float()).abs()
                     .max())
        row = dict(model=arch, shape=[B, S, H, Hkv, Dh], window=win,
                   causal=causal, route=prefill_route(cfg, S, causal),
                   dtype="bfloat16",
                   kernel=_measure(lambda: attend(q, k, v, pos, pos, cfg,
                                                  causal), 10),
                   library=_measure(lib, 20), sdpa_max_abs_diff=diff,
                   **attention_bound(B, S, H, Hkv, Dh, win, causal=causal))
        log(f"time attention {arch} {row['route']} {row['shape']}: "
            f"{_ms(row['kernel'])} ms (SDPA {_ms(row['library'])} ms, bound "
            f"{row['bound_ms']} ms {row['bound_by']}, max |port - SDPA| "
            f"{diff})")
        rows.append(row)
        del q, k, v, qt, kt, vt, out
    return {"attention": rows}


def times_moe(dev) -> dict:
    """One layer's ``moe_block`` at granite-moe-3b-a800m's (4, 2048) bf16
    prefill call (40 experts top-8, capacity factor 1; seeded weights and
    input), beside the least time of the work this call's routing keeps:
    bytes are x, the router, the 40 experts' weights and y, each once;
    operations are the router product and each kept slot's three expert
    products, as multiply-adds over 989 bf16 TFLOP/s.  No single PyTorch
    call computes it (library None); 32 of these calls are granite's
    prefill MoE share."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    B, S, d, E, k, f = 4, 2048, cfg.d_model, m.n_experts, m.top_k, \
        m.d_ff_expert
    g = torch.Generator(device=dev).manual_seed(SEED + 13)

    def w(*shape):
        return (torch.randn(shape, generator=g, device=dev)
                * shape[-2] ** -0.5).to(torch.bfloat16)

    p = moe.MoELayerParams(router=w(d, E), w_gate=w(1, E, d, f),
                           w_up=w(1, E, d, f), w_down=w(1, E, f, d))
    x = torch.randn((B, S, d), generator=g, device=dev).to(torch.bfloat16)
    T = B * S
    cap = min(max(int(math.ceil(T * k * m.capacity_factor / E)), 1), T)
    _, experts, _ = moe.route(x.reshape(T, d), p.router, k)
    kept = int(torch.clamp(torch.bincount(experts.reshape(-1), minlength=E),
                           max=cap).sum())
    nbytes = 2 * (2 * T * d + d * E + 3 * E * d * f)
    ops = 2 * T * d * E + kept * 3 * 2 * d * f
    row = dict(model=MOE_ARCH, shape=[B, S, d, E, k, f], capacity=cap,
               kept_slots=kept, routed_slots=T * k, dtype="bfloat16",
               kernel=_measure(lambda: moe.moe_block(x, p, cfg), 10),
               library=None, **_bound(nbytes, ops, BF16_FLOPS_PER_S))
    log(f"time moe_block {MOE_ARCH} {row['shape']}: {_ms(row['kernel'])} ms "
        f"(bound {row['bound_ms']} ms {row['bound_by']}; {kept} of {T * k} "
        f"slots kept at capacity {cap})")
    return {"moe_block": [row]}


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
    ap.add_argument("--train-restart", action="store_true",
                    help="only the restart check of phase q (run by phase q "
                         "itself in a process of its own)")
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
    if args.train_restart:
        return train_restart_main()
    # a fresh tile cache of this run's own, which the autotune phase fills
    # and every later phase (and its second process) reads
    cache = ROOT / "build" / "chip_smoke" / "autotune.json"
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cache)
    from repro_torch.configs import get_config
    from repro_torch.kernels import checks
    from repro_torch.configs.mnist_cnn import CNNConfig
    from repro_torch.configs.separable_cnn import SeparableCNNConfig

    t_all = time.perf_counter()
    card = header()
    built = build()
    built["conv2d_stream"] = conv2d_stream_instances()
    sweeps = kernels_vs_plain()
    tuned = autotune_path()
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
             fleet_path("separable-cnn", sep_cfg, card),
             table2_path(mnist_cfg, card)]
    paths += lm_paths(get_config(LM_ARCH), card)
    # hymba's f32 check on 4 layers, window 64 and Q_CHUNK 64: the banded
    # prefill and a decode that wraps the ring buffer, at full width
    paths += lm_paths(get_config(HYBRID_ARCH), card, check=dict(
        seq=256, n_layers=4, sliding_window=64, q_chunk=64))
    paths += lm_paths(get_config(DENSE_ARCH), card)
    paths += lm_family_paths(card)
    paths += train_path(card)
    paths.append(ssm_train_path(card))
    paths += spmd_path(card)
    rows = times()
    dry = dryrun_path(card, paths,
                      torch.cuda.get_device_properties(0).total_memory)

    # the JSON row of each kernel and mode: the path run whose launches it
    # reports and the batch-8 call of that run it is timed at
    table = {
        "qgemm": ("qgemm.cu", "qmatmul/kernel.py:68",
                  "qtorch D8-W8 separable-cnn", 1),            # pw0
        "qgemm_f32": ("qgemm.cu", "qmatmul/kernel.py:68",
                      "qtorch D16-W8 separable-cnn", 1),       # pw0
        # the dequant matmul: bf16-rounded x, no epilogue; no path runs it
        "qmatmul": ("qgemm.cu", "qmatmul/kernel.py:68",
                    "Table II mnist-cnn", 0),                  # the FC
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
        if "static" in r:
            # the timed pick's time (``ms``) beside the static rule's, at
            # this row and at every other timed call of the kernel
            kernels[-1].update(
                tiles=r["tiles"], static_tiles=r["static_tiles"],
                static_ms=_ms(r["static"]),
                static_graph_ms=r["static"]["graph_ms"],
                tuned_rows=[dict(shape=t["shape"], tiles=t["tiles"],
                                 ms=_ms(t["kernel"]),
                                 graph_ms=t["kernel"]["graph_ms"],
                                 static_tiles=t["static_tiles"],
                                 static_ms=_ms(t["static"]),
                                 static_graph_ms=t["static"]["graph_ms"])
                            for t in rows[name]])
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
    # the dequant matmul's conv1 im2col call beside its FC row
    qmm = next(k for k in kernels if k["name"] == "qmatmul")
    qmm["rows"] = [dict(shape=r["shape"], ms=_ms(r["kernel"]),
                        graph_ms=r["kernel"]["graph_ms"],
                        plain_ms=_ms(r["plain"]), library_ms=_ms(r["library"]),
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        tiles=r["tiles"])
                   for r in rows["qmatmul"]]
    qmm["max_tol_frac"] = sweeps["qmatmul"]["max_tol_frac"]
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
    # phase s: the same scan on each rank's local heads under local_map
    mesh_run = next(p for p in paths if p["path"].startswith("mesh ")
                    and " prefill " in p["path"])
    kernels[-1]["mesh"] = dict(
        path=f"{mesh_run['path']} {mesh_run['model']}", route="local_map",
        launches=mesh_run["launches"]["ssd_scan"],
        phases={name: mesh_run["launches"][f"ssd_scan.{name}"]
                for name in SSD_PHASES})
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
              "autotune": tuned, "main_paths": paths, "times": rows,
              "dryrun": dry,
              "table2": next(p for p in paths if p["path"] == "Table II"),
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
        if "encoder_frames_per_s" in p:
            log(f"LM {p['model']} encoder: {p['encoder_frames_per_s']:.1f} "
                "frames/s")
    q_run = next(p for p in paths if p["model"] == TRAIN_ARCH
                 and p["path"].startswith("train "))
    s_run = next(p for p in paths if p["model"] == TRAIN_ARCH
                 and p["path"].startswith("mesh ") and " train " in p["path"])
    log(f"train {TRAIN_ARCH}: phase q {q_run['s_per_step']:.3f} s/step, "
        f"peak {q_run['peak_memory_bytes']} B; phase s on the mesh "
        f"{s_run['s_per_step']:.3f} s/step (mesh=None "
        f"{s_run['s_per_step_mesh_none']:.3f}), peak "
        f"{s_run['peak_memory_bytes']} B")
    for r in rows["attention"]:
        log(f"attention {r['model']} {r['route']}: {_ms(r['kernel'])} ms, "
            f"SDPA {_ms(r['library'])} ms, bound {r['bound_ms']} ms")
    for r in rows["moe_block"]:
        log(f"moe_block {r['model']}: {_ms(r['kernel'])} ms, bound "
            f"{r['bound_ms']} ms")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
