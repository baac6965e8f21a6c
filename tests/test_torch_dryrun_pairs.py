"""The dry-run's (cell, mesh) pairs that need the layout pins, cut to one
layer (whisper's encoder too), traced through ``launch.dryrun.trace_pair``
on the fake production meshes and held against the reference's program
(``scripts/dryrun_parity.py --reference-only`` in a subprocess a mesh: the
HLO of the same cut cells, XLA's CPU buffer assignment on the host).

* qwen1.5-0.5b prefill_32k on 16x16 counts the reference's collectives op
  for op: the residual stays batch-sharded and whole over 'model', one
  all-reduce a row-parallel product.
* whisper-base prefill_32k on 16x16: its 8 heads on model 16 (2 ranks a
  head, 2 rows a data rank) are scored each on one rank of its head for
  one row, q, k and v and the cross k/v traded over the head's 2 ranks
  (``attention.row_exchange``).  No more all-reduces than the
  reference's, wire bytes and peak at or under its.
* qwen1.5-0.5b train_4k on 16x16: the residual pins hold their
  cotangents (``sharding.pin_residual``), so the backward's gradients
  keep the residual's layout and are not reduce-scattered and gathered
  again in the layer below.  All-gathers and wire bytes a rank at or
  under the reference's.
* whisper-base train_4k on 16x16 and 2x16x16: every attention core on
  the traced rank scores one head of half of the rank's rows (the same
  trade); all-gathers and the peak a rank at or under the reference's
  all-gathers and argument + temp bytes.
* whisper-base prefill_32k on 2x16x16: 1 row a data rank, which the 2
  ranks of a head cannot split, so they split its query positions
  (``attention.query_exchange``): every core scores one head of the one
  row, the only all-gathers are one head's k and v over its 2 ranks, wire
  bytes and peak at or under the reference's (which gathers nothing and
  all-reduces the f32 scores).
* mamba2-1.3b and phi-3-vision-4.2b train_4k on 2x16x16: the cotangents of
  the SSM's inner activations and of the projected patches are pinned, as
  the reference's constraints pin their transposes.  Wire bytes at or
  under the reference's; mamba2's all-gathers too, phi-3-vision's peak
  and all-gathers.
* mixtral-8x7b train_4k on 16x16: its 32 q heads and 8 kv heads run the
  attention core on each rank's own 2 q heads (``attention._on_own_q_heads``),
  with no q activation gathered in ``models/attention.py``, against the
  one kv head gathered over its 2 model ranks
  (``attention._on_kv_head_group``).
  All-gathers, wire bytes and the peak a rank at or under the
  reference's.

Each pair must count at least one collective and a finite peak a rank.
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.models import attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = 1
# the reference's cells, by mesh
REFERENCE_CELLS = {"16x16": ("qwen1.5-0.5b:prefill_32k",
                             "qwen1.5-0.5b:train_4k",
                             "whisper-base:prefill_32k",
                             "whisper-base:train_4k",
                             "mixtral-8x7b:train_4k"),
                   "2x16x16": ("mamba2-1.3b:train_4k",
                               "phi-3-vision-4.2b:train_4k",
                               "whisper-base:train_4k",
                               "whisper-base:prefill_32k")}


@pytest.fixture(scope="module")
def reference():
    """``reference(mesh)`` -> the reference's figures a rank ({arch:
    {args_temps, all_gather, wire_bytes, counts}}) of
    :data:`REFERENCE_CELLS` on ``mesh`` at :data:`LAYERS` layer, compiled
    in a subprocess a mesh, both started when the first test asks; the
    port's traces run meanwhile."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    procs = {
        mesh: subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "dryrun_parity.py"),
             "--reference-only", "--layers", str(LAYERS),
             *(["--multi-pod"] if mesh == "2x16x16" else []),
             *(f"--cell={c}" for c in cells)],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        for mesh, cells in REFERENCE_CELLS.items()}
    results = {}

    def get(mesh):
        if mesh not in results:
            out, err = procs[mesh].communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.startswith("REF ")]
            assert procs[mesh].returncode == 0 and lines, err[-4000:]
            results[mesh] = json.loads(lines[-1][4:])
        return results[mesh]

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _trace(arch: str, shape: str, mesh: str) -> dict:
    """The port's pair cut to :data:`LAYERS` layer; fails unless it counts
    a collective and a finite peak a rank."""
    traced = D.trace_pair(arch, shape, mesh, LAYERS)
    assert sum(traced["counts"].values()) > 0, traced["counts"]
    assert math.isfinite(traced["peak_bytes"])
    return traced


def test_dense_prefill_counts_the_references_collectives(reference):
    """qwen1.5-0.5b prefill_32k on 16x16: the reference's counts op for op
    (an all-reduce at each of the layer's two row-parallel products, one
    at the head)."""
    traced = _trace("qwen1.5-0.5b", "prefill_32k", "16x16")
    want = reference("16x16")["qwen1.5-0.5b:prefill_32k"]["counts"]
    assert traced["counts"] == want


def test_whisper_prefill_traces(reference):
    """whisper-base prefill_32k on 16x16 (8 kv heads in the cross k/v): no
    more all-reduces than the reference, its wire bytes and peak at or
    under the reference's."""
    traced = _trace("whisper-base", "prefill_32k", "16x16")
    ref = reference("16x16")["whisper-base:prefill_32k"]
    got = traced["counts"].get("all-reduce", 0)
    assert got <= ref["counts"]["all-reduce"], (traced["counts"], ref)
    assert traced["wire_bytes"] <= ref["wire_bytes"], (traced, ref)
    assert traced["peak_bytes"] <= ref["args_temps"], (traced, ref)


def test_dense_train_step_gathers_no_more_than_the_reference(reference):
    """qwen1.5-0.5b train_4k on 16x16: with the residual's cotangent held
    where its forward is pinned, the backward no longer reduce-scatters
    and re-gathers each layer's gradients; all-gather and wire bytes a
    rank at or under the reference's."""
    traced = _trace("qwen1.5-0.5b", "train_4k", "16x16")
    ref = reference("16x16")["qwen1.5-0.5b:train_4k"]
    assert traced["all_gather"] <= ref["all_gather"], (traced, ref)
    assert traced["wire_bytes"] <= ref["wire_bytes"], (traced, ref)


def _counted_attend(monkeypatch) -> list:
    """(rows, q heads) of every attention core run from here on, on the
    traced rank."""
    seen = []
    attend = attention.attend

    def counted(q, *args, **kwargs):
        seen.append((q.shape[0], q.shape[2]))
        return attend(q, *args, **kwargs)

    monkeypatch.setattr(attention, "attend", counted)
    return seen


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_whisper_train_step_traces(reference, monkeypatch, mesh):
    """whisper-base train_4k (8 heads, 2 ranks a head on model 16): every
    attention core on the traced rank (the encoder's, the decoder's self-
    and cross-attention, forward and remat) scores one head of half of
    the rank's rows; all-gathers and the peak a rank at or under the
    reference's all-gathers and argument + temp bytes."""
    seen = _counted_attend(monkeypatch)
    traced = _trace("whisper-base", "train_4k", mesh)
    rows = get_shape("train_4k").global_batch // math.prod(
        D.PRODUCTION_MESHES[mesh][:-1]) // 2
    # the encoder's layer, the decoder's self- and cross-attention, each
    # in the forward and again in its backward (remat)
    assert seen == [(rows, 1)] * (2 * 3 * LAYERS), seen
    ref = reference(mesh)["whisper-base:train_4k"]
    assert traced["all_gather"] <= ref["all_gather"], (traced, ref)
    assert traced["peak_bytes"] <= ref["args_temps"], (traced, ref)


def test_whisper_prefill_splits_queries_on_two_pods(reference, monkeypatch):
    """whisper-base prefill_32k on 2x16x16: every attention core on the
    traced rank (the encoder's, the decoder's self- and cross-attention)
    scores one head of the one row; the all-gathers are exactly one
    head's k and v a core over its 2 ranks (half the gathered bytes on
    the wire); wire bytes and the peak a rank at or under the reference's
    wire and argument + temp bytes."""
    seen = _counted_attend(monkeypatch)
    traced = _trace("whisper-base", "prefill_32k", "2x16x16")
    assert seen == [(1, 1)] * (3 * LAYERS), seen
    cfg, S = get_config("whisper-base"), get_shape("prefill_32k").seq_len
    kv = (2 * S + 4 * cfg.enc_seq) * cfg.head_dim * 2 // 2
    assert traced["all_gather"] == LAYERS * kv, traced
    assert traced["counts"]["all-gather"] == 6 * LAYERS, traced["counts"]
    ref = reference("2x16x16")["whisper-base:prefill_32k"]
    assert traced["wire_bytes"] <= ref["wire_bytes"], (traced, ref)
    assert traced["peak_bytes"] <= ref["args_temps"], (traced, ref)


# the figures a rank of a train step on 2x16x16 held at or under the
# reference's (a peak under the reference's argument + temp bytes)
TRAIN_HELD = {"mamba2-1.3b": ("wire_bytes", "all_gather"),
              "phi-3-vision-4.2b": ("wire_bytes", "peak_bytes", "all_gather")}


@pytest.mark.parametrize("arch", sorted(TRAIN_HELD))
def test_train_step_traces_on_two_pods(reference, arch):
    """The train step of the SSM and of the vision stub on 2x16x16: each
    figure of its :data:`TRAIN_HELD` at or under the reference's."""
    traced = _trace(arch, "train_4k", "2x16x16")
    ref = reference("2x16x16")[f"{arch}:train_4k"]
    for k in TRAIN_HELD[arch]:
        want = ref["args_temps" if k == "peak_bytes" else k]
        assert traced[k] <= want, (k, traced, ref)


def test_eight_kv_head_train_step_still_traces(reference, monkeypatch):
    """mixtral-8x7b train_4k on 16x16 (32 q heads, 8 kv heads): every
    attention core on the traced rank scores its own 2 q heads; no
    all-gather site in ``models/attention.py`` moves (per call) as much as
    a rank's (B_l, S, H * Dh) bf16 q activation; its all-gathers, wire
    bytes and peak a rank at or under the reference's all-gathers, wire
    and argument + temp bytes."""
    seen = _counted_attend(monkeypatch)
    cfg = D.cut_layers(get_config("mixtral-8x7b"), LAYERS)
    shape = get_shape("train_4k")
    traced = D.trace_cell(cfg, shape, D.PRODUCTION_MESHES["16x16"],
                          n_sites=None)
    coll = traced["collective"]
    assert sum(coll.counts.values()) > 0, coll.counts
    # each layer's forward, and again in its backward (remat)
    heads = [h for _, h in seen]
    assert heads == [2] * (2 * LAYERS), heads
    q_act = shape.global_batch // 16 * shape.seq_len * cfg.q_dim * 2
    sites = [s for s in traced["sites"] if s["op"] == "all-gather"
             and "models/attention.py" in s["site"]]
    for s in sites:
        assert s["wire_bytes"] / s["count"] < q_act, s
    ref = reference("16x16")["mixtral-8x7b:train_4k"]
    gathered = coll.bytes_by_op.get("all-gather", 0.0)
    assert gathered <= ref["all_gather"], (gathered, ref)
    assert coll.wire_bytes <= ref["wire_bytes"], (coll.wire_bytes, ref)
    peak = traced["memory"]["peak_bytes"]
    assert peak <= ref["args_temps"], (peak, ref)
