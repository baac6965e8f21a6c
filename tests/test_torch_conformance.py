"""The reference's differential conformance suite (``tests/test_conformance
.py``) on the port: random Conv/Gemm/Pool graphs from a seed, the full pass
pipeline (``DesignFlow.run()``) against the raw node-by-node interpretation
(``run(passes=())``) at batch sizes {1, 3, 8} from ONE batch-polymorphic
artifact, the quantized pipeline and the stream target, the artifact's LRU,
serialization of the symbolic batch and the Reshape refusal.

Each graph is generated twice from the same seed, once with each package's
IR classes, from the same numpy draws; the inputs are numpy draws from the
seed (the reference draws them with ``jax.random``) fed to both packages.
The port runs on ``device="cpu"`` with target ``"torch"`` for ``"jax"``, and
its outputs are also held to the reference's: the float paths within
``1e-4 * max(1, max|y|)`` (f32 sums in another order), the D16-W16 path
within the property's own ``1e-2 * max(1, max|y|)`` (a fixed-16 rounding
step apart where an f32 sum lands on the other side of a tie).  When
``hypothesis`` is installed the seeds are drawn by hypothesis, otherwise a
pinned sweep runs, as in the reference.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ir as j_ir
from repro.core.flow import DesignFlow as JFlow
from repro.quant.qtypes import DatatypeConfig as JDT

from repro_torch.core import ir as t_ir
from repro_torch.core.flow import DesignFlow
from repro_torch.core.ir import BATCH, Graph, Node, TensorInfo, concretize
from repro_torch.quant.qtypes import DatatypeConfig

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

N_EXAMPLES = 10
BATCHES = (1, 3, 8)
J = SimpleNamespace(Graph=j_ir.Graph, Node=j_ir.Node, TensorInfo=j_ir.TensorInfo,
                    BATCH=j_ir.BATCH)
T = SimpleNamespace(Graph=t_ir.Graph, Node=t_ir.Node, TensorInfo=t_ir.TensorInfo,
                    BATCH=t_ir.BATCH)


def seeded_property(fn):
    """Run ``fn(seed)`` under hypothesis when available, else over a pinned
    seed sweep (same property, deterministic examples)."""
    if HAVE_HYPOTHESIS:
        return settings(max_examples=N_EXAMPLES, deadline=None)(
            given(st.integers(0, 2**31 - 1))(fn))
    return pytest.mark.parametrize("seed", [1000003 * i + 17
                                            for i in range(N_EXAMPLES)])(fn)


# ---------------------------------------------------------------------------
# random graph generator (the reference's, on either package's IR classes)
# ---------------------------------------------------------------------------

def random_graph(seed, pkg=T):
    """A random supported topology with a symbolic batch dim.

    CNN flavour: 1-2 blocks of Conv(SAME, stride 1)[+BN][+Relu][+MaxPool2x2]
    then Flatten+Gemm.  MLP flavour: Gemm/Relu stack.  The same seed gives
    the same topology and weights with either package's classes.
    """
    rng = np.random.default_rng(seed)
    nodes, inits = [], {}
    f32 = np.float32
    if rng.random() < 0.6:                                   # CNN flavour
        h = int(rng.choice([6, 8, 12]))
        cin = int(rng.choice([1, 2]))
        x = "input"
        in_shape = (pkg.BATCH, h, h, cin)
        for i in range(int(rng.integers(1, 3))):
            cout = int(rng.choice([2, 3, 4]))
            k = int(rng.choice([1, 3]))
            wn, bn = f"conv{i}/w", f"conv{i}/b"
            inits[wn] = (0.5 * rng.normal(size=(k, k, cin, cout))).astype(f32)
            inits[bn] = (0.2 * rng.normal(size=(cout,))).astype(f32)
            nodes.append(pkg.Node("Conv", f"conv{i}", [x, wn, bn],
                                  [f"conv{i}_out"],
                                  {"kernel_shape": [k, k], "pads": "SAME",
                                   "strides": [1, 1]}))
            x = f"conv{i}_out"
            if rng.random() < 0.5:
                for stat, v in (("scale", rng.uniform(0.5, 1.5, cout)),
                                ("bias", 0.2 * rng.normal(size=cout)),
                                ("mean", 0.2 * rng.normal(size=cout)),
                                ("var", rng.uniform(0.5, 2.0, cout))):
                    inits[f"bn{i}/{stat}"] = v.astype(f32)
                nodes.append(pkg.Node("BatchNormalization", f"bn{i}",
                                      [x] + [f"bn{i}/{s}" for s in
                                             ("scale", "bias", "mean",
                                              "var")],
                                      [f"bn{i}_out"], {"epsilon": 1e-5}))
                x = f"bn{i}_out"
            if rng.random() < 0.5:
                nodes.append(pkg.Node("Relu", f"relu{i}", [x],
                                      [f"relu{i}_out"]))
                x = f"relu{i}_out"
            if h % 2 == 0 and rng.random() < 0.7:
                nodes.append(pkg.Node("MaxPool", f"pool{i}", [x],
                                      [f"pool{i}_out"],
                                      {"kernel_shape": [2, 2],
                                       "strides": [2, 2]}))
                x = f"pool{i}_out"
                h //= 2
            cin = cout
        nodes.append(pkg.Node("Flatten", "flatten", [x], ["flat"]))
        feat = h * h * cin
        x = "flat"
    else:                                                    # MLP flavour
        feat = int(rng.choice([6, 10, 16]))
        in_shape = (pkg.BATCH, feat)
        x = "input"
        for i in range(int(rng.integers(1, 3))):
            hidden = int(rng.choice([4, 8, 12]))
            wn, bn = f"hid{i}/w", f"hid{i}/b"
            inits[wn] = (0.5 * rng.normal(size=(feat, hidden))).astype(f32)
            inits[bn] = (0.2 * rng.normal(size=(hidden,))).astype(f32)
            nodes.append(pkg.Node("Gemm", f"hid{i}", [x, wn, bn],
                                  [f"hid{i}_out"]))
            nodes.append(pkg.Node("Relu", f"hrelu{i}", [f"hid{i}_out"],
                                  [f"hrelu{i}_out"]))
            x, feat = f"hrelu{i}_out", hidden
    classes = int(rng.choice([3, 5]))
    inits["out/w"] = (0.5 * rng.normal(size=(feat, classes))).astype(f32)
    inits["out/b"] = (0.2 * rng.normal(size=(classes,))).astype(f32)
    nodes.append(pkg.Node("Gemm", "out", [x, "out/w", "out/b"], ["logits"]))
    g = pkg.Graph(f"rand{seed}", nodes, [pkg.TensorInfo("input", in_shape)],
                  ["logits"], inits)
    g.validate()
    return g


def _inputs_for(graph, seed):
    shape = concretize(graph.inputs[0].shape, max(BATCHES))
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(y):
    return y.numpy() if hasattr(y, "numpy") else np.asarray(y)


# ---------------------------------------------------------------------------
# differential properties
# ---------------------------------------------------------------------------

@seeded_property
def test_pipeline_matches_raw_interpretation(seed):
    """Full pass pipeline == raw interpretation (float), batch 1/3/8 from one
    batch-polymorphic artifact, with value_info agreeing at every batch;
    and the reference's full pipeline on the same graph and inputs."""
    g = random_graph(seed)
    flow = DesignFlow(g, device="cpu")
    x = _inputs_for(g, seed)
    raw = flow.run(passes=())
    full = flow.run()
    j_full = JFlow(random_graph(seed, J)).run()
    for b in BATCHES:
        y_raw = _np(raw.batched["torch"](x[:b]))
        y_full = _np(full.batched["torch"](x[:b]))
        scale = max(1.0, float(np.max(np.abs(y_raw))))
        np.testing.assert_allclose(y_full, y_raw, atol=1e-4 * scale,
                                   err_msg=f"seed={seed} batch={b}")
        np.testing.assert_allclose(
            y_full, np.asarray(j_full.batched["jax"](jnp.asarray(x[:b]))),
            atol=1e-4 * scale, err_msg=f"reference seed={seed} batch={b}")
        info = full.graph.value_info["logits"]
        assert info.shape[0] == BATCH
        assert concretize(info.shape, b) == y_full.shape
    # one artifact, three batches — each signature a miss once
    assert full.batched["torch"].cached_batches == BATCHES
    assert full.batched["torch"].misses == len(BATCHES)
    assert [n.op for n in full.graph.topo_order()] == \
        [n.op for n in j_full.graph.topo_order()]


@seeded_property
def test_quantized_pipeline_within_quant_tolerance(seed):
    """D16-W16 compiled pipeline stays within quantization tolerance of the
    raw float interpretation at every batch size, and of the reference's."""
    g = random_graph(seed)
    flow = DesignFlow(g, device="cpu")
    x = _inputs_for(g, seed)
    raw = flow.run(passes=())
    q = flow.run(dtconfig=DatatypeConfig(16, 16), calib_inputs=(x,))
    j_q = JFlow(random_graph(seed, J)).run(dtconfig=JDT(16, 16),
                                           calib_inputs=(jnp.asarray(x),))
    for b in BATCHES:
        y_raw = _np(raw.batched["torch"](x[:b]))
        y_q = _np(q.batched["torch"](x[:b]))
        scale = max(1.0, float(np.max(np.abs(y_raw))))
        assert float(np.max(np.abs(y_q - y_raw))) <= 1e-2 * scale, \
            f"seed={seed} batch={b}"
        y_j = np.asarray(j_q.batched["jax"](jnp.asarray(x[:b])))
        assert float(np.max(np.abs(y_q - y_j))) <= 1e-2 * scale, \
            f"reference seed={seed} batch={b}"


@seeded_property
def test_stream_target_matches_torch_target(seed):
    """The streaming target agrees with the reference target on the same
    compiled graph (float) for every generated topology and batch, and with
    the reference package's stream target."""
    g = random_graph(seed)
    res = DesignFlow(g, device="cpu").run(targets=("torch", "stream"))
    j_res = JFlow(random_graph(seed, J)).run(targets=("stream",))
    x = _inputs_for(g, seed)
    for b in BATCHES:
        y = _np(res.batched["stream"](x[:b]))
        np.testing.assert_allclose(y, _np(res.batched["torch"](x[:b])),
                                   atol=1e-4, err_msg=f"seed={seed} batch={b}")
        scale = max(1.0, float(np.max(np.abs(y))))
        np.testing.assert_allclose(
            y, np.asarray(j_res.batched["stream"](jnp.asarray(x[:b]))),
            atol=1e-4 * scale, err_msg=f"reference seed={seed} batch={b}")


def test_batched_executable_lru_evicts_oldest_trace():
    g = random_graph(3)
    res = DesignFlow(g, device="cpu").run(batch_cache=2)
    exe = res.batched["torch"]
    x = _inputs_for(g, 3)
    for b in (1, 3, 8):
        exe(x[:b])
    assert exe.cached_batches == (3, 8)       # batch 1 evicted (LRU)
    assert (exe.hits, exe.misses) == (0, 3)
    exe(x[:8])                                 # hit
    assert (exe.hits, exe.misses) == (1, 3)
    exe(x[:1])                                 # a miss again after eviction
    assert exe.misses == 4 and exe.cached_batches == (8, 1)


def test_symbolic_batch_survives_serialization(tmp_path):
    g = random_graph(11)
    path = str(tmp_path / "g.onnx.json")
    g.save(path)
    g2 = Graph.load(path)
    assert g2.inputs[0].shape == g.inputs[0].shape
    assert g2.inputs[0].is_batched
    res = DesignFlow(g2, device="cpu").run()
    y = res.batched["torch"](_inputs_for(g2, 11)[:3])
    assert y.shape == concretize(res.graph.value_info["logits"].shape, 3)
    # the reference reads the port's file as its own
    assert j_ir.Graph.load(path).to_json() == \
        random_graph(11, J).to_json()


def test_reshape_without_wildcard_rejected_on_symbolic_batch():
    """A fully-concrete Reshape target cannot carry the symbolic batch —
    shape inference must refuse rather than record stale annotations."""
    from repro_torch.core.passes.shape_infer import infer_shapes
    g = Graph("bad",
              [Node("Reshape", "r", ["input"], ["out"], {"shape": [3, 4]})],
              [TensorInfo("input", (BATCH, 2, 2))], ["out"])
    with pytest.raises(ValueError, match="wildcard"):
        infer_shapes(g)
