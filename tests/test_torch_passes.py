"""The reference's compiler-pass tests (``tests/test_passes.py``) on the
port: fusion numerics, DCE, constant folding, shape inference against
executed shapes, multi-output binding, precision assignment and the
mixed-precision explorer.  Each case builds its graph in both packages from
the same numpy arrays (the reference's ``PRNGKey`` draws become numpy draws
fed to both), asserts what the reference asserts on the port (target
``"jax"`` -> ``"torch"``, ``DesignFlow``/writers on ``device="cpu"``), and
holds the port's rewritten graph and outputs to the reference's: op lists
equal, float outputs within 1e-5 (1e-6 where the reference asserts it)."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.core import ir as j_ir
from repro.core import passes as j_passes
from repro.core.flow import DesignFlow as JFlow
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import mlp_to_ir as j_mlp_to_ir
from repro.core.writers.jax_writer import JaxWriter
from repro.models import cnn as j_cnn
from repro.quant.qtypes import DatatypeConfig as JDT
from repro.quant.qtypes import PrecisionMap as JPMap

from repro_torch.configs.mnist_cnn import CONFIG as T_CNN
from repro_torch.core.flow import DesignFlow
from repro_torch.core.ir import Graph, Node, TensorInfo
from repro_torch.core.passes import (PassManager, default_pipeline,
                                     eliminate_dead_nodes, fold_constants,
                                     fuse_conv_bn_relu, fuse_gemm_relu,
                                     infer_shapes, make_assign_precision,
                                     strip_precision)
from repro_torch.core.reader import cnn_to_ir, mlp_to_ir
from repro_torch.core.writers.torch_writer import TorchWriter
from repro_torch.quant.qtypes import DatatypeConfig, PrecisionMap

J = SimpleNamespace(Graph=j_ir.Graph, Node=j_ir.Node, TensorInfo=j_ir.TensorInfo)
T = SimpleNamespace(Graph=Graph, Node=Node, TensorInfo=TensorInfo)


def _run(graph, *xs):
    """The port's float reference writer on the CPU, as numpy."""
    out = TorchWriter(graph, device="cpu").build()(*xs)
    return out.numpy()


def _j_run(graph, *xs):
    return np.asarray(JaxWriter(graph).build()(*[jnp.asarray(x) for x in xs]))


def _ops(graph):
    return [n.op for n in graph.topo_order()]


@pytest.fixture(scope="module")
def cnn_graph():
    """(port graph, reference graph, x): the reference's init, batch 3."""
    params = {k: np.asarray(v) for k, v in
              j_cnn.init_params(J_CNN, jax.random.PRNGKey(0)).items()}
    x = np.random.default_rng(1).random((3, 28, 28, 1), np.float32)
    return (cnn_to_ir(T_CNN, params, batch=3),
            j_cnn_to_ir(J_CNN, params, batch=3), x)


@pytest.fixture(scope="module")
def mlp_graph():
    sizes = [12, 8, 5]
    rng = np.random.default_rng(0)
    params = {}
    for i in range(2):
        params[f"fc{i}/w"] = rng.normal(size=(sizes[i], sizes[i + 1])
                                        ).astype(np.float32)
        params[f"fc{i}/b"] = rng.normal(size=(sizes[i + 1],)).astype(
            np.float32)
    x = np.random.default_rng(2).standard_normal((2, 12)).astype(np.float32)
    return (mlp_to_ir(sizes, params, batch=2),
            j_mlp_to_ir(sizes, params, batch=2), x)


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

def test_fusion_matches_unfused_reference(cnn_graph):
    g, jg, x = cnn_graph
    ref = _run(g, x)
    fused = fuse_conv_bn_relu(g)
    assert _ops(fused) == ["FusedConv", "MaxPool"] * 2 + ["Flatten", "Gemm"]
    assert _ops(fused) == _ops(j_passes.fuse_conv_bn_relu(jg))
    out = _run(fused, x)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, _j_run(j_passes.fuse_conv_bn_relu(jg), x),
                               atol=1e-5)


def _chain(pkg, inits):
    return pkg.Graph("t", [
        pkg.Node("Conv", "c", ["input", "w", "b"], ["y"],
                 {"kernel_shape": [3, 3], "pads": "SAME", "strides": [1, 1]}),
        pkg.Node("BatchNormalization", "bn",
                 ["y", "scale", "bias", "mean", "var"], ["z"],
                 {"epsilon": 1e-5}),
        pkg.Node("Relu", "r", ["z"], ["out"]),
    ], [pkg.TensorInfo("input", (2, 8, 8, 1))], ["out"], dict(inits))


def test_fusion_direct_conv_bn_relu_chain():
    """Conv -> BN -> Relu with no interposed pool fuses to a single node."""
    rng = np.random.default_rng(1)
    c = 4
    inits = {
        "w": rng.normal(size=(3, 3, 1, c)).astype(np.float32),
        "b": rng.normal(size=(c,)).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": rng.normal(size=(c,)).astype(np.float32),
        "mean": rng.normal(size=(c,)).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
    }
    g = _chain(T, inits)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 1)).astype(
        np.float32)
    ref = _run(g, x)
    fused = eliminate_dead_nodes(fuse_conv_bn_relu(g))
    assert _ops(fused) == ["FusedConv"]
    assert fused.nodes[0].attrs["relu"] is True
    assert set(fused.initializers) == {"w", "b"}  # BN stats swept by DCE
    out = _run(fused, x)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    jf = j_passes.eliminate_dead_nodes(j_passes.fuse_conv_bn_relu(
        _chain(J, inits)))
    for k in ("w", "b"):       # the folded weights, rounded as the reference
        np.testing.assert_allclose(np.asarray(fused.initializers[k]),
                                   np.asarray(jf.initializers[k]), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(out, _j_run(jf, x), atol=1e-5)


def test_gemm_relu_fusion_matches_unfused(mlp_graph):
    """Gemm -> Relu folds into FusedGemm with identical numerics; the final
    Gemm (graph output, no Relu) stays untouched."""
    g, jg, x = mlp_graph
    ref = _run(g, x)
    fused = fuse_gemm_relu(g)
    assert _ops(fused) == ["FusedGemm", "Gemm"]
    fg = fused.topo_order()[0]
    assert fg.attrs["relu"] is True and fg.attrs["fused_from"] == ["relu0"]
    assert fg.attrs == j_passes.fuse_gemm_relu(jg).topo_order()[0].attrs
    np.testing.assert_array_equal(_run(fused, x), ref)


def test_gemm_relu_fusion_in_default_pipeline(mlp_graph):
    g, jg, x = mlp_graph
    res = DesignFlow(g, device="cpu").run(targets=("torch", "stream"))
    ops = _ops(res.graph)
    assert "FusedGemm" in ops and "Relu" not in ops
    raw = DesignFlow(g, device="cpu").run(targets=("torch",), passes=())
    np.testing.assert_allclose(res.executables["torch"](x).numpy(),
                               raw.executables["torch"](x).numpy(), atol=1e-6)
    # the stream topology sizes FusedGemm FIFOs with the matrix model
    # (whole per-item vector resident) just like Gemm
    topo = res.writers["stream"].topology()
    fg_conns = [c for c in topo["connections"]
                if c["dst"] == "fc0" and c["src"] == "input"]
    assert fg_conns and fg_conns[0]["depth"] == 12
    j_res = JFlow(jg).run(targets=("jax", "stream"))
    assert ops == _ops(j_res.graph)
    assert topo["connections"] == j_res.writers["stream"].topology()[
        "connections"]


def test_gemm_relu_fusion_skips_fanout_and_outputs():
    """A Gemm whose output feeds two consumers (or the graph output) must not
    fuse — the intermediate FIFO is observable."""
    rng = np.random.default_rng(2)
    inits = {"w/a": rng.normal(size=(4, 4)).astype(np.float32)}
    nodes = [
        Node("Gemm", "g0", ["x", "w/a"], ["h"]),
        Node("Relu", "r0", ["h"], ["r"]),
        Node("Add", "a0", ["h", "r"], ["y"]),     # second consumer of h
    ]
    g = Graph("fanout", nodes, [TensorInfo("x", (2, 4))], ["y"], inits)
    assert _ops(fuse_gemm_relu(g)) == ["Gemm", "Relu", "Add"]


def test_fusion_negative_bn_scale_across_pool_falls_back():
    """A negative BN scale does not commute with MaxPool — no fusion."""
    c = 2
    inits = {
        "w": np.ones((3, 3, 1, c), np.float32),
        "b": np.zeros((c,), np.float32),
        "scale": np.array([1.0, -1.0], np.float32),
        "bias": np.zeros((c,), np.float32),
        "mean": np.zeros((c,), np.float32),
        "var": np.ones((c,), np.float32),
    }
    g = Graph("t", [
        Node("Conv", "c", ["input", "w", "b"], ["y"],
             {"kernel_shape": [3, 3], "pads": "SAME", "strides": [1, 1]}),
        Node("MaxPool", "p", ["y"], ["yp"],
             {"kernel_shape": [2, 2], "strides": [2, 2]}),
        Node("BatchNormalization", "bn",
             ["yp", "scale", "bias", "mean", "var"], ["out"],
             {"epsilon": 1e-5}),
    ], [TensorInfo("input", (1, 8, 8, 1))], ["out"], inits)
    assert _ops(fuse_conv_bn_relu(g)) == \
        ["Conv", "MaxPool", "BatchNormalization"]


def _tied(pkg, inits):
    conv_attrs = {"kernel_shape": [3, 3], "pads": "SAME", "strides": [1, 1]}
    return pkg.Graph("t", [
        pkg.Node("Conv", "c1", ["input", "w", "b"], ["y1"], dict(conv_attrs)),
        pkg.Node("BatchNormalization", "bn",
                 ["y1", "scale", "bias", "mean", "var"], ["z"],
                 {"epsilon": 1e-5}),
        pkg.Node("Conv", "c2", ["input2", "w", "b"], ["y2"], dict(conv_attrs)),
        pkg.Node("Add", "sum", ["z", "y2"], ["out"]),
    ], [pkg.TensorInfo("input", (1, 8, 8, 1)),
        pkg.TensorInfo("input2", (1, 8, 8, 1))], ["out"], dict(inits))


def test_fusion_skips_tied_weights():
    """A weight initializer shared by two convs must not be rescaled."""
    c = 2
    inits = {
        "w": np.ones((3, 3, 1, c), np.float32),
        "b": np.zeros((c,), np.float32),
        "scale": np.ones((c,), np.float32),
        "bias": np.zeros((c,), np.float32),
        "mean": np.zeros((c,), np.float32),
        "var": np.full((c,), 3.0, np.float32),
    }
    g = _tied(T, inits)
    x = np.random.default_rng(4).standard_normal((1, 8, 8, 1)).astype(
        np.float32)
    ref = _run(g, x, x)
    fused = fuse_conv_bn_relu(g)
    assert all(n.op != "FusedConv" for n in fused.nodes)
    out = _run(fused, x, x)
    np.testing.assert_allclose(out, ref)
    np.testing.assert_allclose(out, _j_run(_tied(J, inits), x, x), atol=1e-5)


def test_calibration_ranges_are_float_ranges(cnn_graph):
    """run() must calibrate the float view of the compiled graph, not the
    already-quantized network (whose ranges are clipped to the 8.0 default)."""
    g, jg, x = cnn_graph
    flow = DesignFlow(g, device="cpu")
    big_x = x * 60.0  # drive activations well past the 8.0 fallback range
    res = flow.run(targets=("torch",), dtconfig=DatatypeConfig(8, 32),
                   calib_inputs=(big_x,))
    # res.graph carries dtconfig annotations; strip them for the float ref
    float_ranges = flow.calibrate(big_x, graph=strip_precision(res.graph))
    for k, v in float_ranges.items():
        assert res.act_ranges[k] == pytest.approx(v), k
    j_res = JFlow(jg).run(targets=("jax",), dtconfig=JDT(8, 32),
                          calib_inputs=(jnp.asarray(big_x),))
    assert set(res.act_ranges) == set(j_res.act_ranges)
    for k, v in j_res.act_ranges.items():
        assert res.act_ranges[k] == pytest.approx(v, rel=1e-5), k


# ---------------------------------------------------------------------------
# constant folding / DCE
# ---------------------------------------------------------------------------

def test_constant_folding_precomputes_weight_subgraph():
    inits = {"w": np.full((4, 4), 2.0, np.float32),
             "wa": np.full((4, 4), 0.5, np.float32),
             "b": np.zeros((4,), np.float32)}
    g = Graph("t", [
        Node("Add", "prep", ["w", "wa"], ["w_sum"]),
        Node("Gemm", "fc", ["input", "w_sum", "b"], ["out"]),
    ], [TensorInfo("input", (1, 4))], ["out"], inits)
    folded = eliminate_dead_nodes(fold_constants(g))
    assert _ops(folded) == ["Gemm"]
    np.testing.assert_allclose(folded.initializers["w_sum"],
                               np.full((4, 4), 2.5, np.float32))
    x = np.ones((1, 4), np.float32)
    np.testing.assert_allclose(_run(folded, x), _run(g, x))


def test_dce_removes_unreachable_nodes(mlp_graph):
    g, _, x = mlp_graph
    dead = Node("Relu", "dead_tap", ["fc0_out"], ["dead_out"])
    g2 = Graph(g.name, g.nodes + [dead], g.inputs, g.outputs,
               dict(g.initializers, unused=np.zeros((2, 2), np.float32)))
    cleaned = eliminate_dead_nodes(g2)
    names = [n.name for n in cleaned.nodes]
    assert "dead_tap" not in names
    assert "unused" not in cleaned.initializers
    assert len(names) == len(g.nodes)
    np.testing.assert_allclose(_run(cleaned, x), _run(g, x))


# ---------------------------------------------------------------------------
# shape inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["cnn", "mlp"])
def test_shape_inference_matches_executed_shapes(which, cnn_graph, mlp_graph):
    g, jg, x = cnn_graph if which == "cnn" else mlp_graph
    for graph, j_graph in ((g, jg), (PassManager(default_pipeline(None)).run(
            g), j_passes.PassManager(j_passes.default_pipeline(None)).run(
            jg))):
        infer_shapes(graph)
        _, env = TorchWriter(graph, device="cpu").build(capture=True)(x)
        for n in graph.nodes:
            for o in n.outputs:
                assert tuple(graph.value_info[o].shape) == \
                    tuple(env[o].shape), f"{which}:{o}"
        j_passes.infer_shapes(j_graph)
        assert {k: tuple(v.shape) for k, v in graph.value_info.items()} == \
            {k: tuple(v.shape) for k, v in j_graph.value_info.items()}


def test_shape_inference_explicit_asymmetric_pads():
    """ONNX explicit pads [t, l, b, r] are applied per axis."""
    g = Graph("t", [
        Node("Conv", "c", ["input", "w"], ["out"],
             {"kernel_shape": [3, 3], "pads": [1, 0, 1, 0],
              "strides": [1, 1]}),
    ], [TensorInfo("input", (1, 8, 10, 1))], ["out"],
        {"w": np.zeros((3, 3, 1, 2), np.float32)})
    infer_shapes(g)
    # H: 8 + (1+1) - 3 + 1 = 8 ; W: 10 + 0 - 3 + 1 = 8
    assert tuple(g.value_info["out"].shape) == (1, 8, 8, 2)
    x = np.ones((1, 8, 10, 1), np.float32)
    assert _run(g, x).shape == (1, 8, 8, 2)


# ---------------------------------------------------------------------------
# multi-output ops (Split) — regression for the outputs[0]-only bug
# ---------------------------------------------------------------------------

def test_split_binds_every_output():
    g = Graph("t", [
        Node("Split", "sp", ["input"], ["a", "b"], {"axis": -1}),
        Node("Add", "sum", ["a", "b"], ["out"]),
    ], [TensorInfo("input", (2, 6))], ["out"])
    infer_shapes(g)
    assert tuple(g.value_info["a"].shape) == (2, 3)
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    np.testing.assert_allclose(_run(g, x), x[:, :3] + x[:, 3:])


# ---------------------------------------------------------------------------
# precision assignment + exploration
# ---------------------------------------------------------------------------

def test_assign_precision_is_functional(mlp_graph):
    g, _, _ = mlp_graph
    pm = PrecisionMap(DatatypeConfig(16, 8), {"fc1": DatatypeConfig(16, 4)})
    g2 = make_assign_precision(pm)(g)
    assert all(n.dtconfig is None for n in g.nodes)        # original untouched
    assert {n.name: n.dtconfig for n in g2.nodes}["fc1"] == \
        DatatypeConfig(16, 4)
    assert {n.name: n.dtconfig for n in g2.nodes}["fc0"] == \
        DatatypeConfig(16, 8)


def test_explorer_returns_runnable_heterogeneous_map(mlp_graph):
    g, jg, x = mlp_graph
    flow = DesignFlow(g, device="cpu")
    pm, history = flow.explore_mixed_precision((x,), ladder=(16, 8, 4),
                                               tol=0.5)
    assert isinstance(pm, PrecisionMap)
    assert set(pm.per_node) == {"fc0", "fc1"}
    assert history, "greedy search should accept at least one move"
    assert any(c.weight_bits < 16 for c in pm.per_node.values())
    res = flow.run(targets=("torch",), dtconfig=pm, calib_inputs=(x,))
    assert res.executables["torch"](x).shape == (2, 5)
    j_pm, _ = JFlow(jg).explore_mixed_precision((jnp.asarray(x),),
                                                ladder=(16, 8, 4), tol=0.5)
    assert isinstance(j_pm, JPMap)
    assert pm.name == j_pm.name
    assert torch.is_tensor(res.executables["torch"](x))
