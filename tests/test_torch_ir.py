"""The port's IR front end against the reference: readers, the default pass
pipeline (fusion, reorder, folding, DCE, shape inference, precision), and the
serialized graph — identical JSON and value_info for both CNNs and the MLP."""
import jax
import numpy as np
import pytest

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core import ir as j_ir
from repro.core import reader as j_reader
from repro.core.passes import PassManager as JPM
from repro.core.passes import default_pipeline as j_default
from repro.core.passes import structural_pipeline as j_structural
from repro.models import cnn as j_models
from repro.quant.qtypes import DatatypeConfig as JDT
from repro.quant.qtypes import PrecisionMap as JPMap

from repro_torch.configs.mnist_cnn import CONFIG as T_CNN
from repro_torch.configs.separable_cnn import CONFIG as T_SEP
from repro_torch.core import ir as t_ir
from repro_torch.core import reader as t_reader
from repro_torch.core.passes import PassManager as TPM
from repro_torch.core.passes import default_pipeline as t_default
from repro_torch.core.passes import structural_pipeline as t_structural
from repro_torch.models import cnn as t_models
from repro_torch.quant.qtypes import DatatypeConfig as TDT
from repro_torch.quant.qtypes import PrecisionMap as TPMap


def _mlp_params(sizes=(12, 16, 8, 4)):
    rng = np.random.default_rng(0)
    p = {}
    for i in range(len(sizes) - 1):
        p[f"fc{i}/w"] = rng.normal(size=(sizes[i], sizes[i + 1])).astype(
            np.float32)
        p[f"fc{i}/b"] = rng.normal(size=(sizes[i + 1],)).astype(np.float32)
    return sizes, p


def _pair(which, batch=None):
    """(reference graph, port graph) read from the same numpy params."""
    if which == "mnist-cnn":
        p = {k: np.asarray(v) for k, v in
             j_models.init_params(J_CNN, jax.random.PRNGKey(0)).items()}
        return (j_reader.cnn_to_ir(J_CNN, p, batch=batch),
                t_reader.cnn_to_ir(T_CNN, t_models.params_from_jax(p, "cpu"),
                                   batch=batch))
    if which == "separable-cnn":
        p = {k: np.asarray(v) for k, v in
             j_models.init_separable_params(J_SEP,
                                            jax.random.PRNGKey(1)).items()}
        return (j_reader.separable_cnn_to_ir(J_SEP, p, batch=batch),
                t_reader.separable_cnn_to_ir(
                    T_SEP, t_models.params_from_jax(p, "cpu"), batch=batch))
    sizes, p = _mlp_params()
    return (j_reader.mlp_to_ir(list(sizes), p, batch=batch),
            t_reader.mlp_to_ir(list(sizes), p, batch=batch))


def _same(jg, tg):
    assert tg.to_json() == jg.to_json()
    assert set(tg.initializers) == set(jg.initializers)
    for k, v in jg.initializers.items():
        assert tg.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(tg.initializers[k], v)


MODELS = ["mnist-cnn", "separable-cnn", "mlp"]


@pytest.mark.parametrize("which", MODELS)
@pytest.mark.parametrize("batch", [None, 3])
def test_reader_graphs_identical(which, batch):
    _same(*_pair(which, batch))


@pytest.mark.parametrize("which", MODELS)
@pytest.mark.parametrize("dt", [(8, 8), (16, 4), (32, 32)])
def test_default_pipeline_identical(which, dt):
    jg, tg = _pair(which)
    jo = JPM(j_default(JDT(*dt))).run(jg)
    to = TPM(t_default(TDT(*dt))).run(tg)
    _same(jo, to)
    assert {k: (tuple(v.shape), v.dtype) for k, v in to.value_info.items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in jo.value_info.items()}


@pytest.mark.parametrize("which", MODELS)
def test_structural_pipeline_and_precision_map_identical(which):
    jg, tg = _pair(which)
    _same(JPM(j_structural()).run(jg), TPM(t_structural()).run(tg))
    first = next(n.name for n in jg.nodes if n.op in ("Conv", "Gemm"))
    jo = JPM(j_default(JPMap(JDT(8, 8), {first: JDT(8, 2)}))).run(jg)
    to = TPM(t_default(TPMap(TDT(8, 8), {first: TDT(8, 2)}))).run(tg)
    _same(jo, to)


def test_fold_constants_and_json_roundtrip():
    """An all-constant subgraph folds to the same initializer; a graph
    serialized by the reference reads back identically in the port."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0
    c = np.full((3, 4), 0.25, np.float32)

    def build(ir):
        return ir.Graph(
            "fold", [ir.Node("Add", "add", ["w", "c"], ["wc"]),
                     ir.Node("Gemm", "fc", ["input", "wc"], ["logits"])],
            [ir.TensorInfo("input", (ir.BATCH, 3))], ["logits"],
            {"w": w, "c": c})

    jo = JPM(j_default(None)).run(build(j_ir))
    to = TPM(t_default(None)).run(build(t_ir))
    _same(jo, to)
    assert "wc" in to.initializers and len(to.nodes) == 1
    text = jo.to_json()
    _same(j_reader.read_json(text, dict(jo.initializers)),
          t_reader.read_json(text, dict(jo.initializers)))


def test_normalize_groups_depthwise():
    def build(ir, w):
        return ir.Graph(
            "g", [ir.Node("Conv", "dw", ["input", "w"], ["y"],
                          {"group": 4, "kernel_shape": [3, 3],
                           "pads": "SAME"})],
            [ir.TensorInfo("input", (ir.BATCH, 6, 6, 4))], ["y"], {"w": w})

    w = np.ones((3, 3, 1, 4), np.float32)
    jg = j_reader.normalize_groups(build(j_ir, w))
    tg = t_reader.normalize_groups(build(t_ir, w))
    assert tg.nodes[0].op == jg.nodes[0].op == "DepthwiseConv"
    with pytest.raises(ValueError, match="not depthwise"):
        t_reader.normalize_groups(build(t_ir, np.ones((3, 3, 2, 4),
                                                      np.float32)))


@pytest.mark.parametrize("which", ["mnist-cnn", "separable-cnn"])
def test_params_from_jax_checks_names_shapes_dtypes(which):
    if which == "mnist-cnn":
        p = {k: np.asarray(v) for k, v in
             j_models.init_params(J_CNN, jax.random.PRNGKey(0)).items()}
    else:
        p = {k: np.asarray(v) for k, v in
             j_models.init_separable_params(J_SEP,
                                            jax.random.PRNGKey(0)).items()}
    t = t_models.params_from_jax(p, "cpu")
    assert set(t) == set(p)
    shapes = t_models.param_shapes(T_SEP if which == "separable-cnn"
                                   else T_CNN)
    assert {k: tuple(v.shape) for k, v in t.items()} == shapes
    bad = dict(p)
    bad["fc/w"] = bad["fc/w"][:-1]
    with pytest.raises(ValueError, match="shape"):
        t_models.params_from_jax(bad, "cpu")
    bad = dict(p)
    bad["fc/b"] = bad["fc/b"].astype(np.float64)
    with pytest.raises(ValueError, match="dtype"):
        t_models.params_from_jax(bad, "cpu")
    bad = dict(p)
    bad.pop("fc/b")
    with pytest.raises(ValueError, match="missing"):
        t_models.params_from_jax(bad, "cpu")


# ---------------------------------------------------------------------------
# tests/test_ir.py on the port: each case builds its graph in both packages
# from the same numpy arrays and asserts what the reference asserts on both
# ---------------------------------------------------------------------------

def _toy_graph(ir):
    return ir.Graph(
        name="toy",
        nodes=[
            ir.Node("Gemm", "fc1", ["input", "w1", "b1"], ["h"]),
            ir.Node("Relu", "r1", ["h"], ["hr"]),
            ir.Node("Gemm", "fc2", ["hr", "w2", "b2"], ["logits"]),
        ],
        inputs=[ir.TensorInfo("input", (1, 4))],
        outputs=["logits"],
        initializers={"w1": np.zeros((4, 8), np.float32),
                      "b1": np.zeros(8, np.float32),
                      "w2": np.zeros((8, 2), np.float32),
                      "b2": np.zeros(2, np.float32)},
    )


BOTH = pytest.mark.parametrize("ir", [j_ir, t_ir], ids=["repro", "port"])


@BOTH
def test_validate_and_topo(ir):
    g = _toy_graph(ir)
    g.validate()
    order = [n.name for n in g.topo_order()]
    assert order.index("fc1") < order.index("r1") < order.index("fc2")
    assert order == [n.name for n in _toy_graph(j_ir).topo_order()]


@BOTH
def test_topo_handles_shuffled_nodes(ir):
    g = _toy_graph(ir)
    g.nodes = g.nodes[::-1]
    order = [n.name for n in g.topo_order()]
    assert order.index("fc1") < order.index("fc2")


@BOTH
def test_undefined_input_rejected(ir):
    g = _toy_graph(ir)
    g.nodes[0].inputs[0] = "missing"
    with pytest.raises(ValueError):
        g.validate()


@BOTH
def test_cycle_rejected(ir):
    g = _toy_graph(ir)
    g.nodes[0].inputs[0] = "logits"
    with pytest.raises(ValueError):
        g.topo_order()


@BOTH
def test_unsupported_op_rejected(ir):
    with pytest.raises(ValueError):
        ir.Node("FancyOp", "x", [], [])


def test_json_roundtrip(tmp_path):
    """The port saves and loads a graph; the file reads back in the
    reference identically, and the reference's in the port."""
    g = _toy_graph(t_ir)
    path = str(tmp_path / "g.json")
    g.save(path)
    g2 = t_ir.Graph.load(path)
    assert [n.name for n in g2.nodes] == [n.name for n in g.nodes]
    assert g2.initializers["w1"].shape == (4, 8)
    np.testing.assert_array_equal(g2.initializers["w1"], g.initializers["w1"])
    jg = j_ir.Graph.load(path)
    assert jg.to_json() == g2.to_json()
    jpath = str(tmp_path / "j.json")
    _toy_graph(j_ir).save(jpath)
    assert t_ir.Graph.load(jpath).to_json() == jg.to_json()


@BOTH
def test_producer_consumer_index(ir):
    g = _toy_graph(ir)
    assert g.producer_of("h").name == "fc1"
    assert g.producer_of("input") is None
    assert [n.name for n in g.consumers_of("hr")] == ["fc2"]
    g.nodes = g.nodes[:-1]
    assert g.producer_of("logits") is None


def test_topo_order_handles_long_chain():
    def chain(ir):
        nodes, prev = [], "input"
        for i in range(500):
            nodes.append(ir.Node("Relu", f"r{i}", [prev], [f"t{i}"]))
            prev = f"t{i}"
        return ir.Graph("deep", nodes[::-1], [ir.TensorInfo("input", (1, 4))],
                        [prev])

    order = [n.name for n in chain(t_ir).topo_order()]
    assert order == [f"r{i}" for i in range(500)]
    assert order == [n.name for n in chain(j_ir).topo_order()]


def test_roundtrip_preserves_pass_annotations(tmp_path):
    from repro.core.passes import infer_shapes as j_infer
    from repro.core.passes import make_assign_precision as j_assign
    from repro_torch.core.passes import infer_shapes, make_assign_precision
    g = make_assign_precision(TDT(16, 8))(infer_shapes(_toy_graph(t_ir)))
    path = str(tmp_path / "g.json")
    g.save(path)
    g2 = t_ir.Graph.load(path)
    assert g2.nodes[0].dtconfig == TDT(16, 8)
    assert tuple(g2.value_info["logits"].shape) == (1, 2)
    jg = j_assign(JDT(16, 8))(j_infer(_toy_graph(j_ir)))
    assert jg.to_json() == g.to_json()


def test_cnn_to_ir_matches_paper_topology():
    """Paper: 2 conv blocks (conv, maxpool, batchnorm, relu) + 1 FC."""
    jg, tg = _pair("mnist-cnn")
    ops = [n.op for n in tg.topo_order()]
    assert ops == ["Conv", "MaxPool", "BatchNormalization", "Relu"] * 2 + \
        ["Flatten", "Gemm"]
    assert ops == [n.op for n in jg.topo_order()]


def test_mlp_to_ir():
    sizes = [16, 8, 4]
    params = {f"fc{i}/w": np.zeros((sizes[i], sizes[i + 1]), np.float32)
              for i in range(2)}
    params.update({f"fc{i}/b": np.zeros(sizes[i + 1], np.float32)
                   for i in range(2)})
    g = t_reader.mlp_to_ir(sizes, params)
    assert [n.op for n in g.topo_order()] == ["Gemm", "Relu", "Gemm"]
    assert g.to_json() == j_reader.mlp_to_ir(sizes, params).to_json()
