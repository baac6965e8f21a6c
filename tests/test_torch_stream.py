"""The port's stream target and MDC step against the reference, on the CPU.

* ``StreamWriter.topology()`` equals the reference's golden files
  (``tests/golden/*.json``) under one fixed relabelling of the actor
  targets — the port names its own implementations (``cuda/...``,
  ``torch``) where the reference names ``pallas/...`` and ``jax`` — and
  every structural case of ``tests/test_topology_golden.py`` holds;
* the stream target's D16-W8 logits agree with the reference's stream
  target on both CNNs (atol 1e-4; beyond it at most one quantum of the
  output FIFO's 16-bit type), and ``FlowResult.serve("stream")`` coalesces
  requests into results equal to per-request ones;
* ``compose_adaptive``: master codes and scales byte-identical to the
  reference's ``quantize_tree_native``, the same ``sharing_report()``,
  per-point outputs within the bf16 tolerance of the reference's, and
  ``build_dynamic()`` equal to the static points.
"""
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core.adaptive import WorkingPoint as JWP
from repro.core.flow import DesignFlow as JFlow
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.models import cnn as j_models
from repro.quant.qtypes import DatatypeConfig as JDT

from repro_torch.configs.mnist_cnn import CONFIG as T_CNN
from repro_torch.configs.separable_cnn import CONFIG as T_SEP
from repro_torch.core.adaptive import WorkingPoint
from repro_torch.core.flow import DesignFlow as TFlow
from repro_torch.core.flow import WriterOptions
from repro_torch.core.ir import Graph, Node, TensorInfo
from repro_torch.core.reader import cnn_to_ir as t_cnn_to_ir
from repro_torch.core.reader import separable_cnn_to_ir as t_sep_to_ir
from repro_torch.core.writers.stream_writer import StreamWriter
from repro_torch.models import cnn as t_models
from repro_torch.quant.qtypes import DatatypeConfig as TDT, fixed_for_range

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
# the one difference from the reference's topology: who implements an actor
TARGET_LABELS = {"pallas/conv2d_stream": "cuda/conv2d_stream",
                 "pallas/qconv_dw": "cuda/qconv_dw", "jax": "torch"}
MODELS = ["separable-cnn", "mnist-cnn"]

_PARAMS = {}


def _params(which):
    """The reference's seed-pinned parameters, as numpy."""
    if which not in _PARAMS:
        if which == "separable-cnn":
            p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(0))
        else:
            p = j_models.init_params(J_CNN, jax.random.PRNGKey(0))
        _PARAMS[which] = {k: np.asarray(v) for k, v in p.items()}
    return _PARAMS[which]


def _graphs(which, batch=None):
    """(reference graph, port graph) from the same parameters."""
    p = _params(which)
    tp = t_models.params_from_jax(p, "cpu")
    if which == "separable-cnn":
        return j_sep_to_ir(J_SEP, p, batch=batch), t_sep_to_ir(T_SEP, tp,
                                                               batch=batch)
    return j_cnn_to_ir(J_CNN, p, batch=batch), t_cnn_to_ir(T_CNN, tp,
                                                           batch=batch)


def _topology(which, dt, fifo_slack=1.0, batch=None):
    g = _graphs(which, batch)[1]
    res = TFlow(g, device="cpu").run(("stream",), dt, fifo_slack=fifo_slack)
    return res.writers["stream"].topology()


def canonical_topology(fifo_slack: float = 1.0):
    """The reference's check-in configuration: MNIST CNN, symbolic batch,
    uniform D16-W8, default compile pipeline."""
    return _topology("mnist-cnn", TDT(16, 8), fifo_slack)


def canonical_separable_topology():
    return _topology("separable-cnn", TDT(8, 8))


def _relabelled_golden(name):
    want = json.loads((GOLDEN_DIR / name).read_text())
    for a in want["actors"]:
        a["target"] = TARGET_LABELS[a["target"]]
    return want


# -- topology: the golden files and the structural cases ---------------------

def test_topology_matches_golden_file():
    got = json.loads(json.dumps(canonical_topology()))
    assert got == _relabelled_golden("mnist_cnn_topology.json")


def test_separable_topology_matches_golden_file():
    got = json.loads(json.dumps(canonical_separable_topology()))
    assert got == _relabelled_golden("separable_cnn_topology.json")


def test_every_fifo_has_positive_integer_depth():
    topo = canonical_topology()
    assert topo["connections"], "topology has no FIFOs"
    for c in topo["connections"]:
        assert isinstance(c["depth"], int) and c["depth"] > 0, c
        assert isinstance(c["depth_bytes"], int) and c["depth_bytes"] > 0, c
    assert topo["total_fifo_bytes"] == sum(c["depth_bytes"]
                                           for c in topo["connections"])


def test_fifo_depths_follow_value_info_models():
    topo = canonical_topology()
    by_dst = {c["dst"]: c for c in topo["connections"]}
    assert by_dst["conv0"]["depth"] == 2 * 28 * 1 + 3 * 1
    assert by_dst["pool0"]["depth"] == 1 * 28 * 16 + 2 * 16
    assert by_dst["fc"]["depth"] == T_CNN.fc_in


def test_grouped_fifo_depths_follow_line_buffer_model():
    topo = canonical_separable_topology()
    by_dst = {c["dst"]: c for c in topo["connections"]}
    assert by_dst["dw0"]["depth"] == 2 * 14 * 8 + 3 * 8
    assert by_dst["dw1"]["depth"] == 2 * 14 * 16 + 3 * 16
    assert by_dst["stem_pool"]["tensor"] == "stem_out"
    assert by_dst["stem_pool"]["depth"] == 1 * 28 * 8 + 2 * 8
    assert by_dst["stem_relu"]["depth"] == 8
    actors = {a["name"]: a for a in topo["actors"]}
    for dw in ("dw0", "dw1"):
        assert actors[dw]["class"] == "FusedDepthwiseConv"
        assert actors[dw]["target"] == "cuda/qconv_dw"
        assert actors[dw]["sub_actors"] == [
            "LineBuffer", "DepthwiseActor", "WeightActor", "BiasActor",
            "ReluActor"]
        assert actors[dw]["weight_shape"][2] == 1


def test_fifo_slack_scales_depths():
    base = canonical_topology(fifo_slack=1.0)
    slacked = canonical_topology(fifo_slack=2.5)
    assert slacked["fifo_slack"] == 2.5
    for b, s in zip(base["connections"], slacked["connections"]):
        assert s["depth"] == math.ceil(b["depth"] * 2.5)
    assert slacked["total_fifo_bytes"] > base["total_fifo_bytes"]
    # the typed option reaches the stream writer the same way
    g = _graphs("mnist-cnn")[1]
    opt = TFlow(g, device="cpu").run(("stream",), TDT(16, 8),
                                     options=WriterOptions(fifo_slack=2.5))
    assert opt.writers["stream"].topology() == slacked
    with pytest.raises(ValueError, match="fifo_slack"):
        WriterOptions(fifo_slack=0.0)


def test_fifo_ids_globally_unique_under_fanout():
    rng = np.random.default_rng(0)
    inits = {"w1": rng.normal(size=(6, 4)).astype(np.float32),
             "w2": rng.normal(size=(6, 4)).astype(np.float32)}
    g = Graph("fanout", [
        Node("Gemm", "g1", ["input", "w1"], ["a"]),
        Node("Gemm", "g2", ["input", "w2"], ["b"]),
        Node("Add", "sum", ["a", "b"], ["out"]),
    ], [TensorInfo("input", ("N", 6))], ["out"], inits)
    conns = StreamWriter(g, device="cpu").topology()["connections"]
    assert len(conns) == 4
    ids = [c["fifo"] for c in conns]
    assert len(set(ids)) == len(ids), f"colliding FIFO ids: {ids}"
    input_edges = [c for c in conns if c["tensor"] == "input"]
    assert len(input_edges) == 2
    assert input_edges[0]["fifo"] != input_edges[1]["fifo"]
    assert all(c["depth"] > 0 for c in conns)


def test_save_topology_roundtrip_includes_aggregate_bytes(tmp_path):
    g = _graphs("mnist-cnn")[1]
    res = TFlow(g, device="cpu").run(("stream",), TDT(16, 8))
    path = tmp_path / "net.xdf.json"
    res.writers["stream"].save_topology(str(path))
    loaded = json.loads(path.read_text())
    assert loaded["total_fifo_bytes"] > 0
    assert loaded["fifo_slack"] == 1.0
    assert loaded == json.loads(json.dumps(res.writers["stream"].topology()))


def test_stream_writer_rejects_nonpositive_slack():
    with pytest.raises(ValueError):
        StreamWriter(_graphs("mnist-cnn")[1], device="cpu", fifo_slack=0.0)


def test_fifo_depths_are_batch_independent():
    t_sym = _topology("mnist-cnn", None)
    t_pin = _topology("mnist-cnn", None, batch=8)
    assert [c["depth"] for c in t_pin["connections"]] == \
        [c["depth"] for c in t_sym["connections"]]
    assert t_pin["total_fifo_bytes"] == t_sym["total_fifo_bytes"]
    by_dst = {c["dst"]: c for c in t_pin["connections"]}
    assert by_dst["fc"]["depth"] == T_CNN.fc_in


def test_fifo_depth_falls_back_to_weight_window_without_kernel_shape():
    rng = np.random.default_rng(0)
    inits = {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)}
    g = Graph("nok", [
        Node("Conv", "c", ["input", "w", "b"], ["out"],
             {"pads": "SAME", "strides": [1, 1]}),
    ], [TensorInfo("input", ("N", 8, 8, 2))], ["out"], inits)
    (conn,) = StreamWriter(g, device="cpu").topology()["connections"]
    assert conn["depth"] == (3 - 1) * 8 * 2 + 3 * 2


# -- the stream target's logits and serving ------------------------------------

class _Case:
    """One model at D16-W8: the reference's stream target (interpret-mode
    Pallas conv) and the port's, with the reference's act_ranges."""

    def __init__(self, which):
        self.jg, self.tg = _graphs(which)
        rng = np.random.default_rng(0)
        self.calib = rng.random((3, 28, 28, 1), np.float32)
        self.x = rng.random((4, 28, 28, 1), np.float32)
        self.jres = JFlow(self.jg).run(("stream",), JDT(16, 8),
                                       calib_inputs=(self.calib,))
        self.tres = TFlow(self.tg, device="cpu").run(
            ("stream",), TDT(16, 8), act_ranges=self.jres.act_ranges)


_CASES = {}


@pytest.fixture(scope="module", params=MODELS)
def case(request):
    if request.param not in _CASES:
        _CASES[request.param] = _Case(request.param)
    return _CASES[request.param]


def test_stream_logits_match_the_reference(case):
    want = np.asarray(case.jres.executables["stream"](case.x))
    got = case.tres.executables["stream"](case.x).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    # beyond 1e-4 an element may sit one quantum of the logits FIFO's 16-bit
    # type away, where an f32 summation-order difference flips a requant
    out = case.tres.graph.outputs[0]
    quantum = fixed_for_range(16, case.jres.act_ranges.get(out, 8.0)).scale
    beyond = d > 1e-4
    assert np.all(d[beyond] <= quantum * (1 + 1e-6))
    # measured: none on this CPU; a handful would still be the same contract
    assert int(beyond.sum()) <= want.size // 100


def test_stream_serve_coalesces_like_per_request_results(case):
    run = case.tres.executables["stream"]
    srv = case.tres.serve("stream", max_batch=8, max_wait=0.001)
    rng = np.random.default_rng(3)
    reqs = [rng.random((n, 28, 28, 1), np.float32) for n in (1, 3, 2, 2)]
    with srv:
        tickets = [srv.submit(r) for r in reqs]
        got = [t.result(timeout=60) for t in tickets]
    for r, y in zip(reqs, got):
        np.testing.assert_array_equal(y, run(r).numpy())
    assert srv.stats()["submitted"] == len(reqs)


# -- compose_adaptive (the MDC step) -----------------------------------------------

_ADAPT = {}


def _adaptive():
    """The reference's and the port's merged accelerators over mnist-cnn
    (the README's model; on separable-cnn the reference's own call fails:
    see test_compose_adaptive_separable_refuses_like_the_reference)."""
    if not _ADAPT:
        jg, tg = _graphs("mnist-cnn")
        jpts = [JWP("hi", 8), JWP("mid", 4), JWP("lo", 2)]
        tpts = [WorkingPoint(p.name, p.weight_bits) for p in jpts]
        _ADAPT["j"] = JFlow(jg).compose_adaptive(jpts)
        _ADAPT["t"] = TFlow(tg, device="cpu").compose_adaptive(tpts)
        _ADAPT["x"] = np.random.default_rng(1).random((4, 28, 28, 1),
                                                      np.float32)
    return _ADAPT["j"], _ADAPT["t"], _ADAPT["x"]


def test_compose_adaptive_master_codes_byte_identical():
    j, t, _ = _adaptive()
    assert set(t.qparams.codes) == set(j.qparams.codes)
    assert set(t.qparams.passthrough) == set(j.qparams.passthrough)
    for k, c in j.qparams.codes.items():
        assert t.qparams.codes[k].dtype == torch.int8
        assert t.qparams.codes[k].numpy().tobytes() == np.asarray(c).tobytes()
        assert t.qparams.scales[k].numpy().tobytes() == \
            np.asarray(j.qparams.scales[k]).tobytes(), k
    assert t.sharing_report() == j.sharing_report()
    rep = t.sharing_report()
    assert rep["sharing_ratio"] > 1.0 and rep["extra_bytes_per_config"] == 0


@pytest.mark.parametrize("point", ["hi", "mid", "lo"])
def test_compose_adaptive_points_match_the_reference(point):
    j, t, x = _adaptive()
    want = np.asarray(jnp.asarray(j(point, x), jnp.float32))
    got = t(point, x)
    assert got.shape == (4, 10) and str(got.dtype).endswith(
        str(j(point, x).dtype))
    tol = np.abs(want).max() * 2.0 ** -7 + 1e-6
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, atol=tol)


def test_compose_adaptive_points_differ_and_dynamic_equals_static():
    _, t, x = _adaptive()
    y_hi, y_lo = t("hi", x), t("lo", x)
    assert float((y_hi - y_lo).abs().max()) > 1e-6
    dyn = t.build_dynamic()
    for i, pt in enumerate(t.points):
        want = t(pt.name, x).to(torch.float32)
        assert torch.equal(dyn(i, t.qparams.tree(), x), want)
        assert torch.equal(dyn(torch.tensor(i), t.qparams.tree(), x), want)
    with pytest.raises(IndexError):
        dyn(3, t.qparams.tree(), x)


def test_compose_adaptive_separable_refuses_like_the_reference():
    """compose_adaptive runs the unfused graph in bf16: on separable-cnn the
    f32 stream after dw0's BatchNormalization meets dw1's bf16 taps, which
    the reference's XLA conv refuses and so does the port's."""
    jg, tg = _graphs("separable-cnn")
    x = np.random.default_rng(2).random((1, 28, 28, 1), np.float32)
    with pytest.raises(TypeError, match="same dtypes"):
        JFlow(jg).compose_adaptive([JWP("hi", 8)])("hi", x)
    with pytest.raises(TypeError, match="same dtypes"):
        TFlow(tg, device="cpu").compose_adaptive([WorkingPoint("hi", 8)])(
            "hi", x)
