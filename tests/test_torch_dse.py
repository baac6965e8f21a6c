"""The port's design-space explorer against ``tests/test_dse.py`` and against
the JAX explorer itself.

The first part mirrors every test of ``test_dse.py`` under the port's
mapping (``repro.`` -> ``repro_torch.``, targets ``jax``/``qjax`` ->
``torch``/``qtorch``, flows on the CPU): Pareto dominance and determinism,
front serialization, budget screening with its infeasible error, the
explorer end to end on separable-cnn, ``WriterOptions`` and the
``PointSelector`` protocol.  The second part feeds the same numpy params and
calibration batch to both explorers and holds every front field equal, apart
from ``predicted_latency_s``, which follows the H100's constants.

With this jax the reference's front on the ``test_dse.py`` fixture has two
points, w4 (0.9375) and w2 (0.5625), and no w8, so two reference tests fail on
it (ROADMAP Queue 3, reference facts).  Their mirrors hold the port to the
front the reference computes.

Each package's front counts its own autotune cache (``tuned_tilings``); the
module points both caches at empty temporary files, so the counts compare
like with like.
"""
import json

import jax
import numpy as np
import pytest

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core.flow import DesignFlow as JFlow
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.dse import ParetoFront as JFront
from repro.dse import ResourceBudget as JBudget
from repro.kernels import autotune as j_autotune
from repro.models import cnn as j_models

from repro_torch.configs.mnist_cnn import CONFIG as T_CNN
from repro_torch.configs.separable_cnn import CONFIG as SEP
from repro_torch.core.adaptive import (BudgetSelector, FixedSelector,
                                       PointSelector, RuntimePolicy,
                                       ServiceObjective, SLOController,
                                       WorkingPoint)
from repro_torch.core.flow import DesignFlow, WriterOptions
from repro_torch.core.reader import cnn_to_ir as t_cnn_to_ir
from repro_torch.core.reader import separable_cnn_to_ir
from repro_torch.dse import (BudgetInfeasibleError, DesignSpaceExplorer,
                             ParetoFront, ParetoPoint, ResourceBudget,
                             prune_dominated, scratch_bytes_for)
from repro_torch.kernels import autotune
from repro_torch.launch.roofline import HBM_BW, PEAK_OPS_INT8, graph_mac_count
from repro_torch.models import cnn

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

N_EXAMPLES = 15


def seeded_property(fn):
    """Run ``fn(seed)`` under hypothesis when available, else over a pinned
    seed sweep (same property, deterministic examples)."""
    if HAVE_HYPOTHESIS:
        return settings(max_examples=N_EXAMPLES, deadline=None)(
            given(st.integers(0, 2**31 - 1))(fn))
    return pytest.mark.parametrize("seed", [1000003 * i + 29
                                            for i in range(N_EXAMPLES)])(fn)


def pt(name="p", bits=8, *, wb=100, fb=10, sb=0, lat=1.0, agree=1.0,
       measured=None):
    return ParetoPoint(WorkingPoint(name, bits), weight_bytes=wb,
                       fifo_bytes=fb, scratch_bytes=sb,
                       predicted_latency_s=lat, agreement=agree,
                       measured_latency_s=measured)


def random_points(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    return [pt(f"p{i}", 8,
               wb=int(rng.integers(1, 5)) * 100,
               fb=int(rng.integers(0, 3)) * 10,
               lat=float(rng.integers(1, 4)),
               agree=float(rng.integers(0, 4)) / 4.0)
            for i in range(n)]


# ---------------------------------------------------------------------------
# dominance + prune properties
# ---------------------------------------------------------------------------


def test_dominates_is_strict():
    a, b = pt("a", wb=100), pt("b", wb=200)
    assert a.dominates(b) and not b.dominates(a)
    c = pt("c", wb=100)
    assert not a.dominates(c) and not c.dominates(a)
    d = pt("d", wb=50, agree=0.5)
    assert not a.dominates(d) and not d.dominates(a)


def test_measured_latency_overrides_predicted_in_objectives():
    slow = pt("s", lat=9.0, measured=0.5)
    fast = pt("f", lat=1.0)
    assert slow.latency_s == 0.5
    assert slow.objectives()[1] == 0.5
    assert not fast.dominates(slow)


@seeded_property
def test_prune_dominated_properties(seed):
    pts = random_points(seed)
    front = prune_dominated(pts)
    assert front
    for p in front:
        assert not any(q.dominates(p) for q in front)
    removed = [p for p in pts if p not in front]
    for p in removed:
        assert any(q.dominates(p) for q in front)
    it = iter(pts)
    assert all(any(p is q for q in it) for p in front)
    assert prune_dominated(front) == front
    assert prune_dominated(pts) == front


def test_prune_keeps_objective_identical_duplicates():
    a, b = pt("a", wb=100), pt("b", wb=100)
    assert prune_dominated([a, b]) == [a, b]


# ---------------------------------------------------------------------------
# front serialization
# ---------------------------------------------------------------------------


def make_front():
    pts = [pt("w8", 8, wb=300, lat=3.0, agree=1.0),
           pt("w4", 4, wb=150, lat=2.0, agree=0.9),
           pt("w2", 2, wb=80, lat=1.0, agree=0.6, measured=0.8)]
    return ParetoFront("toy", pts, act_bits=8, fifo_slack=2.0,
                       per_layer_bits={"conv1": 4}, buckets=(1, 2, 4, 8),
                       budget=ResourceBudget(weight_bytes=400),
                       tuned_tilings=3)


def test_front_json_roundtrip_exact(tmp_path):
    front = make_front()
    again = ParetoFront.from_json(front.to_json())
    assert again.to_json() == front.to_json()
    assert [p.point.name for p in again.points] == ["w8", "w4", "w2"]
    assert again.per_layer_bits == {"conv1": 4}
    assert again.budget.weight_bytes == 400
    assert again.points[2].measured_latency_s == 0.8
    path = tmp_path / "front.json"
    front.save(str(path))
    assert ParetoFront.load(str(path)).to_json() == front.to_json()


def test_front_schema_mismatch_refused():
    d = make_front().to_dict()
    d["schema"] = 999
    with pytest.raises(ValueError, match="schema mismatch"):
        ParetoFront.from_dict(d)


def test_front_orders_points_highest_precision_first():
    pts = [pt("w2", 2, wb=80), pt("w8", 8, wb=300), pt("w4", 4, wb=150)]
    front = ParetoFront("toy", pts)
    assert [p.point.weight_bits for p in front.points] == [8, 4, 2]
    assert [w.name for w in front.working_points()] == ["w8", "w4", "w2"]


def test_front_precision_map_and_run_kwargs():
    front = make_front()
    pm = front.precision_map()
    assert pm.default.act_bits == 8 and pm.default.weight_bits == 8
    assert pm.per_node["conv1"].weight_bits == 4
    kw = front.run_kwargs()
    assert kw["fifo_slack"] == 2.0 and kw["dtconfig"] is not pm


def test_front_selector_kinds():
    front = make_front()
    open_loop = front.selector()
    assert isinstance(open_loop, BudgetSelector)
    assert open_loop.select(1.0).name == "w8"
    assert open_loop.select(0.0).name == "w2"
    closed = front.selector(ServiceObjective(p95_latency_s=1.0))
    assert isinstance(closed, SLOController)
    assert [p.name for p in closed.points] == ["w8", "w4", "w2"]


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------


def test_budget_check_reports_each_violated_term():
    b = ResourceBudget(weight_bytes=100, latency_s=1.0)
    bad = b.check({"weight_bytes": 150, "fifo_bytes": 10,
                   "scratch_bytes": 0, "total_bytes": 160,
                   "predicted_latency_s": 2.0})
    assert bad == {"weight_bytes": (150, 100), "latency_s": (2.0, 1.0)}
    assert not b.check({"weight_bytes": 90, "predicted_latency_s": 0.5})
    assert "weight_bytes=150 > ceiling 100" in b.violations_str(bad)


def test_budget_validation_and_roundtrip():
    with pytest.raises(ValueError, match="must be positive"):
        ResourceBudget(weight_bytes=0)
    with pytest.raises(ValueError, match="max_batch"):
        ResourceBudget(max_batch=0)
    with pytest.raises(ValueError, match="unknown budget terms"):
        ResourceBudget.from_dict({"bram_bytes": 1})
    b = ResourceBudget(total_bytes=1000, max_batch=4)
    assert ResourceBudget.from_dict(b.to_dict()) == b
    assert b.constrained and not ResourceBudget(max_batch=4).constrained


# ---------------------------------------------------------------------------
# explorer end-to-end on separable-cnn (test_dse.py's fixture: the same
# numpy params and calibration batch reach both packages)
# ---------------------------------------------------------------------------


def _jax_params(which):
    if which == "separable-cnn":
        p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(1))
    else:
        p = j_models.init_params(J_CNN, jax.random.PRNGKey(1))
    return {k: np.asarray(v) for k, v in p.items()}


def _graphs(which):
    """(reference graph, port graph) from the same numpy params."""
    p = _jax_params(which)
    tp = cnn.params_from_jax(p, "cpu")
    if which == "separable-cnn":
        return j_sep_to_ir(J_SEP, p), separable_cnn_to_ir(SEP, tp)
    return j_cnn_to_ir(J_CNN, p), t_cnn_to_ir(T_CNN, tp)


def _calib():
    shape = (SEP.image_hw[0], SEP.image_hw[1], SEP.in_channels)
    return np.random.default_rng(0).random((32, *shape), np.float32)


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_caches(tmp_path_factory):
    """Both packages' autotune caches at empty temporary files for the
    module (never the home directory's)."""
    d = tmp_path_factory.mktemp("autotune")
    paths = {autotune.AUTOTUNE_CACHE_ENV: d / "repro_torch.json",
             j_autotune.AUTOTUNE_CACHE_ENV: d / "repro.json"}
    with pytest.MonkeyPatch.context() as mp:
        for env, path in paths.items():
            path.write_text("")
            mp.setenv(env, str(path))
        yield paths


@pytest.fixture(scope="module")
def sep_graph_calib():
    return _graphs("separable-cnn")[1], _calib()


@pytest.fixture(scope="module")
def free_front(sep_graph_calib):
    g, calib = sep_graph_calib
    return DesignFlow(g, device="cpu").explore((calib,))


_REF_FRONTS = {}


def ref_front(which, **kw):
    """The JAX explorer's front (computed once per model and budget)."""
    key = (which, tuple(sorted(kw.items())))
    if key not in _REF_FRONTS:
        jg, _ = _graphs(which)
        budget = kw.get("weight_bytes")
        _REF_FRONTS[key] = JFlow(jg).explore(
            (_calib(),),
            budget=None if budget is None else JBudget(weight_bytes=budget))
    return _REF_FRONTS[key]


def test_explore_unconstrained_front(free_front):
    names = [p.point.name for p in free_front.points]
    # test_dse.py expects >= 3 points led by w8; the reference computes w4
    # and w2 only on this fixture (ROADMAP Queue 3), and the port is held to
    # what the reference computes
    assert names == [p.point.name for p in ref_front("separable-cnn").points]
    for p in free_front.points:
        assert not any(q.dominates(p) for q in free_front.points)
    assert free_front.budget is None
    assert free_front.fifo_slack == 2.0 and free_front.act_bits == 8
    assert free_front.buckets == (1, 2, 4, 8)
    # both caches are empty files: the counts agree with the reference's
    assert free_front.tuned_tilings == \
        ref_front("separable-cnn").tuned_tilings == \
        len(autotune.tuned_entries()) == 0


def test_front_counts_the_ports_tuned_tilings(sep_graph_calib, free_front,
                                              tmp_path, monkeypatch):
    """``tuned_tilings`` is the port's cache's entry count at explore time,
    as the reference counts its own; the rest of the front is unchanged."""
    cache = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.AUTOTUNE_CACHE_ENV, str(cache))
    autotune.disk_put("qgemm:6272:9:8:8:1:0", (1, 32, 8, 32, 1))
    autotune.disk_put("qconv_dw:8:14:14:8:14x14:3x3:1x1:8:1:0", (8, 7))
    g, calib = sep_graph_calib
    front = DesignFlow(g, device="cpu").explore((calib,))
    assert front.tuned_tilings == len(autotune.tuned_entries()) == 2
    d, free = front.to_dict(), free_front.to_dict()
    assert d.pop("tuned_tilings") == 2 and free.pop("tuned_tilings") == 0
    assert d == free


def test_explore_deterministic(sep_graph_calib, free_front):
    g, calib = sep_graph_calib
    again = DesignFlow(g, device="cpu").explore((calib,))
    assert again.to_json() == free_front.to_json()


def test_tightened_byte_ceiling_drops_w8(sep_graph_calib, free_front):
    g, calib = sep_graph_calib
    ceiling = max(p.weight_bytes for p in free_front.points) - 1
    tight = DesignFlow(g, device="cpu").explore(
        (calib,), budget=ResourceBudget(weight_bytes=ceiling))
    names = [p.point.name for p in tight.points]
    assert "w8" not in names and len(tight) >= 1
    assert max(p.weight_bytes for p in tight.points) <= ceiling
    assert (max(p.weight_bytes for p in tight.points)
            < max(p.weight_bytes for p in free_front.points))
    assert tight.budget is not None
    assert tight.budget.weight_bytes == ceiling


def test_infeasible_budget_raises_with_violations(sep_graph_calib):
    g, calib = sep_graph_calib
    with pytest.raises(BudgetInfeasibleError,
                       match="closest candidate") as ei:
        DesignFlow(g, device="cpu").explore(
            (calib,), budget=ResourceBudget(weight_bytes=1))
    assert "weight_bytes" in ei.value.violations
    value, ceiling = ei.value.violations["weight_bytes"]
    assert value > ceiling == 1


def test_front_bytes_match_packed_and_stream_accounting(sep_graph_calib,
                                                        free_front):
    g, calib = sep_graph_calib
    res = DesignFlow(g, device="cpu").run(("qtorch", "stream"),
                                          calib_inputs=(calib,),
                                          **free_front.run_kwargs())
    packed = res.writers["qtorch"].packed
    caps = free_front.per_layer_bits
    for p in free_front.points:
        assert p.weight_bytes == packed.view_bytes(p.point.weight_bits,
                                                   caps=caps)
    fifo = int(res.writers["stream"].topology()["total_fifo_bytes"])
    assert all(p.fifo_bytes == fifo for p in free_front.points)
    scratch = scratch_bytes_for(res.graph, batch=max(free_front.buckets),
                                act_bytes=1, dw_mode="direct")
    assert all(p.scratch_bytes == scratch for p in free_front.points)


def test_serve_adaptive_consumes_front(sep_graph_calib, free_front):
    g, calib = sep_graph_calib
    res = DesignFlow(g, device="cpu").run(("qtorch",), calib_inputs=(calib,),
                                          **free_front.run_kwargs())
    srv = res.serve_adaptive(points=free_front, max_batch=4, max_wait=0.0,
                             selector=free_front.selector(
                                 ServiceObjective(p95_latency_s=60.0)))
    tk = srv.submit(calib[:1])
    srv.pump(flush=True)
    assert srv.result(tk).shape[0] == 1
    # SLO satisfied: the front's top point.  test_dse.py names it w8; on
    # this fixture the reference's computed top point is w4 (ROADMAP Queue 3)
    top = ref_front("separable-cnn").points[0].point
    assert free_front.points[0].point.name == top.name
    assert srv.reports[-1].bits == top.weight_bits
    assert srv.stats()["slo"]["point"] == top.name


def test_explorer_requires_a_ladder(sep_graph_calib):
    g, calib = sep_graph_calib
    with pytest.raises(ValueError, match="ladder"):
        DesignSpaceExplorer(g, (calib,), ladder=(), device="cpu")


def test_front_json_from_explorer_is_loadable(free_front, tmp_path):
    path = tmp_path / "sep_front.json"
    free_front.save(str(path))
    loaded = ParetoFront.load(str(path))
    assert loaded.to_json() == free_front.to_json()
    assert json.loads(free_front.to_json())["graph"] == loaded.graph_name


# ---------------------------------------------------------------------------
# WriterOptions: the typed writer-configuration surface
# ---------------------------------------------------------------------------


def test_writer_options_validate_eagerly():
    with pytest.raises(ValueError, match="dw_mode"):
        WriterOptions(dw_mode="winograd")
    with pytest.raises(ValueError, match="fifo_slack"):
        WriterOptions(fifo_slack=0.0)
    assert WriterOptions(dw_mode="im2col", fifo_slack=1.5).set_fields() == {
        "dw_mode": "im2col", "fifo_slack": 1.5}
    assert WriterOptions().set_fields() == {}


def test_unknown_writer_kwarg_names_the_writer(sep_graph_calib):
    g, calib = sep_graph_calib
    with pytest.raises(ValueError, match=r"'torch'.*TorchWriter"):
        DesignFlow(g, device="cpu").run(
            ("torch",), writer_kwargs={"torch": {"bogus": 1}})


def test_writer_kwargs_for_unknown_target_rejected(sep_graph_calib):
    g, _ = sep_graph_calib
    with pytest.raises(KeyError, match="not in targets"):
        DesignFlow(g, device="cpu").run(("torch",),
                                        writer_kwargs={"qtorch": {}})


def test_options_reach_accepting_writers_only(sep_graph_calib):
    g, calib = sep_graph_calib
    opts = WriterOptions(fifo_slack=3.0, dw_mode="im2col")
    res = DesignFlow(g, device="cpu").run(("torch", "stream", "qtorch"),
                                          calib_inputs=(calib,), options=opts)
    assert res.writers["stream"].fifo_slack == 3.0
    assert res.writers["qtorch"].dw_mode == "im2col"


def test_explicit_writer_kwargs_override_options(sep_graph_calib):
    g, calib = sep_graph_calib
    res = DesignFlow(g, device="cpu").run(
        ("stream",), calib_inputs=(calib,),
        options=WriterOptions(fifo_slack=3.0),
        writer_kwargs={"stream": {"fifo_slack": 1.0}})
    assert res.writers["stream"].fifo_slack == 1.0


# ---------------------------------------------------------------------------
# PointSelector protocol + deprecation shims
# ---------------------------------------------------------------------------

POINTS = [WorkingPoint("w8", 8), WorkingPoint("w4", 4), WorkingPoint("w2", 2)]


def test_selector_protocol_instances():
    sel = BudgetSelector(list(POINTS))
    ctl = SLOController(POINTS, ServiceObjective(p95_latency_s=1.0))
    fix = FixedSelector(POINTS[1])
    pol = RuntimePolicy(list(POINTS))
    for s in (sel, ctl, fix, pol):
        assert isinstance(s, PointSelector)


def test_runtime_policy_shim_matches_budget_selector():
    pol = RuntimePolicy(list(POINTS))
    sel = BudgetSelector(list(POINTS))
    for frac in np.linspace(0.0, 1.0, 21):
        assert pol.select(float(frac)) is not None
        assert (pol.select(energy_budget_frac=float(frac)).name
                == sel.select(budget=float(frac)).name)
    pol = RuntimePolicy(list(POINTS), thresholds=[0.8, 0.3])
    sel = BudgetSelector(list(POINTS), thresholds=[0.8, 0.3])
    for frac in (0.0, 0.2, 0.3, 0.5, 0.8, 0.9, 1.0):
        assert pol.select(frac).name == sel.select(frac).name
    assert pol.select(0.9).name == "w8"
    assert pol.select(0.5).name == "w4"
    assert pol.select(0.1).name == "w2"


def test_fixed_selector_pins_one_point():
    fix = FixedSelector(POINTS[2])
    assert fix.points == [POINTS[2]]
    for frac in (0.0, 0.5, 1.0):
        assert fix.select(frac).name == "w2"
    fix.observe(1.0)


def test_slo_controller_select_accepts_protocol_budget_arg():
    ctl = SLOController(POINTS, ServiceObjective(p95_latency_s=1.0))
    assert ctl.select().name == ctl.select(0.0).name == "w8"


# ---------------------------------------------------------------------------
# parity with the JAX explorer
# ---------------------------------------------------------------------------


def _h100_latency(graph, buckets, weight_bytes, scratch_bytes):
    """max(2 * MACs / 1.979e15, bytes / 3.35e12) at the largest bucket."""
    macs = graph_mac_count(graph, batch=max(buckets))["_total"]
    return max(2.0 * macs / 1.979e15, (weight_bytes + scratch_bytes) / 3.35e12)


def _assert_front_matches_reference(t_front, j_front, graph):
    jd, td = j_front.to_dict(), t_front.to_dict()
    jpts, tpts = jd.pop("points"), td.pop("points")
    # tuned_tilings included: each counts its own (empty) cache
    assert td == jd
    assert [p["name"] for p in tpts] == [p["name"] for p in jpts]
    for tp, jp, p in zip(tpts, jpts, t_front.points):
        assert tp.pop("predicted_latency_s") == _h100_latency(
            graph, t_front.buckets, p.weight_bytes, p.scratch_bytes)
        jp.pop("predicted_latency_s")
        assert tp == jp


@pytest.mark.parametrize("which", ["separable-cnn", "mnist-cnn"])
def test_front_equals_the_reference_front(which):
    _, tg = _graphs(which)
    flow = DesignFlow(tg, device="cpu")
    front = flow.explore((_calib(),))
    _assert_front_matches_reference(front, ref_front(which),
                                    flow.transform())
    assert PEAK_OPS_INT8 == 1.979e15 and HBM_BW == 3.35e12


def test_tight_front_equals_the_reference_front(free_front):
    ceiling = max(p.weight_bytes for p in free_front.points) - 1
    _, tg = _graphs("separable-cnn")
    flow = DesignFlow(tg, device="cpu")
    tight = flow.explore((_calib(),),
                         budget=ResourceBudget(weight_bytes=ceiling))
    _assert_front_matches_reference(
        tight, ref_front("separable-cnn", weight_bytes=ceiling),
        flow.transform())


def test_front_json_round_trips_between_packages():
    """A front either package writes loads in the other and writes back
    byte for byte: one wire format."""
    j_text = ref_front("separable-cnn").to_json()
    assert ParetoFront.from_json(j_text).to_json() == j_text
    _, tg = _graphs("mnist-cnn")
    t_text = DesignFlow(tg, device="cpu").explore(
        (_calib(),), budget=ResourceBudget(total_bytes=10 ** 7)).to_json()
    assert JFront.from_json(t_text).to_json() == t_text


def test_im2col_dw_mode_scratch_equals_the_reference():
    """The explorer's dw_mode knob prices the dense depthwise expansion into
    the scratch term exactly as the reference does."""
    jg, tg = _graphs("separable-cnn")
    from repro.dse import scratch_bytes_for as j_scratch
    from repro.core.passes import PassManager as JPM
    from repro.core.passes import structural_pipeline as j_struct
    from repro_torch.core.passes import PassManager, structural_pipeline
    jgs = JPM(j_struct()).run(jg)
    tgs = PassManager(structural_pipeline()).run(tg)
    for mode in ("direct", "im2col"):
        for act_bytes in (1, 4):
            assert scratch_bytes_for(tgs, batch=8, act_bytes=act_bytes,
                                     dw_mode=mode) == \
                j_scratch(jgs, batch=8, act_bytes=act_bytes, dw_mode=mode)
    assert scratch_bytes_for(tgs, batch=8, act_bytes=1, dw_mode="im2col") > \
        scratch_bytes_for(tgs, batch=8, act_bytes=1, dw_mode="direct")
