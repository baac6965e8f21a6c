"""The slice end to end against the reference, on separable-cnn and mnist-cnn
at their config widths: calibrated code qtypes equal; with the reference's
act_ranges every inter-layer FIFO's int8 codes and the logits are
array_equal at W8/W4/W2 with packed weights on and off; every working point
reads ONE packed buffer; and ``serve_adaptive`` coalesces requests into
batches whose results equal per-request results while switching W8->W4->W2.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core.flow import DesignFlow as JFlow
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.models import cnn as j_models
from repro.quant.ptq import act_code_qtype as j_acq
from repro.quant.qtypes import DatatypeConfig as JDT

from repro_torch.configs.mnist_cnn import CONFIG as T_CNN
from repro_torch.configs.separable_cnn import CONFIG as T_SEP
from repro_torch.core.adaptive import (RuntimePolicy, WorkingPoint,
                                       shared_point_executables)
from repro_torch.core.flow import DesignFlow as TFlow
from repro_torch.core.flow import WriterOptions
from repro_torch.core.reader import cnn_to_ir as t_cnn_to_ir
from repro_torch.core.reader import separable_cnn_to_ir as t_sep_to_ir
from repro_torch.core.writers.qtorch_writer import ActCode, QTorchWriter
from repro_torch.models import cnn as t_models
from repro_torch.quant.ptq import act_code_qtype as t_acq
from repro_torch.quant.qtypes import DatatypeConfig as TDT

POINTS = [WorkingPoint("w8", 8), WorkingPoint("w4", 4), WorkingPoint("w2", 2)]
MODELS = ["separable-cnn", "mnist-cnn"]


class _Case:
    """One model: the reference flow (ref path, no Pallas) and the port's
    graph from the same numpy params."""

    def __init__(self, which):
        if which == "separable-cnn":
            p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(0))
            p = {k: np.asarray(v) for k, v in p.items()}
            self.jg = j_sep_to_ir(J_SEP, p)
            self.tg = t_sep_to_ir(T_SEP, t_models.params_from_jax(p, "cpu"))
        else:
            p = j_models.init_params(J_CNN, jax.random.PRNGKey(0))
            p = {k: np.asarray(v) for k, v in p.items()}
            self.jg = j_cnn_to_ir(J_CNN, p)
            self.tg = t_cnn_to_ir(T_CNN, t_models.params_from_jax(p, "cpu"))
        rng = np.random.default_rng(0)
        self.calib = rng.random((3, 28, 28, 1), np.float32)
        self.x = rng.random((2, 28, 28, 1), np.float32)
        self.jres = JFlow(self.jg).run(
            ("qjax",), JDT(8, 8), calib_inputs=(self.calib,),
            writer_kwargs={"qjax": {"use_kernel": False}})
        self.jout = {}
        for bits in (8, 4, 2):
            y, env = self.jres.writers["qjax"].build(capture=True,
                                                     bits=bits)(self.x)
            self.jout[bits] = (np.asarray(y), {
                k: np.asarray(v.codes) for k, v in env.items()
                if hasattr(v, "codes")})

    def port(self, **kw):
        """The port's flow on the CPU with the reference's act_ranges."""
        return TFlow(self.tg, device="cpu").run(
            ("qtorch",), TDT(8, 8), act_ranges=self.jres.act_ranges, **kw)


_CASES = {}


@pytest.fixture(scope="module", params=MODELS)
def case(request):
    if request.param not in _CASES:
        _CASES[request.param] = _Case(request.param)
    return _CASES[request.param]


def test_calibrated_code_qtypes_equal(case):
    tres = TFlow(case.tg, device="cpu").run(("qtorch",), TDT(8, 8),
                                             calib_inputs=(case.calib,))
    j, t = case.jres.act_ranges, tres.act_ranges
    assert set(t) == set(j)
    for k in j:
        # float conv sums in another order: ranges agree to rtol 1e-5, and
        # the power-of-two code qtypes derived from them exactly
        assert t[k] == pytest.approx(j[k], rel=1e-5, abs=1e-30)
        assert (t_acq(8, t[k]).frac, t_acq(8, t[k]).bits) == \
            (j_acq(8, j[k]).frac, j_acq(8, j[k]).bits)
    assert tres.graph.to_json() == case.jres.graph.to_json()


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_fifo_codes_and_logits_bit_exact(case, bits, packed):
    w = case.port(options=WriterOptions(packed_weights=packed)).writers[
        "qtorch"]
    assert w.packed_storage is packed
    y, env = w.build(capture=True, bits=bits)(case.x)
    jy, jcodes = case.jout[bits]
    np.testing.assert_array_equal(y.numpy(), jy)
    outputs = set(w.graph.outputs)
    for node in w.graph.topo_order():
        for o in node.outputs:
            if o in outputs:
                continue
            assert isinstance(env[o], ActCode) and env[o].codes.dtype == \
                torch.int8, f"{node.op} output {o} is not int8 codes"
            np.testing.assert_array_equal(env[o].codes.numpy(), jcodes[o],
                                          err_msg=o)
    assert isinstance(env["input"], ActCode)
    np.testing.assert_array_equal(env["input"].codes.numpy(), jcodes["input"])


def test_points_share_one_packed_buffer(case):
    writer = case.port().writers["qtorch"]
    pts = shared_point_executables(writer, POINTS)
    assert [pts[p.name].bits for p in POINTS] == [8, 4, 2]
    for name, t in writer.packed.tensors.items():
        ptrs = {pts[p.name].packed.tensors[name].codes.data_ptr()
                for p in POINTS}
        assert ptrs == {t.codes.data_ptr()}, f"{name} duplicated"
    # W4/W2 views are cached once and reused by every build
    a = writer.build(bits=4)(case.x)
    views = {n: t._packed.get((4, 8 if n.startswith("dw") else 128))
             for n, t in writer.packed.tensors.items()}
    assert all(v is not None for v in views.values())
    b = writer.build(bits=4)(case.x)
    assert all(writer.packed.tensors[n]._packed[k] is v for n, v in
               views.items() for k in [(4, 8 if n.startswith("dw") else 128)])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    rep = writer.packed.sharing_report(3)
    assert rep["shared_bytes"] * 3 == rep["per_point_copy_bytes"]
    assert rep["view_bytes"][4] <= 0.55 * rep["view_bytes"][8]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_serve_adaptive_coalesces_and_switches_bits(case):
    res = case.port()
    clock = _Clock()
    srv = res.serve_adaptive(
        POINTS, policy=RuntimePolicy(POINTS, thresholds=[0.66, 0.33]),
        max_batch=8, max_wait=0.01, clock=clock)
    rng = np.random.default_rng(3)
    writer = res.writers["qtorch"]
    for budget, bits in ((1.0, 8), (0.5, 4), (0.1, 2)):
        reqs = [rng.random((n, 28, 28, 1), np.float32) for n in (1, 3, 2, 2)]
        tickets = [srv.submit(r, budget=budget) for r in reqs]
        clock.t += 1.0
        srv.pump()
        for r, t in zip(reqs, tickets):
            got = srv.result(t)
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(
                got, writer.build(bits=bits)(r).numpy())
    stats = srv.stats()
    assert stats["bits_views"] == {8: 1, 4: 1, 2: 1}     # 8 rows -> 1 batch
    assert [r.bits for r in srv.reports] == [8, 4, 2]
    assert [r.rows for r in srv.reports] == [8, 8, 8]
    assert stats["bits_bytes"] == {b: writer.packed.view_bytes(b)
                                   for b in (8, 4, 2)}


def test_serve_adaptive_needs_the_packed_writer(case):
    res = TFlow(case.tg, device="cpu").run(("torch",))
    with pytest.raises(KeyError, match="qtorch"):
        res.serve_adaptive(POINTS)
    with pytest.raises(TypeError, match="packed"):
        shared_point_executables(res.writers["torch"], POINTS)


def test_writer_options_and_default_bits(case):
    g = case.port().graph
    assert QTorchWriter(g, TDT(8, 8), device="cpu").default_bits == 8
    assert QTorchWriter(g, TDT(8, 4), device="cpu").default_bits == 4
    with pytest.raises(ValueError, match="unknown option"):
        TFlow(case.tg, device="cpu").run(
            ("qtorch",), TDT(8, 8), writer_kwargs={"qtorch": {"bogus": 1}})


def _selector_pairs():
    from repro.core import adaptive as j_ad
    from repro_torch.core import adaptive as t_ad
    jp = [j_ad.WorkingPoint(p.name, p.weight_bits) for p in POINTS]
    slo = dict(p95_latency_s=0.01, window=8, min_samples=4, hold=4)
    return [
        (j_ad.RuntimePolicy(jp), t_ad.RuntimePolicy(POINTS)),
        (j_ad.BudgetSelector(jp, [0.8, 0.2]),
         t_ad.BudgetSelector(POINTS, [0.8, 0.2])),
        (j_ad.FixedSelector(jp[1]), t_ad.FixedSelector(POINTS[1])),
        (j_ad.SLOController(jp, j_ad.ServiceObjective(**slo)),
         t_ad.SLOController(POINTS, t_ad.ServiceObjective(**slo))),
    ]


@pytest.mark.parametrize("idx", range(4), ids=["RuntimePolicy",
                                                "BudgetSelector",
                                                "FixedSelector",
                                                "SLOController"])
def test_point_selectors_choose_like_the_reference(idx):
    j, t = _selector_pairs()[idx]
    rng = np.random.default_rng(idx)
    for _ in range(64):
        budget = float(rng.random())
        assert t.select(budget).name == j.select(budget).name
        lat = float(rng.random() * 0.02)
        j.observe(lat)
        t.observe(lat)
    if idx == 3:
        assert t.shifts == j.shifts and t.telemetry() == j.telemetry()


def test_background_pump_serves_every_request(case):
    """The pump thread (as chip_smoke.py runs it on the card): every ticket
    resolves to the per-request result, at the point its budget selects."""
    res = case.port()
    srv = res.serve_adaptive(
        POINTS, policy=RuntimePolicy(POINTS, thresholds=[0.66, 0.33]),
        max_batch=4, max_wait=0.001)
    writer = res.writers["qtorch"]
    rng = np.random.default_rng(5)
    reqs = [(rng.random((1 + i % 3, 28, 28, 1), np.float32), b)
            for i, b in enumerate([1.0, 1.0, 0.5, 0.5, 0.1, 0.1])]
    with srv:
        tickets = [srv.submit(x, budget=b) for x, b in reqs]
        got = [t.result(timeout=60) for t in tickets]
    assert not srv.alive
    for (x, b), y in zip(reqs, got):
        assert y.shape == (x.shape[0], 10)
        # a request coalesced with a lower-budget one runs at that point
        outs = {bits: writer.build(bits=bits)(x).numpy() for bits in (8, 4, 2)}
        assert any(np.array_equal(y, o) for o in outs.values())
    assert srv.stats()["submitted"] == len(reqs)


@pytest.mark.parametrize("target,j_target", [("torch", "jax"),
                                             ("qtorch", "qjax"),
                                             ("stream", "stream"),
                                             ("no-such-target", "no-such")])
def test_registered_ops_cover_the_reference_op_names(target, j_target):
    """Each target's effective op table names the ops the reference's table
    for its counterpart names: the ``"torch"`` impls, with the target's own
    merged over them (an unknown target gets the ``"torch"`` table)."""
    from repro.core.writers.registry import registered_ops as j_ops
    from repro_torch.core.writers.registry import OP_REGISTRY, registered_ops
    table = registered_ops(target)
    assert set(table) == set(j_ops(j_target))
    own = OP_REGISTRY.get(target, {}) if target != "torch" else {}
    for op, impl in table.items():
        assert impl is own.get(op, OP_REGISTRY["torch"][op]), op
    table.clear()                              # a copy: the registry stays
    assert registered_ops(target)
