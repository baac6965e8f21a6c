"""The port's greedy mixed-precision explorer: every test of
``tests/test_precision_explorer.py`` under the port's mapping (flows on the
CPU, target ``"torch"``), and parity with
``repro.core.passes.explore_mixed_precision``: the same PrecisionMap and the
same history on the same graph and calibration batch.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.core.flow import DesignFlow as JFlow
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import mlp_to_ir as j_mlp_to_ir
from repro.models import cnn as j_models

from repro_torch.configs.mnist_cnn import CONFIG as CNN
from repro_torch.core.flow import DesignFlow
from repro_torch.core.passes import strip_precision
from repro_torch.core.reader import cnn_to_ir, mlp_to_ir
from repro_torch.core.writers.torch_writer import TorchWriter
from repro_torch.models import cnn as cnn_model
from repro_torch.quant.qtypes import PrecisionMap

TOL = 0.1
SEED = 1234


def _mlp_params():
    sizes = [16, 12, 8, 5]
    rng = np.random.default_rng(SEED)
    params = {}
    for i in range(len(sizes) - 1):
        params[f"fc{i}/w"] = (0.5 * rng.normal(size=(sizes[i], sizes[i + 1]))
                              ).astype(np.float32)
        params[f"fc{i}/b"] = (0.2 * rng.normal(size=(sizes[i + 1],))
                              ).astype(np.float32)
    return sizes, params


@pytest.fixture(scope="module")
def mlp_setup():
    sizes, params = _mlp_params()
    g = mlp_to_ir(sizes, params)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED), (32, 16)))
    return DesignFlow(g, device="cpu"), x


def _agreement(flow, pm, x) -> float:
    """Top-1 agreement of the quantized executable vs. the float reference
    on the calibration batch."""
    res = flow.run(targets=("torch",), dtconfig=pm, calib_inputs=(x,))
    ref = TorchWriter(strip_precision(res.graph), device="cpu").build()(x)
    got = res.executables["torch"](x)
    return float((got.argmax(-1) == ref.argmax(-1)).to(torch.float32).mean())


def test_explorer_is_deterministic(mlp_setup):
    flow, x = mlp_setup
    pm1, hist1 = flow.explore_mixed_precision((x,), ladder=(16, 8, 4, 2),
                                              tol=TOL)
    pm2, hist2 = flow.explore_mixed_precision((x,), ladder=(16, 8, 4, 2),
                                              tol=TOL)
    assert pm1 == pm2
    assert hist1 == hist2


def test_explorer_never_breaches_accuracy_floor(mlp_setup):
    flow, x = mlp_setup
    pm, history = flow.explore_mixed_precision((x,), ladder=(16, 8, 4, 2),
                                               tol=TOL)
    assert all(h["agreement"] >= 1.0 - TOL for h in history)
    assert _agreement(flow, pm, x) >= 1.0 - TOL


def test_explorer_accepts_moves_and_monotonic_ladder(mlp_setup):
    flow, x = mlp_setup
    pm, history = flow.explore_mixed_precision((x,), ladder=(16, 8, 4),
                                               tol=0.5)
    assert history, "with tol=0.5 the greedy search must accept moves"
    assert isinstance(pm, PrecisionMap)
    ladder = (16, 8, 4)
    for cfg in pm.per_node.values():
        assert cfg.weight_bits in ladder
    final = {n: 16 for n in pm.per_node}
    for h in history:
        final[h["layer"]] = h["weight_bits"]
    assert final == {n: c.weight_bits for n, c in pm.per_node.items()}


def _cnn_case():
    """(reference flow, port flow, calibration batch) of the seed-pinned
    mnist-cnn of ``test_explorer_deterministic_on_cnn_graph``."""
    params = j_models.init_params(J_CNN, jax.random.PRNGKey(0))
    params = {k: np.asarray(v) for k, v in params.items()}
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (16, 28, 28, 1)))
    tg = cnn_to_ir(CNN, cnn_model.params_from_jax(params, "cpu"))
    return JFlow(j_cnn_to_ir(J_CNN, params)), DesignFlow(tg, device="cpu"), x


def test_explorer_deterministic_on_cnn_graph():
    _, flow, x = _cnn_case()
    pm1, h1 = flow.explore_mixed_precision((x,), ladder=(16, 8), tol=0.5)
    pm2, h2 = flow.explore_mixed_precision((x,), ladder=(16, 8), tol=0.5)
    assert pm1 == pm2 and h1 == h2
    assert set(pm1.per_node) == {"conv0", "conv1", "fc"}


# ---------------------------------------------------------------------------
# parity with the reference's explorer
# ---------------------------------------------------------------------------


def _same_map(t_pm, j_pm):
    as_tuple = (lambda dt: (dt.act_bits, dt.weight_bits))
    assert as_tuple(t_pm.default) == as_tuple(j_pm.default)
    assert {n: as_tuple(c) for n, c in t_pm.per_node.items()} == \
        {n: as_tuple(c) for n, c in j_pm.per_node.items()}


@pytest.mark.parametrize("ladder,tol", [((16, 8, 4, 2), TOL),
                                        ((16, 8, 4), 0.5)])
def test_mlp_search_equals_the_reference(mlp_setup, ladder, tol):
    flow, x = mlp_setup
    sizes, params = _mlp_params()
    j_pm, j_hist = JFlow(j_mlp_to_ir(sizes, params)).explore_mixed_precision(
        (x,), ladder=ladder, tol=tol)
    t_pm, t_hist = flow.explore_mixed_precision((x,), ladder=ladder, tol=tol)
    _same_map(t_pm, j_pm)
    assert t_hist == j_hist


def test_cnn_search_equals_the_reference():
    jflow, flow, x = _cnn_case()
    j_pm, j_hist = jflow.explore_mixed_precision((x,), ladder=(16, 8, 4),
                                                 tol=0.5)
    t_pm, t_hist = flow.explore_mixed_precision((x,), ladder=(16, 8, 4),
                                                tol=0.5)
    _same_map(t_pm, j_pm)
    assert t_hist == j_hist
    assert t_hist, "tol=0.5 accepts moves on the CNN too"
