"""The port's roofline terms against ``repro.launch.roofline``: MAC counts and
im2col scratch bytes per node on both CNNs, and the latency model with
explicit constants; the defaults are the H100's."""
import jax
import numpy as np
import pytest

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core.passes import PassManager as JPassManager
from repro.core.passes import structural_pipeline as j_structural
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.launch import roofline as jr
from repro.models import cnn as j_models

from repro_torch.configs.mnist_cnn import CONFIG as T_CNN
from repro_torch.configs.separable_cnn import CONFIG as T_SEP
from repro_torch.core.passes import PassManager, structural_pipeline
from repro_torch.core.reader import cnn_to_ir as t_cnn_to_ir
from repro_torch.core.reader import separable_cnn_to_ir as t_sep_to_ir
from repro_torch.launch import roofline as tr
from repro_torch.models import cnn as t_models

MODELS = ["separable-cnn", "mnist-cnn"]


def _graphs(which):
    """(reference, port) graphs after the structural passes (value_info
    populated), from the same numpy params."""
    if which == "separable-cnn":
        p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(0))
        p = {k: np.asarray(v) for k, v in p.items()}
        jg = j_sep_to_ir(J_SEP, p)
        tg = t_sep_to_ir(T_SEP, t_models.params_from_jax(p, "cpu"))
    else:
        p = j_models.init_params(J_CNN, jax.random.PRNGKey(0))
        p = {k: np.asarray(v) for k, v in p.items()}
        jg = j_cnn_to_ir(J_CNN, p)
        tg = t_cnn_to_ir(T_CNN, t_models.params_from_jax(p, "cpu"))
    return (JPassManager(j_structural()).run(jg),
            PassManager(structural_pipeline()).run(tg))


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("which", MODELS)
def test_mac_count_equals_the_reference_per_node(which, batch):
    jg, tg = _graphs(which)
    got = tr.graph_mac_count(tg, batch=batch)
    assert got == jr.graph_mac_count(jg, batch=batch)
    assert got["_total"] == sum(v for k, v in got.items() if k != "_total")
    assert len(got) > 3


@pytest.mark.parametrize("act_bytes", [1, 4])
@pytest.mark.parametrize("which", MODELS)
def test_im2col_scratch_equals_the_reference_per_node(which, act_bytes):
    jg, tg = _graphs(which)
    for batch in (1, 8):
        got = tr.im2col_scratch_bytes(tg, batch=batch, act_bytes=act_bytes)
        assert got == jr.im2col_scratch_bytes(jg, batch=batch,
                                              act_bytes=act_bytes)
    if which == "separable-cnn":
        # each depthwise conv's dense expansion spans all its channels
        assert got["dw0"] == 8 * 14 * 14 * 9 * 8 * act_bytes


def test_separable_im2col_depthwise_rows():
    """The im2col depthwise baseline's patch matrices: dw0 is 1568 x 72 and
    dw1 392 x 144 at batch 8 (the qgemm shapes the baseline launches)."""
    _, tg = _graphs("separable-cnn")
    got = tr.im2col_scratch_bytes(tg, batch=8, act_bytes=1)
    assert got["dw0"] == 1568 * 72 and got["dw1"] == 392 * 144


@pytest.mark.parametrize("flops,nbytes", [(0.0, 0.0), (2e9, 1e6),
                                          (5e12, 1e3), (1e3, 7e9)])
def test_latency_with_explicit_constants_equals_the_reference(flops, nbytes):
    for peak, bw in ((1979e12, 3.35e12), (67e12, 3.35e12), (1e12, 1e9)):
        assert tr.predict_latency_s(flops, nbytes, peak_flops=peak,
                                    hbm_bw=bw) == \
            jr.predict_latency_s(flops, nbytes, peak_flops=peak, hbm_bw=bw)


def test_defaults_are_the_h100s():
    assert tr.PEAK_OPS_INT8 == 1.979e15
    assert tr.PEAK_FLOPS_F32 == 67e12
    assert tr.HBM_BW == 3.35e12
    assert tr.predict_latency_s(2 * 1.979e15, 0.0) == 2.0
    assert tr.predict_latency_s(0.0, 3.35e12) == 1.0
    # none of the reference's TPU constants came along
    for name in ("PEAK_FLOPS_BF16", "PEAK_FLOPS_INT8", "ICI_BW"):
        assert not hasattr(tr, name)
