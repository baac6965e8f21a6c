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
    assert tr.PEAK_FLOPS_BF16 == 989e12
    assert tr.HBM_BW == 3.35e12
    assert tr.NVLINK_BW == 450e9 and tr.IB_BW == 50e9
    assert tr.GPUS_PER_NODE == 8
    assert tr.predict_latency_s(2 * 1.979e15, 0.0) == 2.0
    assert tr.predict_latency_s(0.0, 3.35e12) == 1.0
    # none of the reference's TPU constants came along: the bf16 peak is
    # the H100's, and its ICI link has no counterpart
    assert tr.PEAK_FLOPS_BF16 != jr.PEAK_FLOPS_BF16
    for name in ("PEAK_FLOPS_INT8", "ICI_BW"):
        assert not hasattr(tr, name)


# -- the dry-run's half: the mirrors of test_roofline_pruning.py's four ----

def _stats_equal(got, want):
    assert dict(got.counts) == dict(want.counts)
    assert set(got.bytes_by_op) == set(want.bytes_by_op)
    for op, b in want.bytes_by_op.items():
        assert got.bytes_by_op[op] == b, op
    assert got.wire_bytes == want.wire_bytes
    assert got.raw_bytes == want.raw_bytes


@pytest.mark.parametrize("sample", ["hlo", "tuple"])
def test_parse_collectives_equals_the_reference(sample):
    from test_roofline_pruning import HLO_SAMPLE
    txt = HLO_SAMPLE if sample == "hlo" else (
        '%t = (f32[8,8]{1,0}, f32[4]{0}) all-reduce(%a, %b), '
        'replica_groups=[4,64]<=[256], to_apply=%add')
    got, want = tr.parse_collectives(txt), jr.parse_collectives(txt)
    _stats_equal(got, want)
    # every wire byte lies on one link or the other
    assert got.nvlink_wire_bytes + got.ib_wire_bytes == got.wire_bytes


def test_parse_collectives_prices_groups_by_node():
    """The sample's 16-rank all-reduce and all-gather span two 8-GPU nodes
    (InfiniBand); its 8-rank reduce-scatter and the permute lie in one
    (NVLink)."""
    from test_roofline_pruning import HLO_SAMPLE
    st = tr.parse_collectives(HLO_SAMPLE)
    ar = 2 * 15 / 16 * 16 * 1024 * 4
    ag = 15 / 16 * 4096 * 512 * 2
    rs = 7 * 256 * 512 * 2
    assert st.ib_wire_bytes == ar + ag
    assert st.nvlink_wire_bytes == rs + 128
    rep = tr.RooflineReport("a", "s", "16x16", 256, 0.0, 0.0, st, 1.0)
    assert rep.collective_s == (ar + ag) / tr.IB_BW + (rs + 128) / tr.NVLINK_BW


def test_roofline_bound_selection():
    coll = tr.CollectiveStats(counts={}, bytes_by_op={}, wire_bytes=5e9,
                              raw_bytes=5e9, ib_wire_bytes=5e9)
    r = tr.RooflineReport("a", "s", "16x16", 256, flops_per_device=1e12,
                          bytes_per_device=1e9, collective=coll,
                          model_flops=1e15)
    assert r.collective_s > r.memory_s and r.collective_s > r.compute_s
    assert r.bound == "collective"
    assert 0 < r.mfu < 1
    assert r.compute_s == 1e12 / 989e12 and r.memory_s == 1e9 / 3.35e12
    # the same bytes inside one node are 9x cheaper: memory-bound then
    fast = tr.CollectiveStats(wire_bytes=5e9, nvlink_wire_bytes=5e9)
    r = tr.RooflineReport("a", "s", "16x16", 256, 1e12, 1e11, fast, 1e15)
    assert r.bound == "memory" and r.step_s == r.memory_s
    jrep = jr.RooflineReport("a", "s", "16x16", 256, 1e12, 1e11, fast, 1e15)
    assert set(r.to_dict()) == set(jrep.to_dict())


def test_model_flops_equal_the_reference_for_every_cell():
    from repro.configs import ARCH_IDS
    from repro.configs import get_config as j_get_config
    from repro.configs.base import shapes_for as j_shapes_for
    from repro_torch.configs import get_config, shapes_for
    for arch in ARCH_IDS:
        jc, tc = j_get_config(arch), get_config(arch)
        assert tc.active_param_count() == jc.active_param_count()
        js, ts = j_shapes_for(jc), shapes_for(tc)
        assert [s.name for s in ts] == [s.name for s in js]
        for jsh, tsh in zip(js, ts):
            assert tr.model_flops_for(tc, tsh, tc.active_param_count()) == \
                jr.model_flops_for(jc, jsh, jc.active_param_count()), \
                (arch, tsh.name)
