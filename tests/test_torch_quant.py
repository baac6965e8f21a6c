"""The port's numerics core against the reference, exactly: fixed-point
quantization and its error, the Table II points and the fixed-point weight
tree, the activation quantizer and its calibration, nested views, the master-code rule, activation-code qtypes,
split-row packing at both alignments, and the packed weight buffer of both
CNNs (codes, scales, resident bytes, every CRC32 region seal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_cnn import CONFIG as J_CNN
from repro.configs.separable_cnn import CONFIG as J_SEP
from repro.core.reader import cnn_to_ir as j_cnn_to_ir
from repro.core.reader import separable_cnn_to_ir as j_sep_to_ir
from repro.models import cnn as j_models
from repro.quant import fixedpoint as j_fp
from repro.quant import pack as j_pack
from repro.quant import ptq as j_ptq
from repro.quant.qtypes import QType as JQType
from repro.quant.qtypes import fixed_for_range as j_ffr

from repro_torch.quant import fixedpoint as t_fp
from repro_torch.quant import pack as t_pack
from repro_torch.quant import ptq as t_ptq
from repro_torch.quant import qtypes as t_qt
from repro_torch.quant.qtypes import QType as TQType
from repro_torch.quant.qtypes import fixed_for_range as t_ffr

QTYPES = [(8, 4), (8, 7), (16, 10), (4, 2), (2, 1), (8, -2)]


def _x(seed=0, shape=(64, 33), scale=6.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.flat[:8] = [0.5, -0.5, 1.5, 2.5, -2.5, 0.0, 127.5, -128.5]   # ties
    return x


@pytest.mark.parametrize("bits,frac", QTYPES)
def test_quantize_and_fake_quant_exact(bits, frac):
    x = _x(bits + frac)
    jq, tq = JQType(bits, frac), TQType(bits, frac)
    np.testing.assert_array_equal(
        t_fp.quantize(torch.from_numpy(x), tq).numpy(),
        np.asarray(j_fp.quantize(jnp.asarray(x), jq)))
    np.testing.assert_array_equal(
        t_fp.fake_quant(torch.from_numpy(x), tq).numpy(),
        np.asarray(j_fp.fake_quant(jnp.asarray(x), jq)))
    # a statistic, not a code: both take an f32 mean, summed in another order
    assert float(t_fp.zero_fraction(torch.from_numpy(x), tq)) == pytest.approx(
        float(j_fp.zero_fraction(jnp.asarray(x), jq)), rel=1e-6)


@pytest.mark.parametrize("max_abs", [1e-9, 0.01, 0.3, 1.0, 1.0001, 7.99, 8.0,
                                     100.0])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_fixed_for_range_and_act_code_qtype(bits, max_abs):
    assert (t_ffr(bits, max_abs).bits, t_ffr(bits, max_abs).frac) == \
        (j_ffr(bits, max_abs).bits, j_ffr(bits, max_abs).frac)
    t, j = t_ptq.act_code_qtype(bits, max_abs), j_ptq.act_code_qtype(bits,
                                                                     max_abs)
    assert (t.bits, t.frac, t.qmin, t.qmax) == (j.bits, j.frac, j.qmin, j.qmax)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_derive_view_exact(bits):
    codes = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        t_ptq.derive_view(torch.from_numpy(codes), bits).numpy(),
        np.asarray(j_ptq.derive_view(jnp.asarray(codes), bits)))


@pytest.mark.parametrize("shape", [(9, 8), (3, 3, 1, 16), (1, 1, 16, 32),
                                   (1568, 10)])
def test_quantize_channelwise_byte_exact(shape):
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32) * 0.2
    w.reshape(-1, shape[-1])[:, 0] = 0.0          # an all-zero channel
    tc, ts = t_ptq.quantize_channelwise(torch.from_numpy(w))
    jc, js = j_ptq.quantize_channelwise(jnp.asarray(w))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tc.numpy().tobytes() == np.asarray(jc).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    for bits in (8, 4, 2):
        np.testing.assert_array_equal(
            t_ptq.dequant(tc, ts, bits).numpy(),
            np.asarray(j_ptq.dequant(jc, js, bits, jnp.float32)))


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("rows,align", [(9, 8), (9, 128), (200, 128),
                                        (1568, 128)])
def test_pack_rows_bytes_and_roundtrip(bits, align, rows):
    codes = np.random.default_rng(rows + bits).integers(
        -127, 128, (rows, 24)).astype(np.int8)
    tp = t_pack.pack_rows(torch.from_numpy(codes), bits, align=align)
    jp = j_pack.pack_rows(jnp.asarray(codes), bits, align=align)
    assert tp.dtype == torch.uint8
    assert tp.numpy().tobytes() == np.asarray(jp).tobytes()
    up = t_pack.unpack_rows(tp, bits).numpy()
    np.testing.assert_array_equal(up, np.asarray(j_pack.unpack_rows(jp, bits)))
    np.testing.assert_array_equal(
        up[:rows], t_ptq.derive_view(torch.from_numpy(codes), bits).numpy())
    assert (up[rows:] == 0).all()


def _inits(which):
    if which == "mnist-cnn":
        p = j_models.init_params(J_CNN, jax.random.PRNGKey(0))
        g = j_cnn_to_ir(J_CNN, {k: np.asarray(v) for k, v in p.items()})
    else:
        p = j_models.init_separable_params(J_SEP, jax.random.PRNGKey(0))
        g = j_sep_to_ir(J_SEP, {k: np.asarray(v) for k, v in p.items()})
    return g.initializers


@pytest.mark.parametrize("which", ["mnist-cnn", "separable-cnn"])
def test_packed_weights_codes_scales_bytes_and_crcs_equal(which):
    inits = _inits(which)
    tw = t_pack.PackedWeights.from_initializers(inits, "cpu")
    jw = j_pack.PackedWeights.from_initializers(inits)
    assert set(tw.tensors) == set(jw.tensors)
    assert set(tw.passthrough) == set(jw.passthrough)
    for name, jt in jw.tensors.items():
        tt = tw.tensors[name]
        assert tt.codes.numpy().tobytes() == np.asarray(jt.codes).tobytes()
        assert tt.scale.numpy().tobytes() == np.asarray(jt.scale).tobytes()
        # the alignment each writer streams: depthwise taps at 8, else 128
        align = 8 if name.startswith("dw") else t_pack.PACK_ALIGN
        for bits in (4, 2):
            assert tt.packed_view(bits, align).numpy().tobytes() == \
                np.asarray(jt.packed_view(bits, align)).tobytes()
        assert tt.packed_view(4, align) is tt.packed_view(4, align)  # cached
        for bits in (8, 4, 2):
            assert tt.view_nbytes(bits) == jt.view_nbytes(bits)
    # every sealed region, codes/scales/views, hashes identically
    t_regions = {r.label(): r for r in tw.regions()}
    j_regions = {r.label(): r for r in jw.regions()}
    assert set(t_regions) == set(j_regions)
    for label, r in t_regions.items():
        assert r.nbytes == j_regions[label].nbytes
        assert tw.tensors[r.tensor]._sealed_crc(r) == \
            jw.tensors[r.tensor]._sealed_crc(j_regions[label])
    assert tw.code_bytes() == jw.code_bytes()
    for bits in (8, 4, 2):
        assert tw.view_bytes(bits) == jw.view_bytes(bits)
    assert tw.sharing_report(3) == jw.sharing_report(3)


def test_region_verify_detects_a_flipped_byte():
    tw = t_pack.PackedWeights.from_initializers(_inits("separable-cnn"), "cpu")
    t = tw.tensors["pw1/w"]
    t.packed_view(4)
    assert tw.verify() == []
    t.codes.view(-1)[3] ^= 0x10                 # a silent bit flip
    bad = tw.verify()
    assert [m.region.label() for m in bad] == ["pw1/w:codes"]
    assert not bad[0].repairable
    assert tw.verify(bits=4) == []              # the W4 view is untouched


def test_weight_stats_and_top1_agreement():
    from repro.core.ir import Graph as JGraph
    from repro_torch.core.ir import Graph as TGraph
    inits = _inits("mnist-cnn")
    for dt in (8, 4, 2):
        jg = JGraph("g", [], [], [], inits)
        tg = TGraph("g", [], [], [], inits)
        from repro.quant.qtypes import DatatypeConfig as JDT
        from repro_torch.quant.qtypes import DatatypeConfig as TDT
        # f32 means summed in another order: equal to a few ulps
        assert t_ptq.graph_weight_stats(tg, TDT(32, dt))["zero_weight_frac"] \
            == pytest.approx(j_ptq.graph_weight_stats(jg, JDT(32, dt))
                             ["zero_weight_frac"], rel=1e-6)
    rng = np.random.default_rng(0)
    a, b = rng.random((20, 10)), rng.random((20, 10))
    assert t_ptq.top1_agreement(a, b) == j_ptq.top1_agreement(a, b)


@pytest.mark.parametrize("bits,dtype", [(16, torch.bfloat16), (8, torch.int8),
                                        (4, torch.int8), (2, torch.int8)])
def test_storage_dtype_maps_sub_byte_widths_to_int8(bits, dtype):
    from repro_torch.quant.qtypes import storage_dtype
    assert storage_dtype(bits) is dtype


def test_pack_int4_roundtrip():
    codes = torch.arange(-8, 8, dtype=torch.int8).reshape(2, 8)
    packed = t_pack.pack_int4(codes)
    assert packed.shape == (2, 4) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(t_pack.unpack_int4(packed).numpy(),
                                  codes.numpy())
    assert packed.numpy().tobytes() == np.asarray(
        j_pack.pack_int4(jnp.asarray(codes.numpy()))).tobytes()


def test_pack_int2_roundtrip():
    codes = torch.tensor([[-2, -1, 0, 1] * 2], dtype=torch.int8)
    packed = t_pack.pack_int2(codes)
    assert packed.shape == (1, 2) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(t_pack.unpack_int2(packed).numpy(),
                                  codes.numpy())
    assert packed.numpy().tobytes() == np.asarray(
        j_pack.pack_int2(jnp.asarray(codes.numpy()))).tobytes()


@pytest.mark.parametrize("bits,shape", [(4, (3, 5, 16)), (2, (7, 12)),
                                        (4, (64,)), (2, (2, 2, 8))])
def test_pack_int_bytes_equal_the_reference(bits, shape):
    half = 1 << (bits - 1)
    codes = np.random.default_rng(bits + len(shape)).integers(
        -half, half, shape).astype(np.int8)
    pack, unpack = ((t_pack.pack_int4, t_pack.unpack_int4) if bits == 4
                    else (t_pack.pack_int2, t_pack.unpack_int2))
    j_pack_fn = j_pack.pack_int4 if bits == 4 else j_pack.pack_int2
    packed = pack(codes)
    assert packed.numpy().tobytes() == np.asarray(
        j_pack_fn(jnp.asarray(codes))).tobytes()
    np.testing.assert_array_equal(unpack(packed).numpy(), codes)
    with pytest.raises(ValueError):
        pack(codes[..., :-1])


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_packed_weights_dequantized_equals_the_reference(bits):
    inits = _inits("separable-cnn")
    t = t_pack.PackedWeights.from_initializers(inits, "cpu").dequantized(bits)
    j = j_pack.PackedWeights.from_initializers(inits).dequantized(bits)
    assert set(t) == set(j)
    for name in j:
        np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# the Table II fixed-point path: quant_error, quantize_tree_fixed, the points,
# the activation quantizer and its calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,frac", QTYPES)
def test_quant_error_equals_the_reference_and_is_half_a_step(bits, frac):
    x = _x(bits + frac)
    jq, tq = JQType(bits, frac), TQType(bits, frac)
    got = float(t_fp.quant_error(torch.from_numpy(x), tq))
    assert got == float(j_fp.quant_error(jnp.asarray(x), jq))
    inside = np.clip(x, tq.qmin * tq.scale, tq.qmax * tq.scale)
    assert float(t_fp.quant_error(torch.from_numpy(inside), tq)) <= \
        tq.scale / 2
    assert float(t_fp.quant_error(torch.from_numpy(x), t_qt.FLOAT)) == 0.0


def test_table2_points_and_float_equal_the_reference():
    from repro.quant import qtypes as j_qt
    assert [(p.act_bits, p.weight_bits, p.name) for p in t_qt.TABLE2_POINTS] \
        == [(p.act_bits, p.weight_bits, p.name) for p in j_qt.TABLE2_POINTS]
    f, jf = t_qt.FLOAT, j_qt.FLOAT
    assert (f.bits, f.frac, f.signed, f.is_float, str(f)) == \
        (jf.bits, jf.frac, jf.signed, jf.is_float, str(jf))


def test_quantize_tree_fixed_table2_points():
    """The reference's test on the same arrays, and every leaf and the
    statistic equal to the reference's."""
    rng = np.random.default_rng(3)
    params = {"a/w_up": rng.standard_normal((32, 16)).astype(np.float32),
              "a/norm/w": np.ones(16, np.float32),
              "a/b": rng.standard_normal(16).astype(np.float32),
              "c/w": (rng.standard_normal((3, 3, 2, 4)) * 0.1).astype(
                  np.float32)}
    from repro.quant.qtypes import TABLE2_POINTS as J_POINTS
    for dt, jdt in zip(t_qt.TABLE2_POINTS, J_POINTS):
        q, stats = t_ptq.quantize_tree_fixed(
            {k: torch.from_numpy(v) for k, v in params.items()}, dt)
        jq, jstats = j_ptq.quantize_tree_fixed(
            {k: jnp.asarray(v) for k, v in params.items()}, jdt)
        assert q["a/norm/w"].shape == (16,)          # norms untouched
        assert 0.0 <= stats["zero_weight_frac"] <= 1.0
        if dt.weight_bits >= 32:
            for k, v in params.items():
                np.testing.assert_array_equal(q[k].numpy(), v)
        for k in params:
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]),
                                          err_msg=f"{dt.name} {k}")
        # f32 means summed in another order: equal to a few ulps
        assert stats["zero_weight_frac"] == pytest.approx(
            jstats["zero_weight_frac"], rel=1e-6, abs=1e-12)


def test_quantize_tree_fixed_counts_only_quantized_leaves():
    w = np.array([[0.001, 1.0], [-1.0, 0.5]], np.float32)
    q, stats = t_ptq.quantize_tree_fixed(
        {"l/w": torch.from_numpy(w), "l/b": torch.zeros(2)},
        t_qt.DatatypeConfig(16, 2))
    # W2 on the [-2, 1] grid of step 1: 0.001 and 0.5 (a tie) round to 0
    assert stats["zero_weight_frac"] == 0.5
    np.testing.assert_array_equal(q["l/w"].numpy(), [[0.0, 1.0], [-1.0, 0.0]])


@pytest.mark.parametrize("bits", [32, 16, 8, 4])
def test_act_quant_and_calibration_equal_the_reference(bits):
    rng = np.random.default_rng(bits)
    acts = {"conv0_out": (rng.standard_normal((4, 6, 6, 3)) * 3).astype(
                np.float32),
            "fc_out": rng.standard_normal((4, 10)).astype(np.float32),
            "never_calibrated": rng.standard_normal(7).astype(np.float32)}
    calib = {k: v for k, v in acts.items() if k != "never_calibrated"}
    ranges = t_ptq.calibrate_acts(
        lambda: {k: torch.from_numpy(v) for k, v in calib.items()})
    j_ranges = j_ptq.calibrate_acts(
        lambda: {k: jnp.asarray(v) for k, v in calib.items()})
    assert ranges == j_ranges
    tq, jq = t_ptq.ActQuant(bits, ranges), j_ptq.ActQuant(bits, j_ranges)
    for name, v in acts.items():      # an uncalibrated site takes 8.0
        np.testing.assert_array_equal(tq(name, torch.from_numpy(v)).numpy(),
                                      np.asarray(jq(name, jnp.asarray(v))))
    codes = t_ptq.act_code_scales(ranges, bits)
    j_codes = j_ptq.act_code_scales(j_ranges, bits)
    assert {k: (q.bits, q.frac) for k, q in codes.items()} == \
        {k: (q.bits, q.frac) for k, q in j_codes.items()}
    assert all(q.bits == min(bits, 8) for q in codes.values())
