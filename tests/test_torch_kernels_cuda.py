"""The hand-written Hopper kernels against their plain versions on the card —
the same sweep as ``chip_smoke.py``'s kernel phase.  These need an NVIDIA GPU
and nvcc; where there is none they skip with the reason.  Run them on the
card with ``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import checks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def autotune_cache(tmp_path, monkeypatch):
    """Timed tile picks of these tests go to a temporary cache file, never
    the home directory's."""
    from repro_torch.kernels import autotune
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.AUTOTUNE_CACHE_ENV, str(path))
    return path


# the qgemm and qconv_dw calls of both CNNs' qtorch paths at batch 1 and 8
# (the serving buckets' ends), each mode and weight view
PATH_GEMMS = [(b * m, k, n) for b in (1, 8)
              for m, k, n in ((784, 9, 8), (196, 8, 16), (49, 16, 32),
                              (1, 1568, 10), (784, 9, 16), (196, 144, 32))]
PATH_DWS = [((b, 14, 14, c), st) for b in (1, 8)
            for c, st in ((8, (1, 1)), (16, (2, 2)))]
VIEWS = [(8, False), (4, True), (2, True)]


@pytest.mark.cuda
def test_qgemm_kernel_equals_plain_version(cuda):
    res = checks.qgemm_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_qconv_dw_kernel_equals_plain_version(cuda):
    res = checks.qconv_dw_sweep(cuda, windows=checks.DW_WINDOWS)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_kernels_count_launches(cuda):
    from repro_torch.kernels.qconv_dw.ops import qconv_dw
    from repro_torch.kernels.qmatmul.ops import qgemm
    before = (qgemm.launches, qconv_dw.launches)
    checks.qgemm_sweep(cuda, shapes=[(3, 9, 8)])
    checks.qconv_dw_sweep(cuda, shapes=[(1, 5, 5, 8)], strides=[(1, 1)],
                          pads=["SAME"])
    assert qgemm.launches - before[0] == 5 * 3 * 2 * 2
    assert qconv_dw.launches - before[1] == 5 * 3 * 2 * 2


@pytest.mark.cuda
def test_qgemm_counts_one_launch_per_call_in_each_mapping(cuda):
    """The tiled mapping and the skinny one (at a short and a long K) each
    count one launch per call, in both modes, and agree with the plain
    version."""
    from repro_torch.kernels.qmatmul.ops import pick_tiles, qgemm, qgemm_f32
    shapes = [(1568, 8, 16), (8, 1568, 10), (8, 4100, 10)]
    assert [pick_tiles(*sh).mapping for sh in shapes] == [
        "tiled", "skinny", "skinny"]
    before = (qgemm.launches, qgemm_f32.launches)
    res = checks.qgemm_sweep(cuda, shapes=shapes)
    res_f = checks.qgemm_float_sweep(cuda, shapes=shapes)
    torch.cuda.synchronize()
    assert res["failures"] == [] and res["max_abs_err"] == 0.0
    assert res_f["failures"] == [] and res_f["max_tol_frac"] <= 1.0
    # a case's requant probe and reference run the plain version: one
    # kernel launch per case
    assert qgemm.launches - before[0] == res["cases"]
    assert qgemm_f32.launches - before[1] == res_f["cases"]


@pytest.mark.cuda
def test_qgemm_float_kernel_within_tolerance(cuda):
    """The float mode over every sweep shape, the mapping switch included,
    within ``float_qgemm_tol``."""
    res = checks.qgemm_float_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_tol_frac"] <= 1.0


@pytest.mark.cuda
def test_qmatmul_bf16_in_mode_within_tolerance(cuda):
    """The dequant matmul (activations rounded to bf16, the float mode with
    no epilogue) at the reference's test shapes, the ragged 6-row call and
    the FC, bf16 and f32 in, within one bf16 ulp of max|y|; one launch per
    call of 8 rows or more, counted by ``qmatmul`` and ``qgemm_f32``."""
    from repro_torch.kernels.qmatmul.ops import qgemm_f32, qmatmul
    before = (qmatmul.launches, qgemm_f32.launches)
    res = checks.qmatmul_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_tol_frac"] <= 1.0
    launched = sum(min(s) >= 8 for s in checks.QMATMUL_SHAPES) * 3 * 2
    assert qmatmul.launches - before[0] == launched
    assert qgemm_f32.launches - before[1] == launched


@pytest.mark.cuda
def test_qconv_dw_float_kernel_equals_plain_version(cuda):
    """The float depthwise mode, every window: exact."""
    res = checks.qconv_dw_float_sweep(cuda, windows=checks.DW_WINDOWS)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_abs_err"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_integer_truncation_equals_derive_view(cuda, bits):
    """The kernels' integer truncation (a shift and a half-to-even tie
    test) against ``derive_view`` on all 256 int8 codes."""
    from repro_torch.kernels.qmatmul.ops import truncate_view_cuda
    from repro_torch.quant.ptq import derive_view
    codes = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    got = truncate_view_cuda(codes.to(cuda), bits).cpu()
    assert torch.equal(got, derive_view(codes, bits))


@pytest.mark.cuda
def test_ssd_scan_kernel_matches_plain_version(cuda):
    """Every sweep shape but the full-width one (chip_smoke.py runs that),
    f32 and bf16, contiguous and strided views, within ``ssd_scan_tol``."""
    res = checks.ssd_scan_sweep(cuda, shapes=checks.SSD_TEST_SHAPES)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_tol_frac"] <= 1.0


@pytest.mark.cuda
def test_ssd_scan_counts_launches(cuda):
    """Every case of the sweep launches the kernel once, the warm starts
    (a given initial state) included, and each of its three phases once."""
    from repro_torch.kernels.ssd_scan import ops
    phases = (ops.ssd_chunk_state_cuda, ops.ssd_state_pass_cuda,
              ops.ssd_chunk_scan_cuda)
    before = [f.launches for f in (ops.ssd_scan_cuda,) + phases]
    checks.ssd_scan_sweep(cuda, shapes=[(1, 100, 4, 16, 1, 8, 32)])
    after = [f.launches for f in (ops.ssd_scan_cuda,) + phases]
    assert [a - b for a, b in zip(after, before)] == [2 * 2 * 2] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", checks.SSD_PHASE_SHAPES)
def test_ssd_scan_phases_match_their_plain_versions(cuda, shape):
    """Each phase fed the plain version of the phase before it, f32 and
    bf16, from a given initial state: the chunk states and y within
    ``ssd_scan_tol``, the state-passing phase exactly (the full-width
    prefill call and a ragged length)."""
    res = checks.ssd_scan_phase_check(cuda, shapes=[shape])
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_tol_frac"] <= 1.0


@pytest.mark.cuda
def test_ssd_scan_at_hymba_call_matches_plain_version(cuda):
    """hymba-1.5b's prefill call (50 heads, N = 16), f32 and bf16, both
    layouts, from zero and from a given initial state: y and the state
    within ``ssd_scan_tol``; one launch a case."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    before = ssd_scan_cuda.launches
    res = checks.ssd_scan_sweep(cuda, shapes=[checks.SSD_HYMBA_FULL_WIDTH])
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_tol_frac"] <= 1.0
    assert ssd_scan_cuda.launches - before == res["cases"] == 8


@pytest.mark.cuda
def test_ssd_scan_warm_start_matches_the_oracle(cuda):
    """The kernel from a given initial state against the model oracle
    ``ssd_chunked(init_state=...)`` in f32: y within 1e-5 of max|y|, the
    state within 1e-4 of max(1, max|state|), on a ragged length."""
    from repro_torch.kernels.ssd_scan.ops import (ssd_chunked_kernel,
                                                  ssd_scan_cuda)
    from repro_torch.models.ssm import ssd_chunked
    shape = (2, 100, 4, 16, 2, 8, 32)
    x, dt, A, Bm, C, D = checks.ssd_inputs(shape, 3, torch.float32, cuda)
    s0 = torch.randn((2, 4, 16, 8), generator=torch.Generator().manual_seed(
        4)).to(cuda)
    before = ssd_scan_cuda.launches
    y, s = ssd_chunked_kernel(x, dt, A, Bm, C, D, 32, s0)
    assert ssd_scan_cuda.launches == before + 1
    y_o, s_o = ssd_chunked(x, dt, A, Bm, C, D, 32, s0)
    assert float((y - y_o).abs().max()) <= 1e-5 * float(y_o.abs().max())
    assert float((s - s_o).abs().max()) <= 1e-4 * max(
        1.0, float(s_o.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", checks.CONV_STREAM_WIDE_SHAPES
                         + checks.CONV_STREAM_B32_SHAPES)
def test_conv2d_stream_wide_rows_and_batch32(cuda, shape):
    """Rows wider than the first port's 48 KB line buffer (W-tiled, dynamic
    shared memory) and the path calls at batch 32 launch, agree with the
    plain version in every dtype pair with and without bias, and count one
    launch per call whatever the tiling."""
    from repro_torch.kernels.conv2d_stream.ops import (conv2d_stream_cuda,
                                                       stream_tiles)
    B, H, W, cin, cout, k = shape
    assert stream_tiles(B, H, W, cin, cout, k, k).smem_bytes <= 232448
    before = conv2d_stream_cuda.launches
    res = checks.conv2d_stream_sweep(cuda, shapes=[shape])
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_tol_frac"] <= 1.0
    assert conv2d_stream_cuda.launches - before == res["cases"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("shape", checks.QGEMM_DW_IM2COL_SHAPES
                         + checks.QGEMM_B32_SHAPES)
def test_qgemm_im2col_depthwise_and_batch32_shapes(cuda, shape):
    """The im2col depthwise baseline's calls (K = 72 and 144 over the dense
    block-diagonal codes) and every path call at the explorer's batch 32:
    int8 exact, f32 within ``float_qgemm_tol``, one launch a case."""
    from repro_torch.kernels.qmatmul.ops import qgemm, qgemm_f32
    before = (qgemm.launches, qgemm_f32.launches)
    res = checks.qgemm_sweep(cuda, shapes=[shape])
    res_f = checks.qgemm_float_sweep(cuda, shapes=[shape])
    torch.cuda.synchronize()
    assert res["failures"] == [] and res["max_abs_err"] == 0.0
    assert res_f["failures"] == [] and res_f["max_tol_frac"] <= 1.0
    assert qgemm.launches - before[0] == res["cases"]
    assert qgemm_f32.launches - before[1] == res_f["cases"]


@pytest.mark.cuda
def test_qconv_dw_batch32_shapes(cuda):
    """dw0 and dw1 at the explorer's batch 32, both modes, exact."""
    shapes = [s for s in checks.QCONV_DW_SHAPES if s[0] == 32]
    res = checks.qconv_dw_sweep(cuda, shapes=shapes)
    res_f = checks.qconv_dw_float_sweep(cuda, shapes=shapes)
    torch.cuda.synchronize()
    assert res["failures"] == [] and res["max_abs_err"] == 0.0
    assert res_f["failures"] == [] and res_f["max_abs_err"] == 0.0


def _separable_graph(device):
    from repro_torch.configs.separable_cnn import SeparableCNNConfig
    from repro_torch.core.reader import separable_cnn_to_ir
    from repro_torch.models import cnn
    cfg = SeparableCNNConfig()
    params = cnn.init_separable_params(cfg, torch.Generator().manual_seed(0),
                                       device=device)
    return separable_cnn_to_ir(cfg, params)


@pytest.mark.cuda
def test_explore_on_the_card_equals_the_cpu_front(cuda):
    """``DesignFlow.explore`` on the card scores its candidates through the
    kernels, and its front equals the CPU plain path's field for field."""
    from repro_torch.core.flow import DesignFlow
    from repro_torch.kernels.qconv_dw.ops import qconv_dw
    from repro_torch.kernels.qmatmul.ops import qgemm
    calib = torch.rand((32, 28, 28, 1),
                       generator=torch.Generator().manual_seed(9)).numpy()
    before = (qgemm.launches, qconv_dw.launches)
    front = DesignFlow(_separable_graph(cuda), device=cuda).explore((calib,))
    assert qgemm.launches > before[0] and qconv_dw.launches > before[1]
    cpu = DesignFlow(_separable_graph("cpu"), device="cpu").explore((calib,))
    assert front.to_json() == cpu.to_json()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_im2col_dw_mode_on_the_card(cuda, packed):
    """At D8 the im2col depthwise baseline equals direct mode and the CPU
    plain path bit for bit at W8/W4/W2; a forward launches no ``qconv_dw``
    and two more ``qgemm`` than direct mode."""
    from repro_torch.core.flow import DesignFlow, WriterOptions
    from repro_torch.kernels.qconv_dw.ops import qconv_dw
    from repro_torch.kernels.qmatmul.ops import qgemm
    from repro_torch.quant.qtypes import DatatypeConfig
    g = torch.Generator().manual_seed(3)
    calib = torch.rand((8, 28, 28, 1), generator=g).numpy()
    x = torch.rand((5, 28, 28, 1), generator=g).numpy()
    ranges = DesignFlow(_separable_graph("cpu"), device="cpu").run(
        ("qtorch",), DatatypeConfig(8, 8), calib_inputs=(calib,)).act_ranges

    def writer(device, mode):
        return DesignFlow(_separable_graph(device), device=device).run(
            ("qtorch",), DatatypeConfig(8, 8), act_ranges=ranges,
            options=WriterOptions(dw_mode=mode, packed_weights=packed)
        ).writers["qtorch"]

    cpu = writer("cpu", "im2col")
    for bits in (8, 4, 2):
        counts = {}
        outs = {}
        for mode in ("direct", "im2col"):
            w = writer(cuda, mode)
            before = (qgemm.launches, qconv_dw.launches)
            outs[mode] = w.build(bits=bits)(x).cpu()
            torch.cuda.synchronize()
            counts[mode] = (qgemm.launches - before[0],
                            qconv_dw.launches - before[1])
        assert counts["direct"] == (4, 2) and counts["im2col"] == (6, 0)
        assert torch.equal(outs["direct"], outs["im2col"])
        assert torch.equal(outs["im2col"], cpu.build(bits=bits)(x))


@pytest.mark.cuda
def test_fleet_heals_a_master_code_flip_on_the_card(cuda):
    """``chip_smoke.fleet_path`` on the card: three replicas over one packed
    buffer serve every request bit-exact to the CPU plain path, each
    master-code flip quarantines and heals every replica, no batch finishes
    after its detection, and the requests served after each heal are exact
    again."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs.separable_cnn import SeparableCNNConfig
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    info = chip_smoke.fleet_path("separable-cnn", SeparableCNNConfig(),
                                 device="cuda", n_requests=24, rate_rounds=1)
    assert info["master_flip"]["served_after"] \
        == 24 * chip_smoke.FLEET_MASTER_FLIPS
    assert info["launches"]["qgemm"] > 0 and info["launches"]["qconv_dw"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8_act", [True, False])
@pytest.mark.parametrize("shape", PATH_GEMMS)
def test_every_qgemm_autotune_candidate_equals_plain_version(cuda, shape,
                                                             int8_act):
    """Every mapping a timed pick may return at a path call, launched with
    its tiles: int8 bit for bit, f32 within ``float_qgemm_tol``."""
    for bits, packed in VIEWS:
        res = checks.qgemm_candidates_check(cuda, *shape, bits=bits,
                                            packed=packed, int8_act=int8_act)
        torch.cuda.synchronize()
        assert res["failures"] == [], res["failures"]
        assert res["max_tol_frac"] <= 1.0
        if int8_act:
            assert res["max_abs_err"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("int8_act", [True, False])
@pytest.mark.parametrize("shape,strides", PATH_DWS)
def test_every_qconv_dw_autotune_tile_equals_plain_version(cuda, shape,
                                                           strides, int8_act):
    """Every (ct, owb) a timed pick may return at a path call, launched with
    its tile: bit for bit in both modes."""
    for bits, packed in VIEWS:
        res = checks.qconv_dw_candidates_check(
            cuda, *shape, kh=3, kw=3, strides=strides, pads="SAME",
            bits=bits, packed=packed, int8_act=int8_act)
        torch.cuda.synchronize()
        assert res["failures"] == [] and res["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_timed_picks_sweep_once_and_persist(cuda, autotune_cache):
    """A timed pick sweeps its candidates once on the card, reports every
    candidate's windows, writes the pick through to the cache file, and is
    found in L1 afterwards; the dw pick likewise."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.qconv_dw import ops as dwops
    from repro_torch.kernels.qmatmul import ops as qops
    qops._BLOCK_CACHE.clear()
    dwops._TILE_CACHE.clear()
    before = (qops.pick_blocks.sweeps, dwops.pick_blocks_dw.sweeps)
    t = qops.pick_blocks(1568, 8, 16, 8, timed=True)
    d = dwops.pick_blocks_dw(8, 14, 14, 16, kh=3, kw=3, strides=(2, 2),
                             timed=True)
    assert qops.pick_blocks(1568, 8, 16, 8, timed=True) == t
    assert (qops.pick_blocks.sweeps, dwops.pick_blocks_dw.sweeps) == (
        before[0] + 1, before[1] + 1)
    r = qops.sweep_reports[-1]
    assert len(r["candidates"]) == len(qops.candidate_tiles(1568, 8, 16))
    assert all(len(c["windows_ms"]) == autotune.SWEEP_WINDOWS and
               0 < c["best_ms"] < 1.0 for c in r["candidates"])
    assert autotune.tuned_entries() == {
        "qgemm:1568:8:16:8:1:0": qops.encode_tiles(t),
        "qconv_dw:8:14:14:16:7x7:3x3:2x2:8:1:0": d}
    assert autotune_cache.exists()
