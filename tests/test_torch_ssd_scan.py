"""The port's SSD chunk scan against the reference: the kernel's plain
version against the reference's Pallas kernel (interpret mode) and its
oracle, the model oracle with the bf16 intra-chunk flag, the decode step,
the entry point's routes (CPU plain version, warm start included), and
the kernel's build registration.  Inputs are made with numpy from a seed and
handed to both packages.  Tolerances are the reference's
(tests/test_kernels.py:105-108): y within 1e-5 of max|y|, the state within
1e-4, unless a test states otherwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_chunked_kernel as j_kernel
from repro.models.ssm import ssd_chunked as j_oracle
from repro.models.ssm import ssd_decode_step as j_decode

from repro_torch import perf
from repro_torch.kernels import _build, checks
from repro_torch.kernels.ssd_scan.ops import (ssd_chunk_scan,
                                              ssd_chunk_scan_cuda,
                                              ssd_chunk_state_cuda,
                                              ssd_chunk_states,
                                              ssd_chunked_kernel,
                                              ssd_scan_cuda, ssd_state_pass,
                                              ssd_state_pass_cuda)
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_scan_plain,
                                              ssd_chunk_states_plain,
                                              ssd_chunked_plain, ssd_ref,
                                              ssd_state_pass_plain)
from repro_torch.models.ssm import ssd_chunked, ssd_decode_step

# the reference's test shapes (tests/test_kernels.py:91-94): B,S,H,P,G,N,Q
SHAPES = [(2, 128, 4, 16, 2, 8, 32), (1, 64, 2, 8, 1, 16, 16),
          (2, 96, 6, 32, 3, 4, 32), (1, 256, 8, 64, 1, 128, 64)]
# ragged lengths (S not a multiple of Q), with G > 1 among them
RAGGED = [(1, 100, 4, 16, 1, 8, 32), (2, 100, 4, 16, 2, 8, 32),
          (3, 37, 6, 32, 3, 4, 16), (1, 300, 2, 64, 1, 128, 64)]


def _inputs(B, S, H, P, G, N, Q, seed=0):
    rng = np.random.default_rng(seed + S + H)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return x, dt, A, Bm, C, D


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(y, s, y_ref, s_ref, y_tol=1e-5, s_tol=1e-4):
    y_ref = np.asarray(y_ref, np.float32)
    scale = float(np.abs(y_ref).max()) + 1e-6
    np.testing.assert_allclose(y.to(torch.float32).numpy() / scale,
                               y_ref / scale, atol=y_tol, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=s_tol,
                               rtol=0)


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, S, H, P, G, N, Q):
    arrs = _inputs(B, S, H, P, G, N, Q)
    y, s = ssd_chunked_plain(*_t(arrs), Q)
    assert y.shape == (B, S, H, P) and s.shape == (B, H, P, N)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    for y_ref, s_ref in (j_kernel(*arrs, Q, interpret=True),
                         j_oracle(*arrs, Q)):
        _close(y, s, y_ref, s_ref)


@pytest.mark.parametrize("B,S,H,P,G,N,Q", RAGGED)
def test_plain_matches_oracle_on_ragged_lengths(B, S, H, P, G, N, Q):
    """The reference's kernel wrapper refuses S % Q != 0 (build_call
    asserts); its oracle zero-pads.  The plain version (and so the CUDA
    kernel it specifies) follows the oracle."""
    arrs = _inputs(B, S, H, P, G, N, Q)
    y, s = ssd_chunked_plain(*_t(arrs), Q)
    _close(y, s, *j_oracle(*arrs, Q))
    with pytest.raises(AssertionError):
        j_kernel(*arrs, Q, interpret=True)


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SHAPES + RAGGED[:2])
def test_bf16_oracle_matches_reference_with_bf16_intra(B, S, H, P, G, N, Q):
    """``perf.FLAGS.ssd_bf16_intra`` (on by default) runs the intra-chunk
    math in bf16 on bf16 inputs in both packages.  Tolerance: y within one
    bf16 ulp at max|y| (2^-7 * max|y|; measured up to 4.5e-4 * max|y|), the
    f32 state within 1e-4 * max|state| (measured 2e-6)."""
    assert perf.FLAGS.ssd_bf16_intra
    x, dt, A, Bm, C, D = _inputs(B, S, H, P, G, N, Q)
    xb, Bb, Cb = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, C))
    y_ref, s_ref = j_oracle(xb, dt, A, Bb, Cb, D, Q)

    def tb(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)

    y, s = ssd_chunked(tb(xb), *_t((dt, A)), tb(Bb), tb(Cb),
                       torch.from_numpy(D), Q)
    assert y.dtype == torch.bfloat16
    y_ref = np.asarray(y_ref.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(y_ref).max())
    s_ref = np.asarray(s_ref)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0,
                               atol=1e-4 * np.abs(s_ref).max())


def test_flag_off_oracle_is_the_plain_version(monkeypatch):
    """With the bf16 intra flag off (``set_baseline``), the model oracle is
    the kernel's plain version exactly; with it on, the two differ on bf16
    inputs (the plain version keeps f32, as the TPU kernel does)."""
    x, dt, A, Bm, C, D = _t(_inputs(2, 96, 6, 32, 3, 4, 32))
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), C.bfloat16()
    y_on, _ = ssd_chunked(xb, dt, A, Bb, Cb, D, 32)
    y_plain, s_plain = ssd_chunked_plain(xb, dt, A, Bb, Cb, D, 32)
    assert not torch.equal(y_on, y_plain)
    monkeypatch.setattr(perf, "FLAGS", perf.PerfFlags())
    perf.set_baseline()
    assert not perf.FLAGS.ssd_bf16_intra
    y_off, s_off = ssd_chunked(xb, dt, A, Bb, Cb, D, 32)
    assert torch.equal(y_off, y_plain) and torch.equal(s_off, s_plain)
    assert ssd_ref is ssd_chunked


@pytest.mark.parametrize("B,S,H,P,G,N,Q", [(2, 64, 4, 16, 2, 8, 16),
                                           (2, 100, 4, 16, 2, 8, 32)])
def test_warm_start_matches_reference(B, S, H, P, G, N, Q):
    """``init_state`` given: the entry point takes the kernel's plain
    version on the CPU (the kernel itself on the card), which starts from
    that state; the reference's wrapper routes it to its oracle, which the
    JAX kernel matches where S is a chunk multiple."""
    arrs = _inputs(B, S, H, P, G, N, Q)
    s0 = np.random.default_rng(5).standard_normal(
        (B, H, P, N)).astype(np.float32)
    launches = ssd_scan_cuda.launches
    y, s = ssd_chunked_kernel(*_t(arrs), Q, torch.from_numpy(s0))
    assert ssd_scan_cuda.launches == launches
    y_p, s_p = ssd_chunked_plain(*_t(arrs), Q, torch.from_numpy(s0))
    assert torch.equal(y, y_p) and torch.equal(s, s_p)
    _close(y, s, *j_oracle(*arrs, Q, s0))
    if S % Q == 0:
        _close(y, s, *j_kernel(*arrs, Q, s0))


def test_cpu_entry_point_runs_the_plain_version_and_launches_nothing():
    arrs = _t(_inputs(2, 100, 4, 16, 2, 8, 32))
    launches = ssd_scan_cuda.launches
    y, s = ssd_chunked_kernel(*arrs, 32)
    y_p, s_p = ssd_chunked_plain(*arrs, 32)
    assert torch.equal(y, y_p) and torch.equal(s, s_p)
    assert ssd_scan_cuda.launches == launches


@pytest.mark.parametrize("B,S,H,P,G,N", [(2, 16, 4, 16, 2, 8),
                                         (1, 64, 8, 64, 1, 128)])
def test_decode_step_matches_reference(B, S, H, P, G, N):
    x, dt, A, Bm, C, D = _inputs(B, 1, H, P, G, N, 1)
    state = np.random.default_rng(1).standard_normal(
        (B, H, P, N)).astype(np.float32)
    y_ref, s_ref = j_decode(x[:, 0], dt[:, 0], A, Bm[:, 0], C[:, 0], D,
                            state)
    y, s = ssd_decode_step(*_t((x[:, 0], dt[:, 0], A, Bm[:, 0], C[:, 0], D,
                                state)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-6,
                               rtol=1e-6)


def test_decode_steps_reproduce_the_chunked_scan():
    """Port of the reference's test_ssd_decode_matches_chunked_prefix:
    stepping the recurrence token by token gives the chunked scan's y and
    final state (y within 1e-4 of max|y|, state 1e-4)."""
    x, dt, A, Bm, C, D = _t(_inputs(2, 64, 4, 16, 1, 8, 16))
    y_c, s_c = ssd_chunked_plain(x, dt, A, Bm, C, D, 16)
    s = torch.zeros((2, 4, 16, 8))
    ys = []
    for t in range(64):
        y, s = ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], C[:, t], D, s)
        ys.append(y)
    y_d = torch.stack(ys, 1)
    scale = float(y_c.abs().max())
    assert float((y_d - y_c).abs().max()) / scale < 1e-4
    assert float((s - s_c).abs().max()) < 1e-4


def _phases(x, dt, A, Bm, C, D, Q, s0=None):
    """The three plain phases composed, as the kernel's wrapper runs them."""
    states, decay = ssd_chunk_states_plain(x, dt, A, Bm, Q)
    entering, fin = ssd_state_pass_plain(states, decay, s0)
    return ssd_chunk_scan_plain(x, dt, A, Bm, C, D, entering, Q), fin


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", checks.SSD_TEST_SHAPES + tuple(RAGGED))
def test_phases_compose_to_the_plain_version_bit_for_bit(shape, dtype, warm):
    """Each phase is the same math as the matching lines of ``_ssd_scan``
    (same ops on the same values in the same order), so the composition of
    the three equals ``ssd_chunked_plain`` bit for bit, on strided views of
    a fused tensor, ragged lengths and G > 1 included."""
    Bsz, _, H, P, _, N, Q = shape
    x, dt, A, Bm, C, D = checks.ssd_inputs(shape, 11, dtype, "cpu",
                                           fused=True)
    s0 = (torch.randn((Bsz, H, P, N), generator=torch.Generator()
                      .manual_seed(12)) if warm else None)
    y, s = _phases(x, dt, A, Bm, C, D, Q, s0)
    y_p, s_p = ssd_chunked_plain(x, dt, A, Bm, C, D, Q, s0)
    assert y.dtype == y_p.dtype and torch.equal(y, y_p)
    assert torch.equal(s, s_p)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,Q", SHAPES)
def test_phases_match_the_reference_kernel(B, S, H, P, G, N, Q, warm):
    """The composition against the reference's Pallas kernel in interpret
    mode (the oracle where a warm start routes the reference's wrapper
    there) and its oracle, within the reference's tolerances."""
    arrs = _inputs(B, S, H, P, G, N, Q)
    s0 = np.random.default_rng(7).standard_normal(
        (B, H, P, N)).astype(np.float32) if warm else None
    y, s = _phases(*_t(arrs), Q, None if s0 is None else torch.from_numpy(s0))
    _close(y, s, *j_kernel(*arrs, Q, s0, interpret=True))
    _close(y, s, *j_oracle(*arrs, Q, s0))


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,Q", RAGGED)
def test_phases_match_the_reference_oracle_on_ragged_lengths(
        B, S, H, P, G, N, Q, warm):
    arrs = _inputs(B, S, H, P, G, N, Q)
    s0 = np.random.default_rng(8).standard_normal(
        (B, H, P, N)).astype(np.float32) if warm else None
    y, s = _phases(*_t(arrs), Q, None if s0 is None else torch.from_numpy(s0))
    _close(y, s, *j_oracle(*arrs, Q, s0))


def test_phase_layouts_and_the_state_pass():
    """Phase 1's states are (B,H,nc,N,P) with the (B,H,nc) decays in
    (0, 1]; phase 2's first entering state is the initial one, each next is
    the last times the decay plus the chunk's summary, and the final state
    comes back (B,H,P,N); no chunks leave the initial state as it is."""
    B, S, H, P, G, N, Q = 2, 100, 4, 16, 2, 8, 32
    x, dt, A, Bm, C, D = _t(_inputs(B, S, H, P, G, N, Q))
    states, decay = ssd_chunk_states_plain(x, dt, A, Bm, Q)
    assert states.shape == (B, H, 4, N, P) and decay.shape == (B, H, 4)
    assert states.dtype == decay.dtype == torch.float32
    assert bool(((decay > 0) & (decay <= 1)).all())
    s0 = torch.randn((B, H, P, N), generator=torch.Generator().manual_seed(3))
    entering, fin = ssd_state_pass_plain(states, decay, s0)
    assert entering.shape == states.shape and fin.shape == (B, H, P, N)
    assert torch.equal(entering[:, :, 0], s0.transpose(2, 3))
    for c in range(1, 4):
        assert torch.equal(entering[:, :, c],
                           entering[:, :, c - 1] * decay[:, :, c - 1, None,
                                                         None]
                           + states[:, :, c - 1])
    assert torch.equal(fin.transpose(2, 3),
                       entering[:, :, 3] * decay[:, :, 3, None, None]
                       + states[:, :, 3])
    empty = torch.zeros((B, H, 0, N, P))
    e0, f0 = ssd_state_pass_plain(empty, torch.zeros((B, H, 0)), s0)
    assert e0.shape == empty.shape and torch.equal(f0, s0)


def test_phase_entry_points_run_the_plain_versions_on_the_cpu():
    """On a CPU tensor each phase's entry point is its plain version and
    launches nothing; each phase's launch wrapper refuses a CPU tensor."""
    B, S, H, P, G, N, Q = 2, 100, 4, 16, 2, 8, 32
    x, dt, A, Bm, C, D = _t(_inputs(B, S, H, P, G, N, Q))
    counts = [f.launches for f in (ssd_chunk_state_cuda, ssd_state_pass_cuda,
                                   ssd_chunk_scan_cuda, ssd_scan_cuda)]
    states, decay = ssd_chunk_states(x, dt, A, Bm, Q)
    want = ssd_chunk_states_plain(x, dt, A, Bm, Q)
    assert torch.equal(states, want[0]) and torch.equal(decay, want[1])
    entering, fin = ssd_state_pass(states, decay)
    want = ssd_state_pass_plain(states, decay)
    assert torch.equal(entering, want[0]) and torch.equal(fin, want[1])
    y = ssd_chunk_scan(x, dt, A, Bm, C, D, entering, Q)
    assert torch.equal(y, ssd_chunk_scan_plain(x, dt, A, Bm, C, D, entering,
                                               Q))
    assert counts == [f.launches for f in (ssd_chunk_state_cuda,
                                           ssd_state_pass_cuda,
                                           ssd_chunk_scan_cuda,
                                           ssd_scan_cuda)]
    for call in (lambda: ssd_chunk_state_cuda(x, dt, A, Bm, Q),
                 lambda: ssd_state_pass_cuda(states, decay),
                 lambda: ssd_chunk_scan_cuda(x, dt, A, Bm, C, D, entering,
                                             Q)):
        with pytest.raises(ValueError, match="launches the CUDA kernel"):
            call()


def test_phase_check_runs_on_the_cpu():
    """The chip's per-phase check's code path (on the CPU each phase's
    entry point is its plain version, so every difference is 0)."""
    res = checks.ssd_scan_phase_check("cpu", shapes=[RAGGED[1], SHAPES[0]])
    assert res["cases"] == 2 * 2 and res["failures"] == []
    assert res["max_tol_frac"] == 0.0
    assert len(res["max_tol_frac_by"]) == 2 * 5
    assert checks.SSD_PHASE_SHAPES[0] == checks.SSD_FULL_WIDTH
    assert checks.SSD_PHASE_SHAPES[1][1] % checks.SSD_PHASE_SHAPES[1][-1]


def test_sweep_runs_on_the_cpu():
    """The chip sweep's code path (on the CPU both sides are the plain
    version): shapes, strided views of a fused tensor, both dtypes, zero
    and given initial states."""
    res = checks.ssd_scan_sweep("cpu", shapes=[SHAPES[0], RAGGED[2]])
    assert res["cases"] == 2 * 2 * 2 * 2 and res["failures"] == []
    x, _, _, Bm, C, _ = checks.ssd_inputs(RAGGED[1], 0, torch.bfloat16,
                                          "cpu", fused=True)
    assert not x.is_contiguous() and x.stride(3) == 1
    assert Bm.stride(1) == x.stride(1) == C.stride(1)
    gap = checks.ssd_scan_f64_gap("cpu", shape=SHAPES[3])
    assert gap["plain_y_rel"] < 1e-5 and gap["plain_state_rel"] < 1e-5


def test_tolerance_rule():
    y = torch.tensor([1.0, -4.0, 0.5]).bfloat16()
    y_tol, s_tol = checks.ssd_scan_tol(y, torch.tensor([0.5, 3.0]))
    assert torch.allclose(y_tol, 4e-5 + 2.0 ** -7 * y.float().abs())
    assert s_tol == pytest.approx(3e-4)
    y_tol, s_tol = checks.ssd_scan_tol(y.float(), torch.tensor([0.5]))
    assert torch.allclose(y_tol, torch.full((3,), 4e-5))
    assert s_tol == pytest.approx(1e-4)


def test_launch_wrapper_refuses_what_the_kernel_does_not_take():
    arrs = _t(_inputs(1, 32, 2, 16, 1, 8, 16))
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        ssd_scan_cuda(*arrs, 16)
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        ssd_scan_cuda(*arrs, 16, torch.zeros((1, 2, 16, 8)))


def test_kernel_source_is_registered_with_the_build():
    """The three phases' entry points, with the argument counts of their C
    signatures; the source keeps to expf and two roundings, and names no
    tensor-core, cp.async or TMA instruction."""
    assert "ssd_scan.cu" in _build.SOURCES
    assert (_build.CSRC / "ssd_scan.cu").exists()
    ep = _build._ENTRY_POINTS
    assert "repro_ssd_scan" not in ep
    assert len(ep["repro_ssd_chunk_state"]) == 6 + 7 + 9 + 2
    assert len(ep["repro_ssd_state_pass"]) == 4 + 4 + 1
    assert len(ep["repro_ssd_chunk_scan"]) == 8 + 7 + 12 + 2
    assert len(ep["repro_ssd_scan_info"]) == 5 + 2
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    for name in ("repro_ssd_chunk_state", "repro_ssd_state_pass",
                 "repro_ssd_chunk_scan", "repro_ssd_scan_info"):
        assert f'extern "C" int {name}(' in src
    for kernel in ("chunk_state_kernel", "state_pass_kernel",
                   "chunk_scan_kernel"):
        assert f"{kernel}(" in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert "__expf" not in src and "-fmad=false" in _build.NVCC_FLAGS
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines()).lower()
    for banned in ("wgmma", "mma.sync", "cp.async", "cp_async", "tma",
                   "wmma"):
        assert banned not in code
