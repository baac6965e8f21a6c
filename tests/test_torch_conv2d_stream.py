"""The port's streaming line-buffer convolution against the reference: its
plain version against the reference's Pallas kernel (interpret mode) and its
oracle over the reference's test shapes at atol = rtol = 1e-4, in f32 and in
the mixed bf16/f32 dtypes ``compose_adaptive`` produces; against the port's
model conv; the stride/pads contract; the kernel's host mapping rule
``stream_tiles`` and a numpy mirror of the kernel's index arithmetic under
it; and, on the card, the CUDA kernel against the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_stream.ops import conv2d_stream as j_stream
from repro.kernels.conv2d_stream.ref import conv2d_ref as j_ref

from repro_torch.core.ir import Graph, Node, TensorInfo
from repro_torch.core.writers.stream_writer import StreamWriter
from repro_torch.kernels import checks
from repro_torch.kernels.conv2d_stream.ops import (SMEM_BYTES, SMS,
                                                   conv2d_stream,
                                                   require_stream_window,
                                                   stream_tiles)
from repro_torch.kernels.conv2d_stream.ref import (conv2d_ref,
                                                   conv2d_stream_plain)
from repro_torch.models.cnn import conv2d as t_model_conv

# the reference's test shapes (tests/test_kernels.py): B, H, W, Cin, Cout, k
SHAPES = [(2, 28, 28, 1, 16, 3), (1, 14, 14, 16, 32, 3), (3, 8, 8, 4, 8, 5),
          (2, 7, 7, 32, 16, 3), (1, 28, 28, 3, 8, 1)]
# compose_adaptive's (x, w) dtypes: bf16 input and weights into the first
# conv, an f32 stream (after BatchNormalization promotes) into later ones
MIXED = [("bfloat16", "bfloat16"), ("float32", "bfloat16"),
         ("bfloat16", "float32")]


def _inputs(B, H, W, cin, cout, k, seed=0):
    rng = np.random.default_rng(seed + B + H)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.to(torch.float32).numpy()


@pytest.mark.parametrize("B,H,W,cin,cout,k", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, H, W, cin, cout, k):
    x, w, b = _inputs(B, H, W, cin, cout, k)
    got = conv2d_stream_plain(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, cout)
    for want in (j_stream(x, w, b), j_ref(x, w, b)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4,
                                   rtol=1e-4)
    # the oracle itself, and the dispatcher on a CPU tensor
    np.testing.assert_allclose(
        conv2d_ref(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b)).numpy(), _np(j_ref(x, w, b)),
        atol=1e-4, rtol=1e-4)
    assert torch.equal(conv2d_stream(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b)), got)


@pytest.mark.parametrize("xdt,wdt", MIXED)
@pytest.mark.parametrize("B,H,W,cin,cout,k", SHAPES)
def test_plain_matches_reference_kernel_in_mixed_dtypes(B, H, W, cin, cout,
                                                        k, xdt, wdt):
    """Both sides cast to f32 inside and round once to x's dtype at the end:
    a bf16 output may differ by one bf16 ulp (2^-7 relative) where the f32
    sums differ in their last bits; an f32 output stays within 1e-4."""
    x, w, b = _inputs(B, H, W, cin, cout, k, seed=7)
    jx, jw = jnp.asarray(x, xdt), jnp.asarray(w, wdt)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    tw = torch.from_numpy(w).to(getattr(torch, wdt))
    want = j_stream(jx, jw, jnp.asarray(b))
    got = conv2d_stream_plain(tx, tw, torch.from_numpy(b))
    assert str(want.dtype) == xdt and got.dtype == getattr(torch, xdt)
    rtol = 2.0 ** -7 if xdt == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=rtol)
    # jnp's and torch's bf16 x f32 -> f32 promotion agree
    assert str(jnp.promote_types(jnp.bfloat16, jnp.float32)) == "float32"
    assert torch.promote_types(torch.bfloat16, torch.float32) == torch.float32


def test_plain_matches_model_conv():
    """The stream conv has the CNN model's conv semantics (mirror of the
    reference's test_conv2d_stream_matches_model_conv)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 28, 28, 1)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 1, 16)) * 0.3).astype(
        np.float32))
    b = torch.zeros(16)
    np.testing.assert_allclose(conv2d_stream(x, w, b).numpy(),
                               t_model_conv(x, w, b).numpy(), atol=1e-4)


@pytest.mark.parametrize("k,strides,pads,ok", [
    (3, (1, 1), "SAME", True), (1, (1, 1), "VALID", True),
    (1, (1, 1), "SAME", True), (3, (1, 1), [1, 1, 1, 1], True),
    (3, (2, 2), "SAME", False), (3, (1, 1), "VALID", False),
    (2, (1, 1), "SAME", False), (3, (1, 1), [0, 1, 2, 1], False)])
def test_stream_window_contract(k, strides, pads, ok):
    """The stream conv takes no strides and pads (neither does the
    reference's): a node asking for others is refused.  An even window's
    XLA SAME pads (0, 1) differ from the kernel's (1, 0)."""
    if ok:
        require_stream_window("c", k, k, strides, pads)
    else:
        with pytest.raises(ValueError, match="stream conv"):
            require_stream_window("c", k, k, strides, pads)


def test_stream_writer_refuses_a_strided_conv():
    rng = np.random.default_rng(0)
    inits = {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)}
    g = Graph("strided", [Node("Conv", "c", ["input", "w", "b"], ["out"],
                               {"pads": "SAME", "strides": [2, 2]})],
              [TensorInfo("input", ("N", 8, 8, 2))], ["out"], inits)
    run = StreamWriter(g, device="cpu").build()
    with pytest.raises(ValueError, match="stride 1 only"):
        run(rng.random((1, 8, 8, 2), np.float32))


def test_sweep_runs_its_cases_on_the_cpu():
    res = checks.conv2d_stream_sweep("cpu", shapes=[(1, 5, 6, 3, 7, 3),
                                                   (2, 4, 3, 2, 5, 1)])
    assert res["cases"] == 2 * 4 * 2
    assert res["failures"] == [] and res["max_abs_err"] == 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_version(cuda):
    from repro_torch.kernels.conv2d_stream.ops import conv2d_stream_cuda
    before = conv2d_stream_cuda.launches
    res = checks.conv2d_stream_sweep(cuda)
    torch.cuda.synchronize()
    assert res["failures"] == [], checks.summarize(res)
    assert res["max_tol_frac"] <= 1.0
    assert conv2d_stream_cuda.launches - before == res["cases"]


# -- the kernel's mapping (stream_tiles) ---------------------------------------

def _blocks(t):
    return t.grid[0] * t.grid[1]


@pytest.mark.parametrize("shape", checks.CONV_STREAM_PATH_SHAPES
                         + checks.CONV_STREAM_B32_SHAPES)
def test_stream_tiles_maps_the_path_shapes(shape):
    """At batch 8 every path call gets at least one block per SM; at batch
    32 the windowed calls stage R + kh - 1 rows for R > 1 output rows; the
    window instance is the compile-time one and the 16-byte units are used
    wherever Cin and Cout allow."""
    B, H, W, cin, cout, k = shape
    t = stream_tiles(B, H, W, cin, cout, k, k, 4, 4)
    assert t.window == k and t.co == 4 and t.ct % 4 == 0
    assert t.threads % 32 == 0 and t.threads <= 256
    assert t.threads >= t.ks * -(-t.rows * t.tw // t.px) * (t.ct // t.co)
    assert t.grid == (B * -(-H // t.rows) * -(-W // t.tw), -(-cout // t.ct))
    group = -(-t.rows * t.tw // t.px) * (t.ct // t.co)
    assert t.smem_bytes == 4 * cin * (k * k * t.ct
                                      + (t.rows + k - 1) * (t.tw + k - 1)) \
        + 4 * (t.ks - 1) * t.px * t.co * group
    assert t.ci_vec == t.x_unit == (4 if cin % 4 == 0 else 1)
    assert t.w_unit == 4
    if B == 8:
        assert _blocks(t) >= SMS
        # only mnist conv2 (144 products an output) splits its sums
        assert t.ks == (4 if k * k * cin >= 128 else 1)
    elif k == 3:
        assert t.rows > 1 and _blocks(t) >= SMS and t.ks == 1


# odd shapes: ragged rows, columns and Cout tiles, every window instance,
# rows wider than a W tile, and one whose filter leaves room for a single
# output channel a block
ODD_SHAPES = [(1, 5, 6, 33, 7, 3), (3, 9, 13, 5, 37, 3), (2, 11, 3, 3, 130, 1),
              (1, 17, 40, 24, 70, 5), (3, 8, 8, 4, 8, 5), (2, 7, 9, 2, 3, 1),
              (32, 7, 7, 16, 32, 1), (1, 4, 300, 48, 8, 3),
              (2, 3, 70, 8, 12, 3), (1, 6, 5, 6, 5, 2), (1, 3, 5, 1024, 6, 3),
              (9, 10, 11, 12, 13, 3), (1, 12, 77, 3, 5, 5)]


def _cdiv(a, b):
    return -(-a // b)


def _mirror(x, w, b, t):
    """The kernel's arithmetic under mapping ``t`` in numpy, index for
    index: each block stages its filter slice and its rows + kh - 1 input
    rows as flat runs of (tw + kw - 1) * Cin elements in ``x_unit`` /
    ``w_unit`` copies (zeros off the image), each of a tile's ks threads
    sums its px pixels x co channels over its share of the input channels
    from its window origin, and the first adds the others' partials in
    order.  Returns the output and how many times each output element was
    written."""
    B, H, W, cin = x.shape
    kh, kw, _, cout = w.shape
    nrt, nwt = _cdiv(H, t.rows), _cdiv(W, t.tw)
    lp, nr = (t.tw + kw - 1) * cin, t.rows + kh - 1
    xf = x.reshape(B, H, W * cin)
    wf = w.reshape(kh * kw * cin, cout)
    out = np.zeros((B * H * W, cout), np.float32)
    count = np.zeros((B * H * W, cout), np.int64)
    # per (tap, ci) of a window: its offset from the window origin, and the
    # split group whose share it is
    dy, dx, ci = np.meshgrid(np.arange(kh), np.arange(kw), np.arange(cin),
                             indexing="ij")
    tap_off = (dy * lp + dx * cin + ci).reshape(-1)
    share = ((ci // t.ci_vec) % t.ks).reshape(-1)
    ncg, npix = t.ct // t.co, t.rows * t.tw
    npg = _cdiv(npix, t.px)
    assert t.threads >= t.ks * npg * ncg
    for bx in range(t.grid[0]):
        wt, rt, bb = bx % nwt, (bx // nwt) % nrt, bx // nwt // nrt
        oh0, ow0 = rt * t.rows, wt * t.tw
        line = np.full(nr * lp, np.nan, np.float32)
        g0 = (ow0 - kw // 2) * cin
        for r in range(nr):
            ih = oh0 - kh // 2 + r
            for e in range(0, lp, t.x_unit):
                g = g0 + e
                ok = 0 <= ih < H and 0 <= g < W * cin
                unit = xf[bb, ih, g:g + t.x_unit] if ok else 0.0
                assert not ok or unit.size == t.x_unit
                line[r * lp + e:r * lp + e + t.x_unit] = unit
        assert not np.isnan(line).any()
        for by in range(t.grid[1]):
            c0 = by * t.ct
            wsm = np.full((kh * kw * cin, t.ct), np.nan, np.float32)
            for cc in range(0, t.ct, t.w_unit):
                ok = c0 + cc < cout
                unit = wf[:, c0 + cc:c0 + cc + t.w_unit] if ok else 0.0
                assert not ok or unit.shape[1] == t.w_unit
                wsm[:, cc:cc + t.w_unit] = unit
            for tid in range(npg * ncg):
                pg, cg = divmod(tid, ncg)
                for j in range(t.px):
                    q = pg + j * npg
                    orow, ocol = divmod(q, t.tw)
                    if q >= npix or oh0 + orow >= H or ow0 + ocol >= W:
                        continue
                    win = line[orow * lp + ocol * cin + tap_off]
                    wt = wsm[:, cg * t.co:(cg + 1) * t.co]
                    acc = np.zeros(t.co, np.float32)
                    for s in range(t.ks):
                        acc = acc + win[share == s] @ wt[share == s]
                    pix = (bb * H + oh0 + orow) * W + ow0 + ocol
                    for c in range(t.co):
                        co = c0 + cg * t.co + c
                        if co < cout:
                            out[pix, co] = acc[c] + (0.0 if b is None
                                                     else b[co])
                            count[pix, co] += 1
    return out.reshape(B, H, W, cout), count.reshape(B, H, W, cout)


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_stream_tiles_cover_every_output_once(shape):
    """Under ``stream_tiles``' mapping every output is written exactly once,
    each block's staged rows and columns hold every input its outputs'
    windows read (SAME edges as zeros), the shared memory stays within a
    block's 227 KB, and the mirror of the kernel's arithmetic agrees with
    the plain version within the kernel's contract."""
    B, H, W, cin, cout, k = shape
    kh, kw = k, k
    t = stream_tiles(B, H, W, cin, cout, kh, kw, 4, 4)
    assert t.smem_bytes <= SMEM_BYTES == 232448
    assert t.threads <= 256 and t.ct % t.co == 0
    assert t.window in (0, k) and (t.co == 4 or (t.px, t.window) == (1, 0))
    # halos: a block's staged rows/columns span its outputs' windows
    (pt, _), (pl, _) = ((kh // 2, 0), (kw // 2, 0))
    for oh0 in range(0, H, t.rows):
        rows = range(oh0 - pt, oh0 - pt + t.rows + kh - 1)
        for oh in range(oh0, min(oh0 + t.rows, H)):
            assert oh - pt in rows and oh - pt + kh - 1 in rows
    for ow0 in range(0, W, t.tw):
        cols = range(ow0 - pl, ow0 - pl + t.tw + kw - 1)
        for ow in range(ow0, min(ow0 + t.tw, W)):
            assert ow - pl in cols and ow - pl + kw - 1 in cols
    x, w, b = _inputs(B, H, W, cin, cout, k, seed=11)
    got, count = _mirror(x, w, b, t)
    assert (count == 1).all()
    want = conv2d_stream_plain(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("x_bytes,w_bytes", [(4, 4), (2, 2), (4, 2), (2, 4)])
def test_stream_tiles_staging_units(x_bytes, w_bytes):
    """16-byte units where Cin (x) and Cout (w) allow them: 4 f32 or 8 bf16
    elements of x; 4 f32 of w (bf16 w is loaded by element); 2-element
    bf16 units of x where Cin is even; else one element.  The mirror of the
    staging holds under each."""
    for shape in [(2, 5, 7, 8, 8, 3), (1, 4, 6, 6, 12, 3),
                  (1, 3, 4, 3, 6, 1)]:
        B, H, W, cin, cout, k = shape
        t = stream_tiles(B, H, W, cin, cout, k, k, x_bytes, w_bytes)
        if x_bytes == 4:
            assert t.x_unit == (4 if cin % 4 == 0 else 1)
        else:
            assert t.x_unit == (8 if cin % 8 == 0 else
                                2 if cin % 2 == 0 else 1)
        assert t.w_unit == (4 if w_bytes == 4 and cout % 4 == 0 else 1)
        x, w, b = _inputs(B, H, W, cin, cout, k, seed=3)
        got, count = _mirror(x, w, None, t)
        assert (count == 1).all()
        want = conv2d_stream_plain(torch.from_numpy(x), torch.from_numpy(w),
                                   None).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_stream_tiles_refuses_only_past_one_channel():
    """A call is refused only when one output channel's filter slice plus
    kh rows of an 8-pixel W tile exceed a block's 232,448 B; the widest Cin
    under that limit is mapped to one channel a block and fits."""
    k, W = 3, 300
    per_cin = 4 * (k * k + k * (8 + k - 1))
    fits = SMEM_BYTES // per_cin
    t = stream_tiles(1, 4, W, fits, 16, k, k)
    assert (t.ct, t.co, t.tw, t.rows) == (1, 1, 8, 1)
    assert t.smem_bytes == per_cin * fits <= SMEM_BYTES
    with pytest.raises(ValueError, match="232448"):
        stream_tiles(1, 4, W, fits + 1, 16, k, k)
    with pytest.raises(ValueError, match="W >= 1"):
        stream_tiles(1, 4, 0, 8, 16, k, k)


@pytest.mark.parametrize("shape", [(1, 4, 300, 48, 8, 3),
                                   (2, 9, 37, 12, 20, 5)])
def test_wide_rows_are_tiled_and_match_the_reference(shape):
    """A row the first port's 48 KB line buffer refused (the 3x3 over 300 x
    48 needs 175,680 B of line buffer and one channel's filter) is W-tiled,
    not refused; there and at a 5x5 window the plain version agrees with
    the reference's Pallas kernel (interpret mode) and its oracle."""
    B, H, W, cin, cout, k = shape
    t = stream_tiles(B, H, W, cin, cout, k, k)
    assert t.tw < W and t.smem_bytes <= SMEM_BYTES
    x, w, b = _inputs(B, H, W, cin, cout, k, seed=13)
    got = conv2d_stream(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b))
    for want in (j_stream(x, w, b), j_ref(x, w, b)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4,
                                   rtol=1e-4)
