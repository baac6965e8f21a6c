"""The port's tile autotuner (``repro_torch.kernels.autotune``, the timed
``pick_blocks`` of ``qgemm`` and ``pick_blocks_dw`` of ``qconv_dw``) against
the reference's autotune tests: ``test_qpath.py``'s cache persistence and
disable/corrupt cases, ``test_integrity.py``'s per-entry validation and
strict writes (the same entries fed to both packages' caches), and
``test_depthwise.py``'s schema gate and untimed default.  On the CPU nothing
is timed: the disk-hit path, the one-candidate path and the static rules
run as they do on the card, and the sweep's choice runs with its timing
replaced by given numbers.  Every test points both packages' caches at a
temporary file or at ``off``.
"""
import importlib.util
import json
import threading
import time
from pathlib import Path

import pytest

from repro.kernels import autotune as j_autotune

from repro_torch.kernels import autotune, checks
from repro_torch.kernels.qconv_dw import ops as dwops
from repro_torch.kernels.qconv_dw.ops import (candidate_dw_tiles, dw_tiles,
                                              pick_blocks_dw)
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.kernels.qmatmul.ops import (Tiles, candidate_tiles,
                                             decode_tiles, encode_tiles,
                                             pick_blocks, pick_tiles)

ROOT = Path(__file__).resolve().parents[1]

# every qgemm call of both CNNs' qtorch paths at the serving buckets
# (separable stem, pw0, pw1, FC; mnist conv0 and conv1 as im2col, FC)
PATH_GEMMS = [(b * m, k, n) for b in (1, 2, 4, 8)
              for m, k, n in ((784, 9, 8), (196, 8, 16), (49, 16, 32),
                              (1, 1568, 10), (784, 9, 16), (196, 144, 32))]
# separable-cnn's depthwise calls at the buckets: dw0 (stride 1), dw1 (2)
PATH_DWS = [((b, 14, 14, 8), (1, 1)) for b in (1, 2, 4, 8)] + \
    [((b, 14, 14, 16), (2, 2)) for b in (1, 2, 4, 8)]


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Both packages' caches at fresh files, the port's L1 dicts empty."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.AUTOTUNE_CACHE_ENV, str(path))
    monkeypatch.setenv(j_autotune.AUTOTUNE_CACHE_ENV,
                       str(tmp_path / "reference.json"))
    monkeypatch.setattr(qops, "_BLOCK_CACHE", {})
    monkeypatch.setattr(dwops, "_TILE_CACHE", {})
    return path


@pytest.fixture
def fake_timing(monkeypatch):
    """Sweeps on the CPU: operands made there, each candidate's windows
    read from ``times`` (ms; missing candidates take ``default_ms``)
    instead of timed on the card."""
    state = {"times": {}, "default_ms": 0.005, "calls": 0}

    def fake(launches, windows=autotune.SWEEP_WINDOWS, per_window=0):
        state["calls"] += 1
        return {k: list(state["times"].get(k, [state["default_ms"]] * 3))
                for k in launches}

    monkeypatch.setattr(autotune, "SWEEP_DEVICE", "cpu")
    monkeypatch.setattr(autotune, "time_candidates", fake)
    return state


# ---------------------------------------------------------------------------
# the disk cache (test_qpath.py:495, :521; test_integrity.py:522, :543)
# ---------------------------------------------------------------------------

def test_autotune_cache_persists_across_processes(cache):
    """A timed pick survives the process: a second (simulated) process
    with a cold L1 and a cold disk state reloads it instead of sweeping."""
    key = (256, 512, 384, 8, True, False, True)
    tuned = Tiles("tiled", 32, 64, 32)
    assert tuned != pick_tiles(256, 512, 384) and \
        tuned in candidate_tiles(256, 512, 384)
    qops._BLOCK_CACHE[key] = tuned
    qops._disk_put(key, tuned)
    assert cache.exists()
    qops._BLOCK_CACHE.clear()
    qops._disk_state["path"] = False
    sweeps = pick_blocks.sweeps
    assert pick_blocks(256, 512, 384, 8, timed=True) == tuned
    assert pick_blocks.sweeps == sweeps           # no card touched
    assert qops._BLOCK_CACHE[key] == tuned        # written through to L1
    # untimed (CPU) picks stay in process: the static rule, not persisted
    qops._BLOCK_CACHE.clear()
    assert pick_blocks(512, 512, 512, 8) == pick_tiles(512, 512, 512)
    doc = json.loads(cache.read_text())
    assert doc["schema"] == autotune.CACHE_SCHEMA == 1
    assert doc["entries"] == {"qgemm:256:512:384:8:1:0": [1, 32, 64, 32, 1]}


def test_autotune_cache_disable_and_corrupt(cache, monkeypatch):
    monkeypatch.setenv(qops.AUTOTUNE_CACHE_ENV, "off")
    assert qops.autotune_cache_path() is None
    qops._disk_put((1, 2, 3, 8, True, False, True), Tiles("tiled", 16, 8, 32))
    assert qops._disk_cache() == {}
    for off in ("", "0", "none", " OFF "):
        monkeypatch.setenv(qops.AUTOTUNE_CACHE_ENV, off)
        assert qops.autotune_cache_path() is None
    cache.write_text("{not json")
    monkeypatch.setenv(qops.AUTOTUNE_CACHE_ENV, str(cache))
    assert qops._disk_cache() == {}      # a corrupt file retunes, no crash


def test_default_cache_file_is_the_ports_own(monkeypatch):
    """Unset, the port's cache lives in its own file, beside (never in)
    the reference's, whose tuples are Pallas blocks."""
    monkeypatch.delenv(autotune.AUTOTUNE_CACHE_ENV, raising=False)
    monkeypatch.delenv(j_autotune.AUTOTUNE_CACHE_ENV, raising=False)
    ours = autotune.autotune_cache_path()
    assert ours.endswith("/.cache/repro_torch/autotune.json")
    assert ours != j_autotune.autotune_cache_path()
    assert autotune.AUTOTUNE_CACHE_ENV == "REPRO_TORCH_AUTOTUNE_CACHE" != \
        j_autotune.AUTOTUNE_CACHE_ENV
    assert qops._disk_state is autotune._disk_state


def test_autotune_cache_drops_corrupt_entries_keeps_rest(cache, tmp_path):
    """The same entries, each package under its own schema: both keep the
    one good entry and drop the rest; a non-dict ``entries`` reads as
    empty in both."""
    entries = {"good": [64, 64, 128], "zero": [0, 64], "negative": [-8],
               "boolean": [True, 64], "fractional": [64.5],
               "stringy": "64", "empty": []}
    ref = tmp_path / "reference.json"
    cache.write_text(json.dumps({"schema": autotune.CACHE_SCHEMA,
                                 "entries": entries}))
    ref.write_text(json.dumps({"schema": j_autotune.CACHE_SCHEMA,
                               "entries": entries}))
    assert autotune.disk_cache() == j_autotune.disk_cache() == \
        {"good": (64, 64, 128)}
    for path, schema in ((cache, autotune.CACHE_SCHEMA),
                         (ref, j_autotune.CACHE_SCHEMA)):
        path.write_text(json.dumps({"schema": schema,
                                    "entries": [["good", [64]]]}))
    autotune._disk_state["path"] = False
    j_autotune._disk_state["path"] = False
    assert autotune.disk_cache() == j_autotune.disk_cache() == {}


def test_autotune_schema_gate(cache):
    """A file of another schema (the reference's 2, or the flat
    pre-versioned form) reads as empty: it retunes, never returns a tuple
    of another arity."""
    for doc in ({"schema": 2, "entries": {"qgemm:1:2:3:8:1:0": [1, 16, 8,
                                                                 32, 1]}},
                {"qgemm:1:2:3:8:1:0": [1, 16, 8, 32, 1]}):
        cache.write_text(json.dumps(doc))
        autotune._disk_state["path"] = False
        assert autotune.disk_cache() == {}


@pytest.mark.parametrize("blocks", [
    (0, 64), (-8,), (True, 64), (64.5,), (), "64", None])
def test_autotune_disk_put_is_strict(cache, blocks):
    for pkg in (autotune, j_autotune):
        with pytest.raises(pkg.CacheFormatError):
            pkg.disk_put("k", blocks)
    assert not cache.exists()


def test_disk_put_writes_atomically_and_sorted(cache):
    autotune.disk_put("b", (2,))
    autotune.disk_put("a", (1, 3))
    doc = json.loads(cache.read_text())
    assert list(doc["entries"]) == ["a", "b"]
    assert not list(cache.parent.glob("*.tmp.*"))
    assert autotune.tuned_entries() == {"a": (1, 3), "b": (2,)}
    assert autotune.tuned_entries("b") == {"b": (2,)}


# ---------------------------------------------------------------------------
# qgemm: candidates, keys, the static and the timed pick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("float_mode", [False, True])
@pytest.mark.parametrize("shape", PATH_GEMMS[-6:] + [(7, 1100, 130),
                                                     (65, 4100, 32)])
def test_candidates_are_mappings_the_kernel_takes(shape, float_mode):
    """The static pick first, then its neighbours: every candidate within
    qgemm.cu's launch limits, ~10 of them."""
    M, K, N = shape
    cands = candidate_tiles(M, K, N, float_mode)
    assert cands[0] == pick_tiles(M, K, N, float_mode)
    assert len(set(cands)) == len(cands) <= 12
    for t in cands:
        assert qops._legal(t, M, K, N, float_mode)
        if t.mapping == "skinny":
            assert M <= 64 and t.bk == 32 and t.splits == 8
        elif float_mode:
            assert t.bm == 512 // t.bn and t.bk in (8, 16, 32)
        else:
            assert t.bm in (16, 32, 64) and t.bk == 32
    assert any(t.mapping == "skinny" for t in cands) == (M <= 64)
    assert decode_tiles(encode_tiles(cands[-1])) == cands[-1]


def test_host_rule_refuses_what_the_kernel_refuses():
    """The host's copy of qgemm.cu's checks: wrong k steps, BM, BN and
    split counts, skinny above 64 rows, and a stage past 48 KB."""
    assert not qops._legal(Tiles("tiled", 16, 8, 16), 100, 9, 8, False)
    assert not qops._legal(Tiles("tiled", 8, 8, 32), 100, 9, 8, False)
    assert not qops._legal(Tiles("tiled", 16, 16, 8), 100, 9, 8, True)
    assert not qops._legal(Tiles("tiled", 32, 16, 64), 100, 9, 8, True)
    assert not qops._legal(Tiles("tiled", 16, 128, 32), 100, 9, 8, False)
    assert not qops._legal(Tiles("skinny", 80, 8, 32, 8), 65, 1568, 8, False)
    assert not qops._legal(Tiles("skinny", 16, 8, 32, 4), 8, 1568, 8, False)
    assert not qops._legal(Tiles("tiled", 16, 8, 32, 2), 100, 9, 8, False)
    assert qops.smem_bytes(Tiles("tiled", 64, 64, 32), 9, 9, 64, False) \
        <= qops.TILE_SMEM
    assert decode_tiles((3, 16, 8, 32, 1)) is None
    assert decode_tiles((1, 16, 8, 32)) is None


def test_pick_blocks_untimed_is_the_static_rule_and_keyed_apart(cache):
    """``timed=False`` (a CPU call) returns pick_tiles, touches no disk,
    and does not pin the rule for a later timed call of the shape."""
    for M, K, N in PATH_GEMMS:
        for int8_act in (True, False):
            assert pick_blocks(M, K, N, 8, int8_act=int8_act) == \
                pick_tiles(M, K, N, float_mode=not int8_act)
    assert (784, 9, 8, 8, True, False, False) in qops._BLOCK_CACHE
    assert (784, 9, 8, 8, True, False, True) not in qops._BLOCK_CACHE
    assert not cache.exists()


def test_a_disk_entry_that_is_not_a_candidate_is_a_miss(cache, fake_timing):
    """A pick the kernel would refuse for this shape (here tiles of another
    shape's candidates) is timed anew and overwritten."""
    key = (784, 9, 8, 8, True, False, True)
    autotune.disk_put(qops._disk_key(key), (1, 16, 128, 32, 1))
    sweeps = pick_blocks.sweeps
    got = pick_blocks(784, 9, 8, 8, timed=True)
    assert pick_blocks.sweeps == sweeps + 1
    assert got == pick_tiles(784, 9, 8)
    assert autotune.disk_cache()[qops._disk_key(key)] == encode_tiles(got)


@pytest.mark.parametrize("gain_ms,moves", [(0.0004, False), (0.0011, True)])
def test_sweep_keeps_the_static_pick_within_its_spread(cache, fake_timing,
                                                       gain_ms, moves):
    """A candidate whose best window beats the static pick's by less than
    the sweep's spread (here 0.001 ms) leaves the static pick; by more, it
    is picked, reported, and written through to L1 and disk."""
    M, K, N = 1568, 8, 16
    cands = candidate_tiles(M, K, N)
    other = cands[-1]
    fake_timing["times"] = {cands[0]: [0.005, 0.0055, 0.006],
                            other: [0.005 - gain_ms] * 3}
    got = pick_blocks(M, K, N, 4, packed=True, timed=True)
    assert got == (other if moves else cands[0])
    report = qops.sweep_reports[-1]
    assert report["shape"] == [M, K, N] and report["bits"] == 4
    assert report["packed"] is True and report["kernel"] == "qgemm"
    assert report["spread_ms"] == pytest.approx(0.001)
    assert report["static"] == encode_tiles(cands[0])
    assert report["pick"] == encode_tiles(got)
    assert [tuple(c["tiles"]) for c in report["candidates"]] == \
        [encode_tiles(t) for t in cands]
    key = qops._disk_key((M, K, N, 4, True, True, True))
    assert key == "qgemm:1568:8:16:4:1:1"
    assert autotune.disk_cache()[key] == encode_tiles(got)
    calls = fake_timing["calls"]
    assert pick_blocks(M, K, N, 4, packed=True, timed=True) == got
    assert fake_timing["calls"] == calls          # an L1 hit


def test_choose_rule():
    times = {"a": [1.0, 1.2], "b": [0.95, 0.96], "c": [0.5, 0.9]}
    assert autotune.choose(times, "a") == ("c", pytest.approx(0.4))
    assert autotune.choose({"a": [1.0, 1.1], "b": [0.95, 0.95]}, "a") == \
        ("a", pytest.approx(0.1))
    assert autotune.choose({"a": [1.0]}, "a") == ("a", 0.0)


def test_sweeps_hold_one_lock(cache, fake_timing, monkeypatch):
    """Threads that meet one untuned shape at once sweep it once: the sweep
    holds the module lock, and the others find its pick in L1."""
    inner = autotune.time_candidates

    def slow(launches, **kw):
        time.sleep(0.05)
        return inner(launches, **kw)

    monkeypatch.setattr(autotune, "time_candidates", slow)
    sweeps = pick_blocks.sweeps
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        pick_blocks(392, 16, 32, 8, timed=True))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert pick_blocks.sweeps == sweeps + 1 and fake_timing["calls"] == 1
    assert len(set(out)) == 1


def test_sweep_count_per_bucket(cache, fake_timing):
    """One sweep per (shape, view, mode) of the paths' bucket calls, and no
    more however often they repeat."""
    sweeps = pick_blocks.sweeps
    for _ in range(3):
        for M, K, N in PATH_GEMMS:
            for bits, packed in ((8, False), (4, True), (2, True)):
                for int8_act in (True, False):
                    pick_blocks(M, K, N, bits, int8_act=int8_act,
                                packed=packed, timed=True)
    assert pick_blocks.sweeps - sweeps == len(set(PATH_GEMMS)) * 3 * 2
    assert len(autotune.tuned_entries("qgemm:")) == len(set(PATH_GEMMS)) * 6


# ---------------------------------------------------------------------------
# qconv_dw: the host tile rule, candidates, keys (test_depthwise.py:169, :194)
# ---------------------------------------------------------------------------

def _old_kernel_rule(C, OW, kh, kw, sw, float_mode):
    """The tile rule qconv_dw.cu's ``launch`` ran before the host chose the
    tiles, transcribed line for line."""
    taps, esz = kh * kw, 4 if float_mode else 1
    vec = 4 if C % 4 == 0 else 1
    ct = C if C < 64 else 64
    owb = OW if OW < 64 else 64

    def smem_of(ct_, owb_):
        return ((taps * ct_ * 4 + 15) & ~15) + \
            kh * ((owb_ - 1) * sw + kw) * ct_ * esz

    while smem_of(ct, owb) > 48 * 1024 and owb > 1:
        owb = (owb + 1) // 2
    while smem_of(ct, owb) > 48 * 1024 and ct > vec:
        ct = (ct // 2) // vec * vec
        if ct < vec:
            ct = vec
    return ct, owb


def _dw_shapes():
    from repro_torch.kernels.qconv_dw.ref import out_spatial
    out = []
    for (B, H, W, C), st in PATH_DWS:
        out.append((C, out_spatial(H, W, 3, 3, st, "SAME")[1], 3, 3, st[1]))
    for (B, H, W, C) in checks.QCONV_DW_SHAPES + ((1, 4, 300, 130),
                                                   (2, 9, 200, 64)):
        for kh, kw, _ in checks.DW_WINDOWS:
            for st in checks.DW_STRIDES:
                for pd in checks.DW_PADS:
                    ow = out_spatial(H, W, kh, kw, st, pd)[1]
                    if ow > 0:
                        out.append((C, ow, kh, kw, st[1]))
    # windows past the sweep's, whose int8 blocks must halve too
    out += [(64, 150, 7, 7, 2), (130, 300, 8, 8, 1), (6, 64, 7, 7, 2)]
    return sorted(set(out))


@pytest.mark.parametrize("float_mode", [False, True])
def test_dw_tiles_default_equals_the_old_in_kernel_rule(float_mode):
    """With no cache entry a call launches with the tiles the kernel chose
    for itself before: at every path shape and bucket, every shape and
    window of the kernel sweep, and wide rows that make it halve."""
    shapes = _dw_shapes()
    halved = 0
    for C, OW, kh, kw, sw in shapes:
        old = _old_kernel_rule(C, OW, kh, kw, sw, float_mode)
        assert dw_tiles(C, OW, kh=kh, kw=kw, sw=sw,
                        float_mode=float_mode) == old, (C, OW, kh, kw, sw)
        halved += old != (min(C, 64), min(OW, 64))
    assert halved > 0        # the wide rows reach the halving loops


def test_dw_candidates_are_tiles_the_kernel_takes():
    for C, OW, kh, kw, sw in _dw_shapes():
        for float_mode in (False, True):
            geo = dict(kh=kh, kw=kw, sw=sw, float_mode=float_mode)
            cands = candidate_dw_tiles(C, OW, **geo)
            assert cands[0] == dw_tiles(C, OW, **geo)
            assert len(set(cands)) == len(cands) <= 9
            vec = 4 if C % 4 == 0 else 1
            for ct, owb in cands:
                assert ct % vec == 0 and vec <= ct <= 64 and 1 <= owb <= 64
                assert dwops.dw_smem_bytes(ct, owb, **geo) <= 48 * 1024
    assert candidate_dw_tiles(8, 14, kh=3, kw=3, sw=1, float_mode=False) == [
        (8, 14), (8, 7), (8, 4), (4, 14), (4, 7), (4, 4)]


def test_dw_autotune_schema_gate_and_arity(cache):
    """A flat pre-versioned file loads as empty; a wrong-arity entry (a
    qgemm 5-tuple under a qconv_dw key) is ignored; a well-formed 2-tuple
    round-trips through the schema envelope and is returned with no
    sweep."""
    geo = dict(kh=3, kw=3, strides=(1, 1), pads="SAME", bits=8)
    key = (8, 14, 14, 8, 14, 14, 3, 3, 1, 1, 8, True, False, True)
    dk = dwops._disk_key_dw(key)
    assert dk == "qconv_dw:8:14:14:8:14x14:3x3:1x1:8:1:0"
    cache.write_text(json.dumps({dk: [4, 7]}))
    assert autotune.disk_cache() == {}
    # a call with one candidate (one channel, one output column) takes it
    # untimed: the wrong-arity entry is not returned mis-shaped
    one = (2, 9, 1, 1, 9, 1, 3, 3, 1, 1, 8, True, False, True)
    autotune.disk_put(dwops._disk_key_dw(one), (512, 256, 128))
    assert pick_blocks_dw(2, 9, 1, 1, timed=True, **geo) == (1, 1)
    autotune.disk_put(dk, (4, 7))
    raw = json.loads(cache.read_text())
    assert raw["schema"] == autotune.CACHE_SCHEMA
    assert raw["entries"][dk] == [4, 7]
    sweeps = pick_blocks_dw.sweeps
    assert pick_blocks_dw(8, 14, 14, 8, timed=True, **geo) == (4, 7)
    assert pick_blocks_dw.sweeps == sweeps


def test_dw_autotune_untimed_skips_disk(cache):
    """The counterpart of interpret mode: the static rule, no disk."""
    tile = pick_blocks_dw(1, 12, 24, 256, kh=3, kw=3, strides=(1, 1),
                          pads="SAME", bits=8)
    assert tile == dw_tiles(256, 24, kh=3, kw=3, sw=1, float_mode=False) \
        == (64, 24)
    assert not cache.exists()
    assert (1, 12, 24, 256, 12, 24, 3, 3, 1, 1, 8, True, False, False) in \
        dwops._TILE_CACHE


def test_dw_sweep_picks_and_reports(cache, fake_timing):
    cands = candidate_dw_tiles(16, 7, kh=3, kw=3, sw=2, float_mode=True)
    fake_timing["times"] = {cands[0]: [0.004, 0.0041],
                            cands[4]: [0.002, 0.0021]}
    got = pick_blocks_dw(8, 14, 14, 16, kh=3, kw=3, strides=(2, 2),
                         pads="SAME", bits=2, int8_act=False, packed=True,
                         timed=True)
    assert got == cands[4]
    r = dwops.sweep_reports[-1]
    assert r["kernel"] == "qconv_dw_f32" and r["out"] == [7, 7]
    assert r["pads"] == [[0, 1], [0, 1]] and r["window"] == [3, 3]
    assert autotune.tuned_entries("qconv_dw:") == {
        "qconv_dw:8:14:14:16:7x7:3x3:2x2:2:0:1": got}


# ---------------------------------------------------------------------------
# the card's autotune phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SRC = ROOT / "src"
    return mod


def test_chip_smoke_autotune_checks_rehearse_on_the_cpu(cache, fake_timing):
    """``chip_smoke.py``'s checks of the swept calls on the CPU: every
    candidate of each report against the plain version (which the CPU runs
    for every case), then a second process on the same cache file that
    must resolve every report from the disk with no sweep."""
    cs = _chip_smoke()
    fake_timing["default_ms"] = 0.003
    for M, K, N in PATH_GEMMS[:2] + PATH_GEMMS[3:4]:
        pick_blocks(M, K, N, 8, timed=True)
        pick_blocks(M, K, N, 2, int8_act=False, packed=True, timed=True)
    for (B, H, W, C), st in PATH_DWS[3:5]:
        pick_blocks_dw(B, H, W, C, kh=3, kw=3, strides=st, pads="SAME",
                       bits=4, packed=True, timed=True)
    reports = list(qops.sweep_reports)[-6:] + list(dwops.sweep_reports)[-2:]
    held = cs.hold_candidates(reports, "cpu")
    assert held["cases"] == sum(len(r["candidates"]) for r in reports)
    assert held["max_abs_err"] == 0.0
    reload = cs.reload_picks(reports)
    assert reload["sweeps"] == 0
    assert "spread" in cs._report_line(reports[0])


@pytest.mark.parametrize("int8_act", [True, False])
def test_candidate_checks_run_their_cases_on_the_cpu(int8_act):
    res = checks.qgemm_candidates_check("cpu", 49, 16, 32, bits=8,
                                        packed=False, int8_act=int8_act)
    assert res["cases"] == len(candidate_tiles(49, 16, 32, not int8_act))
    assert res["failures"] == [] and res["max_abs_err"] == 0.0
    res = checks.qconv_dw_candidates_check(
        "cpu", 2, 14, 14, 16, kh=3, kw=3, strides=(2, 2), pads="SAME",
        bits=4, packed=True, int8_act=int8_act)
    assert res["cases"] == 9 and res["failures"] == []
