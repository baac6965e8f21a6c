"""Persistent tile-choice cache shared by the port's CUDA kernel families
(counterpart of ``repro.kernels.autotune``).

Timed tile picks are cached at two levels: each kernel family keeps its own
in-process L1 dict, and the picks timed on the card persist here to ONE
JSON file (``~/.cache/repro_torch/autotune.json``; override with
``REPRO_TORCH_AUTOTUNE_CACHE=<path>``, disable persistence with
``REPRO_TORCH_AUTOTUNE_CACHE=off``), so tuning survives across processes.
The port keeps its own variable and file: the reference's file holds Pallas
block tuples, which mean nothing to these kernels.

Keys are family-prefixed strings and values positive-int tuples of a
family's own arity:

* ``"qgemm:M:K:N:bits:int8_act:packed"`` -> ``(mapping, bm, bn, bk,
  splits)``, mapping 1 = tiled and 2 = skinny (``csrc/qgemm.cu``'s
  mappings; :func:`repro_torch.kernels.qmatmul.ops.pick_blocks`);
* ``"qconv_dw:B:H:W:C:OHxOW:khxkw:shxsw:bits:int8_act:packed"`` ->
  ``(ct, owb)``, the channel tile and the output-column band of
  ``csrc/qconv_dw.cu``
  (:func:`repro_torch.kernels.qconv_dw.ops.pick_blocks_dw`).

The file carries an explicit schema version, starting at 1 in this
package::

    {"schema": 1, "entries": {"<key>": [<ints...>], ...}}

A file whose schema is not :data:`CACHE_SCHEMA`, or whose ``entries`` is
not a dict, reads as empty, so a stale cache retunes instead of handing a
kernel a tuple of the wrong arity.  One bad entry is dropped and the rest
survive.  Bump :data:`CACHE_SCHEMA` whenever a key format or tuple arity
changes.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

CACHE_SCHEMA = 1

AUTOTUNE_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


class CacheFormatError(ValueError):
    """A cache value that is not a non-empty sequence of positive ints (a
    bool is not an int here; floats, NaN and negatives are refused): a
    corrupted pick would otherwise reach a kernel's launch arguments."""


def _valid_blocks(v: object) -> Tuple[int, ...]:
    """Validate one cache value; raises :class:`CacheFormatError`."""
    if not isinstance(v, (list, tuple)) or len(v) < 1:
        raise CacheFormatError(
            f"cache entry must be a non-empty block list, got {v!r}")
    blocks = []
    for b in v:
        if isinstance(b, bool) or not isinstance(b, int) or b <= 0:
            raise CacheFormatError(
                f"block sizes must be positive integers, got {b!r} in {v!r}")
        blocks.append(int(b))
    return tuple(blocks)


# the loaded file: {"path": the path it was read from (False: not yet), or
# None when persistence is off, "data": {key: blocks}}; re-read when the
# environment variable changes.  The dict OBJECT is shared by identity with
# the kernel families' ops modules.
_disk_state: Dict[str, object] = {"path": False, "data": {}}


def autotune_cache_path() -> Optional[str]:
    """The cache file's path, or None when persistence is disabled."""
    p = os.environ.get(AUTOTUNE_CACHE_ENV)
    if p is None:
        return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                            "autotune.json")
    p = p.strip()
    if p.lower() in ("", "0", "off", "none"):
        return None
    return os.path.expanduser(p)


def disk_cache() -> Dict[str, Tuple[int, ...]]:
    """The persisted ``{key: blocks}`` map (empty when disabled, unreadable,
    or written under another :data:`CACHE_SCHEMA`)."""
    path = autotune_cache_path()
    if _disk_state["path"] != path:
        data: Dict[str, Tuple[int, ...]] = {}
        if path is not None and os.path.exists(path):
            try:
                with open(path) as f:
                    raw = json.load(f)
                if isinstance(raw, dict) and raw.get("schema") == CACHE_SCHEMA:
                    entries = raw.get("entries", {})
                    if not isinstance(entries, dict):
                        raise CacheFormatError(
                            f"'entries' must be a dict, got "
                            f"{type(entries).__name__}")
                    for k, v in entries.items():
                        try:
                            data[str(k)] = _valid_blocks(v)
                        except CacheFormatError:
                            continue
            except (OSError, ValueError, TypeError):
                data = {}
        _disk_state["path"] = path
        _disk_state["data"] = data
    return _disk_state["data"]  # type: ignore[return-value]


def tuned_entries(prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    """The persisted tile picks whose key starts with ``prefix`` (``""``:
    every family; ``"qconv_dw:"``: the depthwise kernel).  The explorer
    counts them as its fronts' ``tuned_tilings``."""
    return {k: tuple(v) for k, v in disk_cache().items()
            if k.startswith(prefix)}


def disk_put(key: str, blocks: Tuple[int, ...]) -> None:
    """Write one timed pick through to the file (no-op when persistence is
    off).  Strict: a malformed pick raises :class:`CacheFormatError`
    instead of reaching every later process.  The file is replaced
    atomically, so a concurrent reader never sees a partial one."""
    path = autotune_cache_path()
    if path is None:
        return
    data = disk_cache()
    data[key] = _valid_blocks(blocks)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"schema": CACHE_SCHEMA,
                       "entries": {k: list(v)
                                   for k, v in sorted(data.items())}},
                      f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass      # persistence is best effort: a call never fails on it


# -- timing a sweep on the card -----------------------------------------------
# Each candidate's launches are captured in one CUDA graph and replayed
# between CUDA events, so the window measures the card and not the host's
# launch path (a call of a few microseconds is shorter than its launch);
# windows of the candidates alternate, so a drift of the card's clock
# reaches every candidate alike.
SWEEP_WINDOWS = 7
SWEEP_LAUNCHES = 20
# where a sweep makes its operands: the card its launches time
SWEEP_DEVICE = "cuda"


def time_candidates(launches: Dict[object, Callable[[], None]],
                    windows: int = SWEEP_WINDOWS,
                    per_window: int = SWEEP_LAUNCHES
                    ) -> Dict[object, List[float]]:
    """Milliseconds per launch of each candidate, one value per window.

    ``launches`` maps a candidate to a function that enqueues one launch of
    it on the current stream and allocates nothing.  Each is called twice
    first (a refused launch raises there), then ``per_window`` calls are
    captured in a CUDA graph, and the graphs are replayed in turns,
    ``windows`` times each."""
    import torch
    for fn in launches.values():
        fn()
        fn()
    torch.cuda.synchronize()
    graphs = {}
    for key, fn in launches.items():
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            for _ in range(per_window):
                fn()
        graphs[key] = g
    for g in graphs.values():
        g.replay()
    torch.cuda.synchronize()
    events = {key: [] for key in graphs}
    for _ in range(windows):
        for key, g in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            events[key].append((start, end))
    torch.cuda.synchronize()
    out = {key: [s.elapsed_time(e) / per_window for s, e in evs]
           for key, evs in events.items()}
    del graphs
    return out


def choose(times: Dict[object, List[float]], default: object
           ) -> Tuple[object, float]:
    """(the pick, the sweep's spread in ms).  The spread is the widest range
    between a candidate's best and worst window.  The fastest candidate (by
    its best window) is picked only if it beats ``default``'s best window by
    more than that spread; otherwise ``default`` stays: at a few
    microseconds a call, a strict minimum would pick noise."""
    best = {k: min(v) for k, v in times.items()}
    spread = max(max(v) - min(v) for v in times.values())
    fastest = min(best, key=best.get)
    if best[fastest] < best[default] - spread:
        return fastest, spread
    return default, spread
