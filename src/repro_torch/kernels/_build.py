"""Build and load the port's hand-written CUDA kernels (no counterpart in
``repro``: the JAX package's Pallas kernels compile inside ``jax.jit``).

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into an
object file — one ``nvcc`` process per source, all started together — and the
objects are linked into ONE shared library with a plain C interface, loaded
with ``ctypes``.  The library lands in ``build/repro_torch/<hash>/`` at the
repository root (listed in ``.gitignore``; ``REPRO_TORCH_BUILD_DIR``
overrides the root), keyed on a hash of the sources and flags, so the first
call in a fresh checkout builds it and later processes load it.  Nothing is
built when a module is imported: :func:`load_kernels` runs at a kernel's
first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("qgemm.cu", "qconv_dw.cu", "conv2d_stream.cu", "ssd_scan.cu")
HEADERS = ("epilogue.cuh",)
# -fmad=false on top of the explicit __fmul_rn/__fadd_rn in the epilogue:
# the kernels' contract is two roundings, never a contracted fma
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# (x, w, xs, s, bias, out, M, K, N, bits, packed, kp_rows, relu, has_aqt,
#  out_code, qmin, qmax, mapping, bm, bn, bk, splits, mul, inv, stream)
_QGEMM_ARGS = [_P] * 6 + [_I] * 16 + [_F, _F, _P]
# (x, w, s, bias, out, B, H, W, C, OH, OW, kh, kw, sh, sw, ph, pw, bits,
#  packed, kp_rows, relu, has_aqt, out_code, qmin, qmax, ct, owb, mul, inv,
#  stream)
_QCONV_DW_ARGS = [_P] * 5 + [_I] * 22 + [_F, _F, _P]
# (x, w, bias, out, B, H, W, Cin, Cout, kh, kw, x_bf16, w_bf16, rows, tw,
#  ct, px, co, ks, window, ci_vec, x_unit, w_unit, threads, smem_bytes,
#  stream)
_CONV2D_STREAM_ARGS = [_P] * 4 + [_I] * 21 + [_P]
# the SSD scan's three phases:
# (x, dt, A, B, states, decay, B, S, H, P, G, N, Q, 9 element strides,
#  x_bf16, stream)
_SSD_CHUNK_STATE_ARGS = [_P] * 6 + [_I] * 7 + [_L] * 9 + [_I, _P]
# (states, decay, s0, fin, B*H, nc, P, N, stream)
_SSD_STATE_PASS_ARGS = [_P] * 4 + [_I] * 4 + [_P]
# (x, dt, A, B, C, D, states, y, B, S, H, P, G, N, Q, 12 element strides,
#  x_bf16, stream)
_SSD_CHUNK_SCAN_ARGS = [_P] * 8 + [_I] * 7 + [_L] * 12 + [_I, _P]
_IP = ctypes.POINTER(_I)
# C entry point -> its argument types; every one returns a CUDA error code
_ENTRY_POINTS = {
    "repro_qgemm_i8": _QGEMM_ARGS,
    "repro_qgemm_f32": _QGEMM_ARGS,
    "repro_truncate_view": [_P, _P, _I, _I, _P],   # (codes, out, n, bits, stream)
    "repro_qconv_dw_i8": _QCONV_DW_ARGS,
    "repro_qconv_dw_f32": _QCONV_DW_ARGS,
    "repro_conv2d_stream": _CONV2D_STREAM_ARGS,
    # (window, px, co, ci_vec, ks, threads, smem_bytes, *registers,
    #  *blocks_per_sm)
    "repro_conv2d_stream_info": [_I] * 7 + [_IP, _IP],
    "repro_ssd_chunk_state": _SSD_CHUNK_STATE_ARGS,
    "repro_ssd_state_pass": _SSD_STATE_PASS_ARGS,
    "repro_ssd_chunk_scan": _SSD_CHUNK_SCAN_ARGS,
    # (phase, Q, P, N, x_bf16, *smem_bytes, *blocks_per_sm)
    "repro_ssd_scan_info": [_I] * 5 + [_IP, _IP],
}

_lock = threading.Lock()
_lib = None
# what the last build did: seconds, whether it was cached, the library path
# and nvcc's output (-Xptxas -v register/spill report)
build_info: Dict[str, object] = {}


def build_root() -> Path:
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[subprocess.CompletedProcess]:
    """Run the compile commands in parallel and wait for every one."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    done = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        done.append(subprocess.CompletedProcess(cmd, p.returncode, out, ""))
    return done


def build() -> Path:
    """Compile and link the kernel library unless the hashed one exists."""
    out_dir = build_root() / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(cached=True, seconds=0.0, path=str(lib), log="")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [out_dir / f"{name}.{tag}.o" for name in SOURCES]
    try:
        compiled = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                              str(CSRC / name), "-o", str(obj)]
                             for name, obj in zip(SOURCES, objs)])
        log = "\n".join(f"== nvcc {name}\n{r.stdout}"
                        for name, r in zip(SOURCES, compiled))
        failed = [n for n, r in zip(SOURCES, compiled) if r.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                               str(tmp)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp, lib)     # atomic: a concurrent build sees all or none
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_info.update(cached=False, seconds=time.perf_counter() - t0,
                      path=str(lib), log=log)
    return lib


def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with its C entry
    points declared: every pointer and the stream as ``c_void_p``."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _I
            _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")
