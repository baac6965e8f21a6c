"""LM parameter tree: shapes, initialization, analytic counts, and the
carry-over of the reference's arrays (counterpart of
``repro.models.params``).

``param_shapes(cfg, max_seq, tp_total)`` is the single source of truth, with
the reference's path names and layouts: decoder layers stacked on a leading
L dim under ``layers/``, MoE experts in the expert-parallel layout
``(tp_total, E/ep, d, f/tp)``; the encoder-decoder's encoder stack under
``enc/`` with its positions ``enc_pos``/``dec_pos`` and the decoder's
``layers/cross/*``; the vision stub's ``vision_proj/w``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def moe_factors(n_experts: int, tp_total: int) -> Tuple[int, int]:
    ep = math.gcd(n_experts, tp_total)
    return ep, tp_total // ep


def _attn_shapes(cfg: ModelConfig, L: int, prefix: str, bias: bool) -> Dict[str, tuple]:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {
        f"{prefix}_norm/w": (L, d),
        f"{prefix}/wq": (L, d, q),
        f"{prefix}/wk": (L, d, kv),
        f"{prefix}/wv": (L, d, kv),
        f"{prefix}/wo": (L, q, d),
    }
    if bias:
        s[f"{prefix}/bq"] = (L, q)
        s[f"{prefix}/bk"] = (L, kv)
        s[f"{prefix}/bv"] = (L, kv)
    return s


def _mlp_shapes(cfg: ModelConfig, L: int, prefix: str = "mlp") -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    s = {f"{prefix}_norm/w": (L, d)}
    if cfg.act == "swiglu":
        s[f"{prefix}/w_gate"] = (L, d, f)
        s[f"{prefix}/w_up"] = (L, d, f)
        s[f"{prefix}/w_down"] = (L, f, d)
    else:
        s[f"{prefix}/w_up"] = (L, d, f)
        s[f"{prefix}/b_up"] = (L, f)
        s[f"{prefix}/w_down"] = (L, f, d)
        s[f"{prefix}/b_down"] = (L, d)
    return s


def _moe_shapes(cfg: ModelConfig, L: int, tp_total: int) -> Dict[str, tuple]:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    ep, tp = moe_factors(E, tp_total)
    el, fl = E // ep, f // tp
    return {
        "mlp_norm/w": (L, d),
        "moe/router": (L, d, E),
        "moe/w_gate": (L, tp_total, el, d, fl),
        "moe/w_up": (L, tp_total, el, d, fl),
        "moe/w_down": (L, tp_total, el, fl, d),
    }


def _ssm_shapes(cfg: ModelConfig, L: int) -> Dict[str, tuple]:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = cfg.d_inner
    H = cfg.n_ssm_heads
    gn = 2 * s.n_groups * s.d_state
    conv_dim = d_inner + gn                 # conv over (x, B, C)
    return {
        "ssm_norm/w": (L, d),
        "ssm/w_z": (L, d, d_inner),
        "ssm/w_x": (L, d, d_inner),
        "ssm/w_bc": (L, d, gn),
        "ssm/w_dt": (L, d, H),
        "ssm/conv": (L, s.d_conv, conv_dim),
        "ssm/A_log": (L, H),
        "ssm/D": (L, H),
        "ssm/dt_bias": (L, H),
        "ssm/norm_w": (L, d_inner),
        "ssm/w_out": (L, d_inner, d),
    }


def param_shapes(cfg: ModelConfig, max_seq: int = 0, tp_total: int = 1) -> Dict[str, tuple]:
    """Flat {path: shape}.  Decoder stack paths are prefixed ``layers/`` and
    carry a leading L dim; the encoder stack uses ``enc/``."""
    d, L = cfg.d_model, cfg.n_layers
    shapes: Dict[str, tuple] = {
        "embed/table": (cfg.vocab_padded, d),
        "final_norm/w": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head/w"] = (d, cfg.vocab_padded)

    layer: Dict[str, tuple] = {}
    if cfg.family != "ssm":
        layer.update(_attn_shapes(cfg, L, "attn", cfg.qkv_bias))
    if cfg.family in ("ssm", "hybrid"):
        layer.update(_ssm_shapes(cfg, L))
    if cfg.moe is not None:
        layer.update(_moe_shapes(cfg, L, tp_total))
    elif cfg.d_ff > 0:
        layer.update(_mlp_shapes(cfg, L))
    shapes.update({f"layers/{k}": v for k, v in layer.items()})

    if cfg.enc_layers:
        Le = cfg.enc_layers
        enc: Dict[str, tuple] = {}
        enc.update(_attn_shapes(cfg, Le, "attn", cfg.qkv_bias))
        enc.update(_mlp_shapes(cfg, Le))
        shapes.update({f"enc/{k}": v for k, v in enc.items()})
        shapes["enc_final_norm/w"] = (d,)
        shapes["enc_pos"] = (cfg.enc_seq, d)
        shapes["dec_pos"] = (max(max_seq, 8), d)
        shapes.update({f"layers/{k}": v for k, v in _attn_shapes(cfg, L, "cross", False).items()})
    if cfg.n_patches:
        shapes["vision_proj/w"] = (d, d)
    return shapes


_F32_SUFFIXES = ("A_log", "dt_bias")


def param_dtype(path: str, default: torch.dtype) -> torch.dtype:
    if any(path.endswith(s) for s in _F32_SUFFIXES):
        return torch.float32
    return default


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                max_seq: int = 0, tp_total: int = 1,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Scaled-normal init matching ``param_shapes`` exactly, with the
    reference's distributions (drawn from ``generator``, so the numbers
    differ from ``jax.random``'s).  Numbers are drawn on the generator's
    device and the tree lands on ``device``."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg, max_seq=max_seq, tp_total=tp_total)
    dt = _dtype(cfg.dtype)
    gd = generator.device
    params: Dict[str, torch.Tensor] = {}

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=gd,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    for path, shape in sorted(shapes.items()):
        pdt = param_dtype(path, dt)
        if path.endswith(("norm/w", "norm_w", "/D")):
            t = torch.ones(shape, dtype=pdt, device=gd)
        elif path.endswith("A_log"):
            t = torch.log(uniform(shape, 1.0, 16.0))
        elif path.endswith("dt_bias"):
            t = torch.log(torch.expm1(uniform(shape, 1e-3, 0.1)))
        elif path.endswith(("/bq", "/bk", "/bv", "/b_up", "/b_down")):
            t = torch.zeros(shape, dtype=pdt, device=gd)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
            t = (torch.randn(shape, generator=generator, device=gd,
                             dtype=torch.float32) * std).to(pdt)
        params[path] = t.to(dev)
    return params


def abstract_params(cfg: ModelConfig, max_seq: int = 0,
                    tp_total: int = 1) -> Dict[str, torch.Tensor]:
    """``param_shapes`` with ``param_dtype`` as meta tensors: a shape and a
    dtype and no storage (the reference's ``ShapeDtypeStruct`` leaves)."""
    dt = _dtype(cfg.dtype)
    return {p: torch.empty(s, dtype=param_dtype(p, dt), device="meta")
            for p, s in param_shapes(cfg, max_seq=max_seq,
                                     tp_total=tp_total).items()}


def count_params_analytic(cfg: ModelConfig, active_only: bool = False,
                          max_seq: int = 0) -> int:
    """Total (or MoE-active) parameter count; positions/embeddings included."""
    total = 0
    for path, shape in param_shapes(cfg, max_seq=max_seq, tp_total=1).items():
        n = int(np.prod(shape))
        if active_only and "/moe/w_" in path:
            m = cfg.moe
            n = n * m.top_k // m.n_experts
        total += n
    return total


def params_from_jax(params: Mapping[str, np.ndarray], cfg: ModelConfig,
                    device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The reference's parameter arrays (as numpy; bf16 ones are
    ``ml_dtypes`` arrays) -> tensors on ``device``, checked name by name,
    shape by shape and dtype by dtype against :func:`param_shapes` and
    :func:`param_dtype`.  bf16 arrays cross bit for bit, viewed as uint16.
    Any mismatch raises ``ValueError``."""
    dev = resolve_device(device)
    # dec_pos, the one shape that depends on max_seq, sets it
    max_seq = np.shape(params["dec_pos"])[0] if "dec_pos" in params else 0
    expected = param_shapes(cfg, max_seq=max_seq)
    missing = sorted(set(expected) - set(params))
    extra = sorted(set(params) - set(expected))
    if missing or extra:
        raise ValueError(f"parameter names do not match {cfg.name}: "
                         f"missing {missing}, unexpected {extra}")
    dt = _dtype(cfg.dtype)
    out: Dict[str, torch.Tensor] = {}
    for path, shape in expected.items():
        arr = np.asarray(params[path])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(shape)} for {cfg.name}")
        out[path] = tensor_from_numpy(path, arr,
                                      param_dtype(path, dt)).to(dev)
    return out


def tensor_from_numpy(name: str, arr: np.ndarray,
                      want: torch.dtype) -> torch.Tensor:
    """A reference array (a bf16 one is an ``ml_dtypes`` array) -> a CPU
    tensor of ``want`` (bf16 or f32), bit for bit: bf16 crosses viewed as
    16-bit integers.  Another dtype raises ``ValueError``."""
    if want == torch.bfloat16:
        if arr.dtype.name != "bfloat16":
            raise ValueError(f"{name}: dtype {arr.dtype}, expected bfloat16")
        return torch.from_numpy(np.asarray(arr, order="C").view(np.int16)
                                .copy()).view(torch.bfloat16)
    if arr.dtype != np.float32:
        raise ValueError(f"{name}: dtype {arr.dtype}, expected float32")
    return torch.from_numpy(np.array(arr))
