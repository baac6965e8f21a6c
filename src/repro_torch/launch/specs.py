"""Meta-tensor stand-ins and shardings for every dry-run cell (counterpart
of ``repro.launch.specs``).

A meta tensor has a shape and a dtype and no storage: the port's
``ShapeDtypeStruct``.  ``input_specs(cfg, shape)`` gives the abstract model
inputs; the other functions give what ``launch.dryrun`` traces per cell
kind:

  train   -> (TrainState, batch{tokens, labels[, frames|patches]})
  prefill -> (params, batch{tokens[, frames|patches]})
  decode  -> (params, tokens(B, 1), DecodeState)

Two rules differ from the serving and training helpers, as the
reference's do: :func:`batch_sharding` replicates a batch that the data
axes do not divide (long_500k's ``global_batch=1``), where
``runtime.train.batch_shardings`` always shards, and
:func:`decode_state_sharding` then puts the cache's sequence dim over the
data axes, where ``runtime.serve.decode_state_shardings`` always shards
the batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.params import abstract_params
from repro_torch.optim.adamw import OptState
from repro_torch.runtime.train import TrainState
from repro_torch.sharding import (P, NamedSharding, batch_axes, dp_size,
                                  param_sharding, tp_size)


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def kv_dtype_of(name: Optional[str]) -> torch.dtype:
    """A torch dtype's name (``"float8_e4m3fn"``) -> the dtype; None is
    bf16."""
    if name is None:
        return torch.bfloat16
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown torch dtype {name!r}")
    return dt


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Abstract model inputs for one cell (tokens/labels + modality stubs)."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    specs = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "audio":
        specs["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.n_patches and not shape.is_decode:
        specs["patches"] = _meta((B, cfg.n_patches, cfg.d_model),
                                 torch.bfloat16)
    return specs


def batch_sharding(specs: Dict, mesh) -> Dict[str, NamedSharding]:
    dp = batch_axes(mesh)
    n = dp_size(mesh)
    out = {}
    for k, v in specs.items():
        if v.ndim and v.shape[0] % n == 0:
            out[k] = NamedSharding(mesh, P(dp, *([None] * (v.ndim - 1))))
        else:
            out[k] = NamedSharding(mesh, P())  # tiny batch (long_500k)
    return out


def abstract_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                          kv_dtype=None):
    """The decode state's leaves as meta tensors (a host int ``index``);
    ``kv_dtype`` a torch dtype's name, bf16 by default."""
    B = shape.global_batch
    dt = kv_dtype_of(kv_dtype)
    if cfg.family == "audio":
        return encdec.abstract_decode_state(cfg, B, shape.seq_len, dt)
    return transformer.abstract_decode_state(cfg, B, shape.seq_len, dt)


def decode_state_sharding(cfg: ModelConfig, state, mesh):
    """Flat kv dims over ``model``; batch over dp when divisible, else the
    cache *sequence* dim over the data axes (long_500k, global_batch=1)."""
    del cfg
    dp = batch_axes(mesh)
    ndp = dp_size(mesh)
    tp = tp_size(mesh)

    def spec(x, seq_dim: Optional[int] = None,
             feat_dim: Optional[int] = None):
        if x is None:
            return None
        parts = [None] * x.ndim
        if x.shape[1] % ndp == 0:
            parts[1] = dp
        elif seq_dim is not None and x.shape[seq_dim] % ndp == 0:
            parts[seq_dim] = dp
        if feat_dim is not None and x.shape[feat_dim] % tp == 0:
            parts[feat_dim] = "model"
        return NamedSharding(mesh, P(*parts))

    if isinstance(state, encdec.EncDecDecodeState):
        return encdec.EncDecDecodeState(
            cache_k=spec(state.cache_k, seq_dim=2, feat_dim=3),
            cache_v=spec(state.cache_v, seq_dim=2, feat_dim=3),
            cross_k=spec(state.cross_k),
            cross_v=spec(state.cross_v),
            index=NamedSharding(mesh, P()))
    return transformer.DecodeState(
        cache_k=spec(state.cache_k, seq_dim=2, feat_dim=3),
        cache_v=spec(state.cache_v, seq_dim=2, feat_dim=3),
        ssm_ssd=spec(state.ssm_ssd, feat_dim=2),
        ssm_conv=spec(state.ssm_conv),
        index=NamedSharding(mesh, P()))


def abstract_train_state(cfg: ModelConfig, shape: ShapeConfig, tp_total: int,
                         grad_compress: bool = False) -> TrainState:
    params = abstract_params(cfg, max_seq=shape.seq_len, tp_total=tp_total)

    def like(p, dtype):
        return _meta(p.shape, dtype)

    err = None
    if grad_compress:
        err = {k: like(v, torch.bfloat16) for k, v in params.items()}
    return TrainState(
        params=params,
        opt=OptState(mu={k: like(v, torch.float32) for k, v in params.items()},
                     nu={k: like(v, torch.float32) for k, v in params.items()},
                     count=_meta((), torch.int32)),
        err_fb=err)


def abstract_inference_params(cfg: ModelConfig, shape: ShapeConfig,
                              tp_total: int) -> Dict[str, torch.Tensor]:
    return abstract_params(cfg, max_seq=shape.seq_len, tp_total=tp_total)


def param_sharding_for(cfg: ModelConfig, params, mesh
                       ) -> Dict[str, NamedSharding]:
    del cfg
    return param_sharding(params, mesh)
