"""Model configurations the port runs (own copies of ``repro.configs``).

:func:`get_config` lists the LM architectures the port's LM path serves;
every other architecture of the reference's registry raises ``KeyError``
naming the ROADMAP queue where it waits.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterator, List, Tuple

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, ModelConfig,
                                      ShapeConfig, shapes_for)
from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.configs.separable_cnn import SeparableCNNConfig

__all__ = ["ALL_SHAPES", "ARCH_IDS", "CNNConfig", "DECODE_32K", "LONG_500K",
           "ModelConfig", "PREFILL_32K", "SeparableCNNConfig", "ShapeConfig",
           "TRAIN_4K", "all_cells", "get_cnn_config", "get_config",
           "get_shape", "require_lm_family", "shapes_for"]

# arch-id -> module name, for the LM architectures the port runs, in the
# reference registry's order
_REGISTRY: Dict[str, str] = {
    "hymba-1.5b": "hymba_1_5b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "mamba2-1.3b": "mamba2_1_3b",
}
ARCH_IDS: List[str] = list(_REGISTRY)
# the reference's other LM architectures: they need MoE, an encoder or the
# vision stub, which the port does not have yet
_NOT_PORTED = ("granite-moe-3b-a800m", "mixtral-8x7b", "whisper-base",
               "phi-3-vision-4.2b")


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP Queue 1, "
                       f"the LM side); the port runs {ARCH_IDS}")
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port runs {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[arch]}").CONFIG


def require_lm_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose blocks the port
    does not have yet: MoE, the vision stub, the encoder-decoder."""
    if cfg.moe is not None or cfg.n_patches or cfg.enc_layers \
            or cfg.family in ("moe", "vlm", "audio", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: the port's LM path runs the ssm, hybrid and dense "
            f"families; {cfg.family} blocks wait in ROADMAP Queue 1 (the LM "
            f"side)")


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def get_cnn_config() -> CNNConfig:
    from repro_torch.configs.mnist_cnn import CONFIG
    return CONFIG


def all_cells() -> Iterator[Tuple[str, str]]:
    """Every applicable (arch, shape) cell of the architectures the port
    runs."""
    for arch in ARCH_IDS:
        for shape in shapes_for(get_config(arch)):
            yield arch, shape.name
