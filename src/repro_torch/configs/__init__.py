"""Model configurations the port runs (own copies of ``repro.configs``).

:func:`get_config` resolves every LM architecture of the reference's
registry, in its order.
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
           "get_shape", "shapes_for"]

# arch-id -> module name, in the reference registry's order
_REGISTRY: Dict[str, str] = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-base": "whisper_base",
    "hymba-1.5b": "hymba_1_5b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "mamba2-1.3b": "mamba2_1_3b",
}
ARCH_IDS: List[str] = list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[arch]}").CONFIG


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def get_cnn_config() -> CNNConfig:
    from repro_torch.configs.mnist_cnn import CONFIG
    return CONFIG


def all_cells() -> Iterator[Tuple[str, str]]:
    """Every applicable (arch, shape) cell."""
    for arch in ARCH_IDS:
        for shape in shapes_for(get_config(arch)):
            yield arch, shape.name
