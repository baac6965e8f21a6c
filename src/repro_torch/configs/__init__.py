"""Model configurations the port runs (own copies of ``repro.configs``).

:func:`get_config` lists the LM architectures the port's LM path serves;
every other architecture of the reference's registry raises ``KeyError``
naming the ROADMAP queue where it waits.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.configs.separable_cnn import SeparableCNNConfig

__all__ = ["ARCH_IDS", "CNNConfig", "ModelConfig", "SeparableCNNConfig",
           "get_config"]

# arch-id -> module name, for the LM architectures the port runs
_REGISTRY = {"mamba2-1.3b": "mamba2_1_3b"}
ARCH_IDS = list(_REGISTRY)
# the reference's other LM architectures: they need attention, MoE or an
# encoder, which the port does not have yet
_NOT_PORTED = ("granite-moe-3b-a800m", "mixtral-8x7b", "whisper-base",
               "hymba-1.5b", "phi3-mini-3.8b", "h2o-danube-3-4b",
               "codeqwen1.5-7b", "qwen1.5-0.5b", "phi-3-vision-4.2b")


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP Queue 1, "
                       f"the LM side); the port runs {ARCH_IDS}")
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port runs {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[arch]}").CONFIG
