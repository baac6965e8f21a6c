"""The flow's CNN models (counterpart of ``repro.models.cnn``): the paper's
2-block MNIST CNN and the depthwise-separable classifier, as parameter
dictionaries and as plain forward functions — the oracles the stream target
and the quickstart are held to — with the MNIST CNN's loss (batch
statistics, for autograd training) and accuracy (running statistics).

Weights are HWIO (conv) / (K, N) (Gemm) float32 tensors keyed exactly as the
reference keys them, so the readers build the same IR from either package.
``init_params`` / ``init_separable_params`` draw from a ``torch.Generator``
(the reference draws from ``jax.random``: the numbers differ, the shapes and
scales do not); :func:`params_from_jax` carries the reference's own arrays
across, checked against the config, so both packages compute the same thing.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.configs.separable_cnn import SeparableCNNConfig
from repro_torch.core.writers.registry import conv_nhwc
from repro_torch.device import DeviceLike, as_tensor

Config = Union[CNNConfig, SeparableCNNConfig]

_BN_STATS = ("scale", "bias", "mean", "var")


def param_shapes(cfg: Config) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter of ``cfg``'s model (HWIO convs)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    k = cfg.kernel_size
    if isinstance(cfg, SeparableCNNConfig):
        shapes["stem/w"] = (k, k, cfg.in_channels, cfg.stem_channels)
        shapes["stem/b"] = (cfg.stem_channels,)
        cin = cfg.stem_channels
        for i, (cout, _) in enumerate(cfg.blocks):
            shapes[f"dw{i}/w"] = (k, k, 1, cin)
            shapes[f"dw{i}/b"] = (cin,)
            shapes[f"pw{i}/w"] = (1, 1, cin, cout)
            shapes[f"pw{i}/b"] = (cout,)
            for layer, c in ((f"dw{i}", cin), (f"pw{i}", cout)):
                for stat in _BN_STATS:
                    shapes[f"{layer}_bn/{stat}"] = (c,)
            cin = cout
    else:
        cin = cfg.in_channels
        for i, cout in enumerate(cfg.conv_channels):
            shapes[f"conv{i}/w"] = (k, k, cin, cout)
            shapes[f"conv{i}/b"] = (cout,)
            for stat in _BN_STATS:
                shapes[f"bn{i}/{stat}"] = (cout,)
            cin = cout
    shapes["fc/w"] = (cfg.fc_in, cfg.n_classes)
    shapes["fc/b"] = (cfg.n_classes,)
    return shapes


def _fan_in(name: str, shape: Tuple[int, ...]) -> int:
    if name.startswith("dw"):
        return shape[0] * shape[1]            # one filter per channel
    return int(math.prod(shape[:-1]))


def _init(cfg: Config, generator: torch.Generator,
          device: DeviceLike) -> Dict[str, torch.Tensor]:
    """Normal / sqrt(fan_in) weights, zero biases, identity BN statistics —
    the reference's initialization scheme."""
    out: Dict[str, torch.Tensor] = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("/w"):
            t = torch.randn(shape, generator=generator, dtype=torch.float32)
            t = t / math.sqrt(_fan_in(name, shape))
        elif name.endswith(("/scale", "/var")):
            t = torch.ones(shape, dtype=torch.float32)
        else:
            t = torch.zeros(shape, dtype=torch.float32)
        out[name] = t.to(device) if device is not None else t
    return out


def init_params(cfg: CNNConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The 2-conv-block + FC MNIST classifier's parameters."""
    return _init(cfg, generator, device)


def init_separable_params(cfg: SeparableCNNConfig, generator: torch.Generator,
                          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Conv stem + (depthwise 3x3, pointwise 1x1) separable blocks + FC."""
    return _init(cfg, generator, device)


def params_from_jax(params: Mapping[str, np.ndarray], device: DeviceLike,
                    cfg: Optional[Config] = None) -> Dict[str, torch.Tensor]:
    """The reference package's parameter arrays (as numpy) -> float32 tensors
    on ``device``, checked name by name, shape by shape (HWIO) and dtype by
    dtype against ``cfg`` (default: the published config whose names match —
    separable-cnn when ``stem/w`` is present, else mnist-cnn).  Any mismatch
    raises ``ValueError``."""
    if cfg is None:
        cfg = SeparableCNNConfig() if "stem/w" in params else CNNConfig()
    expected = param_shapes(cfg)
    missing = sorted(set(expected) - set(params))
    extra = sorted(set(params) - set(expected))
    if missing or extra:
        raise ValueError(f"parameter names do not match {cfg.name}: "
                         f"missing {missing}, unexpected {extra}")
    out: Dict[str, torch.Tensor] = {}
    for name, shape in expected.items():
        arr = np.asarray(params[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                             f"{shape} for {cfg.name}")
        if arr.dtype != np.float32:
            raise ValueError(f"{name}: dtype {arr.dtype}, expected float32")
        out[name] = torch.from_numpy(np.array(arr)).to(device)
    return out


# ---------------------------------------------------------------------------
# Forward functions (NHWC activations, HWIO weights, XLA's SAME padding)
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, Cin); w: (kh, kw, Cin, Cout) — SAME padding, stride 1."""
    return conv_nhwc(x, w, (1, 1), "SAME") + b


def maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window, stride k, VALID (NHWC)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=k, stride=k)
    return y.permute(0, 2, 3, 1)


def batchnorm(x: torch.Tensor, scale, bias, mean, var,
              eps: float = 1e-5) -> torch.Tensor:
    inv = scale * torch.rsqrt(var + eps)
    return x * inv + (bias - mean * inv)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: CNNConfig,
            train_stats: bool = False):
    """x: (B, H, W, C) -> (logits (B, n_classes), aux).

    ``train_stats`` uses the batch statistics (returned in ``aux``), else the
    stored running statistics."""
    aux = {}
    for i in range(len(cfg.conv_channels)):
        x = conv2d(x, params[f"conv{i}/w"], params[f"conv{i}/b"])
        x = maxpool(x, cfg.pool)
        if train_stats:
            mean = x.mean(dim=(0, 1, 2))
            var = x.var(dim=(0, 1, 2), unbiased=False)
            aux[f"bn{i}/mean"], aux[f"bn{i}/var"] = mean, var
        else:
            mean, var = params[f"bn{i}/mean"], params[f"bn{i}/var"]
        x = batchnorm(x, params[f"bn{i}/scale"], params[f"bn{i}/bias"], mean,
                      var)
        x = torch.relu(x)
    x = x.reshape(x.shape[0], -1)
    return x @ params["fc/w"] + params["fc/b"], aux


def loss_fn(params: Dict[str, torch.Tensor], x: torch.Tensor, labels,
            cfg: CNNConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy of ``forward(..., train_stats=True)``: (loss, the
    batch statistics).  ``labels`` (B,) integer class ids."""
    logits, aux = forward(params, x, cfg, train_stats=True)
    labels = as_tensor(labels, logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels[:, None])[:, 0]
    return (logz - gold).mean(), aux


def accuracy(params: Dict[str, torch.Tensor], x: torch.Tensor, labels,
             cfg: CNNConfig) -> torch.Tensor:
    """Top-1 accuracy with the stored running statistics."""
    logits, _ = forward(params, x, cfg)
    labels = as_tensor(labels, logits.device)
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 1) -> torch.Tensor:
    """x: (B, H, W, C); w: (kh, kw, 1, C) HWIO — SAME padding, one filter
    per channel."""
    return conv_nhwc(x, w, (stride, stride), "SAME",
                     groups=int(x.shape[-1])) + b


def separable_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                      cfg: SeparableCNNConfig) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes), with the stored statistics —
    the oracle of the separable IR graph."""
    x = conv2d(x, params["stem/w"], params["stem/b"])
    x = torch.relu(x)
    x = maxpool(x, cfg.pool)
    for i, (_, stride) in enumerate(cfg.blocks):
        x = depthwise_conv2d(x, params[f"dw{i}/w"], params[f"dw{i}/b"], stride)
        x = batchnorm(x, params[f"dw{i}_bn/scale"], params[f"dw{i}_bn/bias"],
                      params[f"dw{i}_bn/mean"], params[f"dw{i}_bn/var"])
        x = torch.relu(x)
        x = conv2d(x, params[f"pw{i}/w"], params[f"pw{i}/b"])
        x = batchnorm(x, params[f"pw{i}_bn/scale"], params[f"pw{i}_bn/bias"],
                      params[f"pw{i}_bn/mean"], params[f"pw{i}_bn/var"])
        x = torch.relu(x)
    x = x.reshape(x.shape[0], -1)
    return x @ params["fc/w"] + params["fc/b"]
