"""MobileNet-style depthwise-separable classifier config.

The workload class the direct depthwise kernels open up: a standard conv
stem, then blocks of DepthwiseConv(3x3) + BN + ReLU followed by a pointwise
Conv(1x1) + BN + ReLU — the factorization MobileNet popularized.  Spatial
downsampling happens in the depthwise stage (its ``stride``), exactly where
the legacy im2col lowering pays its kh*kw patch-blowup for zero reuse.

The port's own copy of ``repro.configs.separable_cnn``.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SeparableCNNConfig:
    name: str = "separable-cnn"
    image_hw: Tuple[int, int] = (28, 28)
    in_channels: int = 1
    stem_channels: int = 8
    # (out_channels, depthwise stride) per separable block
    blocks: Tuple[Tuple[int, int], ...] = ((16, 1), (32, 2))
    kernel_size: int = 3
    pool: int = 2
    n_classes: int = 10

    @property
    def fc_in(self) -> int:
        h, w = self.image_hw
        h, w = h // self.pool, w // self.pool        # stem maxpool
        for _, s in self.blocks:
            h, w = -(-h // s), -(-w // s)            # SAME depthwise stride
        return h * w * self.blocks[-1][0]


CONFIG = SeparableCNNConfig()
