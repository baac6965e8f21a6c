"""The paper's own accelerator model (Table II): 2 convolutional blocks
(conv + maxpool + batchnorm + relu) followed by 1 fully connected layer,
classifying 28x28 MNIST digits into 10 classes.

The port's own copy of ``repro.configs.mnist_cnn`` (the port imports nothing
of ``repro``).
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CNNConfig:
    name: str = "mnist-cnn"
    image_hw: Tuple[int, int] = (28, 28)
    in_channels: int = 1
    conv_channels: Tuple[int, ...] = (16, 32)
    kernel_size: int = 3
    pool: int = 2
    n_classes: int = 10

    @property
    def fc_in(self) -> int:
        h, w = self.image_hw
        for _ in self.conv_channels:
            h, w = h // self.pool, w // self.pool
        return h * w * self.conv_channels[-1]


CONFIG = CNNConfig()
