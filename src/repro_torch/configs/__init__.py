"""Model configurations the port's slice runs (own copies of ``repro.configs``)."""
from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.configs.separable_cnn import SeparableCNNConfig

__all__ = ["CNNConfig", "SeparableCNNConfig"]
