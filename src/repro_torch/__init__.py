"""PyTorch/CUDA port of the ONNX-to-hardware design flow (``repro``).

The package mirrors ``src/repro/`` path for path and imports neither ``jax``
nor anything of ``repro``: where it needs a module that the reference keeps
free of jax (configs, the scheduler) it holds its own copy.  Every entry point
runs on the CUDA device unless the caller passes ``device="cpu"``; the
hand-written Hopper kernels live in ``csrc/`` and are built at first use by
:mod:`repro_torch.kernels._build`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
