"""Device selection shared by every entry point of the port.

The port runs on the CUDA device unless the caller asks for the CPU: a
missing CUDA runtime is an error, never a silent fallback to the CPU path.
(No counterpart in ``repro``: JAX picks its backend globally.)
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a CUDA runtime raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless the "
            "caller asks for the CPU (pass device='cpu' to run the plain "
            "PyTorch path)")
    return dev


def as_tensor(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """Host array or tensor -> tensor on ``device`` (no copy when it is
    already there)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()        # torch cannot wrap a read-only buffer safely
    return torch.as_tensor(x, device=device)


def to_numpy(x):
    """Tensor (any device) or array -> numpy array on the host (a device
    tensor is copied back, which waits for the work that produced it).
    numpy has no bfloat16, so a bf16 tensor comes back as float32: exact,
    so a caller that takes bf16 casts it back to the same values.  (The
    reference's ``np.asarray`` gives an ``ml_dtypes`` bfloat16 array; the
    port cannot count on having ``ml_dtypes``.)  A DTensor comes back as
    its global value (``full_tensor()``, a collective every rank joins)."""
    if isinstance(x, torch.Tensor):
        if is_dtensor(x):
            x = x.full_tensor()
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
