"""Plain PyTorch version of the SSD chunk-scan kernel (counterpart of
``repro.kernels.ssd_scan.ref``).

:func:`ssd_chunked_plain` is the specification the CUDA kernel
``csrc/ssd_scan.cu`` is held to: the oracle's algorithm with every step in
f32 (f64 for f64 inputs), as the TPU kernel ``ssd_kernel`` computes it —
unlike the model oracle, whose intra-chunk math follows
``perf.FLAGS.ssd_bf16_intra`` — including the oracle's rule for a ragged
length (zero-padding to a chunk multiple, exact since dt=0 rows change
nothing).  The kernel sums each dot in its own order, so the two agree to
f32 rounding, not bit for bit.  ``ssd_ref`` is the model oracle, as in the
reference.
"""
from __future__ import annotations

from repro_torch.models.ssm import _ssd_scan
from repro_torch.models.ssm import ssd_chunked as ssd_ref  # noqa: F401

__all__ = ["ssd_chunked_plain", "ssd_ref"]


def ssd_chunked_plain(x, dt, A, Bm, C, D, chunk: int, init_state=None):
    """x (B,S,H,P); dt (B,S,H) f32; A, D (H,); Bm/C (B,S,G,N) ->
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    return _ssd_scan(x, dt, A, Bm, C, D, chunk, init_state, intra_bf16=False)
