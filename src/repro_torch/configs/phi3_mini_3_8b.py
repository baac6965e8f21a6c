"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

RoPE + SwiGLU + (degenerate kv=heads) GQA.  [arXiv:2404.14219; unverified]
The port's own copy of ``repro.configs.phi3_mini_3_8b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    d_head=96,
)
