"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA.

llama+mistral mix with sliding-window attention.  [arXiv:2401.16818; unverified]
The port's own copy of ``repro.configs.h2o_danube3_4b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    d_head=120,
    sliding_window=4096,
)
