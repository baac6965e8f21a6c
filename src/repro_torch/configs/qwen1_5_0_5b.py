"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]
The port's own copy of ``repro.configs.qwen1_5_0_5b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    d_head=64,
    qkv_bias=True,
    tie_embeddings=True,
)
