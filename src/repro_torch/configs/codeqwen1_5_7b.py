"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416.

qwen1.5 architecture (QKV bias).  [hf:Qwen/CodeQwen1.5-7B; hf]
The port's own copy of ``repro.configs.codeqwen1_5_7b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    d_head=128,
    qkv_bias=True,
)
