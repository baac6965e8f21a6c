"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) vocab=49155, MoE 40e top-8.

[hf:ibm-granite/granite-3.0-3b-a800m-base; hf].  40 experts top-8, as in the
3b-a800m config (d_model=1536, 24 heads, expert d_ff=512).
The port's own copy of ``repro.configs.granite_moe_3b_a800m``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    d_head=64,
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
)
