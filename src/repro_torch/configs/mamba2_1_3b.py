"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free, vocab=50280, ssm_state=128.

SSD (state-space duality) blocks.  d_inner = 2*d_model = 4096, 64 SSD heads of
dim 64, n_groups=1, depthwise conv width 4.  [arXiv:2405.21060]  The port's
own copy of ``repro.configs.mamba2_1_3b``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,      # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    d_head=64,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_head=64, n_groups=1, d_conv=4, expand=2,
                  chunk=64),
)
