"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.

[arXiv:2411.13676; hf].  Parallel attention + mamba heads per block; most layers
use sliding-window attention (window 2048 here), which together with the SSM
path makes the arch sub-quadratic for the long_500k cell.
The port's own copy of ``repro.configs.hymba_1_5b``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    d_head=64,
    hybrid=True,
    sliding_window=2048,
    ssm=SSMConfig(d_state=16, d_head=64, n_groups=1, expand=2, chunk=64),
)
