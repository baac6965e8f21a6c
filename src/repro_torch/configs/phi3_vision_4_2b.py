"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP patch embeddings (stub frontend).

[hf:microsoft/Phi-3-vision-128k-instruct; hf].  The model takes 576
precomputed (B, 576, d_model) patch embeddings in place of the first 576
token positions.
The port's own copy of ``repro.configs.phi3_vision_4_2b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    d_head=96,
    n_patches=576,
)
