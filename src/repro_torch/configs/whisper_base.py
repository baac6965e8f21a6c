"""whisper-base [audio] — 6L d_model=512 8H d_ff=2048 vocab=51865 — enc-dec, conv frontend stub.

[arXiv:2212.04356; unverified].  The conv1d mel frontend is a stub: the encoder
takes precomputed (B, 1500, d_model) frame embeddings.  Decoder is 6 layers with cross-attention.
The port's own copy of ``repro.configs.whisper_base``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    d_head=64,
    rope_theta=0.0,  # learned absolute positions (enc_pos / dec_pos), no RoPE
    norm="layernorm",
    act="gelu",
    enc_layers=6,
    enc_seq=1500,
)
