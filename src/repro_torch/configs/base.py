"""Model / shape configuration dataclasses (the port's own copy of
``repro.configs.base``).

Every LM architecture is expressed as a :class:`ModelConfig`; reduced
("smoke") variants are derived with :meth:`ModelConfig.smoke` so CPU tests
stay cheap.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256  # vocab padded so embedding tables shard 16-way cleanly


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int          # per-expert hidden size
    capacity_factor: float = 1.0
    router_jitter: float = 0.0
    # shared dense FFN run for every token in addition to experts
    n_shared_experts: int = 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_head: int = 64           # SSD head dim (P)
    n_groups: int = 1          # B/C groups (G)
    d_conv: int = 4            # depthwise conv width
    chunk: int = 256           # SSD chunk length
    expand: int = 2            # d_inner = expand * d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None           # default d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    act: str = "swiglu"                    # swiglu | gelu
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    enc_layers: int = 0
    enc_seq: int = 0
    n_patches: int = 0
    hybrid: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab, VOCAB_PAD_MULTIPLE)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        if self.ssm is None:
            raise ValueError(f"{self.name} has no SSM block")
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.d_head

    def param_count(self) -> int:
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self, active_only=True)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128,
            vocab=512,
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_experts=4, top_k=2, d_ff_expert=32)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, d_head=16, chunk=32)
        if self.enc_layers:
            kw["enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.n_patches:
            kw["n_patches"] = 4
        if self.sliding_window is not None:
            kw["sliding_window"] = 32
        return replace(self, name=self.name + "-smoke", **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells that apply to an architecture: long_500k only for a
    sub-quadratic one."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return tuple(out)
