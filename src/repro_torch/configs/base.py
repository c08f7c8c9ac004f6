"""Model configuration dataclass (a copy of ``repro.configs.base``'s
``ModelConfig``) and the registry of the ten configurations, the JAX
package's ``ARCH_IDS`` in its order."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm_mamba2", "ssm_rwkv6", "hybrid", "encoder", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture; field names and defaults match the JAX
    package's ``ModelConfig`` so a config can be rebuilt field for field."""

    name: str
    family: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None

    # norm / mlp
    norm_type: str = "rmsnorm"  # 'rmsnorm' | 'layernorm' | 'nonparametric_ln'
    norm_eps: float = 1e-5
    mlp_activation: str = "silu"  # 'silu' (gated) | 'gelu' (ungated)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / RWKV6)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    rwkv_lora_rank: int = 64

    # hybrid
    attn_every: int = 0

    # encoder / vlm frontends
    is_encoder: bool = False
    n_vision_tokens: int = 0
    frontend_dim: int = 0

    # numerics
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    remat: bool = True

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family in ("ssm_rwkv6",)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def param_count(self) -> int:
        """Analytic parameter count (``models.counting``)."""
        from repro_torch.models.counting import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_params
        return count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, vocab<=512 — the same
        reduction rule as the JAX package's ``ModelConfig.reduced``."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else 0
        if n_kv and self.n_kv_heads < self.n_heads:
            n_kv = max(1, n_heads // max(1, self.n_heads // self.n_kv_heads))
        changes = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d_model,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=(d_model // n_heads) if n_heads else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_head_dim else 0,
            rwkv_lora_rank=min(self.rwkv_lora_rank, 16),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_vision_tokens=min(self.n_vision_tokens, 16),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            remat=False,
        )
        return replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape (a copy of the JAX package's ``ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "zamba2-2.7b",
    "internvl2-26b",
    "hubert-xlarge",
    "internlm2-1.8b",
    "olmo-1b",
    "rwkv6-7b",
    "mixtral-8x22b",
    "llama4-maverick-400b-a17b",
    "command-r-plus-104b",
    "qwen2.5-3b",
)

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.CONFIG


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The skip matrix (DESIGN.md §Arch-applicability): an encoder has no
    decode step."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only architecture has no decode step"
    return True, ""
