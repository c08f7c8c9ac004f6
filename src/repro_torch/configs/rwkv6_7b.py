"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent per-channel decay.

32L d_model=4096 d_ff=14336 vocab=65536; head_dim 64 (64 heads).
O(1) decode state.  [arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm_rwkv6",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    ssm_head_dim=64,
    rwkv_lora_rank=64,
    norm_type="layernorm",
)
