"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Shared transformer block applied every 6th layer (Zamba2-style weight
sharing; the per-invocation LoRA deltas of the released model are
omitted, as in the JAX package).  [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab_size=32000,
    n_heads=32,
    n_kv_heads=32,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_ngroups=1,
    attn_every=6,
    norm_type="rmsnorm",
)
