"""internvl2-26b [vlm] — InternViT-6B vision encoder (stubbed per the
assignment carve-out: input_specs supplies precomputed patch embeddings)
feeding an InternLM2-20B-family GQA decoder.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    d_ff=16384,
    vocab_size=92553,
    n_heads=48,
    n_kv_heads=8,
    n_vision_tokens=256,
    frontend_dim=3200,  # InternViT-6B hidden size
    norm_type="rmsnorm",
)
