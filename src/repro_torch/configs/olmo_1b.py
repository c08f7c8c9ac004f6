"""olmo-1b [dense] — non-parametric LayerNorm (no learned scale/bias).

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.  [arXiv:2402.00838]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=50304,
    n_heads=16,
    n_kv_heads=16,
    norm_type="nonparametric_ln",
    tie_embeddings=True,
)
