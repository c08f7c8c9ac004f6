"""hubert-xlarge [audio] — encoder-only transformer backbone (same arch as
wav2vec2).  Conv/mel frontend stubbed per the assignment carve-out:
input_specs supplies precomputed frame embeddings.  Masked-frame cluster
prediction over 504 k-means units.  No decode step (encoder-only) —
decode_32k/long_500k skipped, recorded in DESIGN.md.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.  [arXiv:2106.07447]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    n_heads=16,
    n_kv_heads=16,
    is_encoder=True,
    frontend_dim=512,  # conv feature-extractor output dim
    norm_type="layernorm",
    mlp_activation="gelu",
)
