"""command-r-plus-104b [dense] — GQA, no biases.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
[hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    d_ff=33792,
    vocab_size=256000,
    n_heads=96,
    n_kv_heads=8,
    norm_type="layernorm",
)
