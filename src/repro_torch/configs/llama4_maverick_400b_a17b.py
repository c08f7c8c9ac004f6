"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
MoE interleaved every other layer (Maverick-style; with d_ff=8192 per
expert this lands at ≈430B total / ≈17B active — matching the model card,
where MoE-every-layer would be ≈1.6T).  Early-fusion multimodal embeddings
stubbed like the VLM carve-out; chunked/sliding attention for the
long-context shape.  [hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    n_heads=40,
    n_kv_heads=8,
    n_experts=128,
    top_k=1,
    moe_every=2,
    n_shared_experts=1,
    norm_type="rmsnorm",
)
