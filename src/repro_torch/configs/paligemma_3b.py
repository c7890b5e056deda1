"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216, SigLIP vision frontend + gemma decoder [arXiv:2407.07726; hf].

The SigLIP tower is a stub per the assignment: ``input_specs`` provides 256
precomputed patch embeddings, concatenated ahead of the text tokens.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    tie_embeddings=True,
    ffn_gated=True,
    frontend="vision_stub",
    frontend_tokens=256,
    rope_theta=10_000.0,
)
