"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attention 7:1 interleave, MoE 16 experts top-2 on every
2nd layer [arXiv:2403.19887; hf].

Block pattern: 8 layers with attention at position 4 (jamba's published
layout), scanned 4 times.  Sub-quadratic state => runs the long_500k cell.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    block_pattern=(
        "mamba", "mamba", "mamba", "mamba",
        "attn", "mamba", "mamba", "mamba",
    ),
    moe=MoEConfig(n_experts=16, top_k=2, every=2, capacity_factor=1.25),
    ffn_gated=True,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=10_000.0,
)
