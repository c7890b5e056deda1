"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 -- local/global alternating attention (window 4096) and logit
softcapping (50 attn / 30 final) [arXiv:2408.00118; hf].

The alternating pattern makes per-layer cost heterogeneous -- a natural
showcase for Scope's cluster merging (DESIGN.md SS5).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=14336,
    vocab=256000,
    block_pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    ffn_gated=True,
    rope_theta=10_000.0,
)
