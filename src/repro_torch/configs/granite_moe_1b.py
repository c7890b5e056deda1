"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512, vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, every=1, capacity_factor=1.25),
    ffn_gated=True,
    rope_theta=10_000.0,
)
