"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite/granite-3.0-8b-base]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    ffn_gated=True,
    rope_theta=10_000.0,
)
