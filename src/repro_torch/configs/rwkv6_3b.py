"""rwkv6-3b "Finch" [ssm]: 32L d_model=2560 (attention-free) channel-mix
d_ff=8960 vocab=65536, data-dependent decay [arXiv:2404.05892; hf].

Attention-free => ISP applies to channel dims only; WSP over sequence uses
chunked WKV state handoff (DESIGN.md SS5).  Runs the long_500k cell.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
)
