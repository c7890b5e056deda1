"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
expert d_ff=8192, vocab=202048, MoE 128 experts top-1, dense/MoE
interleaved (every 2nd layer routed) [hf:meta-llama/Llama-4; unverified].

~396B total / ~14B active parameters with this layout (the published
"17B active" includes a shared expert per MoE layer, which we fold into
the alternating dense FFN -- documented approximation).

Production note: AdamW state for 400B params does not fit 256 chips;
this config selects the factored optimizer (adafactor) -- see
EXPERIMENTS.md SSPerf.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, every=2, capacity_factor=1.25),
    ffn_gated=True,
    rope_theta=500_000.0,
    optimizer="adafactor",
    accum_steps=4,
)
