"""musicgen-medium [audio]: decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 == MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec frontend is a stub: ``input_specs``
provides precomputed frame embeddings (already codebook-summed to d_model);
the backbone predicts the next frame's codebook-0 token ids.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    ffn_gated=False,            # classic transformer MLP (GELU)
    frontend="audio_stub",
    rope_theta=10_000.0,
)
