"""Architecture registry: the 10 assigned configs + input-shape set (a copy of
the JAX package's ``configs/registry.py``, so ``--arch`` takes the same names).

Every entry is importable as ``repro_torch.configs.<module>.CONFIG`` and selectable
as ``--arch <id>`` in the launchers.  ``get_smoke_config`` returns the
family-preserving reduced config used by CPU smoke tests.
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import ModelConfig, MoEConfig
from . import (  # noqa: F401  (imported for registration side effect below)
    musicgen_medium,
    starcoder2_15b,
    granite_3_8b,
    gemma2_9b,
    granite_20b,
    llama4_maverick_400b,
    granite_moe_1b,
    jamba_v01_52b,
    rwkv6_3b,
    paligemma_3b,
)

ARCHS: dict[str, ModelConfig] = {
    "musicgen-medium": musicgen_medium.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "gemma2-9b": gemma2_9b.CONFIG,
    "granite-20b": granite_20b.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "jamba-v0.1-52b": jamba_v01_52b.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
}

# (seq_len, global_batch, kind); kind decides which step the cell lowers.
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# Sub-quadratic state is required for long_500k (DESIGN.md SS5): only the
# SSM/hybrid archs qualify; gemma2's alternating stack still contains global
# full-attention layers, so it is skipped too.
LONG_CONTEXT_ARCHS = {"rwkv6-3b", "jamba-v0.1-52b"}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def get_shape(name: str) -> tuple[int, int, str]:
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honoring the long_500k skip rule."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            skipped = shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS
            if skipped and not include_skipped:
                continue
            out.append((arch, shape))
    return out


def get_smoke_config(name: str) -> ModelConfig:
    """Family-preserving reduction: tiny dims, same block pattern/features."""
    cfg = ARCHS[name]
    kw = dict(
        name=f"{cfg.name}-smoke",
        n_layers=2 * len(cfg.block_pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
        d_head=16,
        d_ff=128,
        vocab=128,
        window=8 if cfg.window else 0,
        frontend_tokens=4 if cfg.frontend != "none" else 0,
        rwkv_head_dim=16,
        mamba_d_state=4,
        accum_steps=1,
        param_dtype="float32",       # CPU smoke tests prefer exactness
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            every=cfg.moe.every,
            capacity_factor=2.0,
            d_ff=64 if cfg.moe.d_ff else None,
        )
    return replace(cfg, **kw)
