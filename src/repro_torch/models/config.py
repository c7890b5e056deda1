"""Model configuration: one dataclass describes every assigned architecture
(a verbatim copy of the JAX package's ``models/config.py``, which is JAX-free).

``block_pattern`` is a repeating unit of block kinds (scanned ``n_layers /
len(pattern)`` times), which covers all assigned families:

* dense decoder            -> ("attn",)
* gemma2 local/global      -> ("local", "attn")
* jamba 1:7 attn:mamba     -> ("attn", "mamba", ...7 mambas) with MoE every 2
* rwkv6                    -> ("rwkv",)

The same config also exports a Scope layer graph (``workloads/lm.py``) so the
paper's DSE can schedule the model.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    every: int = 1            # MoE FFN on every ``every``-th block (jamba: 2)
    capacity_factor: float = 1.25
    d_ff: int | None = None   # expert hidden dim if != dense d_ff
    dispatch_groups: int = 512  # local-dispatch groups (>= mesh shards so the
                                # group axis shards; capacity is per group)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                       # 0 -> d_model // n_heads
    block_pattern: tuple[str, ...] = ("attn",)
    moe: MoEConfig | None = None
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0            # gemma2: 30.0 final / 50.0 attn
    attn_softcap: float = 0.0
    window: int = 0                       # sliding window for "local" blocks
    norm_eps: float = 1e-6
    ffn_gated: bool = True                # SwiGLU (3 mats) vs classic MLP (2)
    tie_embeddings: bool = False
    frontend: str = "none"                # none | audio_stub | vision_stub
    frontend_tokens: int = 0              # stub positions (e.g. 256 patches)
    # mamba sub-config (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # rwkv sub-config
    rwkv_head_dim: int = 64
    # numerics / memory knobs (hillclimb levers, see EXPERIMENTS.md SSPerf)
    param_dtype: str = "bfloat16"
    remat: bool = True
    scan_unroll: int = 1       # lax.scan unroll; pattern_repeats => trip=1 so
                               # cost_analysis counts every layer (dry-run mode)
    optimizer: str = "adamw"              # adamw | adafactor (huge MoE)
    accum_steps: int = 1
    meta: dict = field(default_factory=dict, hash=False, compare=False)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the embedding shards over any mesh
        axis (production practice; labels stay < vocab)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def expanded_pattern(self) -> tuple[str, ...]:
        """Pattern expanded so MoE periodicity aligns with pattern positions
        (keeps stacked-scan param pytrees homogeneous across repeats)."""
        import math

        P = len(self.block_pattern)
        if self.moe is None:
            return self.block_pattern
        l = math.lcm(P, self.moe.every)
        return self.block_pattern * (l // P)

    @property
    def pattern_repeats(self) -> int:
        P = len(self.expanded_pattern)
        assert self.n_layers % P == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"expanded pattern of length {P}"
        )
        return self.n_layers // P

    def block_kinds(self) -> list[str]:
        return list(self.expanded_pattern) * self.pattern_repeats

    def is_moe_block(self, layer_idx: int) -> bool:
        return self.moe is not None and (layer_idx % self.moe.every == self.moe.every - 1)

    @property
    def n_params(self) -> float:
        """Total parameter count (embeddings included once)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        fmats = 3.0 if self.ffn_gated else 2.0
        total = float(v) * d * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(self.block_kinds()):
            if kind in ("attn", "local"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            elif kind == "mamba":
                di = self.mamba_expand * d
                total += 2 * d * di + di * (self.mamba_d_conv + 2 * self.mamba_d_state + 2) + di * d
            elif kind == "rwkv":
                total += 5 * d * d   # r/k/v/g token-mix + output proj
            # FFN / channel-mix
            if kind == "rwkv":
                total += 2.0 * d * ff + d * d   # k->ff, ff->d + receptance
            elif self.is_moe_block(i):
                eff_ff = self.moe.d_ff or ff
                total += fmats * d * eff_ff * self.moe.n_experts + d * self.moe.n_experts
            else:
                total += fmats * d * ff
        return total

    @property
    def n_active_params(self) -> float:
        """Active params per token (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.n_params
        dense = self.n_params
        eff_ff = self.moe.d_ff or self.d_ff
        fmats = 3.0 if self.ffn_gated else 2.0
        n_moe_blocks = sum(1 for i in range(self.n_layers) if self.is_moe_block(i))
        expert_params = fmats * self.d_model * eff_ff * n_moe_blocks
        dense -= expert_params * self.moe.n_experts
        dense += expert_params * self.moe.top_k
        return dense
