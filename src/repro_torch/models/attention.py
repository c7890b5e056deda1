"""GQA attention: prefill (full/sliding-window causal) and KV-cache decode.

PyTorch port of ``repro/models/attention.py``.  Prefill goes through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` -- the
hand-written CUDA kernel on the card, its plain version on the CPU -- as the
reference's module docstring intends for the TPU.  Decode has no kernel in
the reference and is plain tensor code here too.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from .config import ModelConfig
from .layers import apply_rope, dense, rope_freqs, softcap

NEG_INF = -2.0e38


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def attention_scores(q, k, scale, cap):
    """q [B,S,H,hd], k [B,T,KV,hd] -> scores [B,H,S,T] (fp32) with GQA broadcast."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, S, KV, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    scores = softcap(scores * scale, cap)
    return scores.reshape(B, KV * g, S, k.shape[1])


def _masked_attention(q, k, v, mask, cap, dtype):
    """Plain GQA attention; mask [B,S,T] (True = visible) -> [B,S,H*hd]."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    scores = attention_scores(q, k, hd ** -0.5, cap)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.reshape(B, KV, H // KV, S, T), v.float())
    return out.reshape(B, S, H * hd).to(dtype)


def runs_from_offsets(positions: torch.Tensor) -> bool:
    """Whether each row is ``p0_b + 0..S-1``: one comparison on the
    positions' device (on the card, one host sync)."""
    S = positions.shape[1]
    steps = torch.arange(S, device=positions.device, dtype=positions.dtype)
    return torch.equal(positions, positions[:, :1] + steps)


def attention_prefill(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor | None = None,
    window: int = 0,
    plain: bool = False,
    from_offsets: bool | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal attention.  Returns (out, (k, v)) for caching.

    ``positions=None`` means ``0..S-1`` per row.  The flash call counts
    query and key positions from 0, and its causal and window masks depend
    only on ``i - j``, so rows whose positions run ``p0_b + 0..S-1`` take it
    too, exactly, with RoPE applied on the given positions first.  Other
    explicit positions run the plain masked path on the CPU and raise
    elsewhere (ROADMAP A19).  ``from_offsets`` is :func:`runs_from_offsets`
    of ``positions`` where the caller has it already (the model tests once
    for all its layers); ``None`` tests here.  ``plain`` runs the flash
    call's plain version on any device (the checks that hold the kernels
    against it pass it).
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if positions is not None and from_offsets is None:
        from_offsets = runs_from_offsets(positions)
    flash = positions is None or from_offsets
    if not (flash or x.device.type == "cpu"):
        raise NotImplementedError(
            "explicit prefill positions that do not run p0 + 0..S-1 in each row on the "
            "card (the flash kernel takes no per-row positions): ROADMAP A19"
        )
    q = _split_heads(dense(x, params["wq"]), H, hd)
    k = _split_heads(dense(x, params["wk"]), KV, hd)
    v = _split_heads(dense(x, params["wv"]), KV, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    cos, sin = rope_freqs(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if flash:
        # [B,S,H,hd] -> [B,H,S,hd] as a strided view; the kernel takes strides
        # and returns q's layout, so the reshape back copies nothing.
        attend = attention_ref if plain else flash_attention
        out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     causal=True, window=window, softcap=cfg.attn_softcap)
        out = out.transpose(1, 2).reshape(B, S, H * hd)
    else:
        i = positions[:, :, None]
        j = positions[:, None, :]
        mask = j <= i
        if window > 0:
            mask &= j > i - window
        out = _masked_attention(q, k, v, mask, cfg.attn_softcap, x.dtype)
    return dense(out, params["wo"]), (k, v)


def attention_decode(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache_k: torch.Tensor,        # [B, T, KV, hd]
    cache_v: torch.Tensor,
    position: torch.Tensor,       # [B] current write index
    window: int = 0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a KV cache.

    Writes this token's k/v into ``cache_k``/``cache_v`` IN PLACE (the
    reference returns updated copies, which its jit donates) and returns them.
    """
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = cache_k.shape[1]
    q = _split_heads(dense(x, params["wq"]), H, hd)
    k = _split_heads(dense(x, params["wk"]), KV, hd)
    v = _split_heads(dense(x, params["wv"]), KV, hd)
    cos, sin = rope_freqs(position[:, None], hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, position] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, position] = v[:, 0].to(cache_v.dtype)

    j = torch.arange(T, device=x.device)[None, :]
    valid = j <= position[:, None]
    if window > 0:
        valid &= j > position[:, None] - window
    out = _masked_attention(q, cache_k, cache_v, valid[:, None, :], cfg.attn_softcap, x.dtype)
    return dense(out, params["wo"]), (cache_k, cache_v)
