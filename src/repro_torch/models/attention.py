"""GQA attention: prefill (full/sliding-window causal) and KV-cache decode.

PyTorch port of ``repro/models/attention.py``.  Prefill goes through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` -- the
hand-written CUDA kernel on the card, its plain version on the CPU -- as the
reference's module docstring intends for the TPU.  Decode has no kernel in
the reference and is plain tensor code here too.

``attention_prefill_isp`` / ``attention_prefill_wsp`` /
``attention_decode_mesh`` / ``attention_decode_heads`` are a rank's
attention on a model axis (``runtime/sharding.py``): its own heads on the
whole sequence, ending in an all-reduce (ISP); every head on its own
positions, the weights and the other ranks' keys and values all-gathered,
the queries at their positions through the flash call's ``q_offset``
(WSP); decode over a cache sharded on time, each rank scoring its own
positions and the ranks combining their softmax sums by all-reduce; and
decode over a cache whole over time (``shard_kv_cache_time=False``), each
rank its own heads, ending in an all-reduce.

The prefill functions on a model axis differentiate
(``runtime/collectives.py``): under ISP the replicated input's gradient is
summed over the ranks and the output's all-reduce passes its gradient
through; under WSP each gathered weight's and the gathered keys' and
values' gradients are reduce-scattered back to the rank's block.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from ..runtime.collectives import copy_to, gather, sum_over
from .config import ModelConfig
from .layers import apply_rope, dense, dense_fp32, rope_freqs, softcap

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
    positions' device (on the card, one host sync).  Meta positions hold no
    values to compare, so they raise (the dry-run passes no positions)."""
    if positions.device.type == "meta":
        raise NotImplementedError(
            "explicit prefill positions on the meta device: whether each row runs "
            "p0 + 0..S-1 depends on their values, which meta tensors do not hold")
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


def _decode_heads(params: dict, x: torch.Tensor, cfg: ModelConfig, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, position: torch.Tensor, window: int) -> torch.Tensor:
    """The one-token attention of the heads ``params``' wq / wk / wv columns
    hold (all of them on one rank) against ``cache_k`` / ``cache_v`` [B, T,
    kv heads, hd], which take the token's key and value at ``position`` in
    place: [B, 1, heads * hd], before ``wo``."""
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per row, got {S1}")
    hd = cfg.head_dim
    H, KV = params["wq"].shape[1] // hd, params["wk"].shape[1] // hd
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
    return _masked_attention(q, cache_k, cache_v, valid[:, None, :], cfg.attn_softcap, x.dtype)


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
    out = _decode_heads(params, x, cfg, cache_k, cache_v, position, window)
    return dense(out, params["wo"]), (cache_k, cache_v)


def attention_decode_heads(params: dict, x: torch.Tensor, cfg: ModelConfig,
                           cache_k: torch.Tensor, cache_v: torch.Tensor, position: torch.Tensor,
                           shard, window: int = 0, tag: str = "") -> torch.Tensor:
    """One-token decode on a model axis, the cache whole over time
    (``shard_kv_cache_time=False``): ``cache_k`` / ``cache_v`` [B, T, kvl,
    hd] hold this rank's kv heads, those its query heads read, at every
    position; the query, key and value are the rank's own and nothing is
    gathered; the output projection's partial sums are added over the model
    axis.  The reference's cache in this layout is replicated over
    ``model`` (every kv head on every rank); a rank here keeps only the
    heads it reads."""
    out = _decode_heads(params, x, cfg, cache_k, cache_v, position, window)
    return shard.comm.all_reduce(dense_fp32(out, params["wo"]), tag=f"{tag}:attn").to(x.dtype)


def attention_prefill_isp(params: dict, x: torch.Tensor, cfg: ModelConfig, shard,
                          window: int = 0, plain: bool = False, tag: str = "") -> torch.Tensor:
    """This rank's query heads and the kv heads they read (``params``: its
    column blocks of wq / wk / wv and row block of wo) over the whole
    sequence ``x`` [B, S, d]; the output projection's partial sums are
    added over the model axis."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    comm = shard.comm
    x_in = x
    x = copy_to(comm, x, tag=f"{tag}:attn_in")
    q = _split_heads(dense(x, params["wq"]), shard.n_heads, hd)
    k = _split_heads(dense(x, params["wk"]), shard.n_kv_heads, hd)
    v = _split_heads(dense(x, params["wv"]), shard.n_kv_heads, hd)
    cos, sin = rope_freqs(torch.arange(S, device=x.device).expand(B, S), hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attend = attention_ref if plain else flash_attention
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=True, window=window, softcap=cfg.attn_softcap)
    out = out.transpose(1, 2).reshape(B, S, shard.n_heads * hd)
    return sum_over(comm, dense_fp32(out, params["wo"]), tag=f"{tag}:attn").to(x_in.dtype)


def _gather_kv_cols(w: torch.Tensor, shard, tag: str) -> torch.Tensor:
    """The whole [d, KV*hd] wk / wv from the ranks' kv-head columns, each kv
    head once (ranks that share one hold the same columns: the gradient
    reaches the first of them, and the train step sums it over them)."""
    g = gather(shard.comm, w[None], dim=0, tag=tag)             # [m, d, kvl * hd]
    owners = shard.kv_owners()
    if len(owners) != shard.m:
        g = g[owners]
    return g.permute(1, 0, 2).reshape(w.shape[0], -1)


def attention_prefill_wsp(params: dict, x: torch.Tensor, cfg: ModelConfig, shard,
                          window: int = 0, plain: bool = False, tag: str = "") -> torch.Tensor:
    """Every head over this rank's positions ``x`` [B, Sl, d] (positions
    ``r*Sl ..``): the weights all-gathered at use, the keys and values of
    every position up to this rank's last gathered from the ranks (the
    halo), the queries attending at their positions (``q_offset``)."""
    B, Sl, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    comm = shard.comm
    wq = gather(comm, params["wq"], dim=1, tag=f"{tag}:wq")
    wk = _gather_kv_cols(params["wk"], shard, f"{tag}:wk")
    wv = _gather_kv_cols(params["wv"], shard, f"{tag}:wv")
    q = _split_heads(dense(x, wq), H, hd)
    k = _split_heads(dense(x, wk), KV, hd)
    v = _split_heads(dense(x, wv), KV, hd)
    p0 = shard.r * Sl
    pos = torch.arange(p0, p0 + Sl, device=x.device).expand(B, Sl)
    cos, sin = rope_freqs(pos, hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    kv = gather(comm, torch.stack([k, v]), dim=2, tag=f"{tag}:kv")   # [2, B, m*Sl, KV, hd]
    keys, values = kv[0, :, :p0 + Sl], kv[1, :, :p0 + Sl]
    attend = attention_ref if plain else flash_attention
    out = attend(q.transpose(1, 2), keys.transpose(1, 2), values.transpose(1, 2),
                 causal=True, window=window, softcap=cfg.attn_softcap, q_offset=p0)
    out = out.transpose(1, 2).reshape(B, Sl, H * hd)
    return dense(out, gather(comm, params["wo"], dim=0, tag=f"{tag}:wo"))


def attention_decode_mesh(params: dict, x: torch.Tensor, cfg: ModelConfig,
                          cache_k: torch.Tensor, cache_v: torch.Tensor, position: torch.Tensor,
                          shard, window: int = 0, tag: str = "") -> torch.Tensor:
    """One-token decode on a model axis, the cache sharded over time.

    ``cache_k`` / ``cache_v`` [B, Tl, KV, hd] hold positions ``r*Tl ..`` of
    every kv head.  The ranks all-gather every head's query and the new key
    and value; the rank that holds ``position`` writes them (in place); each
    rank scores its positions, and the ranks combine the softmax by
    all-reduce: the max, then the sums and the weighted values.  The
    output projection runs on this rank's heads, its partial sums added
    over the model axis."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hl, kvl, m = shard.n_heads, shard.n_kv_heads, shard.m
    comm = shard.comm
    q = _split_heads(dense(x, params["wq"]), hl, hd)
    k = _split_heads(dense(x, params["wk"]), kvl, hd)
    v = _split_heads(dense(x, params["wv"]), kvl, hd)
    cos, sin = rope_freqs(position[:, None], hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    qkv = torch.cat([q.reshape(B, -1), k.reshape(B, -1), v.reshape(B, -1)], dim=-1)
    g = comm.all_gather(qkv[None], dim=0, tag=f"{tag}:qkv")     # [m, B, (hl + 2 kvl) hd]
    qa = g[:, :, :hl * hd].reshape(m, B, hl, hd).transpose(0, 1).reshape(B, H, hd)
    owners = shard.kv_owners()

    def new_kv(lo):
        t = g[owners, :, lo:lo + kvl * hd].reshape(len(owners), B, kvl, hd)
        return t.transpose(0, 1).reshape(B, KV, hd)

    ka, va = new_kv(hl * hd), new_kv((hl + kvl) * hd)
    Tl = cache_k.shape[1]
    t0 = shard.r * Tl
    local = position - t0
    own = ((local >= 0) & (local < Tl))[:, None, None]
    bidx = torch.arange(B, device=x.device)
    li = local.clamp(0, Tl - 1)
    cache_k[bidx, li] = torch.where(own, ka.to(cache_k.dtype), cache_k[bidx, li])
    cache_v[bidx, li] = torch.where(own, va.to(cache_v.dtype), cache_v[bidx, li])

    j = t0 + torch.arange(Tl, device=x.device)[None, :]
    valid = j <= position[:, None]
    if window > 0:
        valid &= j > position[:, None] - window
    scores = attention_scores(qa[:, None], cache_k, hd ** -0.5, cfg.attn_softcap)  # [B,H,1,Tl]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    top = comm.all_reduce(scores.amax(dim=-1), op="max", tag=f"{tag}:max")        # [B,H,1]
    p = torch.exp(scores - top[..., None])
    o = torch.einsum("bkgst,btkh->bskgh", p.reshape(B, KV, H // KV, 1, Tl), cache_v.float())
    sums = torch.cat([p.sum(dim=-1).reshape(B, H, 1), o.reshape(B, H, hd)], dim=-1)
    sums = comm.all_reduce(sums, tag=f"{tag}:sum")
    out = (sums[..., 1:] / sums[..., :1])[:, shard.heads[0]:shard.heads[1]]
    out = out.reshape(B, 1, hl * hd).to(x.dtype)
    return comm.all_reduce(dense_fp32(out, params["wo"]), tag=f"{tag}:attn").to(x.dtype)
