"""Scope layer graphs for the assigned LM architectures.

A copy of the JAX package's ``core/workloads/lm.py``, which is JAX-free.

Exports a :class:`LayerGraph` per (ModelConfig x shape) so the paper's DSE
schedules the same models the JAX runtime executes.  Costs are per *sample*
(one sequence); the pipeline unit count m = global batch.

Parallelism metadata:
* ``wsp_parallel``  = tokens (sequence split; the CNN row-split analogue),
* ``isp_parallel``  = heads*d_head or d_ff (weight-output split),
* ``halo_bytes``    = WSP boundary exchange: KV block for attention,
  recurrent state for SSM/RWKV (tiny -- which is why WSP loves them).
"""
from __future__ import annotations

from ...models.config import ModelConfig
from ..graph import LayerGraph, LayerNode, chain

BYTES = 2  # bf16


def _attn_node(cfg: ModelConfig, name: str, S: int, window: int = 0) -> LayerNode:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2.0 * S * d * hd * (2 * H + 2 * KV)
    ctx = min(window, S) if window else S
    attn = 2.0 * 2.0 * S * ctx * H * hd / 2.0       # causal QK^T + PV
    kv_bytes = S * KV * hd * 2 * BYTES
    return LayerNode(
        name=name, kind="attention",
        flops=proj + attn,
        weight_bytes=d * hd * (H + 2 * KV) * BYTES + H * hd * d * BYTES,
        in_bytes=S * d * BYTES, out_bytes=S * d * BYTES,
        halo_bytes=min(kv_bytes, (min(window, S) if window else S) * KV * hd * 2 * BYTES),
        wsp_parallel=float(S), isp_parallel=float(H * hd),
    )


def _ffn_node(cfg: ModelConfig, name: str, S: int, moe: bool) -> LayerNode:
    d = cfg.d_model
    fmats = 3.0 if cfg.ffn_gated else 2.0
    if moe:
        m = cfg.moe
        ff = m.d_ff or cfg.d_ff
        flops = 2.0 * S * m.top_k * m.capacity_factor * fmats * d * ff \
            + 2.0 * S * d * m.n_experts
        w = fmats * d * ff * m.n_experts * BYTES
        return LayerNode(
            name=name, kind="moe_ffn", flops=flops, weight_bytes=w,
            in_bytes=S * d * BYTES, out_bytes=S * d * BYTES,
            wsp_parallel=float(S), isp_parallel=float(ff),
            n_experts=m.n_experts, active_experts=m.top_k,
        )
    ff = cfg.d_ff
    return LayerNode(
        name=name, kind="ffn", flops=2.0 * S * fmats * d * ff,
        weight_bytes=fmats * d * ff * BYTES,
        in_bytes=S * d * BYTES, out_bytes=S * d * BYTES,
        wsp_parallel=float(S), isp_parallel=float(ff),
    )


def _mamba_node(cfg: ModelConfig, name: str, S: int) -> LayerNode:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    N = cfg.mamba_d_state
    R = max(1, d // 16)
    proj = 2.0 * S * (2 * d * di + di * (R + 2 * N) + R * di + di * d)
    scan = 10.0 * S * di * N                 # discretize + recurrence + output
    w = (2 * d * di + di * (cfg.mamba_d_conv + R + 2 * N + 2) + R * di + di * d) * BYTES
    return LayerNode(
        name=name, kind="mamba", flops=proj + scan, weight_bytes=w,
        in_bytes=S * d * BYTES, out_bytes=S * d * BYTES,
        halo_bytes=float(di * N * 4 + cfg.mamba_d_conv * di * BYTES),  # state handoff
        wsp_parallel=float(S), isp_parallel=float(di),
    )


def _rwkv_node(cfg: ModelConfig, name: str, S: int) -> LayerNode:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    proj = 2.0 * S * 5 * d * d
    wkv = 4.0 * S * H * hd * hd              # state update + readout
    cm = 2.0 * S * (2 * d * cfg.d_ff + d * d)
    w = (5 * d * d + 2 * d * cfg.d_ff + d * d) * BYTES
    return LayerNode(
        name=name, kind="rwkv", flops=proj + wkv + cm, weight_bytes=w,
        in_bytes=S * d * BYTES, out_bytes=S * d * BYTES,
        halo_bytes=float(H * hd * hd * 4),    # WKV state handoff
        wsp_parallel=float(S), isp_parallel=float(d),
    )


def _embed_node(cfg: ModelConfig, name: str, S: int, out: bool) -> LayerNode:
    d, V = cfg.d_model, cfg.vocab
    return LayerNode(
        name=name, kind="embed",
        flops=2.0 * S * d * V if out else 2.0 * S * d,
        weight_bytes=float(V * d * BYTES),
        in_bytes=S * (d if out else 4) * BYTES,
        out_bytes=S * (V if out else d) * BYTES,
        wsp_parallel=float(S), isp_parallel=float(V),
    )


def lm_graph(cfg: ModelConfig, seq_len: int, decode: bool = False) -> LayerGraph:
    """decode=True models one serve_step token (S=1 compute, full-S KV halo)."""
    S = 1 if decode else seq_len
    layers = [_embed_node(cfg, "embed", S, out=False)]
    for i, kind in enumerate(cfg.block_kinds()):
        moe = cfg.is_moe_block(i) and kind != "rwkv"
        if kind in ("attn", "local"):
            win = cfg.window if kind == "local" else 0
            node = _attn_node(cfg, f"l{i}.attn", S, win)
            if decode:
                # one-token attention against the full cache
                import dataclasses

                ctx = min(win, seq_len) if win else seq_len
                node = dataclasses.replace(
                    node,
                    flops=2.0 * cfg.d_model * cfg.head_dim
                    * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                    + 4.0 * ctx * cfg.n_heads * cfg.head_dim,
                )
            layers.append(node)
            layers.append(_ffn_node(cfg, f"l{i}.ffn", S, moe))
        elif kind == "mamba":
            layers.append(_mamba_node(cfg, f"l{i}.mamba", S))
            layers.append(_ffn_node(cfg, f"l{i}.ffn", S, moe))
        elif kind == "rwkv":
            layers.append(_rwkv_node(cfg, f"l{i}.rwkv", S))
    layers.append(_embed_node(cfg, "lm_head", S, out=True))
    return chain(f"{cfg.name}@{'decode' if decode else 'prefill'}{seq_len}", layers)
