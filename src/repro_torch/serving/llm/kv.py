"""KV-cache sizing: the memory axis of the phase DSE.

A copy of the JAX package's ``serving/llm/kv.py``, which is JAX-free.

Autoregressive decode keeps per-sequence state resident for the lifetime of
the sequence -- KV blocks for attention layers (windowed layers cap at the
window), fixed-size recurrent state for mamba/rwkv blocks.  The formulas
here mirror the halo terms of :mod:`repro_torch.core.workloads.lm` exactly: the
bytes a decode step *streams* per boundary are the bytes a resident
sequence *holds* per layer.

The DSE consumes this through :func:`repro_torch.multimodel.curves.kv_bound_curve`
-- a decode quota's throughput flattens at ``K / service(K)`` once the
quota's KV budget (``HardwareModel.kv_bytes_per_chip`` x chips) holds fewer
than ``m`` concurrent sequences.
"""
from __future__ import annotations

from ...core.hw import HardwareModel
from ...core.workloads.lm import BYTES
from ...models.config import ModelConfig

# Sentinel for "no resident state" (a config with zero stateful layers
# never bounds concurrency).
UNBOUNDED = 10**9


def kv_seq_bytes(cfg: ModelConfig, seq_len: int) -> float:
    """Resident decode state of ONE sequence at context ``seq_len``.

    Per layer: attention holds K and V (``2 * n_kv_heads * head_dim``)
    per cached token -- windowed ("local") layers cap the cache at the
    window; mamba holds its SSM state + conv buffer; rwkv holds the WKV
    state matrix.  Matches the ``halo_bytes`` of the corresponding
    :mod:`~repro_torch.core.workloads.lm` nodes.
    """
    total = 0.0
    for kind in cfg.block_kinds():
        if kind in ("attn", "local"):
            win = cfg.window if kind == "local" else 0
            ctx = min(win, seq_len) if win else seq_len
            total += 2.0 * cfg.n_kv_heads * cfg.head_dim * BYTES * ctx
        elif kind == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            total += di * cfg.mamba_d_state * 4 + cfg.mamba_d_conv * di * BYTES
        elif kind == "rwkv":
            hd = cfg.rwkv_head_dim
            total += (cfg.d_model // hd) * hd * hd * 4
    return total


def kv_capacity_bytes(hw: HardwareModel, chips: int) -> float:
    """KV budget of a ``chips``-chip quota on this package."""
    return hw.kv_bytes_per_chip * chips


def max_concurrent_seqs(hw: HardwareModel, chips: int, cfg: ModelConfig,
                        seq_len: int) -> int:
    """How many sequences at context ``seq_len`` a quota can hold resident."""
    per_seq = kv_seq_bytes(cfg, seq_len)
    if per_seq <= 0:
        return UNBOUNDED
    return int(kv_capacity_bytes(hw, chips) // per_seq)
