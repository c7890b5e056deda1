#!/usr/bin/env python3
"""Predicted H100 prefill and decode times of the configs that phases 16-17
of ``chip_smoke.py`` run, from their shapes and granite-3-8b's readings.

    PYTHONPATH=src python3 scripts/prefill_prediction.py

Runs on the CPU and touches no device.  It scales what ``chip_smoke.py``
read for granite-3-8b's B=4 x S=2048 bf16 prefill (NVIDIA H100 80GB HBM3,
700 W, the ``GRANITE_*`` constants below) to each config:

* dense products: 2 x tokens x the weights in products (attention, the FFN
  or the top-k experts, the LM head), at granite's measured rate;
* flash: each layer's bound (4 x B*H*hd*pairs / 989 TFLOP/s) times the
  ratio of time to bound granite's layout (hd 128) or granite-moe's (hd 64)
  measured, and the ratio gemma2-9b's hd 256 cases showed;
* other (elementwise, indexing, copies): granite's per layer, scaled by
  (d_model + d_ff) of the layer; an MoE layer by granite-moe-1b-a400m's
  per-layer share, scaled by d_model and top-k;
* decode busy: the weights one batch-4 step reads (every expert's, as the
  batched expert product reads them all) at granite's effective rate;
  decode wall: operations dispatched at granite's host time per operation.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config

BF16_PEAK = 989e12
B, S = 4, 2048
# granite-3-8b and granite-moe-1b-a400m readings of chip_smoke.py (PERF.md sections 5-6)
GRANITE_DENSE_MS = 169.771      # dense products in one granite-3-8b prefill
GRANITE_OTHER_MS = 99.424       # elementwise / indexing / copies, 40 layers
GRANITE_MOE_OTHER_MS = 68.886   # granite-moe-1b-a400m, 24 layers (d 1024, top-8 of 32)
FLASH_RATIO = {64: 0.108 / 0.0348, 128: 0.282 / 0.139, 256: 2.75}  # time / bound
GRANITE_DECODE_BUSY_MS = 11.727 # one batch-4 decode step's device busy time
HOST_US_PER_OP = 52.352e3 / 4055  # its wall time over the operations it dispatched
OPS_PER_LAYER = 101


def product_weights(cfg) -> float:
    """Weights one token multiplies (the LM head included, the embedding not)."""
    d, hd = cfg.d_model, cfg.head_dim
    mats = 3 if cfg.ffn_gated else 2
    total = float(cfg.padded_vocab) * d
    for i, kind in enumerate(cfg.block_kinds()):
        total += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
        if cfg.is_moe_block(i):
            total += mats * d * (cfg.moe.d_ff or cfg.d_ff) * cfg.moe.top_k + d * cfg.moe.n_experts
        else:
            total += mats * d * cfg.d_ff
    return total


def step_weights(cfg) -> float:
    """Weight bytes (bf16) a decode step reads: every expert of an MoE layer."""
    return 2 * (cfg.n_params - (cfg.vocab * cfg.d_model if not cfg.tie_embeddings else 0))


def flash_bound_ms(cfg) -> float:
    pairs = S * (S + 1) // 2
    return 1e3 * 4 * B * cfg.n_heads * cfg.head_dim * pairs / BF16_PEAK


def predict(cfg) -> dict:
    granite = get_config("granite-3-8b")
    rate = 2 * B * S * product_weights(granite) / (GRANITE_DENSE_MS / 1e3)
    dense = 1e3 * 2 * B * S * product_weights(cfg) / rate
    layers = cfg.n_layers
    bound = flash_bound_ms(cfg)
    flash = layers * bound * FLASH_RATIO[cfg.head_dim]
    per_dense = GRANITE_OTHER_MS / granite.n_layers / (granite.d_model + granite.d_ff)
    moe_layers = sum(cfg.is_moe_block(i) for i in range(layers))
    other = (layers - moe_layers) * per_dense * (cfg.d_model + cfg.d_ff)
    if moe_layers:
        per_moe = GRANITE_MOE_OTHER_MS / 24 / (1024 * 8)
        other += moe_layers * per_moe * cfg.d_model * cfg.moe.top_k
    busy = GRANITE_DECODE_BUSY_MS * step_weights(cfg) / step_weights(granite)
    wall = max(busy, layers * OPS_PER_LAYER * HOST_US_PER_OP / 1e3)
    return {"dense_ms": dense, "flash_ms": flash, "flash_bound_ms_per_layer": bound,
            "other_ms": other, "busy_ms": dense + flash + other,
            "decode_busy_ms": busy, "decode_wall_ms": wall}


def main() -> None:
    for arch, layers in (("starcoder2-15b", None), ("granite-20b", None),
                         ("llama4-maverick-400b-a17b", 2), ("paligemma-3b", None),
                         ("musicgen-medium", None), ("granite-3-8b", None)):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        p = predict(cfg)
        print(f"{arch} ({cfg.n_layers} layers): " + ", ".join(
            f"{k} {v:.3f}" for k, v in p.items()))


if __name__ == "__main__":
    main()
