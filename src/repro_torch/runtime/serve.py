"""Serving runtime: batched prefill + KV-cache decode steps under a plan.

Port of ``repro/runtime/serve.py`` for one card: the same builders without
the mesh, plus a ``device`` (default ``"cuda"``; raises when CUDA is
missing).  A step is a plain function of the model and its inputs that runs
under ``torch.inference_mode()``.  One card has one zone, so a plan's
WSP->ISP ``transition_repeat`` changes nothing numerically (the reference
runs the same layers under two sharding constraints).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import DecoderLM, check_supported
from .sharding import ShardPlan


def _check_model(model: DecoderLM, cfg: ModelConfig, dev: torch.device) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, called with a {model.cfg.name} model")
    md = model.device
    if md.type != dev.type or (dev.index is not None and md.index != dev.index):
        raise ValueError(f"step built for {dev}, model is on {md}")


def build_prefill_step(cfg: ModelConfig, plan: ShardPlan, device: str | torch.device = "cuda"):
    """``prefill(model, tokens [B,S]) -> logits [B,S,padded_vocab]`` (fp32).

    On the card every attention layer's prefill goes through the flash
    attention kernel, every rwkv layer's through the WKV-6 kernel and every
    mamba layer's through the selective-scan kernel, one launch per layer.
    """
    check_supported(cfg)
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
        _check_model(model, cfg, dev)
        logits, _ = model(tokens.to(dev))
        return logits

    return prefill


def build_decode_step(cfg: ModelConfig, plan: ShardPlan, batch: int | None = None,
                      max_len: int | None = None, device: str | torch.device = "cuda"):
    """``serve_step(model, token [B,1], position [B], caches) -> (logits, caches)``:
    one new token against resident caches (KV cache, rwkv or mamba state).

    The caches are updated IN PLACE and returned (the reference donates them
    to its jitted step).  ``batch``, when given, is checked against every
    cache (each has its batch on dim 1); ``max_len`` against the caches with
    a sequence axis (attention's k/v; the rwkv ``S``/``shift`` and the mamba
    ``h``/``conv`` states have none).
    """
    check_supported(cfg)
    dev = resolve_device(device)

    @torch.inference_mode()
    def serve_step(model: DecoderLM, token, position, caches):
        _check_model(model, cfg, dev)
        for slot in caches:
            for name, t in slot.items():
                B = t.shape[1]
                T = t.shape[2] if name in ("k", "v") else max_len
                if (batch is not None and B != batch) or (max_len is not None and T != max_len):
                    raise ValueError(f"cache {name!r} is batch {B} x {T} positions; step "
                                     f"built for batch {batch} x {max_len}")
        return model.decode_step(token.to(dev), position.to(dev), caches)

    return serve_step


def build_multimodel_steps(
    cfgs,
    plans: dict[str, ShardPlan],
    batch: int | None = None,
    max_len: int | None = None,
    with_decode: bool = True,
    device: str | torch.device = "cuda",
):
    """Per-model serving steps from a multimodel co-schedule.

    On one card every model runs on the whole device, time-multiplexed by
    whoever dispatches the steps.  Returns ``{cfg.name: {"prefill": fn,
    "decode": fn, "plan": plan}}`` (``"decode"`` only with ``with_decode``).
    """
    fleet = {}
    for cfg in cfgs:
        plan = plans[cfg.name]
        entry = {"prefill": build_prefill_step(cfg, plan, device), "plan": plan}
        if with_decode:
            entry["decode"] = build_decode_step(cfg, plan, batch=batch, max_len=max_len,
                                                device=device)
        fleet[cfg.name] = entry
    return fleet


@torch.inference_mode()
def greedy_generate(cfg, model, decode_fn, caches, prompt_last_token, start_pos, steps):
    """Batched greedy loop driving a decode step; returns (tokens [B,steps], caches)."""
    B = prompt_last_token.shape[0]
    tok = prompt_last_token.to(model.device)
    pos = torch.full((B,), start_pos, dtype=torch.int64, device=model.device)
    out = []
    for _ in range(steps):
        logits, caches = decode_fn(model, tok, pos, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1), caches
