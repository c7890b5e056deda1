"""Serving runtime: batched prefill + KV-cache decode steps under a plan.

Port of ``repro/runtime/serve.py``: the same builders, plus a ``device``
(default ``"cuda"``; raises when CUDA is missing).  A step is a plain
function of the model and its inputs that runs under
``torch.inference_mode()``.

``mesh`` (default: one rank, as on one card) is the
:class:`~repro_torch.launch.mesh.Mesh` of the rank that calls the step; the
step then takes that rank's model, ``runtime.sharding.shard_model(model,
plan, mesh)``, runs the plan's zones rank-locally (ISP / WSP, the
transition at ``transition_repeat``) and returns the rank's logits,
``[B / dp, S, padded_vocab / model]`` as the reference's ``P(dp, None,
"model")`` (``sharding.gather_logits`` assembles them).  On one rank the
plan's zones change nothing numerically (the reference runs the same
layers under two sharding constraints).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import DecoderLM, check_supported
from .sharding import ShardPlan, gather_logits


def _check_model(model: DecoderLM, cfg: ModelConfig, dev: torch.device, mesh=None,
                 plan: ShardPlan | None = None) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, called with a {model.cfg.name} model")
    md = model.device
    if md.type != dev.type or (dev.index is not None and md.index != dev.index):
        raise ValueError(f"step built for {dev}, model is on {md}")
    if mesh is None or mesh.size == 1:
        if model.shard is not None:
            raise ValueError("step built for one rank, called with a rank's shard of a mesh")
    elif model.shard is None or model.shard.mesh is not mesh or model.shard.plan != plan:
        raise ValueError(f"step built for a {mesh.shape} mesh under {plan}: call it with "
                         "runtime.sharding.shard_model(model, plan, mesh)")


def _device(device, mesh) -> torch.device:
    return resolve_device(device if mesh is None or mesh.size == 1 else mesh.device)


def build_prefill_step(cfg: ModelConfig, plan: ShardPlan, device: str | torch.device = "cuda",
                       mesh=None):
    """The prefill step, ``-> logits [B,S,padded_vocab]`` (fp32); as in the
    reference its signature depends on the frontend:

    * ``none``: ``prefill(model, tokens [B,S])``;
    * ``audio_stub``: ``prefill(model, frontend_embeds [B,S,d])``;
    * ``vision_stub``: ``prefill(model, tokens [B,S-P], frontend_embeds [B,P,d])``.

    On the card every attention layer's prefill goes through the flash
    attention kernel, every rwkv layer's through the WKV-6 kernel and every
    mamba layer's through the selective-scan kernel, one launch per layer.
    With a ``mesh`` of several ranks (the step runs on its ``device``) the
    model is the rank's shard and the logits are the rank's.
    """
    check_supported(cfg)
    dev = _device(device, mesh)

    @torch.inference_mode()
    def core(model: DecoderLM, tokens, frontend_embeds) -> torch.Tensor:
        _check_model(model, cfg, dev, mesh, plan)
        logits, _ = model(None if tokens is None else tokens.to(dev),
                          None if frontend_embeds is None else frontend_embeds.to(dev))
        return logits

    if cfg.frontend == "audio_stub":
        return lambda model, frontend_embeds: core(model, None, frontend_embeds)
    if cfg.frontend == "vision_stub":
        return core
    return lambda model, tokens: core(model, tokens, None)


def build_decode_step(cfg: ModelConfig, plan: ShardPlan, batch: int | None = None,
                      max_len: int | None = None, device: str | torch.device = "cuda",
                      mesh=None):
    """``serve_step(model, token [B,1], position [B], caches) -> (logits, caches)``:
    one new token against resident caches (KV cache, rwkv or mamba state).

    The caches are updated IN PLACE and returned (the reference donates them
    to its jitted step).  ``batch``, when given, is checked against every
    cache (each has its batch on dim 1); ``max_len`` against the caches with
    a sequence axis (attention's k/v; the rwkv ``S``/``shift`` and the mamba
    ``h``/``conv`` states have none).

    With a ``mesh`` of several ranks the model is the rank's shard and the
    caches its pieces (``model.init_kv_cache`` / ``sharding.shard_caches``):
    ``batch`` over the data ranks, and on a model axis the k/v time axis
    ``max_len`` over the model ranks, rounded up (whole with the plan's
    ``shard_kv_cache_time=False``).  Decode runs in the ISP zone, as in the
    reference.
    """
    check_supported(cfg)
    dev = _device(device, mesh)

    @torch.inference_mode()
    def serve_step(model: DecoderLM, token, position, caches):
        _check_model(model, cfg, dev, mesh, plan)
        sh = model.shard
        rows = batch if batch is None or sh is None else batch // sh.dp
        span = max_len if max_len is None or sh is None or sh.m == 1 else sh.cache_len(max_len)
        for slot in caches:
            for name, t in slot.items():
                B = t.shape[1]
                T = t.shape[2] if name in ("k", "v") else span
                if (rows is not None and B != rows) or (span is not None and T != span):
                    raise ValueError(f"cache {name!r} is batch {B} x {T} positions; step "
                                     f"built for batch {rows} x {span} on this rank")
        return model.decode_step(token.to(dev), position.to(dev), caches)

    return serve_step


def build_multimodel_steps(
    cfgs,
    plans: dict[str, ShardPlan],
    batch: int | None = None,
    max_len: int | None = None,
    with_decode: bool = True,
    device: str | torch.device = "cuda",
    mesh=None,
):
    """Per-model serving steps from a multimodel co-schedule.

    Every model runs on the whole device (or every rank of ``mesh``),
    time-multiplexed by whoever dispatches the steps.  Returns
    ``{cfg.name: {"prefill": fn, "decode": fn, "plan": plan}}``
    (``"decode"`` only with ``with_decode``).
    """
    fleet = {}
    for cfg in cfgs:
        plan = plans[cfg.name]
        entry = {"prefill": build_prefill_step(cfg, plan, device, mesh), "plan": plan}
        if with_decode:
            entry["decode"] = build_decode_step(cfg, plan, batch=batch, max_len=max_len,
                                                device=device, mesh=mesh)
        fleet[cfg.name] = entry
    return fleet


def next_tokens(model: DecoderLM, logits: torch.Tensor) -> torch.Tensor:
    """The greedy next token [B, 1] of every row from a step's last logits;
    a rank's shard first gathers the whole batch and vocab."""
    if model.shard is not None:
        logits = gather_logits(logits[:, -1:], model.shard, tag="next_token")
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


@torch.inference_mode()
def greedy_generate(cfg, model, decode_fn, caches, prompt_last_token, start_pos, steps):
    """Batched greedy loop driving a decode step; returns (tokens [B,steps], caches)."""
    B = prompt_last_token.shape[0]
    tok = prompt_last_token.to(model.device)
    pos = torch.full((B,), start_pos, dtype=torch.int64, device=model.device)
    out = []
    for _ in range(steps):
        logits, caches = decode_fn(model, tok, pos, caches)
        tok = next_tokens(model, logits)
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1), caches
