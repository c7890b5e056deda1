"""The train step: loss -> grads -> (compress) -> clip -> optimizer.

Port of ``repro/runtime/train.py`` for one card.  The reference's step is a
jitted pure function over (params, opt_state, batch); the port's updates
the model's parameters and the optimizer state in place and returns them,
and it does so only after the backward pass has finished, so a step that
fails in its forward or backward leaves both as they were
(:class:`repro_torch.ft.ResilientTrainer` retries such a step without a
checkpoint).  One card has one zone, so the plan's WSP->ISP
``transition_repeat`` changes nothing here, as in ``runtime/serve.py``.

Dtypes follow the reference: with ``cfg.accum_steps == 1`` gradients stay
in the parameter dtype (bf16 on the full configs) and clipping casts back
to it; with ``accum_steps > 1`` the microbatches ``reshape(A, B // A)`` add
fp32 gradients, divided by A and clipped in fp32.  On the card attention's
backward is the flash backward kernel (``csrc/flash_attention_bwd.cu``),
the rwkv layers' the WKV-6 backward kernel (``csrc/wkv6_bwd.cu``) and the
mamba layers' the selective-scan backward kernel
(``csrc/mamba_scan_bwd.cu``), each behind its autograd function.
"""
from __future__ import annotations

import torch

from .. import tree
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import DecoderLM, check_supported, loss_fn
from ..optim import clip_by_global_norm, cosine_schedule, make_optimizer
from .compression import compress_decompress
from .serve import _check_model
from .sharding import ShardPlan


def _regroup(params, flat: list[torch.Tensor]):
    """``params``' structure over ``flat``, one tensor per layer in order."""
    it = iter(flat)
    return tree.map(lambda p: tree.Stacked([next(it) for _ in p.layers])
                    if isinstance(p, tree.Stacked) else next(it), params)


def build_train_step(
    cfg: ModelConfig,
    plan: ShardPlan,
    base_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    compress: bool = False,
    device: str | torch.device = "cuda",
):
    """``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
    with ``metrics = {"loss", "grad_norm"}`` (fp32 scalar tensors on the
    device).  ``batch``: ``{"tokens", "labels"}`` [B, S] integer arrays or
    tensors, and for the frontend stubs ``"frontend_embeds"`` (the audio
    stub's batch has no ``"tokens"``), as the data pipeline's
    ``frontend_batch`` makes them.  The model must be trainable
    (:meth:`DecoderLM.train_params`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    _, update_fn = make_optimizer(cfg.optimizer)
    lr = cosine_schedule(base_lr, warmup, total_steps)

    def grads_of(model, flat, tokens, labels, femb):
        # every other leaf has a path to the loss: autograd raises on one
        # that has none (a kernel call that drops its inputs' graph) rather
        # than training on with that leaf frozen.  The leaves the prefill
        # does not use get a zero gradient, as in the reference.
        loss = loss_fn(model, tokens, labels, femb)
        unused = {id(p) for p in model.unused_by_prefill()}
        g = iter(torch.autograd.grad(loss, [p for p in flat if id(p) not in unused]))
        return loss.detach(), [torch.zeros_like(p) if id(p) in unused else next(g)
                               for p in flat]

    def train_step(model: DecoderLM, opt_state, batch: dict):
        _check_model(model, cfg, dev)
        tokens = batch.get("tokens")
        if tokens is not None:
            tokens = torch.as_tensor(tokens).to(dev, torch.int64)
        labels = torch.as_tensor(batch["labels"]).to(dev, torch.int64)
        femb = batch.get("frontend_embeds")
        if femb is not None:
            femb = torch.as_tensor(femb).to(dev)
        params = model.param_tree()
        flat = model.flat_params()
        A = cfg.accum_steps
        if A > 1:
            B = labels.shape[0]
            if B % A:
                raise ValueError(f"batch {B} does not split into {A} microbatches")
            mb = B // A
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for a in range(A):
                rows = slice(a * mb, (a + 1) * mb)
                loss_a, g = grads_of(model, flat, None if tokens is None else tokens[rows],
                                     labels[rows], None if femb is None else femb[rows])
                loss = loss + loss_a
                for acc, ga in zip(grads, g, strict=True):
                    acc.add_(ga.float())
            loss = loss / A
            grads = [g / A for g in grads]
        else:
            loss, grads = grads_of(model, flat, tokens, labels, femb)
        grads = _regroup(params, list(grads))
        with torch.profiler.record_function("optimizer"):
            if compress:
                grads = tree.map(lambda g: tree.Stacked(compress_decompress(g.layers))
                                 if isinstance(g, tree.Stacked) else compress_decompress(g), grads)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            opt_state = update_fn(params, grads, opt_state, lr)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
