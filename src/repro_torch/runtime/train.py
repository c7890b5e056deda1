"""The train step: loss -> grads -> (compress) -> clip -> optimizer.

Port of ``repro/runtime/train.py``.  The reference's step is a jitted pure
function over (params, opt_state, batch) that GSPMD partitions over its
mesh; the port's updates the model's parameters and the optimizer state
in place and returns them, and it does so only after the backward pass has
finished, so a step that fails in its forward or backward leaves both as
they were (:class:`repro_torch.ft.ResilientTrainer` retries such a step
without a checkpoint).  On one rank there is one zone, so the plan's
WSP->ISP ``transition_repeat`` changes nothing there.

On a mesh of several ranks (``mesh``; the model is the rank's
``runtime.sharding.shard_model`` shard and the optimizer state its
``shard_opt_state`` pieces) each rank runs its step
(:class:`~repro_torch.runtime.sharding.TrainLayout`): the zones of the
plan rank-locally through collectives with gradients, the vocab-parallel
loss of its rows, the gradients summed over ``model`` where each rank
holds a part, reduced over ``data`` into the rank's moment pieces (ZeRO),
clipped by the global norm with each element counted once, AdamW on those
pieces, and the updated elements all-gathered back.  MoE layers run their
dispatch groups rank-locally (``models/moe.py``): the all-to-alls and the
expert banks' FSDP gathers differentiate through their transposes, the
router's gradient is summed over ``model`` and an expert bank's arrives
summed over ``data`` on the rank's piece, where its moments are.  A step that fails on
one rank leaves the others waiting in a collective (ROADMAP).

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
from .serve import _check_model, _device
from .sharding import ShardPlan, train_layout


def _batch_on(batch: dict, dev: torch.device):
    """(tokens or None, labels, frontend embeddings or None) on ``dev``."""
    tokens, femb = batch.get("tokens"), batch.get("frontend_embeds")
    return (None if tokens is None else torch.as_tensor(tokens).to(dev, torch.int64),
            torch.as_tensor(batch["labels"]).to(dev, torch.int64),
            None if femb is None else torch.as_tensor(femb).to(dev))


def _loss_and_grads(model: DecoderLM, A: int, tokens, labels, femb, div: int = 1):
    """(the mean of the A microbatches' losses, the mean of their gradients
    of ``loss / div`` over ``model.flat_params()``): with A == 1 the
    gradients in the parameters' dtype; with A > 1 the microbatches
    ``reshape(A, B // A)`` add fp32 gradients.  On a mesh the inputs are
    global and each microbatch is the reference's, its rows split over the
    data ranks (``loss_fn``)."""
    flat = model.flat_params()
    # every other leaf has a path to the loss: autograd raises on one that
    # has none (a kernel call that drops its inputs' graph) rather than
    # training on with that leaf frozen.  The leaves the prefill does not
    # use get a zero gradient, as in the reference.
    unused = {id(p) for p in model.unused_by_prefill()}
    B = labels.shape[0]
    if B % A:
        raise ValueError(f"batch {B} does not split into {A} microbatches")
    mb = B // A
    loss = grads = None
    for a in range(A):
        rows = slice(a * mb, (a + 1) * mb)
        loss_a = loss_fn(model, None if tokens is None else tokens[rows], labels[rows],
                         None if femb is None else femb[rows])
        g = iter(torch.autograd.grad(loss_a / div if div != 1 else loss_a,
                                     [p for p in flat if id(p) not in unused]))
        g = [torch.zeros_like(p) if id(p) in unused else next(g) for p in flat]
        loss = loss_a.detach() if loss is None else loss + loss_a.detach()
        if A == 1:
            grads = g
        elif grads is None:
            grads = [x.float() for x in g]
        else:
            for acc, x in zip(grads, g, strict=True):
                acc.add_(x.float())
    if A == 1:
        return loss, grads
    return loss / A, [x / A for x in grads]


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
    mesh=None,
):
    """``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
    with ``metrics = {"loss", "grad_norm"}`` (fp32 scalar tensors on the
    device).  ``batch``: ``{"tokens", "labels"}`` [B, S] integer arrays or
    tensors, and for the frontend stubs ``"frontend_embeds"`` (the audio
    stub's batch has no ``"tokens"``), as the data pipeline's
    ``frontend_batch`` makes them.  The model must be trainable
    (:meth:`DecoderLM.train_params`).

    With a ``mesh`` of several ranks the step runs on the mesh's device and
    takes the global batch; ``model`` is this rank's shard and
    ``opt_state`` its pieces (``runtime.sharding.shard_opt_state``); the
    metrics are the global ones, the same on every rank."""
    check_supported(cfg)
    if mesh is not None and mesh.size > 1:
        return _build_mesh_step(cfg, plan, base_lr, warmup, total_steps, max_grad_norm,
                                compress, mesh)
    dev = resolve_device(device)
    _, update_fn = make_optimizer(cfg.optimizer)
    lr = cosine_schedule(base_lr, warmup, total_steps)

    def train_step(model: DecoderLM, opt_state, batch: dict):
        _check_model(model, cfg, dev)
        params = model.param_tree()
        loss, grads = _loss_and_grads(model, cfg.accum_steps, *_batch_on(batch, dev))
        grads = _regroup(params, list(grads))
        with torch.profiler.record_function("optimizer"):
            if compress:
                grads = tree.map(lambda g: tree.Stacked(compress_decompress(g.layers))
                                 if isinstance(g, tree.Stacked) else compress_decompress(g), grads)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            opt_state = update_fn(params, grads, opt_state, lr)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _build_mesh_step(cfg, plan, base_lr, warmup, total_steps, max_grad_norm, compress, mesh):
    """The step of one rank of ``mesh`` (:func:`build_train_step`)."""
    if compress:
        raise NotImplementedError("int8 gradient compression in the mesh train step (the "
                                  "reference compresses its accumulation buffers under "
                                  "GSPMD): ROADMAP A13c-5")
    if cfg.optimizer != "adamw":
        raise NotImplementedError(f"{cfg.name}: {cfg.optimizer} on a mesh (factored "
                                  "statistics summed over the axes a leaf splits on): "
                                  "ROADMAP A13c-3b")
    dev = _device(None, mesh)
    _, update_fn = make_optimizer(cfg.optimizer)
    lr = cosine_schedule(base_lr, warmup, total_steps)
    comm = mesh.comm

    def train_step(model: DecoderLM, opt_state, batch: dict):
        _check_model(model, cfg, dev, mesh, plan)
        layout = train_layout(model)
        # the data ranks' gradients add up: each rank's mean counts 1 / n of
        # the global mean (n the data ranks; with use_dp off each holds the
        # whole batch)
        dp = mesh.shape.get("data", 1)
        loss, grads = _loss_and_grads(model, cfg.accum_steps, *_batch_on(batch, dev), div=dp)
        loss = comm.all_reduce(loss, axis="data", tag="loss") / dp
        with torch.profiler.record_function("optimizer"):
            pieces = layout.reduce_grads(model, grads)
            del grads
            gnorm = torch.sqrt(layout.grad_norm_sq(pieces))
            scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            with torch.no_grad():
                for g in pieces:
                    g.copy_(g.float() * scale)
            opt_state = update_fn(layout.param_views(model), layout.grad_tree(model, pieces),
                                  opt_state, lr)
            layout.reassemble(model)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
