"""AdamW and Adafactor written out by hand (port of ``repro/optim/optimizers.py``).

No ``torch.optim``: the update arithmetic is the reference's, in fp32.  The
optimizer's unit is the reference's leaf, which for a block weight is one
pattern slot's R layers stacked; the port keeps those as per-layer tensors
(:class:`~repro_torch.tree.Stacked`).

* AdamW is elementwise, so it updates layer by layer (one layer's fp32
  temporaries at a time), but stores its moments under the reference's
  stacked shapes, so checkpoints interchange.
* Adafactor's statistics and RMS clip span the whole stacked leaf: a stacked
  ``[R, d]`` norm weight is factored when R > 1 (its column statistics
  average over the R layers) and the clip's RMS runs over all R layers.  So
  it stacks each leaf's gradients; a per-layer Adafactor computes another
  update.  Its state has the reference's shapes: rows ``p.shape[:-1]``,
  cols ``p.shape[:-2] + p.shape[-1:]`` of the stacked shape.

Parameters are updated in place: the caller runs an update only after its
backward pass has finished.  Scalars (the schedule, the bias corrections,
Adafactor's ``beta``) are evaluated in float32 on the host with
``step = state.step + 1``, as the reference evaluates them in float32.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import tree
from ..tree import Stacked, leaf_layers

f32 = np.float32


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar, on the host
    m: Any               # AdamW: fp32 first moments. Adafactor: row stats pytree.
    v: Any               # AdamW: fp32 second moments. Adafactor: col stats pytree.


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)`` -> float32: linear warm-up, then cosine decay to 0."""
    def lr(step) -> np.float32:
        step = f32(step)
        warm = f32(base_lr) * step / f32(max(1, warmup))
        t = np.clip((step - f32(warmup)) / f32(max(1, total - warmup)), f32(0.0), f32(1.0))
        cos = f32(0.5 * base_lr) * (f32(1.0) + np.cos(f32(np.pi) * t))
        return warm if step < warmup else cos
    return lr


def _zeros(shape, leaf) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=leaf.device)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling as an fp32 tensor).  Each gradient is scaled in fp32 and
    cast back to its dtype, in place."""
    leaves = tree.leaves(grads)
    gsq = 0
    for leaf in leaves:
        gsq = gsq + sum(g.float().square().sum() for g in leaf_layers(leaf))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for leaf in leaves:
        for g in leaf_layers(leaf):
            g.copy_(g.float() * scale)
    return grads, gnorm


# --------------------------------------------------------------------- AdamW

def adamw_init(params) -> OptState:
    """Zero fp32 moments in the reference's stacked shapes."""
    zeros = lambda p: _zeros(p.shape, p)  # noqa: E731
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    m=tree.map(zeros, params), v=tree.map(zeros, params))


@torch.no_grad()
def adamw_update(
    params, grads, state: OptState, lr,
    b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
) -> OptState:
    """One AdamW step on ``params`` (a :meth:`DecoderLM.param_tree` or any
    pytree of tensors) in place; returns the new state (its moments updated
    in place)."""
    step = int(state.step) + 1
    lr_t = float(lr(step) if callable(lr) else f32(lr))
    bc1 = float(f32(1.0) - f32(b1) ** f32(step))
    bc2 = float(f32(1.0) - f32(b2) ** f32(step))
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads), tree.leaves(state.m),
                          tree.leaves(state.v), strict=True):
        stacked = isinstance(p, Stacked)
        for r, (pr, gr) in enumerate(zip(leaf_layers(p), leaf_layers(g), strict=True)):
            mr, vr = (m[r], v[r]) if stacked else (m, v)
            gf = gr.float()
            mr.mul_(b1).add_(gf, alpha=1 - b1)
            vr.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            delta = (mr / bc1) / ((vr / bc2).sqrt_().add_(eps))
            pf = pr.float()
            delta.add_(pf, alpha=weight_decay)
            pr.copy_(pf.sub_(delta, alpha=lr_t))
    return OptState(step=torch.tensor(step, dtype=torch.int32), m=state.m, v=state.v)


# ----------------------------------------------------------------- Adafactor

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params) -> OptState:
    def rows(p):
        shape = tuple(p.shape)
        return _zeros(shape[:-1] if _factored(shape) else shape, p)

    def cols(p):
        shape = tuple(p.shape)
        return _zeros(shape[:-2] + shape[-1:] if _factored(shape) else (1,), p)

    return OptState(step=torch.zeros((), dtype=torch.int32),
                    m=tree.map(rows, params), v=tree.map(cols, params))


@torch.no_grad()
def adafactor_update(
    params, grads, state: OptState, lr,
    decay=0.8, eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
) -> OptState:
    """One Adafactor step on ``params`` in place, a stacked leaf at a time;
    returns the new state (its statistics updated in place)."""
    step = int(state.step) + 1
    lr_t = float(lr(step) if callable(lr) else f32(lr))
    beta = f32(1.0) - (f32(step) + f32(1.0)) ** f32(-decay)
    one_minus_beta = float(f32(1.0) - beta)
    beta = float(beta)
    for p, g, r, c in zip(tree.leaves(params), tree.leaves(grads), tree.leaves(state.m),
                          tree.leaves(state.v), strict=True):
        stacked = isinstance(p, Stacked)
        gf = (torch.stack([x.float() for x in g.layers]) if stacked else g.float())
        g2 = gf * gf + eps
        if _factored(tuple(p.shape)):
            r.mul_(beta).add_(g2.mean(dim=-1), alpha=one_minus_beta)
            c.mul_(beta).add_(g2.mean(dim=-2), alpha=one_minus_beta)
            rc = r / torch.clamp(r.mean(dim=-1, keepdim=True), min=eps)
            vhat = rc[..., None] * c[..., None, :]
        else:
            r.mul_(beta).add_(g2, alpha=one_minus_beta)
            vhat = r
        u = gf * torch.rsqrt(torch.clamp(vhat, min=eps))
        rms = torch.sqrt(torch.mean(u * u))           # update clipping (RMS)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        for i, pr in enumerate(leaf_layers(p)):
            pf = pr.float()
            delta = (u[i] if stacked else u) + weight_decay * pf
            pr.copy_(pf - lr_t * delta)
    return OptState(step=torch.tensor(step, dtype=torch.int32), m=state.m, v=state.v)


def make_optimizer(kind: str):
    if kind == "adamw":
        return adamw_init, adamw_update
    if kind == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(kind)
