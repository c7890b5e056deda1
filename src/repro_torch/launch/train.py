"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro.launch.train`` for one card: config -> Scope DSE plan
(``plan_for_cell(kind="train")``) -> train step -> synthetic data ->
fault-tolerant loop with checkpointing.  The same flags, plus ``--device``
(default ``cuda``; the CPU only when asked for).  ``--mesh`` other than
``1x1`` raises (the train step on a mesh is ROADMAP A13c).  Before it allocates, it refuses
a config whose weights, gradients and optimizer state exceed the card.

    python -m repro_torch.launch.train --arch granite-3-8b --smoke --device cpu --steps 20
    python -m repro_torch.launch.train --arch granite-moe-1b-a400m --steps 20
    python -m repro_torch.launch.train --arch musicgen-medium --steps 4 --batch 4 --seq 2048

The frontend stubs train on the data pipeline's embeddings (audio: a frame
a position; vision: ``frontend_tokens`` patches ahead of the tokens).  The
run fails if a step's loss or grad norm is not finite.  ``--smoke`` on the
card widens the smoke config's attention head dim (16) to the flash
kernels' narrowest (64), as the card tests do:

    python -m repro_torch.launch.train --arch jamba-v0.1-52b --smoke --device cuda --steps 4
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.ft import ResilientTrainer, StragglerMonitor
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.optim import make_optimizer
from repro_torch.runtime.planner import plan_for_cell
from repro_torch.runtime.train import build_train_step


def training_bytes(cfg: ModelConfig) -> int:
    """A lower bound on what training holds besides activations: weights and
    gradients in ``cfg.param_dtype`` (fp32 gradients too when accumulating),
    plus AdamW's two fp32 moments (Adafactor's factored state is ignored)."""
    p = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    per_param = 2 * p + (4 if cfg.accum_steps > 1 else 0)
    per_param += 8 if cfg.optimizer == "adamw" else 0
    return cfg.n_params * per_param


def check_training_fits(cfg: ModelConfig, device_bytes: int) -> None:
    need = training_bytes(cfg)
    if need > device_bytes:
        raise RuntimeError(
            f"{cfg.name}: its weights, gradients and {cfg.optimizer} state need at least "
            f"{need / 2**30:.1f} GiB, more than the card's {device_bytes / 2**30:.1f} GiB "
            "(torch.cuda.get_device_properties(dev).total_memory); train it with fewer "
            "layers or on more cards")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="data x model; one card: 1x1")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-dse", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if tuple(int(x) for x in args.mesh.split("x")) != (1, 1):
        raise NotImplementedError(f"--mesh {args.mesh}: the train step on a mesh is ROADMAP A13c")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if device.type == "cuda":
        if args.smoke and cfg.head_dim < min(HEAD_DIMS):
            print(f"smoke config on the card: d_head {cfg.head_dim} -> {min(HEAD_DIMS)} "
                  "(the flash kernels' narrowest head dim)")
            cfg = dataclasses.replace(cfg, d_head=min(HEAD_DIMS))
        check_training_fits(cfg, torch.cuda.get_device_properties(device).total_memory)
    plan = plan_for_cell(cfg, args.seq, args.batch, ("data", "model"), model_axis=1,
                         kind="train", use_dse=not args.no_dse)
    print(f"plan: {plan.p1}->{plan.p2} @ repeat {plan.transition_repeat} "
          f"(dse meta: {plan.meta})")

    step = build_train_step(cfg, plan, base_lr=args.lr, warmup=max(1, args.steps // 20),
                            total_steps=args.steps, device=device)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device).train_params()
    init_fn, _ = make_optimizer(cfg.optimizer)
    opt = init_fn(model.param_tree())

    it = make_batch_iterator(cfg, batch=args.batch, seq=args.seq)
    cache = {}

    def batch_fn(s):
        while s not in cache:
            i, b = next(it)
            cache[i] = b
            if len(cache) > 4:
                cache.pop(min(k for k in cache if k != s), None)
        return cache[s]

    mon = StragglerMonitor()
    trainer = ResilientTrainer(
        train_step=step, batch_fn=batch_fn, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, straggler=mon,
        on_straggler=lambda s, dt: print(f"  [straggler] step {s}: {dt:.2f}s"),
    )
    model, opt, hist = trainer.run(model, opt, n_steps=args.steps)
    for h in hist:
        if h["step"] % max(1, args.steps // 20) == 0 or h["step"] == 1:
            print(f"step {h['step']:5d} loss {h['loss']:.4f} grad norm {h['grad_norm']:.4f} "
                  f"({h['time']*1e3:.0f} ms)")
    print(f"final loss {hist[-1]['loss']:.4f}; stragglers flagged: {len(mon.flagged)}")
    bad = [h for h in hist if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))]
    if bad:
        raise RuntimeError(f"non-finite loss or grad norm: {bad}")
    return hist


def check_gradients(model, batch: dict, device: torch.device) -> int:
    """Raise unless every per-layer gradient of the loss on ``batch`` is
    finite and non-zero (those the prefill does not use,
    :meth:`DecoderLM.unused_by_prefill`, left out); return how many were
    checked.  One forward and backward beyond training, for the checks that
    hold a config's gradient path."""
    tokens = batch.get("tokens")
    femb = batch.get("frontend_embeds")
    loss = loss_fn(model, None if tokens is None else torch.as_tensor(tokens).to(device).long(),
                   torch.as_tensor(batch["labels"]).to(device).long(),
                   None if femb is None else torch.as_tensor(femb).to(device))
    unused = {id(p) for p in model.unused_by_prefill()}
    flat = [p for p in model.flat_params() if id(p) not in unused]
    grads = torch.autograd.grad(loss, flat)
    n_bad = sum(not (bool(torch.isfinite(g).all()) and g.abs().max().item() > 0) for g in grads)
    if n_bad:
        raise RuntimeError(f"{n_bad} of {len(grads)} per-layer gradients are zero or non-finite")
    return len(grads)


if __name__ == "__main__":
    main()
