"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro.launch.train``: config -> Scope DSE plan
(``plan_for_cell(kind="train")``) -> train step -> synthetic data ->
fault-tolerant loop with checkpointing.  The same flags, plus ``--device``
(default ``cuda``; the CPU only when asked for).  ``--mesh DxM`` trains on
a (data, model) mesh of D x M ranks, each a process of its own started here
(``launch/mesh.run_ranks``; NCCL with a card a rank, gloo where ranks share
one): each rank builds the whole model from the seed (one rank at a time
where ranks share a card), keeps its shard and its optimizer pieces, and
runs the mesh train step; its checkpoints hold whole leaves.  Before it
allocates, it refuses a config whose weights, gradients and optimizer state
exceed the card (on a mesh: the rank's peak from the dry-run's meta step
times the ranks a card holds, and the build's whole model beside their
shards).

    python -m repro_torch.launch.train --arch granite-3-8b --smoke --device cpu --steps 20
    python -m repro_torch.launch.train --arch granite-3-8b --smoke --device cpu --mesh 2x2
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
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.ft import ResilientTrainer, StragglerMonitor
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.optim import make_optimizer
from repro_torch.runtime.planner import plan_for_cell
from repro_torch.runtime.sharding import shard_model, train_layout
from repro_torch.runtime.train import build_train_step

MESH_AXES = ("data", "model")


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


def check_rank_fits(cfg: ModelConfig, plan, seq: int, batch: int, dims: tuple[int, int],
                    ranks_a_card: int) -> None:
    """Raise unless ``ranks_a_card`` ranks of the mesh fit a card, both while
    they build (:func:`rank_model`: one whole model beside the shards built
    so far) and in the step (the first rank's step traced on meta,
    ``launch.dryrun.trace_step``)."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.hlo_analysis import CARD_USABLE_MEMORY, RESERVED_MARGIN

    meta = make_mesh(dims, MESH_AXES, meta=True)
    peak = trace_step(cfg, seq, batch, "train", plan, meta)["memory_analysis"]["peak_bytes"]
    whole = init_params(cfg, None, "meta")
    shard = shard_model(whole, plan, meta)
    held = sum(p.nbytes for p in shard.parameters())
    # on a model axis each shard is a copy beside the whole model
    build = ranks_a_card * held + (sum(p.nbytes for p in whole.parameters())
                                   if dims[1] > 1 else 0)
    need = max(ranks_a_card * peak, build) * (1 + RESERVED_MARGIN)
    if need > CARD_USABLE_MEMORY:
        raise RuntimeError(
            f"{cfg.name} on a {dims[0]}x{dims[1]} mesh: {ranks_a_card} rank(s) a card need "
            f"{need / 2**30:.1f} GiB (the dry-run's peak {peak / 2**30:.1f} GiB a rank, the "
            f"build {build / 2**30:.1f} GiB, +{RESERVED_MARGIN:.0%}), more than the card's "
            f"usable {CARD_USABLE_MEMORY / 2**30:.1f} GiB; train it with fewer layers or on "
            "more cards")


def rank_model(cfg: ModelConfig, plan, mesh, seed: int = 0):
    """This rank's trainable shard of the model a one-rank run builds from
    ``seed``.  Where ranks share a card (gloo on a card) they build the whole
    model one at a time, each freeing it before the next begins, so the
    card holds one whole model beside the shards built so far."""
    dev = mesh.device
    shared = dev.type == "cuda" and mesh.backend == "gloo"
    model = None
    for turn in range(mesh.size if shared else 1):
        if not shared or turn == mesh.rank:
            whole = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
            model = shard_model(whole, plan, mesh)
            del whole
            if shared:
                torch.cuda.empty_cache()
        if shared:
            dist.barrier()
    return model.train_params()


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

    device = resolve_device(args.device)
    dims = tuple(int(x) for x in args.mesh.split("x"))
    if len(dims) != 2 or min(dims) < 1:
        raise SystemExit(f"--mesh {args.mesh}: D x M, e.g. 2x2")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if device.type == "cuda" and args.smoke and cfg.head_dim < min(HEAD_DIMS):
        print(f"smoke config on the card: d_head {cfg.head_dim} -> {min(HEAD_DIMS)} "
              "(the flash kernels' narrowest head dim)")
        cfg = dataclasses.replace(cfg, d_head=min(HEAD_DIMS))
    plan = plan_for_cell(cfg, args.seq, args.batch, MESH_AXES, model_axis=dims[1],
                         kind="train", use_dse=not args.no_dse)
    print(f"plan: {plan.p1}->{plan.p2} @ repeat {plan.transition_repeat} "
          f"(dse meta: {plan.meta})")
    if dims == (1, 1):
        if device.type == "cuda":
            check_training_fits(cfg, torch.cuda.get_device_properties(device).total_memory)
        return _train(args, cfg, plan, device)
    n = dims[0] * dims[1]
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        check_rank_fits(cfg, plan, args.seq, args.batch, dims, 1 if cards >= n else n)
    return run_ranks(_train_rank, dims, MESH_AXES, args, cfg, plan, device=device)[0]


def _train_rank(mesh, args, cfg, plan) -> list[dict]:
    """One rank of ``--mesh``: the whole model from the seed, then its shard
    and its zero optimizer pieces."""
    return _train(args, cfg, plan, mesh.device, mesh)


def _train(args, cfg: ModelConfig, plan, device: torch.device, mesh=None) -> list[dict]:
    """The training loop on one rank, or on this rank of ``mesh``; its
    history (the metrics are global, the same on every rank)."""
    step = build_train_step(cfg, plan, base_lr=args.lr, warmup=max(1, args.steps // 20),
                            total_steps=args.steps, device=device, mesh=mesh)
    if mesh is None:
        model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
        model.train_params()
        opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    else:
        model = rank_model(cfg, plan, mesh)
        opt = train_layout(model).zero_moments(device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

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
        on_straggler=lambda s, dt: say(f"  [straggler] step {s}: {dt:.2f}s"),
    )
    model, opt, hist = trainer.run(model, opt, n_steps=args.steps)
    for h in hist:
        if h["step"] % max(1, args.steps // 20) == 0 or h["step"] == 1:
            say(f"step {h['step']:5d} loss {h['loss']:.4f} grad norm {h['grad_norm']:.4f} "
                f"({h['time']*1e3:.0f} ms)")
    say(f"final loss {hist[-1]['loss']:.4f}; stragglers flagged: {len(mon.flagged)}")
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
