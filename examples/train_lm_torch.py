"""End to end: train a ~100M-parameter LM for a few hundred steps.

The PyTorch port's copy of ``examples/train_lm.py``, on one card
(``--device``, default ``cuda``; ``--device cpu`` runs it on the CPU).

Builds a granite-family model scaled to ~100M params, lets the Scope DSE
pick the WSP/ISP plan, and runs the fault-tolerant training loop (with a
mid-run injected failure to demonstrate checkpoint restart) on the device.
Loss drops from ~uniform (ln V ~ 8.3) toward the Markov-chain floor.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import math
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.ft import ResilientTrainer
from repro_torch.models import init_params
from repro_torch.optim import make_optimizer
from repro_torch.runtime.planner import plan_for_cell
from repro_torch.runtime.train import build_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=16)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

dev = resolve_device(args.device)
# granite-3-8b family scaled to ~100M params
cfg = dataclasses.replace(
    get_config("granite-3-8b"),
    name="granite-100m", n_layers=4, d_model=512, n_heads=8, n_kv_heads=2,
    d_head=64, d_ff=1536, vocab=4096, param_dtype="float32", accum_steps=1,
)
model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev).train_params()
print(f"model: {cfg.name}, {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params")

plan = plan_for_cell(cfg, args.seq, args.batch, ("data", "model"), 1,
                     kind="train", use_dse=False)
step = build_train_step(cfg, plan, base_lr=3e-3, warmup=20, total_steps=args.steps,
                        device=dev)
init_fn, _u = make_optimizer(cfg.optimizer)
opt = init_fn(model.param_tree())

it = make_batch_iterator(cfg, batch=args.batch, seq=args.seq)
store = {}


def batch_fn(s):
    while s not in store:
        i, b = next(it)
        store[i] = b
    return store[s]


def injector(s):
    if s == args.steps // 2 and not getattr(injector, "fired", False):
        injector.fired = True
        print(f"  !! injecting node failure at step {s} "
              "(recovery via checkpoint restart)")
        raise RuntimeError("injected failure")


with tempfile.TemporaryDirectory() as ckpt_dir:
    trainer = ResilientTrainer(train_step=step, batch_fn=batch_fn,
                               ckpt_dir=ckpt_dir, ckpt_every=25)
    model, opt, hist = trainer.run(model, opt, n_steps=args.steps,
                                   failure_injector=injector)

for h in hist:
    if h["step"] % 25 == 0 or h["step"] == 1:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}")
print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
      f"(uniform = {math.log(cfg.vocab):.3f})")
assert all(math.isfinite(h["loss"]) for h in hist), "non-finite loss"
assert hist[-1]["loss"] < hist[0]["loss"] - 1.0, "expected a clear loss drop"
