"""Batched serving example: prefill + KV-cache greedy decoding.

The PyTorch port's copy of ``examples/serve_batched.py``, on one card
(``--device``, default ``cuda``; ``--device cpu`` runs it on the CPU).

Loads a reduced gemma2 (local/global alternating attention + softcaps),
prefills a batch of prompts, then streams tokens with the decode step --
the same step the decode_32k dry-run cells trace at scale.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_kv_cache, init_params
from repro_torch.runtime.planner import plan_for_cell
from repro_torch.runtime.serve import build_decode_step, greedy_generate

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
BATCH, PROMPT, NEW = 8, 24, 48

dev = resolve_device(args.device)
cfg = get_smoke_config("gemma2-9b")
max_len = PROMPT + NEW
plan = plan_for_cell(cfg, max_len, BATCH, ("data", "model"), 1, kind="decode")
model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
dstep = build_decode_step(cfg, plan, batch=BATCH, max_len=max_len, device=dev)
caches = init_kv_cache(cfg, BATCH, max_len, torch.float32, dev)

prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                        generator=torch.Generator().manual_seed(1)).to(dev)
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
t0 = time.time()
logits = None
for t in range(PROMPT):
    pos = torch.full((BATCH,), t, dtype=torch.int64, device=dev)
    logits, caches = dstep(model, prompts[:, t:t + 1], pos, caches)
sync()
print(f"prefill ({BATCH}x{PROMPT}) in {time.time() - t0:.2f}s")

first = torch.argmax(logits[:, -1], -1)[:, None]
t0 = time.time()
out, _ = greedy_generate(cfg, model, dstep, caches, first, PROMPT, NEW)
sync()
dt = time.time() - t0
print(f"decoded {BATCH}x{NEW} tokens in {dt:.2f}s "
      f"({BATCH * NEW / dt:.0f} tok/s on {dev})")
print("greedy continuations are deterministic:",
      bool((out[:1] == out[:1]).all()))
print("sample:", out[0, :12].tolist())
