"""Serving launcher: prompt ingest through the decode step, then greedy decode.

``python -m repro_torch.launch.serve --arch granite-3-8b [--smoke] [--device cpu] --tokens 32``

The same flags and flow as ``repro.launch.serve`` minus ``--mesh`` (one
card), plus ``--device`` (default ``cuda``; the CPU only when asked for).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import DecoderLM, init_kv_cache, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.planner import plan_for_cell
from repro_torch.runtime.serve import build_decode_step, greedy_generate


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, model: DecoderLM, batch: int, prompt_len: int, tokens: int,
          cache_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Ingest a random prompt token by token through the decode step (the
    step the serving loop runs), then decode ``tokens`` greedy tokens.

    Returns the generated tokens and host-clock times of both phases, each
    ending in a device synchronise.
    """
    device = model.device
    max_len = prompt_len + tokens
    plan = plan_for_cell(cfg, max_len, batch, ("data", "model"), model_axis=1, kind="decode")
    dstep = build_decode_step(cfg, plan, batch=batch, max_len=max_len, device=device)
    caches = init_kv_cache(cfg, batch, max_len, cache_dtype, device)
    gen = torch.Generator().manual_seed(1)     # the reference's PRNGKey(1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen).to(device)

    _sync(device)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        pos = torch.full((batch,), t, dtype=torch.int64, device=device)
        logits, caches = dstep(model, prompt[:, t:t + 1], pos, caches)
    _sync(device)
    t1 = time.perf_counter()
    out, _ = greedy_generate(cfg, model, dstep, caches,
                             prompt_last_token=torch.argmax(logits[:, -1], -1)[:, None],
                             start_pos=prompt_len, steps=tokens)
    _sync(device)
    t2 = time.perf_counter()
    return {"tokens": out, "prompt_s": t1 - t0, "decode_s": t2 - t1,
            "decode_tok_s": batch * tokens / (t2 - t1)}


def check_weights_fit(cfg: ModelConfig, device_bytes: int) -> None:
    """Raise before allocating when the weights alone (``cfg.n_params`` in
    ``cfg.param_dtype``, a lower bound) exceed the card's memory."""
    need = cfg.n_params * torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    if need > device_bytes:
        raise RuntimeError(
            f"{cfg.name}: its {cfg.param_dtype} weights need at least {need / 2**30:.1f} GiB, "
            f"more than the card's {device_bytes / 2**30:.1f} GiB "
            "(torch.cuda.get_device_properties(dev).total_memory); serve it with fewer "
            "layers or on more cards")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if device.type == "cuda":
        check_weights_fit(cfg, torch.cuda.get_device_properties(device).total_memory)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    res = serve(cfg, model, args.batch, args.prompt_len, args.tokens,
                torch.float32 if args.smoke else torch.bfloat16)
    out, dt = res["tokens"], res["decode_s"]
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({res['decode_tok_s']:.1f} tok/s)")
    print("sample:", out[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
