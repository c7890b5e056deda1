"""Serving launcher: prompt ingest through the decode step, then greedy decode.

``python -m repro_torch.launch.serve --arch granite-3-8b [--smoke] [--device cpu] --tokens 32``
``python -m repro_torch.launch.serve --arch granite-3-8b --smoke --mesh 2x2 --device cpu``

The same flags and flow as ``repro.launch.serve``, plus ``--device``
(default ``cuda``; the CPU only when asked for).  ``--mesh DxM`` runs the
decode step on a (data, model) mesh of D x M ranks, each a process of its
own started here (``launch/mesh.run_ranks``; NCCL with a card a rank, gloo
when they share a card or run on the CPU): every rank draws the whole model
from the seed and keeps its shard.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import DecoderLM, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.planner import plan_for_cell
from repro_torch.runtime.serve import build_decode_step, greedy_generate, next_tokens
from repro_torch.runtime.sharding import shard_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, model: DecoderLM, batch: int, prompt_len: int, tokens: int,
          cache_dtype: torch.dtype = torch.bfloat16, mesh=None) -> dict:
    """Ingest a random prompt token by token through the decode step (the
    step the serving loop runs), then decode ``tokens`` greedy tokens.

    ``model`` is the whole model; with a ``mesh`` of several ranks (this
    process being one of them) the rank keeps its shard and the step runs
    on the mesh.  Returns the generated tokens (the whole batch, on every
    rank) and host-clock times of both phases, each ending in a device
    synchronise.
    """
    max_len = prompt_len + tokens
    model_axis = 1 if mesh is None else mesh.shape["model"]
    plan = plan_for_cell(cfg, max_len, batch, ("data", "model"), model_axis=model_axis,
                         kind="decode")
    if mesh is not None:
        model = shard_model(model, plan, mesh)
    device = model.device
    dstep = build_decode_step(cfg, plan, batch=batch, max_len=max_len, device=device, mesh=mesh)
    caches = model.init_kv_cache(batch, max_len, cache_dtype)
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
                             prompt_last_token=next_tokens(model, logits),
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


def _serve_rank(mesh, args) -> dict:
    """One rank of ``--mesh``: the whole model from the seed, then its shard."""
    return _serve_here(args, mesh.device, mesh)


def _serve_here(args, device: torch.device, mesh=None) -> dict:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if device.type == "cuda":
        check_weights_fit(cfg, torch.cuda.get_device_properties(device).total_memory)
    # no reference kept here: on a mesh the rank keeps only its shard
    res = serve(cfg, init_params(cfg, torch.Generator(device=device).manual_seed(0), device),
                args.batch, args.prompt_len, args.tokens,
                torch.float32 if args.smoke else torch.bfloat16, mesh)
    res["tokens"] = res["tokens"].cpu()
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--mesh", default="1x1", help="DxM: data x model ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dims = tuple(int(x) for x in args.mesh.split("x"))
    if len(dims) != 2 or min(dims) < 1:
        raise SystemExit(f"--mesh {args.mesh}: D x M, e.g. 2x2")
    if dims == (1, 1):
        res = _serve_here(args, device)
    else:
        res = run_ranks(_serve_rank, dims, ("data", "model"), args, device=device)[0]
    out, dt = res["tokens"], res["decode_s"]
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({res['decode_tok_s']:.1f} tok/s)")
    print("sample:", out[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
