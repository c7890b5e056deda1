"""Merged-pipeline execution demo (the paper's mechanism, on a mesh of ranks).

The PyTorch port's copy of ``examples/scope_pipeline.py``: starts 8 ranks
(processes, ``launch.mesh.run_ranks``) as a (stage=4, data=2) mesh and runs
the GPipe pipeline where each stage executes a Scope *cluster* of merged
layers.  Verifies the pipelined forward matches the plain forward and shows
the Eq. 2 beat structure (m + N_cluster - 1).  ``--device`` (default
``cuda``): the ranks share the card over gloo; ``--device cpu`` runs them
on the CPU.

    PYTHONPATH=src python examples/scope_pipeline_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import init_params
from repro_torch.runtime.pipeline import gather_pipeline_logits, gpipe_beats, pipeline_forward

N_STAGES, N_DATA, N_MICRO, MB, S = 4, 2, 8, 4, 32
# 8 repeats / 4 stages; d_head 64 on the card, where the flash kernel has no
# instantiation at the smoke config's 16
CFG = dataclasses.replace(get_smoke_config("granite-3-8b"), n_layers=8, remat=False)


def model_and_tokens(dev):
    cfg = CFG if dev.type == "cpu" else dataclasses.replace(CFG, d_head=64)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
    toks = torch.randint(0, cfg.vocab, (N_MICRO, MB, S), generator=torch.Generator().manual_seed(1))
    return model, toks


def rank(mesh):
    model, toks = model_and_tokens(mesh.device)
    logits = pipeline_forward(model, toks, mesh, N_STAGES)
    return gather_pipeline_logits(logits, mesh).cpu()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)
    print(f"mesh: {{'stage': {N_STAGES}, 'data': {N_DATA}}} -- each stage owns a merged "
          f"cluster of {CFG.pattern_repeats // N_STAGES} blocks")
    print(f"GPipe beats = n_micro + n_stages - 1 = {len(gpipe_beats(N_MICRO, N_STAGES))} "
          f"(paper Eq. 2: m + N_cluster - 1)")
    t0 = time.time()
    piped = run_ranks(rank, (N_STAGES, N_DATA), ("stage", "data"), device=dev, verbose=False)[0]
    print(f"pipelined forward: {time.time() - t0:.2f}s (8 ranks started), logits "
          f"{tuple(piped.shape)}")
    model, toks = model_and_tokens(dev)
    with torch.inference_mode():
        ref = torch.stack([model(toks[i].to(dev))[0] for i in range(N_MICRO)]).cpu()
    err = (piped - ref).abs().max().item()
    print(f"max |pipelined - plain| = {err:.2e}")
    torch.testing.assert_close(piped, ref, rtol=2e-3, atol=2e-3)
    print("OK: merged pipeline reproduces the plain forward exactly")


if __name__ == "__main__":
    main()
