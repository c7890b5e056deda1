"""JAX parameter pytree (as numpy) -> :class:`repro_torch.models.DecoderLM`.

The one converter between the packages: tests run the reference and the port
on the same weights, since ``jax.random`` and ``torch.Generator`` draw
different numbers from the same seed.  Takes numpy arrays only, so this
module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models.model import DecoderLM


def to_torch(a: np.ndarray, device: str | torch.device = "cuda") -> torch.Tensor:
    """numpy -> torch, bfloat16 included (read as uint16, no ``ml_dtypes``)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(cfg: ModelConfig, params_np: dict,
                    device: str | torch.device = "cuda") -> DecoderLM:
    """``params_np``: the reference's ``init_params`` pytree as numpy arrays.

    The reference stacks each pattern slot's leaves as ``[R, ...]``; leaf
    ``[r]`` of slot ``pi`` becomes layer ``r * P + pi``.
    """
    dev = resolve_device(device)
    P = len(cfg.expanded_pattern)

    def layer(tree, r):
        return {n: layer(v, r) if isinstance(v, dict) else to_torch(v[r], dev)
                for n, v in tree.items()}

    blocks = [layer(params_np["blocks"][li % P], li // P) for li in range(cfg.n_layers)]
    params = {"embed": to_torch(params_np["embed"], dev), "blocks": blocks,
              "final_ln": to_torch(params_np["final_ln"], dev)}
    if "lm_head" in params_np:
        params["lm_head"] = to_torch(params_np["lm_head"], dev)
    return DecoderLM(cfg, params)
