"""The reference's pytrees (as numpy) <-> the port's model and optimizer state.

The one converter between the packages, both ways: tests run the reference
and the port on the same weights, since ``jax.random`` and
``torch.Generator`` draw different numbers from the same seed.  The
reference stacks each pattern slot's leaves ``[R, ...]``; the port keeps a
tensor per layer and optimizer state in the stacked layout.  Takes and gives
numpy arrays only, so this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tree
from .device import resolve_device
from .models.config import ModelConfig
from .models.model import DecoderLM
from .optim import OptState
from .tree import Stacked


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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host; bfloat16 as ``ml_dtypes.bfloat16`` (imported
    only for bfloat16: the JAX side of the tests has it)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Stacked):
        return np.stack([to_numpy(t) for t in leaf.layers])
    return to_numpy(leaf)


def params_to_jax(model: DecoderLM) -> dict:
    """The inverse of :func:`params_from_jax`: the model's weights as the
    reference's numpy pytree, each pattern slot's leaves stacked ``[R, ...]``."""
    return tree.map(_leaf_to_numpy, model.param_tree())


def opt_state_to_jax(state: OptState) -> OptState:
    """The port's optimizer state as numpy in the reference's ``OptState``
    layout (``step`` an int32 scalar; ``m``, ``v`` pytrees of stacked
    leaves); ``repro.optim.OptState(*result)`` is the reference's type."""
    return OptState(*(tree.map(to_numpy, x) for x in state))


def opt_state_from_jax(state_np, device: str | torch.device = "cuda") -> OptState:
    """The reference's ``OptState`` (as numpy) -> the port's, on ``device``
    (``step`` stays on the host)."""
    dev = resolve_device(device)
    return OptState(step=to_torch(np.asarray(state_np.step, np.int32), "cpu"),
                    m=tree.map(lambda a: to_torch(a, dev), state_np.m),
                    v=tree.map(lambda a: to_torch(a, dev), state_np.v))
