"""Shared primitive layers (PyTorch port of ``repro/models/layers.py``).

Weights keep the JAX layout ``[d_in, d_out]``, so ``dense`` is ``x @ w``.
``ffn_isp`` / ``ffn_wsp`` are a rank's FFN on a model axis
(``runtime/sharding.py``): column- then row-parallel with an all-reduce,
or the weights all-gathered at use; ``mixer_in`` / ``mixer_out`` bracket a
recurrent mixer's rank-local form (``models/rwkv.py``, ``models/ssm.py``);
all differentiate (``runtime/collectives.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime.collectives import copy_to, gather, scatter_sum, sum_over


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] -> (cos, sin) of shape [..., head_dim//2], fp32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, n, head_dim]; cos/sin [..., S, head_dim//2] (half-split form)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., d_in] @ [d_in, d_out] in x's dtype.

    ``torch.matmul`` accumulates bf16 products in fp32 and rounds the result
    once, as the reference's ``preferred_element_type=float32`` then cast does;
    like the reference (which leaves it to XLA) this is no hand-written kernel.
    """
    return torch.matmul(x, w)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def ffn(params: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    if gated:
        h = F.silu(dense(x, params["w1"])) * dense(x, params["w3"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, params["w1"]), approximate="tanh")
    return dense(h, params["w2"])


class _DenseFp32(torch.autograd.Function):
    """``bmm`` with an fp32 output (which autograd cannot differentiate).
    The gradient arriving is that of the partial sum later rounded to x's
    dtype (every call site rounds the ranks' sum), so it is exact in x's
    dtype, and both products take it there, accumulating in fp32 as
    ``dense`` does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        flat = x.reshape(1, -1, x.shape[-1])
        out = torch.bmm(flat, w[None], out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.matmul(g, w.T)
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).T, g.reshape(-1, g.shape[-1]))
        return dx, dw


def dense_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dense`` returned in fp32, not rounded to x's dtype: a row-parallel
    product's partial sum, which the ranks then add.  On the card a bf16
    product accumulates and returns fp32 on the tensor cores (``bmm`` with
    ``out_dtype``, CUDA only; its gradient is :class:`_DenseFp32`'s); the
    CPU multiplies the operands cast to fp32.  Meta tensors take the card's
    form."""
    if x.device.type == "cpu":
        return torch.matmul(x.float(), w.float())
    return _DenseFp32.apply(x, w)


def ffn_isp(params: dict, x: torch.Tensor, gated: bool, shard, tag: str) -> torch.Tensor:
    """This rank's FFN columns (``w1`` / ``w3``) and ``w2`` rows on the whole
    sequence, the partial products summed over the model axis."""
    dtype = x.dtype
    x = copy_to(shard.comm, x, tag=f"{tag}:ffn_in")
    if gated:
        h = F.silu(dense(x, params["w1"])) * dense(x, params["w3"])
    else:
        h = F.gelu(dense(x, params["w1"]), approximate="tanh")
    out = sum_over(shard.comm, dense_fp32(h, params["w2"]), tag=f"{tag}:ffn")
    return out.to(dtype)


def ffn_wsp(params: dict, x: torch.Tensor, gated: bool, shard, tag: str) -> torch.Tensor:
    """The whole FFN on this rank's positions, its weights all-gathered."""
    comm = shard.comm
    full = {"w1": gather(comm, params["w1"], dim=1, tag=f"{tag}:w1"),
            "w2": gather(comm, params["w2"], dim=0, tag=f"{tag}:w2")}
    if gated:
        full["w3"] = gather(comm, params["w3"], dim=1, tag=f"{tag}:w3")
    return ffn(full, x, gated)


def mixer_in(x: torch.Tensor, shard, wsp_seq: int | None, tag: str) -> torch.Tensor:
    """A mixer's input on a model axis: the zone's ``wsp_seq`` positions
    gathered (the gradient arriving is a part on each rank, reduce-scattered
    back), or the replicated input whose gradient each rank's columns hold a
    part of (summed over the ranks)."""
    if shard is None:
        return x
    if wsp_seq is not None:
        return gather(shard.comm, x, dim=1, tag=tag, grad="sum")[:, :wsp_seq]
    return copy_to(shard.comm, x, tag=tag)


def mixer_out(part: torch.Tensor, shard, wsp_seq: int | None, tag: str, dtype) -> torch.Tensor:
    """A row-parallel product's partial sums [B, S, d] added over the ranks:
    all of them (ISP), or the rank's positions of the sequence padded to m
    chunks (WSP, reduce-scattered)."""
    if wsp_seq is None:
        return sum_over(shard.comm, part, tag=tag).to(dtype)
    return scatter_sum(shard.comm, shard.pad_seq(part), dim=1, tag=tag).to(dtype)
