"""Public selective-scan entry: the CUDA kernels on the card, the plain
PyTorch version on the CPU."""
from __future__ import annotations

import torch

from .kernel import mamba_scan_bwd_kernel, mamba_scan_kernel
from .ref import mamba_scan_ref


class _MambaScan(torch.autograd.Function):
    """Forward through the forward kernel, backward through the backward
    kernel; nothing in between runs the plain version.  ``keep`` (a
    gradient will be asked for) makes the forward keep what the backward
    takes: its inputs and the chunk states.  A cotangent autograd does not
    materialise (h_last's, in training) is a zero one."""

    @staticmethod
    def forward(ctx, dt, x, A, Bc, Cc, D, keep):
        ctx.set_materialize_grads(False)
        if not keep:
            return mamba_scan_kernel(dt, x, A, Bc, Cc, D)
        y, h_last, states = mamba_scan_kernel(dt, x, A, Bc, Cc, D, with_states=True)
        ctx.save_for_backward(dt, x, A, Bc, Cc, D, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, x, A, Bc, Cc, D, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = mamba_scan_bwd_kernel(dt, x, A, Bc, Cc, D, states, dy, dh_last)
        return *grads, None


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dt, x [B,S,di]; A [di,N]; Bc, Cc [B,S,N]; D [di] ->
    (y [B,S,di], h_last [B,di,N]), fp32, from a zero state.

    A CPU tensor goes to :func:`mamba_scan_ref` (differentiated by
    autograd); any other goes to the kernels, which launch or raise (there
    is no fallback to the plain version): the forward kernel, and the
    backward kernel when a gradient flows back through the call.  A meta
    tensor takes the kernels' route too, which allocates and launches
    nothing.  The reference's ``block_d`` and ``chunk`` are tiling choices
    that do not change the result; the kernels' are fixed, and they take any
    ``S``.
    """
    if x.device.type == "cpu":
        return mamba_scan_ref(dt, x, A, Bc, Cc, D)
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, A, Bc, Cc, D))
    return _MambaScan.apply(dt, x, A, Bc, Cc, D, keep)
