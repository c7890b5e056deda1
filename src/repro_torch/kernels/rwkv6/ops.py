"""Public WKV-6 entry: the CUDA kernels on the card, the plain PyTorch
version on the CPU."""
from __future__ import annotations

import torch

from .kernel import wkv6_bwd_kernel, wkv6_kernel
from .ref import wkv6_ref


class _WKV6(torch.autograd.Function):
    """Forward through the forward kernel, backward through the backward
    kernel; nothing in between runs the plain version.  ``keep`` (a
    gradient will be asked for) makes the forward keep what the backward
    takes: its inputs and the segments' input states.  A cotangent autograd
    does not materialise (S_last's, in training) is a zero one."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, keep):
        ctx.set_materialize_grads(False)
        if not keep:
            return wkv6_kernel(r, k, v, logw, u)
        out, s_last, seg_state = wkv6_kernel(r, k, v, logw, u, with_states=True)
        ctx.save_for_backward(r, k, v, logw, u, seg_state)
        return out, s_last

    @staticmethod
    def backward(ctx, dout, ds_last):
        r, k, v, logw, u, seg_state = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        grads = wkv6_bwd_kernel(r, k, v, logw, u, seg_state, dout, ds_last)
        return *grads, None


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw [B,H,S,hd], u [H,hd] -> (out [B,H,S,hd], S_last [B,H,hd,hd]), fp32.

    A CPU tensor goes to :func:`wkv6_ref` (differentiated by autograd); any
    other goes to the kernels, which launch or raise (there is no fallback
    to the plain version): the forward kernel, and the backward kernel
    when a gradient flows back through the call.  A meta tensor takes the
    kernels' route too, which allocates and launches nothing.  The
    reference's ``chunk`` is a tiling choice that does not change the
    result (its chunk-invariance test); the kernel's chunk is fixed at 32
    tokens.
    """
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u)
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u))
    return _WKV6.apply(r, k, v, logw, u, keep)
