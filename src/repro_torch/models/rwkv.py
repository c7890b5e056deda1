"""RWKV-6 ("Finch") block (PyTorch port of ``repro/models/rwkv.py``).

Per head, the WKV state S [hd, hd] evolves as
    out_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + lora(x~_t))) computed from the input.  Prefill runs
the scan through :func:`repro_torch.kernels.rwkv6.ops.wkv6` -- the
hand-written CUDA kernel on the card, its plain version on the CPU -- from a
zero state; a step with a state (decode) is plain tensor code, as the
reference's ``lax.scan`` is.  The same simplification as the reference:
static token-shift mixes (mu), the full data-dependent decay LoRA.

State cache: {"S": [B, H, hd, hd] fp32, "shift": [B, 1, d], "shift_ffn": [B, 1, d]}.

On a model axis (``shard``, a :class:`~repro_torch.runtime.sharding.RankShard`)
a rank holds whole heads: ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``w_lora_b``
and ``cm_r`` columns of its heads, ``cm_k`` its FFN columns, ``wo`` and
``cm_v`` their rows, ``u`` and ``S`` its heads; ``mu``, ``w0``,
``w_lora_a`` and ``ln_x`` whole (the reference's specs replicate them; each
rank slices or uses them on its heads, so their gradients are a part on
each rank, which the train step sums).  The time mix ends in ``wo``'s
partial sums added over the ranks; the channel mix's ``r * v`` needs ``v``
whole on the rank's columns: its partial sums are reduce-scattered over the
features, multiplied by the rank's ``r`` and all-gathered (an all-reduce's
bytes).  ``wsp_seq`` (a WSP zone of that many positions): the input is the
rank's positions; the mixer gathers the zone's positions (a recurrence
needs every earlier position), runs the same form on the real ones (the
padding left out, so the arithmetic is the ISP form's) and hands back the
rank's positions (a reduce-scatter over the padded sequence, or the
rank's rows of the gathered channel mix).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6.ops import wkv6
from ..runtime.collectives import gather, scatter_sum
from .config import ModelConfig
from .layers import dense, dense_fp32, mixer_in, mixer_out


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} (prev fills t=0).  x [B,S,d], prev [B,1,d]."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def wkv_scan(r, k, v, w, u, S0):
    """r,k,v [B,S,H,hd]; w decay in (0,1) [B,S,H,hd]; S0 [B,H,hd,hd].

    Returns (out [B,S,H,hd], S_last).  fp32 throughout.
    """
    state = S0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t], state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def rwkv_time_mix(params, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None,
                  shard=None, tag: str = "", wsp_seq: int | None = None):
    """x [B,S,d] -> (out [B,S,d], {"S", "shift"}).  ``state=None`` is prefill
    from a zero state (through the kernel); otherwise the scan starts from
    ``state["S"]`` and ``state["shift"]``.  With a ``shard``, this rank's
    heads (module docstring)."""
    dtype = x.dtype
    x = mixer_in(x, shard, wsp_seq, f"{tag}:tm_in")
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    dl = params["wr"].shape[1]              # the columns of this rank's heads
    H = dl // hd
    c0 = 0 if shard is None else shard.r * dl
    prev = state["shift"] if state is not None else x.new_zeros(B, 1, d)
    xs = _shift(x, prev)
    mu = params["mu"]
    xr, xk, xv, xg, xw = (_mix(x, xs, mu[i]) for i in range(5))
    r = dense(xr, params["wr"]).float().reshape(B, S, H, hd)
    k = dense(xk, params["wk"]).float().reshape(B, S, H, hd)
    v = dense(xv, params["wv"]).float().reshape(B, S, H, hd)
    g = dense(xg, params["wg"])
    # data-dependent decay (the RWKV-6 core): log w = -exp(w0 + lora(x))
    dw = dense(torch.tanh(dense(xw, params["w_lora_a"])), params["w_lora_b"])
    logw = -torch.exp(params["w0"][c0:c0 + dl] + dw.float()).reshape(B, S, H, hd)
    if state is None:
        # [B,S,H,hd] -> [B,H,S,hd] as strided views; the kernel's out has r's
        # strides, so the transpose back is contiguous again.
        out, S_last = wkv6(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           logw.transpose(1, 2), params["u"])
        out = out.transpose(1, 2)
    else:
        out, S_last = wkv_scan(r, k, v, torch.exp(logw), params["u"], state["S"])
    # group norm per head (approximated by rmsnorm over hd)
    var = torch.mean(out * out, dim=-1, keepdim=True)
    out = out * torch.rsqrt(var + 1e-5) * (1.0 + params["ln_x"][c0:c0 + dl].reshape(H, hd))
    out = out.reshape(B, S, dl).to(dtype) * F.silu(g)
    st = {"S": S_last, "shift": x[:, -1:]}
    if shard is None:
        return dense(out, params["wo"]), st
    return mixer_out(dense_fp32(out, params["wo"]), shard, wsp_seq, f"{tag}:tm", dtype), st


def rwkv_channel_mix(params, x: torch.Tensor, state: dict | None = None, shard=None,
                     tag: str = "", wsp_seq: int | None = None):
    """x [B,S,d] -> (out [B,S,d], {"shift_ffn"}).  With a ``shard``, this
    rank's columns (module docstring)."""
    x = mixer_in(x, shard, wsp_seq, f"{tag}:cm_in")
    B, S, d = x.shape
    prev = state["shift_ffn"] if state is not None else x.new_zeros(B, 1, d)
    xs = _shift(x, prev)
    xk = _mix(x, xs, 0.5)
    r = torch.sigmoid(dense(xk, params["cm_r"]))
    k = torch.square(F.relu(dense(xk, params["cm_k"])))
    st = {"shift_ffn": x[:, -1:]}
    if shard is None:
        return r * dense(k, params["cm_v"]), st
    comm = shard.comm
    v = scatter_sum(comm, dense_fp32(k, params["cm_v"]), dim=-1, tag=f"{tag}:cm_v").to(x.dtype)
    if wsp_seq is None:
        return gather(comm, r * v, dim=-1, tag=f"{tag}:cm", grad="own"), st
    return shard.own_positions(gather(comm, r * v, dim=-1, tag=f"{tag}:cm")), st
