"""Decoder LM: embed -> blocks -> final norm -> logits (port of ``repro/models/model.py``).

Layers run in a Python loop (the reference scans over pattern repeats with
stacked params).  Layer ``l`` is pattern slot ``l % P`` of repeat ``l // P``;
caches keep the reference's stacked layout, one dict of ``[R, ...]`` tensors
per pattern slot: ``{"k", "v"}`` of ``[R, B, T, KV, hd]`` for attention,
``{"S", "shift", "shift_ffn"}`` for rwkv, ``{"h", "conv"}`` for mamba.

On a mesh (``runtime/sharding.shard_model``) a model holds one rank's
pieces and a ``shard`` (:class:`~repro_torch.runtime.sharding.RankShard`);
it takes the global inputs, keeps its batch rows, and on a model axis runs
the reference's zones rank-locally where the reference runs its layers
under two sharding constraints (``constrain`` / ``constrain2`` at
``transition_repeat``): each layer under its zone's partition, ISP or WSP,
with a transition between the two, and vocab-sharded logits.  The mesh
prefill differentiates (the train step on a mesh): each collective's
transpose is written out in ``runtime/collectives.py``, the blocks run
under ``torch.utils.checkpoint`` with ``cfg.remat`` as on one rank, and
:func:`loss_fn` takes the NLL over the vocab-sharded logits without
gathering the vocabulary.

``attn``, ``local`` and ``mamba`` blocks take a dense or an MoE FFN (MoE on
the layers ``cfg.is_moe_block`` names; on a mesh, a data-only one too, the
rank's block of the dispatch groups, ``models/moe.py``); ``rwkv`` blocks carry their own
channel mix.  The frontend stubs stand in for an encoder (SigLIP, EnCodec)
as in the reference: ``audio_stub`` prefills take frame embeddings and no
tokens, ``vision_stub`` prefills take patch embeddings placed ahead of the
text tokens; decode embeds tokens for both.

On a model axis every block kind runs rank-locally: attention and the FFN
as ``models/attention.py`` and ``layers.py`` say; a recurrent mixer (rwkv's
time and channel mix, mamba's) on the rank's heads or channels, and in a
WSP zone on the zone's positions gathered (``models/rwkv.py``,
``models/ssm.py``).  The paper's weight-gathered WSP recurrence, each
rank's state handed on to the next, is not built (ROADMAP).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from .. import tree as pytree
from ..device import resolve_device
from ..runtime.collectives import copy_to, scatter_sum, sum_over
from .attention import (attention_decode, attention_decode_heads, attention_decode_mesh,
                        attention_prefill, attention_prefill_isp, attention_prefill_wsp,
                        runs_from_offsets)
from .config import ModelConfig
from .layers import dense, embed, ffn, ffn_isp, ffn_wsp, rmsnorm, softcap
from .moe import moe_ffn
from .rwkv import rwkv_channel_mix, rwkv_time_mix
from .ssm import mamba_decode, mamba_prefill


FRONTENDS = ("none", "audio_stub", "vision_stub")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a frontend or block kind the model has no code for."""
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r}")
    for kind in cfg.block_pattern:
        if kind not in _BLOCKS:
            raise ValueError(kind)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(params: dict) -> nn.ParameterDict:
    return nn.ParameterDict({n: _frozen(t) for n, t in params.items()})


class _FfnBlock(nn.Module):
    """Pre-norm mixer (the subclass's) then a dense or MoE FFN, chosen by
    which leaf the block's params hold (``"ffn"`` or ``"moe"``)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(params["ln1"])
        self.ln2 = _frozen(params["ln2"])
        self.moe = _frozen_dict(params["moe"]) if "moe" in params else None
        self.ffn = None if self.moe is not None else _frozen_dict(params["ffn"])

    def _ffn(self, x: torch.Tensor, shard=None, tag: str = "") -> torch.Tensor:
        """The FFN of one rank, or of a rank of a data-only mesh (``shard``:
        its MoE takes its block of the global dispatch groups)."""
        h2 = rmsnorm(x, self.ln2, self.cfg.norm_eps)
        if self.moe is not None:
            return x + moe_ffn(self.moe, h2, self.cfg, shard, tag=tag)
        return x + ffn(self.ffn, h2, self.cfg.ffn_gated)

    def _ffn_mesh(self, x: torch.Tensor, partition: str, shard, tag: str,
                  seq: int | None = None) -> torch.Tensor:
        """The FFN on a model axis: ``x`` the whole sequence (ISP) or this
        rank's positions of ``seq`` (WSP)."""
        h2 = rmsnorm(x, self.ln2, self.cfg.norm_eps)
        if self.moe is not None:
            return x + moe_ffn(self.moe, h2, self.cfg, shard, seq if partition == "WSP" else None,
                               tag)
        mlp = ffn_isp if partition == "ISP" else ffn_wsp
        return x + mlp(self.ffn, h2, self.cfg.ffn_gated, shard, tag)


class AttnBlock(_FfnBlock):
    """Pre-norm attention block."""

    def __init__(self, cfg: ModelConfig, kind: str, params: dict):
        super().__init__(cfg, params)
        self.window = cfg.window if kind == "local" else 0
        self.attn = _frozen_dict(params["attn"])

    def prefill(self, x, positions, plain_attention=False, from_offsets=None, shard=None,
                tag=""):
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        a, (k, v) = attention_prefill(self.attn, h, self.cfg, positions, self.window,
                                      plain=plain_attention, from_offsets=from_offsets)
        return self._ffn(x + a, shard, tag), {"k": k, "v": v}

    def decode(self, x, position, cache, shard=None, tag=""):
        """``cache``: this layer's ``{"k", "v"}`` [B, T, KV, hd], written in place."""
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        a, _ = attention_decode(self.attn, h, self.cfg, cache["k"], cache["v"], position,
                                self.window)
        return self._ffn(x + a, shard, tag)

    def prefill_mesh(self, x, partition, shard, plain_attention=False, tag="", seq=None):
        """One rank's layer on a model axis: ``x`` is the whole sequence
        under ISP, this rank's positions under WSP (of ``seq``)."""
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        attend = attention_prefill_isp if partition == "ISP" else attention_prefill_wsp
        x = x + attend(self.attn, h, self.cfg, shard, self.window, plain_attention, tag)
        return self._ffn_mesh(x, partition, shard, tag, seq)

    def decode_mesh(self, x, position, cache, shard, tag=""):
        """One rank's decode step of the layer (ISP; the cache sharded on
        time, or whole over time on the rank's kv heads)."""
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        attend = (attention_decode_mesh if shard.plan.shard_kv_cache_time
                  else attention_decode_heads)
        x = x + attend(self.attn, h, self.cfg, cache["k"], cache["v"], position, shard,
                       self.window, tag)
        return self._ffn_mesh(x, "ISP", shard, tag)


class RwkvBlock(nn.Module):
    """Pre-norm RWKV-6 block: time mix, then channel mix (both in ``rwkv``)."""

    def __init__(self, cfg: ModelConfig, kind: str, params: dict):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(params["ln1"])
        self.ln2 = _frozen(params["ln2"])
        self.rwkv = _frozen_dict(params["rwkv"])

    def _run(self, x, state, shard=None, tag="", wsp_seq=None):
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        a, st = rwkv_time_mix(self.rwkv, h, self.cfg, state, shard, tag, wsp_seq)
        x = x + a
        h2 = rmsnorm(x, self.ln2, self.cfg.norm_eps)
        f, st2 = rwkv_channel_mix(self.rwkv, h2, state, shard, tag, wsp_seq)
        return x + f, {**st, **st2}

    def prefill(self, x, positions, plain_attention=False, from_offsets=None, shard=None,
                tag=""):
        return self._run(x, None)          # position-free, as in the reference

    def decode(self, x, position, cache, shard=None, tag=""):
        """``cache``: this layer's ``{"S", "shift", "shift_ffn"}``, written in place."""
        x, st = self._run(x, cache)
        for n, t in st.items():
            cache[n].copy_(t)
        return x

    def prefill_mesh(self, x, partition, shard, plain_attention=False, tag="", seq=None):
        """One rank's layer on a model axis: its heads, on the whole
        sequence ``x`` (ISP) or on the zone's ``seq`` positions gathered
        from this rank's (WSP)."""
        return self._run(x, None, shard, tag, seq if partition == "WSP" else None)[0]

    def decode_mesh(self, x, position, cache, shard, tag=""):
        """One rank's decode step: its heads of ``S``, the shifts whole."""
        x, st = self._run(x, cache, shard, tag)
        for n, t in st.items():
            cache[n].copy_(t)
        return x


class MambaBlock(_FfnBlock):
    """Pre-norm Mamba-1 block (``ssm``)."""

    def __init__(self, cfg: ModelConfig, kind: str, params: dict):
        super().__init__(cfg, params)
        self.mamba = _frozen_dict(params["mamba"])

    def prefill(self, x, positions, plain_attention=False, from_offsets=None, shard=None,
                tag=""):
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        a, st = mamba_prefill(self.mamba, h, self.cfg)     # position-free
        return self._ffn(x + a, shard, tag), st

    def decode(self, x, position, cache, shard=None, tag=""):
        """``cache``: this layer's ``{"h", "conv"}``, written in place."""
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        a, st = mamba_decode(self.mamba, h, self.cfg, cache)
        for n, t in st.items():
            cache[n].copy_(t)
        return self._ffn(x + a, shard, tag)

    def prefill_mesh(self, x, partition, shard, plain_attention=False, tag="", seq=None):
        """One rank's layer on a model axis: its channels, on the whole
        sequence ``x`` (ISP) or on the zone's ``seq`` positions gathered
        from this rank's (WSP); then the FFN under the partition."""
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        a, _ = mamba_prefill(self.mamba, h, self.cfg, shard, tag,
                             seq if partition == "WSP" else None)
        return self._ffn_mesh(x + a, partition, shard, tag, seq)

    def decode_mesh(self, x, position, cache, shard, tag=""):
        """One rank's decode step: its channels of ``h`` and ``conv``."""
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        a, st = mamba_decode(self.mamba, h, self.cfg, cache, shard, tag)
        for n, t in st.items():
            cache[n].copy_(t)
        return self._ffn_mesh(x + a, "ISP", shard, tag)


_BLOCKS = {"attn": AttnBlock, "local": AttnBlock, "rwkv": RwkvBlock, "mamba": MambaBlock}


class DecoderLM(nn.Module):
    """Parameters in the reference's leaf layout (``[d_in, d_out]`` weights).

    Built frozen (``requires_grad=False``), as serving wants it;
    :meth:`train_params` makes every parameter trainable.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kinds = cfg.block_kinds()
        self.embed = _frozen(params["embed"])
        self.blocks = nn.ModuleList(
            _BLOCKS[kind](cfg, kind, bp) for kind, bp in zip(kinds, params["blocks"], strict=True)
        )
        self.final_ln = _frozen(params["final_ln"])
        self.lm_head = None if cfg.tie_embeddings else _frozen(params["lm_head"])
        self.shard = None     # a rank's placement on a mesh (runtime/sharding.shard_model)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def train_params(self) -> "DecoderLM":
        """Make every parameter trainable (in place); returns the model."""
        for p in self.parameters():
            p.requires_grad_(True)
        return self

    def param_tree(self) -> dict:
        """The reference's parameter pytree over this model's tensors:
        ``{"blocks": (slot dicts...), "embed", "final_ln"[, "lm_head"]}``,
        where each leaf under ``blocks`` is a :class:`~repro_torch.tree.Stacked` of the slot's
        R per-layer tensors (the reference's ``[R, ...]`` leaf) and every
        other leaf is the parameter itself."""
        P = len(self.cfg.expanded_pattern)
        blocks = []
        for pi in range(P):
            layers = [self.blocks[li] for li in range(pi, self.cfg.n_layers, P)]
            tree: dict = {}
            for name, _ in layers[0].named_parameters():
                *outer, leaf = name.split(".")
                node = tree
                for key in outer:
                    node = node.setdefault(key, {})
                node[leaf] = pytree.Stacked([layer.get_parameter(name) for layer in layers])
            blocks.append(tree)
        tree = {"blocks": tuple(blocks), "embed": self.embed, "final_ln": self.final_ln}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        return tree

    def unused_by_prefill(self) -> list[nn.Parameter]:
        """Parameters with no path from a prefill's inputs to its logits: the
        audio stub's embedding table when the head is not tied to it (decode
        embeds tokens with it; the prefill takes frames)."""
        if self.cfg.frontend == "audio_stub" and not self.cfg.tie_embeddings:
            return [self.embed]
        return []

    def flat_params(self) -> list[nn.Parameter]:
        """Every parameter, one tensor per layer, in the order of
        :meth:`param_tree`'s leaves (the order the train step differentiates
        and the optimizers walk)."""
        return [t for leaf in pytree.leaves(self.param_tree()) for t in pytree.leaf_layers(leaf)]

    def _logits(self, x: torch.Tensor, head_in=None) -> torch.Tensor:
        x = rmsnorm(x, self.final_ln, self.cfg.norm_eps)
        if head_in is not None:
            x = head_in(x)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return softcap(dense(x, head).float(), self.cfg.logit_softcap)

    def embed_inputs(self, tokens: torch.Tensor | None,
                     frontend_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """The first hidden state [B, S, d]: ``audio_stub`` takes the frame
        embeddings [B, S, d] (cast to the parameter dtype) and no tokens;
        ``vision_stub`` puts the patch embeddings [B, P, d] (cast to the
        token embeddings' dtype) ahead of the embedded tokens [B, S - P]."""
        frontend = self.cfg.frontend
        if frontend == "none":
            return embed(tokens, self.embed)
        if frontend_embeds is None:
            raise ValueError(f"{self.cfg.name}: the {frontend} prefill takes frontend_embeds")
        if frontend == "audio_stub":
            return frontend_embeds.to(getattr(torch, self.cfg.param_dtype))
        t_emb = embed(tokens, self.embed)
        return torch.cat([frontend_embeds.to(t_emb.dtype), t_emb], dim=1)

    def forward(self, tokens: torch.Tensor | None,
                frontend_embeds: torch.Tensor | None = None, collect_cache: bool = False,
                positions: torch.Tensor | None = None, plain_attention: bool = False):
        """tokens [B,S] -> (logits [B,S,padded_vocab] fp32, caches or None).

        The frontend stubs take ``frontend_embeds`` (:meth:`embed_inputs`);
        their logits cover every position, patches included.
        ``positions=None`` is ``0..S-1`` per row; on the card explicit
        positions must run ``p0 + 0..S-1`` in each row (see
        :func:`attention_prefill`).  rwkv blocks take no
        positions, as in the reference.  With ``cfg.remat`` and autograd
        recording, each block runs under ``torch.utils.checkpoint`` (the
        reference's ``jax.checkpoint`` of its scanned body): its activations
        are recomputed in the backward pass.  ``plain_attention`` runs
        attention through the plain version on any device; it exists for the
        checks that hold the kernels against it, not for use.
        """
        sh = self.shard
        if sh is not None:
            tokens, frontend_embeds, positions = (sh.rows(t) for t in
                                                  (tokens, frontend_embeds, positions))
            if sh.m > 1:
                return self._forward_mesh(tokens, frontend_embeds, collect_cache, positions,
                                          plain_attention)
        P = len(self.cfg.expanded_pattern)
        x = self.embed_inputs(tokens, frontend_embeds)
        # one test (one host sync on the card) for every attention layer
        from_offsets = None if positions is None else runs_from_offsets(positions)
        per_slot = [[] for _ in range(P)]
        remat = self.cfg.remat and torch.is_grad_enabled() and not collect_cache
        for layer, blk in enumerate(self.blocks):
            if remat:   # on a data-only mesh the whole block again, its collectives too
                with set_checkpoint_early_stop(sh is None):
                    x, cache = checkpoint(blk.prefill, x, positions, plain_attention,
                                          from_offsets, sh, f"blk{layer}", use_reentrant=False)
            else:
                x, cache = blk.prefill(x, positions, plain_attention, from_offsets, sh,
                                       f"blk{layer}")
            if collect_cache:
                per_slot[layer % P].append(cache)
        caches = None
        if collect_cache:
            caches = tuple(
                {n: torch.stack([c[n] for c in slot]) for n in slot[0]}
                for slot in per_slot
            )
        return self._logits(x), caches

    def _embed_mesh(self, tokens, partition: str, frontend_embeds=None) -> torch.Tensor:
        """The first hidden state on a model axis, in ``partition``'s layout:
        each rank looks up the tokens in its vocab rows (zeros elsewhere) and
        the ranks add them, by all-reduce, or by reduce-scatter over the
        sequence into a WSP zone's positions (whose gradient is all-gathered
        back; the all-reduce's passes through).  A prefill's frontend
        embeddings are the same on every rank and need no collective: the
        audio stub's frames are the hidden state, the vision stub's patches
        go ahead of the summed tokens (in a WSP zone, the rank's positions
        of both)."""
        sh = self.shard
        frontend = self.cfg.frontend if frontend_embeds is not None else "none"
        if frontend == "audio_stub":
            x = frontend_embeds.to(getattr(torch, self.cfg.param_dtype))
            return sh.own_positions(x) if partition == "WSP" else x
        lo, hi = sh.vocab
        inside = (tokens >= lo) & (tokens < hi)
        part = self.embed[(tokens - lo).clamp(0, hi - lo - 1)] * inside[..., None]
        if frontend == "vision_stub":
            patches = frontend_embeds.to(part.dtype)
            if partition == "WSP":
                lead = torch.cat([torch.zeros_like(patches), part], dim=1)
                ahead = torch.cat([patches, torch.zeros_like(part)], dim=1)
                return (scatter_sum(sh.comm, sh.pad_seq(lead), dim=1, tag="embed")
                        + sh.own_positions(ahead))
            return torch.cat([patches, sum_over(sh.comm, part, tag="embed")], dim=1)
        if partition == "WSP":
            return scatter_sum(sh.comm, sh.pad_seq(part), dim=1, tag="embed")
        return sum_over(sh.comm, part, tag="embed")

    def _forward_mesh(self, tokens, frontend_embeds, collect_cache, positions, plain_attention):
        """The prefill of one rank of a model axis: zone by zone, each layer
        under its partition; WSP -> ISP all-gathers the sequence (the
        transition: the ISP zone's gradient is the same on every rank, so
        its transpose keeps the rank's positions), and a WSP last zone
        gathers it before the head (whose gradient is vocab-partial: its
        transpose reduce-scatters).  After an ISP last zone the head's
        input gradient is summed over the ranks.  With ``cfg.remat`` and
        autograd recording each block runs under ``torch.utils.checkpoint``;
        its recompute issues its collectives again."""
        if collect_cache or positions is not None:
            raise NotImplementedError(
                "a mesh prefill collects no caches and takes no explicit positions (the "
                "reference's prefill step collects none); shard a one-rank prefill's caches "
                "with runtime.sharding.shard_caches")
        if self.cfg.frontend != "none" and frontend_embeds is None:
            raise ValueError(f"{self.cfg.name}: the {self.cfg.frontend} prefill takes "
                             "frontend_embeds")
        sh = self.shard
        S = (frontend_embeds.shape[1] if self.cfg.frontend == "audio_stub" else
             tokens.shape[1] + (0 if frontend_embeds is None else frontend_embeds.shape[1]))
        current = sh.plan.p1                 # the reference constrains the embedding in zone 1
        x = self._embed_mesh(tokens, current, frontend_embeds)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer, blk in enumerate(self.blocks):
            partition = sh.partition(layer)
            if partition != current:
                x = (sh.gather_seq(x, S, "transition") if current == "WSP"
                     else sh.seq_shard(x))
                current = partition
            if remat:      # the whole block again, so its collectives run twice
                with set_checkpoint_early_stop(False):
                    x = checkpoint(blk.prefill_mesh, x, partition, sh, plain_attention,
                                   f"blk{layer}", S, use_reentrant=False)
            else:
                x = blk.prefill_mesh(x, partition, sh, plain_attention, f"blk{layer}", S)
        if current == "WSP":
            return self._logits(sh.gather_seq(x, S, "logits", grad="sum")), None
        return self._logits(x, lambda h: copy_to(sh.comm, h, tag="head_in")), None

    def init_kv_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """Zero caches of a ``batch`` x ``max_len`` decode; on a mesh this
        rank's pieces of them (its batch rows; on a model axis as
        ``runtime.sharding.shard_caches`` cuts them: its block of the time
        axis, ``max_len`` over the model ranks rounded up, or its kv heads
        over the whole time; its rwkv heads, its mamba channels)."""
        sh = self.shard
        if sh is None:
            return init_kv_cache(self.cfg, batch, max_len, dtype, self.device)
        rows = batch // sh.dp
        if rows * sh.dp != batch:
            raise ValueError(f"batch {batch} does not split over the {sh.dp} data ranks")
        return init_kv_cache(self.cfg, rows, max_len, dtype, self.device,
                             shard=sh if sh.m > 1 else None)

    def decode_step(self, token: torch.Tensor, position: torch.Tensor, caches: tuple):
        """One autoregressive step: token [B,1], position [B] write index.

        Returns (logits [B,1,padded_vocab], caches); ``caches`` is updated in
        place and returned (the reference returns new, donated buffers).  Each
        layer gets its own slice ``[r]`` of its slot's stacked state.
        """
        P = len(self.cfg.expanded_pattern)
        sh = self.shard
        if sh is not None:
            token, position = sh.rows(token), sh.rows(position)
            if sh.m > 1:
                x = self._embed_mesh(token, "ISP")          # decode: the ISP zone
                for layer, blk in enumerate(self.blocks):
                    r, pi = divmod(layer, P)
                    x = blk.decode_mesh(x, position, {n: t[r] for n, t in caches[pi].items()},
                                        sh, f"blk{layer}")
                return self._logits(x), caches
        x = embed(token, self.embed)
        for layer, blk in enumerate(self.blocks):
            r, pi = divmod(layer, P)
            x = blk.decode(x, position, {n: t[r] for n, t in caches[pi].items()}, sh,
                           f"blk{layer}")
        return self._logits(x), caches


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device: str | torch.device = "cuda") -> DecoderLM:
    """Random model with the reference's init scales, drawn from ``generator``
    (on its own device) and stored on ``device`` in ``cfg.param_dtype``
    (``w0``, ``u``, ``A_log``, ``D``, the MoE router and the norm weights in
    fp32, as in the reference).

    On ``device="meta"`` (the dry-run) the leaves have their names, shapes
    and dtypes and no values, and nothing is drawn: ``generator`` is then
    ``None``, and only then."""
    check_supported(cfg)
    dev = resolve_device(device)
    if (generator is None) != (dev.type == "meta"):
        raise ValueError(f"generator {generator} on device {dev}: a meta model draws "
                         "nothing (generator=None), any other needs a generator")
    dtype = getattr(torch, cfg.param_dtype)
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def normal(shape, scale, dt=dtype):
        if generator is None:
            return torch.empty(shape, dtype=dt, device=dev)
        # scaled in place: one fp32 temporary at a time (llama4's fp32 expert
        # weights are 21 GB a leaf)
        t = torch.randn(shape, generator=generator, device=generator.device)
        return t.mul_(scale).to(dev, dt)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def ffn_block(layer):                  # scales of init_ffn / init_moe
        if cfg.is_moe_block(layer):
            E, eff = cfg.moe.n_experts, cfg.moe.d_ff or ff
            moe = {"router": normal((d, E), d ** -0.5, torch.float32),
                   "w1": normal((E, d, eff), d ** -0.5), "w2": normal((E, eff, d), eff ** -0.5)}
            if cfg.ffn_gated:
                moe["w3"] = normal((E, d, eff), d ** -0.5)
            return {"moe": moe}
        ffn_p = {"w1": normal((d, ff), d ** -0.5), "w2": normal((ff, d), ff ** -0.5)}
        if cfg.ffn_gated:
            ffn_p["w3"] = normal((d, ff), d ** -0.5)
        return {"ffn": ffn_p}

    def attn_block():
        return {"attn": {"wq": normal((d, H * hd), d ** -0.5),
                         "wk": normal((d, KV * hd), d ** -0.5),
                         "wv": normal((d, KV * hd), d ** -0.5),
                         "wo": normal((H * hd, d), (H * hd) ** -0.5)}}

    def mamba_block():                     # scales of the reference's init_mamba
        di, N, dc = cfg.mamba_expand * d, cfg.mamba_d_state, cfg.mamba_d_conv
        R = max(1, d // 16)                # dt_rank
        return {"mamba": {
            "in_proj": normal((d, 2 * di), d ** -0.5),
            "conv_w": normal((dc, di), 0.2),
            "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
            "x_proj": normal((di, R + 2 * N), di ** -0.5),
            "dt_proj": normal((R, di), R ** -0.5),
            "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=dev),  # softplus^-1(0.01)
            "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)
                               ).repeat(di, 1),
            "D": full((di,), 1.0),
            "out_proj": normal((di, d), di ** -0.5),
        }}

    def rwkv_block():                      # scales of the reference's init_rwkv
        rhd, lora, s = cfg.rwkv_head_dim, 64, d ** -0.5
        mu = (torch.empty((5, d), device=dev) if generator is None
              else torch.rand((5, d), generator=generator, device=generator.device))
        return {"rwkv": {
            "mu": mu.to(dev, dtype),
            "wr": normal((d, d), s), "wk": normal((d, d), s), "wv": normal((d, d), s),
            "wg": normal((d, d), s), "wo": normal((d, d), s),
            "w0": full((d,), -2.0),
            "w_lora_a": normal((d, lora), s), "w_lora_b": normal((lora, d), lora ** -0.5),
            "u": normal((d // rhd, rhd), 0.1, torch.float32),
            "ln_x": full((d,), 0.0),
            "cm_r": normal((d, d), s), "cm_k": normal((d, ff), s),
            "cm_v": normal((ff, d), ff ** -0.5),
        }}

    mixers = {"attn": attn_block, "local": attn_block, "mamba": mamba_block,
              "rwkv": rwkv_block}
    blocks = [{"ln1": full((d,), 0.0), "ln2": full((d,), 0.0), **mixers[kind](),
               **({} if kind == "rwkv" else ffn_block(layer))}
              for layer, kind in enumerate(cfg.block_kinds())]
    params = {"embed": normal((cfg.padded_vocab, d), d ** -0.5), "blocks": blocks,
              "final_ln": full((d,), 0.0)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.padded_vocab), d ** -0.5)
    return DecoderLM(cfg, params)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device: str | torch.device = "cuda", shard=None) -> tuple:
    """Zero caches, one dict per pattern slot: attention ``{"k", "v"}`` of
    ``[R, batch, max_len, KV, hd]`` in ``dtype``; rwkv ``{"S"}`` of
    ``[R, batch, H, hd, hd]`` in fp32 and ``{"shift", "shift_ffn"}`` of
    ``[R, batch, 1, d]`` in ``dtype``; mamba ``{"h"}`` of ``[R, batch,
    d_inner, N]`` in fp32 and ``{"conv"}`` of ``[R, batch, d_conv - 1,
    d_inner]`` in ``dtype``.  ``shard`` (a rank of a model axis): the
    rank's pieces of them (``runtime.sharding.shard_caches``)."""
    dev = resolve_device(device)
    R = cfg.pattern_repeats
    m = 1 if shard is None else shard.m

    def zeros(*shape, dt=dtype):
        return torch.zeros((R, batch, *shape), dtype=dt, device=dev)

    caches = []
    for kind in cfg.expanded_pattern:
        if kind == "rwkv":
            hd = cfg.rwkv_head_dim
            caches.append({"S": zeros(cfg.d_model // hd // m, hd, hd, dt=torch.float32),
                           "shift": zeros(1, cfg.d_model),
                           "shift_ffn": zeros(1, cfg.d_model)})
        elif kind == "mamba":
            di = cfg.mamba_expand * cfg.d_model // m
            caches.append({"h": zeros(di, cfg.mamba_d_state, dt=torch.float32),
                           "conv": zeros(cfg.mamba_d_conv - 1, di)})
        else:
            T, KV = max_len, cfg.n_kv_heads
            if shard is not None:
                T = shard.cache_len(max_len)
                KV = KV if shard.plan.shard_kv_cache_time else shard.n_kv_heads
            kv_shape = (T, KV, cfg.head_dim)
            caches.append({"k": zeros(*kv_shape), "v": zeros(*kv_shape)})
    return tuple(caches)


def forward(model: DecoderLM, tokens, frontend_embeds=None, collect_cache: bool = False,
            positions=None):
    """Functional spelling of :meth:`DecoderLM.forward` (the reference's name)."""
    return model(tokens, frontend_embeds, collect_cache=collect_cache, positions=positions)


def decode_step(model: DecoderLM, token, position, caches):
    """Functional spelling of :meth:`DecoderLM.decode_step`."""
    return model.decode_step(token, position, caches)


def loss_fn(model: DecoderLM, tokens: torch.Tensor | None, labels: torch.Tensor,
            frontend_embeds: torch.Tensor | None = None,
            plain_attention: bool = False) -> torch.Tensor:
    """Mean next-token NLL over the final ``labels.shape[1]`` positions (a
    frontend stub's positions ahead of them are unlabeled).

    On a mesh (a rank's shard) the inputs are global and the mean runs over
    the rank's rows; on a model axis over the vocab-sharded logits
    (:func:`vocab_parallel_nll`)."""
    logits, _ = model(tokens, frontend_embeds, plain_attention=plain_attention)
    sh = model.shard
    if sh is not None:
        labels = sh.rows(labels)
    logits = logits[:, -labels.shape[1]:]
    if sh is not None and sh.m > 1:
        return vocab_parallel_nll(logits, labels, sh).mean()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, shard) -> torch.Tensor:
    """Each position's NLL over the padded vocabulary from this rank's
    ``[B, S, padded_vocab / m]`` columns: the row max, then the sum of
    exponentials and the label's logit, all-reduced over the model axis
    (never the vocabulary itself).  The sums' gradient passes through
    their all-reduce to each rank's columns."""
    comm = shard.comm
    lo, hi = shard.vocab
    with torch.no_grad():
        top = comm.all_reduce(logits.amax(dim=-1), op="max", tag="loss:max")
    sumexp = torch.exp(logits - top[..., None]).sum(dim=-1)
    inside = (labels >= lo) & (labels < hi)
    picked = torch.gather(logits, -1, (labels - lo).clamp(0, hi - lo - 1)[..., None])[..., 0]
    sums = sum_over(comm, torch.stack([sumexp, picked * inside]), tag="loss")
    return top + torch.log(sums[0]) - sums[1]
