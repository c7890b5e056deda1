"""Scope schedule -> per-rank placements (port of ``repro/runtime/sharding.py``).

The storage rule (paper SSIII-B, distributed weight buffering), as in the
reference: parameters are ALWAYS stored sharded over the ``model`` axis on
their heavy dimension.

* ISP layers compute on the shards: ``wq``/``wk``/``wv``/``w1``/``w3``
  column-parallel, ``wo``/``w2`` row-parallel, activations replicated over
  ``model``; each row-parallel product ends in an all-reduce.
* WSP layers keep activations sequence-sharded over ``model`` and
  all-gather the weights at use; attention's K/V gathers play the halo, so
  nothing is gathered or reduced on the residual.
* The WSP -> ISP transition (``ShardPlan.transition_repeat``) is an
  all-gather of the sequence-sharded activations.

The placement functions (:func:`param_pspecs`, :func:`opt_pspecs`,
:func:`cache_pspecs`, :func:`batch_pspecs`, :func:`zero_shard`,
:func:`sanitize_pspecs`) are the reference's, entry for entry, over
:class:`PartitionSpec` (which normalises its entries as jax's does); they
read only ``mesh.shape``.  GSPMD then partitions one program by them; the
port has no GSPMD, so :func:`shard_model` cuts a rank's pieces out of a
whole model and the model runs rank-locally under a :class:`RankShard`
(``models/model.py``), issuing its collectives itself
(``runtime/collectives.py``).  :func:`activation_pspec` is the counterpart
of ``make_constrain``: the layout a zone's activations take.

Where the port's execution differs in layout, not in result: GSPMD pads
dims a mesh axis does not divide; the port pads a WSP sequence to a
multiple of the model axis at its end (causal attention never lets a real
query see the padding) and a decode cache's time axis likewise.  Where the
reference splits inside a kv head (``model > n_kv_heads``), each rank holds
the whole kv heads its query heads need.  The rank-local execution covers
``attn`` / ``local`` blocks with a dense FFN and no frontend stub on a
model axis above 1, and every config but MoE on a data-only mesh; the rest
raises (ROADMAP A13c).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..models.config import ModelConfig
from ..models.model import DecoderLM
from ..optim.optimizers import OptState

WSP, ISP = "WSP", "ISP"


@dataclass(frozen=True)
class ShardPlan:
    """Execution plan for one (arch x shape x mesh) cell."""
    mesh_axes: tuple[str, ...]            # ("pod","data","model") | ("data","model")
    p1: str = ISP                         # zone-1 partition
    p2: str = ISP                         # zone-2 partition
    transition_repeat: int | None = None  # None -> single zone (p1)
    ep: bool = True                       # expert parallelism for MoE weights
    zero: bool = True                     # optimizer state sharded over data too
    shard_kv_cache_time: bool = True      # decode cache sharded over T
    use_dp: bool = True                   # False when batch < dp size (long_500k)
    # Pipeline stages of the Scope schedule behind this plan, as
    # (layer_lo, layer_hi, chip_type, region_chips) tuples.
    stage_chip_types: tuple[tuple[int, int, str | None, int], ...] = ()
    meta: dict = field(default_factory=dict, hash=False, compare=False)

    @property
    def dp(self):
        """Batch data-parallel axes."""
        if not self.use_dp:
            return ()
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))

    def zone_partition(self, zone: int) -> str:
        return self.p1 if zone == 1 else self.p2


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array, as ``jax.sharding.PartitionSpec``:
    an entry is ``None`` (replicated), an axis name, or a tuple of names; an
    empty tuple reads as ``None`` and a one-name tuple as the name."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else (e[0] if len(e) == 1 else e)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_specs(fn, tree, *rest):
    """``jax.tree.map`` with :class:`PartitionSpec` leaves: ``fn(leaf,
    *matching leaves of rest)`` over dicts, NamedTuples, tuples and lists."""
    if isinstance(tree, PartitionSpec):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_specs(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


# ------------------------------------------------------------- param specs

def _attn_specs(cfg: ModelConfig, model_div_kv: bool) -> dict:
    kv_spec = P(None, None, "model") if model_div_kv else P(None, None, None)
    return {
        "wq": P(None, None, "model"),
        "wk": kv_spec,
        "wv": kv_spec,
        "wo": P(None, "model", None),
    }


def _ffn_specs() -> dict:
    return {"w1": P(None, None, "model"), "w2": P(None, "model", None),
            "w3": P(None, None, "model")}


def _moe_specs(ep: bool) -> dict:
    if ep:
        # experts over 'model' + an FSDP-style 'data' shard on the hidden dim
        e = P(None, "model", "data", None)
        return {"router": P(None, None, None), "w1": e, "w2": e, "w3": e}
    return {
        "router": P(None, None, None),
        "w1": P(None, None, None, "model"),
        "w2": P(None, None, "model", None),
        "w3": P(None, None, None, "model"),
    }


def _mamba_specs() -> dict:
    return {
        "in_proj": P(None, None, "model"),
        "conv_w": P(None, None, "model"),
        "conv_b": P(None, "model"),
        "x_proj": P(None, "model", None),
        "dt_proj": P(None, None, "model"),
        "dt_bias": P(None, "model"),
        "A_log": P(None, "model", None),
        "D": P(None, "model"),
        "out_proj": P(None, "model", None),
    }


def _rwkv_specs() -> dict:
    return {
        "mu": P(None, None, None),
        "wr": P(None, None, "model"),
        "wk": P(None, None, "model"),
        "wv": P(None, None, "model"),
        "wg": P(None, None, "model"),
        "wo": P(None, "model", None),
        "w0": P(None, None),
        "w_lora_a": P(None, None, None),
        "w_lora_b": P(None, None, "model"),
        "u": P(None, "model", None),
        "ln_x": P(None, None),
        "cm_r": P(None, None, "model"),
        "cm_k": P(None, None, "model"),
        "cm_v": P(None, "model", None),
    }


def param_pspecs(cfg: ModelConfig, plan: ShardPlan, mesh) -> dict:
    """PartitionSpec tree of the reference's parameter pytree (its stacked
    ``[R, ...]`` leaves: the first entry is the repeat axis)."""
    model_size = mesh.shape["model"]
    model_div_kv = cfg.n_kv_heads % model_size == 0 or model_size % cfg.n_kv_heads == 0
    blocks = []
    for pi, kind in enumerate(cfg.expanded_pattern):
        spec = {"ln1": P(None, None), "ln2": P(None, None)}
        if kind in ("attn", "local"):
            spec["attn"] = _attn_specs(cfg, model_div_kv)
        elif kind == "mamba":
            spec["mamba"] = _mamba_specs()
        elif kind == "rwkv":
            spec["rwkv"] = _rwkv_specs()
        if kind == "rwkv":
            pass
        elif cfg.is_moe_block(pi):
            spec["moe"] = _moe_specs(plan.ep)
            if not cfg.ffn_gated:
                spec["moe"].pop("w3")
        else:
            spec["ffn"] = _ffn_specs()
            if not cfg.ffn_gated:
                spec["ffn"].pop("w3")
        blocks.append(spec)
    out = {
        "embed": P("model", None),          # vocab-sharded
        "blocks": tuple(blocks),
        "final_ln": P(None),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = P(None, "model")
    return out


def opt_pspecs(cfg: ModelConfig, plan: ShardPlan, mesh, param_specs, optimizer: str):
    """Optimizer-state specs.  ZeRO mode adds a 'data' shard on the repeat
    axis of stacked block params (paper SSIII-B applied to optimizer state)."""
    def zero_ify(spec: P) -> P:
        if not plan.zero or len(spec) == 0:
            return spec
        if spec[0] is None and "data" in plan.mesh_axes:
            return P("data", *spec[1:])
        return spec

    moment_specs = map_specs(zero_ify, param_specs)
    if optimizer == "adamw":
        return OptState(step=P(), m=moment_specs, v=moment_specs)

    # adafactor: row stats drop the last dim, col stats drop the 2nd-to-last
    def rows(s):
        return zero_ify(P(*s[:-1])) if len(s) >= 2 else s

    def cols(s):
        if len(s) >= 2:
            return zero_ify(P(*s[:-2], s[-1]))
        return P(None)

    return OptState(step=P(), m=map_specs(rows, param_specs), v=map_specs(cols, param_specs))


# -------------------------------------------------------------- activations

def activation_pspec(plan: ShardPlan, zone: int, tag: str, shape: tuple[int, ...]) -> P:
    """The layout of a zone's activation of ``shape`` under ``tag``: the spec
    the reference's ``make_constrain(mesh, plan, zone)`` constrains it to."""
    dp = plan.dp
    ndim = len(shape)
    if tag == "moe:groups":
        return P(tuple([*dp, "model"]), *([None] * (ndim - 1)))
    if tag == "moe:buffers":
        if plan.ep:
            return P("model", tuple(dp), *([None] * (ndim - 2)))
        return P(None, tuple([*dp, "model"]), *([None] * (ndim - 2)))
    if tag == "logits":
        return P(dp, None, "model")
    if plan.zone_partition(zone) == WSP and ndim >= 3 and shape[1] > 1:
        return P(dp, "model", *([None] * (ndim - 2)))
    return P(dp, *([None] * (ndim - 1)))


# ------------------------------------------------------------------- caches

def cache_pspecs(cfg: ModelConfig, plan: ShardPlan) -> tuple:
    dp = plan.dp
    t_ax = "model" if plan.shard_kv_cache_time else None
    specs = []
    for kind in cfg.expanded_pattern:
        if kind in ("attn", "local"):
            specs.append({
                "k": P(None, dp, t_ax, None, None),
                "v": P(None, dp, t_ax, None, None),
            })
        elif kind == "mamba":
            specs.append({
                "h": P(None, dp, "model", None),
                "conv": P(None, dp, None, "model"),
            })
        elif kind == "rwkv":
            specs.append({
                "S": P(None, dp, "model", None, None),
                "shift": P(None, dp, None, None),
                "shift_ffn": P(None, dp, None, None),
            })
    return tuple(specs)


def batch_pspecs(cfg: ModelConfig, plan: ShardPlan, with_labels: bool = True):
    dp = plan.dp
    tok = P(dp, None)
    spec = {}
    if cfg.frontend != "audio_stub":      # audio stub has no token input
        spec["tokens"] = tok
    if with_labels:
        spec["labels"] = tok
    if cfg.frontend != "none":
        spec["frontend_embeds"] = P(dp, None, None)
    return spec


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= mesh.shape[a]
        return n
    return mesh.shape[entry]


def zero_shard(spec_tree, shape_tree, mesh, axis: str = "data"):
    """Shape-aware ZeRO placement: for each optimizer-moment leaf, put the
    ``data`` axis on the first unsharded dim whose size it divides.
    ``shape_tree`` has the spec tree's structure with leaves that have a
    ``.shape`` (tensors, :class:`~repro_torch.tree.Stacked`)."""
    if axis not in mesh.shape:
        return spec_tree
    n = mesh.shape[axis]

    def fix(spec, shaped):
        if not isinstance(spec, P):
            return spec
        entries = list(spec) + [None] * (len(shaped.shape) - len(spec))
        if axis in entries:
            return spec
        for i, (e, dim) in enumerate(zip(entries, shaped.shape)):
            if e is None and dim % n == 0 and dim >= n:
                entries[i] = axis
                return P(*entries)
        return spec

    return map_specs(fix, spec_tree, shape_tree)


def sanitize_pspecs(spec_tree, shape_tree, mesh):
    """Drop shard axes whose size does not divide the array dim (the
    reference's jit shardings require exact divisibility; such dims fall
    back to replication)."""
    def fix(spec, shaped):
        if not isinstance(spec, P):
            return spec
        shape = shaped.shape
        out = []
        for i, entry in enumerate(spec):
            if i >= len(shape) or shape[i] % _axes_size(mesh, entry) != 0:
                out.append(None)
            else:
                out.append(entry)
        return P(*out)

    return map_specs(fix, spec_tree, shape_tree)


# -------------------------------------------------------- rank-local layout

def _span(n: int, parts: int, i: int) -> tuple[int, int]:
    size = n // parts
    return i * size, (i + 1) * size


@dataclass(frozen=True)
class RankShard:
    """Where one rank's pieces of a model sit and how its activations lie.

    ``m`` ranks share the ``model`` axis (this one is ``r``); the batch
    splits over the plan's data axes into ``dp`` parts (this one's is
    ``dpi``).  On the model axis the rank holds query heads ``heads``, the
    kv heads ``kv_heads`` they read, vocab rows ``vocab`` of the embedding
    (columns of the head) and FFN columns ``ff``.
    """

    cfg: ModelConfig
    plan: ShardPlan
    mesh: object
    m: int
    r: int
    dp: int
    dpi: int
    heads: tuple[int, int] = (0, 0)
    kv_heads: tuple[int, int] = (0, 0)
    vocab: tuple[int, int] = (0, 0)
    ff: tuple[int, int] = (0, 0)

    @property
    def comm(self):
        return self.mesh.comm

    @property
    def n_heads(self) -> int:
        return self.heads[1] - self.heads[0]

    @property
    def n_kv_heads(self) -> int:
        return self.kv_heads[1] - self.kv_heads[0]

    def kv_owners(self) -> list[int]:
        """For each kv head in order, the first model rank that holds it (a
        kv head serves the query heads of several ranks when m > n_kv_heads)."""
        H, KV, m = self.cfg.n_heads, self.cfg.n_kv_heads, self.m
        g, hl = H // KV, H // m
        owners = []
        for rank in range(m):
            lo = rank * hl // g
            if not owners or lo != owners[-1][1]:
                owners.append((rank, lo))
        return [rank for rank, _ in owners]

    def partition(self, layer: int) -> str:
        """The partition layer ``layer`` runs under: zone 1 (repeats below
        ``transition_repeat``, every repeat when it is None) takes ``p1``,
        zone 2 ``p2``; the reference's two scan segments."""
        t = self.plan.transition_repeat
        repeat = layer // len(self.cfg.expanded_pattern)
        return self.plan.zone_partition(1 if t is None or repeat < t else 2)

    def chunk(self, S: int) -> int:
        """Positions a rank holds of a sequence-sharded S: S over m, rounded up."""
        return -(-S // self.m)

    def rows(self, x: torch.Tensor | None) -> torch.Tensor | None:
        """This rank's rows of a global batch-major tensor."""
        if x is None or self.dp == 1:
            return x
        B = x.shape[0]
        if B % self.dp:
            raise ValueError(f"batch {B} does not split over the {self.dp} ranks of the data "
                             f"axes {self.plan.dp} (shape {tuple(x.shape)})")
        lo, hi = _span(B, self.dp, self.dpi)
        return x[lo:hi]

    def pad_seq(self, x: torch.Tensor) -> torch.Tensor:
        """A [B, S, ...] sequence padded with zeros at its end to m chunks."""
        S = x.shape[1]
        extra = self.chunk(S) * self.m - S
        if not extra:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], extra, *x.shape[2:]))], dim=1)

    def seq_shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's positions of a replicated [B, S, ...] sequence (padded
        at its end to m chunks)."""
        Sl = self.chunk(x.shape[1])
        return self.pad_seq(x)[:, self.r * Sl:(self.r + 1) * Sl]

    def gather_seq(self, x: torch.Tensor, S: int, tag: str) -> torch.Tensor:
        """The whole sequence [B, S, ...] from every rank's positions."""
        return self.comm.all_gather(x, dim=1, tag=tag)[:, :S]


def _mesh_layout(cfg: ModelConfig, plan: ShardPlan, mesh) -> tuple[int, int, int, int]:
    """(m, r, dp, dpi) of this rank.  An axis that is neither ``model`` nor
    one of the plan's data axes (a ``stage`` axis) is replicated, as GSPMD
    replicates over an axis no ``PartitionSpec`` names: ranks that differ
    only there compute the same."""
    shape = mesh.shape
    for axis in plan.dp:
        if axis not in shape:
            raise ValueError(f"the plan's data axis {axis!r} is not an axis of the mesh "
                             f"{tuple(shape)}")
    m = shape.get("model", 1)
    r = mesh.index("model") if "model" in shape else 0
    dp, dpi = 1, 0
    for axis in plan.dp:
        dp, dpi = dp * shape[axis], dpi * shape[axis] + mesh.index(axis)
    return m, r, dp, dpi


def rank_shard(cfg: ModelConfig, plan: ShardPlan, mesh) -> RankShard:
    """This rank's :class:`RankShard`; raises ``NotImplementedError`` for a
    config or mesh the rank-local execution does not cover (ROADMAP A13c)
    and ``ValueError`` for dims the mesh does not divide, naming them."""
    m, r, dp, dpi = _mesh_layout(cfg, plan, mesh)
    if mesh.size > 1 and cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name} on a {tuple(mesh.shape.items())} mesh: MoE's capacity dispatch is "
            "global in the reference (moe:groups), so it runs on one rank only until "
            "ROADMAP A13c")
    if m == 1:
        return RankShard(cfg, plan, mesh, 1, 0, dp, dpi)
    bad = sorted({k for k in cfg.block_pattern if k not in ("attn", "local")})
    if bad:
        raise NotImplementedError(f"{cfg.name}: {bad} blocks on a model axis of {m} ranks "
                                  "(their model-axis rules): ROADMAP A13c")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend on a model axis "
                                  f"of {m} ranks: ROADMAP A13c")
    if not plan.shard_kv_cache_time:
        raise NotImplementedError("a decode cache replicated over time on a model axis "
                                  "(shard_kv_cache_time=False): ROADMAP A13c")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = H // KV
    if H % m:
        raise ValueError(f"{cfg.name}: {H} query heads do not split over {m} model ranks")
    hl = H // m
    if hl % g and g % hl:
        raise ValueError(f"{cfg.name}: {hl} query heads a rank cut its GQA groups of {g} "
                         f"(H={H}, KV={KV}, model axis {m})")
    for name, n in (("d_ff", cfg.d_ff), ("padded vocab", cfg.padded_vocab)):
        if n % m:
            raise ValueError(f"{cfg.name}: {name} {n} does not split over {m} model ranks")
    heads = (r * hl, (r + 1) * hl)
    kv_heads = (heads[0] // g, (heads[1] - 1) // g + 1)
    return RankShard(cfg, plan, mesh, m, r, dp, dpi, heads, kv_heads,
                     _span(cfg.padded_vocab, m, r), _span(cfg.d_ff, m, r))


def _local_params(model, sh: RankShard) -> dict:
    """The params dict ``DecoderLM`` takes, cut to this rank's pieces (copies,
    so the whole model can be freed)."""
    hd = sh.cfg.head_dim
    q0, q1 = (h * hd for h in sh.heads)
    k0, k1 = (h * hd for h in sh.kv_heads)
    f0, f1 = sh.ff
    v0, v1 = sh.vocab
    cut = sh.m > 1

    def cols(t, lo, hi):
        return t[:, lo:hi].clone() if cut else t

    def rows(t, lo, hi):
        return t[lo:hi].clone() if cut else t

    blocks = []
    for blk in model.blocks:
        bp = {"ln1": blk.ln1.data, "ln2": blk.ln2.data}
        for name in ("attn", "mamba", "rwkv", "moe", "ffn"):
            leaves = getattr(blk, name, None)
            if leaves is not None:
                bp[name] = {n: p.data for n, p in leaves.items()}
        if "attn" in bp:
            a = bp["attn"]
            bp["attn"] = {"wq": cols(a["wq"], q0, q1), "wk": cols(a["wk"], k0, k1),
                          "wv": cols(a["wv"], k0, k1), "wo": rows(a["wo"], q0, q1)}
        if "ffn" in bp:
            f = bp["ffn"]
            bp["ffn"] = {n: rows(w, f0, f1) if n == "w2" else cols(w, f0, f1)
                         for n, w in f.items()}
        blocks.append(bp)
    params = {"embed": rows(model.embed.data, v0, v1), "blocks": blocks,
              "final_ln": model.final_ln.data}
    if model.lm_head is not None:
        params["lm_head"] = cols(model.lm_head.data, v0, v1)
    return params


def shard_model(model, plan: ShardPlan, mesh):
    """This rank's shard of ``model`` (a whole ``DecoderLM``) on ``mesh``: a
    ``DecoderLM`` holding the rank's pieces (:func:`param_pspecs`' storage,
    whole kv heads) whose ``forward`` / ``decode_step`` take the global
    inputs, run the rank-local program and return this rank's logits,
    ``[B / dp, S, padded_vocab / m]`` (the reference's ``P(dp, None,
    "model")``).  A one-rank mesh returns ``model`` itself."""
    if mesh.size == 1:
        return model
    sh = rank_shard(model.cfg, plan, mesh)
    local = DecoderLM(model.cfg, _local_params(model, sh))
    local.shard = sh
    return local


def shard_caches(caches: tuple, sh: RankShard) -> tuple:
    """This rank's pieces of whole caches (``init_kv_cache``'s layout, e.g. a
    one-rank prefill's collected caches): its batch rows, and on a model
    axis its block of the attention caches' time axis (padded at the end
    to m blocks), as :func:`cache_pspecs` places them."""
    out = []
    for slot in caches:
        local = {}
        for name, t in slot.items():
            t = t.transpose(0, 1)
            t = sh.rows(t).transpose(0, 1)
            if name in ("k", "v") and sh.m > 1:
                T = t.shape[2]
                Tl = sh.chunk(T)
                if Tl * sh.m != T:
                    t = torch.cat([t, t.new_zeros((*t.shape[:2], Tl * sh.m - T,
                                                   *t.shape[3:]))], dim=2)
                t = t[:, :, sh.r * Tl:(sh.r + 1) * Tl]
            local[name] = t.contiguous()
        out.append(local)
    return tuple(out)


def gather_logits(logits: torch.Tensor, sh: RankShard, tag: str = "gather") -> torch.Tensor:
    """The global logits [B, S, padded_vocab] from every rank's
    ``[B / dp, S, padded_vocab / m]`` (all-gathers over the model axis, then
    the data axes, innermost first)."""
    out = sh.comm.all_gather(logits, dim=-1, axis="model", tag=tag) if sh.m > 1 else logits
    for axis in reversed(sh.plan.dp):
        out = sh.comm.all_gather(out, dim=0, axis=axis, tag=tag)
    return out

