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
the whole kv heads its query heads need; with ``shard_kv_cache_time=False``
the reference replicates the decode cache over ``model`` and a rank holds
its kv heads over the whole time axis.  Mamba's ``in_proj`` (``[d, 2 d_inner]``,
read as ``[x | z]``) is stored as the reference stores it, ``d_inner``
columns a rank, but the rank's columns are its block of the x half and of
the z half (:class:`Spans`), so that its channels are local; its AdamW
moments cover the same columns.  The rank-local execution covers every
block kind (``attn`` / ``local`` / ``rwkv`` / ``mamba``, with a dense or an
MoE FFN) and both frontend stubs, on a model axis above 1 (rwkv heads whole
on a rank) and on a data-only mesh; a model axis that would split inside an
rwkv head raises (A13c-6: the reference splits there and replicates ``u``).
MoE's expert banks are stored as ``_moe_specs`` stores them: with
``plan.ep`` a rank's experts over ``model`` and, FSDP-style, its block of
the second-to-last dim over ``data`` (whole where ``data`` does not divide
it, as :func:`sanitize_pspecs` drops the entry), also on a data-only mesh;
without ``ep`` the expert ``d_ff`` over ``model``.  ``models/moe.py`` runs
the dispatch groups of ``moe:groups`` rank-locally.

The train step's state on a mesh (:class:`TrainLayout`): a rank keeps its
parameter pieces whole over ``data`` (the expert banks under ``ep``
excepted) and its pieces of each AdamW moment by the reference's optimizer
specs (:func:`opt_pspecs`, then :func:`sanitize_pspecs`, then
:func:`zero_shard`, as its ``build_train_step`` places them), except that a
leaf whose parameter spec already names ``data`` (the expert banks) keeps
its moments on the parameter's own piece: the reference adds a second
``data`` entry there and raises (ROADMAP C-ref-5), ``zero_shard``'s own
rule skips such a leaf.  A ``data`` entry on a stacked leaf's repeat axis
means whole layers' moments live on one data rank.  :func:`shard_opt_state`
cuts a whole ``OptState`` into those pieces.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import tree as pytree
from ..models.config import ModelConfig
from ..models.model import DecoderLM, init_params
from ..optim.optimizers import OptState
from .collectives import gather, own_block

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
    (columns of the head), FFN columns ``ff`` and, under ``plan.ep``, the
    experts ``experts``; of a recurrent block its block of the rwkv heads or
    of mamba's channels (:meth:`part`).  ``data`` is the mesh's ``data``
    axis (size, this rank's coordinate), over which the expert banks are
    cut under ``plan.ep`` (:meth:`piece_box`).
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
    experts: tuple[int, int] = (0, 0)
    data: tuple[int, int] = (1, 0)

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

    def part(self, n: int) -> tuple[int, int]:
        """This rank's (lo, hi) of a dim of ``n`` split over the model axis."""
        return _span(n, self.m, self.r)

    def cache_len(self, max_len: int) -> int:
        """Positions a rank's k / v cache holds: its time block
        (``shard_kv_cache_time``), else the whole ``max_len``."""
        return self.chunk(max_len) if self.plan.shard_kv_cache_time else max_len

    def piece_box(self, group: str, name: str, shape, r: int | None = None,
                  q: int | None = None) -> tuple:
        """The (lo, hi) a dim of the piece of a layer of leaf ``name`` of
        ``group`` (whole per-layer ``shape``) that this rank holds, or model
        rank ``r`` and data rank ``q`` of this mesh (:func:`_piece_box`)."""
        return _piece_box(self.cfg, self.m, self.r if r is None else r, group, name, shape,
                          self.plan.ep, (self.data[0], self.data[1] if q is None else q))

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

    def own_positions(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's positions of a replicated [B, S, ...] sequence (padded
        at its end to m chunks), sliced: an input that takes no gradient."""
        x = self.pad_seq(x)
        n = x.shape[1] // self.m
        return x[:, self.r * n:(self.r + 1) * n]

    def seq_shard(self, x: torch.Tensor, tag: str = "transition") -> torch.Tensor:
        """This rank's positions of a replicated [B, S, ...] sequence (padded
        at its end to m chunks); the gradient of every rank's positions is
        all-gathered back (the padding's is dropped)."""
        return own_block(self.comm, self.pad_seq(x), dim=1, tag=tag)

    def gather_seq(self, x: torch.Tensor, S: int, tag: str, grad: str = "own") -> torch.Tensor:
        """The whole sequence [B, S, ...] from every rank's positions.  The
        gradient arriving is the same on every rank (``grad="own"``: an
        ISP zone follows) or a part on each (``"sum"``: a vocab-parallel
        head follows), :func:`~repro_torch.runtime.collectives.gather`."""
        return gather(self.comm, x, dim=1, tag=tag, grad=grad)[:, :S]

    def partial_grads(self, model, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """``grads`` (of ``model.flat_params()``) with the parts each model
        rank holds of a gradient summed over ``model``, in one all-reduce: the
        norm weights of WSP layers and, after a WSP last zone, the final
        norm's (each rank saw its positions), a kv head's wk / wv where
        ranks share it (each rank's query heads, or only the rank whose
        copy the WSP gather took), rwkv's leaves that every rank holds
        whole and uses on its own heads (``mu``, ``w0``, ``w_lora_a``,
        ``ln_x``), and the MoE router (each rank routes its own dispatch
        groups)."""
        if self.m == 1:
            return grads
        flat = model.flat_params()
        index = {id(p): i for i, p in enumerate(flat)}
        parts: list[tuple[int, bool]] = []       # (gradient index, a shared kv head's)
        for layer, blk in enumerate(model.blocks):
            if self.partition(layer) == WSP:
                parts += [(index[id(blk.ln1)], False), (index[id(blk.ln2)], False)]
            attn, rwkv = getattr(blk, "attn", None), getattr(blk, "rwkv", None)
            if getattr(blk, "moe", None) is not None:
                parts.append((index[id(blk.moe["router"])], False))
            if attn is not None and self.shared_kv():
                parts += [(index[id(attn[n])], True) for n in ("wk", "wv")]
            if rwkv is not None:
                parts += [(index[id(rwkv[n])], False) for n in ("mu", "w0", "w_lora_a", "ln_x")]
        if self.partition(self.cfg.n_layers - 1) == WSP:
            parts.append((index[id(model.final_ln)], False))
        if not parts:
            return grads
        KV, kvh = self.cfg.n_kv_heads, self.kv_heads[0]
        flat_parts = []
        for i, kv in parts:
            g = grads[i].float()
            if kv:   # a slot a kv head: the ranks that share one add into it
                z = g.new_zeros((KV, *g.shape))
                z[kvh] = g
                g = z
            flat_parts.append(g.reshape(-1))
        summed = self.comm.all_reduce(torch.cat(flat_parts), tag="grad:model")
        out = list(grads)
        at = 0
        for (i, kv), part in zip(parts, flat_parts):
            g = summed[at:at + part.numel()]
            at += part.numel()
            g = g.view(KV, *grads[i].shape)[kvh] if kv else g.view(grads[i].shape)
            out[i] = g.to(grads[i].dtype)
        return out

    def shared_kv(self) -> bool:
        """Whether this rank's kv head serves the query heads of other ranks
        too (m > n_kv_heads): its wk / wv gradient is then summed over them."""
        return self.m > 1 and self.n_heads < self.cfg.n_heads // self.cfg.n_kv_heads


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
    mesh the rank-local execution does not cover (ROADMAP A13c-6) and
    ``ValueError`` for dims the mesh does not divide, naming them."""
    m, r, dp, dpi = _mesh_layout(cfg, plan, mesh)
    data = (mesh.shape.get("data", 1), mesh.index("data") if "data" in mesh.shape else 0)
    E = cfg.moe.n_experts if cfg.moe is not None else 0
    if m == 1:
        return RankShard(cfg, plan, mesh, 1, 0, dp, dpi, experts=(0, E), data=data)
    kinds = set(cfg.block_pattern)
    dims = [("padded vocab", cfg.padded_vocab), ("d_ff", cfg.d_ff)]
    if cfg.moe is not None:
        dims.append(("MoE n_experts", E) if plan.ep else ("MoE d_ff", cfg.moe.d_ff or cfg.d_ff))
    if "rwkv" in kinds:
        heads = cfg.d_model // cfg.rwkv_head_dim
        if heads % m:
            raise NotImplementedError(
                f"{cfg.name}: {heads} rwkv heads on a model axis of {m} ranks would split "
                "inside a head (the reference then replicates u): ROADMAP A13c-6")
    if "mamba" in kinds:
        dims.append(("mamba d_inner", cfg.mamba_expand * cfg.d_model))
    if kinds & {"attn", "local"}:
        H, KV = cfg.n_heads, cfg.n_kv_heads
        g = H // KV
        if H % m:
            raise ValueError(f"{cfg.name}: {H} query heads do not split over {m} model ranks")
        hl = H // m
        if hl % g and g % hl:
            raise ValueError(f"{cfg.name}: {hl} query heads a rank cut its GQA groups of {g} "
                             f"(H={H}, KV={KV}, model axis {m})")
    for name, n in dims:
        if n % m:
            raise ValueError(f"{cfg.name}: {name} {n} does not split over {m} model ranks")
    return RankShard(cfg, plan, mesh, m, r, dp, dpi, *_model_spans(cfg, m, r),
                     experts=_span(E, m, r) if plan.ep else (0, E), data=data)


def _model_spans(cfg: ModelConfig, m: int, r: int) -> tuple:
    """(query heads, kv heads, vocab rows, FFN columns) that model rank ``r``
    of ``m`` holds, each (lo, hi): whole kv heads, those its query heads
    read."""
    g, hl = cfg.n_heads // cfg.n_kv_heads, cfg.n_heads // m
    heads = (r * hl, (r + 1) * hl)
    kv_heads = (heads[0] // g, (heads[1] - 1) // g + 1)
    return heads, kv_heads, _span(cfg.padded_vocab, m, r), _span(cfg.d_ff, m, r)


class Spans(tuple):
    """A dim of a rank's piece held as several ``(lo, hi)`` spans of the
    whole leaf, side by side in this order: mamba's ``in_proj`` columns, the
    rank's block of the x half and of the z half."""


def _width(span) -> int:
    return sum(hi - lo for lo, hi in span) if isinstance(span, Spans) else span[1] - span[0]


def _piece_box(cfg: ModelConfig, m: int, r: int, group: str, name: str, shape,
               ep: bool, data: tuple[int, int]) -> tuple:
    """(lo, hi) a dim (or :class:`Spans`) of model rank ``r``'s piece of a
    layer of the leaf ``name`` of ``group`` (``"attn"``, ``"ffn"``,
    ``"moe"``, ``"rwkv"``, ``"mamba"``, ``"blocks"`` for a block's norms,
    ``""`` at the top), ``shape`` the whole leaf's per-layer shape: the one
    rule that cuts a model over the mesh (:func:`_local_params`,
    :class:`TrainLayout`).  rwkv's ``mu``, ``w0``, ``w_lora_a`` and ``ln_x``
    and the MoE router are whole on every rank, as the reference's specs
    replicate them.  Under ``ep`` an expert bank (``[E, d, f]`` or ``[E, f,
    d]``) is cut to the rank's experts and, over the ``data`` axis of
    ``data = (size, this rank's coordinate)``, to its block of dim 1 where
    the size divides it (:func:`_moe_specs`, :func:`sanitize_pspecs`)."""
    full = [(0, n) for n in shape]
    bank = group == "moe" and name != "router"
    if bank and ep and data[0] > 1 and shape[1] % data[0] == 0:
        full[1] = _span(shape[1], *data)
    if m == 1:
        return tuple(full)
    hd = cfg.head_dim
    heads, kv, vocab, ff = _model_spans(cfg, m, r)
    heads, kv = (heads[0] * hd, heads[1] * hd), (kv[0] * hd, kv[1] * hd)
    cols = _span(cfg.d_model, m, r)                      # an rwkv rank's heads' columns
    di = cfg.mamba_expand * cfg.d_model
    ch = _span(di, m, r)                                 # a mamba rank's channels
    rules = {("attn", "wq"): (1, heads), ("attn", "wk"): (1, kv), ("attn", "wv"): (1, kv),
             ("attn", "wo"): (0, heads), ("ffn", "w1"): (1, ff), ("ffn", "w3"): (1, ff),
             ("ffn", "w2"): (0, ff), ("", "embed"): (0, vocab), ("", "lm_head"): (1, vocab),
             ("rwkv", "wo"): (0, cols), ("rwkv", "cm_k"): (1, ff), ("rwkv", "cm_v"): (0, ff),
             ("rwkv", "u"): (0, _span(cfg.d_model // cfg.rwkv_head_dim, m, r)),
             ("mamba", "in_proj"): (1, Spans((ch, (di + ch[0], di + ch[1])))),
             ("mamba", "conv_w"): (1, ch), ("mamba", "dt_proj"): (1, ch)}
    if bank:
        eff = cfg.moe.d_ff or cfg.d_ff
        rules[("moe", name)] = ((0, _span(cfg.moe.n_experts, m, r)) if ep else
                                (1 if name == "w2" else 2, _span(eff, m, r)))
    rules.update({("rwkv", n): (1, cols) for n in ("wr", "wk", "wv", "wg", "w_lora_b", "cm_r")})
    rules.update({("mamba", n): (0, ch) for n in ("conv_b", "x_proj", "dt_bias", "A_log", "D",
                                                  "out_proj")})
    if (group, name) in rules:
        dim, span = rules[(group, name)]
        full[dim] = span
    return tuple(full)


def _local_params(model, sh: RankShard) -> dict:
    """The params dict ``DecoderLM`` takes, cut to this rank's pieces by
    :func:`_piece_box` (on a model axis every leaf a copy, so the whole
    model can be freed and a shard's training leaves it as it was; a
    data-only shard holds the whole model's tensors themselves, its blocks
    of the expert banks excepted)."""
    def cut(t, group, name):
        box = sh.piece_box(group, name, t.shape)
        if sh.m == 1 and box == tuple((0, n) for n in t.shape):
            return t
        return _narrow(t, box).clone()

    blocks = []
    for blk in model.blocks:
        bp = {n: cut(getattr(blk, n).data, "blocks", n) for n in ("ln1", "ln2")}
        for group in ("attn", "mamba", "rwkv", "moe", "ffn"):
            leaves = getattr(blk, group, None)
            if leaves is not None:
                bp[group] = {n: cut(p.data, group, n) for n, p in leaves.items()}
        blocks.append(bp)
    params = {"embed": cut(model.embed.data, "", "embed"), "blocks": blocks,
              "final_ln": cut(model.final_ln.data, "", "final_ln")}
    if model.lm_head is not None:
        params["lm_head"] = cut(model.lm_head.data, "", "lm_head")
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
    one-rank prefill's collected caches), as :func:`cache_pspecs` places
    them: its batch rows, and on a model axis its block of the attention
    caches' time axis (padded at the end to m blocks; with
    ``shard_kv_cache_time=False`` its kv heads over the whole time, where
    the reference keeps every head), its rwkv heads of ``S``, its mamba
    channels of ``h`` and ``conv``; the token shifts whole.  Every piece is
    a copy: decode writes its caches in place."""
    cut = {"S": 2, "h": 2, "conv": 3}       # the dim a recurrent state splits on
    out = []
    for slot in caches:
        local = {}
        for name, t in slot.items():
            t = t.transpose(0, 1)
            t = sh.rows(t).transpose(0, 1)
            if name in ("k", "v") and sh.m > 1:
                if sh.plan.shard_kv_cache_time:
                    T = t.shape[2]
                    Tl = sh.chunk(T)
                    if Tl * sh.m != T:
                        t = torch.cat([t, t.new_zeros((*t.shape[:2], Tl * sh.m - T,
                                                       *t.shape[3:]))], dim=2)
                    t = t[:, :, sh.r * Tl:(sh.r + 1) * Tl]
                else:
                    t = t[:, :, :, sh.kv_heads[0]:sh.kv_heads[1]]
            elif name in cut and sh.m > 1:
                lo, hi = sh.part(t.shape[cut[name]])
                t = t.narrow(cut[name], lo, hi - lo)
            local[name] = t.clone(memory_format=torch.contiguous_format)
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



# -------------------------------------------------------- the train state

def _spec_leaves(tree, path: tuple[str, ...] = ()):
    """(key, PartitionSpec) pairs of a spec tree in the order (and with the
    keys) of :func:`~repro_torch.tree.flatten_with_path`."""
    if isinstance(tree, PartitionSpec):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (f"[{k!r}]",))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _spec_leaves(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _spec_leaves(x, path + (f"[{i}]",))


def _block(n: int, entry, mesh) -> tuple[int, int]:
    """This rank's (lo, hi) of a dim of size ``n`` under a spec entry."""
    if entry is None:
        return 0, n
    axes = entry if isinstance(entry, tuple) else (entry,)
    size, index = 1, 0
    for a in axes:
        size, index = size * mesh.shape[a], index * mesh.shape[a] + mesh.index(a)
    return _span(n, size, index)


def train_specs(cfg: ModelConfig, plan: ShardPlan, mesh):
    """(the whole parameter tree's leaves with their shapes, on meta; the
    optimizer state's specs): the reference's ``build_train_step``
    placement, ``sanitize(opt_pspecs)`` then ``zero_shard`` under ZeRO,
    except that an AdamW moment of a leaf whose parameter spec names
    ``data`` (an expert bank under ``ep``) takes the parameter's spec, as
    ``zero_shard``'s own rule leaves such a leaf (the reference's
    ``opt_pspecs`` adds a second ``data`` entry: ROADMAP C-ref-5)."""
    shapes = init_params(cfg, None, "meta").param_tree()
    p_specs = sanitize_pspecs(param_pspecs(cfg, plan, mesh), shapes, mesh)
    opt_shapes = OptState(step=torch.empty((), device="meta"), m=shapes, v=shapes)
    o_specs = sanitize_pspecs(opt_pspecs(cfg, plan, mesh, p_specs, cfg.optimizer), opt_shapes,
                              mesh)
    if cfg.optimizer == "adamw":
        def own(o, p):
            return p if any(e == "data" or (isinstance(e, tuple) and "data" in e)
                            for e in p) else o
        o_specs = OptState(step=o_specs.step, m=map_specs(own, o_specs.m, p_specs),
                           v=map_specs(own, o_specs.v, p_specs))
    if plan.zero:
        o_specs = zero_shard(o_specs, opt_shapes, mesh)
    return shapes, o_specs


def _leaf_names(key: str) -> tuple[str, str]:
    """(group, name) of a parameter leaf's key (``flatten_with_path``'s):
    ``"['blocks']/[0]/['attn']/['wq']"`` -> ``("attn", "wq")``, a block's
    norm -> ``("blocks", "ln1")``, a top leaf -> ``("", "embed")``."""
    names = [p[2:-2] for p in key.split("/") if p.startswith("['")]
    return (names[-2] if len(names) > 1 else ""), names[-1]


def _narrow(t: torch.Tensor, box: tuple, skip: int | None = None) -> torch.Tensor:
    """``t`` narrowed to ``box`` ((lo, hi) a dim, in ``t``'s coordinates),
    ``skip`` left whole: a view, or a copy of the spans side by side where a
    dim is :class:`Spans`."""
    for d, span in enumerate(box):
        if d == skip:
            continue
        if isinstance(span, Spans):
            t = torch.cat([t.narrow(d, lo, hi - lo) for lo, hi in span], dim=d)
        elif span != (0, t.shape[d]):
            t = t.narrow(d, span[0], span[1] - span[0])
    return t


def _place(out: torch.Tensor, box: tuple, src: torch.Tensor) -> None:
    """``src`` written into ``out``'s region ``box`` (a :class:`Spans` dim
    span by span)."""
    multi = [d for d, span in enumerate(box) if isinstance(span, Spans)]
    if not multi:
        _narrow(out, box).copy_(src)
        return
    (d,) = multi
    at = 0
    for lo, hi in box[d]:
        _narrow(out, box[:d] + ((lo, hi),) + box[d + 1:]).copy_(src.narrow(d, at, hi - lo))
        at += hi - lo


@dataclass
class _Leaf:
    key: str
    stacked: bool
    shape: tuple          # the whole leaf's (a stacked leaf's [R, ...])
    piece: tuple          # this rank's parameter piece, (lo, hi) a dim of the whole leaf
    box: tuple            # this rank's moment piece, likewise
    data_dim: int | None  # the dim the moments split over ``data``
    axes: frozenset       # the mesh axes the moments split over
    fsdp: bool = False    # the parameter piece is cut over ``data`` too (an expert bank)

    @property
    def moment_shape(self) -> tuple:
        """The shape of this rank's moment piece."""
        return tuple(_width(b) for b in self.box)

    def local(self, box: tuple) -> tuple:
        """``box`` in the coordinates of the rank's parameter piece (a
        :class:`Spans` dim is the piece's own, whole)."""
        return tuple((0, _width(b)) if isinstance(b, Spans) else (b[0] - p[0], b[1] - p[0])
                     for b, p in zip(box, self.piece))


class TrainLayout:
    """One rank's train state on a mesh: for each leaf of the parameter tree
    (in its flattening order) the rank's parameter piece and moment piece
    in the whole leaf's coordinates, and the collectives that carry the
    step between them (``runtime/train.py``):

    * :meth:`reduce_grads`: the parameter pieces' gradients, made whole over
      ``model`` where they are partial (:meth:`RankShard.partial_grads`),
      reduced over ``data`` into the moment pieces (reduce-scatter on the
      dim the moments split over ``data``, else all-reduce; an expert
      bank's piece, cut over ``data`` as its moments are, comes summed from
      its FSDP gather's transpose);
    * :meth:`grad_norm_sq`: the global gradient's squared norm, each element
      counted once (a piece's sum added over the axes its leaf splits on);
    * :meth:`param_views`: views of the parameter elements the moments cover;
    * :meth:`reassemble`: those elements all-gathered back over ``data``, and
      over ``model`` where a piece is wider than the moments' (ranks that
      share a kv head);
    * whole leaves for checkpoints and checks (:meth:`whole_params`,
      :meth:`whole_moments`) and back (:meth:`load_params`,
      :meth:`load_moments`, :meth:`cut_moments`).
    """

    def __init__(self, cfg: ModelConfig, plan: ShardPlan, mesh, shard: RankShard):
        if cfg.optimizer != "adamw":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.optimizer} on a mesh (factored statistics summed over the "
                "axes a leaf splits on): ROADMAP A13c-3b")
        self.cfg, self.plan, self.mesh, self.shard = cfg, plan, mesh, shard
        shapes, o_specs = train_specs(cfg, plan, mesh)
        self.o_specs = o_specs
        self.leaves: list[_Leaf] = []
        for (key, spec), leaf in zip(_spec_leaves(o_specs.m), pytree.leaves(shapes), strict=True):
            stacked = isinstance(leaf, pytree.Stacked)
            shape = tuple(leaf.shape)
            entries = list(spec) + [None] * (len(shape) - len(spec))
            if any(e not in (None, "data", "model") for e in entries):
                raise NotImplementedError(f"{key}: moment spec {spec} (multi-pod: ROADMAP A13c-4)")
            layer = shard.piece_box(*_leaf_names(key), shape[1:] if stacked else shape)
            piece = ((0, shape[0]),) + layer if stacked else layer
            # a dim the piece holds as spans: the moments cover the same columns
            box = tuple(p if isinstance(p, Spans) and e == "model" else _block(n, e, mesh)
                        for n, e, p in zip(shape, entries, piece))
            data_dim = entries.index("data") if "data" in entries else None
            fsdp = data_dim is not None and piece[data_dim] != (0, shape[data_dim])
            for d, (b, p) in enumerate(zip(box, piece)):
                inside = (b == p if isinstance(p, Spans) else
                          p[0] <= b[0] and b[1] <= p[1]
                          and (d != data_dim or p == (0, shape[d]) or b == p))
                if not inside:
                    raise ValueError(f"{key}: the moment piece {box} is not inside the rank's "
                                     f"parameter piece {piece}")
            self.leaves.append(_Leaf(key, stacked, shape, piece, box, data_dim,
                                     frozenset(e for e in entries if e), fsdp))

    @property
    def comm(self):
        return self.mesh.comm

    def _per_leaf(self, flat: list) -> list[list]:
        it = iter(flat)
        return [[next(it) for _ in range(lf.shape[0] if lf.stacked else 1)]
                for lf in self.leaves]

    def _joined(self, lf: _Leaf, layers: list[torch.Tensor]) -> torch.Tensor:
        return torch.stack(layers) if lf.stacked else layers[0]

    def _model_box(self, lf: _Leaf) -> tuple:
        """The moment box widened to the whole dim it splits over ``data``
        (unless the parameter piece splits there too): the region the rank
        holds once ``data`` is gathered."""
        return tuple((0, n) if d == lf.data_dim and not lf.fsdp else b
                     for d, (b, n) in enumerate(zip(lf.box, lf.shape)))

    # -------------------------------------------------------- the step

    def reduce_grads(self, model: DecoderLM, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The moment pieces of the global gradient (a stacked leaf's as one
        ``[R or R / data, ...]`` tensor), from the rank's gradients of
        ``model.flat_params()`` (each the gradient of the rank's loss, the
        data ranks' losses adding up to the global one)."""
        grads = self.shard.partial_grads(model, grads)
        out = []
        for lf, layers in zip(self.leaves, self._per_leaf(grads), strict=True):
            t = _narrow(self._joined(lf, layers), lf.local(lf.box), skip=lf.data_dim)
            if lf.fsdp:
                out.append(t)
            elif lf.data_dim is None:
                out.append(self.comm.all_reduce(t, axis="data", tag="grad"))
            else:
                out.append(self.comm.reduce_scatter(t, dim=lf.data_dim, axis="data", tag="grad"))
        return out

    def grad_norm_sq(self, pieces: list[torch.Tensor]) -> torch.Tensor:
        """The squared L2 norm of the global gradient from the moment pieces:
        each piece's sum of squares added over the axes its leaf splits on
        (a leaf replicated over an axis counts once)."""
        dev = pieces[0].device
        parts = {k: torch.zeros((), dtype=torch.float32, device=dev)
                 for k in ("", "data", "model", "both")}
        for lf, g in zip(self.leaves, pieces, strict=True):
            k = ("both" if len(lf.axes) == 2 else next(iter(lf.axes))) if lf.axes else ""
            parts[k] = parts[k] + g.float().square().sum()
        over_data = self.comm.all_reduce(torch.stack([parts["data"], parts["both"]]),
                                         axis="data", tag="grad_norm")
        over_model = self.comm.all_reduce(torch.stack([parts["model"], over_data[1]]),
                                          axis="model", tag="grad_norm")
        return parts[""] + over_data[0] + over_model.sum()

    def _views(self, lf: _Leaf, layers: list[torch.Tensor]):
        local = lf.local(lf.box)
        if lf.stacked:
            lo, hi = local[0] if lf.data_dim == 0 else (0, lf.shape[0])
            return pytree.Stacked([_narrow(t, local[1:]) for t in layers[lo:hi]])
        return _narrow(layers[0], local)

    def param_views(self, model: DecoderLM):
        """The parameter tree over views of the elements the moment pieces
        cover (a stacked leaf split over ``data`` on its repeat axis: the
        rank's layers); an update writes through them."""
        it = iter(self._views(lf, layers)
                  for lf, layers in zip(self.leaves, self._per_leaf(model.flat_params())))
        return pytree.map(lambda _: next(it), model.param_tree())

    def grad_tree(self, model: DecoderLM, pieces: list[torch.Tensor]):
        """The moment pieces of the gradient in :meth:`param_views`' structure."""
        it = iter(pytree.Stacked(list(g.unbind(0))) if lf.stacked else g
                  for lf, g in zip(self.leaves, pieces))
        return pytree.map(lambda _: next(it), model.param_tree())

    @torch.no_grad()
    def reassemble(self, model: DecoderLM) -> None:
        """After an update of :meth:`param_views`: every rank's updated
        elements all-gathered over ``data`` into the rank's pieces, then over
        ``model`` where a piece holds more than its moments cover."""
        comm = self.comm
        for lf, layers in zip(self.leaves, self._per_leaf(model.flat_params())):
            model_box = lf.local(self._model_box(lf))
            if lf.data_dim is not None and not lf.fsdp and comm.sizes.get("data", 1) > 1:
                view = self._views(lf, layers)
                t = self._joined(lf, pytree.leaf_layers(view))
                full = comm.all_gather(t, dim=lf.data_dim, axis="data", tag="zero")
                for r, p in enumerate(layers):
                    box = model_box[1:] if lf.stacked else model_box
                    _narrow(p, box).copy_(full[r] if lf.stacked else full)
            wide = [d for d, (b, p) in enumerate(zip(self._model_box(lf), lf.piece)) if b != p]
            if not wide:
                continue
            (d,) = wide
            t = _narrow(self._joined(lf, layers), model_box)
            full = comm.all_gather(t, dim=d, axis="model", tag="zero")
            lo, hi = lf.piece[d]
            full = full.narrow(d, lo, hi - lo)
            for r, p in enumerate(layers):
                p.copy_(full[r] if lf.stacked else full)

    # ---------------------------------------------------- whole leaves

    def whole_params(self, model: DecoderLM):
        """(leaf, the whole leaf) of every parameter leaf in order, gathered
        one at a time (a stacked leaf as ``[R, ...]``): the model ranks'
        pieces all-gathered and placed by :func:`_piece_box` (ranks that
        share a kv head hold the same columns; an expert bank's pieces also
        over ``data``).  Every rank walks every leaf."""
        m = self.shard.m
        for lf, layers in zip(self.leaves, self._per_leaf(model.flat_params())):
            t = self._joined(lf, [p.detach() for p in layers])
            if m == 1 and not lf.fsdp:
                yield lf, t
                continue
            parts = self.comm.all_gather(t[None], dim=0, axis="model", tag="ckpt")
            if lf.fsdp:
                parts = self.comm.all_gather(parts[None], dim=0, axis="data", tag="ckpt")
            out = t.new_empty(lf.shape)
            for q in range(len(parts) if lf.fsdp else 1):
                for r in range(m):
                    _place(out, self._piece_of(lf, r, q), parts[q][r] if lf.fsdp else parts[r])
            yield lf, out

    def _piece_of(self, lf: _Leaf, r: int, q: int | None = None) -> tuple:
        """Model rank ``r``'s (and data rank ``q``'s) parameter piece of ``lf``
        (whole-leaf coordinates)."""
        box = self.shard.piece_box(*_leaf_names(lf.key), lf.shape[1:] if lf.stacked else lf.shape,
                                   r, q)
        return ((0, lf.shape[0]),) + box if lf.stacked else box

    def whole_moments(self, pieces):
        """(leaf, the whole moment leaf) of every leaf of a moment tree of
        the rank's pieces, each all-gathered over the axes it splits on."""
        for lf, t in zip(self.leaves, pytree.leaves(pieces), strict=True):
            for d, span in enumerate(lf.box):
                if isinstance(span, Spans):         # each rank's spans placed
                    parts = self.comm.all_gather(t[None], dim=0, axis="model", tag="ckpt")
                    full = t.new_empty((*t.shape[:d], lf.shape[d], *t.shape[d + 1:]))
                    for r in range(self.shard.m):
                        box = tuple((0, n) for n in full.shape)
                        _place(full, box[:d] + (self._piece_of(lf, r)[d],) + box[d + 1:],
                               parts[r])
                    t = full
                elif _width(span) != lf.shape[d]:
                    axis = "data" if d == lf.data_dim else "model"
                    t = self.comm.all_gather(t, dim=d, axis=axis, tag="ckpt")
            yield lf, t

    @staticmethod
    def _checked(lf: _Leaf, whole: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if tuple(whole.shape) != lf.shape or whole.dtype != dtype:
            raise ValueError(f"{lf.key}: a whole leaf {whole.dtype} {list(whole.shape)}, the "
                             f"layout's {dtype} {list(lf.shape)}")
        return whole

    @torch.no_grad()
    def load_params(self, model: DecoderLM, whole_of) -> None:
        """The rank's parameter pieces written in place from the whole leaves
        ``whole_of(leaf)`` returns (a stacked one ``[R, ...]``), one at a time."""
        for lf, layers in zip(self.leaves, self._per_leaf(model.flat_params())):
            t = _narrow(self._checked(lf, whole_of(lf), layers[0].dtype), lf.piece)
            for p, x in zip(layers, t.unbind(0) if lf.stacked else [t], strict=True):
                p.copy_(x)

    @torch.no_grad()
    def load_moments(self, pieces, whole_of) -> None:
        """A moment tree of the rank's pieces written in place from the whole
        leaves ``whole_of(leaf)`` returns, one at a time."""
        for lf, t in zip(self.leaves, pytree.leaves(pieces), strict=True):
            t.copy_(_narrow(self._checked(lf, whole_of(lf), t.dtype), lf.box))

    def cut_moments(self, whole_tree):
        """A moment tree of the rank's pieces from a whole one (copies)."""
        it = iter(_narrow(t, lf.box).clone() for lf, t in
                  zip(self.leaves, pytree.leaves(whole_tree), strict=True))
        return pytree.map(lambda _: next(it), whole_tree)

    def zero_moments(self, device) -> OptState:
        """A fresh AdamW state of the rank's pieces (fp32 zeros)."""
        def zeros():
            it = iter(torch.zeros(lf.moment_shape, dtype=torch.float32,
                                  device=device) for lf in self.leaves)
            return _map_structure(self.o_specs.m, lambda: next(it))
        return OptState(step=torch.zeros((), dtype=torch.int32), m=zeros(), v=zeros())


def _map_structure(spec_tree, fn):
    """``spec_tree``'s containers with each PartitionSpec leaf replaced by ``fn()``."""
    if isinstance(spec_tree, PartitionSpec):
        return fn()
    if isinstance(spec_tree, dict):
        return {k: _map_structure(spec_tree[k], fn) for k in sorted(spec_tree)}
    if isinstance(spec_tree, (tuple, list)):
        return type(spec_tree)(_map_structure(x, fn) for x in spec_tree)
    return fn()


def train_layout(model: DecoderLM) -> TrainLayout:
    """The :class:`TrainLayout` of a rank's shard (``shard_model``'s), built once."""
    sh = model.shard
    if sh is None:
        raise ValueError("train_layout takes a rank's shard of a mesh (shard_model)")
    layout = getattr(model, "_train_layout", None)
    if layout is None:
        layout = TrainLayout(model.cfg, sh.plan, sh.mesh, sh)
        model._train_layout = layout
    return layout


def shard_opt_state(opt_state: OptState, model: DecoderLM) -> OptState:
    """This rank's pieces of a whole AdamW ``OptState`` (``adamw_init`` of
    the whole model, or a one-rank run's), for the rank's shard ``model``
    (``shard_model``'s): each moment cut by the reference's optimizer specs
    (:func:`train_specs`), the step kept."""
    layout = train_layout(model)
    return OptState(step=opt_state.step.clone(), m=layout.cut_moments(opt_state.m),
                    v=layout.cut_moments(opt_state.v))
