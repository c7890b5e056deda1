"""Phase DSE: disaggregated vs colocated prefill/decode deployments.

A copy of the JAX package's ``serving/llm/phases.py``, which is JAX-free.

An autoregressive request is two workloads with opposite shapes: prefill is
one compute-dense pass over the prompt (the ``lm_graph(cfg, S)`` the facade
already schedules), decode is ``n_out - 1`` latency-bound single-token
passes against a growing KV cache (``lm_graph(cfg, S, decode=True)``).  The
phase DSE schedules both graphs per model and searches two deployments:

* **disaggregated** -- separate prefill and decode quotas per model (2N
  quotas through the min-rate allocator), with the prompt's KV cache handed
  off over the mesh boundary between them, charged like the merged mode's
  model-boundary staging: a rate cap of ``handoff_bw / kv_prompt_bytes`` on the
  whole mix plus a per-request latency the executor adds to TTFT.
* **colocated** -- one quota per model; prefill batches and decode steps
  interleave on the same server (no hand-off, but the phases steal beats
  from each other at serve time).

Decode quotas use KV-bounded curves (:func:`~repro_torch.multimodel.curves.
kv_bound_curve`): where the quota's KV budget holds fewer than ``m``
sequences, its curve flattens at the memory bound instead of the compute
bound, so the allocator sees memory starvation directly.

Rates are *mix rates* in the co-scheduler's sense: ``r`` such that model ``i``
receives ``r * weight_i`` requests/s, each costing one prefill sample and
``output_tokens - 1`` decode samples (the first token is produced by the
prefill pass itself).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

from ...core.costmodel import CostModel
from ...core.fastcost import FastCostModel
from ...core.graph import ScopeSchedule
from ...core.hw import HardwareModel
from ...core.workloads.lm import lm_graph
from ...models.config import ModelConfig
from ...multimodel.curves import kv_bound_curve, throughput_curve
from ...multimodel.quota import package_flavors
from ...obs import current_tracer
from .kv import UNBOUNDED, kv_seq_bytes


@dataclass
class PhaseAssignment:
    """One model's slice of an :class:`LLMPlan`."""
    model: str                     # config name (traffic key)
    weight: float
    cfg: ModelConfig
    prefill_chips: int
    decode_chips: int              # colocated: == prefill_chips (one server)
    prefill_schedule: ScopeSchedule
    decode_schedule: ScopeSchedule | None   # None when output_tokens <= 1
    kv_seq_bytes: float            # resident state/seq at full context
    kv_capacity_bytes: float       # the searched bound (decode quota memory)
    max_seqs: int                  # floor(capacity / kv_seq_bytes)
    rate: float                    # requests/s this model sustains at the mix


@dataclass
class LLMPlan:
    """A solved phase deployment -- the token executor's input."""
    package: str
    chips: int
    mode: str                      # "disaggregated" | "colocated"
    chip_type: str | None
    seq_len: int
    output_tokens: float
    assignments: list[PhaseAssignment]
    mix_rate: float                # requests/s per unit of mix weight
    handoff_bw: float              # bytes/s for prefill->decode KV transfer
    meta: dict = field(default_factory=dict)

    @property
    def used_chips(self) -> int:
        if self.mode == "colocated":
            return sum(a.prefill_chips for a in self.assignments)
        return sum(a.prefill_chips + a.decode_chips for a in self.assignments)

    @property
    def token_rate(self) -> float:
        """Output tokens/s of the whole mix at the sustainable rate."""
        return self.mix_rate * sum(
            a.weight * self.output_tokens for a in self.assignments
        )


def _allocate(tables: list[list[float]], chips: int) -> tuple[float, list[int]]:
    """Split ``chips`` among items maximizing the *minimum* per-item rate.

    ``tables[i][q]`` is item ``i``'s rate when granted ``q`` chips (a
    monotone envelope lookup, so non-decreasing in ``q``).  Classic minimax
    allocation DP, O(items * chips^2) -- cheap at package scale.
    """
    n = len(tables)
    nxt = [math.inf] * (chips + 1)
    choice = [[0] * (chips + 1) for _ in range(n)]
    for i in range(n - 1, -1, -1):
        cur = [0.0] * (chips + 1)
        t = tables[i]
        for c in range(chips + 1):
            best, best_q = -1.0, 0
            for q in range(c + 1):
                v = min(t[q], nxt[c - q])
                if v > best:
                    best, best_q = v, q
            cur[c] = best
            choice[i][c] = best_q
        nxt = cur
    quotas, c = [], chips
    for i in range(n):
        q = choice[i][c]
        quotas.append(q)
        c -= q
    return nxt[chips], quotas


def solve_phases(
    cfgs: list[ModelConfig],
    weights: list[float],
    hw: HardwareModel,
    cost: CostModel | None = None,
    *,
    seq_len: int,
    output_tokens: float = 64.0,
    mode: str = "auto",
    step: int = 1,
    paper_strict: bool = False,
    m_samples: int = 16,
) -> tuple[LLMPlan | None, dict]:
    """Search phase deployments for an LLM mix; returns ``(plan, diag)``.

    ``mode`` picks the family ("disaggregated" / "colocated") or lets the
    search choose ("auto").  ``diag["plans"]`` carries *both* solved plans
    so callers (benchmarks, CLI baselines) can replay the loser on the
    same trace.
    """
    if mode not in ("auto", "disaggregated", "colocated"):
        raise ValueError(f"unknown phase mode {mode!r}")
    if len(cfgs) != len(weights) or not cfgs:
        raise ValueError("cfgs and weights must align and be non-empty")
    if cost is None:
        cost = FastCostModel(hw, m_samples=m_samples)
    t0 = time.time()
    tr = current_tracer()
    # Phase quotas live in one flavor pool (the largest on hetero packages);
    # spanning quotas for LLM phases are future work.
    ctype, cap = max(package_flavors(hw), key=lambda f: f[1])

    n_d = max(0.0, output_tokens - 1.0)    # decode tokens per request
    env_p: dict[str, list] = {}
    env_d: dict[str, list] = {}
    seq_bytes: dict[str, float] = {}
    prompt_bytes: dict[str, float] = {}
    full_ctx = seq_len + int(math.ceil(output_tokens))
    for cfg in cfgs:
        with tr.span("llm:curves", model=cfg.name, chips=cap):
            cp = throughput_curve(cost, lm_graph(cfg, seq_len), cap,
                                  ctype, step, paper_strict)
            cd = throughput_curve(cost, lm_graph(cfg, seq_len, decode=True),
                                  cap, ctype, step, paper_strict)
        sb = kv_seq_bytes(cfg, full_ctx)
        seq_bytes[cfg.name] = sb
        prompt_bytes[cfg.name] = kv_seq_bytes(cfg, seq_len)
        env_p[cfg.name] = cp.envelope(cap)
        env_d[cfg.name] = kv_bound_curve(
            cd, sb, hw.kv_bytes_per_chip).envelope(cap)

    def p_rate(name: str, q: int, w: float) -> float:
        pt = env_p[name][q] if q else None
        return pt.throughput / w if pt else 0.0

    def d_rate(name: str, q: int, w: float) -> float:
        if n_d <= 0:
            return math.inf
        pt = env_d[name][q] if q else None
        return pt.throughput / (w * n_d) if pt else 0.0

    # The KV hand-off crosses the quota boundary like a model seam: budget
    # one mesh cut of flavor links, shared by the whole mix.
    handoff_bw = hw.flavor_link_bw(ctype) * min(hw.mesh_shape)

    # ---- disaggregated: 2N quotas through the min-rate allocator --------
    tables, items = [], []
    for cfg, w in zip(cfgs, weights):
        tables.append([p_rate(cfg.name, q, w) for q in range(cap + 1)])
        items.append((cfg.name, "prefill"))
        if n_d > 0:
            tables.append([d_rate(cfg.name, q, w) for q in range(cap + 1)])
            items.append((cfg.name, "decode"))
    r_disagg, quotas = _allocate(tables, cap)
    kv_flux = sum(w * prompt_bytes[c.name] for c, w in zip(cfgs, weights))
    handoff_cap = handoff_bw / kv_flux if kv_flux > 0 else math.inf
    r_disagg = min(r_disagg, handoff_cap)
    disagg_q = {}
    for (name, phase), q in zip(items, quotas):
        disagg_q.setdefault(name, {})[phase] = q

    # ---- colocated: one quota per model, phases share the server --------
    tables = []
    for cfg, w in zip(cfgs, weights):
        row = []
        for q in range(cap + 1):
            rp, rd = p_rate(cfg.name, q, w), d_rate(cfg.name, q, w)
            row.append(0.0 if not (rp and rd)
                       else 1.0 / (1.0 / rp + (1.0 / rd if rd < math.inf else 0.0)))
        tables.append(row)
    r_coloc, quotas_c = _allocate(tables, cap)
    coloc_q = {cfg.name: q for cfg, q in zip(cfgs, quotas_c)}

    def build(mode_: str, rate: float) -> LLMPlan | None:
        if rate <= 0:
            return None
        assignments = []
        for cfg, w in zip(cfgs, weights):
            name, sb = cfg.name, seq_bytes[cfg.name]
            if mode_ == "disaggregated":
                qp = disagg_q[name].get("prefill", 0)
                qd = disagg_q[name].get("decode", 0)
                pp = env_p[name][qp] if qp else None
                pd = env_d[name][qd] if qd else None
            else:
                q = coloc_q[name]
                pp = env_p[name][q] if q else None
                pd = env_d[name][q] if q else None
            if pp is None or (n_d > 0 and pd is None):
                return None
            if mode_ == "colocated":
                # one physical quota sized for the hungrier phase
                chips = max(pp.chips, pd.chips if pd else 0)
                pchips = dchips = chips
            else:
                pchips = pp.chips
                dchips = pd.chips if pd else 0
            kv_cap = hw.kv_bytes_per_chip * dchips
            assignments.append(PhaseAssignment(
                model=name, weight=w, cfg=cfg,
                prefill_chips=pchips, decode_chips=dchips,
                prefill_schedule=pp.schedule,
                decode_schedule=pd.schedule if pd else None,
                kv_seq_bytes=sb,
                kv_capacity_bytes=kv_cap,
                max_seqs=(int(kv_cap // sb) if sb > 0 else UNBOUNDED),
                rate=rate * w,
            ))
        return LLMPlan(
            package=hw.name, chips=hw.chips, mode=mode_, chip_type=ctype,
            seq_len=seq_len, output_tokens=output_tokens,
            assignments=assignments, mix_rate=rate,
            handoff_bw=handoff_bw if mode_ == "disaggregated" else 0.0,
        )

    plans = {"disaggregated": build("disaggregated", r_disagg),
             "colocated": build("colocated", r_coloc)}
    mode_rates = {m: (p.mix_rate if p else 0.0) for m, p in plans.items()}
    if mode == "auto":
        chosen = max(plans, key=lambda m: mode_rates[m])
    else:
        chosen = mode
    plan = plans[chosen]
    diag = {
        "plans": plans,
        "mode_rates": mode_rates,
        "handoff_rate_cap": handoff_cap,
        "dse_s": time.time() - t0,
        "engine_stats": dict(cost.stats) if hasattr(cost, "stats") else {},
    }
    if plan is not None:
        plan.meta.update({"mode_rates": mode_rates, "dse_s": diag["dse_s"],
                          "m_samples": cost.m})
    return plan, diag


def describe_llm(plan: LLMPlan) -> list[str]:
    """Human-readable phase plan summary (CLI / examples)."""
    lines = [
        f"{plan.package}: {len(plan.assignments)} models, mode={plan.mode}, "
        f"mix rate {plan.mix_rate:.2f} req/s, "
        f"{plan.token_rate:.1f} tokens/s "
        f"(prefill {plan.seq_len} tok, ~{plan.output_tokens:g} out)"
    ]
    for a in plan.assignments:
        kv = (f"KV {a.kv_capacity_bytes / 2**20:.0f} MiB "
              f"(<= {a.max_seqs} seqs)" if a.max_seqs < UNBOUNDED else "KV -")
        if plan.mode == "colocated":
            quota = f"{a.prefill_chips:3d} chips shared"
        else:
            quota = f"{a.prefill_chips:3d}p + {a.decode_chips:3d}d chips"
        lines.append(
            f"  {a.model:20s} w={a.weight:g}  {quota}  "
            f"{a.rate:8.2f} req/s  {kv}"
        )
    return lines
