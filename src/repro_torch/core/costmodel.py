"""Scope analytical cost model: paper Eqs. 1-7 + Table II.

A copy of the JAX package's ``core/costmodel.py``, which is JAX-free.

Phase decomposition per layer (paper SSIII-A):

* preparation  (Eq. 4): weight delivery.  Segment-level DRAM loads are charged
  once per segment deployment; the distributed-weight-buffering exchange
  (paper SSIII-B) is charged per pipeline beat.
* computation  (Eq. 5): FLOPs / (chips x peak x util), where ``util`` models
  tiling quantization: ISP shrinks the weight-output dim per chip, WSP shrinks
  the activation dim per chip (this reproduces the paper's observation that
  ISP "reduces the parallelizable weight dimension").
* communication (Eq. 6 / Table II): activation redistribution to the next
  layer, which depends on both layers' partitions and whether the next layer
  lives in the same region (Case1) or the next region (Case2).

Eq. 7 overlaps computation and NoP communication:
``T_layer = T_pre + max(T_comm, T_comp)``.

Deviation from the literal equations (documented in DESIGN.md): Eq. 3 as
printed charges T_pre per sample.  With weight-stationary regions, DRAM weight
loads happen once per segment *deployment*; we charge them once and keep only
the per-beat distributed-buffer exchange inside the steady-state beat time.
Set ``literal_pre=True`` to reproduce the literal reading.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .graph import (
    PARTITION_EP,
    PARTITION_ISP,
    PARTITION_WSP,
    ClusterAssignment,
    LayerGraph,
    LayerNode,
    ScopeSchedule,
    SegmentSchedule,
)
from .hw import HardwareModel, eff

INF = float("inf")

# Sentinel for ``next_chip_type``: "the consuming cluster has the same flavor
# as the producer" -- the homogeneous-pipeline default, which keeps every
# pre-mixed-flavor call site's behavior (and results) unchanged.  ``None`` is
# a real flavor (the package's base type), so it cannot double as the default.
SAME_FLAVOR = "<same>"


def _flavor_tuple(chip_type, n_clusters: int) -> tuple:
    """Normalize a schedule-level or per-cluster flavor argument.

    ``chip_type`` may be ``None``/a flavor name (every cluster on that
    flavor, the pre-mixed-flavor calling convention) or a sequence of
    per-cluster flavors (mixed pipelines).
    """
    if chip_type is None or isinstance(chip_type, str):
        return (chip_type,) * n_clusters
    types = tuple(chip_type)
    if len(types) != n_clusters:
        raise ValueError(
            f"{len(types)} chip types for {n_clusters} clusters"
        )
    return types


# --------------------------------------------------------------- attribution
# Fixed component order: the conservation fold sums in exactly this order, so
# "components sum to the scalar" is a bit-exact statement, not an approximate
# one (see conserve_components).
BREAKDOWN_COMPONENTS = ("compute", "nop_comm", "seam", "dram", "staging")

# Component -> bottleneck label ("what is this stage bound by").
BOUND_LABELS = {"compute": "compute", "nop_comm": "link", "seam": "seam",
                "dram": "dram", "staging": "staging"}


def fold_components(components: dict, order=BREAKDOWN_COMPONENTS) -> float:
    """Left-to-right sum in a fixed component order."""
    total = 0.0
    for name in order:
        total += components.get(name, 0.0)
    return total


def conserve_components(components: dict, total: float,
                        order=BREAKDOWN_COMPONENTS) -> dict:
    """Adjust ``components`` so :func:`fold_components` equals ``total``
    *bit-identically*.

    The per-component charges are recomputed with the same arithmetic the
    scalar used, but accumulated per category rather than per layer -- a
    different floating-point summation order, so the fold can differ from
    the optimized scalar by a few ulps.  The residual is folded into the
    dominant bucket until exact; if rounding refuses to converge (or the
    scalar is non-finite: an infeasible placement), the degenerate-but-exact
    fallback parks the whole scalar in one bucket (``x + 0.0 == x``).

    The serving layer reuses this with its own ``order`` (latency-waterfall
    components); the same bit-exactness argument applies.
    """
    out = {k: float(components.get(k, 0.0)) for k in order}
    if not math.isfinite(total):
        # Infeasible cluster: place_weights ran out of per-chip DRAM/SRAM
        # residency, so the infinity is a memory fact.
        out = dict.fromkeys(order, 0.0)
        out["dram" if "dram" in out else order[0]] = total
        return out
    for _ in range(64):
        residual = total - fold_components(out, order)
        if residual == 0.0:
            return out
        out[max(out, key=lambda k: abs(out[k]))] += residual
    top = max(out, key=lambda k: abs(out[k]))
    out = dict.fromkeys(order, 0.0)
    out[top] = total
    return out


@dataclass(frozen=True)
class CostBreakdown:
    """A scalar cost split into additive components that *conserve* it.

    ``components`` maps every name in :data:`BREAKDOWN_COMPONENTS` to
    seconds; folding them in that fixed order reproduces ``total``
    bit-identically (the invariant ``conserved`` checks).  ``bottleneck``
    names the largest component, ``bound`` its human label
    (compute/link/seam/dram/staging).
    """
    total: float
    components: dict

    @property
    def conserved(self) -> bool:
        return fold_components(self.components) == self.total

    @property
    def bottleneck(self) -> str:
        return max(self.components, key=lambda k: self.components[k])

    @property
    def bound(self) -> str:
        return BOUND_LABELS[self.bottleneck]

    def to_json(self) -> dict:
        return {"total": self.total, "bound": self.bound,
                "components": dict(self.components)}

    @classmethod
    def build(cls, components: dict, total: float) -> "CostBreakdown":
        return cls(total=total,
                   components=conserve_components(components, total))

    @classmethod
    def merge(cls, parts, total: float) -> "CostBreakdown":
        """Sum breakdowns (e.g. per-segment -> whole schedule), re-conserved
        against the combined scalar."""
        buckets = dict.fromkeys(BREAKDOWN_COMPONENTS, 0.0)
        for p in parts:
            for k, v in p.components.items():
                buckets[k] += v
        return cls.build(buckets, total)


@dataclass(frozen=True)
class LayerTime:
    pre: float
    comp: float
    comm: float

    @property
    def total(self) -> float:          # Eq. 7
        return self.pre + max(self.comm, self.comp)

    @property
    def unoverlapped(self) -> float:
        return self.pre + self.comm + self.comp


@dataclass(frozen=True)
class WeightPlacement:
    """How a cluster's weights sit in the region (paper SSIII-B)."""
    resident_bytes_per_chip: float
    transient_bytes_per_chip: float      # peak scratch for the active gather
    gather_bytes: tuple[float, ...]      # per-layer per-beat NoP receive / chip
    feasible: bool


class CostModel:
    def __init__(
        self,
        hw: HardwareModel,
        m_samples: int = 16,
        overlap: bool = True,
        distributed_weights: bool = True,
        literal_pre: bool = False,
    ):
        self.hw = hw
        self.m = m_samples
        self.overlap = overlap
        self.distributed_weights = distributed_weights
        self.literal_pre = literal_pre
        self._typed_hw: dict[str | None, HardwareModel] = {}
        self._seam_bw: dict[tuple[str | None, str | None], float] = {}
        # engine counters (same schema as FastCostModel.stats; the reference
        # model has no memo, so every cluster probe is a compute)
        self._evals = 0
        self._misses = 0
        self._probes = 0
        self._batched_bodies = 0
        self._batch_evals = 0
        self._batch_rows = 0

    @property
    def stats(self) -> dict:
        """Engine work counters (schema shared with :class:`FastCostModel`)."""
        return {
            "segment_evals": self._evals,
            "cluster_computes": self._misses,
            "cluster_probes": self._probes,
            "memo_hits": self._probes - self._misses,
            "memo_cells": 0,
            "memo_entries": 0,
            "batched_bodies": self._batched_bodies,
            "batch_evals": self._batch_evals,
            "batch_rows": self._batch_rows,
        }

    def hw_for(self, chip_type: str | None) -> HardwareModel:
        """The hardware a region of ``chip_type`` chips sees (hetero packages;
        ``None``/base type returns ``self.hw`` unchanged)."""
        if not chip_type:
            return self.hw
        hw = self._typed_hw.get(chip_type)
        if hw is None:
            hw = self._typed_hw[chip_type] = self.hw.typed(chip_type)
        return hw

    def seam_bw(self, a: str | None, b: str | None) -> float:
        """Cached :meth:`HardwareModel.seam_link_bw` for a flavor pair."""
        bw = self._seam_bw.get((a, b))
        if bw is None:
            bw = self._seam_bw[(a, b)] = self.hw.seam_link_bw(a, b)
        return bw

    # ------------------------------------------------------------------ utils
    def _util(self, layer: LayerNode, p: str, n: int,
              hw: HardwareModel | None = None) -> float:
        hw = hw or self.hw
        if p == PARTITION_WSP:
            m_local = layer.wsp_parallel / n
            n_local = layer.isp_parallel
        elif p == PARTITION_ISP:
            m_local = layer.wsp_parallel
            n_local = layer.isp_parallel / n
        else:  # EP: experts spread over chips; within an expert both dims intact
            m_local = layer.wsp_parallel * (layer.active_experts / max(1, layer.n_experts))
            n_local = layer.isp_parallel
        return eff(m_local, hw.m_granule) * eff(n_local, hw.n_granule)

    def comp_time(self, layer: LayerNode, p: str, n: int,
                  chip_type: str | None = None) -> float:
        """Eq. 5 (Timeloop regression replaced by peak x tiling-efficiency)."""
        hw = self.hw_for(chip_type)
        util = self._util(layer, p, n, hw)
        return layer.flops / (n * hw.flops_per_chip * util)

    # -------------------------------------------------------------- Table II
    def comm_volume(
        self,
        layer: LayerNode,
        p: str,
        n: int,
        next_p: str | None,
        next_n: int | None,
        same_region: bool,
    ) -> float:
        """NoP bytes produced by ``layer``'s output redistribution (Table II)."""
        if next_p is None:            # network output: leaves via DRAM, no NoP
            return 0.0
        out = layer.out_bytes
        # ``halo_bytes`` is per split boundary; an n-way WSP split has n-1 seams.
        halo = layer.halo_bytes * max(0, n - 1)
        if p == PARTITION_EP or next_p == PARTITION_EP:
            # Beyond-paper: expert dispatch/combine is an all-to-all of the
            # token activations, volume ~ out each way.
            return 2.0 * out
        if same_region:               # Case 1
            if p == PARTITION_WSP and next_p == PARTITION_WSP:
                return halo
            if p == PARTITION_WSP and next_p == PARTITION_ISP:
                return (n - 1) * out
            if p == PARTITION_ISP and next_p == PARTITION_WSP:
                return (n - 1) * out + halo
            return (n - 1) * out      # ISP -> ISP
        # Case 2: hand-off to the next cluster's region
        if next_p == PARTITION_WSP:
            return out
        return (next_n or 1) * out    # replicate into every chip of next region

    def comm_time(
        self,
        layer: LayerNode,
        p: str,
        n: int,
        next_p: str | None,
        next_n: int | None,
        same_region: bool,
        chip_type: str | None = None,
        next_chip_type: str | None = SAME_FLAVOR,
    ) -> float:
        vol = self.comm_volume(layer, p, n, next_p, next_n, same_region)
        if vol <= 0:
            return 0.0
        # The producing region's flavor bounds its injection bandwidth; the
        # boundary links are shared with the consuming region, so a flavor
        # seam runs at the weaker flavor's link rate (hw.seam_link_bw).
        hw = self.hw_for(chip_type)
        if same_region:
            # Collectives inside the region: aggregate injection bandwidth.
            return vol / (n * hw.nop_bw_per_chip)
        # Region boundary: limited by the links crossing the ZigZag seam
        # (stand-in for the paper's BookSim regression, see DESIGN.md SS3).
        if next_chip_type is SAME_FLAVOR or next_chip_type == chip_type:
            link_bw = hw.link_bw
        else:
            link_bw = self.seam_bw(chip_type, next_chip_type)
        links = max(1, round(math.sqrt(min(n, next_n or n))))
        boundary = vol / (links * link_bw)
        injection = vol / (n * hw.nop_bw_per_chip)
        return max(boundary, injection)

    # ------------------------------------------------------ weight placement
    def place_weights(
        self, graph: LayerGraph, cluster: ClusterAssignment
    ) -> WeightPlacement:
        """Greedy residency plan for a cluster (paper SSIII-B).

        ISP/EP layers are sharded by construction.  WSP layers start
        replicated; while over capacity, the largest replicated WSP layer
        flips to distributed storage (tile resident, full copy gathered
        per beat).
        """
        n = cluster.region_chips
        layers = graph.layers[cluster.layer_lo : cluster.layer_hi]
        resident = []
        wsp_idx = []
        for k, (layer, p) in enumerate(zip(layers, cluster.partitions)):
            if p == PARTITION_WSP:
                resident.append(layer.weight_bytes)      # replicated
                wsp_idx.append(k)
            elif p == PARTITION_EP:
                resident.append(layer.weight_bytes / min(n, max(1, layer.n_experts)))
            else:
                resident.append(layer.weight_bytes / n)  # ISP shard
        gather = [0.0] * len(layers)
        cap = self.hw.weight_capacity_per_chip
        if self.distributed_weights:
            order = sorted(wsp_idx, key=lambda k: -layers[k].weight_bytes)
            ptr = 0
            while sum(resident) > cap and ptr < len(order):
                k = order[ptr]
                w = layers[k].weight_bytes
                resident[k] = w / n
                gather[k] = w * (n - 1) / n      # received per chip per beat
                ptr += 1
        # Distributed WSP compute proceeds ring-style: compute with tile t
        # while receiving tile t+1 ("chiplets exchange their weight tiles",
        # paper SSIII-B) => transient scratch is two tiles, not the full matrix.
        transient = max(
            (2.0 * layers[k].weight_bytes / n for k in range(len(layers)) if gather[k] > 0),
            default=0.0,
        )
        feasible = (sum(resident) + transient) <= cap
        return WeightPlacement(sum(resident), transient, tuple(gather), feasible)

    # --------------------------------------------------------------- layers
    def layer_time(
        self,
        layer: LayerNode,
        p: str,
        n: int,
        next_p: str | None,
        next_n: int | None,
        same_region: bool,
        gather_bytes: float = 0.0,
        extra_pre: float = 0.0,
        chip_type: str | None = None,
        next_chip_type: str | None = SAME_FLAVOR,
    ) -> LayerTime:
        pre = extra_pre
        if gather_bytes > 0:
            pre += gather_bytes / self.hw_for(chip_type).nop_bw_per_chip
        comp = self.comp_time(layer, p, n, chip_type)
        comm = self.comm_time(layer, p, n, next_p, next_n, same_region,
                              chip_type, next_chip_type)
        return LayerTime(pre=pre, comp=comp, comm=comm)

    # -------------------------------------------------------------- clusters
    def cluster_time(
        self,
        graph: LayerGraph,
        cluster: ClusterAssignment,
        next_cluster: ClusterAssignment | None,
        first_in_segment: bool,
        last_in_segment: bool,
    ) -> float:
        """Steady-state beat time of one cluster (Eq. 3 with Eq. 7 per layer)."""
        self._probes += 1
        self._misses += 1
        placement = self.place_weights(graph, cluster)
        if not placement.feasible:
            return INF
        n = cluster.region_chips
        layers = graph.layers[cluster.layer_lo : cluster.layer_hi]
        total = 0.0
        for k, (layer, p) in enumerate(zip(layers, cluster.partitions)):
            last_layer = k == len(layers) - 1
            nxt_t = SAME_FLAVOR
            if not last_layer:
                nxt_p, nxt_n, same = cluster.partitions[k + 1], n, True
            elif next_cluster is not None:
                nxt_p, nxt_n, same = next_cluster.partitions[0], next_cluster.region_chips, False
                nxt_t = next_cluster.chip_type
            else:
                nxt_p, nxt_n, same = None, None, False
            extra_pre = 0.0
            if self.literal_pre:
                extra_pre += layer.weight_bytes / self.hw.dram_bw_total
            t = self.layer_time(
                layer, p, n, nxt_p, nxt_n, same,
                gather_bytes=placement.gather_bytes[k],
                extra_pre=extra_pre,
                chip_type=cluster.chip_type,
                next_chip_type=nxt_t,
            )
            total += t.total if self.overlap else t.unoverlapped
        return total

    # ------------------------------------------------------------ populations
    def cluster_population(self, graph: LayerGraph, rows) -> "np.ndarray":
        """Batched population evaluator: score a ``(K, ...)`` batch of cluster
        configurations in one call.

        Each row is ``(lo, hi, spec, n, next_p0, next_n, ctype, next_ctype)``
        with global layer bounds ``[lo, hi)``.  ``spec`` is either an explicit
        partition tuple (first element a partition string) or an Algorithm 1
        transition hint ``(k, ep)``: WSP for the first ``k`` layers, ISP for
        the rest, MoE layers flipped to EP when ``ep``.  ``next_p0`` is the
        consuming cluster's first partition (``None`` = network output) and
        ``next_ctype`` its flavor (:data:`SAME_FLAVOR` = producer's flavor).

        Returns a float64 array of the K steady-state cluster beat times.
        The reference implementation scores rows one at a time through
        :meth:`cluster_time`; :class:`repro_torch.core.fastcost.FastCostModel`
        overrides it with per-row memo consults plus grouped vectorized body
        fills, so cache semantics are unchanged while the arithmetic runs as
        one array program per distinct cluster cell.
        """
        out = np.empty(len(rows), dtype=np.float64)
        self._batch_evals += 1
        self._batch_rows += len(rows)
        for i, (lo, hi, spec, n, next_p0, next_n, ctype, next_ctype) in enumerate(rows):
            if spec and isinstance(spec[0], str):
                partitions = tuple(spec)
            else:
                k, ep = spec
                parts = [PARTITION_WSP] * k + [PARTITION_ISP] * (hi - lo - k)
                if ep:
                    for d, layer in enumerate(graph.layers[lo:hi]):
                        if layer.n_experts > 1:
                            parts[d] = PARTITION_EP
                partitions = tuple(parts)
            cluster = ClusterAssignment(
                layer_lo=lo, layer_hi=hi, region_chips=n,
                partitions=partitions, chip_type=ctype,
            )
            nxt = None
            if next_p0 is not None:
                nxt_t = ctype if next_ctype is SAME_FLAVOR else next_ctype
                nxt = ClusterAssignment(
                    layer_lo=hi, layer_hi=hi + 1, region_chips=next_n or 1,
                    partitions=(next_p0,), chip_type=nxt_t,
                )
            out[i] = self.cluster_time(
                graph, cluster, nxt,
                first_in_segment=False, last_in_segment=nxt is None,
            )
        return out

    # -------------------------------------------------------------- segments
    def segment_time(
        self, graph: LayerGraph, clusters: tuple[ClusterAssignment, ...]
    ) -> tuple[float, list[float]]:
        """Eq. 2: (m + Nc - 1) * max_j T_cluster + one-time weight load."""
        self._evals += 1
        times = []
        for j, cl in enumerate(clusters):
            nxt = clusters[j + 1] if j + 1 < len(clusters) else None
            times.append(
                self.cluster_time(
                    graph, cl, nxt,
                    first_in_segment=(j == 0),
                    last_in_segment=(nxt is None),
                )
            )
        bottleneck = max(times)
        if bottleneck == INF:
            return INF, times
        # Sequential-deployment overheads (the anti-segment force of Fig. 1b):
        # before the pipeline wave can run, the segment's weights and the
        # batch's input activations must be staged through shared DRAM.  The
        # output-side spill overlaps with the pipeline drain and is not
        # serialized.
        load = 0.0
        if not self.literal_pre:
            seg_weights = sum(
                graph.layers[i].weight_bytes
                for cl in clusters
                for i in range(cl.layer_lo, cl.layer_hi)
            )
            load += seg_weights / self.hw.dram_bw_total
        first_lo = clusters[0].layer_lo
        load += self.m * graph.layers[first_lo].in_bytes / self.hw.dram_bw_total
        # Mid-segment DRAM-staged entry layers (merged multi-model graphs
        # mark model boundaries with meta["dram_input"]): their inputs are
        # staged like a segment start's, wherever the boundary lands.
        for cl in clusters:
            for i in range(cl.layer_lo, cl.layer_hi):
                if i != first_lo and graph.layers[i].meta.get("dram_input"):
                    load += self.m * graph.layers[i].in_bytes / self.hw.dram_bw_total
        n_cl = len(clusters)
        return load + (self.m + n_cl - 1) * bottleneck, times

    # ------------------------------------------------------------ attribution
    def comm_kind(
        self,
        layer: LayerNode,
        p: str,
        n: int,
        next_p: str | None,
        next_n: int | None,
        same_region: bool,
        chip_type: str | None = None,
        next_chip_type: str | None = SAME_FLAVOR,
    ) -> str:
        """Which component a :meth:`comm_time` charge belongs to.

        Intra-region collectives ride the NoP injection links
        (``nop_comm``); a region hand-off is ``seam`` when the boundary
        links bind (the ZigZag cut, flavor seam or not) and ``nop_comm``
        when the producer's injection bandwidth does.
        """
        if same_region:
            return "nop_comm"
        vol = self.comm_volume(layer, p, n, next_p, next_n, same_region)
        if vol <= 0:
            return "nop_comm"
        hw = self.hw_for(chip_type)
        if next_chip_type is SAME_FLAVOR or next_chip_type == chip_type:
            link_bw = hw.link_bw
        else:
            link_bw = self.seam_bw(chip_type, next_chip_type)
        links = max(1, round(math.sqrt(min(n, next_n or n))))
        boundary = vol / (links * link_bw)
        injection = vol / (n * hw.nop_bw_per_chip)
        return "seam" if boundary >= injection else "nop_comm"

    def cluster_breakdown(
        self,
        graph: LayerGraph,
        cluster: ClusterAssignment,
        next_cluster: ClusterAssignment | None,
        first_in_segment: bool,
        last_in_segment: bool,
    ) -> CostBreakdown:
        """Decompose :meth:`cluster_time` into BREAKDOWN_COMPONENTS.

        The scalar is obtained through ``self.cluster_time`` -- i.e. the
        *engine's own* entry point (memoized on FastCostModel) -- and the
        per-layer charges are re-derived with the reference arithmetic this
        class defines (FastCostModel inherits it unchanged), so the
        conserved breakdown sums bit-identically to the number the solver
        optimized on either engine.
        """
        total = self.cluster_time(graph, cluster, next_cluster,
                                  first_in_segment, last_in_segment)
        buckets = dict.fromkeys(BREAKDOWN_COMPONENTS, 0.0)
        if total == INF:
            return CostBreakdown.build(buckets, total)
        placement = self.place_weights(graph, cluster)
        n = cluster.region_chips
        layers = graph.layers[cluster.layer_lo : cluster.layer_hi]
        for k, (layer, p) in enumerate(zip(layers, cluster.partitions)):
            last_layer = k == len(layers) - 1
            nxt_t = SAME_FLAVOR
            if not last_layer:
                nxt_p, nxt_n, same = cluster.partitions[k + 1], n, True
            elif next_cluster is not None:
                nxt_p, nxt_n, same = (next_cluster.partitions[0],
                                      next_cluster.region_chips, False)
                nxt_t = next_cluster.chip_type
            else:
                nxt_p, nxt_n, same = None, None, False
            if self.literal_pre:
                buckets["dram"] += layer.weight_bytes / self.hw.dram_bw_total
            gather = placement.gather_bytes[k]
            if gather > 0:
                buckets["nop_comm"] += (
                    gather / self.hw_for(cluster.chip_type).nop_bw_per_chip)
            comp = self.comp_time(layer, p, n, cluster.chip_type)
            comm = self.comm_time(layer, p, n, nxt_p, nxt_n, same,
                                  cluster.chip_type, nxt_t)
            kind = self.comm_kind(layer, p, n, nxt_p, nxt_n, same,
                                  cluster.chip_type, nxt_t)
            if self.overlap:
                # Eq. 7 keeps only the winner of the overlap race; ties go
                # to comm, matching max(comm, comp) and the vectorized
                # engine's select.
                if comm >= comp:
                    buckets[kind] += comm
                else:
                    buckets["compute"] += comp
            else:
                buckets["compute"] += comp
                buckets[kind] += comm
        return CostBreakdown.build(buckets, total)

    def segment_breakdown(
        self, graph: LayerGraph, clusters: tuple[ClusterAssignment, ...]
    ) -> tuple[CostBreakdown, list[CostBreakdown]]:
        """Decompose :meth:`segment_time`: ``(segment, per-cluster)``.

        The pipeline wave repeats the bottleneck cluster's beat
        ``m + Nc - 1`` times, so the segment inherits that cluster's
        components at scale; the one-time deployment load splits into
        ``dram`` (segment weights) and ``staging`` (batch input staging,
        incl. mid-segment ``dram_input`` entries).
        """
        total, times = self.segment_time(graph, clusters)
        per_cluster = []
        for j, cl in enumerate(clusters):
            nxt = clusters[j + 1] if j + 1 < len(clusters) else None
            per_cluster.append(
                self.cluster_breakdown(graph, cl, nxt, j == 0, nxt is None))
        buckets = dict.fromkeys(BREAKDOWN_COMPONENTS, 0.0)
        if total == INF:
            return CostBreakdown.build(buckets, total), per_cluster
        if not self.literal_pre:
            seg_weights = sum(
                graph.layers[i].weight_bytes
                for cl in clusters
                for i in range(cl.layer_lo, cl.layer_hi)
            )
            buckets["dram"] += seg_weights / self.hw.dram_bw_total
        first_lo = clusters[0].layer_lo
        stage_bytes = self.m * graph.layers[first_lo].in_bytes
        for cl in clusters:
            for i in range(cl.layer_lo, cl.layer_hi):
                if i != first_lo and graph.layers[i].meta.get("dram_input"):
                    stage_bytes += self.m * graph.layers[i].in_bytes
        buckets["staging"] += stage_bytes / self.hw.dram_bw_total
        beats = self.m + len(clusters) - 1
        b = max(range(len(times)), key=lambda j: times[j])
        for name, v in per_cluster[b].components.items():
            buckets[name] += beats * v
        return CostBreakdown.build(buckets, total), per_cluster

    # --------------------------------------------------------- DSE interface
    def segment_evaluator(self, graph, seg_lo, clustering, partitions,
                          transition=None, chip_type=None):
        """Return ``eval_fn(alloc) -> (latency, per_cluster_times)``.

        ``transition`` is an optional Algorithm 1 sweep hint (ignored here;
        see :meth:`repro_torch.core.fastcost.FastCostModel.segment_evaluator`).
        ``chip_type`` evaluates the segment on a heterogeneous package: one
        flavor name runs every cluster on that flavor, a per-cluster
        sequence evaluates a mixed-flavor pipeline (boundary comm between
        differently-flavored neighbors is charged through the seam model).

        The DSE (search.py) funnels every candidate region allocation of a
        fixed (clustering, partitions) choice through this closure.  The
        reference implementation rebuilds ClusterAssignments and re-derives
        every cluster from scratch; :class:`repro_torch.core.fastcost.FastCostModel`
        overrides it with a vectorized, memoized evaluator.
        """
        types = _flavor_tuple(chip_type, len(clustering))

        def eval_fn(alloc):
            clusters = tuple(
                ClusterAssignment(
                    layer_lo=seg_lo + lo,
                    layer_hi=seg_lo + hi,
                    region_chips=chips,
                    partitions=partitions[lo:hi],
                    chip_type=ctype,
                )
                for (lo, hi), chips, ctype in zip(clustering, alloc, types)
            )
            return self.segment_time(graph, clusters)

        return eval_fn

    def segment_sweeper(self, graph, seg_lo, clustering, chip_type=None):
        """Factory used by Algorithm 1: ``sweeper(partitions, transition) ->
        eval_fn`` for one clustering.  FastCostModel overrides this with a
        reusable evaluator that updates incrementally along the sweep."""
        def configure(partitions, transition=None):
            return self.segment_evaluator(
                graph, seg_lo, clustering, partitions, transition, chip_type
            )

        return configure

    # ---------------------------------------------------------------- system
    def system_time(self, graph: LayerGraph, segments) -> float:
        """Eq. 1."""
        total = 0.0
        for seg in segments:
            t, _ = self.segment_time(graph, seg if isinstance(seg, tuple) else seg.clusters)
            if t == INF:
                return INF
            total += t
        return total

    def evaluate(self, graph: LayerGraph, sched: ScopeSchedule) -> float:
        return self.system_time(graph, sched.segments)

    def throughput(self, graph: LayerGraph, sched_or_latency) -> float:
        lat = (
            sched_or_latency
            if isinstance(sched_or_latency, float)
            else self.evaluate(graph, sched_or_latency)
        )
        if lat == INF or lat <= 0:
            return 0.0
        return self.m / lat
