"""Batched + memoized DSE evaluation engine (drop-in for :class:`CostModel`).

A copy of the JAX package's ``core/fastcost.py``, which is JAX-free, except that the
``use_jit`` population tier (whose module the reference never committed)
raises: ROADMAP A15.

The reference :class:`~repro_torch.core.costmodel.CostModel` walks Python objects
layer by layer for every candidate the DSE proposes.  Algorithm 1 proposes
millions of candidates for the paper's larger cases (resnet152 x 256), and
nearly all of them share cluster sub-problems with candidates evaluated
moments earlier: the transition-point sweep changes a few layers' partitions,
the CMT sweep re-splits the same layer ranges, and ``rebalance`` moves one
chip between two regions while every other region is untouched.

:class:`FastCostModel` exploits this twice over:

1. **Vectorized cluster evaluation.**  Per graph it precomputes NumPy arrays
   of ``flops``, ``weight_bytes``, ``in/out_bytes``, ``halo_bytes``,
   ``wsp/isp_parallel`` and expert counts (plus a weight-bytes prefix sum for
   segment load terms).  A cluster's computation time (Eq. 5), intra-region
   communication (Table II Case 1), and the greedy weight-placement plan
   (paper SSIII-B) are then array expressions over ``layers[lo:hi]`` instead
   of per-layer Python loops.  The array expressions replicate the reference
   model's arithmetic *operation by operation* so results agree to the last
   few ulps (the parity suite in ``tests/test_fastcost.py`` asserts 1e-9
   rtol; in practice values are almost always bit-identical).

2. **Cross-candidate memoization.**  The steady-state beat time of a cluster
   (Eq. 3 body) depends only on

   ``(graph, layer_lo, layer_hi, partitions, region_chips, chip_type,
      next_first_partition, next_chips, next_chip_type)``

   which is exactly the memo key.  Why this is sound: every term of the
   reference ``cluster_time`` reads only (a) the layer records in
   ``[layer_lo, layer_hi)`` -- fixed by the graph and the bounds, (b) the
   per-layer partition choices, the region size ``n`` and the region's chip
   flavor -- in the key, and (c) for the *last* layer's Table II Case 2
   hand-off, the next cluster's first-layer partition, region size and chip
   flavor (the hand-off crosses the flavor seam, whose bandwidth depends on
   both endpoints' flavors) -- also in the key.  Nothing else
   (segment membership, position within the segment, the allocation of other
   regions) enters the formula, so two candidates that agree on the key have
   equal cluster cost by construction.  The memo is shared across the
   transition-point sweep, the CMT sweep, the rebalance walk, the
   segment-count sweep, and the baselines, because they all funnel through
   :meth:`FastCostModel.cluster_time` / :meth:`segment_evaluator`.

The memo is also what makes ``rebalance`` *incremental*: moving one chip
from region ``f`` to region ``s`` changes the keys of clusters ``f`` and
``s`` (their ``region_chips``) and of their left boundary neighbors
``f-1`` / ``s-1`` (their ``next_chips``); ``_SegmentSweep.move`` re-probes
exactly those slots and every other cluster of the segment keeps its cached
time, so a rebalance step costs O(changed clusters), not O(all clusters).
``FastCostModel.stats`` (segment_evals / cluster_computes / memo sizes)
exposes this in benchmarks.
"""
from __future__ import annotations

import math
from bisect import bisect_left, bisect_right
from dataclasses import dataclass

import numpy as np

from .costmodel import INF, SAME_FLAVOR, CostModel, _flavor_tuple
from .graph import ClusterAssignment, LayerGraph
from .hw import eff

_WSP, _ISP, _EP = 0, 1, 2
_CODE = {"WSP": _WSP, "ISP": _ISP, "EP": _EP}
_PSTR = {_WSP: "WSP", _ISP: "ISP", _EP: "EP"}


@dataclass(frozen=True)
class _GraphData:
    """Per-graph NumPy precomputation (held alive for id() stability)."""
    graph: LayerGraph
    flops: np.ndarray
    weight_bytes: np.ndarray
    in_bytes: np.ndarray
    out_bytes: np.ndarray
    halo_bytes: np.ndarray
    wsp: np.ndarray
    isp: np.ndarray
    n_experts: np.ndarray
    active_experts: np.ndarray
    is_expert: np.ndarray          # n_experts > 1 (apply_ep's flip condition)
    expert_prefix: np.ndarray      # prefix sum of is_expert, len L+1
    wprefix: np.ndarray            # prefix sum of weight_bytes, len L+1
    dram_idx: tuple[int, ...]      # meta["dram_input"] layers (merged graphs)


def _graph_data(graph: LayerGraph) -> _GraphData:
    ls = graph.layers
    arr = lambda f: np.array([f(l) for l in ls], dtype=np.float64)
    w = arr(lambda l: l.weight_bytes)
    nexp = arr(lambda l: float(l.n_experts))
    is_expert = nexp > 1
    return _GraphData(
        graph=graph,
        flops=arr(lambda l: l.flops),
        weight_bytes=w,
        in_bytes=arr(lambda l: l.in_bytes),
        out_bytes=arr(lambda l: l.out_bytes),
        halo_bytes=arr(lambda l: l.halo_bytes),
        wsp=arr(lambda l: l.wsp_parallel),
        isp=arr(lambda l: l.isp_parallel),
        n_experts=nexp,
        active_experts=arr(lambda l: float(l.active_experts)),
        is_expert=is_expert,
        expert_prefix=np.concatenate(([0], np.cumsum(is_expert))),
        wprefix=np.concatenate(([0.0], np.cumsum(w))),
        dram_idx=tuple(
            i for i, l in enumerate(ls) if l.meta.get("dram_input")
        ),
    )


def _veff(dim: np.ndarray, granule: int) -> np.ndarray:
    """Vectorized :func:`repro_torch.core.hw.eff` (same expression order).

    ``np.maximum(tiles, 1.0)`` only guards the ``dim <= 0`` lanes (whose
    result is overwritten with 1e-9 anyway); for dim > 0, tiles >= 1 and the
    quotient is bit-identical to the scalar ``eff``.
    """
    tiles = np.ceil(dim / granule)
    e = dim / (granule * np.maximum(tiles, 1.0))
    return np.where(dim <= 0, 1e-9, e)


def _seqsum(a) -> float:
    """Left-to-right Python summation, matching the reference model's ``sum``/
    ``+=`` accumulation bit-for-bit (NumPy's pairwise sum would not)."""
    return sum(a.tolist(), 0.0)


_STATIC = None      # sentinel key holding a cell's _ClusterStatic
_BODY = "body"      # sentinel key holding a cell's per-n body cache
_INF_BODY = (INF,)  # marker: placement infeasible at this n
# Below this cluster size a tight scalar loop beats NumPy dispatch overhead;
# the scalar path reuses the reference model's exact scalar arithmetic.
_SCALAR_MAX_LAYERS = 32
# Below this cluster size the 2D (k x layer) seed-phase batch fill is not
# worth its NumPy dispatch either; the lazy per-k paths handle it.
_BATCH_MIN_LAYERS = 8
# Region-size window (+- chips around the seed) pre-filled per slot by
# prefill_seed: covers the one-chip-at-a-time rebalance walk's body misses.
_PREFILL_N_WINDOW = 1
# Batched-first-rebalance-iteration group floor: a (bottleneck, donor) pair
# shared by fewer candidates than this runs the scalar walk instead -- the
# move-table costs span + 2 memo consults, so tiny groups would compute more
# speculative entries than their walks save.
_FIRST_MOVE_MIN_GROUP = 8


class _ClusterStatic:
    """Allocation-independent precomputation for one (lo, hi, partitions).

    Everything here depends only on the memo cell's identity, so it is built
    once and reused for every region size ``n`` the DSE probes against this
    cluster -- the per-``n`` cost below is a handful of array expressions.
    """

    __slots__ = (
        "lo", "hi", "last_layer", "last_p", "fl", "w", "wsp",
        "isp", "is_wsp", "is_isp", "is_ep", "any_ep", "m_base", "men",
        "flip_order", "flip_w", "out_i", "halo_i", "ep_edge", "ww_edge",
        "iw_edge", "rows", "codes_l", "flip_l", "w_l",
    )

    def __init__(self, gd: _GraphData, lo: int, hi: int, codes: np.ndarray):
        self.lo, self.hi = lo, hi
        self.last_layer = gd.graph.layers[hi - 1]
        self.last_p = _PSTR[int(codes[-1])]
        self.fl = gd.flops[lo:hi]
        self.w = gd.weight_bytes[lo:hi]
        self.wsp = gd.wsp[lo:hi]
        self.isp = gd.isp[lo:hi]
        is_wsp, is_isp, is_ep = codes == _WSP, codes == _ISP, codes == _EP
        self.is_wsp, self.is_isp, self.is_ep = is_wsp, is_isp, is_ep
        self.any_ep = bool(is_ep.any())
        # EP activation dim is n-independent (Eq. 5 EP branch); others get
        # the plain wsp dim here and are divided by n per allocation.
        self.m_base = np.where(
            is_ep,
            self.wsp * (gd.active_experts[lo:hi] / np.maximum(1.0, gd.n_experts[lo:hi])),
            self.wsp,
        )
        self.men = np.maximum(1.0, gd.n_experts[lo:hi])
        # Distributed-weight flip order: replicated WSP layers, largest
        # first; stable sort matches the reference ``sorted(key=-w)``.
        wsp_idx = np.nonzero(is_wsp)[0]
        self.flip_order = wsp_idx[np.argsort(-self.w[wsp_idx], kind="stable")]
        self.flip_w = self.w[self.flip_order]
        # Table II Case 1 edge classification for intra-cluster hand-offs.
        if hi - lo > 1:
            p, q = codes[:-1], codes[1:]
            self.out_i = gd.out_bytes[lo : hi - 1]
            self.halo_i = gd.halo_bytes[lo : hi - 1]
            self.ep_edge = (p == _EP) | (q == _EP)
            self.ww_edge = (p == _WSP) & (q == _WSP)
            self.iw_edge = (p == _ISP) & (q == _WSP)
        else:
            self.out_i = self.halo_i = self.ep_edge = self.ww_edge = self.iw_edge = None
        # Scalar fast path (small clusters): per-layer tuples in plain
        # Python floats, so a body evaluation is one tight loop with the
        # reference model's exact arithmetic and no NumPy dispatch overhead.
        if hi - lo <= _SCALAR_MAX_LAYERS:
            self.codes_l = codes.tolist()
            self.w_l = self.w.tolist()
            self.rows = list(zip(
                self.fl.tolist(), self.w_l, self.wsp.tolist(),
                self.isp.tolist(), self.codes_l, gd.out_bytes[lo:hi].tolist(),
                gd.halo_bytes[lo:hi].tolist(), self.m_base.tolist(),
                self.men.tolist(),
            ))
            self.flip_l = self.flip_order.tolist()
        else:
            self.rows = None
            self.codes_l = self.flip_l = self.w_l = None


class FastCostModel(CostModel):
    """CostModel-compatible engine with vectorized + memoized evaluation.

    Exact-parity contract: for any (graph, schedule) the reference model can
    evaluate, ``cluster_time`` / ``segment_time`` / ``system_time`` return
    the same values within 1e-9 rtol, and the DSE driven through
    :meth:`segment_evaluator` picks the same argmin schedules.
    """

    def __init__(self, *args, use_jit: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self._graphs: dict[int, _GraphData] = {}
        # Two-level memo: (graph, lo, hi, partitions) -> {(n, next_p0,
        # next_n) -> time}.  The outer lookup (hashing the partition tuple)
        # happens once per candidate; the per-allocation probes in the
        # rebalance inner loop only hash small int tuples.
        self._memo: dict[tuple, dict] = {}
        self._codes_cache: dict[tuple[str, ...], np.ndarray] = {}
        # _evals/_misses/_probes/_batched_bodies/_batch_evals/_batch_rows
        # inherited from CostModel
        self.batched_seed_fill = True   # 2D (k x layer) seed-phase fill
        # Batched transition sweep: _SegmentSweep.sweep_transitions scores
        # every (transition index, ep) candidate of a clustering as one
        # gather over per-slot value tables instead of an incremental walk.
        self.batched_sweep = True
        if use_jit:
            # The reference's jax.jit population tier (core/jit_batch.py) was
            # never committed; a torch tier is a later port step.
            raise NotImplementedError(
                "FastCostModel(use_jit=True): the population tier is not "
                "ported: ROADMAP A15")

    # ------------------------------------------------------------- plumbing
    def graph_data(self, graph: LayerGraph) -> _GraphData:
        gd = self._graphs.get(id(graph))
        if gd is None or gd.graph is not graph:
            gd = _graph_data(graph)
            self._graphs[id(graph)] = gd
        return gd

    def clear_memo(self) -> None:
        self._graphs.clear()
        self._memo.clear()
        self._evals = self._misses = self._probes = self._batched_bodies = 0
        self._batch_evals = self._batch_rows = 0

    @property
    def stats(self) -> dict:
        """Counters proving the memo/incrementality claims in benchmarks.

        Same schema as the reference :class:`CostModel.stats`;
        ``memo_hits = cluster_probes - cluster_computes`` is what the
        cross-candidate memo saved, and ``batch_evals``/``batch_rows`` count
        batched population calls (sweep_transitions / cluster_population)
        and the candidate rows they scored.
        """
        return {
            "segment_evals": self._evals,
            "cluster_computes": self._misses,
            "cluster_probes": self._probes,
            "memo_hits": self._probes - self._misses,
            "memo_cells": len(self._memo),
            "memo_entries": sum(len(c) - 2 for c in self._memo.values()),
            "batched_bodies": self._batched_bodies,
            "batch_evals": self._batch_evals,
            "batch_rows": self._batch_rows,
        }

    def _cluster_cell(
        self, gd: _GraphData, lo: int, hi: int, partitions: tuple[str, ...],
        ctype: str | None = None,
    ) -> dict:
        """Memo cell for an explicit partition tuple (generic API path)."""
        key = (id(gd.graph), lo, hi, partitions, ctype)
        cell = self._memo.get(key)
        if cell is None:
            cell = self._memo[key] = {
                _STATIC: _ClusterStatic(gd, lo, hi, self._codes(partitions)),
                _BODY: {},
            }
        return cell

    def _cluster_cell_hint(
        self, gd: _GraphData, lo: int, hi: int, k: int, ep: bool,
        ctype: str | None = None,
    ) -> dict:
        """Memo cell for a WSP^k ISP^(len-k) transition slice (DSE path).

        Algorithm 1's partition dimension only ever produces transition
        slices (optionally with MoE layers flipped to EP), so the DSE keys
        cells by the small ``(lo, hi, k, ep)`` tuple instead of hashing a
        partition tuple per probe -- and slices that coincide across
        different segment-level transition points share one cell.  ``ctype``
        (the hetero chip flavor) completes the key: cached times are only
        valid for the flavor whose scaled hardware computed them, so flavors
        never share cells (asserted in tests/test_multimodel.py).
        """
        key = (id(gd.graph), lo, hi, k, ep, ctype)
        cell = self._memo.get(key)
        if cell is None:
            codes = np.full(hi - lo, _ISP, dtype=np.int8)
            codes[:k] = _WSP
            if ep:
                codes[gd.is_expert[lo:hi]] = _EP
            cell = self._memo[key] = {
                _STATIC: _ClusterStatic(gd, lo, hi, codes),
                _BODY: {},
            }
        return cell

    def _codes(self, partitions: tuple[str, ...]) -> np.ndarray:
        c = self._codes_cache.get(partitions)
        if c is None:
            c = np.array([_CODE[p] for p in partitions], dtype=np.int8)
            self._codes_cache[partitions] = c
        return c

    # ------------------------------------------------- vectorized evaluation
    def _cluster_cost(self, st: _ClusterStatic, n: int,
                      next_p0: str | None, next_n: int | None,
                      body_cache: dict | None = None,
                      ctype: str | None = None,
                      next_ctype: str | None = SAME_FLAVOR) -> float:
        """Vectorized reference ``cluster_time`` for one memoized static.

        The last layer's Table II Case 2 boundary term is the only part that
        depends on the *next* cluster (its first partition, region size, and
        -- across a flavor seam -- its chip flavor), so the expensive array
        work -- the ``body`` -- is keyed by ``n`` alone in ``body_cache``
        and the final assembly is three scalar operations.  During
        rebalance, a donor's left neighbor changes only ``next_n``: its
        re-evaluation is a body cache hit plus scalar math, no NumPy at all.
        """
        body = body_cache.get(n) if body_cache is not None else None
        if body is None:
            body = self._cluster_body(st, n, self.hw_for(ctype))
            if body_cache is not None:
                body_cache[n] = body
        if body is _INF_BODY:
            return INF
        head, pre_last, comp_last = body
        comm_last = self.comm_time(
            st.last_layer, st.last_p, n, next_p0, next_n, False, ctype,
            next_ctype,
        )
        if self.overlap:
            t_last = pre_last + (comm_last if comm_last >= comp_last else comp_last)
        else:
            t_last = (pre_last + comm_last) + comp_last
        return head + t_last

    def _cluster_body(self, st: _ClusterStatic, n: int, hw=None):
        """Per-(cluster, n) array work: placement + Eq. 5/7 for all layers,
        minus the last layer's next-dependent comm.  Returns ``(head_sum,
        pre_last, comp_last)`` or ``_INF_BODY`` when weights don't fit.
        ``hw`` is the (possibly chip-type-scaled) hardware of the region."""
        if hw is None:
            hw = self.hw
        if st.rows is not None:
            return self._cluster_body_scalar(st, n, hw)
        w = st.w
        # --- greedy weight placement (reference place_weights, SSIII-B)
        if st.any_ep:
            div = np.where(st.is_ep, np.minimum(float(n), st.men), float(n))
            resident = np.where(st.is_wsp, w, w / div)
        else:
            resident = np.where(st.is_wsp, w, w / n)
        cap = hw.weight_capacity_per_chip
        s = _seqsum(resident)
        gather = None
        transient = 0.0
        if self.distributed_weights and s > cap and len(st.flip_order):
            # Reference semantics: flip the largest replicated WSP layers to
            # distributed storage one at a time while the (sequentially
            # re-summed) residency exceeds capacity.  Guess the flip count
            # from a running delta, then verify with the reference's exact
            # left-to-right sums so the boundary decision is bit-identical.
            def exact_after(t: int) -> float:
                r = resident.copy()
                idx = st.flip_order[:t]
                r[idx] = w[idx] / n
                return _seqsum(r)

            deltas = st.flip_w - st.flip_w / n      # residency drop per flip
            run = s - np.cumsum(deltas)
            t = int(np.searchsorted(-run, -cap))    # first t with run[t-1] <= cap
            t = min(t + 1, len(st.flip_order))
            while t > 0 and exact_after(t - 1) <= cap:
                t -= 1
            while t < len(st.flip_order) and exact_after(t) > cap:
                t += 1
            flips = st.flip_order[:t]
            resident[flips] = w[flips] / n
            gather = np.zeros_like(w)
            gather[flips] = w[flips] * (n - 1) / n
            s = _seqsum(resident)
            transient = max(
                ((2.0 * w[k]) / n for k in np.nonzero(gather > 0)[0]),
                default=0.0,
            )
        if (s + transient) > cap:
            return _INF_BODY

        # --- Eq. 5 computation (vectorized CostModel._util / comp_time)
        m_local = np.where(st.is_wsp, st.wsp / n, st.m_base)
        n_local = np.where(st.is_isp, st.isp / n, st.isp)
        util = _veff(m_local, hw.m_granule) * _veff(n_local, hw.n_granule)
        comp = st.fl / ((n * hw.flops_per_chip) * util)

        # --- Table II Case 1 comm for intra-cluster hand-offs (vectorized)
        pre = None
        if gather is not None:
            pre = gather / hw.nop_bw_per_chip
        if self.literal_pre:
            lit = w / hw.dram_bw_total
            pre = lit if pre is None else pre + lit
        if st.out_i is not None:
            vo = (n - 1) * st.out_i
            ha = st.halo_i * max(0, n - 1)
            vol = np.where(
                st.ep_edge, 2.0 * st.out_i,
                np.where(st.ww_edge, ha, np.where(st.iw_edge, vo + ha, vo)),
            )
            comm_i = np.where(vol <= 0, 0.0, vol / (n * hw.nop_bw_per_chip))
            # Eq. 7 per layer for layers [0, L-1), summed in reference order
            if self.overlap:
                head_arr = np.maximum(comm_i, comp[:-1])
            else:
                head_arr = comm_i + comp[:-1]
            if pre is not None:
                head_arr = (
                    pre[:-1] + head_arr if self.overlap
                    else (pre[:-1] + comm_i) + comp[:-1]
                )
            head = _seqsum(head_arr)
        else:
            head = 0.0
        pre_last = float(pre[-1]) if pre is not None else 0.0
        comp_last = float(comp[-1])
        return (head, pre_last, comp_last)

    def _cluster_body_scalar(self, st: _ClusterStatic, n: int, hw=None):
        """Small-cluster body: one tight loop of the reference model's exact
        scalar arithmetic (no NumPy dispatch), bit-identical by construction."""
        if hw is None:
            hw = self.hw
        cap = hw.weight_capacity_per_chip
        rows = st.rows
        L = len(rows)
        # --- greedy weight placement (reference place_weights, SSIII-B)
        resident = []
        append = resident.append
        for fl, w, wsp, isp, code, out, halo, m_base, men in rows:
            if code == _WSP:
                append(w)
            elif code == _EP:
                append(w / min(n, men))
            else:
                append(w / n)
        s = sum(resident)
        gather = None
        transient = 0.0
        if self.distributed_weights and s > cap and st.flip_l:
            gather = [0.0] * L
            w_l = st.w_l
            for k in st.flip_l:
                if s <= cap:
                    break
                wk = w_l[k]
                resident[k] = wk / n
                gather[k] = wk * (n - 1) / n
                s = sum(resident)
            transient = max(
                (2.0 * w_l[k] / n for k in range(L) if gather[k] > 0),
                default=0.0,
            )
        if (s + transient) > cap:
            return _INF_BODY
        # --- Eq. 5 / Table II Case 1 / Eq. 7 per layer (reference order)
        mg, ng = hw.m_granule, hw.n_granule
        peak, nop = hw.flops_per_chip, hw.nop_bw_per_chip
        dram = hw.dram_bw_total
        literal, overlap = self.literal_pre, self.overlap
        head = 0.0
        pre_last = comp_last = 0.0
        nm1 = n - 1
        last = L - 1
        for i, (fl, w, wsp, isp, code, out, halo, m_base, men) in enumerate(rows):
            if code == _WSP:
                m_l, n_l = wsp / n, isp
            elif code == _ISP:
                m_l, n_l = wsp, isp / n
            else:
                m_l, n_l = m_base, isp
            util = eff(m_l, mg) * eff(n_l, ng)
            comp = fl / (n * peak * util)
            pre = 0.0
            if literal:
                pre += w / dram
            if gather is not None and gather[i] > 0:
                pre += gather[i] / nop
            if i == last:
                pre_last, comp_last = pre, comp
                break
            ncode = rows[i + 1][4]
            if code == _EP or ncode == _EP:
                vol = 2.0 * out
            elif code == _WSP:
                vol = halo * nm1 if ncode == _WSP else nm1 * out
            elif ncode == _WSP:
                vol = nm1 * out + halo * nm1
            else:
                vol = nm1 * out
            comm = 0.0 if vol <= 0 else vol / (n * nop)
            if overlap:
                head += pre + (comm if comm >= comp else comp)
            else:
                head += pre + comm + comp
        return (head, pre_last, comp_last)

    # ------------------------------------------------- 2D seed-phase fill
    def _batch_seed_fill(self, gd: _GraphData, lo: int, hi: int, ns,
                         ctype: str | None = None,
                         eager_ns=None) -> None:
        """Batched (row x layer) bodies for the transition slices of one span.

        Algorithm 1's seed phase probes the same cluster span at the same
        region size ``n`` under every transition index ``k`` (WSP for the
        first ``k`` layers, ISP for the rest).  Filling those ``L + 1``
        bodies one row at a time repeats the identical array setup per row;
        this computes them as one matrix pass over ``(k, n)`` rows and
        writes the results into the per-k memo cells the sweep will probe.
        ``ns`` is one region size or a sequence of them (the mixed-flavor
        run-cut enumeration re-seeds the same spans at several sizes; those
        fills share this one pass too).  ``eager_ns`` restricts which sizes'
        over-capacity rows are worth the scalar greedy-flip fallback here:
        speculative window sizes (prefill_seed's +- window) are left for the
        lazy path to fill only if a probe actually lands on them.

        Exactness: every elementwise expression mirrors ``_cluster_body``
        operation by operation, and row reductions use ``np.cumsum`` (a
        strictly left-to-right accumulation, like ``_seqsum`` and the scalar
        path's ``+=``), so the stored bodies are bit-identical to what the
        lazy per-k evaluation would produce.  Rows whose weight placement
        overflows capacity (they need the greedy distributed-weight flip
        walk, or are infeasible) fall back to the per-k path, as do EP
        variants (never batched).
        """
        L = hi - lo
        hw = self.hw_for(ctype)
        cells = [
            self._cluster_cell_hint(gd, lo, hi, k, False, ctype)
            for k in range(L + 1)
        ]
        if isinstance(ns, int):
            ns = (ns,)
        need = [
            (k, n) for n in ns for k in range(L + 1)
            if n not in cells[k][_BODY]
        ]
        if not need:
            return
        w = gd.weight_bytes[lo:hi]
        fl = gd.flops[lo:hi]
        wsp = gd.wsp[lo:hi]
        isp = gd.isp[lo:hi]
        ks = np.array([k for k, _ in need], dtype=np.int64)
        nr = np.array([n for _, n in need], dtype=np.int64)[:, None]
        lidx = np.arange(L)

        is_wsp = lidx[None, :] < ks[:, None]                # rows x L

        # --- residency (replicated WSP / sharded ISP), row-wise sums
        resident = np.where(is_wsp, w, w / nr)
        s = np.cumsum(resident, axis=1)[:, -1]
        cap = hw.weight_capacity_per_chip
        over = s > cap
        if over.any():
            # These rows need the greedy flip walk (or are INF): per-k path.
            for row in np.nonzero(over)[0]:
                k, n = need[row]
                if eager_ns is not None and n not in eager_ns:
                    continue
                cell = cells[k]
                cell[_BODY][n] = self._cluster_body(cell[_STATIC], n, hw)
        good = np.nonzero(~over)[0]
        if not len(good):
            return
        ks_g = ks[good]
        nr_g = nr[good]

        is_wsp = is_wsp[good]
        # --- Eq. 5 computation (rows of _cluster_body's vectorized path)
        m_local = np.where(is_wsp, wsp / nr_g, wsp)
        n_local = np.where(is_wsp, isp, isp / nr_g)
        util = _veff(m_local, hw.m_granule) * _veff(n_local, hw.n_granule)
        comp = fl / ((nr_g * hw.flops_per_chip) * util)

        lit = (w / hw.dram_bw_total) if self.literal_pre else None
        if L > 1:
            # Transition-slice edge (l, l+1): WSP->WSP iff l <= k-2,
            # WSP->ISP iff l == k-1, ISP->ISP otherwise (ISP->WSP and EP
            # edges cannot occur in a WSP^k ISP^(L-k) row).
            out_i = gd.out_bytes[lo : hi - 1]
            halo_i = gd.halo_bytes[lo : hi - 1]
            vo = (nr_g - 1) * out_i
            ha = halo_i * np.maximum(0, nr_g - 1)
            ww = lidx[None, : L - 1] <= (ks_g[:, None] - 2)
            vol = np.where(ww, ha, vo)
            comm_i = np.where(vol <= 0, 0.0, vol / (nr_g * hw.nop_bw_per_chip))
            comph = comp[:, :-1]
            if self.overlap:
                head_arr = np.maximum(comm_i, comph)
            else:
                head_arr = comm_i + comph
            if lit is not None:
                head_arr = (
                    lit[None, :-1] + head_arr if self.overlap
                    else (lit[None, :-1] + comm_i) + comph
                )
            head = np.cumsum(head_arr, axis=1)[:, -1]
        else:
            head = np.zeros(len(good))
        comp_last = comp[:, -1]
        pre_last = float(lit[-1]) if lit is not None else 0.0
        for row, g in enumerate(good.tolist()):
            k, n = need[g]
            cells[k][_BODY][n] = (
                float(head[row]), pre_last, float(comp_last[row])
            )
        self._batched_bodies += len(good)

    def prefill_spans(self, graph: LayerGraph, spans) -> None:
        """Batch-fill transition-slice bodies for many spans in one go.

        ``spans`` is an iterable of ``(lo, hi, ns, ctype)`` with global layer
        bounds and one-or-more region sizes per span.  The mixed-flavor
        run-cut enumeration uses this to score a whole flavor assignment's
        cut candidates as one population: every cut re-seeds the same
        cluster spans at different sizes, and this fills all those bodies
        as one matrix pass per span before the per-cut sweeps probe them.
        """
        if not self.batched_seed_fill:
            return
        gd = self.graph_data(graph)
        for lo, hi, ns, ctype in spans:
            if hi - lo >= _BATCH_MIN_LAYERS:
                self._batch_seed_fill(gd, lo, hi, ns, ctype)

    # ---------------------------------------------------------- populations
    def _fill_bodies(self, cell: dict, ns, hw) -> None:
        """Fill a memo cell's bodies for several region sizes in one pass.

        The multi-``n`` analogue of the seed fill: one cluster static, a
        vector of region sizes (the population evaluator's grouped misses).
        Small clusters and EP statics keep the scalar/lazy paths (parity is
        trivially guaranteed there); large non-EP statics run the body as a
        ``(len(ns) x layers)`` matrix program mirroring ``_cluster_body``
        operation by operation, with over-capacity rows falling back to the
        exact greedy flip walk.
        """
        st = cell[_STATIC]
        body = cell[_BODY]
        ns = [n for n in ns if n not in body]
        if not ns:
            return
        if st.rows is not None or st.any_ep or len(ns) == 1:
            for n in ns:
                body[n] = self._cluster_body(st, n, hw)
            return
        nr = np.array(ns, dtype=np.int64)[:, None]              # R x 1
        w = st.w
        resident = np.where(st.is_wsp, w, w / nr)
        s = np.cumsum(resident, axis=1)[:, -1]
        cap = hw.weight_capacity_per_chip
        over = s > cap
        for row in np.nonzero(over)[0]:
            body[ns[row]] = self._cluster_body(st, ns[row], hw)
        good = np.nonzero(~over)[0]
        if not len(good):
            return
        nr = nr[good]
        m_local = np.where(st.is_wsp, st.wsp / nr, st.m_base)
        n_local = np.where(st.is_isp, st.isp / nr, st.isp)
        util = _veff(m_local, hw.m_granule) * _veff(n_local, hw.n_granule)
        comp = st.fl / ((nr * hw.flops_per_chip) * util)
        lit = (w / hw.dram_bw_total) if self.literal_pre else None
        if st.out_i is not None:
            vo = (nr - 1) * st.out_i
            ha = st.halo_i * np.maximum(0, nr - 1)
            vol = np.where(
                st.ep_edge, 2.0 * st.out_i,
                np.where(st.ww_edge, ha, np.where(st.iw_edge, vo + ha, vo)),
            )
            comm_i = np.where(vol <= 0, 0.0, vol / (nr * hw.nop_bw_per_chip))
            comph = comp[:, :-1]
            if self.overlap:
                head_arr = np.maximum(comm_i, comph)
            else:
                head_arr = comm_i + comph
            if lit is not None:
                head_arr = (
                    lit[None, :-1] + head_arr if self.overlap
                    else (lit[None, :-1] + comm_i) + comph
                )
            head = np.cumsum(head_arr, axis=1)[:, -1]
        else:
            head = np.zeros(len(good))
        pre_last = float(lit[-1]) if lit is not None else 0.0
        comp_last = comp[:, -1]
        for row, g in enumerate(good.tolist()):
            body[ns[g]] = (float(head[row]), pre_last, float(comp_last[row]))
        self._batched_bodies += len(good)

    def cluster_population(self, graph: LayerGraph, rows) -> np.ndarray:
        """Batched population evaluator (see :meth:`CostModel.cluster_population`
        for the row format).

        Memo semantics are unchanged: every row is consulted against the
        same two-level memo the scalar paths use and misses are written
        back, so a population call warms the cache for later scalar probes
        and vice versa.  What *is* batched is the body arithmetic: all
        missing bodies that share a cluster cell are filled as one
        ``(rows x layers)`` matrix program (:meth:`_fill_bodies`), and the
        per-row remainder is scalar memo assembly.
        """
        gd = self.graph_data(graph)
        out = np.empty(len(rows), dtype=np.float64)
        self._batch_evals += 1
        self._batch_rows += len(rows)
        resolved = []
        pending: dict[int, tuple[dict, str | None, set]] = {}
        for lo, hi, spec, n, next_p0, next_n, ctype, next_ctype in rows:
            if spec and isinstance(spec[0], str):
                cell = self._cluster_cell(gd, lo, hi, tuple(spec), ctype)
            else:
                k, ep = spec
                cell = self._cluster_cell_hint(gd, lo, hi, int(k), bool(ep), ctype)
            nct = ctype if next_ctype is SAME_FLAVOR else next_ctype
            resolved.append((cell, n, next_p0, next_n, ctype, nct))
            if n not in cell[_BODY]:
                ent = pending.get(id(cell))
                if ent is None:
                    pending[id(cell)] = (cell, ctype, {n})
                else:
                    ent[2].add(n)
        for cell, ctype, ns in pending.values():
            self._fill_bodies(cell, sorted(ns), self.hw_for(ctype))
        for i, (cell, n, next_p0, next_n, ctype, nct) in enumerate(resolved):
            self._probes += 1
            key = (n, next_p0, next_n, nct)
            t = cell.get(key)
            if t is None:
                self._misses += 1
                t = cell[key] = self._cluster_cost(
                    cell[_STATIC], n, next_p0, next_n, cell[_BODY], ctype, nct,
                )
            out[i] = t
        return out

    # -------------------------------------------------------------- memoized
    def _cluster_time_fast(
        self,
        gd: _GraphData,
        lo: int,
        hi: int,
        partitions: tuple[str, ...],
        n: int,
        next_p0: str | None,
        next_n: int | None,
        ctype: str | None = None,
        next_ctype: str | None = None,
    ) -> float:
        cell = self._cluster_cell(gd, lo, hi, partitions, ctype)
        # The entry key carries the *neighbor's* flavor too: the last
        # layer's boundary term crosses the seam, so a cached time is only
        # valid against a next cluster of the same flavor.
        self._probes += 1
        k = (n, next_p0, next_n, next_ctype)
        t = cell.get(k)
        if t is None:
            self._misses += 1
            t = cell[k] = self._cluster_cost(
                cell[_STATIC], n, next_p0, next_n, cell[_BODY], ctype,
                next_ctype,
            )
        return t

    # --------------------------------------------- CostModel-compatible API
    def cluster_time(
        self,
        graph: LayerGraph,
        cluster: ClusterAssignment,
        next_cluster: ClusterAssignment | None,
        first_in_segment: bool,
        last_in_segment: bool,
    ) -> float:
        next_p0 = next_cluster.partitions[0] if next_cluster is not None else None
        next_n = next_cluster.region_chips if next_cluster is not None else None
        next_ct = next_cluster.chip_type if next_cluster is not None else None
        return self._cluster_time_fast(
            self.graph_data(graph),
            cluster.layer_lo,
            cluster.layer_hi,
            cluster.partitions,
            cluster.region_chips,
            next_p0,
            next_n,
            cluster.chip_type,
            next_ct,
        )

    def segment_time(
        self, graph: LayerGraph, clusters: tuple[ClusterAssignment, ...]
    ) -> tuple[float, list[float]]:
        gd = self.graph_data(graph)
        times = []
        for j, cl in enumerate(clusters):
            nxt = clusters[j + 1] if j + 1 < len(clusters) else None
            next_p0 = nxt.partitions[0] if nxt is not None else None
            next_n = nxt.region_chips if nxt is not None else None
            next_ct = nxt.chip_type if nxt is not None else None
            times.append(
                self._cluster_time_fast(
                    gd, cl.layer_lo, cl.layer_hi, cl.partitions,
                    cl.region_chips, next_p0, next_n, cl.chip_type, next_ct,
                )
            )
        bottleneck = max(times)
        if bottleneck == INF:
            return INF, times
        load = 0.0
        if not self.literal_pre:
            seg_weights = sum(
                float(gd.wprefix[cl.layer_hi] - gd.wprefix[cl.layer_lo])
                for cl in clusters
            )
            load += seg_weights / self.hw.dram_bw_total
        first_lo = clusters[0].layer_lo
        load += self.m * graph.layers[first_lo].in_bytes / self.hw.dram_bw_total
        if gd.dram_idx:
            # Mid-segment DRAM-staged entry layers (merged model boundaries);
            # mirrors the reference segment_time loop in index order.
            for i in gd.dram_idx:
                if i != first_lo and any(
                    cl.layer_lo <= i < cl.layer_hi for cl in clusters
                ):
                    load += self.m * graph.layers[i].in_bytes / self.hw.dram_bw_total
        n_cl = len(clusters)
        return load + (self.m + n_cl - 1) * bottleneck, times

    # --------------------------------------------------------- DSE hot path
    def segment_sweeper(self, graph, seg_lo, clustering, chip_type=None):
        """Per-clustering factory for Algorithm 1's partition sweep.

        Returns ``sweeper(partitions, transition=None) -> eval_fn`` where
        ``eval_fn(alloc) -> (latency, times)`` and ``eval_fn.move`` is the
        incremental rebalance path.  The allocation-independent precomputation
        (layer spans, Eq. 2 load terms, per-slot memo cells) lives in one
        reusable :class:`_SegmentSweep`; advancing the transition index by one
        only touches the single cluster whose partition slice changed.
        ``sweeper.prefill(seed)`` batch-fills the seed-phase bodies (2D
        ``k x layer`` vectorization) for every transition slice at once.
        ``chip_type`` is one flavor name (whole segment) or a per-cluster
        flavor sequence (mixed pipeline, seam-aware boundary terms).
        """
        sweep = _SegmentSweep(self, graph, seg_lo, clustering, chip_type)

        def configure(partitions, transition=None):
            sweep.set_partitions(partitions, transition)
            return sweep

        configure.prefill = sweep.prefill_seed
        if self.batched_sweep:
            # search_segment scores all transition candidates of the
            # clustering as one batch before the per-candidate rebalance.
            configure.sweep_transitions = sweep.sweep_transitions
        return configure

    def segment_evaluator(self, graph, seg_lo, clustering, partitions,
                          transition=None, chip_type=None):
        """One-shot evaluator (CostModel-compatible); see segment_sweeper."""
        return self.segment_sweeper(graph, seg_lo, clustering, chip_type)(
            partitions, transition
        )


class _SegmentSweep:
    """Reusable segment evaluator: one clustering, many partition sets.

    ``set_partitions`` swaps in the memo cells for the given partition
    choice; Algorithm 1's linear transition sweep changes the slice of only
    one cluster per step, so consecutive calls re-probe a single slot.
    Calling the object evaluates a region allocation; :meth:`move`
    re-evaluates a one-chip transfer by recomputing only the donor/receiver
    clusters and their boundary-comm neighbors (the clusters whose memo keys
    contain the changed region sizes).
    """

    __slots__ = (
        "model", "gd", "spans", "rel", "n_cl", "load_const", "m",
        "fill_factor", "has_expert", "first_expert", "cells", "statics",
        "next_p0s", "cur_k", "cur_ep", "ctypes", "next_ctypes", "slot_cells",
        "_rlos", "_rhis", "_last_t",
    )

    def __init__(self, model: FastCostModel, graph: LayerGraph, seg_lo: int,
                 clustering, chip_type=None) -> None:
        self.model = model
        # One flavor name applies to every cluster; a sequence gives each
        # cluster its own flavor (mixed pipelines).  next_ctypes[j] feeds the
        # seam-aware boundary term of slot j's memo entry key.
        self.ctypes = list(_flavor_tuple(chip_type, len(clustering)))
        self.next_ctypes = self.ctypes[1:] + [None]
        gd = model.graph_data(graph)
        self.gd = gd
        self.rel = tuple(clustering)
        self.spans = [(seg_lo + lo, seg_lo + hi) for lo, hi in clustering]
        n_cl = len(self.spans)
        self.n_cl = n_cl
        epre = gd.expert_prefix
        self.has_expert = [bool(epre[hi] > epre[lo]) for lo, hi in self.spans]
        self.first_expert = [bool(gd.is_expert[lo]) for lo, _ in self.spans]
        load_const = 0.0
        if not model.literal_pre:
            seg_weights = sum(
                float(gd.wprefix[hi] - gd.wprefix[lo]) for lo, hi in self.spans
            )
            load_const += seg_weights / model.hw.dram_bw_total
        first_lo = self.spans[0][0]
        load_const += (
            model.m * graph.layers[first_lo].in_bytes / model.hw.dram_bw_total
        )
        for i in gd.dram_idx:
            # mid-segment DRAM-staged entry layers (merged model boundaries)
            if i != first_lo and any(lo <= i < hi for lo, hi in self.spans):
                load_const += (
                    model.m * graph.layers[i].in_bytes / model.hw.dram_bw_total
                )
        self.load_const = load_const
        self.m = model.m
        self.fill_factor = model.m + n_cl - 1
        self.cells = [None] * n_cl
        self.statics = [None] * n_cl
        self.next_p0s = [None] * n_cl          # next_p0s[j] = slot j+1's first p
        self.cur_k = [None] * n_cl
        self.cur_ep = [None] * n_cl
        # (j, ep) -> [memo cell per k]: the transition sweep touches every k
        # of every slot, so cells are resolved once per slot here and looked
        # up by list index afterwards instead of re-hashing hint tuples.
        self.slot_cells: dict = {}
        self._rlos = [lo for lo, _ in self.rel]
        self._rhis = [hi for _, hi in self.rel]
        self._last_t = None          # last applied (idx, ep_variant)

    def set_partitions(self, partitions, transition=None) -> None:
        model, gd = self.model, self.gd
        if transition is None:
            # Generic path (arbitrary partition tuples): tuple-keyed cells.
            for j, (lo, hi) in enumerate(self.rel):
                p = partitions[lo:hi]
                cell = model._cluster_cell(gd, *self.spans[j], p, self.ctypes[j])
                self.cells[j] = cell
                self.statics[j] = cell[_STATIC]
                self.cur_k[j] = self.cur_ep[j] = None
                if j > 0:
                    self.next_p0s[j - 1] = p[0]
            self._last_t = None
            return
        idx, ep_variant = transition
        last = self._last_t
        self._last_t = transition
        rel = self.rel
        if last is not None and last[1] == ep_variant:
            # Same ep variant: slot j's clipped k changes between transition
            # indices p and idx only if (lo_j, hi_j] meets (min, max] -- a
            # contiguous j range since clusterings tile the segment.  The
            # usual sweep step is |idx - p| = 1, touching one or two slots.
            p = last[0]
            if p == idx:
                return
            mn, mx = (p, idx) if p < idx else (idx, p)
            js = range(bisect_right(self._rhis, mn),
                       bisect_left(self._rlos, mx))
        else:
            js = range(self.n_cl)
        cur_k, cur_ep = self.cur_k, self.cur_ep
        has_expert, first_expert = self.has_expert, self.first_expert
        cells, statics, next_p0s = self.cells, self.statics, self.next_p0s
        for j in js:
            lo, hi = rel[j]
            k = idx - lo
            if k < 0:
                k = 0
            elif k > hi - lo:
                k = hi - lo
            ep_j = ep_variant and has_expert[j]
            if k == cur_k[j] and ep_j == cur_ep[j]:
                continue
            cell = self._slot_cell_list(j, ep_j)[k]
            cells[j] = cell
            statics[j] = cell[_STATIC]
            cur_k[j] = k
            cur_ep[j] = ep_j
            if j > 0:
                next_p0s[j - 1] = (
                    "EP" if (ep_j and first_expert[j])
                    else ("WSP" if k > 0 else "ISP")
                )

    def _slot_cell_list(self, j: int, ep_j: bool) -> list:
        """Slot ``j``'s memo cells for every transition slice k (cached)."""
        key = (j, ep_j)
        lst = self.slot_cells.get(key)
        if lst is None:
            lo, hi = self.spans[j]
            model, gd, ctype = self.model, self.gd, self.ctypes[j]
            hint = model._cluster_cell_hint
            lst = self.slot_cells[key] = [
                hint(gd, lo, hi, k, ep_j, ctype)
                for k in range(hi - lo + 1)
            ]
        return lst

    def _probe(self, j: int, n: int, next_n: int | None) -> float:
        next_p0 = self.next_p0s[j]
        next_ct = self.next_ctypes[j]
        self.model._probes += 1
        k = (n, next_p0, next_n, next_ct)
        cell = self.cells[j]
        t = cell.get(k)
        if t is None:
            self.model._misses += 1
            t = cell[k] = self.model._cluster_cost(
                self.statics[j], n, next_p0, next_n, cell[_BODY],
                self.ctypes[j], next_ct,
            )
        return t

    def __call__(self, alloc):
        model = self.model
        model._evals += 1
        model._probes += self.n_cl
        n_cl = self.n_cl
        cells = self.cells
        statics = self.statics
        next_p0s = self.next_p0s
        cost = model._cluster_cost
        ctypes = self.ctypes
        next_ctypes = self.next_ctypes
        times = []
        append = times.append
        bottleneck = 0.0
        for j in range(n_cl):
            next_n = alloc[j + 1] if j + 1 < n_cl else None
            k = (alloc[j], next_p0s[j], next_n, next_ctypes[j])
            cell = cells[j]
            t = cell.get(k)
            if t is None:
                model._misses += 1
                t = cell[k] = cost(
                    statics[j], alloc[j], next_p0s[j], next_n, cell[_BODY],
                    ctypes[j], next_ctypes[j],
                )
            if t > bottleneck:
                bottleneck = t
            append(t)
        if bottleneck == INF:
            return INF, times
        return self.load_const + self.fill_factor * bottleneck, times

    def prefill_seed(self, alloc) -> None:
        """Batch-fill the seed-phase bodies of every transition slice.

        Called once per (clustering, seed allocation) by search_segment
        before the transition sweep; spans below _BATCH_MIN_LAYERS stay on
        the lazy per-k paths (scalar loops beat NumPy dispatch there).
        Besides the seed size itself, a +-_PREFILL_N_WINDOW window of region
        sizes rides along in the same matrix pass: the rebalance walks that
        follow move one chip at a time, so almost all their body misses land
        within a few chips of the seed -- pre-filling them swaps scalar
        per-(k, n) fills during the walk for a few extra vectorized rows
        here.  Extra rows only add bodies to the memo; probe results are
        unchanged.
        """
        model = self.model
        if not model.batched_seed_fill:
            return
        d = _PREFILL_N_WINDOW
        for j, (lo, hi) in enumerate(self.spans):
            if hi - lo >= _BATCH_MIN_LAYERS:
                a = alloc[j]
                ns = range(max(1, a - d), a + d + 1)
                model._batch_seed_fill(self.gd, lo, hi, ns, self.ctypes[j],
                                       eager_ns=(a,))

    def move(self, base_alloc, base_times, dst, src, k=1):
        """Incremental re-eval after moving ``k`` chips src -> dst."""
        model = self.model
        model._evals += 1
        n_cl = self.n_cl
        alloc = list(base_alloc)
        alloc[dst] += k
        alloc[src] -= k
        times = list(base_times)
        # Inlined _probe for the four affected slots (the rebalance walk's
        # innermost loop): donor, receiver, and their left neighbors.
        j2 = dst - 1
        j3 = src - 1
        slots = (dst, src) + (
            () if j2 < 0 or j2 == src else (j2,)
        ) + (
            () if j3 < 0 or j3 == dst else (j3,)
        )
        cells = self.cells
        next_p0s = self.next_p0s
        next_ctypes = self.next_ctypes
        model._probes += len(slots)
        for j in slots:
            key = (alloc[j], next_p0s[j],
                   alloc[j + 1] if j + 1 < n_cl else None, next_ctypes[j])
            cell = cells[j]
            t = cell.get(key)
            if t is None:
                model._misses += 1
                t = cell[key] = model._cluster_cost(
                    self.statics[j], key[0], key[1], key[2], cell[_BODY],
                    self.ctypes[j], key[3],
                )
            times[j] = t
        bottleneck = max(times)
        if bottleneck == INF:
            return INF, alloc, times
        return self.load_const + self.fill_factor * bottleneck, alloc, times

    # ----------------------------------------------- batched transition sweep
    def _slot_vals(self, j: int, n: int, next_n: int | None, ep_variant: bool,
                   out: list) -> None:
        """Append slot ``j``'s transition-index value table to ``out``.

        For a transition index ``idx``, slot ``j`` (relative span
        ``[lo, hi)``) evaluates the WSP^k ISP^(span-k) slice with
        ``k = clip(idx - lo, 0, span)``, against a next cluster starting
        ISP while ``idx <= hi`` and WSP once ``idx > hi`` (EP-pinned when
        the ep variant makes the next slot start on an expert layer; absent
        for the last slot).  The table therefore has one entry per k plus --
        when the next-start can flip to WSP -- one trailing ``(k=span,
        next=WSP)`` entry, and a candidate's value sits at
        ``clip(idx - lo, 0, len-1)``.  Entries are memo consults with the
        exact keys the scalar probes use, so the sweep and the incremental
        rebalance walk share every cached time.
        """
        model = self.model
        lo, hi = self.rel[j]
        span = hi - lo
        ep_j = ep_variant and self.has_expert[j]
        ctype = self.ctypes[j]
        next_ct = self.next_ctypes[j]
        last = j == self.n_cl - 1
        ep_next = (not last) and ep_variant and self.first_expert[j + 1]
        cost = model._cluster_cost
        if last:
            p0, nn = None, None
        elif ep_next:
            p0, nn = "EP", next_n
        else:
            p0, nn = "ISP", next_n
        cell = None
        slot_cells = self._slot_cell_list(j, ep_j)
        model._probes += span + 1
        key = (n, p0, nn, next_ct)
        append = out.append
        for k in range(span + 1):
            cell = slot_cells[k]
            t = cell.get(key)
            if t is None:
                model._misses += 1
                t = cell[key] = cost(
                    cell[_STATIC], n, p0, nn, cell[_BODY], ctype, next_ct,
                )
            append(t)
        if not last and not ep_next:
            # idx past this slot: k stays at span, the next slot starts WSP.
            model._probes += 1
            key = (n, "WSP", next_n, next_ct)
            t = cell.get(key)
            if t is None:
                model._misses += 1
                t = cell[key] = cost(
                    cell[_STATIC], n, "WSP", next_n, cell[_BODY], ctype,
                    next_ct,
                )
            out.append(t)

    def sweep_transitions(self, alloc, hints, first_moves=False):
        """Score every transition candidate of this clustering as one batch.

        ``hints`` is the list of ``(transition_idx, ep_variant)`` pairs from
        ``_partition_sets``; the return is ``(lats, times)`` -- a float64
        array of segment latencies and the per-candidate cluster-time lists
        -- exactly what evaluating each candidate's ``eval_fn(alloc)`` one
        at a time would produce, bit for bit.  Instead of ``K x n_cl``
        scalar probes, each slot's distinct values are materialized once
        (``span + 2`` memo consults per slot) and all K candidates are
        assembled with a single clipped fancy-index gather + row max.

        With ``first_moves=True`` the return gains a third element: a
        per-candidate head-of-walk decision from batching the *first
        rebalance iteration* as well (see :meth:`_first_moves`).  ``None``
        means "run the scalar walk from the seed" (infeasible seeds take
        the repair phase; small candidate groups are not worth batching),
        ``("done",)`` means the walk provably terminates at the seed, and
        ``("cont", alloc2, lat2, times2)`` is the state after the one
        accepted move, from which the scalar walk continues.
        """
        model = self.model
        n_cl = self.n_cl
        K = len(hints)
        model._evals += K
        model._batch_evals += 1
        model._batch_rows += K
        lats = np.empty(K, dtype=np.float64)
        times: list[list[float] | None] = [None] * K
        heads: list[tuple | None] | None = [None] * K if first_moves else None
        move_tables: dict = {}
        for ep_variant in (False, True):
            rows = [r for r, (_i, ep) in enumerate(hints) if bool(ep) == ep_variant]
            if not rows:
                continue
            idxs = np.array([hints[r][0] for r in rows], dtype=np.int64)
            vals: list[float] = []
            offs = np.empty(n_cl, dtype=np.int64)
            caps = np.empty(n_cl, dtype=np.int64)
            rlos = np.empty(n_cl, dtype=np.int64)
            for j in range(n_cl):
                offs[j] = len(vals)
                self._slot_vals(
                    j, alloc[j],
                    alloc[j + 1] if j + 1 < n_cl else None,
                    ep_variant, vals,
                )
                caps[j] = len(vals) - offs[j] - 1
                rlos[j] = self.rel[j][0]
            flat = np.array(vals, dtype=np.float64)
            pos = np.clip(idxs[None, :] - rlos[:, None], 0, caps[:, None])
            tmat = flat[offs[:, None] + pos]               # n_cl x K_variant
            bn = tmat.max(axis=0)
            lat_v = np.where(np.isinf(bn), INF, self.load_const + self.fill_factor * bn)
            for c, r in enumerate(rows):
                lats[r] = lat_v[c]
                times[r] = tmat[:, c].tolist()
            if first_moves and n_cl > 1:
                self._first_moves(alloc, rows, tmat, pos, lat_v, times, heads,
                                  ep_variant, move_tables)
        if first_moves:
            return lats, times, heads
        return lats, times

    def _first_moves(self, alloc, rows, tmat, pos, lat_v, times, heads,
                     ep_variant, tables) -> None:
        """Batch the first rebalance iteration of every finite-seed candidate.

        Most rebalance walks end immediately: the two fastest donors both
        fail to lower the bottleneck.  This replicates iteration 1 of
        :func:`repro_torch.core.regions.rebalance`'s hot path (``groups=None``,
        ``donor_tries=2``) exactly -- bottleneck = first argmax, donors = the
        two fastest regions with more than one chip excluding the bottleneck
        (first-argmin tie-breaks, like the scalar scans), acceptance =
        strictly lower latency -- but for whole candidate groups at once.
        Candidates are grouped by their (bottleneck, donor) pair; a group's
        post-move cluster times are one fancy-index gather from a value
        table at the moved allocation (``tables`` caches them, keyed
        ``(slot, n, next_n, ep)``).  Groups smaller than
        ``_FIRST_MOVE_MIN_GROUP`` keep ``heads[r] = None`` and take the
        scalar walk -- a table costs ``span + 2`` memo consults, so tiny
        groups would compute more speculative entries than the walk itself.
        """
        model = self.model
        n_cl = self.n_cl
        fin = np.nonzero(np.isfinite(lat_v))[0]
        if not len(fin):
            return
        eligible = np.array([a > 1 for a in alloc], dtype=bool)
        slow = tmat[:, fin].argmax(axis=0)
        M = np.where(eligible[:, None], tmat[:, fin], np.inf)
        ar = np.arange(len(fin))
        M[slow, ar] = np.inf
        d1 = M.argmin(axis=0)
        ok1 = M[d1, ar] < np.inf

        def eval_move(cols, s, d):
            # Post-move state for candidates `cols` (fin-relative) moving
            # one chip from donor d to bottleneck s: exactly what
            # _SegmentSweep.move would compute, gathered per slot.
            a2 = list(alloc)
            a2[s] += 1
            a2[d] -= 1
            aff = [s, d]
            if s - 1 >= 0 and s - 1 != d:
                aff.append(s - 1)
            if d - 1 >= 0 and d - 1 != s:
                aff.append(d - 1)
            gcols = fin[cols]
            newvals = np.empty((len(aff), len(cols)))
            for i, j in enumerate(aff):
                key = (j, a2[j], a2[j + 1] if j + 1 < n_cl else None,
                       ep_variant)
                tab = tables.get(key)
                if tab is None:
                    out: list[float] = []
                    self._slot_vals(j, key[1], key[2], ep_variant, out)
                    tab = tables[key] = np.array(out, dtype=np.float64)
                newvals[i] = tab[pos[j, gcols]]
            model._evals += len(cols)
            rest = np.ones(n_cl, dtype=bool)
            rest[aff] = False
            bn2 = newvals.max(axis=0)
            if rest.any():
                bn2 = np.maximum(bn2, tmat[rest][:, gcols].max(axis=0))
            lat2 = np.where(np.isinf(bn2), INF,
                            self.load_const + self.fill_factor * bn2)
            return a2, aff, newvals, lat2

        def apply_round(pairs, failed):
            for (s, d), cols in pairs.items():
                if len(cols) < _FIRST_MOVE_MIN_GROUP:
                    continue                     # scalar walk (heads stay None)
                cols = np.array(cols)
                a2, aff, newvals, lat2 = eval_move(cols, s, d)
                imp = lat2 < lat_v[fin[cols]]
                for i, c in enumerate(cols):
                    r = rows[fin[c]]
                    if imp[i]:
                        t2 = list(times[r])
                        for ai, j in enumerate(aff):
                            t2[j] = float(newvals[ai, i])
                        heads[r] = ("cont", a2, float(lat2[i]), t2)
                    elif failed is None:
                        heads[r] = ("done",)
                    else:
                        failed.append(int(c))

        pairs1: dict[tuple[int, int], list[int]] = {}
        for c in ar[ok1]:
            pairs1.setdefault((int(slow[c]), int(d1[c])), []).append(int(c))
        for c in ar[~ok1]:
            heads[rows[fin[c]]] = ("done",)      # no donor: walk ends at seed
        fail1: list[int] = []
        apply_round(pairs1, fail1)
        if fail1:
            f1 = np.array(fail1)
            M[d1[f1], f1] = np.inf
            d2 = M[:, f1].argmin(axis=0)
            ok2 = M[d2, f1] < np.inf
            pairs2: dict[tuple[int, int], list[int]] = {}
            for i, c in enumerate(fail1):
                if ok2[i]:
                    pairs2.setdefault((int(slow[c]), int(d2[i])), []).append(c)
                else:
                    heads[rows[fin[c]]] = ("done",)
            apply_round(pairs2, None)
