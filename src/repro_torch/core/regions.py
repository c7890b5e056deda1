"""Region allocation: proportional seed + iterative rebalance + ZigZag placement.

A copy of the JAX package's ``core/regions.py``, which is JAX-free.

Paper SSIV-B: chiplets are first allocated across regions proportionally to
cluster computational load; the heuristic then repeatedly moves one chiplet
from the fastest region to the slowest until overall latency stops improving.
Regions are laid out on the 2D mesh in a ZigZag (boustrophedon) pattern.

``RegionMode.UNIFORM`` is the TPU/SPMD constraint (DESIGN.md SS3): all regions
must have equal chip counts, so only ``chips % n_regions == 0`` allocations
are legal and the rebalance loop is disabled -- balance must come from the
cluster-merge dimension instead.
"""
from __future__ import annotations

import enum


class RegionMode(enum.Enum):
    FREE = "free"          # paper: arbitrary per-region chip counts
    UNIFORM = "uniform"    # TPU SPMD: equal-size regions only


def proportional_allocate(loads: list[float], chips: int) -> list[int]:
    """Seed allocation: >=1 chip each, proportional to load, sum == chips."""
    n = len(loads)
    if n > chips:
        raise ValueError(f"{n} clusters > {chips} chips")
    total = sum(loads) or 1.0
    alloc = [max(1, int(chips * l / total)) for l in loads]
    # repair the sum: remove from the most over-provisioned, add to the most
    # under; pressure(i) = alloc[i] / load[i], chips per unit load.  The
    # running-sum / explicit-scan form keeps the exact division and
    # first-argmax tie-breaks of the original max(key=...) loops.
    lds = [max(l, 1e-30) for l in loads]
    s = sum(alloc)
    while s > chips:
        cand, cp = -1, -1.0
        for i in range(n):
            if alloc[i] > 1:
                p = alloc[i] / lds[i]
                if p > cp:
                    cand, cp = i, p
        if cand < 0:
            raise ValueError("cannot satisfy >=1 chip per region")
        alloc[cand] -= 1
        s -= 1
    while s < chips:
        cand, cp = 0, alloc[0] / lds[0]
        for i in range(1, n):
            p = alloc[i] / lds[i]
            if p < cp:
                cand, cp = i, p
        alloc[cand] += 1
        s += 1
    return alloc


def uniform_allocate(n_regions: int, chips: int) -> list[int] | None:
    if chips % n_regions != 0:
        return None
    return [chips // n_regions] * n_regions


def zigzag_order(mesh_shape: tuple[int, int]) -> list[tuple[int, int]]:
    """The boustrophedon walk of the mesh: the 1D chip order every placement
    (and every flavor zone of a heterogeneous package) is carved from."""
    rows, cols = mesh_shape
    order = []
    for r in range(rows):
        rng = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        order.extend((r, c) for c in rng)
    return order


def flavor_zones(
    flavor_counts: list[tuple[str | None, int]],
    mesh_shape: tuple[int, int],
    dead: frozenset[tuple[int, int]] | set | tuple = frozenset(),
) -> dict[str | None, list[tuple[int, int]]]:
    """Physical home of each chip flavor: consecutive slices of the zigzag
    walk, in ``flavor_counts`` (= ``HardwareModel.region_types``) order.

    Adjacent zones share the package's physical flavor seam -- the boundary
    the cost model prices via ``HardwareModel.seam_link_bw``.

    ``dead`` (a degraded package's ``HardwareModel.dead_chips``) removes
    failed coordinates from the walk before slicing.  Because pristine
    zones are consecutive slices and ``flavor_counts`` then carries the
    *surviving* count per flavor, slicing the filtered walk reproduces
    exactly each pristine zone minus its holes.
    """
    order = zigzag_order(mesh_shape)
    if dead:
        dead = set(dead)
        order = [c for c in order if c not in dead]
    if sum(c for _, c in flavor_counts) > len(order):
        raise ValueError("flavor zones exceed mesh capacity")
    zones, cursor = {}, 0
    for flavor, c in flavor_counts:
        if flavor in zones:
            raise ValueError(f"duplicate flavor {flavor!r}")
        zones[flavor] = order[cursor : cursor + c]
        cursor += c
    return zones


def zigzag_placement(
    region_sizes: list[int],
    mesh_shape: tuple[int, int],
    region_flavors: list[str | None] | None = None,
    flavor_counts: list[tuple[str | None, int]] | None = None,
    dead: frozenset[tuple[int, int]] | set | tuple = frozenset(),
) -> list[list[tuple[int, int]]]:
    """Assign chip coordinates to regions walking the mesh boustrophedon.

    Keeps each region spatially contiguous, as validated by prior work
    ([17] Tangram) -- consecutive regions share a seam, which is what the
    cost model's cross-region boundary term assumes.

    ``region_flavors`` (mixed-flavor pipelines) makes the placement
    flavor-aware: each region is pinned inside its flavor's physical zone
    (:func:`flavor_zones` over ``flavor_counts``), and each flavor *run* is
    aligned against the zone edge facing the neighboring run's zone, so the
    pipeline's cross-flavor hand-off happens across the physical seam the
    cost model charges.  Region flavors must form contiguous runs -- a
    placement like ``big, little, big`` would tear the big zone apart and
    straddle the seam twice; it raises ``ValueError``.

    ``dead`` coordinates (failed chips of a degraded package) are skipped
    by the walk, so regions place around the holes while staying contiguous
    in the surviving chip order.
    """
    if region_flavors is None:
        order = zigzag_order(mesh_shape)
        if dead:
            order = [c for c in order if c not in set(dead)]
        if sum(region_sizes) > len(order):
            raise ValueError("regions exceed mesh capacity")
        out, cursor = [], 0
        for size in region_sizes:
            out.append(order[cursor : cursor + size])
            cursor += size
        return out

    if flavor_counts is None:
        raise ValueError("region_flavors requires flavor_counts")
    if len(region_flavors) != len(region_sizes):
        raise ValueError(
            f"{len(region_flavors)} flavors for {len(region_sizes)} regions"
        )
    zone_index = {f: k for k, (f, _) in enumerate(flavor_counts)}
    for f in region_flavors:
        if f not in zone_index:
            raise ValueError(f"region flavor {f!r} not in {list(zone_index)}")
    # Group regions into contiguous same-flavor runs.
    runs: list[tuple[str | None, list[int]]] = []
    for i, f in enumerate(region_flavors):
        if runs and runs[-1][0] == f:
            runs[-1][1].append(i)
        else:
            runs.append((f, [i]))
    seen = [f for f, _ in runs]
    if len(set(seen)) != len(seen):
        raise ValueError(
            f"non-contiguous flavor runs {seen}: a flavor's regions must "
            "occupy one contiguous stretch of the pipeline (the placement "
            "would straddle the physical seam)"
        )
    zones = flavor_zones(flavor_counts, mesh_shape, dead=dead)
    out: list[list[tuple[int, int]] | None] = [None] * len(region_sizes)
    for k, (f, idxs) in enumerate(runs):
        need = sum(region_sizes[i] for i in idxs)
        zone = zones[f]
        if need > len(zone):
            raise ValueError(
                f"flavor {f!r} regions need {need} > {len(zone)} chips"
            )
        # Pin the run against the seam shared with its neighboring run
        # (successor preferred: that is where the activations hand off).
        neighbor = (runs[k + 1][0] if k + 1 < len(runs)
                    else runs[k - 1][0] if k > 0 else None)
        start = (len(zone) - need
                 if neighbor is not None and zone_index[neighbor] > zone_index[f]
                 else 0)
        cursor = start
        for i in idxs:
            out[i] = zone[cursor : cursor + region_sizes[i]]
            cursor += region_sizes[i]
    return out  # type: ignore[return-value]


def check_schedule_placement(
    schedule,
    mesh_shape: tuple[int, int],
    flavor_counts: list[tuple[str | None, int]],
    dead: frozenset[tuple[int, int]] | set | tuple = frozenset(),
) -> list[list[list[tuple[int, int]]]]:
    """Flavor-aware placement of every segment of a ``ScopeSchedule``.

    Segments run sequentially, so each places independently; within a
    segment the clusters' flavors must form contiguous runs inside their
    zones (:func:`zigzag_placement` raises otherwise).  This is the one
    placement validator behind both the runtime planner and the serving
    executor; returns per-segment region coordinates.
    """
    return [
        zigzag_placement(
            [cl.region_chips for cl in seg.clusters],
            mesh_shape,
            region_flavors=[cl.chip_type for cl in seg.clusters],
            flavor_counts=flavor_counts,
            dead=dead,
        )
        for seg in schedule.segments
    ]


def check_assignments_placement(
    assignments,
    mesh_shape: tuple[int, int],
    flavor_counts: list[tuple[str | None, int]],
    dead: frozenset[tuple[int, int]] | set | tuple = frozenset(),
) -> None:
    """Run :func:`check_schedule_placement` over a co-schedule's
    assignments, deduplicating shared schedules (merged mode carries one
    schedule on every assignment) -- the one wrapper behind both the
    runtime planner's and the serving executor's placement enforcement."""
    seen: set[int] = set()
    for a in assignments:
        if id(a.schedule) in seen:
            continue
        seen.add(id(a.schedule))
        check_schedule_placement(a.schedule, mesh_shape, flavor_counts,
                                 dead=dead)


def rebalance(
    alloc: list[int],
    eval_fn,
    max_iters: int = 256,
    donor_tries: int = 2,
    paper_strict: bool = False,
    groups: list[int] | None = None,
    times0: tuple[float, list[float]] | None = None,
) -> tuple[list[int], float, list[float]]:
    """Paper's heuristic: move 1 chip from the fastest to the slowest region.

    ``eval_fn(alloc) -> (latency, per_cluster_times)``.  Continues while a
    move strictly improves latency (Alg. 1's inner while-loop), with two
    repairs over the literal pseudocode:

    * an INF seed (some cluster's weights overflow its region) is repaired by
      feeding the first infeasible region one chip at a time from the fastest
      feasible donor, instead of giving up immediately;
    * when the fastest donor's move ties or regresses, the next-fastest
      donor is tried (``donor_tries`` donors in total) before terminating --
      a tie through one donor does not prove no donor can improve.

    ``groups`` (mixed-flavor pipelines) gives each region a pool id: chips
    only move between regions of the same pool, because a chip physically
    belongs to one flavor of the package.  A bottleneck region whose pool
    has no improving donor terminates the walk, exactly as in the ungrouped
    case -- cross-pool moves could never lower a bottleneck outside their
    pool.  ``None`` is a single shared pool (homogeneous behavior).

    ``paper_strict=True`` disables both repairs and replicates Algorithm 1's
    pseudocode exactly: an infeasible seed terminates immediately, and only
    the single fastest region is ever tried as donor.  Use it for
    literal-pseudocode comparison tables; the default explores strictly more.

    ``times0=(latency, per_cluster_times)`` supplies the seed allocation's
    evaluation when the caller already has it -- the batched transition
    sweep (``fastcost._SegmentSweep.sweep_transitions``) scores every
    candidate's seed in one array pass, so re-evaluating it here would undo
    the batching.  The values must equal ``eval_fn(alloc)`` exactly; the
    walk (and therefore the result) is then bit-identical to the unseeded
    call.
    """
    INF = float("inf")
    if paper_strict:
        donor_tries = 1
    best = list(alloc)
    if times0 is not None:
        best_lat, best_times = times0[0], list(times0[1])
    else:
        best_lat, best_times = eval_fn(best)
    if paper_strict and best_lat == INF:
        return best, best_lat, best_times
    # Incremental protocol (fastcost.py): ``move(alloc, times, dst, src, k)``
    # re-evaluates only the clusters a chip transfer actually changes.
    mv = getattr(eval_fn, "move", None)
    if mv is None:
        def mv(base_alloc, base_times, dst, src, k=1):
            trial = list(base_alloc)
            trial[dst] += k
            trial[src] -= k
            lat, times = eval_fn(trial)
            return lat, trial, times

    step = 1        # repair transfer size (doubles while the target stays INF)
    for _ in range(max_iters):
        if not best_times:
            break
        n = len(best_times)
        if best_lat == INF:
            # Repair phase: grow the first infeasible region.  A region goes
            # INF only when weights overflow capacity, and more chips shard
            # weights further, so feeding it is the only move that can help.
            # Transfers grow geometrically so a region that is hundreds of
            # chips short is repaired in O(log) evaluations.
            bad = [j for j, t in enumerate(best_times) if t == INF]
            if not bad:
                break
            # Repair an infeasible region whose pool still has donors
            # (pool-less infeasible regions stay INF and the walk ends).
            if groups is None:
                # Without pools donor availability is receiver-independent,
                # so the scan below always lands on the first bad region.
                target = bad[0]
            else:
                target = next(
                    (
                        j for j in bad
                        if _fastest_donors(best_times, best, bad, 1, groups, j)
                    ),
                    bad[0],
                )
            donors = _fastest_donors(best_times, best, bad, donor_tries,
                                     groups, target)
            moved = False
            for donor in donors:
                # donors all have > 1 chip, so k >= 1
                k = min(step, best[donor] - 1)
                lat, trial, times = mv(best, best_times, target, donor, k)
                # The donor must stay feasible (otherwise chips ping-pong
                # between regions); the target's allocation then grows
                # monotonically while it stays infeasible, so this terminates.
                if times[donor] != INF and sum(1 for t in times if t == INF) <= len(bad):
                    best, best_lat, best_times = trial, lat, times
                    moved = True
                    step = step * 2 if times[target] == INF else 1
                    break
            if not moved:
                if step > 1:    # retry the conservative single-chip transfer
                    step = 1
                    continue
                break
            continue
        if groups is None and donor_tries <= 2:
            # Fused scan (the hot path): one pass finds the bottleneck
            # (first max, matching the plain max scan) and the three
            # fastest donor-eligible regions; dropping the bottleneck from
            # those three leaves the two fastest donors excluding it --
            # exactly ``_fastest_donors(..., (slow,), donor_tries)``.
            slow = 0
            ts = best_times[0]
            t1 = t2 = t3 = 0.0
            j1 = j2 = j3 = -1
            for j, t in enumerate(best_times):
                if t > ts:
                    slow, ts = j, t
                if best[j] > 1:
                    if j1 < 0 or t < t1:
                        t3, j3 = t2, j2
                        t2, j2 = t1, j1
                        t1, j1 = t, j
                    elif j2 < 0 or t < t2:
                        t3, j3 = t2, j2
                        t2, j2 = t, j
                    elif j3 < 0 or t < t3:
                        t3, j3 = t, j
            donors = [d for d in (j1, j2, j3)
                      if d >= 0 and d != slow][:donor_tries]
        else:
            slow = 0
            for j in range(1, n):
                if best_times[j] > best_times[slow]:
                    slow = j
            donors = _fastest_donors(best_times, best, (slow,), donor_tries,
                                     groups, slow)
        improved = False
        for fast in donors:
            lat, trial, times = mv(best, best_times, slow, fast, 1)
            if lat < best_lat:
                best, best_lat, best_times = trial, lat, times
                improved = True
                break
        if not improved:
            break
    return best, best_lat, best_times


def _fastest_donors(times, alloc, exclude, k, groups=None, receiver=None):
    """Indices of the ``k`` fastest regions that can give up a chip.

    With ``groups``, only regions in the receiver's pool may donate (chips
    never cross a flavor boundary).
    """
    pool = None if groups is None or receiver is None else groups[receiver]
    if k <= 2:
        # Hot path (donor_tries <= 2): a two-min scan instead of building
        # and sorting the full (t, j) list.  Strict ``<`` with ascending j
        # reproduces the sort's lexicographic tie-break (smallest t, then
        # smallest j) exactly.
        t1 = t2 = 0.0
        j1 = j2 = -1
        for j, t in enumerate(times):
            if alloc[j] > 1 and j not in exclude:
                if pool is not None and groups[j] != pool:
                    continue
                if j1 < 0 or t < t1:
                    t2, j2 = t1, j1
                    t1, j1 = t, j
                elif j2 < 0 or t < t2:
                    t2, j2 = t, j
        if j1 < 0:
            return []
        if k == 1 or j2 < 0:
            return [j1]
        return [j1, j2]
    out = []
    for j, t in enumerate(times):
        if alloc[j] > 1 and j not in exclude:
            if pool is not None and groups[j] != pool:
                continue
            out.append((t, j))
    out.sort()
    return [j for _, j in out[:k]]
