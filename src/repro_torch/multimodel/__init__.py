"""Multi-model co-scheduling: N LayerGraphs on one (optionally hetero) MCM.

A copy of the JAX package's ``multimodel/__init__.py``, which is JAX-free.

Production MCM packages serve mixed traffic (Odema et al., SCAR); this
subsystem schedules a set of ``(LayerGraph, traffic_weight)`` models onto a
single package by searching jointly over

* package partitioning into per-model chip quotas (``quota.py``), drawing
  each quota from one flavor of a heterogeneous package -- or *spanning*
  two flavors (``search_partitioned_mixed``), where the model's pipeline
  itself crosses the flavor seam (``repro_torch.core.search.search_mixed``),
* per-model Scope schedules via the existing ``search()`` -- one shared
  :class:`~repro_torch.core.fastcost.FastCostModel` memo makes the repeated
  ``(graph, chips, chip_type)`` sub-searches across quota candidates
  near-free,
* a merged interleaving mode (``interleave.py``) that concatenates small
  models into one shared merged pipeline with per-model batch weighting.

The figure of merit is weighted throughput at the traffic mix: the largest
``lambda`` such that model ``i`` sustains ``lambda * weight_i`` samples/s,
times the total weight (see :class:`repro_torch.core.graph.MultiModelSchedule`).
``co_schedule`` returns the best of the searched modes and is compared in
``benchmarks/fig11_multimodel.py`` against the two static baselines
(equal-split and whole-package time-multiplexing, ``baselines.py``).
"""
from ..core.graph import (  # noqa: F401
    MM_MERGED,
    MM_PARTITIONED,
    MM_TIME_MUX,
    ModelAssignment,
    MultiModelSchedule,
    validate_multimodel,
)
from .spec import ModelSpec, parse_mix  # noqa: F401
from .curves import (  # noqa: F401
    MixedCurve,
    ThroughputCurve,
    build_curves,
    mixed_throughput_curve,
)
from .quota import (  # noqa: F401
    brute_force_partitioned,
    search_partitioned,
    search_partitioned_mixed,
)
from .interleave import (  # noqa: F401
    merged_graph,
    search_merged,
    search_merged_groups,
)
from .baselines import equal_split, time_multiplexed  # noqa: F401
from .coschedule import co_schedule, describe  # noqa: F401
