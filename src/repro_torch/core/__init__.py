"""Scope core: the paper's merged-pipeline scheduler and analytical models.

A copy of the JAX package's ``core/__init__.py``, which is JAX-free.
"""
from .costmodel import CostModel, LayerTime  # noqa: F401
from .fastcost import FastCostModel  # noqa: F401
from .graph import (  # noqa: F401
    PARTITION_EP,
    PARTITION_ISP,
    PARTITION_WSP,
    ClusterAssignment,
    LayerGraph,
    LayerNode,
    ModelAssignment,
    MultiModelSchedule,
    ScopeSchedule,
    SegmentSchedule,
    chain,
    validate_multimodel,
    validate_schedule,
)
from .hw import (  # noqa: F401
    ChipType,
    HardwareModel,
    get_hw,
    mcm_hetero,
    mcm_table_iii,
    tpu_v5e,
)
from .regions import RegionMode  # noqa: F401
from .baselines import (  # noqa: F401
    ALL_METHODS,
    schedule_full_pipeline,
    schedule_scope,
    schedule_segmented,
    schedule_sequential,
)
from .search import search, search_segment  # noqa: F401
