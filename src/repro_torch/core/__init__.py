"""Scope core: the paper's cost model and the layer graphs it prices (a copy
of the JAX package's ``core/`` modules that the planner's DSE branch needs).

Only the copied modules are exported: the search (``baselines``, ``search``,
``segments``, ``partition``, ``cmt``) and the CNN workloads are not copied
yet (ROADMAP A5, ``plan_for_multimodel``).
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
