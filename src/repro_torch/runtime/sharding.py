"""Execution plan of one (arch x shape x mesh) cell.

The dataclass of ``repro/runtime/sharding.py`` (fields and ``dp``), so plans
read the same in both packages.  One card has no sharding: the GSPMD
partition specs of the reference have no counterpart until the multi-GPU
slice (ROADMAP A13).
"""
from __future__ import annotations

from dataclasses import dataclass, field

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
