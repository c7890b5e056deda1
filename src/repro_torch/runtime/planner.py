"""Plan for an (arch x shape x mesh) cell (port of ``repro/runtime/planner.py``).

The two branches that need no design-space exploration: decode cells and
``use_dse=False``.  The DSE branch sweeps the paper's WSP->ISP transition
with the cost model in ``repro/core``, which this package has not copied yet.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .sharding import ShardPlan


def plan_for_cell(
    cfg: ModelConfig,
    seq_len: int,
    global_batch: int,
    mesh_axes: tuple[str, ...],
    model_axis: int = 16,
    kind: str = "train",
    use_dse: bool = True,
) -> ShardPlan:
    if kind == "decode" or not use_dse:
        # single-token steps have no sequence to split: pure ISP
        return ShardPlan(mesh_axes=mesh_axes, p1="ISP", p2="ISP",
                         transition_repeat=None, meta={"kind": kind, "dse": False})
    raise NotImplementedError(
        "plan_for_cell with the DSE sweep needs the cost model (repro/core) "
        "copied into the port: ROADMAP A5"
    )
