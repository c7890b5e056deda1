"""Roofline terms of a step on one NVIDIA H100 SXM (port of
``repro/launch/hlo_analysis.py``).

The reference parses compiled XLA HLO for its collectives' bytes.  torch has
no HLO: the dry-run (``launch/dryrun.py``) counts a step's work from the aten
operations it dispatches and from each hand kernel's own count
(``kernels/cost.py``), and :func:`collective_stats` reads a rank's
collectives from the recorder they went through
(``runtime/collectives.Collectives``): the same fields, each op's result
bytes by kind, as the reference sums them from HLO.  One rank issues none.

The constants are the H100 SXM data sheet's dense peaks and HBM3 rate; the
card's name and memory, as ``chip_smoke.py`` phase 20 reads them, stand
beside them.  The dry-run's peak is what the allocator hands out with
expandable segments (each block its request rounded up to 512 bytes); what
it reserves from the card, with those segments or without, is more, by at
most ``RESERVED_MARGIN`` of that peak on phase 20(c)'s steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..kernels.cost import KernelCost

CARD_NAME = "NVIDIA H100 80GB HBM3"
CARD_TOTAL_MEMORY = 85_017_493_504   # torch.cuda.get_device_properties(0).total_memory
# what one process's step can allocate: torch.cuda.mem_get_info()'s free bytes
# once the CUDA context is up, every kernel loaded and cuBLAS' workspaces made
# (84,213,432,320 read), rounded down to 64 MiB
CARD_USABLE_MEMORY = 84_154_515_456
# the allocator's reserved peak over a step above the dry-run's peak, as a
# share of that peak: 0.040 to 0.105 over phase 20(c)'s four steps under
# either allocator in two runs (the default allocator's varies from run to
# run: jamba's period 0.076, then 0.105), with room for that spread
RESERVED_MARGIN = 0.15


COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def to_dict(self):
        return {"bytes_by_kind": self.bytes_by_kind,
                "count_by_kind": self.count_by_kind,
                "total_bytes": self.total_bytes}


def collective_stats(comm) -> CollectiveStats:
    """The result bytes and count of every collective ``comm`` (a rank's
    :class:`~repro_torch.runtime.collectives.Collectives`) recorded, by kind."""
    s = comm.stats()
    return CollectiveStats(dict(s["bytes_by_kind"]), dict(s["count_by_kind"]))


@dataclass(frozen=True)
class HwConstants:
    peak_flops: float = 989e12       # bf16 dense tensor cores / card
    hbm_bw: float = 3.35e12          # bytes/s / card (HBM3)
    link_bw: float = 450e9           # bytes/s / card, one direction of NVLink 4
    fp32_flops: float = 67e12        # fp32 outside the tensor cores
    int8_ops: float = 1979e12        # int8 dense tensor cores


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    chips: int,
    hw: HwConstants = HwConstants(),
) -> dict:
    """The three roofline terms in seconds (per step, whole mesh), as the
    reference computes them: flops over the bf16 peak, bytes over HBM,
    collective bytes over one link."""
    compute = hlo_flops / hw.peak_flops
    memory = hlo_bytes / hw.hbm_bw
    collective = collective_bytes / hw.link_bw
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": max(compute, memory, collective),
    }


def unit_peak(unit: str, hw: HwConstants = HwConstants()) -> float:
    """Operations a second of the unit that runs a kernel's work."""
    return {"bf16": hw.peak_flops, "fp32": hw.fp32_flops, "int8": hw.int8_ops}[unit]


def kernel_bound(cost: KernelCost, hw: HwConstants = HwConstants()) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time the card takes for
    a kernel's work, its operations over the peak of their unit or its bytes
    over HBM, whichever is longer."""
    t_ops, t_mem = cost.flops / unit_peak(cost.unit, hw), cost.bytes / hw.hbm_bw
    return max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"
