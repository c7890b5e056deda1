"""Hardware models for the Scope cost model.

A copy of the JAX package's ``core/hw.py``, which is JAX-free.

Two presets:

* :data:`MCM_TABLE_III` -- the paper's evaluation platform (Table III).
  Chiplet: 4x4 PEs, 8 lanes/PE, 8 MACs/lane @ 800 MHz => 1024 MAC/cycle =
  819.2 GMAC/s (1.638 TOPS int8).  64 KB weight buffer per PE (1 MiB/chiplet),
  64 KB global (activation) buffer.  NoP: 2D mesh, 100 GB/s per chiplet,
  1.3 pJ/bit.  DRAM: 100 GB/s total (shared), 128-bit LPDDR5.

* :func:`tpu_v5e` -- the TPU adaptation target (see DESIGN.md SS3):
  197 TFLOP/s bf16 per chip, 819 GB/s HBM, ~50 GB/s/link ICI, 16 GiB HBM.

The paper regresses NoP/DRAM behaviour from BookSim2/Ramulator2 and compute
from Timeloop; we replace those regressions with bandwidth/peak roofline terms
plus a tiling-quantization utilization model (``eff``), which captures the
paper's two scaling pathologies: NoP overheads and sub-granule
underutilization ("typical utilization below 40% at 64 chiplets").
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace


def eff(dim: float, granule: int) -> float:
    """Tiling efficiency of mapping ``dim`` work onto units of ``granule``.

    eff = dim / (granule * ceil(dim / granule)); 1.0 when dim is a multiple
    of the granule, small when dim << granule (under-filled compute units).
    """
    if dim <= 0:
        return 1e-9
    tiles = math.ceil(dim / granule)
    return dim / (granule * tiles)


@dataclass(frozen=True)
class ChipType:
    """One chiplet flavor of a heterogeneous package (Odema et al. / SCAR).

    ``flops_scale`` / ``nop_bw_scale`` multiply the package's base
    ``flops_per_chip`` / ``nop_bw_per_chip`` (and ``link_bw``); ``chips`` is
    how many chiplets of this flavor the package carries.  The cost model
    evaluates a cluster placed on chips of a single type; the type name is
    folded into the FastCostModel memo key so cached cluster costs never
    leak across flavors.
    """
    name: str
    chips: int
    flops_scale: float = 1.0
    nop_bw_scale: float = 1.0


@dataclass(frozen=True)
class HardwareModel:
    name: str
    chips: int
    mesh_shape: tuple[int, int]
    flops_per_chip: float          # peak FLOP/s (2 x MAC/s at deploy precision)
    nop_bw_per_chip: float         # bytes/s injection bandwidth per chip
    link_bw: float                 # bytes/s of one mesh link (cross-region)
    dram_bw_total: float           # bytes/s package <-> off-chip
    weight_capacity_per_chip: float  # bytes of resident parameter storage
    act_capacity_per_chip: float   # bytes of activation buffering
    m_granule: int                 # activation-dim tiling granule (WSP dim)
    n_granule: int                 # weight-output-dim tiling granule (ISP dim)
    # KV-cache budget for autoregressive decode (bytes per chip).  This is
    # the memory axis the phase DSE trades against: a decode quota of ``c``
    # chips holds at most ``c * kv_bytes_per_chip / kv_seq_bytes`` concurrent
    # sequences, which caps its sustainable batch below the compute optimum
    # when KV runs out before compute does.  0 falls back to the activation
    # buffer (packages without a dedicated KV slice).
    kv_capacity_per_chip: float = 0.0
    # energy (J/unit)
    e_flop: float = 0.0            # J per FLOP (2 flops per MAC)
    e_nop_byte: float = 0.0
    e_dram_byte: float = 0.0
    e_sram_byte: float = 0.0
    # Heterogeneous package: per-region chip flavors.  Empty = homogeneous
    # (every chip is the base flavor described by the fields above).
    region_types: tuple[ChipType, ...] = ()
    # Cross-flavor seam model: the links crossing the boundary between two
    # adjacent regions of *different* flavors.  Default bandwidth is the
    # weaker flavor's link bandwidth (the seam runs at the slower endpoint's
    # SerDes rate), optionally derated by ``seam_bw_scale`` (interposer
    # crossings slower than intra-flavor links).  ``seam_bw_overrides`` pins
    # specific unordered flavor pairs to an absolute bytes/s per link.
    seam_bw_scale: float = 1.0
    seam_bw_overrides: tuple[tuple[str, str, float], ...] = ()
    # Degraded package: mesh coordinates whose chips have failed.  ``chips``
    # and ``region_types`` count the *surviving* chips only; the dead
    # coordinates stay in the field so placement can carve around the holes
    # (and so the frozen value -- hence every problem fingerprint built on
    # it -- distinguishes a degraded package from an intact smaller one).
    dead_chips: tuple[tuple[int, int], ...] = ()

    def with_chips(self, chips: int) -> "HardwareModel":
        side = int(math.sqrt(chips))
        if side * side == chips:
            shape = (side, side)
        else:
            shape = (max(1, chips // max(1, side)), side)
        return replace(self, chips=chips, mesh_shape=shape)

    @property
    def kv_bytes_per_chip(self) -> float:
        """Per-chip KV-cache budget (falls back to the activation buffer)."""
        return self.kv_capacity_per_chip or self.act_capacity_per_chip

    # ------------------------------------------------------- chip flavors
    @property
    def is_heterogeneous(self) -> bool:
        return len(self.region_types) > 0

    def chip_type(self, name: str) -> ChipType:
        for t in self.region_types:
            if t.name == name:
                return t
        raise KeyError(f"{self.name}: unknown chip type {name!r}")

    def typed(self, name: str | None) -> "HardwareModel":
        """The hardware seen by a region of ``name``-flavored chips.

        Scales compute and NoP injection/link bandwidth by the flavor's
        factors; DRAM and buffer capacities stay package-level properties.
        ``None`` (or empty) is the base flavor: returns ``self`` unchanged,
        so homogeneous callers never pay for the indirection.
        """
        if not name:
            return self
        t = self.chip_type(name)
        return replace(
            self,
            name=f"{self.name}:{name}",
            flops_per_chip=self.flops_per_chip * t.flops_scale,
            nop_bw_per_chip=self.nop_bw_per_chip * t.nop_bw_scale,
            link_bw=self.link_bw * t.nop_bw_scale,
            region_types=(),
        )

    def flavor_link_bw(self, name: str | None) -> float:
        """Link bandwidth of one ``name``-flavored chip's mesh links."""
        if not name:
            return self.link_bw
        return self.link_bw * self.chip_type(name).nop_bw_scale

    def seam_link_bw(self, a: str | None, b: str | None) -> float:
        """Bandwidth of one link on the seam between a region of flavor
        ``a`` and an adjacent region of flavor ``b``.

        Same flavor on both sides: the flavor's own link bandwidth
        (homogeneous seam, the pre-mixed-flavor behavior).  Different
        flavors: an explicit override for the pair if one exists, else the
        weaker flavor's link bandwidth times ``seam_bw_scale``.
        """
        if a == b:
            return self.flavor_link_bw(a)
        for x, y, bw in self.seam_bw_overrides:
            if (x == a and y == b) or (x == b and y == a):
                return bw
        return min(self.flavor_link_bw(a), self.flavor_link_bw(b)) * self.seam_bw_scale

    # --------------------------------------------------------- degradation
    def occupied_coords(self) -> list[tuple[int, int]]:
        """Mesh coordinates the package populates (dead chips included):
        the first ``chips + len(dead_chips)`` steps of the zigzag walk."""
        from .regions import zigzag_order

        return zigzag_order(self.mesh_shape)[: self.chips + len(self.dead_chips)]

    def disable_chips(self, dead) -> "HardwareModel":
        """Derive the degraded package after the chips at ``dead`` mesh
        coordinates fail.

        ``chips`` and each flavor's ``region_types`` count shrink to the
        survivors; flavors with no survivor are dropped; the dead
        coordinates accumulate in ``dead_chips`` so the placement layer
        (:func:`repro_torch.core.regions.flavor_zones` with ``dead=``) carves the
        pristine zones minus the holes.  Seam bookkeeping
        (``seam_bw_scale`` / ``seam_bw_overrides``) is untouched -- the
        surviving seam links keep their bandwidth.  Raises when a
        coordinate is outside the occupied mesh or the whole package dies.
        """
        dead = {(int(r), int(c)) for r, c in dead}
        occupied = self.occupied_coords()
        unknown = dead - set(occupied)
        if unknown:
            raise ValueError(
                f"{self.name}: cannot disable unoccupied coords "
                f"{sorted(unknown)} (mesh {self.mesh_shape}, "
                f"{len(occupied)} chips populated)"
            )
        all_dead = dead | set(self.dead_chips)
        alive = [c for c in occupied if c not in all_dead]
        if not alive:
            raise ValueError(f"{self.name}: every chip is dead")
        new_types = self.region_types
        if self.region_types:
            # Pristine flavor zones are consecutive slices of the walk; an
            # already-degraded package re-derives them from the current
            # (alive) counts by skipping its current dead coords.  Interior
            # dead coords at a zone boundary are attributed to the later
            # zone; the trailing run goes to the last zone -- alive counts,
            # the only observable, are identical either way.
            cur_dead = set(self.dead_chips)
            spans, pos = [], 0
            for i, t in enumerate(self.region_types):
                if i == len(self.region_types) - 1:
                    spans.append(len(occupied) - pos)
                    break
                n_alive = n_total = 0
                while n_alive < t.chips:
                    if occupied[pos + n_total] not in cur_dead:
                        n_alive += 1
                    n_total += 1
                spans.append(n_total)
                pos += n_total
            shrunk, pos = [], 0
            for t, span in zip(self.region_types, spans):
                zone = occupied[pos : pos + span]
                pos += span
                n = sum(1 for c in zone if c not in all_dead)
                if n:
                    shrunk.append(replace(t, chips=n))
            new_types = tuple(shrunk)
        hw = replace(
            self,
            chips=len(alive),
            region_types=new_types,
            dead_chips=tuple(sorted(all_dead)),
        )
        validate_region_types(hw)
        return hw

    def disable_seam(self, a: str, b: str,
                     bw: float = 1.0) -> "HardwareModel":
        """Fail the interconnect seam between flavors ``a`` and ``b``:
        pins the pair's per-link bandwidth to ``bw`` (default 1 byte/s --
        effectively unusable, so a re-solve routes around it) via
        ``seam_bw_overrides``; chips on both sides stay alive."""
        for n in (a, b):
            self.chip_type(n)       # raises on unknown flavors
        overrides = tuple(
            (x, y, w) for x, y, w in self.seam_bw_overrides
            if {x, y} != {a, b}
        ) + ((a, b, bw),)
        return replace(self, seam_bw_overrides=overrides)


def validate_region_types(hw: HardwareModel) -> None:
    if not hw.region_types:
        return
    names = [t.name for t in hw.region_types]
    assert len(set(names)) == len(names), f"duplicate chip types: {names}"
    assert all(n for n in names), "chip types need non-empty names"
    total = sum(t.chips for t in hw.region_types)
    assert total == hw.chips, (
        f"{hw.name}: region_types cover {total} != {hw.chips} chips"
    )
    assert hw.seam_bw_scale > 0, f"seam_bw_scale {hw.seam_bw_scale} <= 0"
    for x, y, bw in hw.seam_bw_overrides:
        assert bw > 0, f"seam override {x}<->{y}: bandwidth {bw} <= 0"
        for n in (x, y):
            assert any(t.name == n for t in hw.region_types), (
                f"seam override names unknown chip type {n!r}"
            )


def mcm_table_iii(chips: int = 256) -> HardwareModel:
    macs_per_s = 16 * 8 * 8 * 800e6          # 4x4 PEs x 8 lanes x 8 MACs @ 800MHz
    return HardwareModel(
        name=f"mcm{chips}",
        chips=chips,
        mesh_shape=(int(math.sqrt(chips)), int(math.sqrt(chips)))
        if int(math.sqrt(chips)) ** 2 == chips
        else (1, chips),
        flops_per_chip=2.0 * macs_per_s,      # 1.638 TOPS int8
        nop_bw_per_chip=100e9,
        link_bw=100e9,                        # paper: 100 GB/s per chiplet
        dram_bw_total=100e9,
        weight_capacity_per_chip=16 * 64 * 1024,   # 16 PEs x 64 KB = 1 MiB
        act_capacity_per_chip=64 * 1024,           # 64 KB global buffer
        kv_capacity_per_chip=32 * 2**20,           # LPDDR KV slice per chiplet
        m_granule=1,                          # row-stripe quantization (rows/chip)
        n_granule=16,                         # out-channels spread across 16 PEs;
                                              # lanes/MACs consume the reduction dim
        e_flop=0.2e-12 / 2.0,                 # 0.2 pJ per 8-bit MAC
        e_nop_byte=1.3e-12 * 8,               # 1.3 pJ/bit
        e_dram_byte=8e-12 * 8,                # LPDDR5 ~8 pJ/bit (documented estimate)
        e_sram_byte=0.6e-12 * 8,              # 28nm SRAM ~0.6 pJ/bit (documented estimate)
    )


def tpu_v5e(chips: int = 256, mesh_shape: tuple[int, int] = (16, 16)) -> HardwareModel:
    return HardwareModel(
        name=f"tpu_v5e_{chips}",
        chips=chips,
        mesh_shape=mesh_shape,
        flops_per_chip=197e12,                # bf16 peak
        nop_bw_per_chip=4 * 50e9,             # 4 ICI links per chip (2D torus)
        link_bw=50e9,
        dram_bw_total=819e9 * chips * 0.05,   # host->HBM staging; prep phase only
        weight_capacity_per_chip=16 * 2**30,  # 16 GiB HBM
        act_capacity_per_chip=16 * 2**30,     # HBM is unified; VMEM modeled in kernels
        m_granule=8,                          # sublane granularity
        n_granule=128,                        # MXU lane width
        e_flop=0.25e-12,                      # ~0.25 pJ/FLOP bf16 (documented estimate)
        e_nop_byte=0.3e-12 * 8,
        e_dram_byte=6e-12 * 8,
        e_sram_byte=0.1e-12 * 8,
    )


def mcm_hetero(
    chips: int = 64,
    big_fraction: float = 0.5,
    big_flops_scale: float = 1.0,
    little_flops_scale: float = 0.5,
    little_nop_scale: float = 0.75,
) -> HardwareModel:
    """Table III package with a big/little chiplet split (hetero extension).

    ``big`` chips are the base Table III chiplet; ``little`` chips trade
    compute (and some NoP bandwidth) for area/power, the setting of the
    multi-model co-scheduling papers (Odema et al., SCAR).
    """
    big = int(round(chips * big_fraction))
    big = min(max(big, 1), chips - 1)
    hw = replace(
        mcm_table_iii(chips),
        name=f"mcm{chips}_hetero",
        region_types=(
            ChipType("big", big, flops_scale=big_flops_scale),
            ChipType("little", chips - big,
                     flops_scale=little_flops_scale,
                     nop_bw_scale=little_nop_scale),
        ),
    )
    validate_region_types(hw)
    return hw


def mcm_hetero3(
    chips: int = 48,
    flops_scales: tuple[float, float, float] = (1.0, 0.6, 0.3),
    nop_scales: tuple[float, float, float] = (1.0, 0.85, 0.7),
) -> HardwareModel:
    """Table III package with three chiplet flavors (big / mid / little).

    Exercises the 3+-flavor regime end to end: the per-cluster mixed DSE
    handles any flavor count, and the multimodel spanning-quota enumeration
    scores k-flavor budget tuples against F-dimensional mixed envelopes
    (``quota.search_partitioned_mixed``), so no single-flavor fallback is
    involved.
    """
    third = chips // 3
    counts = (chips - 2 * third, third, third)
    hw = replace(
        mcm_table_iii(chips),
        name=f"mcm{chips}_hetero3",
        region_types=tuple(
            ChipType(name, n, flops_scale=f, nop_bw_scale=b)
            for name, n, f, b in zip(
                ("big", "mid", "little"), counts, flops_scales, nop_scales
            )
        ),
    )
    validate_region_types(hw)
    return hw


# Convenience preset registry used by benchmarks / CLI.
PRESETS = {
    "mcm16": lambda: mcm_table_iii(16),
    "mcm64": lambda: mcm_table_iii(64),
    "mcm256": lambda: mcm_table_iii(256),
    "mcm1024": lambda: mcm_table_iii(1024),
    "tpu_v5e_256": lambda: tpu_v5e(256, (16, 16)),
    "tpu_v5e_512": lambda: tpu_v5e(512, (16, 32)),
    "mcm64_hetero": lambda: mcm_hetero(64),
    "mcm16_hetero": lambda: mcm_hetero(16),
    "mcm48_hetero3": lambda: mcm_hetero3(48),
}


def get_hw(name: str) -> HardwareModel:
    if name in PRESETS:
        return PRESETS[name]()
    if name.startswith("mcm"):
        return mcm_table_iii(int(name[3:]))
    raise KeyError(name)
