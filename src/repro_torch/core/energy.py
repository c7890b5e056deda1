"""Per-sample energy breakdown (paper Fig. 10b).

A copy of the JAX package's ``core/energy.py``, which is JAX-free.

Components: MAC (compute), SRAM (activation + weight buffer traffic), NoP
(inter-chiplet), DRAM (weight loads amortized over the batch + segment
boundary activation spills).  Constants live on the HardwareModel; the
paper's synthesized numbers are Table III (0.2 pJ/8-bit MAC, 1.3 pJ/bit NoP),
the rest are documented estimates -- Fig. 10b is reported normalized, so the
breakdown *structure* is what is reproduced.
"""
from __future__ import annotations

from dataclasses import dataclass

from .costmodel import CostModel
from .graph import LayerGraph, ScopeSchedule


@dataclass(frozen=True)
class EnergyBreakdown:
    mac: float
    sram: float
    nop: float
    dram: float

    @property
    def total(self) -> float:
        return self.mac + self.sram + self.nop + self.dram

    def normalized(self, base: float | None = None):
        b = base or self.total
        return {
            "mac": self.mac / b,
            "sram": self.sram / b,
            "nop": self.nop / b,
            "dram": self.dram / b,
        }


def schedule_energy(cost: CostModel, graph: LayerGraph, sched: ScopeSchedule) -> EnergyBreakdown:
    hw, m = cost.hw, cost.m
    mac = sram = nop = dram = 0.0
    for seg_idx, seg in enumerate(sched.segments):
        clusters = seg.clusters
        for j, cl in enumerate(clusters):
            placement = cost.place_weights(graph, cl)
            n = cl.region_chips
            layers = graph.layers[cl.layer_lo : cl.layer_hi]
            for k, (layer, p) in enumerate(zip(layers, cl.partitions)):
                mac += layer.flops * hw.e_flop
                # activation + one weight sweep through on-chip SRAM per beat
                sram += (2.0 * (layer.in_bytes + layer.out_bytes) + layer.weight_bytes) * hw.e_sram_byte
                last_layer = k == len(layers) - 1
                if not last_layer:
                    nxt_p, nxt_n, same = cl.partitions[k + 1], n, True
                elif j + 1 < len(clusters):
                    nc = clusters[j + 1]
                    nxt_p, nxt_n, same = nc.partitions[0], nc.region_chips, False
                else:
                    nxt_p, nxt_n, same = None, None, False
                nop += cost.comm_volume(layer, p, n, nxt_p, nxt_n, same) * hw.e_nop_byte
                nop += placement.gather_bytes[k] * n * hw.e_nop_byte
                dram += layer.weight_bytes / m * hw.e_dram_byte  # amortized load
                if last_layer and j == len(clusters) - 1 and seg_idx + 1 < len(sched.segments):
                    dram += layer.out_bytes * hw.e_dram_byte     # spill
                    dram += layer.out_bytes * hw.e_dram_byte     # refill next seg
    return EnergyBreakdown(mac=mac, sram=sram, nop=nop, dram=dram)


def sequential_energy(cost: CostModel, graph: LayerGraph) -> EnergyBreakdown:
    """Energy of the fully-sequential baseline (whole package per layer)."""
    hw, m, chips = cost.hw, cost.m, cost.hw.chips
    mac = sram = nop = dram = 0.0
    for i, layer in enumerate(graph.layers):
        mac += layer.flops * hw.e_flop
        sram += (2.0 * (layer.in_bytes + layer.out_bytes) + layer.weight_bytes) * hw.e_sram_byte
        nxt = "WSP" if i + 1 < len(graph.layers) else None
        nop += cost.comm_volume(layer, "WSP", chips, nxt, chips, True) * hw.e_nop_byte
        dram += layer.weight_bytes / m * hw.e_dram_byte
    return EnergyBreakdown(mac=mac, sram=sram, nop=nop, dram=dram)
