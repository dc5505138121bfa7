"""ACT-style embodied-carbon model (Gupta et al., ISCA'22), as used in §3.1.

The paper models embodied carbon from chip area and memory capacity using
ACT and reports the totals in Table 1: 26.6 kg CO2eq for RTX6000 Ada and
10.3 kg for T4. We implement the same three-component structure

    C_em = C_die + C_memory + C_packaging
    C_die = area_cm^2 * CPA(node) / yield
    C_memory = mem_GB * CPG(mem_type)

with carbon-per-area (CPA) values in the range published by ACT for the
TSMC-class nodes and fit (within a few percent) so that the two paper
devices land on Table 1. ``tests/test_act.py`` pins the Table 1 agreement.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import HardwareProfile

# kg CO2eq per cm^2 of die, by technology node (nm). Newer nodes have more
# EUV steps + higher energy per wafer -> higher CPA (ACT Fig. 6 trend).
CPA_KG_PER_CM2 = {
    3: 2.6,
    5: 2.05,
    7: 1.7,
    10: 1.4,
    12: 1.00,
    16: 0.95,
    28: 0.85,
}

# kg CO2eq per GB of onboard memory.
CPG_KG_PER_GB = {
    "GDDR6": 0.25,
    "HBM2": 0.27,
    "HBM2e": 0.27,
    "HBM3": 0.29,
}

DEFAULT_FAB_YIELD = 0.875
PACKAGING_KG = 0.15


@dataclasses.dataclass(frozen=True)
class EmbodiedBreakdown:
    die_kg: float
    memory_kg: float
    packaging_kg: float

    @property
    def total_kg(self) -> float:
        return self.die_kg + self.memory_kg + self.packaging_kg

    @property
    def total_g(self) -> float:
        return self.total_kg * 1000.0


def cpa_for_node(node_nm: float) -> float:
    """CPA for a node, interpolating between the tabulated nodes."""
    nodes = sorted(CPA_KG_PER_CM2)
    if node_nm <= nodes[0]:
        return CPA_KG_PER_CM2[nodes[0]]
    if node_nm >= nodes[-1]:
        return CPA_KG_PER_CM2[nodes[-1]]
    for lo, hi in zip(nodes, nodes[1:]):
        if lo <= node_nm <= hi:
            w = (node_nm - lo) / (hi - lo)
            return CPA_KG_PER_CM2[lo] * (1 - w) + CPA_KG_PER_CM2[hi] * w
    raise AssertionError("unreachable")


def embodied_carbon(
    profile: HardwareProfile,
    fab_yield: float = DEFAULT_FAB_YIELD,
) -> EmbodiedBreakdown:
    """Total embodied carbon of one device, kg CO2eq (paper Table 1)."""
    if not (0.0 < fab_yield <= 1.0):
        raise ValueError(f"yield must be in (0, 1], got {fab_yield}")
    area_cm2 = profile.die_mm2 / 100.0
    die = area_cm2 * cpa_for_node(profile.tech_node_nm) / fab_yield
    mem = profile.mem_gb * CPG_KG_PER_GB[profile.mem_type]
    return EmbodiedBreakdown(die_kg=die, memory_kg=mem, packaging_kg=PACKAGING_KG)
