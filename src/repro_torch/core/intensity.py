"""Grid carbon intensities (paper Table 2) and CI traces (paper §4).

The paper uses 2023 average CIs from Electricity Maps for three regions with
distinct energy mixes. For the CI-directed-serving extension (§4 "CI-directed
LLM serving") we also provide synthetic diurnal traces: solar-heavy grids
(CISO) dip mid-day, coal/gas grids are flat, hydro grids are flat-low.

Each region also has a multi-criteria ZONE record (water / primary-energy /
ADPe factors of the same electricity mix) in :mod:`repro_torch.core.impacts` —
kept separate so this module stays exactly the paper's Table 2 and the gCO2
path never routes through the ledger (docs/METHODOLOGY.md#regions-and-zones).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence


@dataclasses.dataclass(frozen=True)
class Region:
    name: str
    location: str
    main_sources: str
    ci_g_per_kwh: float         # 2023 average (Table 2)
    # diurnal shape: amplitude as a fraction of the mean, and the local hour
    # of minimum CI (solar regions dip mid-day).
    diurnal_amplitude: float = 0.0
    min_hour: float = 13.0


QC = Region("QC", "Quebec (Canada)", "Hydro, Wind", 31.0,
            diurnal_amplitude=0.05, min_hour=3.0)
CISO = Region("CISO", "California (USA)", "Gas, Solar", 262.0,
              diurnal_amplitude=0.35, min_hour=13.0)
PACE = Region("PACE", "WY/UT/AZ/NM/ID (USA)", "Coal, Gas", 647.0,
              diurnal_amplitude=0.08, min_hour=14.0)

REGIONS: Dict[str, Region] = {r.name: r for r in (QC, CISO, PACE)}


def get_region(name: str) -> Region:
    try:
        return REGIONS[name]
    except KeyError:
        raise KeyError(f"unknown region {name!r}; known: {sorted(REGIONS)}") from None


def ci_at_hour(region: Region, hour: float) -> float:
    """Synthetic diurnal CI trace, gCO2eq/kWh; mean equals the Table 2 value."""
    phase = 2.0 * math.pi * (hour - region.min_hour) / 24.0
    return region.ci_g_per_kwh * (1.0 - region.diurnal_amplitude * math.cos(phase))


def ci_trace(region: Region, hours: Sequence[float]) -> list:
    return [ci_at_hour(region, h) for h in hours]
