"""Multi-criteria impact ledger — water, primary energy, and abiotic
depletion alongside the paper's gCO2eq (Eq. 2-4).

The paper prices operational joules at a regional carbon intensity and adds
ACT-style embodied rent; Wu et al. (2025, "Unveiling Environmental Impacts
of LLM Serving: A Functional Unit View") show that the same per-functional-
unit ledger extends to three more criteria, each a linear factor on the
electricity mix of the serving zone:

* **water** (L): on-site cooling (WUE x PUE) plus off-site withdrawal at
  the power plants of the mix (EWIF);
* **primary energy** (MJ): fuel-chain MJ per delivered kWh (PEF) — a
  fossil grid burns ~2.6 MJ of primary fuel per kWh at the socket, hydro
  ~1.1;
* **abiotic depletion** (mg Sb-eq): mineral/metal depletion of generating
  the electricity (ADPe), dominated by PV/metal-heavy mixes.

Embodied counterparts follow the ACT structure of :mod:`repro_torch.core.act`:
manufacturing water / primary energy / ADPe are modeled from die area and
memory capacity and amortized over the device lifetime exactly like Eq. 3
amortizes embodied carbon — same denominator, same ``n_devices`` scaling,
so degraded-fleet re-denomination (``FleetMeterView.set_live``) carries
all four criteria automatically.

Every factor is documented, with provenance, in
``docs/METHODOLOGY.md#multi-criteria-factors``. The gCO2eq path is NOT
routed through this module: :func:`price_energy` calls
:func:`repro_torch.core.carbon.total_carbon` unchanged, which is what makes the
pre-PR carbon meter the bit-exact parity oracle for the ledger
(``tests/test_impacts.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

from repro_torch.core.carbon import (DEFAULT_LIFETIME_YEARS, J_PER_KWH,
                               SECONDS_PER_YEAR, CarbonBreakdown,
                               total_carbon)
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.intensity import Region

# ---------------------------------------------------------------------------
# Electricity-mix zones (operational factors)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ZoneFactors:
    """Per-kWh impact factors of one electricity-mix zone.

    ``water_l_per_kwh`` folds the datacenter's on-site WUE x PUE together
    with the mix's off-site EWIF (power-plant withdrawal); the other two
    are pure mix factors. CI is deliberately NOT here — carbon stays
    priced by :mod:`repro_torch.core.carbon` against the
    :mod:`repro_torch.core.intensity` region (optionally diurnal), so the gCO2
    ledger is unchanged by this module's existence.
    """

    zone: str
    water_l_per_kwh: float      # on-site WUE*PUE + off-site EWIF
    primary_mj_per_kwh: float   # primary-energy factor (PEF), MJ/kWh
    adpe_mg_per_kwh: float      # abiotic depletion, mg Sb-eq/kWh
    # scale on the EMBODIED water/PE/ADPe legs (manufacturing amortization)
    # priced under this zone — 1.0 everywhere real; 0.0 is the parity
    # lever that degrades the ledger to the pre-PR gCO2+J meter
    embodied_scale: float = 1.0

    @staticmethod
    def zero(zone: str = "zero") -> "ZoneFactors":
        """All-zero factors (operational AND embodied legs): the ledger
        degenerates to the pre-PR meter (gCO2 + J only) — the parity
        lever of tests/test_impacts.py."""
        return ZoneFactors(zone, 0.0, 0.0, 0.0, embodied_scale=0.0)


# Factor provenance: docs/METHODOLOGY.md#multi-criteria-factors (WUE/PUE
# per climate, Macknick et al. EWIF medians per source, IEA-style PEFs,
# ADEME-order ADPe magnitudes). Zones mirror intensity.REGIONS.
QC_ZONE = ZoneFactors("QC", water_l_per_kwh=1.32,
                      primary_mj_per_kwh=4.0, adpe_mg_per_kwh=0.015)
CISO_ZONE = ZoneFactors("CISO", water_l_per_kwh=1.75,
                        primary_mj_per_kwh=7.3, adpe_mg_per_kwh=0.10)
PACE_ZONE = ZoneFactors("PACE", water_l_per_kwh=2.55,
                        primary_mj_per_kwh=9.4, adpe_mg_per_kwh=0.062)

# Unknown regions (a custom Region registered beside Table 2) price at a
# world-average mix rather than crashing the meter mid-serve.
WORLD_ZONE = ZoneFactors("WORLD", water_l_per_kwh=2.0,
                         primary_mj_per_kwh=8.1, adpe_mg_per_kwh=0.062)

ZONES: Dict[str, ZoneFactors] = {z.zone: z
                                 for z in (QC_ZONE, CISO_ZONE, PACE_ZONE)}


def zone_of(region: Union[str, Region]) -> ZoneFactors:
    """Resolve a region (name or Region) to its zone record; regions
    without a curated zone fall back to :data:`WORLD_ZONE` factors."""
    name = region if isinstance(region, str) else region.name
    z = ZONES.get(name)
    if z is None:
        return dataclasses.replace(WORLD_ZONE, zone=name)
    return z


# ---------------------------------------------------------------------------
# Embodied (manufacturing) factors, ACT-style: die area + memory capacity
# ---------------------------------------------------------------------------

# Ultra-pure water per cm^2 of die (fab UPW ~8-12 kL per 300 mm wafer),
# fab primary energy per cm^2, and mineral depletion per cm^2 / per GB —
# order-of-magnitude constants in the ecologits/ADEME range, documented
# with sources in docs/METHODOLOGY.md#embodied-factors.
WPA_L_PER_CM2 = 12.0          # manufacturing water per die cm^2
WPG_L_PER_GB = 1.5            # per GB of onboard memory
EPA_MJ_PER_CM2 = 14.0         # fab primary energy per die cm^2
EPG_MJ_PER_GB = 2.0
ADPE_MG_PER_CM2 = 900.0       # mineral depletion per die cm^2
ADPE_MG_PER_GB = 25.0
DEFAULT_FAB_YIELD = 0.875     # matches repro_torch.core.act


@dataclasses.dataclass(frozen=True)
class EmbodiedImpacts:
    """Total manufacturing impacts of ONE device (not yet amortized)."""

    water_l: float
    primary_mj: float
    adpe_mg: float


def embodied_impacts(profile: HardwareProfile,
                     fab_yield: float = DEFAULT_FAB_YIELD) -> EmbodiedImpacts:
    if not (0.0 < fab_yield <= 1.0):
        raise ValueError(f"yield must be in (0, 1], got {fab_yield}")
    area_cm2 = profile.die_mm2 / 100.0
    return EmbodiedImpacts(
        water_l=area_cm2 * WPA_L_PER_CM2 / fab_yield
        + profile.mem_gb * WPG_L_PER_GB,
        primary_mj=area_cm2 * EPA_MJ_PER_CM2 / fab_yield
        + profile.mem_gb * EPG_MJ_PER_GB,
        adpe_mg=area_cm2 * ADPE_MG_PER_CM2 / fab_yield
        + profile.mem_gb * ADPE_MG_PER_GB,
    )


# ---------------------------------------------------------------------------
# Pricing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiImpactBreakdown:
    """One metering event priced across all four criteria.

    ``carbon`` is the unchanged Eq. 2-4 :class:`CarbonBreakdown` (the
    parity oracle); the other three criteria each split into an
    operational part (energy x zone factor) and an embodied part
    (manufacturing impact amortized t/LT x n_devices, exactly Eq. 3's
    structure).
    """

    carbon: CarbonBreakdown
    zone: str
    operational_water_l: float
    embodied_water_l: float
    operational_primary_mj: float
    embodied_primary_mj: float
    operational_adpe_mg: float
    embodied_adpe_mg: float

    # convenience totals (what PhaseStats accumulates)
    @property
    def water_l(self) -> float:
        return self.operational_water_l + self.embodied_water_l

    @property
    def primary_mj(self) -> float:
        return self.operational_primary_mj + self.embodied_primary_mj

    @property
    def adpe_mg(self) -> float:
        return self.operational_adpe_mg + self.embodied_adpe_mg

    # mirror the CarbonBreakdown surface so existing callers of
    # CarbonMeter.record keep reading .operational_g/.total_g etc.
    @property
    def operational_g(self) -> float:
        return self.carbon.operational_g

    @property
    def embodied_g(self) -> float:
        return self.carbon.embodied_g

    @property
    def total_g(self) -> float:
        return self.carbon.total_g

    @property
    def energy_j(self) -> float:
        return self.carbon.energy_j

    @property
    def time_s(self) -> float:
        return self.carbon.time_s

    @property
    def tokens(self) -> float:
        return self.carbon.tokens


def price_energy(
    profile: HardwareProfile,
    energy_j: float,
    t_seconds: float,
    region: Union[str, Region],
    zone: Optional[ZoneFactors] = None,
    lifetime_years: float = DEFAULT_LIFETIME_YEARS,
    tokens: float = 0.0,
    n_devices: float = 1,
) -> MultiImpactBreakdown:
    """Price one (energy, time) event across all four criteria.

    The carbon leg IS :func:`repro_torch.core.carbon.total_carbon` — same
    arguments, same result, bit for bit. The three new criteria are
    linear: operational = energy_j/J_PER_KWH x factor, embodied =
    n_devices x (t/LT) x manufacturing impact.
    """
    cb = total_carbon(profile, energy_j, t_seconds, region,
                      lifetime_years=lifetime_years, tokens=tokens,
                      n_devices=n_devices)
    z = zone if zone is not None else zone_of(region)
    if math.isinf(energy_j) or math.isinf(t_seconds):
        inf = math.inf
        return MultiImpactBreakdown(cb, z.zone, inf, inf, inf, inf, inf, inf)
    kwh = energy_j / J_PER_KWH
    em = embodied_impacts(profile)
    share = (n_devices * t_seconds / (lifetime_years * SECONDS_PER_YEAR)
             * z.embodied_scale)
    return MultiImpactBreakdown(
        carbon=cb, zone=z.zone,
        operational_water_l=kwh * z.water_l_per_kwh,
        embodied_water_l=share * em.water_l,
        operational_primary_mj=kwh * z.primary_mj_per_kwh,
        embodied_primary_mj=share * em.primary_mj,
        operational_adpe_mg=kwh * z.adpe_mg_per_kwh,
        embodied_adpe_mg=share * em.adpe_mg,
    )
