"""Carbon accounting — paper §3, Equations 2–4.

    C_prompt = C_op + C_em = E_prompt * CI + (t_prompt / LT) * C_em,device

Operational carbon scales with grid CI; embodied carbon is fixed at
manufacturing time and amortized over the device lifetime (default 5 years,
§3.1; §3.4 sweeps 4–8 years).

This module is the gCO2 leg of the multi-criteria ledger AND its parity
oracle: :func:`repro_torch.core.impacts.price_energy` calls :func:`total_carbon`
unchanged, so the carbon numbers are bit-identical with or without the
ledger (docs/METHODOLOGY.md#the-impact-ledger).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

from repro_torch.core import act
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.intensity import Region, get_region

J_PER_KWH = 3.6e6
SECONDS_PER_YEAR = 365.25 * 24 * 3600
DEFAULT_LIFETIME_YEARS = 5.0


def operational_carbon_g(energy_j: float, ci_g_per_kwh: float) -> float:
    """Eq. 2: C_op = E * CI. Energy in joules, CI in g/kWh, result grams."""
    if energy_j < 0:
        raise ValueError("energy must be non-negative")
    return energy_j / J_PER_KWH * ci_g_per_kwh


def embodied_carbon_g(profile: HardwareProfile) -> float:
    """Total manufacturing carbon of a device, grams (paper Table 1)."""
    return act.embodied_carbon(profile).total_g


def amortized_embodied_g(profile: HardwareProfile, t_seconds: float,
                         lifetime_years: float = DEFAULT_LIFETIME_YEARS) -> float:
    """Eq. 3: C_em,prompt = (t / LT) * C_em."""
    if t_seconds < 0:
        raise ValueError("time must be non-negative")
    if lifetime_years <= 0:
        raise ValueError("lifetime must be positive")
    lt_s = lifetime_years * SECONDS_PER_YEAR
    return t_seconds / lt_s * embodied_carbon_g(profile)


@dataclasses.dataclass(frozen=True)
class CarbonBreakdown:
    """Per-prompt (or per-step / per-token) carbon, grams CO2eq."""

    operational_g: float
    embodied_g: float
    energy_j: float
    time_s: float
    region: str
    device: str
    tokens: float = 0.0

    @property
    def total_g(self) -> float:
        return self.operational_g + self.embodied_g

    @property
    def embodied_fraction(self) -> float:
        tot = self.total_g
        return self.embodied_g / tot if tot > 0 else 0.0

    @property
    def g_per_token(self) -> float:
        return self.total_g / max(self.tokens, 1e-12)

    def __add__(self, other: "CarbonBreakdown") -> "CarbonBreakdown":
        return CarbonBreakdown(
            operational_g=self.operational_g + other.operational_g,
            embodied_g=self.embodied_g + other.embodied_g,
            energy_j=self.energy_j + other.energy_j,
            time_s=self.time_s + other.time_s,
            region=self.region if self.region == other.region else "mixed",
            device=self.device if self.device == other.device else "mixed",
            tokens=self.tokens + other.tokens,
        )


def total_carbon(
    profile: HardwareProfile,
    energy_j: float,
    t_seconds: float,
    region: Union[str, Region],
    lifetime_years: float = DEFAULT_LIFETIME_YEARS,
    tokens: float = 0.0,
    n_devices: int = 1,
) -> CarbonBreakdown:
    """Eq. 4: total = operational + amortized embodied.

    ``n_devices``: multi-chip serving multiplies both the energy (already
    aggregated by the caller) amortization base and the embodied share —
    every participating chip ages for ``t_seconds``.
    """
    r = get_region(region) if isinstance(region, str) else region
    if math.isinf(energy_j) or math.isinf(t_seconds):
        return CarbonBreakdown(math.inf, math.inf, math.inf, math.inf,
                               r.name, profile.name, tokens)
    op = operational_carbon_g(energy_j, r.ci_g_per_kwh)
    em = n_devices * amortized_embodied_g(profile, t_seconds, lifetime_years)
    return CarbonBreakdown(operational_g=op, embodied_g=em, energy_j=energy_j,
                           time_s=t_seconds, region=r.name,
                           device=profile.name, tokens=tokens)


def lifetime_sweep(profile: HardwareProfile, energy_j: float, t_seconds: float,
                   region: Union[str, Region],
                   lifetimes=(4.0, 5.0, 6.0, 7.0, 8.0)):
    """Paper §3.4 / Figure 7: embodied share vs device lifetime."""
    out = []
    for lt in lifetimes:
        cb = total_carbon(profile, energy_j, t_seconds, region,
                          lifetime_years=lt)
        out.append((lt, cb.embodied_fraction, cb))
    return out
