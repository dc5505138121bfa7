"""CarbonMeter — per-request / per-token / per-phase carbon accounting.

This is the paper's measurement harness recast as a first-class serving
component: every prefill/decode step the engine executes reports its
(time, energy, tokens) here; the meter attributes operational carbon via the
region CI (optionally time-varying) and amortized embodied carbon via the
device profile — giving the paper's per-token, per-phase breakdowns
(Figures 2–6) live, per request class, in production.

Phase names are open-ended (``phases`` is a defaultdict); the serving
engines use four: ``"prefill"`` and ``"decode"`` for ordinary work,
``"recompute"`` for the resume prefill of a PREEMPTED request, and
``"migrate"`` for live KV-page copies between shards (drain, reachable
evacuation, power-cap shedding). Keeping recompute and migrate out of
the prefill/decode buckets makes the per-phase J-per-token figures — and
every undisturbed request's attributed energy — invariant to the
preemption and migration policies, while each phase totals the true
energy price of its mechanism (the engine also surfaces them per request
as ``Response.recompute_j`` and fleet-wide as ``preempted_recompute_j``
/ ``migrate_j``). A migrate record is charged on BOTH endpoints of the
copy — each shard's meter prices its own side at its own profile/CI.

Since PR 9 every record is priced across the FOUR criteria of the impact
ledger (gCO2eq, water L, primary-energy MJ, ADPe mg Sb-eq) via
:mod:`repro_torch.core.impacts`; the carbon leg still goes through
:func:`repro_torch.core.carbon.total_carbon` unchanged, so the pre-PR meter is
the bit-exact parity oracle (docs/METHODOLOGY.md#the-impact-ledger).

Heterogeneous fleets meter PER SHARD: one CarbonMeter per shard at that
shard's hardware profile × region CI, all sharing one ``SharedClock``
(fleet wall time — shards run in parallel, so the diurnal clock advances
by the slowest shard's modeled time per quantum, not the sum), aggregated
through ``FleetMeterView`` so the fleet totals are by construction the
exact sum of the per-shard attribution.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Sequence, Union

from repro_torch.core.carbon import DEFAULT_LIFETIME_YEARS
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.impacts import MultiImpactBreakdown, ZoneFactors, price_energy, zone_of
from repro_torch.core.intensity import Region, ci_at_hour, get_region


@dataclasses.dataclass
class PhaseStats:
    """Accumulated ledger of one phase: the paper's J + gCO2eq plus the
    multi-criteria impacts (water L / primary MJ / ADPe mg Sb-eq) priced
    by :mod:`repro_torch.core.impacts`. Each criterion is an op+embodied total;
    docs/METHODOLOGY.md#the-impact-ledger defines every column."""

    steps: int = 0
    tokens: float = 0.0
    time_s: float = 0.0
    energy_j: float = 0.0
    operational_g: float = 0.0
    embodied_g: float = 0.0
    water_l: float = 0.0
    primary_mj: float = 0.0
    adpe_mg: float = 0.0

    @property
    def total_g(self) -> float:
        return self.operational_g + self.embodied_g

    @property
    def j_per_token(self) -> float:
        return self.energy_j / max(self.tokens, 1e-12)

    @property
    def g_per_token(self) -> float:
        return self.total_g / max(self.tokens, 1e-12)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.time_s, 1e-12)

    @property
    def water_per_token(self) -> float:
        return self.water_l / max(self.tokens, 1e-12)

    def add(self, other: "PhaseStats") -> "PhaseStats":
        self.steps += other.steps
        self.tokens += other.tokens
        self.time_s += other.time_s
        self.energy_j += other.energy_j
        self.operational_g += other.operational_g
        self.embodied_g += other.embodied_g
        self.water_l += other.water_l
        self.primary_mj += other.primary_mj
        self.adpe_mg += other.adpe_mg
        return self


@dataclasses.dataclass
class SharedClock:
    """Mutable virtual-hours clock shared by several CarbonMeters — a
    fleet of shard meters advances ONE clock (fleet wall time) instead of
    each meter privately summing its own device time."""

    hours: float = 0.0


class CarbonMeter:
    """Accumulates per-phase energy/carbon for one device (group)."""

    def __init__(self, profile: HardwareProfile, region: Union[str, Region],
                 lifetime_years: float = DEFAULT_LIFETIME_YEARS,
                 n_devices: int = 1, use_diurnal_ci: bool = False,
                 clock: Optional[SharedClock] = None,
                 advances_clock: bool = True,
                 zone: Optional[ZoneFactors] = None):
        self.profile = profile
        self.region = get_region(region) if isinstance(region, str) else region
        self.lifetime_years = lifetime_years
        self.n_devices = n_devices
        self.use_diurnal_ci = use_diurnal_ci
        # electricity-mix zone for the water / primary-energy / ADPe legs;
        # resolved from the region name by default. ZoneFactors.zero()
        # degrades the ledger to the pre-PR gCO2+J meter bit for bit —
        # carbon is priced by core.carbon regardless of the zone.
        self.zone = zone if zone is not None else zone_of(self.region)
        self.phases: Dict[str, PhaseStats] = defaultdict(PhaseStats)
        # wall clock for diurnal CI: private by default; a fleet passes one
        # SharedClock to every shard meter (and advances it ITSELF, once
        # per quantum, with advances_clock=False here — S parallel shards
        # recording the same quantum must not advance the day S times)
        self._clock = clock if clock is not None else SharedClock()
        self.advances_clock = advances_clock

    @property
    def clock_hours(self) -> float:
        return self._clock.hours

    @clock_hours.setter
    def clock_hours(self, hours: float) -> None:
        self._clock.hours = hours

    def record(self, phase: str, tokens: float, time_s: float,
               energy_j: float) -> MultiImpactBreakdown:
        if time_s < 0 or energy_j < 0 or tokens < 0:
            raise ValueError("meter inputs must be non-negative")
        region = self.region
        if self.use_diurnal_ci:
            ci = ci_at_hour(self.region, self.clock_hours % 24.0)
            region = dataclasses.replace(self.region, ci_g_per_kwh=ci)
        # carbon leg unchanged (price_energy delegates to total_carbon with
        # these exact arguments); the zone adds water / primary / ADPe
        mi = price_energy(self.profile, energy_j, time_s, region,
                          zone=self.zone, lifetime_years=self.lifetime_years,
                          tokens=tokens, n_devices=self.n_devices)
        st = self.phases[phase]
        st.steps += 1
        st.tokens += tokens
        st.time_s += time_s
        st.energy_j += energy_j
        st.operational_g += mi.operational_g
        st.embodied_g += mi.embodied_g
        st.water_l += mi.water_l
        st.primary_mj += mi.primary_mj
        st.adpe_mg += mi.adpe_mg
        if self.advances_clock:
            self._clock.hours += time_s / 3600.0
        return mi

    def phase(self, name: str) -> PhaseStats:
        return self.phases[name]

    @property
    def totals(self) -> PhaseStats:
        t = PhaseStats()
        for st in self.phases.values():
            t.add(st)
        return t

    def report(self) -> str:
        lines = [
            f"CarbonMeter[{self.profile.name} x{self.n_devices} @ "
            f"{self.region.name} (CI={self.region.ci_g_per_kwh:g} g/kWh), "
            f"LT={self.lifetime_years:g}y]"
        ]
        rows = list(self.phases.items()) + [("TOTAL", self.totals)]
        for name, st in rows:
            if st.steps == 0 and name != "TOTAL":
                continue
            lines.append(
                f"  {name:<10} steps={st.steps:<6} tokens={st.tokens:<10.0f}"
                f" t={st.time_s:9.3f}s  E={st.energy_j:10.1f}J"
                f"  op={st.operational_g:9.4f}g  em={st.embodied_g:9.5f}g"
                f"  g/tok={st.g_per_token:.3e}  J/tok={st.j_per_token:.3e}"
                f"  H2O={st.water_l:.3e}L  PE={st.primary_mj:.3e}MJ"
                f"  ADPe={st.adpe_mg:.3e}mg"
            )
        return "\n".join(lines)


class FleetMeterView:
    """Read-only aggregate over per-shard CarbonMeters.

    Exposes the same ``totals``/``phase``/``phases``/``report`` surface as
    one CarbonMeter, computed by summing the shard meters — so fleet-level
    accounting (carbon budgets, stats, benches) IS the sum of the
    per-shard attribution, with no second ledger that could drift.

    Degraded fleets (shard loss): ``set_live(live)`` marks which shards
    are serving. History is never rewritten — sums still cover every
    meter — but the fleet's EMBODIED rent re-denominates onto the live
    devices: the hardware was provisioned and keeps depreciating whether
    or not one device is down, so each live meter's ``n_devices`` scales
    by fleet_devices / live_devices and the per-token embodied cost of
    the survivors' work honestly carries the dead device's rent (paper
    Eq. 2-4: embodied g amortizes over the work the fleet actually
    serves). Rejoin restores the base denomination exactly."""

    def __init__(self, meters: Sequence[CarbonMeter]):
        if not meters:
            raise ValueError("FleetMeterView needs at least one meter")
        self.meters = list(meters)
        self._base_devices = [m.n_devices for m in self.meters]
        self._live = list(range(len(self.meters)))

    @property
    def live(self) -> list:
        return list(self._live)

    @property
    def n_live(self) -> int:
        return len(self._live)

    def set_live(self, live: Sequence[int]) -> None:
        """Mark ``live`` (shard indices) as the serving set and
        re-denominate embodied rent over them."""
        live = sorted(set(live))
        if not live:
            raise ValueError("a fleet needs at least one live shard")
        if live[0] < 0 or live[-1] >= len(self.meters):
            raise ValueError(f"live shards {live} out of range")
        self._live = live
        fleet = sum(self._base_devices)
        alive = sum(self._base_devices[i] for i in live)
        for i, m in enumerate(self.meters):
            if i in live:
                m.n_devices = self._base_devices[i] * fleet / alive
            else:
                m.n_devices = self._base_devices[i]   # records nothing

    @property
    def phases(self) -> Dict[str, PhaseStats]:
        out: Dict[str, PhaseStats] = {}
        for m in self.meters:
            for name, st in m.phases.items():
                out.setdefault(name, PhaseStats()).add(st)
        return out

    def phase(self, name: str) -> PhaseStats:
        return self.phases.get(name, PhaseStats())

    @property
    def totals(self) -> PhaseStats:
        t = PhaseStats()
        for m in self.meters:
            t.add(m.totals)
        return t

    @property
    def clock_hours(self) -> float:
        return self.meters[0].clock_hours

    def report(self) -> str:
        return "\n".join(m.report() for m in self.meters)
