"""CI-directed, carbon-aware fleet scheduling (paper §4, beyond-paper).

The paper's Takeaways 3–5 say: older GPUs win in low-CI regions, newer in
high-CI regions; best-throughput configs are not best-carbon configs; phase
splitting (SplitWise-style) exposes more optimization room. This module
operationalizes those findings:

* ``carbon_optimal_batch`` — pick the batch size minimizing g/token for a
  (device, region, phase), subject to a latency SLO (Takeaways 2 & 4).
* ``place_request_class`` — pick the (device, region) minimizing per-prompt
  carbon subject to SLO + memory feasibility (Takeaway 3).
* ``plan_disaggregated`` — independent placement of prefill and decode
  phases, possibly on different device generations/regions (Takeaway 2 +
  SplitWise [24], carbon-directed instead of cost-directed).
* ``CIDirectedScheduler`` — time-varying CI: route each request batch to the
  fleet slice whose *current* CI x energy + embodied is lowest.

Degraded fleets: the serving engine's carbon router consumes these
primitives over its *live* shard set only — when a shard is declared
dead, its (device, region) slice simply drops out of the candidate list
and the embodied rent re-denominates over the survivors, so the same
per-prompt accounting holds at any fleet width.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.carbon import (DEFAULT_LIFETIME_YEARS,
                                     amortized_embodied_g,
                                     operational_carbon_g, total_carbon)
from repro_torch.core.energy import (EnergyReport, LLMWorkload,
                                     decode_report, migrate_counts,
                                     prefill_report, prompt_report,
                                     step_energy)
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.intensity import Region, ci_at_hour, get_region


@dataclasses.dataclass(frozen=True)
class FleetSlice:
    """``count`` devices of one type in one grid region."""

    profile: HardwareProfile
    region: Region
    count: int = 1
    lifetime_years: float = DEFAULT_LIFETIME_YEARS

    @property
    def key(self) -> str:
        return f"{self.profile.name}@{self.region.name}"


@dataclasses.dataclass(frozen=True)
class Placement:
    slice_key: str
    batch: int
    phase: str
    latency_s: float
    energy_j: float
    carbon_g: float
    g_per_token: float
    feasible: bool
    reason: str = ""


BATCH_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)


def _phase_report(phase: str, profile: HardwareProfile, w: LLMWorkload,
                  batch: int) -> EnergyReport:
    if phase == "prefill":
        return prefill_report(profile, w, batch)
    if phase == "decode":
        return decode_report(profile, w, batch)
    if phase == "prompt":
        return prompt_report(profile, w, batch)
    raise ValueError(f"unknown phase {phase!r}")


def evaluate(sl: FleetSlice, w: LLMWorkload, phase: str, batch: int,
             slo_s: Optional[float] = None,
             ci_override: Optional[float] = None) -> Placement:
    rep = _phase_report(phase, sl.profile, w, batch)
    region = sl.region
    if ci_override is not None:
        region = dataclasses.replace(region, ci_g_per_kwh=ci_override)
    if math.isinf(rep.t_total):
        return Placement(sl.key, batch, phase, math.inf, math.inf, math.inf,
                         math.inf, False, "oom")
    cb = total_carbon(sl.profile, rep.energy_j, rep.t_total, region,
                      lifetime_years=sl.lifetime_years, tokens=rep.tokens)
    feasible = True
    reason = ""
    if slo_s is not None and rep.t_total > slo_s:
        feasible, reason = False, f"latency {rep.t_total:.3f}s > SLO {slo_s:.3f}s"
    return Placement(sl.key, batch, phase, rep.t_total, rep.energy_j,
                     cb.total_g, cb.g_per_token, feasible, reason)


def marginal_request_g(sl: FleetSlice, w: LLMWorkload, prefill_tokens: float,
                       decode_tokens: float, resv_frac: float,
                       ci: Optional[float] = None,
                       n_devices: int = 1) -> Tuple[float, float]:
    """Marginal gCO2 of serving ONE request on slice ``sl`` — the live
    placement score of the sharded engine's carbon routing.

    Operational: batch-1 per-token J of each phase (the marginal unit of
    work at this slice's profile, via the same ``_phase_report`` that
    backs :func:`evaluate`) × the request's phase mix, priced at the
    CURRENT carbon intensity ``ci`` (default: the region's flat mean).
    ``prefill_tokens`` arrives already discounted by resident-prefix hits
    — adopted pages cost this request nothing to recompute.

    Embodied: Eq. 2-4 amortized over the request's estimated service
    time, scaled by ``resv_frac`` — the fraction of the shard's page pool
    the request would reserve. The request rents its share of the device
    for its service window; prefix hits shrink the reservation and with
    it the rent, which is what steers decode-heavy requests toward
    memory-rich amortized shards (GreenLLM's disaggregation).

    Returns ``(carbon_g, est_time_s)``; ``(inf, inf)`` when either phase
    OOMs the slice."""
    ci_val = sl.region.ci_g_per_kwh if ci is None else ci
    op_g = 0.0
    t_est = 0.0
    for phase, toks in (("prefill", prefill_tokens),
                        ("decode", decode_tokens)):
        if toks <= 0:
            continue
        rep = _phase_report(phase, sl.profile, w, 1)
        if math.isinf(rep.t_total):
            return math.inf, math.inf
        scale = toks / max(rep.tokens, 1e-12)
        op_g += operational_carbon_g(rep.energy_j * scale, ci_val)
        t_est += rep.t_total * scale
    em_g = (n_devices * amortized_embodied_g(sl.profile, t_est,
                                             sl.lifetime_years)
            * max(min(resv_frac, 1.0), 0.0))
    return op_g + em_g, t_est


def migration_cost_g(sl: FleetSlice, w: LLMWorkload, kv_tokens: float,
                     ci: Optional[float] = None) -> Tuple[float, float]:
    """gCO2 of landing ``kv_tokens`` of migrated KV cache on slice ``sl``
    — the destination tie-break of live page migration.

    Operational only: a page copy is a one-shot transfer, not a service
    window, so it rents no embodied share (the migrating request's rent
    moves with its reservation and is already priced by
    :func:`marginal_request_g` at admission). Priced at the CURRENT
    carbon intensity ``ci`` (default: the region's flat mean).

    Returns ``(carbon_g, copy_time_s)``."""
    ci_val = sl.region.ci_g_per_kwh if ci is None else ci
    rep = step_energy(sl.profile, migrate_counts(w, kv_tokens))
    return operational_carbon_g(rep.energy_j, ci_val), rep.t_total


def carbon_optimal_batch(sl: FleetSlice, w: LLMWorkload, phase: str,
                         slo_s: Optional[float] = None,
                         batches: Sequence[int] = BATCH_CANDIDATES
                         ) -> Optional[Placement]:
    """Batch size minimizing g/token under the SLO (Takeaway 4: this is NOT
    the throughput-optimal batch in general)."""
    best = None
    for b in batches:
        p = evaluate(sl, w, phase, b, slo_s=slo_s)
        if not p.feasible:
            continue
        if best is None or p.g_per_token < best.g_per_token:
            best = p
    return best


def throughput_optimal_batch(sl: FleetSlice, w: LLMWorkload, phase: str,
                             batches: Sequence[int] = BATCH_CANDIDATES
                             ) -> Optional[Placement]:
    best, best_tps = None, -1.0
    for b in batches:
        rep = _phase_report(phase, sl.profile, w, b)
        if math.isinf(rep.t_total):
            continue
        if rep.tokens_per_s > best_tps:
            best_tps = rep.tokens_per_s
            best = evaluate(sl, w, phase, b)
    return best


def place_request_class(fleet: Sequence[FleetSlice], w: LLMWorkload,
                        phase: str = "prompt",
                        slo_s: Optional[float] = None,
                        batches: Sequence[int] = BATCH_CANDIDATES
                        ) -> Tuple[Optional[Placement], List[Placement]]:
    """Min-carbon (device, region, batch) for a request class. Returns the
    winner and the full candidate table (for reporting)."""
    table: List[Placement] = []
    for sl in fleet:
        for b in batches:
            table.append(evaluate(sl, w, phase, b, slo_s=slo_s))
    feas = [p for p in table if p.feasible]
    winner = min(feas, key=lambda p: p.g_per_token) if feas else None
    return winner, table


def plan_disaggregated(fleet: Sequence[FleetSlice], w: LLMWorkload,
                       prefill_slo_s: Optional[float] = None,
                       decode_slo_s: Optional[float] = None
                       ) -> Dict[str, Optional[Placement]]:
    """SplitWise-style phase disaggregation, carbon-directed: prefill is
    compute-bound (favors new chips / high-CI tolerance differs), decode is
    memory-bound (old chips often win on g/token at small batch)."""
    pf, _ = place_request_class(fleet, w, "prefill", slo_s=prefill_slo_s)
    dc, _ = place_request_class(fleet, w, "decode", slo_s=decode_slo_s)
    return {"prefill": pf, "decode": dc}


class CIDirectedScheduler:
    """Route request batches across the fleet as grid CI varies over the day.

    ``route(hour)`` returns the fleet slice minimizing *current* total
    carbon per token for the given phase — the paper's §4 "CI-directed LLM
    serving" direction made concrete.
    """

    def __init__(self, fleet: Sequence[FleetSlice], w: LLMWorkload,
                 phase: str = "prompt", batch: int = 8,
                 slo_s: Optional[float] = None):
        if not fleet:
            raise ValueError("fleet must be non-empty")
        self.fleet = list(fleet)
        self.w = w
        self.phase = phase
        self.batch = batch
        self.slo_s = slo_s

    def route(self, hour: float) -> Tuple[FleetSlice, Placement]:
        best: Optional[Tuple[FleetSlice, Placement]] = None
        for sl in self.fleet:
            ci = ci_at_hour(sl.region, hour % 24.0)
            p = evaluate(sl, self.w, self.phase, self.batch,
                         slo_s=self.slo_s, ci_override=ci)
            if not p.feasible:
                continue
            if best is None or p.g_per_token < best[1].g_per_token:
                best = (sl, p)
        if best is None:
            raise RuntimeError("no feasible fleet slice for this request class")
        return best

    def simulate_day(self, requests_per_hour: float = 3600.0,
                     hours: int = 24) -> Dict[str, object]:
        """Simulate a day of routing; returns totals and the hourly choices."""
        total_g = 0.0
        total_j = 0.0
        choices: List[str] = []
        for h in range(hours):
            sl, p = self.route(float(h))
            n_batches = requests_per_hour / max(self.batch, 1)
            total_g += p.carbon_g * n_batches
            total_j += p.energy_j * n_batches
            choices.append(sl.key)
        # counterfactual: pin to each slice all day
        pinned: Dict[str, float] = {}
        for sl in self.fleet:
            g = 0.0
            ok = True
            for h in range(hours):
                ci = ci_at_hour(sl.region, float(h))
                p = evaluate(sl, self.w, self.phase, self.batch,
                             slo_s=self.slo_s, ci_override=ci)
                if not p.feasible:
                    ok = False
                    break
                g += p.carbon_g * requests_per_hour / max(self.batch, 1)
            if ok:
                pinned[sl.key] = g
        return {"total_g": total_g, "total_j": total_j, "choices": choices,
                "pinned_g": pinned}
