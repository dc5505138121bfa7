"""Calibration of the GPU performance/energy model against the paper.

The paper reports ~15 quantitative observations about RTX6000 Ada vs T4
(latency ratios, energy ratios, throughput-peak batch sizes, ...). The
analytical model in :mod:`repro_torch.core.energy` has a handful of free
parameters per device (overhead, idle power, power exponent, efficiency
factors, SM-saturation, KV-read inefficiency, thrash knee/slope). This
module defines the anchor set and a scoring function, plus a random-search
fitter used offline to pick the constants frozen in
:mod:`repro_torch.core.hardware`.

Anchor provenance (all from the paper):
  §2.2 / Fig.1: T4/Ada batch-1 prompt-latency ratios 1.1x/1.4x/2.2x for
     1B/3B/7B; 11.4x at 7B batch 4; T4 energy 28%/20% lower at batch 1 for
     1B/7B.
  §2.3 / Fig.2: prefill throughput peaks at batch 8 (T4) / 32 (Ada);
     per-token energy best at batch 8 (T4) / 16 (Ada).
  §2.3 / Fig.3: decode batch 1: T4 27.1% less energy, 9.5% lower
     throughput; Ada up to 5.4x throughput (batch 64) and 57.5% lower
     J/token (batch 16).

The fit will not (and need not) drive every residual to zero — the paper's
measurements fold in HF-runtime effects a roofline model cannot represent.
EXPERIMENTS.md §Paper-validation reports each residual.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core import energy
from repro_torch.core.energy import (LLAMA_1B, LLAMA_3B, LLAMA_7B,
                                     decode_report, prefill_report,
                                     prompt_report)
from repro_torch.core.hardware import RTX6000ADA, T4, HardwareProfile

BATCHES = (1, 2, 4, 8, 16, 32, 64)


@dataclasses.dataclass
class Anchor:
    name: str
    target: float
    fn: Callable[[HardwareProfile, HardwareProfile], float]
    kind: str = "ratio"        # "ratio" (log error) | "batch" (log2 distance)
    weight: float = 1.0


def _peak_batch(profile, w, metric):
    vals = {}
    for b in BATCHES:
        r = prefill_report(profile, w, b)
        if math.isinf(r.t_total):
            continue
        vals[b] = r.tokens_per_s if metric == "tput" else -r.j_per_token
    return max(vals, key=vals.get)


def anchors() -> List[Anchor]:
    A: List[Anchor] = []

    def lat_ratio(w):
        return lambda t4, ada: (prompt_report(t4, w, 1).t_total /
                                prompt_report(ada, w, 1).t_total)

    A.append(Anchor("lat_b1_1b", 1.1, lat_ratio(LLAMA_1B)))
    A.append(Anchor("lat_b1_3b", 1.4, lat_ratio(LLAMA_3B)))
    A.append(Anchor("lat_b1_7b", 2.2, lat_ratio(LLAMA_7B)))
    A.append(Anchor(
        "lat_b4_7b", 11.4,
        lambda t4, ada: (prompt_report(t4, LLAMA_7B, 4).t_total /
                         prompt_report(ada, LLAMA_7B, 4).t_total),
        weight=0.7))
    A.append(Anchor(
        "energy_b1_1b", 0.72,
        lambda t4, ada: (prompt_report(t4, LLAMA_1B, 1).energy_j /
                         prompt_report(ada, LLAMA_1B, 1).energy_j)))
    A.append(Anchor(
        "energy_b1_7b", 0.80,
        lambda t4, ada: (prompt_report(t4, LLAMA_7B, 1).energy_j /
                         prompt_report(ada, LLAMA_7B, 1).energy_j)))
    A.append(Anchor(
        "decode_b1_tput", 0.905,
        lambda t4, ada: (decode_report(t4, LLAMA_1B, 1).tokens_per_s /
                         decode_report(ada, LLAMA_1B, 1).tokens_per_s)))
    A.append(Anchor(
        "decode_b1_energy", 0.729,
        lambda t4, ada: (decode_report(t4, LLAMA_1B, 1).j_per_token /
                         decode_report(ada, LLAMA_1B, 1).j_per_token)))
    A.append(Anchor(
        "decode_b64_tput", 5.4,
        lambda t4, ada: (decode_report(ada, LLAMA_1B, 64).tokens_per_s /
                         decode_report(t4, LLAMA_1B, 64).tokens_per_s),
        weight=0.7))
    A.append(Anchor(
        "decode_b16_energy", 0.425,
        lambda t4, ada: (decode_report(ada, LLAMA_1B, 16).j_per_token /
                         decode_report(t4, LLAMA_1B, 16).j_per_token),
        weight=0.7))
    A.append(Anchor(
        "prefill_peak_t4", 8,
        lambda t4, ada: _peak_batch(t4, LLAMA_1B, "tput"), kind="batch"))
    A.append(Anchor(
        "prefill_peak_ada", 32,
        lambda t4, ada: _peak_batch(ada, LLAMA_1B, "tput"), kind="batch"))
    A.append(Anchor(
        "prefill_energy_t4", 8,
        lambda t4, ada: _peak_batch(t4, LLAMA_1B, "energy"), kind="batch"))
    A.append(Anchor(
        "prefill_energy_ada", 16,
        lambda t4, ada: _peak_batch(ada, LLAMA_1B, "energy"), kind="batch"))
    return A


def score(t4: HardwareProfile, ada: HardwareProfile,
          verbose: bool = False) -> Tuple[float, Dict[str, Tuple[float, float]]]:
    total = 0.0
    detail: Dict[str, Tuple[float, float]] = {}
    for a in anchors():
        try:
            got = a.fn(t4, ada)
        except (ZeroDivisionError, OverflowError):
            got = math.inf
        if a.kind == "batch":
            err = abs(math.log2(max(got, 1e-9)) - math.log2(a.target))
        else:
            if not math.isfinite(got) or got <= 0:
                err = 10.0
            else:
                err = abs(math.log(got / a.target))
        total += a.weight * err ** 2
        detail[a.name] = (a.target, got)
        if verbose:
            print(f"  {a.name:<22} target={a.target:<8g} got={got:<10.4g} "
                  f"err={err:.3f}")
    return total, detail


# Search space: (field, low, high, log?)
SPACE_T4 = [
    ("step_overhead_s", 1e-3, 15e-3, True),
    ("idle_w", 8.0, 40.0, False),
    ("power_alpha", 0.3, 2.0, False),
    ("eff_compute", 0.15, 0.6, False),
    ("eff_memory", 0.55, 0.95, False),
    ("sm_saturation_tokens", 40.0, 4000.0, True),
    ("kv_read_inefficiency", 1.0, 14.0, False),
    ("thrash_knee", 0.80, 0.95, False),
    ("thrash_slope", 50.0, 1500.0, True),
]
SPACE_ADA = [
    ("step_overhead_s", 4e-3, 25e-3, True),
    ("idle_w", 12.0, 70.0, False),
    ("power_alpha", 0.3, 1.4, False),
    ("eff_compute", 0.3, 0.65, False),
    ("eff_memory", 0.55, 0.9, False),
    ("sm_saturation_tokens", 300.0, 9000.0, True),
    ("kv_read_inefficiency", 1.0, 2.5, False),
]
SPACE_ADA[2] = ("power_alpha", 0.3, 2.2, False)
SPACE_ADA[3] = ("eff_compute", 0.3, 0.75, False)


def _sample(rng, space, base):
    kw = {}
    for field, lo, hi, is_log in space:
        if is_log:
            v = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        else:
            v = rng.uniform(lo, hi)
        kw[field] = v
    return dataclasses.replace(base, **kw)


def _perturb(rng, prof, space, scale):
    kw = {}
    for field, lo, hi, is_log in space:
        v = getattr(prof, field)
        if is_log:
            v = math.exp(math.log(v) + rng.normal(0, scale))
        else:
            v = v + rng.normal(0, scale * (hi - lo))
        kw[field] = min(max(v, lo), hi)
    return dataclasses.replace(prof, **kw)


def fit(n_random: int = 4000, n_refine: int = 3000, seed: int = 0,
        verbose: bool = True):
    """Random search + local refinement. Returns (t4, ada, score)."""
    rng = np.random.default_rng(seed)
    best = (T4, RTX6000ADA)
    best_s, _ = score(*best)
    for i in range(n_random):
        cand = (_sample(rng, SPACE_T4, T4), _sample(rng, SPACE_ADA, RTX6000ADA))
        s, _ = score(*cand)
        if s < best_s:
            best, best_s = cand, s
            if verbose:
                print(f"[random {i}] score={s:.4f}")
    for i in range(n_refine):
        scale = 0.25 * (1.0 - i / n_refine) + 0.02
        cand = (_perturb(rng, best[0], SPACE_T4, scale),
                _perturb(rng, best[1], SPACE_ADA, scale))
        s, _ = score(*cand)
        if s < best_s:
            best, best_s = cand, s
            if verbose:
                print(f"[refine {i}] score={s:.4f}")
    return best[0], best[1], best_s


# ---------------------------------------------------------------------------
# Measured-power-trace calibration
# ---------------------------------------------------------------------------
#
# The anchor fit above pins the model to the PAPER's published ratios; the
# trace fit below pins it to a MEASURED power log from a deployment you
# actually run (docs/METHODOLOGY.md#measured-power). Input is the pair
# (PowerTrace, labeled segments) that repro_torch.core.power_trace produces —
# from a DCGM/NVML CSV + request log in production, or from
# synthesize_trace in tests — and the fit adjusts only the power-path
# knobs of the profile so the model's per-phase Wh and durations match
# the trapezoidal integrals of the trace.

from repro_torch.core.power_trace import PowerTrace  # noqa: E402

# Power-path knobs only: the roofline/capacity constants (flops, bandwidth,
# memory) are physics/spec sheet, not free parameters of a power fit.
POWER_TRACE_SPACE = [
    ("idle_w", 5.0, 120.0, False),
    ("power_alpha", 0.2, 2.5, False),
    ("eff_compute", 0.1, 0.9, False),
    ("eff_memory", 0.3, 0.98, False),
    ("step_overhead_s", 5e-4, 5e-2, True),
]


@dataclasses.dataclass(frozen=True)
class PhaseResidual:
    """Measured-vs-modeled for one phase of the trace."""

    phase: str
    measured_wh: float
    modeled_wh: float
    measured_s: float
    modeled_s: float

    @property
    def energy_error_frac(self) -> float:
        return (self.modeled_wh - self.measured_wh) / max(self.measured_wh,
                                                          1e-12)

    @property
    def time_error_frac(self) -> float:
        return (self.modeled_s - self.measured_s) / max(self.measured_s,
                                                        1e-12)


@dataclasses.dataclass(frozen=True)
class TraceCalibration:
    """Result of :func:`fit_power_trace`."""

    profile: HardwareProfile
    loss: float
    measured_wh: float
    modeled_wh: float
    residuals: Tuple[PhaseResidual, ...]

    @property
    def energy_error_frac(self) -> float:
        """Signed total-energy error of the fitted model vs the trace."""
        return (self.modeled_wh - self.measured_wh) / max(self.measured_wh,
                                                          1e-12)

    def report(self) -> str:
        lines = [f"TraceCalibration[{self.profile.name}] "
                 f"loss={self.loss:.4f} total "
                 f"measured={self.measured_wh:.4f}Wh "
                 f"modeled={self.modeled_wh:.4f}Wh "
                 f"({self.energy_error_frac:+.2%})"]
        for r in self.residuals:
            lines.append(
                f"  {r.phase:<10} Wh {r.measured_wh:.4f} -> {r.modeled_wh:.4f}"
                f" ({r.energy_error_frac:+.2%})   "
                f"t {r.measured_s:.3f}s -> {r.modeled_s:.3f}s"
                f" ({r.time_error_frac:+.2%})")
        return "\n".join(lines)


def _phase_residuals(profile: HardwareProfile, trace: PowerTrace,
                     segments) -> List[PhaseResidual]:
    by_phase: Dict[str, List[float]] = {}
    order: List[str] = []
    for seg in segments:
        rep = energy.step_energy(profile, seg.counts)
        modeled_wh = (0.0 if math.isinf(rep.energy_j)
                      else rep.energy_wh * seg.n_steps)
        modeled_s = (math.inf if math.isinf(rep.t_total)
                     else rep.t_total * seg.n_steps)
        acc = by_phase.setdefault(seg.phase, [0.0, 0.0, 0.0, 0.0])
        if seg.phase not in order:
            order.append(seg.phase)
        acc[0] += trace.energy_wh(seg.window)
        acc[1] += modeled_wh
        acc[2] += seg.duration_s
        acc[3] += modeled_s
    return [PhaseResidual(p, *by_phase[p]) for p in order]


def trace_loss(profile: HardwareProfile, trace: PowerTrace,
               segments) -> float:
    """Sum of squared log-errors of per-phase Wh and duration. Energy and
    time are both scored so power knobs (idle_w, power_alpha) and speed
    knobs (eff_*, overhead) are separately identified."""
    loss = 0.0
    for r in _phase_residuals(profile, trace, segments):
        for meas, model in ((r.measured_wh, r.modeled_wh),
                            (r.measured_s, r.modeled_s)):
            if meas <= 0:
                continue
            if not math.isfinite(model) or model <= 0:
                loss += 100.0
            else:
                loss += math.log(model / meas) ** 2
    return loss


def fit_power_trace(trace: PowerTrace, segments,
                    base: HardwareProfile,
                    space=POWER_TRACE_SPACE,
                    n_random: int = 400, n_refine: int = 400,
                    seed: int = 0) -> TraceCalibration:
    """Fit ``base``'s power/efficiency knobs to a measured trace.

    ``segments`` are :class:`repro_torch.core.power_trace.LabeledSegment`s — the
    request-log alignment that says which (phase, StepCounts, window) each
    stretch of the trace corresponds to. Same random-search + refinement
    scheme as the paper-anchor :func:`fit`, over the power-path knobs
    only (:data:`POWER_TRACE_SPACE`).
    """
    if not segments:
        raise ValueError("fit_power_trace needs at least one labeled segment")
    rng = np.random.default_rng(seed)
    best = base
    best_s = trace_loss(best, trace, segments)
    for _ in range(n_random):
        cand = _sample(rng, space, base)
        s = trace_loss(cand, trace, segments)
        if s < best_s:
            best, best_s = cand, s
    for i in range(n_refine):
        scale = 0.25 * (1.0 - i / max(n_refine, 1)) + 0.02
        cand = _perturb(rng, best, space, scale)
        s = trace_loss(cand, trace, segments)
        if s < best_s:
            best, best_s = cand, s
    residuals = tuple(_phase_residuals(best, trace, segments))
    measured = sum(r.measured_wh for r in residuals)
    modeled = sum(r.modeled_wh for r in residuals)
    return TraceCalibration(profile=best, loss=best_s,
                            measured_wh=measured, modeled_wh=modeled,
                            residuals=residuals)


if __name__ == "__main__":
    t4, ada, s = fit()
    print(f"\nfinal score {s:.4f}")
    score(t4, ada, verbose=True)
    for p, space in ((t4, SPACE_T4), (ada, SPACE_ADA)):
        print(f"\n{p.name}:")
        for field, *_ in space:
            print(f"  {field} = {getattr(p, field):.6g}")
