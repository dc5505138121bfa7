"""Measured-power trace ingestion (the kserve-vllm-mini energy method).

The analytical model in :mod:`repro_torch.core.energy` *models* joules; a real
deployment has a power sampler (NVML / DCGM / a PDU) emitting
``(timestamp, watts)`` rows. This module turns such a trace into
defensible energy numbers using the method documented in
``docs/METHODOLOGY.md#measured-power``:

* **active window** — derived from the request log as
  ``[min(start), max(start + latency)]`` so warm-up and cool-down never
  count (:class:`ActiveWindow`);
* **trapezoidal integration** — ``Wh = sum (P[i]+P[i+1])/2 * dt_h`` over
  the samples inside the window; fewer than two in-window samples yield
  0.0, never an extrapolation;
* **idle tax** (optional) — either integrate the outside-window samples
  (``series``) or charge the outside duration at the median
  outside-window power (``baseline``);
* **normalization** — Wh per successful request and per 1k tokens.

:func:`synthesize_trace` runs the pipeline in reverse — it lays
phase-labeled segments of the *analytical* model end to end and samples
their power — which is what lets ``repro_torch.core.calibrate.fit_power_trace``
close the loop: fit the model's power/efficiency knobs against a trace and
report per-phase residuals, turning modeled J into auditable J.
"""
from __future__ import annotations

import bisect
import csv
import dataclasses
import io
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.energy import StepCounts, step_energy
from repro_torch.core.hardware import HardwareProfile

# column-name fallbacks, mirroring the DCGM/NVML exporters in the wild
_TIME_COLS = ("t_s", "ts_s", "timestamp_s", "time_s")
_POWER_COLS = ("watts", "power_w", "power_W", "w")


@dataclasses.dataclass(frozen=True)
class ActiveWindow:
    """The integration window ``[t0, t1]`` in trace time (seconds)."""

    t0: float
    t1: float

    def __post_init__(self):
        if not (self.t1 >= self.t0):
            raise ValueError(f"window end {self.t1} before start {self.t0}")

    @staticmethod
    def from_requests(starts_s: Sequence[float],
                      latencies_s: Sequence[float]) -> "ActiveWindow":
        """kserve method: t0 = min(start), t1 = max(start + latency)."""
        if not starts_s or len(starts_s) != len(latencies_s):
            raise ValueError("need matching non-empty starts and latencies")
        return ActiveWindow(min(starts_s),
                            max(s + l for s, l in zip(starts_s, latencies_s)))

    def contains(self, t: float) -> bool:
        return self.t0 <= t <= self.t1


class PowerTrace:
    """An immutable, time-sorted sequence of (t_s, watts) samples."""

    def __init__(self, t_s: Sequence[float], watts: Sequence[float]):
        if len(t_s) != len(watts):
            raise ValueError("t_s and watts must have equal length")
        for a, b in zip(t_s, t_s[1:]):
            if b <= a:
                raise ValueError("sample timestamps must strictly increase")
        for w in watts:
            if w < 0 or not math.isfinite(w):
                raise ValueError("power samples must be finite and >= 0")
        self.t_s: Tuple[float, ...] = tuple(float(t) for t in t_s)
        self.watts: Tuple[float, ...] = tuple(float(w) for w in watts)

    def __len__(self) -> int:
        return len(self.t_s)

    @property
    def span(self) -> Optional[ActiveWindow]:
        if not self.t_s:
            return None
        return ActiveWindow(self.t_s[0], self.t_s[-1])

    # ------------------------------------------------------------------ io
    @classmethod
    def from_csv(cls, source: Union[str, Path, io.TextIOBase]) -> "PowerTrace":
        """Read ``t_s,watts`` rows (header required; common alternative
        column names from DCGM/NVML logs are accepted). Rows with missing
        or unparsable values are ignored, per the kserve method."""
        if isinstance(source, (str, Path)):
            with open(source, newline="") as f:
                return cls.from_csv(f)
        reader = csv.DictReader(source)
        if reader.fieldnames is None:
            raise ValueError("power CSV has no header row")
        tcol = next((c for c in _TIME_COLS if c in reader.fieldnames), None)
        pcol = next((c for c in _POWER_COLS if c in reader.fieldnames), None)
        if tcol is None or pcol is None:
            raise ValueError(
                f"power CSV needs a time column ({'/'.join(_TIME_COLS)}) and "
                f"a power column ({'/'.join(_POWER_COLS)}); got "
                f"{reader.fieldnames}")
        ts: List[float] = []
        ws: List[float] = []
        for row in reader:
            try:
                t, w = float(row[tcol]), float(row[pcol])
            except (TypeError, ValueError, KeyError):
                continue                      # missing samples are ignored
            ts.append(t)
            ws.append(w)
        return cls(ts, ws)

    def to_csv(self, path: Union[str, Path]) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["t_s", "watts"])
            for t, p in zip(self.t_s, self.watts):
                w.writerow([f"{t:.6f}", f"{p:.6f}"])

    # --------------------------------------------------------- integration
    def _window_slice(self, window: Optional[ActiveWindow]) -> Tuple[int, int]:
        if window is None:
            return 0, len(self.t_s)
        lo = bisect.bisect_left(self.t_s, window.t0)
        hi = bisect.bisect_right(self.t_s, window.t1)
        return lo, hi

    def energy_wh(self, window: Optional[ActiveWindow] = None) -> float:
        """Trapezoidal Wh over the samples inside ``window`` (whole trace
        when None). Fewer than two in-window samples integrate to 0.0 —
        the method never extrapolates a single reading into energy."""
        lo, hi = self._window_slice(window)
        if hi - lo < 2:
            return 0.0
        wh = 0.0
        for i in range(lo, hi - 1):
            dt_h = (self.t_s[i + 1] - self.t_s[i]) / 3600.0
            wh += (self.watts[i] + self.watts[i + 1]) / 2.0 * dt_h
        return wh

    def energy_j(self, window: Optional[ActiveWindow] = None) -> float:
        return self.energy_wh(window) * 3600.0

    def baseline_w(self, window: ActiveWindow) -> float:
        """Median power of the samples OUTSIDE the window (the idle
        baseline estimate of the kserve ``baseline`` mode)."""
        lo, hi = self._window_slice(window)
        outside = sorted(self.watts[:lo] + self.watts[hi:])
        if not outside:
            return 0.0
        n = len(outside)
        mid = n // 2
        return (outside[mid] if n % 2
                else (outside[mid - 1] + outside[mid]) / 2.0)

    def idle_tax_wh(self, window: ActiveWindow, mode: str = "series") -> float:
        """Energy charged OUTSIDE the active window.

        ``series``: trapezoidal integration of the outside segments.
        ``baseline``: median outside power x outside duration.
        """
        if mode not in ("series", "baseline"):
            raise ValueError(f"unknown idle-tax mode {mode!r}")
        if not self.t_s:
            return 0.0
        if mode == "series":
            before = ActiveWindow(self.t_s[0], min(window.t0, self.t_s[-1])) \
                if self.t_s[0] < window.t0 else None
            after = ActiveWindow(max(window.t1, self.t_s[0]), self.t_s[-1]) \
                if self.t_s[-1] > window.t1 else None
            return sum(self.energy_wh(w) for w in (before, after)
                       if w is not None)
        lo, hi = self._window_slice(window)
        outside_s = (max(window.t0 - self.t_s[0], 0.0)
                     + max(self.t_s[-1] - window.t1, 0.0))
        del lo, hi
        return self.baseline_w(window) * outside_s / 3600.0


def normalized(wh_active: float, n_requests: int,
               total_tokens: Optional[float]) -> Dict[str, Optional[float]]:
    """Per-request / per-1k-token normalization (kserve output schema).
    Missing token counts yield ``None`` for the per-1k value, never 0."""
    if n_requests < 0:
        raise ValueError("n_requests must be >= 0")
    per_req = wh_active / n_requests if n_requests else None
    per_1k = (wh_active / total_tokens * 1000.0
              if total_tokens else None)
    return {"wh_per_request_active": per_req,
            "wh_per_1k_tokens_active": per_1k}


# ---------------------------------------------------------------------------
# Synthetic traces from the analytical model (the calibration loop's input)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """``n_steps`` identical engine steps of one phase: the per-step
    demand is ``counts``; duration and power come from the profile being
    synthesized (``step_energy``)."""

    phase: str
    counts: StepCounts
    n_steps: int = 1

    def __post_init__(self):
        if self.n_steps < 1:
            raise ValueError("n_steps must be >= 1")


@dataclasses.dataclass(frozen=True)
class LabeledSegment:
    """One request-aligned window of a trace with KNOWN workload: the
    ground truth a calibration consumes (phase label + per-step counts +
    the wall window the steps occupied)."""

    phase: str
    t0: float
    t1: float
    counts: StepCounts             # per-step demand
    n_steps: int

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    @property
    def window(self) -> ActiveWindow:
        return ActiveWindow(self.t0, self.t1)


def synthesize_trace(
    profile: HardwareProfile,
    plan: Sequence[SegmentPlan],
    interval_s: float = 0.25,
    pad_s: float = 5.0,
    noise_frac: float = 0.0,
    rng=None,
) -> Tuple[PowerTrace, List[LabeledSegment]]:
    """Sample the power a device running ``plan`` would draw.

    Segments run back to back after ``pad_s`` of idle, with ``pad_s`` of
    idle cool-down at the end (so active-window alignment and the idle
    tax are exercised, not just integration). Power is the model's
    average step power inside a segment and ``profile.idle_w`` outside;
    ``noise_frac`` adds multiplicative Gaussian sampling noise.

    Returns the sampled trace plus the ground-truth labeled segments.
    A real deployment produces the same pair from its DCGM log +
    request log; everything downstream (integration, calibration) is
    source-agnostic.
    """
    if interval_s <= 0:
        raise ValueError("interval_s must be > 0")
    if pad_s < 0:
        raise ValueError("pad_s must be >= 0")
    segments: List[LabeledSegment] = []
    t = pad_s
    for sp in plan:
        rep = step_energy(profile, sp.counts)
        if math.isinf(rep.t_total):
            raise ValueError(
                f"segment {sp.phase!r} OOMs on {profile.name}; a trace "
                "cannot be synthesized for an infeasible workload")
        dur = rep.t_total * sp.n_steps
        segments.append(LabeledSegment(sp.phase, t, t + dur, sp.counts,
                                       sp.n_steps))
        t += dur
    end = t + pad_s

    def power_at(ti: float) -> float:
        for seg in segments:
            if seg.t0 <= ti < seg.t1:
                return step_energy(profile, seg.counts).power_w
        return profile.idle_w

    ts: List[float] = []
    ws: List[float] = []
    n = int(end / interval_s) + 1
    for i in range(n + 1):
        ti = i * interval_s
        w = power_at(ti)
        if noise_frac > 0.0:
            if rng is None:
                raise ValueError("noise_frac > 0 requires an rng")
            w = max(0.0, w * (1.0 + noise_frac * rng.standard_normal()))
        ts.append(ti)
        ws.append(w)
    return PowerTrace(ts, ws), segments
