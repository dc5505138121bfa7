"""Day-ahead carbon-intensity forecasting (paper §4: "CI predictions
[18, 19] can work collaboratively with the CI-directed scheduling strategy
to make early scheduling decisions").

A deliberately small forecaster in the spirit of DACF/CarbonCast's
first-order components: harmonic regression (daily + half-daily sinusoids)
fit by least squares on a trailing history window, plus a persistence
blend. Enough to let the scheduler commit workloads to tomorrow's low-CI
windows; accuracy is characterized in tests on synthetic traces with noise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CIForecaster:
    """Fit on hourly CI history; predict any future hour."""

    periods: Sequence[float] = (24.0, 12.0)
    blend_persistence: float = 0.2       # weight on same-hour-yesterday

    def fit(self, hours: np.ndarray, ci: np.ndarray) -> "CIForecaster":
        hours = np.asarray(hours, dtype=np.float64)
        ci = np.asarray(ci, dtype=np.float64)
        cols = [np.ones_like(hours)]
        for p in self.periods:
            w = 2 * np.pi / p
            cols += [np.cos(w * hours), np.sin(w * hours)]
        X = np.stack(cols, axis=1)
        self._coef, *_ = np.linalg.lstsq(X, ci, rcond=None)
        self._last_day = {}
        for h, c in zip(hours[-24:], ci[-24:]):
            self._last_day[int(h) % 24] = c
        return self

    def _harmonic(self, hours: np.ndarray) -> np.ndarray:
        cols = [np.ones_like(hours)]
        for p in self.periods:
            w = 2 * np.pi / p
            cols += [np.cos(w * hours), np.sin(w * hours)]
        return np.stack(cols, axis=1) @ self._coef

    def predict(self, hours) -> np.ndarray:
        hours = np.atleast_1d(np.asarray(hours, dtype=np.float64))
        harm = self._harmonic(hours)
        pers = np.array([self._last_day.get(int(h) % 24, harm[i])
                         for i, h in enumerate(hours)])
        a = self.blend_persistence
        return (1 - a) * harm + a * pers

    def greenest_window(self, start_hour: float, horizon_h: int = 24,
                        duration_h: int = 1) -> tuple:
        """(best_start_hour, mean_ci) for a duration-long job in the next
        horizon — the paper's 'training has no deadline' scheduling move."""
        hours = np.arange(start_hour, start_hour + horizon_h, 1.0)
        pred = self.predict(hours)
        best_i, best_ci = 0, np.inf
        for i in range(0, horizon_h - duration_h + 1):
            m = float(np.mean(pred[i:i + duration_h]))
            if m < best_ci:
                best_i, best_ci = i, m
        return float(hours[best_i]), best_ci


def mape(pred: np.ndarray, true: np.ndarray) -> float:
    pred, true = np.asarray(pred), np.asarray(true)
    return float(np.mean(np.abs(pred - true) / np.maximum(np.abs(true), 1e-9)))
