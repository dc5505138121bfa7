"""The port's copies of ``core/power_trace.py`` and ``core/calibrate.py``
against the reference's: every case of ``tests/test_power_trace.py`` and
``tests/test_trace_calibration.py`` with its own assertions, run on the
port's modules, and each deterministic result held to the reference's on
the same inputs (to 1e-12 relative). Last, the CSV that ``chip_smoke.py``'s
``nvidia-smi`` sampler writes, read back through ``PowerTrace.from_csv``."""
import dataclasses
import importlib
import importlib.util
import io
import math
import os

import numpy as np
import pytest


class Pkg:
    """One package's power-trace and calibration modules."""

    def __init__(self, root):
        self.energy = importlib.import_module(f"{root}.core.energy")
        self.pt = importlib.import_module(f"{root}.core.power_trace")
        self.cal = importlib.import_module(f"{root}.core.calibrate")
        hw = importlib.import_module(f"{root}.core.hardware")
        self.ada = hw.get_profile("rtx6000ada")
        e = self.energy
        self.plan = [
            self.pt.SegmentPlan("prefill",
                                e.prefill_counts(e.LLAMA_1B, 8, 512), 40),
            self.pt.SegmentPlan("decode",
                                e.decode_counts(e.LLAMA_1B, 8, 600), 2000)]

    def trace(self, noise=0.02, seed=0):
        """``tests/test_trace_calibration.py``'s ``_trace``."""
        return self.pt.synthesize_trace(
            self.ada, self.plan, interval_s=0.05, pad_s=5.0,
            noise_frac=noise, rng=np.random.default_rng(seed))

    def wrong_start(self):
        t = self.ada
        return dataclasses.replace(
            t, idle_w=t.idle_w * 2.0, power_alpha=t.power_alpha * 0.6,
            eff_compute=t.eff_compute * 0.7, eff_memory=t.eff_memory * 0.8)


@pytest.fixture(scope="module")
def T():
    return Pkg("repro_torch")


@pytest.fixture(scope="module")
def J():
    return Pkg("repro")


def close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


def same_trace(a, b):
    """Two (trace, segments) pairs, one from each package, agree."""
    (ta, sa), (tb, sb) = a, b
    assert ta.t_s == tb.t_s
    close(list(ta.watts), list(tb.watts))
    assert [(s.phase, s.n_steps) for s in sa] == \
        [(s.phase, s.n_steps) for s in sb]
    close([(s.t0, s.t1) for s in sa], [(s.t0, s.t1) for s in sb])


def same_profile(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, float):
            close(va, vb)
        else:
            assert va == vb, f.name


# ----------------------------------------------- tests/test_power_trace.py


def test_active_window_from_requests_is_min_start_max_end(T, J):
    args = ([10.0, 12.0, 11.0], [5.0, 1.0, 30.0])
    w = T.pt.ActiveWindow.from_requests(*args)
    assert w.t0 == 10.0
    assert w.t1 == 41.0
    assert w.contains(10.0) and w.contains(41.0) and not w.contains(41.1)
    jw = J.pt.ActiveWindow.from_requests(*args)
    assert (w.t0, w.t1) == (jw.t0, jw.t1)


def test_active_window_rejects_bad_input(T):
    AW = T.pt.ActiveWindow
    with pytest.raises(ValueError):
        AW(5.0, 4.0)
    with pytest.raises(ValueError):
        AW.from_requests([], [])
    with pytest.raises(ValueError):
        AW.from_requests([1.0], [1.0, 2.0])


def test_constant_power_integrates_exactly(T, J):
    args = ([0.0, 1800.0, 3600.0], [100.0, 100.0, 100.0])
    tr = T.pt.PowerTrace(*args)
    assert tr.energy_wh() == pytest.approx(100.0)
    assert tr.energy_j() == pytest.approx(100.0 * 3600.0)
    close(tr.energy_j(), J.pt.PowerTrace(*args).energy_j())


def test_linear_ramp_integrates_exactly(T, J):
    tr = T.pt.PowerTrace([0.0, 3600.0], [0.0, 100.0])
    assert tr.energy_wh() == pytest.approx(50.0)
    close(tr.energy_wh(),
          J.pt.PowerTrace([0.0, 3600.0], [0.0, 100.0]).energy_wh())


def test_window_restricts_integration(T, J):
    args = ([0.0, 10.0, 20.0, 30.0, 40.0], [100.0] * 5)
    tr, jtr = T.pt.PowerTrace(*args), J.pt.PowerTrace(*args)
    half = tr.energy_wh(T.pt.ActiveWindow(10.0, 30.0))
    assert half == pytest.approx(100.0 * 20.0 / 3600.0)
    assert tr.energy_wh(T.pt.ActiveWindow(100.0, 200.0)) == 0.0
    close(half, jtr.energy_wh(J.pt.ActiveWindow(10.0, 30.0)))


def test_fewer_than_two_samples_is_zero_not_extrapolated(T):
    PT = T.pt.PowerTrace
    assert PT([], []).energy_wh() == 0.0
    assert PT([5.0], [300.0]).energy_wh() == 0.0
    tr = PT([0.0, 10.0, 20.0], [100.0, 100.0, 100.0])
    assert tr.energy_wh(T.pt.ActiveWindow(9.0, 11.0)) == 0.0


def test_trace_validates_samples(T):
    PT = T.pt.PowerTrace
    with pytest.raises(ValueError):
        PT([0.0, 0.0], [1.0, 1.0])
    with pytest.raises(ValueError):
        PT([0.0, 1.0], [1.0, -2.0])
    with pytest.raises(ValueError):
        PT([0.0, 1.0], [1.0, math.nan])
    with pytest.raises(ValueError):
        PT([0.0], [1.0, 2.0])


def _padded_trace(P):
    ts = [float(i) for i in range(0, 31, 2)]
    ws = [300.0 if 10 < t < 20 else 60.0 for t in ts]
    return P.pt.PowerTrace(ts, ws), P.pt.ActiveWindow(10.0, 20.0)


def test_idle_tax_series_integrates_outside_segments(T, J):
    tr, w = _padded_trace(T)
    total = tr.energy_wh()
    active = tr.energy_wh(w)
    tax = tr.idle_tax_wh(w, mode="series")
    assert tax == pytest.approx(2 * (60.0 * 10.0 / 3600.0))
    assert tax + active == pytest.approx(total)
    jtr, jw = _padded_trace(J)
    close([total, active, tax],
          [jtr.energy_wh(), jtr.energy_wh(jw),
           jtr.idle_tax_wh(jw, mode="series")])


def test_idle_tax_baseline_uses_median_outside_power(T, J):
    tr, w = _padded_trace(T)
    assert tr.baseline_w(w) == 60.0
    tax = tr.idle_tax_wh(w, mode="baseline")
    assert tax == pytest.approx(60.0 * 20.0 / 3600.0)
    with pytest.raises(ValueError):
        tr.idle_tax_wh(w, mode="nonsense")
    jtr, jw = _padded_trace(J)
    close(tax, jtr.idle_tax_wh(jw, mode="baseline"))


def test_normalized_per_request_and_per_1k_tokens(T, J):
    n = T.pt.normalized(10.0, 4, 2000.0)
    assert n["wh_per_request_active"] == pytest.approx(2.5)
    assert n["wh_per_1k_tokens_active"] == pytest.approx(5.0)
    assert n == J.pt.normalized(10.0, 4, 2000.0)


def test_normalized_missing_denominators_yield_none(T):
    n = T.pt.normalized(10.0, 0, None)
    assert n["wh_per_request_active"] is None
    assert n["wh_per_1k_tokens_active"] is None
    with pytest.raises(ValueError):
        T.pt.normalized(1.0, -1, None)


def test_csv_round_trip(T, J, tmp_path):
    tr = T.pt.PowerTrace([0.0, 1.5, 3.0], [50.0, 120.0, 80.0])
    path = tmp_path / "trace.csv"
    tr.to_csv(path)
    back = T.pt.PowerTrace.from_csv(path)
    assert back.t_s == tr.t_s
    assert back.watts == tr.watts
    theirs = J.pt.PowerTrace.from_csv(path)
    assert (theirs.t_s, theirs.watts) == (back.t_s, back.watts)


def test_csv_accepts_alternative_headers_and_skips_bad_rows(T):
    src = io.StringIO(
        "ts_s,power_w,extra\n0.0,100.0,x\n1.0,,x\n2.0,nope,x\n3.0,200.0,x\n")
    tr = T.pt.PowerTrace.from_csv(src)
    assert tr.t_s == (0.0, 3.0)
    assert tr.watts == (100.0, 200.0)


def test_csv_rejects_missing_columns(T):
    with pytest.raises(ValueError):
        T.pt.PowerTrace.from_csv(io.StringIO("a,b\n1,2\n"))


def test_synthesized_trace_matches_the_model_it_sampled(T, J):
    def run(P):
        e = P.energy
        plan = [P.pt.SegmentPlan("prefill",
                                 e.prefill_counts(e.LLAMA_1B, 8, 512), 20),
                P.pt.SegmentPlan("decode",
                                 e.decode_counts(e.LLAMA_1B, 8, 600), 1000)]
        return plan, P.pt.synthesize_trace(P.ada, plan, interval_s=0.02,
                                           pad_s=3.0)

    plan, (tr, segs) = run(T)
    assert [s.phase for s in segs] == ["prefill", "decode"]
    for seg, sp in zip(segs, plan):
        modeled_wh = T.energy.step_energy(T.ada, sp.counts).energy_wh \
            * sp.n_steps
        assert tr.energy_wh(seg.window) == pytest.approx(modeled_wh,
                                                         rel=0.05)
    w = T.pt.ActiveWindow(segs[0].t0, segs[-1].t1)
    assert tr.baseline_w(w) == pytest.approx(T.ada.idle_w)
    assert tr.idle_tax_wh(w, mode="baseline") == pytest.approx(
        T.ada.idle_w * 6.0 / 3600.0, rel=0.1)
    same_trace((tr, segs), run(J)[1])


def test_synthesize_rejects_infeasible_and_bad_args(T, J):
    e, st = T.energy, T.pt.synthesize_trace
    huge = e.decode_counts(e.LLAMA_1B, 100000, 100000)
    with pytest.raises(ValueError):
        st(T.ada, [T.pt.SegmentPlan("decode", huge)])
    small = [T.pt.SegmentPlan("decode", e.decode_counts(e.LLAMA_1B, 1, 10))]
    with pytest.raises(ValueError):
        st(T.ada, small, interval_s=0.0)
    with pytest.raises(ValueError):
        st(T.ada, small, noise_frac=0.1, rng=None)
    with pytest.raises(ValueError):
        T.pt.SegmentPlan("decode", e.decode_counts(e.LLAMA_1B, 1, 10),
                         n_steps=0)
    tr = st(T.ada, small, noise_frac=0.05, rng=np.random.default_rng(0))
    assert len(tr[0]) > 0
    jsmall = [J.pt.SegmentPlan("decode",
                               J.energy.decode_counts(J.energy.LLAMA_1B, 1,
                                                      10))]
    same_trace(tr, J.pt.synthesize_trace(J.ada, jsmall, noise_frac=0.05,
                                         rng=np.random.default_rng(0)))


# ---------------------------------------- tests/test_trace_calibration.py


def test_truth_profile_has_near_zero_loss(T, J):
    tr, segs = T.trace(noise=0.0)
    loss = T.cal.trace_loss(T.ada, tr, segs)
    assert loss < 1e-3
    wrong = T.cal.trace_loss(T.wrong_start(), tr, segs)
    assert wrong > 0.1
    jtr, jsegs = J.trace(noise=0.0)
    close([loss, wrong], [J.cal.trace_loss(J.ada, jtr, jsegs),
                          J.cal.trace_loss(J.wrong_start(), jtr, jsegs)])


def test_fit_recovers_energy_within_5_percent(T, J):
    tr, segs = T.trace()
    cal = T.cal.fit_power_trace(tr, segs, base=T.wrong_start(), seed=1)
    assert isinstance(cal, T.cal.TraceCalibration)
    assert abs(cal.energy_error_frac) < 0.05
    assert [r.phase for r in cal.residuals] == ["prefill", "decode"]
    for r in cal.residuals:
        assert r.measured_wh > 0 and r.modeled_wh > 0
        assert abs(r.energy_error_frac) < 0.10
        assert abs(r.time_error_frac) < 0.10
    for field, lo, hi, _ in T.cal.POWER_TRACE_SPACE:
        assert lo <= getattr(cal.profile, field) <= hi
    jtr, jsegs = J.trace()
    jcal = J.cal.fit_power_trace(jtr, jsegs, base=J.wrong_start(), seed=1)
    same_profile(cal.profile, jcal.profile)
    close([cal.loss, cal.energy_error_frac],
          [jcal.loss, jcal.energy_error_frac])
    for r, jr in zip(cal.residuals, jcal.residuals):
        close([r.measured_wh, r.modeled_wh, r.time_error_frac],
              [jr.measured_wh, jr.modeled_wh, jr.time_error_frac])


def test_fit_improves_on_the_starting_profile(T, J):
    tr, segs = T.trace()
    start = T.wrong_start()
    cal = T.cal.fit_power_trace(tr, segs, base=start, seed=2)
    assert cal.loss < T.cal.trace_loss(start, tr, segs)
    jtr, jsegs = J.trace()
    close(cal.loss, J.cal.fit_power_trace(jtr, jsegs, base=J.wrong_start(),
                                          seed=2).loss)


def test_report_is_human_readable(T, J):
    tr, segs = T.trace()
    rep = T.cal.fit_power_trace(tr, segs, base=T.ada, n_random=10,
                                n_refine=10).report()
    assert "prefill" in rep and "decode" in rep and "Wh" in rep
    jtr, jsegs = J.trace()
    assert rep == J.cal.fit_power_trace(jtr, jsegs, base=J.ada, n_random=10,
                                        n_refine=10).report()


def test_fit_requires_segments(T):
    tr, _ = T.trace()
    with pytest.raises(ValueError):
        T.cal.fit_power_trace(tr, [], base=T.ada)


# ----------------------------------------------------- the chip's sampler


def test_sampler_csv_reads_back_through_from_csv(T, tmp_path):
    """``chip_smoke.py``'s power sampler stamps each ``nvidia-smi`` reading
    with the host clock and writes ``t_s,watts`` rows; a row the sampler
    could not parse is left out. ``PowerTrace.from_csv`` reads the file
    back, and its integral over ``ActiveWindow.from_requests`` of a run's
    requests is the trapezoid over the in-window samples."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    lines = ["412.07 W", "415.52 W", "[N/A]", "698.90 W", "701.03 W",
             "433.18 W"]
    rows = [(100.0 + 0.1 * i, chip_smoke.parse_watts(s))
            for i, s in enumerate(lines)]
    path = tmp_path / "power.csv"
    chip_smoke.write_power_csv(path, rows)
    tr = T.pt.PowerTrace.from_csv(path)
    kept = [(t, w) for t, w in rows if w is not None]
    assert tr.t_s == tuple(round(t, 6) for t, _ in kept)
    assert tr.watts == tuple(w for _, w in kept)
    win = T.pt.ActiveWindow.from_requests([100.05, 100.15], [0.3, 0.25])
    inside = [(t, w) for t, w in zip(tr.t_s, tr.watts) if win.contains(t)]
    want = sum((w0 + w1) / 2.0 * (t1 - t0) for (t0, w0), (t1, w1)
               in zip(inside, inside[1:]))
    assert tr.energy_j(win) == pytest.approx(want, rel=1e-12)
