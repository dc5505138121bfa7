"""Temporal deferral in the port's ``ServingEngine`` against the JAX
engine, case for case: the reference's ``tests/test_defer_queue.py``
(the seeded sweeps it runs without hypothesis, and its four deterministic
cases) and ``tests/test_forecast.py`` on the port's copy of
``core/forecast.py``; plus the async server driving deferred work on
either engine, as the reference's server does.

Each engine case drives the port's engine and the JAX engine (same
parameters: the reference's ``Model.init``, converted by
``models/convert.params_from_jax``) through the same schedule, checks the
reference's invariants after every quantum on both (a parked request owns
nothing; page conservation), and holds the port to the JAX engine:
identical tokens, finish reasons and admission order, and every
``stats()`` key that is not a wall-clock reading (``queue_wait_*``) equal
to 1e-12 relative. The deferral queue is single-device: these run in this
process on one host device.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from repro.core.forecast import CIForecaster as JCIForecaster
from repro.core.forecast import mape as jmape
from repro.core.intensity import CISO as JCISO
from repro.core.intensity import QC as JQC
from repro.core.intensity import ci_at_hour as j_ci_at_hour
from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.models.config import repeat_pattern as j_repeat_pattern
from repro.serving import AsyncServingServer as JAsyncServingServer
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.core.forecast import CIForecaster, mape
from repro_torch.core.intensity import CISO, QC, ci_at_hour
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig, repeat_pattern
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (AsyncServingServer, EngineConfig, Request,
                                 ServingEngine, ShardedServingEngine)

PS = 8
CH = 8
TINY = dict(name="tiny-defer", family="dense", n_layers=2, d_model=64,
            n_heads=8, n_kv_heads=2, d_ff=128, vocab=256, dtype="float32",
            vocab_pad_multiple=8)
WALL_CLOCK = ("queue_wait_",)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model's ops are far below what a
    second thread pays for, and test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    jm = JModel(JModelConfig(**TINY,
                             block_pattern=j_repeat_pattern(("dense",), 2)))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY, block_pattern=repeat_pattern(("dense",), 2))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    tm = Model(cfg, "cpu")

    def jax_engine(**kw):
        return JServingEngine(jm, jp, JEngineConfig(**_cfg(kw)))

    def port_engine(**kw):
        return ServingEngine(tm, tp, EngineConfig(**_cfg(kw)), device="cpu")

    return ((jax_engine, JRequest, JAsyncServingServer),
            (port_engine, Request, AsyncServingServer), (tm, tp))


def _cfg(kw):
    args = dict(max_batch=3, max_len=64, sync_every=4, paged=True,
                page_size=PS, prefill_chunk=CH, defer_below_priority=1)
    args.update(kw)
    return args


def check_quantum_invariants(eng):
    """Truths that hold after EVERY scheduling quantum."""
    slot_rids = {r for r in eng.slot_rid if r >= 0}
    for req in eng.deferred:
        rid = req.rid
        assert rid in eng.deferred_rids
        assert rid in eng._defer_release_h
        assert rid not in eng._resv, f"deferred {rid} holds a reservation"
        assert rid not in slot_rids, f"deferred {rid} holds a slot"
        assert not eng.responses[rid].finished
        assert all(req is not q for q in eng.queue), \
            f"deferred {rid} also queued"
    assert len(eng.deferred_rids) == len(eng.deferred)
    assert (eng.free_pages + sum(eng._slot_pages)
            + sum(eng._resv.values()) == eng.num_pages)


def agree(jeng, teng):
    """The port's engine against the JAX engine after the same drive."""
    assert sorted(teng.responses) == sorted(jeng.responses)
    for rid, want in jeng.responses.items():
        got = teng.responses[rid]
        for field in ("tokens", "finish_reason", "finished", "preemptions"):
            assert getattr(got, field) == getattr(want, field), (rid, field)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key, val in js.items():
        if not key.startswith(WALL_CLOCK):
            assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
    assert teng.meter.clock_hours == pytest.approx(jeng.meter.clock_hours,
                                                   rel=1e-12, abs=0.0)
    assert [r.rid for r in teng.deferred] == [r.rid for r in jeng.deferred]


def _random_specs(rng):
    return [(int(rng.integers(0, 7)),            # submit at quantum
             int(rng.integers(0, 3)),            # priority
             int(rng.integers(3, 21)),           # prompt len
             int(rng.integers(1, 9)),            # max_new_tokens
             (None, 30.0)[int(rng.integers(0, 2))])   # deadline_s
            for _ in range(int(rng.integers(1, 11)))]


def _drive(eng, make, specs, rng):
    """Submit per the schedule while stepping; invariants every quantum.
    Returns (deferred-class rids in submission order, admission order of
    those rids)."""
    admit_order = []
    orig_stamp = type(eng)._stamp_admit

    def spy(req):
        if req.priority < 1:
            admit_order.append(req.rid)
        return orig_stamp(eng, req)

    eng._stamp_admit = spy
    pending = sorted(enumerate(specs), key=lambda t: (t[1][0], t[0]))
    deferred_class = []
    q = 0
    while pending or eng.queue or eng.active or eng.deferred:
        while pending and pending[0][1][0] <= q:
            rid, (_, prio, L, mnt, dl) = pending.pop(0)
            eng.submit(make(
                rid=rid, prompt=[int(t) for t in rng.integers(0, 256, L)],
                max_new_tokens=mnt, priority=prio, deadline_s=dl))
            if prio < 1:
                deferred_class.append(rid)
        progressed = eng.step()
        check_quantum_invariants(eng)
        if not progressed and not eng.decoding and not pending:
            if eng.queue:
                eng._resolve_stall()
            elif eng.deferred:
                eng._fast_forward_deferred()
        q += 1
        assert q < 2000, "deferral wedged the engine"
    return deferred_class, admit_order


def _both(sides, specs, seed, **kw):
    """Drive both engines through one schedule; they must agree."""
    out = []
    for engine, make, _ in sides[:2]:
        eng = engine(**kw)
        out.append((eng,) + _drive(eng, make, specs,
                                   np.random.default_rng(seed)))
    (jeng, jclass, jorder), (teng, tclass, torder) = out
    agree(jeng, teng)
    assert torder == jorder
    return teng, tclass, torder


@pytest.mark.parametrize("seed", range(12))
def test_defer_release_interleavings(sides, seed):
    """Random schedules: parked requests own nothing, page conservation
    holds every quantum, every deferred request releases and finishes,
    none by deadline, release never reorders FCFS."""
    specs = _random_specs(np.random.default_rng(1000 + seed))
    eng, deferred_class, admit_order = _both(sides, specs, seed)
    assert not eng.deferred and not eng.deferred_rids
    assert not eng._defer_release_h
    assert eng.deferred_total == len(deferred_class)
    assert eng.deferred_released == eng.deferred_total
    for rid in deferred_class:
        resp = eng.responses[rid]
        assert resp.finished, f"deferred {rid} never finished"
        assert resp.finish_reason != "deadline"
    assert admit_order == deferred_class
    assert eng.free_pages == eng.num_pages


@pytest.mark.parametrize("seed", range(8))
def test_defer_with_preemption_interleavings(sides, seed):
    """Same properties with priority preemption evicting running
    deferred-class work mid-decode."""
    specs = _random_specs(np.random.default_rng(2000 + seed))
    eng, deferred_class, _ = _both(sides, specs, seed, preemption=True,
                                   max_batch=2)
    assert not eng.deferred
    for rid in deferred_class:
        resp = eng.responses[rid]
        assert resp.finished and resp.finish_reason != "deadline"
    assert eng.free_pages == eng.num_pages


def _order_run(engine, make, n, rng_seed, **kw):
    eng = engine(**kw)
    rng = np.random.default_rng(rng_seed)
    for i in range(n):
        eng.submit(make(rid=i, prompt=[int(t) for t in
                                       rng.integers(0, 256, 6)],
                        max_new_tokens=3, priority=0))
    order = []
    orig = type(eng)._stamp_admit

    def spy(req):
        order.append(req.rid)
        return orig(eng, req)

    eng._stamp_admit = spy
    parked = len(eng.deferred)
    eng.run()
    return eng, order, parked


def test_release_preserves_fcfs_order(sides):
    """Five same-class deferred requests released together admit in
    submission order, at the region's greenest window, not before."""
    (jeng, jorder, _), (eng, order, parked) = (
        _order_run(engine, make, 5, 0) for engine, make, _ in sides[:2])
    agree(jeng, eng)
    assert order == jorder == sorted(order)
    assert parked == 5
    assert eng.deferred_released == 5
    assert all(eng.responses[i].finished for i in range(5))
    assert eng.meter.clock_hours >= eng.meter.region.min_hour - 1.0


def test_deferred_exempt_from_bounded_queue(sides):
    """A burst of deferred-class work neither sheds nor makes express
    work shed: parked requests own no queue position."""
    engs = []
    for engine, make, _ in sides[:2]:
        eng = engine(max_queue=2)
        rng = np.random.default_rng(1)
        for i in range(6):
            eng.submit(make(rid=i, prompt=[int(t) for t in
                                           rng.integers(0, 256, 5)],
                            max_new_tokens=2, priority=0))
        eng.submit(make(rid=100, prompt=[int(t) for t in
                                         rng.integers(0, 256, 5)],
                        max_new_tokens=2, priority=1))
        assert eng.shed_count == 0 and len(eng.deferred) == 6
        eng.run()
        engs.append(eng)
    agree(*engs)
    eng = engs[1]
    assert eng.shed_count == 0
    assert all(r.finished for r in eng.responses.values())


def test_forced_release_beats_deadline(sides):
    """A deferred request whose wall-clock deadline budget half-expires
    is force-released though its window is hours of virtual time away,
    and finishes inside its deadline; an express stream keeps the engine
    busy so the idle fast-forward cannot mask the forced path. The
    reference sleeps 0.3 s of a 0.5 s deadline; here the request's submit
    time moves 10.5 s back of a 20 s deadline, so half its budget has
    passed at once and the rest leaves room for a loaded host."""
    engs = []
    for engine, make, _ in sides[:2]:
        eng = engine(defer_deadline_frac=0.5)
        rng = np.random.default_rng(2)
        eng.submit(make(rid=0, prompt=[int(t) for t in
                                       rng.integers(0, 256, 5)],
                        max_new_tokens=2, priority=0, deadline_s=20.0))
        assert len(eng.deferred) == 1
        eng.deferred[0].t_submit -= 10.5
        eng.submit(make(rid=1, prompt=[int(t) for t in
                                       rng.integers(0, 256, 8)],
                        max_new_tokens=30, priority=1))
        for _ in range(200):
            eng.step()
            if not (eng.queue or eng.active or eng.deferred):
                break
        engs.append(eng)
    agree(*engs)
    eng = engs[1]
    assert eng.deferred_forced == 1, "deadline pressure never forced"
    resp = eng.responses[0]
    assert resp.finished and resp.finish_reason != "deadline"


def test_defer_disabled_is_inert(sides):
    engs = []
    for engine, make, _ in sides[:2]:
        eng = engine(defer_below_priority=None)
        rng = np.random.default_rng(3)
        for i in range(3):
            eng.submit(make(rid=i, prompt=[int(t) for t in
                                           rng.integers(0, 256, 6)],
                            max_new_tokens=3, priority=0))
        eng.run()
        engs.append(eng)
    agree(*engs)
    st = engs[1].stats()
    assert st["deferred_requests"] == 0
    assert st["deferred_released"] == 0
    assert st["deferred_forced_releases"] == 0
    assert all(r.finished for r in engs[1].responses.values())


# ------------------------------------------------------- the async server


def _served(engine, Server, make):
    async def go():
        srv = Server(engine, max_steps=100_000)
        rng = np.random.default_rng(4)
        for i in range(4):
            await srv.submit(make(rid=i, prompt=[int(t) for t in
                                                 rng.integers(0, 256, 7)],
                                  max_new_tokens=4, priority=i % 2))
        await srv.drain()
        return {rid: (r.tokens, r.finish_reason)
                for rid, r in engine.responses.items()}
    return asyncio.run(go())


def test_server_releases_deferred_work(sides):
    """Parked requests keep the server's drive loop alive: with only
    deferred work left it moves the virtual clock to the release window,
    on both engines alike."""
    got = []
    engs = []
    for engine, make, Server in sides[:2]:
        eng = engine()
        got.append(_served(eng, Server, make))
        engs.append(eng)
    assert got[1] == got[0]
    agree(*engs)
    assert engs[1].deferred_released == 2
    assert all(reason == "length" for _, reason in got[1].values())


def test_server_wraps_the_fleet(sides):
    """The port's server drives the fleet as it drives the single engine:
    the same responses as ``run()`` on an identical fleet."""
    tm, tp = sides[2]
    cfg = EngineConfig(**_cfg(dict(max_batch=2, shards=2,
                                   routing="carbon",
                                   shard_regions=("QC", "PACE"))))
    via_server = _served(ShardedServingEngine(tm, tp, cfg, device="cpu"),
                         AsyncServingServer, Request)
    eng = ShardedServingEngine(tm, tp, cfg, device="cpu")
    rng = np.random.default_rng(4)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=[int(t) for t in
                                          rng.integers(0, 256, 7)],
                           max_new_tokens=4, priority=i % 2))
    eng.run()
    assert via_server == {rid: (r.tokens, r.finish_reason)
                          for rid, r in eng.responses.items()}
    assert eng.deferred_released == 2


# ------------------------------------------------------ tests/test_forecast


def synth_trace(ci_at, region, days=7, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    hours = np.arange(days * 24, dtype=float)
    ci = np.array([ci_at(region, h % 24) for h in hours])
    ci = ci * (1 + rng.normal(0, noise, ci.shape))
    return hours, ci


def _fit_both(region, jregion, fit_days, **kw):
    hours, ci = synth_trace(ci_at_hour, region, **kw)
    jhours, jci = synth_trace(j_ci_at_hour, jregion, **kw)
    np.testing.assert_array_equal(ci, jci)
    n = fit_days * 24 if fit_days else len(hours)
    return (hours, ci, CIForecaster().fit(hours[:n], ci[:n]),
            JCIForecaster().fit(jhours[:n], jci[:n]))


def test_forecast_accuracy_on_diurnal_trace():
    hours, ci, f, jf = _fit_both(CISO, JCISO, 6, days=7)
    pred = f.predict(hours[-24:])
    np.testing.assert_allclose(pred, jf.predict(hours[-24:]), rtol=1e-12)
    err = mape(pred, ci[-24:])
    assert err == pytest.approx(jmape(pred, ci[-24:]), rel=1e-12)
    assert err < 0.10


def test_forecast_flat_region():
    hours, ci, f, jf = _fit_both(QC, JQC, 4, days=5, noise=0.02)
    pred = f.predict(hours[-24:])
    np.testing.assert_allclose(pred, jf.predict(hours[-24:]), rtol=1e-12)
    assert mape(pred, ci[-24:]) < 0.06


def test_greenest_window_hits_solar_dip():
    hours, _, f, jf = _fit_both(CISO, JCISO, None, days=7, noise=0.03)
    start, mean_ci = f.greenest_window(start_hour=hours[-1] + 1,
                                       horizon_h=24, duration_h=3)
    jstart, jmean = jf.greenest_window(start_hour=hours[-1] + 1,
                                       horizon_h=24, duration_h=3)
    assert start == jstart
    assert mean_ci == pytest.approx(jmean, rel=1e-12)
    assert 10 <= (start % 24) <= 16
    assert mean_ci < CISO.ci_g_per_kwh


def test_window_duration_monotone():
    hours, _, f, jf = _fit_both(CISO, JCISO, None, days=7)
    for dur in (1, 6):
        got = f.greenest_window(hours[-1] + 1, 24, dur)
        want = jf.greenest_window(hours[-1] + 1, 24, dur)
        assert got[0] == want[0]
        assert got[1] == pytest.approx(want[1], rel=1e-12)
    _, ci1 = f.greenest_window(hours[-1] + 1, 24, 1)
    _, ci6 = f.greenest_window(hours[-1] + 1, 24, 6)
    assert ci1 <= ci6 + 1e-9
