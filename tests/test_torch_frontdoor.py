"""The port's front door against the JAX engine, case for case: the
reference's ``tests/test_preemption.py`` (9), ``tests/test_faults.py``
(14), ``tests/test_server.py`` (10) and ``tests/test_engine_admission.py``
(8).

Each engine case runs the port's ``ServingEngine`` and the JAX engine on
the same parameters (the reference's ``Model.init``, converted by
``models/convert.params_from_jax``), the same trace and the same
``FaultPlan``, then holds the port to the JAX engine: identical token
streams, finish reasons, preemption counts and fired faults, and every
``stats()`` key that is not a wall-clock reading (``queue_wait_*``) equal
to 1e-12 relative; a paged port engine that drained ends with a whole
pool (``_assert_pool_clean``). On top, each case keeps the reference
test's own assertions (the unpreempted oracle, the fault-free run, the
backoff schedule). Preemption cases check the pin-aware allocator
invariants after every quantum on both engines, as the reference's
``CheckedPreemptEngine``.

The reference's model of those suites (2 dense layers, d_model 64, 8 query
heads on 2 kv heads, vocab 256, float32), on the CPU. Where a reference
test times an arrival with ``asyncio.sleep`` or sets a deadline of 1e-4 s,
its mirror keys the arrival to the engine's quantum counter and takes
``deadline_s=0.0`` (expired at the first sweep), so both engines see the
same interleaving whatever the host's speed."""
import asyncio
import dataclasses
import time

import jax
import numpy as np
import pytest

from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.models.config import repeat_pattern as j_repeat_pattern
from repro.serving import AsyncServingServer as JAsyncServingServer
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import FaultError as JFaultError
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig, repeat_pattern
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (AsyncServingServer, EngineConfig,
                                 FaultError, FaultInjector, FaultPlan,
                                 HealthMonitor, Request, ServingEngine)
from repro_torch.serving.faults import ADMIN_SITES
from repro_torch.serving.preempt import pick_victim

PS = 4                                 # page size of the suites
CH = 8                                 # prefill chunk
TINY = dict(name="tiny-frontdoor", family="dense", n_layers=2, d_model=64,
            n_heads=8, n_kv_heads=2, d_ff=128, vocab=256, dtype="float32",
            vocab_pad_multiple=8)
WALL_CLOCK = ("queue_wait_",)


def _pin_invariants(eng):
    """The reference's ``CheckedPreemptEngine.check_alloc``, on either
    engine's allocator: device ``ref[p]`` == table mappings + host pins,
    every page conserved (``top`` + #referenced == P), no duplicate and no
    referenced page on the free stack."""
    a = {k: np.asarray(v) for k, v in eng.caches["paged"].items()}
    if not isinstance(eng, JServingEngine):
        a = {k: v[0] for k, v in a.items()}      # the port's S = 1 axis
    tbl, free, top, ref = a["tbl"], a["free"], int(a["top"]), a["ref"]
    P = ref.shape[0]
    counts = np.zeros((P,), int)
    for row in tbl:
        for p in row[row >= 0]:
            counts[p] += 1
    for pins in eng._pins.values():
        for p in pins:
            counts[p] += 1
    assert (ref == counts).all(), "device refcounts != mappings + pins"
    assert top + int((counts > 0).sum()) == P, "page conservation"
    stack = free[:top].tolist()
    assert len(set(stack)) == top, "free stack duplicate"
    assert not set(stack) & set(np.flatnonzero(counts).tolist()), \
        "referenced page on the free stack"


class _JChecked(JServingEngine):
    def step(self, max_steps=10_000):
        ran = super().step(max_steps)
        _pin_invariants(self)
        return ran


class _TChecked(ServingEngine):
    def step(self, max_steps=10_000):
        ran = super().step(max_steps)
        _pin_invariants(self)
        return ran


@dataclasses.dataclass
class Side:
    """One package's serving API over one model and its parameters."""
    name: str
    model: object
    params: object
    Engine: type
    Checked: type
    Config: type
    Request: type
    Injector: type
    Plan: type
    Server: type
    FaultError: type
    kw: dict

    def engine(self, checked=False, **cfg):
        cls = self.Checked if checked else self.Engine
        return cls(self.model, self.params, self.Config(**cfg), **self.kw)

    def submit(self, eng, **req):
        eng.submit(self.Request(**req))


@pytest.fixture(scope="module")
def sides():
    jm = JModel(JModelConfig(**TINY,
                             block_pattern=j_repeat_pattern(("dense",), 2)))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY, block_pattern=repeat_pattern(("dense",), 2))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return (Side("jax", jm, jp, JServingEngine, _JChecked, JEngineConfig,
                 JRequest, JFaultInjector, JFaultPlan, JAsyncServingServer,
                 JFaultError, {}),
            Side("torch", Model(cfg, "cpu"), tp, ServingEngine, _TChecked,
                 EngineConfig, Request, FaultInjector, FaultPlan,
                 AsyncServingServer, FaultError, dict(device="cpu")))


def _assert_pool_clean(teng):
    """``tests/test_torch_engine.py``'s check: the whole pool back."""
    alloc = {k: v[0] for k, v in teng.caches["paged"].items()}   # S = 1
    P = alloc["free"].shape[0]
    assert int(alloc["top"]) == P
    assert (alloc["tbl"] == -1).all() and (alloc["ref"] == 0).all()
    assert sorted(alloc["free"].tolist()) == list(range(P))
    assert teng.free_pages == teng.num_pages


def _agree(jeng, teng):
    """The port's engine against the JAX engine after the same drive."""
    assert sorted(teng.responses) == sorted(jeng.responses)
    for rid, want in jeng.responses.items():
        got = teng.responses[rid]
        for field in ("tokens", "finish_reason", "finished", "rejected",
                      "preemptions", "priority"):
            assert getattr(got, field) == getattr(want, field), (rid, field)
        for field in ("energy_j", "recompute_j", "prefill_s", "decode_s"):
            assert getattr(got, field) == pytest.approx(
                getattr(want, field), rel=1e-12, abs=0.0), (rid, field)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key, val in js.items():
        if not key.startswith(WALL_CLOCK):
            assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
    if jeng.faults is not None:
        assert teng.faults.fired == jeng.faults.fired
    assert [r.rid for r in teng.queue] == [r.rid for r in jeng.queue]
    assert sorted(teng._pins) == sorted(jeng._pins)
    if teng.paged:
        assert teng.free_pages == jeng.free_pages
        if not (teng.queue or teng.active):
            _assert_pool_clean(teng)
            assert not teng._pins


def both(sides, drive, checked=False, **cfg):
    """``drive(side, engine)`` on a fresh engine of each package (built
    from ``cfg``); the two engines must agree (``_agree``). Returns
    (jax engine, port engine, jax result, port result)."""
    (jside, tside) = sides
    jeng = jside.engine(checked, **cfg)
    jres = drive(jside, jeng)
    teng = tside.engine(checked, **cfg)
    tres = drive(tside, teng)
    _agree(jeng, teng)
    return jeng, teng, jres, tres


def _tokens(side, reqs, **cfg):
    eng = side.engine(**cfg)
    for r in reqs:
        side.submit(eng, **r)
    return {r.rid: r.tokens for r in eng.run()}


# ---------------------------------------------------------------------------
# tests/test_preemption.py
# ---------------------------------------------------------------------------
PREEMPT = dict(max_batch=2, max_len=64, sync_every=4, paged=True,
               page_size=PS, prefill_chunk=CH, preemption=True,
               prefix_sharing=True)


def _oracle(side, reqs):
    """Every request served with ample capacity, never preempted."""
    return _tokens(side, reqs, max_batch=max(4, len(reqs)), max_len=64,
                   sync_every=4, paged=True, page_size=PS, prefill_chunk=CH)


def _preempted(low, high, warmup=6):
    """Submit ``low`` (default class), run ``warmup`` quanta so they are
    armed mid-decode, submit ``high`` (priority 1), drain."""
    def drive(side, eng):
        for r in low:
            side.submit(eng, **r)
        for _ in range(warmup):
            eng.step()
        assert eng.decoding > 0, "warmup must leave victims mid-decode"
        for r in high:
            side.submit(eng, **{"priority": 1, **r})
        return {r.rid: r for r in eng.run()}
    return drive


def _reqs(rng, rids, lens, max_new=16, **kw):
    return [dict(rid=rid, prompt=rng.integers(0, 256, int(n)).tolist(),
                 max_new_tokens=max_new, **kw)
            for rid, n in zip(rids, lens)]


def test_preemption_parity_and_invariants(sides):
    """Two long low-priority decodes hold both slots; a high-priority
    arrival evicts one. Both engines agree, every request equals the
    unpreempted oracle, the victim serves its whole budget, the pool
    drains with no pin left."""
    rng = np.random.default_rng(42)
    low = _reqs(rng, (0, 1), (10, 13), max_new=24)
    high = _reqs(rng, (2,), (6,), max_new=6)
    _, eng, _, got = both(sides, _preempted(low, high), checked=True,
                          **PREEMPT)
    want = _oracle(sides[1], low + high)
    assert eng.preemption_count >= 1, "no eviction happened"
    for rid in want:
        assert got[rid].tokens == want[rid], f"request {rid} diverged"
        assert got[rid].finished
    preempted = [r for r in got.values() if r.preemptions > 0]
    assert preempted, "some victim must have resumed"
    for r in preempted:
        assert len(r.tokens) == 24 and r.recompute_j > 0.0
    assert eng.free_pages == eng.num_pages and not eng._pins
    st = eng.stats()
    assert st["preemption_count"] == eng.preemption_count
    assert st["preempted_recompute_j"] == pytest.approx(
        sum(r.recompute_j for r in got.values()))


def test_preemption_without_sharing_recomputes_everything(sides):
    rng = np.random.default_rng(43)
    low = _reqs(rng, (0, 1), (9, 12), max_new=32)
    high = _reqs(rng, (2,), (5,), max_new=4)
    _, eng, _, got = both(sides, _preempted(low, high), checked=True,
                          **dict(PREEMPT, prefix_sharing=False))
    want = _oracle(sides[1], low + high)
    assert eng.preemption_count >= 1 and not eng._pins
    for rid in want:
        assert got[rid].tokens == want[rid], f"request {rid} diverged"


def test_partially_shared_victim_parity(sides):
    """The victim adopted a prefix another resident registered: eviction
    keeps the still-shared run alive for the sibling and pins only what
    the index can hand back."""
    rng = np.random.default_rng(44)
    common = rng.integers(0, 256, 8).tolist()      # two whole shared pages
    low = [dict(rid=0, prompt=common + [7, 8, 9], max_new_tokens=40),
           dict(rid=1, prompt=common + [1, 2, 3, 4], max_new_tokens=40)]
    high = _reqs(rng, (2,), (6,), max_new=6)
    _, eng, _, got = both(sides, _preempted(low, high), checked=True,
                          **PREEMPT)
    want = _oracle(sides[1], low + high)
    assert eng.preemption_count >= 1
    for rid in want:
        assert got[rid].tokens == want[rid], f"request {rid} diverged"
    assert eng.free_pages == eng.num_pages


def test_resume_hits_pinned_prefix(sides):
    rng = np.random.default_rng(45)
    low = _reqs(rng, (0, 1), (12, 12), max_new=24)
    high = _reqs(rng, (2,), (4,), max_new=4)
    _, eng, _, got = both(sides, _preempted(low, high), checked=True,
                          **PREEMPT)
    assert eng.preemption_count >= 1
    assert eng.prefix_hit_tokens > 0
    assert [r for r in got.values() if r.preemptions > 0]


def test_preemption_charges_recompute_not_prefill(sides):
    """Resume prefills are metered under ``recompute``: the prefill phase
    equals the unpreempted engine's, on both engines."""
    rng = np.random.default_rng(46)
    low = _reqs(rng, (0, 1), (10, 13), max_new=24)
    high = _reqs(rng, (2,), (6,), max_new=6)
    jeng, eng, _, _ = both(sides, _preempted(low, high), checked=True,
                           **PREEMPT)
    assert eng.preemption_count >= 1
    ref = sides[1].engine(max_batch=4, max_len=64, sync_every=4, paged=True,
                          page_size=PS, prefill_chunk=CH)
    for r in low + [dict(priority=1, **h) for h in high]:
        sides[1].submit(ref, **r)
    ref.run()
    pf, ref_pf = eng.meter.phase("prefill"), ref.meter.phase("prefill")
    assert pf.tokens == pytest.approx(ref_pf.tokens)
    assert pf.energy_j == pytest.approx(ref_pf.energy_j, rel=1e-6)
    rc = eng.meter.phase("recompute")
    assert rc.energy_j == pytest.approx(eng.preempted_recompute_j)
    assert rc.energy_j > 0
    assert rc.energy_j == pytest.approx(
        jeng.meter.phase("recompute").energy_j, rel=1e-12)


def test_repeated_preemption_same_request(sides):
    """A request evicted twice still serves its exact budget."""
    orig = np.random.default_rng(47).integers(0, 256, 8).tolist()

    def drive(side, eng):
        side.submit(eng, rid=0, prompt=list(orig), max_new_tokens=40)
        for _ in range(5):
            eng.step()
        assert eng.decoding
        side.submit(eng, rid=1, prompt=[1, 2, 3], max_new_tokens=4,
                    priority=1)
        side.submit(eng, rid=2, prompt=[4, 5, 6], max_new_tokens=4,
                    priority=1)
        while not (eng.responses[1].finished and eng.responses[2].finished):
            eng.step()
        while not eng.decoding:          # rid 0 back mid-flight
            eng.step()
        side.submit(eng, rid=3, prompt=[7, 8, 9], max_new_tokens=4,
                    priority=1)
        side.submit(eng, rid=4, prompt=[8, 9, 1], max_new_tokens=4,
                    priority=1)
        return {r.rid: r for r in eng.run()}

    _, eng, _, got = both(sides, drive, checked=True, **PREEMPT)
    assert got[0].finished and len(got[0].tokens) == 40
    assert got[0].preemptions >= 1
    want = _oracle(sides[1], [dict(rid=0, prompt=orig, max_new_tokens=40)])
    assert got[0].tokens == want[0]
    assert eng.free_pages == eng.num_pages


def test_no_victim_below_priority_waits(sides):
    rng = np.random.default_rng(48)
    low = _reqs(rng, (0, 1), (8, 8), max_new=16)

    def drive(side, eng):
        for r in low:
            side.submit(eng, **r)
        for _ in range(5):
            eng.step()
        side.submit(eng, rid=2, prompt=[1, 2, 3], max_new_tokens=4)
        return {r.rid: r for r in eng.run()}

    _, eng, _, got = both(sides, drive, checked=True, **PREEMPT)
    assert eng.preemption_count == 0
    want = _oracle(sides[1], low + [dict(rid=2, prompt=[1, 2, 3],
                                         max_new_tokens=4)])
    for rid in want:
        assert got[rid].tokens == want[rid]


def test_pick_victim_policy():
    armed = [True, True, False, True]
    prio = [0, 0, 0, 1]
    progress = [5, 3, 0, 1]
    assert pick_victim(armed, prio, progress, below_priority=1) == 1
    assert pick_victim(armed, prio, progress, below_priority=2) == 1
    assert pick_victim(armed, prio, progress, below_priority=0) is None
    assert pick_victim([True, True], [0, 0], [2, 2], 1) == 1


def test_preemption_requires_chunked(sides):
    msgs = []
    for side in sides:
        with pytest.raises(ValueError, match="preemption requires chunked") \
                as e:
            side.engine(max_batch=2, max_len=64, paged=True, page_size=PS,
                        preemption=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# tests/test_faults.py
# ---------------------------------------------------------------------------
FAULTS = dict(max_batch=2, max_len=64, sync_every=4, paged=True,
              page_size=PS, prefill_chunk=CH)


def _fault_reqs(n=3, max_new=8, seed=7):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=rng.integers(0, 256, 6 + 2 * i).tolist(),
                 max_new_tokens=max_new) for i in range(n)]


def _faulted(reqs, plans):
    """Run ``reqs`` under ``plans`` (site, at_quantum, count) to the end;
    a FaultError is returned, not raised."""
    def drive(side, eng):
        eng.faults = side.Injector([side.Plan(*p) for p in plans])
        for r in reqs:
            side.submit(eng, **r)
        try:
            return {r.rid: r for r in eng.run()}
        except side.FaultError as e:
            return e
    return drive


@pytest.mark.parametrize("site,at", [
    ("page_alloc", 1), ("prefill_chunk", 2), ("prefill_chunk", 1),
    ("decode_scan", 4),
])
def test_single_fault_full_recovery(sides, site, at):
    reqs = _fault_reqs()
    want = _tokens(sides[1], reqs, **FAULTS)
    _, eng, _, got = both(sides, _faulted(reqs, [(site, at)]), **FAULTS)
    assert eng.faults.fired, f"planned fault at {site} q{at} never fired"
    assert eng.fault_retries >= 1 and not eng._backoff
    for rid in want:
        assert got[rid].tokens == want[rid], f"request {rid} diverged"
        assert got[rid].finished
    _assert_pool_clean(eng)


def test_page_alloc_rollback_exact(sides):
    """An admission fault returns every page of the quantum's reservations
    and restores the takes at the queue head in order."""
    def drive(side, eng):
        eng.faults = side.Injector([side.Plan("page_alloc", at_quantum=1)])
        for r in _fault_reqs(2):
            side.submit(eng, **r)
        free0, order0 = eng.free_pages, [r.rid for r in eng.queue]
        assert eng.step() == 0             # the faulted quantum
        assert eng.free_pages == free0, "rollback leaked reservation pages"
        assert [r.rid for r in eng.queue] == order0, "rollback reordered"
        assert not eng._resv and eng.peak_pages_reserved == 0
        return {r.rid: r for r in eng.run()}

    _, eng, _, got = both(sides, drive, **FAULTS)
    assert all(r.finished for r in got.values())
    _assert_pool_clean(eng)


def test_consecutive_faults_backoff_schedule(sides):
    """Retries at quantum gaps 2, 4, 8; the retry past max_retries raises.
    A window shorter than the cumulative backoff recovers."""
    _, eng, _, err = both(sides, _faulted(_fault_reqs(1),
                                          [("prefill_chunk", 1, 30)]),
                          **FAULTS, max_retries=3)
    assert isinstance(err, FaultError) and "prefill_chunk" in str(err)
    fired = [q for _, q in eng.faults.fired]
    assert len(fired) == 3 + 1
    assert np.diff(fired).tolist() == [2, 4, 8]
    _, eng2, _, got = both(sides, _faulted(_fault_reqs(1),
                                           [("prefill_chunk", 1, 7)]),
                           **FAULTS, max_retries=3)
    assert len(eng2.faults.fired) == 3
    assert all(r.finished for r in got.values())
    _assert_pool_clean(eng2)


def test_retry_exhaustion_raises_fault_error_state_consistent(sides):
    """A permanently failing site raises FaultError with the state
    consistent; with the injector cleared the same engine finishes."""
    reqs = _fault_reqs(2)
    want = _tokens(sides[1], reqs, **FAULTS)

    def drive(side, eng):
        eng.faults = side.Injector([side.Plan("page_alloc", at_quantum=0,
                                              count=100)])
        for r in reqs:
            side.submit(eng, **r)
        with pytest.raises(side.FaultError, match="page_alloc"):
            eng.run()
        assert eng.free_pages == eng.num_pages
        assert len(eng.queue) == len(reqs)
        fired = list(eng.faults.fired)
        eng.faults = None              # "the device came back"
        eng._backoff.clear()
        return fired, {r.rid: r for r in eng.run()}

    _, eng, (jfired, _), (fired, got) = both(sides, drive, **FAULTS,
                                             max_retries=2)
    assert fired == jfired
    for rid in want:
        assert got[rid].tokens == want[rid]
    _assert_pool_clean(eng)


def test_decode_fault_never_double_emits(sides):
    """A decode-scan fault relaunches the identical chunk, EOS mid-chunk
    included: fires at rel q 3 and at its retry at 5, succeeds at 9."""
    probe = _tokens(sides[1], [dict(rid=0, prompt=[9, 8, 7],
                                    max_new_tokens=12)], **FAULTS)
    eos = probe[0][5]
    reqs = [dict(rid=0, prompt=[9, 8, 7], max_new_tokens=12, eos_id=eos),
            dict(rid=1, prompt=[1, 2, 3, 4], max_new_tokens=10)]
    want = _tokens(sides[1], reqs, **FAULTS)
    _, eng, _, got = both(sides, _faulted(reqs, [("decode_scan", 3, 3)]),
                          **FAULTS)
    assert len(eng.faults.fired) == 2
    assert got[0].finish_reason == "eos"
    for rid in want:
        assert got[rid].tokens == want[rid]
    _assert_pool_clean(eng)


def test_faults_at_every_site_same_run(sides):
    reqs = _fault_reqs(3, max_new=10)
    want = _tokens(sides[1], reqs, **FAULTS)
    _, eng, _, got = both(sides, _faulted(reqs, [
        ("page_alloc", 1), ("prefill_chunk", 4), ("decode_scan", 8)]),
        **FAULTS)
    assert {s for s, _ in eng.faults.fired} == {"page_alloc",
                                                "prefill_chunk",
                                                "decode_scan"}
    for rid in want:
        assert got[rid].tokens == want[rid]
    _assert_pool_clean(eng)
    assert eng.stats()["fault_retries"] == eng.fault_retries >= 3


def test_faults_with_sharing_and_preemption(sides):
    """Faults during a preemption run with sharing: pins, copy-on-write
    and rollback compose, token-exact and clean."""
    rng = np.random.default_rng(8)
    common = rng.integers(0, 256, 8).tolist()
    reqs = [dict(rid=0, prompt=common + [3, 1], max_new_tokens=24),
            dict(rid=1, prompt=common + [4, 1, 5], max_new_tokens=24)]
    high = dict(rid=2, prompt=[6, 2, 8], max_new_tokens=4, priority=1)
    want = _tokens(sides[1], reqs + [high],
                   **dict(FAULTS, max_batch=4, prefix_sharing=True))

    def drive(side, eng):
        eng.faults = side.Injector([side.Plan("decode_scan", at_quantum=5),
                                    side.Plan("prefill_chunk",
                                              at_quantum=8)])
        for r in reqs:
            side.submit(eng, **r)
        for _ in range(6):
            eng.step()
        side.submit(eng, **high)
        return {r.rid: r for r in eng.run()}

    _, eng, _, got = both(sides, drive, checked=True,
                          **dict(FAULTS, prefix_sharing=True,
                                 preemption=True))
    assert eng.faults.fired
    for rid in want:
        assert got[rid].tokens == want[rid], f"request {rid} diverged"
    _assert_pool_clean(eng)


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan("warp_core", at_quantum=0)
    with pytest.raises(ValueError, match="at_quantum"):
        FaultPlan("decode_scan", at_quantum=-1)
    with pytest.raises(ValueError, match="count"):
        FaultPlan("decode_scan", at_quantum=0, count=0)


def test_fault_plan_shard_validation():
    with pytest.raises(ValueError, match="shard >= 0"):
        FaultPlan("shard_down", at_quantum=1)
    with pytest.raises(ValueError, match="only apply to shard_down"):
        FaultPlan("decode_scan", at_quantum=1, shard=0)
    assert FaultPlan("shard_down", at_quantum=1, shard=2).shard == 2


def test_fault_plan_admin_validation():
    with pytest.raises(ValueError, match="shard >= 0"):
        FaultPlan("drain", at_quantum=1)
    with pytest.raises(ValueError, match="shard >= 0"):
        FaultPlan("power_cap", at_quantum=1)
    with pytest.raises(ValueError, match="watts only applies"):
        FaultPlan("drain", at_quantum=1, shard=0, watts=150.0)
    with pytest.raises(ValueError, match="watts must be > 0"):
        FaultPlan("power_cap", at_quantum=1, shard=0, watts=0.0)
    p = FaultPlan("power_cap", at_quantum=1, shard=1, watts=120.0)
    assert p.shard == 1 and p.watts == 120.0
    assert FaultPlan("drain", at_quantum=0, shard=0).watts is None


def test_injector_admin_fires_schedule():
    inj = FaultInjector([
        FaultPlan("drain", at_quantum=2, shard=1),
        FaultPlan("power_cap", at_quantum=3, shard=0, watts=100.0),
        FaultPlan("decode_scan", at_quantum=2),
    ])
    assert inj.admin_fires(1) == []
    assert [p.site for p in inj.admin_fires(2)] == ["drain"]
    assert [p.site for p in inj.admin_fires(3)] == ["power_cap"]
    assert ("drain", 2) in inj.fired and ("power_cap", 3) in inj.fired
    inj.check("page_alloc", 2, 0)       # admin sites never raise here
    assert all(p.site not in ADMIN_SITES
               for p in FaultPlan.random(42, n=20, shards=4))
    with pytest.raises(ValueError, match="shards"):
        FaultPlan.random(1, sites=("drain",))
    assert all(p.site not in ADMIN_SITES
               for p in FaultPlan.random(1, n=6, admin=True))


def test_fault_plan_random_reproducible_and_valid():
    """Same seed, same campaign — the reference module's campaign too."""
    a = FaultPlan.random(42, n=10, max_quantum=8, max_count=3, shards=4)
    assert a == FaultPlan.random(42, n=10, max_quantum=8, max_count=3,
                                 shards=4)
    assert [dataclasses.astuple(p) for p in a] == [
        dataclasses.astuple(p) for p in JFaultPlan.random(
            42, n=10, max_quantum=8, max_count=3, shards=4)]
    assert len(a) == 10
    for p in a:
        assert 0 <= p.at_quantum <= 8
        if p.site == "shard_down":
            assert p.count == 1 and 0 <= p.shard < 4
        else:
            assert 1 <= p.count <= 3 and p.shard is None
    assert a != FaultPlan.random(43, n=10, max_quantum=8, max_count=3,
                                 shards=4)
    assert all(p.site != "shard_down" for p in FaultPlan.random(42, n=20))
    with pytest.raises(ValueError, match="shards"):
        FaultPlan.random(1, sites=("shard_down",))


def test_injector_shard_down_fires_schedule():
    inj = FaultInjector([
        FaultPlan("shard_down", at_quantum=2, shard=1),
        FaultPlan("shard_down", at_quantum=2, shard=0, absolute=True),
        FaultPlan("decode_scan", at_quantum=2),
    ])
    assert inj.shard_down_fires(1, run_start=0) == []
    assert inj.shard_down_fires(2, run_start=0) == [0, 1]
    assert inj.shard_down_fires(7, run_start=5) == [1]
    assert inj.fired.count(("shard_down", 2)) == 2
    inj.check("page_alloc", 2, 0)


def test_health_monitor_watchdog_contract():
    hm = HealthMonitor(3, max_retries=2)
    assert hm.live == [0, 1, 2]
    assert hm.record_fault([0, 1]) == []
    assert hm.record_fault([0, 1]) == []
    hm.record_ok([1])
    assert hm.record_fault([0, 1]) == [0]
    hm.declare_down(0, quantum=7)
    assert hm.is_dead(0) and hm.live == [1, 2]
    assert hm.record_fault([0, 1]) == []
    hm.declare_up(0, quantum=9)
    assert hm.live == [0, 1, 2] and hm.fails[0] == 0
    assert hm.events == [(7, "down", 0), (9, "up", 0)]
    with pytest.raises(ValueError, match="out of range"):
        hm.declare_down(3, quantum=0)
    with pytest.raises(ValueError, match="n_shards"):
        HealthMonitor(0)


# ---------------------------------------------------------------------------
# tests/test_server.py
# ---------------------------------------------------------------------------


def _served(go, max_steps=100_000, **kw):
    """``go(side, server)`` (a coroutine) on each package's server over a
    fresh engine of the suite's config (``kw`` on top); returns a drive for
    ``both``."""
    def drive(side, eng):
        srv = side.Server(eng, max_steps=max_steps)
        return asyncio.run(go(side, srv))
    return drive, dict(PREEMPT, **kw)


async def _after_quantum(srv, q):
    """Wait until the engine has started quantum ``q``: a submission made
    then lands right after that quantum, on either engine."""
    while srv.engine._quantum < q:
        await asyncio.sleep(0)


def test_tokens_stream_before_finish(sides):
    req = _reqs(np.random.default_rng(3), (0,), (10,), max_new=24)[0]
    want = _tokens(sides[1], [req], max_batch=4, max_len=64, sync_every=4,
                   paged=True, page_size=PS, prefill_chunk=CH)

    async def go(side, srv):
        await srv.submit(side.Request(**req))
        streamed, live = [], None
        async for tok in srv.stream(0):
            if live is None:
                live = not srv.engine.responses[0].finished
            streamed.append(tok)
        resp = await srv.result(0)
        await srv.drain()
        return streamed, live, resp

    drive, cfg = _served(go)
    _, _, _, (streamed, live, resp) = both(sides, drive, **cfg)
    assert streamed == want[0]
    assert live, "first token only surfaced after the request finished"
    assert resp.finished and resp.finish_reason in ("eos", "length")


def test_open_loop_submissions_token_parity(sides):
    """Requests submitted while others decode land between quanta; every
    stream equals the closed-loop oracle (arrivals keyed to quanta)."""
    reqs = _reqs(np.random.default_rng(4), (0, 1, 2), (8, 11, 6),
                 max_new=16)
    want = _oracle(sides[1], reqs)

    async def go(side, srv):
        await srv.submit(side.Request(**reqs[0]))

        async def late(req, q):
            await _after_quantum(srv, q)
            await srv.submit(side.Request(**req))
            return [t async for t in srv.stream(req["rid"])]

        first = [t async for t in srv.stream(0)]
        q0 = srv.engine._quantum
        got1, got2 = await asyncio.gather(late(reqs[1], q0),
                                          late(reqs[2], q0 + 3))
        await srv.drain()
        return {0: first, 1: got1, 2: got2}

    drive, cfg = _served(go)
    _, _, jgot, got = both(sides, drive, **cfg)
    assert got == jgot
    for rid in want:
        assert got[rid] == want[rid], f"request {rid} diverged"


def test_priority_preemption_through_server(sides):
    """A high-priority arrival through the async door (after quantum 6,
    the victims decoding) evicts a low-priority request; both equal the
    unpreempted oracle."""
    rng = np.random.default_rng(5)
    low = _reqs(rng, (0, 1), (10, 13), max_new=24)
    high = _reqs(rng, (2,), (6,), max_new=6, priority=1)
    want = _oracle(sides[1], low + high)

    async def go(side, srv):
        for r in low:
            await srv.submit(side.Request(**r))
        await _after_quantum(srv, 6)
        assert srv.engine.decoding > 0
        await srv.submit(side.Request(**high[0]))
        await srv.drain()
        return {rid: await srv.result(rid) for rid in (0, 1, 2)}

    drive, cfg = _served(go)
    _, eng, _, got = both(sides, drive, **cfg)
    assert eng.preemption_count >= 1
    for rid in want:
        assert got[rid].tokens == want[rid], f"request {rid} diverged"
    assert eng.stats()["preemption_count"] >= 1


def test_submit_validation_raises(sides):
    async def go(side, srv):
        with pytest.raises(ValueError, match="empty prompt"):
            await srv.submit(side.Request(rid=0, prompt=[],
                                          max_new_tokens=4))
        with pytest.raises(ValueError, match="max_new_tokens"):
            await srv.submit(side.Request(rid=1, prompt=[1],
                                          max_new_tokens=0))
        with pytest.raises(ValueError, match="exceeds max_len"):
            await srv.submit(side.Request(rid=2, prompt=[1] * 70,
                                          max_new_tokens=4))
        await srv.drain()

    drive, cfg = _served(go)
    both(sides, drive, **cfg)


def test_overload_shed_resolves_immediately(sides):
    reqs = _reqs(np.random.default_rng(6), range(6), [8] * 6, max_new=16)

    async def go(side, srv):
        shed = []
        for r in reqs:
            await srv.submit(side.Request(**r))
            if srv.engine.responses[r["rid"]].finish_reason == "shed":
                shed.append(r["rid"])
                done = await srv.result(r["rid"])     # resolves now
                assert done.finish_reason == "shed"
                assert [t async for t in srv.stream(r["rid"])] == []
        await srv.drain()
        return shed

    drive, cfg = _served(go, max_queue=2, shed_policy="reject_newest")
    _, eng, jshed, shed = both(sides, drive, **cfg)
    assert shed and shed == jshed, "queue bound never triggered a shed"
    st = eng.stats()
    assert st["shed_count"] == len(shed) and st["queue_depth"] == 0
    survivors = [r for r in eng.responses.values()
                 if r.finish_reason != "shed"]
    assert survivors and all(r.finished for r in survivors)


def test_deadline_expiry_cancels_queued_request(sides):
    """A queued request past its deadline (0.0: expired at the first
    sweep) is cancelled with reason 'deadline'; its stream ends empty."""
    blockers = _reqs(np.random.default_rng(7), (0, 1), (10, 12), max_new=24)

    async def go(side, srv):
        for r in blockers:
            await srv.submit(side.Request(**r))
        await srv.submit(side.Request(rid=2, prompt=[1, 2, 3],
                                      max_new_tokens=8, deadline_s=0.0))
        doomed = await srv.result(2)
        toks = [t async for t in srv.stream(2)]
        await srv.drain()
        return doomed.finish_reason, toks

    drive, cfg = _served(go)
    _, eng, _, (reason, toks) = both(sides, drive, **cfg)
    assert reason == "deadline" and toks == []
    assert eng.stats()["deadline_cancelled"] == 1
    assert eng.responses[0].finished and eng.responses[1].finished


def test_max_steps_timeout_marks_survivors(sides):
    reqs = _reqs(np.random.default_rng(8), (0, 1), (10, 40), max_new=48)

    async def go(side, srv):
        for r in reqs:
            await srv.submit(side.Request(**r))
        r0, r1 = await srv.result(0), await srv.result(1)
        await srv.drain()
        return r0, r1

    drive, cfg = _served(go, max_steps=3)
    _, _, _, (r0, r1) = both(sides, drive, **cfg)
    stranded = [r for r in (r0, r1) if r.finish_reason == "timeout"]
    assert stranded, "max_steps never stranded anything"
    assert all(not r.finished for r in stranded)


def test_transient_fault_invisible_to_clients(sides):
    req = _reqs(np.random.default_rng(9), (0,), (8,), max_new=12)[0]
    want = _oracle(sides[1], [req])

    async def go(side, srv):
        srv.engine.faults = side.Injector(
            [side.Plan("decode_scan", at_quantum=3, absolute=True)])
        await srv.submit(side.Request(**req))
        toks = [t async for t in srv.stream(0)]
        await srv.drain()
        return toks

    drive, cfg = _served(go)
    _, eng, _, toks = both(sides, drive, **cfg)
    assert eng.faults.fired and toks == want[0]


def test_retry_exhaustion_fails_loudly(sides):
    async def go(side, srv):
        srv.engine.faults = side.Injector(
            [side.Plan("page_alloc", at_quantum=0, count=1000,
                       absolute=True)])
        await srv.submit(side.Request(rid=0, prompt=[1, 2, 3],
                                      max_new_tokens=4))
        with pytest.raises(side.FaultError):
            await srv.drain()
        with pytest.raises(side.FaultError):
            await srv.result(0)
        toks = []
        with pytest.raises(side.FaultError):
            async for t in srv.stream(0):
                toks.append(t)
        assert srv.engine.responses[0].finish_reason == "error"
        assert toks == []
        with pytest.raises(side.FaultError):
            await srv.submit(side.Request(rid=1, prompt=[4],
                                          max_new_tokens=4))

    drive, cfg = _served(go, max_retries=1)
    both(sides, drive, **cfg)


def test_stats_expose_front_door_counters(sides):
    reqs = _reqs(np.random.default_rng(10), (0, 1, 2), (6, 9, 12),
                 max_new=8)

    async def go(side, srv):
        for r in reqs:
            await srv.submit(side.Request(**r))
        await srv.drain()
        return srv.stats()

    drive, cfg = _served(go)
    _, _, _, st = both(sides, drive, **cfg)
    for key in ("queue_depth", "shed_count", "preemption_count",
                "deadline_cancelled", "clamped_requests", "fault_retries",
                "timeout_requests", "preempted_recompute_j"):
        assert key in st, f"stats() missing {key}"
    assert st["queue_depth"] == 0
    assert st["queue_wait_p99_s_class_0"] >= 0.0
    assert "queue_wait_p50_s_class_0" in st


# ---------------------------------------------------------------------------
# tests/test_engine_admission.py
# ---------------------------------------------------------------------------
ADMIT = dict(max_batch=4, max_len=64, sync_every=8, paged=True, page_size=8)


def _run_all(reqs):
    def drive(side, eng):
        for r in reqs:
            side.submit(eng, **r)
        return {r.rid: r for r in eng.run()}
    return drive


def test_oversized_prompt_rejected_not_admitted(sides):
    reqs = [dict(rid=0, prompt=list(range(1, 41)), max_new_tokens=5),
            dict(rid=1, prompt=[1, 2, 3], max_new_tokens=5)]
    _, eng, _, got = both(sides, _run_all(reqs), **ADMIT, num_pages=4)
    assert got[0].rejected and got[0].finished and not got[0].tokens
    assert not got[1].rejected and len(got[1].tokens) == 5
    assert eng.prefill_batches == 1
    assert eng.free_pages == eng.num_pages


def test_request_waits_for_free_pages_then_completes(sides):
    rng = np.random.default_rng(0)
    reqs = [dict(rid=i, prompt=rng.integers(0, 256, 10).tolist(),
                 max_new_tokens=8) for i in range(4)]
    _, eng, _, got = both(sides, _run_all(reqs), **ADMIT, num_pages=6)
    assert all(not r.rejected and r.finished and len(r.tokens) == 8
               for r in got.values())
    assert eng.stats()["peak_pages_reserved"] <= 6
    assert eng.free_pages == eng.num_pages


def test_fcfs_no_overtaking_under_pressure(sides):
    reqs = [dict(rid=0, prompt=list(range(1, 31)), max_new_tokens=10),
            dict(rid=1, prompt=list(range(1, 25)), max_new_tokens=10),
            dict(rid=2, prompt=[1, 2], max_new_tokens=2)]
    _, eng, _, got = both(sides, _run_all(reqs), **ADMIT, num_pages=8)
    assert all(r.finished and not r.rejected for r in got.values())
    assert eng.stats()["peak_active"] <= 2


def test_decode_budget_past_max_len_rejected_in_paged_mode(sides):
    reqs = [dict(rid=0, prompt=[1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=64),
            dict(rid=1, prompt=[1, 2, 3], max_new_tokens=4)]
    _, _, _, got = both(sides, _run_all(reqs), **dict(ADMIT, max_len=32))
    assert got[0].rejected and not got[0].tokens
    assert got[1].finished and len(got[1].tokens) == 4
    # the contiguous engine still serves it (its ring keeps the last W)
    _, _, _, cgot = both(sides, _run_all(reqs[:1]), max_batch=4, max_len=32)
    assert cgot[0].finished and len(cgot[0].tokens) == 64


def test_prompt_exactly_at_capacity_is_admitted(sides):
    reqs = [dict(rid=0, prompt=list(range(1, 33)), max_new_tokens=9)]
    _, eng, _, got = both(sides, _run_all(reqs), **ADMIT, num_pages=5)
    assert got[0].finished and not got[0].rejected
    assert len(got[0].tokens) == 9
    assert eng.free_pages == eng.num_pages


def test_rate_limit_hard_budget_sheds_over_quota(sides):
    """refill 0: a hard budget of ``capacity`` submissions per tenant."""
    def drive(side, eng):
        for i in range(4):
            side.submit(eng, rid=i, prompt=[1, 2, 3], max_new_tokens=4,
                        tenant="acme")
        for i in range(4, 6):          # unknown tenant: the "*" bucket
            side.submit(eng, rid=i, prompt=[1, 2, 3], max_new_tokens=4,
                        tenant="zorg")
        side.submit(eng, rid=9, prompt=[1, 2, 3], max_new_tokens=4)
        shed = sorted(r.rid for r in eng.responses.values()
                      if r.finish_reason == "rate_limited")
        return shed, {r.rid: r for r in eng.run()}

    _, eng, _, (shed, got) = both(
        sides, drive, **ADMIT,
        tenant_quota={"acme": (2, 0.0), "*": (1, 0.0)})
    assert shed == [2, 3, 5]
    assert all(got[r].finished and not got[r].tokens for r in shed)
    assert eng.stats()["rate_limited"] == 3
    for rid in (0, 1, 4, 9):
        assert got[rid].finished and len(got[rid].tokens) == 4


def test_rate_limit_bucket_refills_over_wall_clock(sides):
    """Continuous refill: after the bucket drains, 50 tokens/s x 0.05 s of
    wall clock (``time.sleep``, as the reference) restores admission."""
    def drive(side, eng):
        side.submit(eng, rid=0, prompt=[1, 2], max_new_tokens=2,
                    tenant="acme")
        side.submit(eng, rid=1, prompt=[1, 2], max_new_tokens=2,
                    tenant="acme")
        assert eng.responses[1].finish_reason == "rate_limited"
        time.sleep(0.05)
        side.submit(eng, rid=2, prompt=[1, 2], max_new_tokens=2,
                    tenant="acme")
        assert eng.responses[2].finish_reason != "rate_limited"
        return {r.rid: r for r in eng.run()}

    _, eng, _, _ = both(sides, drive, **ADMIT,
                        tenant_quota={"acme": (1, 50.0)})
    assert eng.stats()["rate_limited"] == 1


@pytest.mark.parametrize("quota,match", [({"a": (0, 1.0)}, "capacity"),
                                         ({"a": (1, -1.0)}, "refill")])
def test_tenant_quota_validation(sides, quota, match):
    msgs = []
    for side in sides:
        with pytest.raises(ValueError, match=match) as e:
            side.engine(**ADMIT, tenant_quota=quota)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the whole front door at once (``chip_smoke.py``'s smoke trace)
# ---------------------------------------------------------------------------


def test_frontdoor_trace_matches_reference(sides):
    """Every front-door path in one served trace, as ``chip_smoke.py``
    drives it on the card: wave A (class 0) at once — tenant "acme" over a
    (2, 0) quota (rid 4 rate limited), rid 1 with deadline 0.0, the
    bounded queue (6, reject_lowest) shedding rid 7 as it arrives — then
    wave B (class 1) after quantum 8, preempting, its last arrival
    displacing the newest class-0 request waiting (rid 6); one fault at
    each launch site. The engines agree; the planned counters hold."""
    rng = np.random.default_rng(9)
    system = rng.integers(2, 256, 32).tolist()
    prompts = [system + rng.integers(2, 256, int(n)).tolist()
               if i % 2 == 0 else rng.integers(2, 256, int(n)).tolist()
               for i, n in enumerate([9, 20, 3, 14, 25, 6, 11, 17,
                                      5, 12, 7, 30, 9, 4])]
    reqs = [dict(rid=rid, prompt=p, max_new_tokens=20,
                 priority=0 if rid < 8 else 1,
                 tenant="acme" if rid in (2, 3, 4) else None,
                 deadline_s=0.0 if rid == 1 else None)
            for rid, p in enumerate(prompts)]

    async def go(side, srv):
        srv.engine.faults = side.Injector([
            side.Plan("page_alloc", 1, absolute=True),
            side.Plan("prefill_chunk", 4, absolute=True),
            side.Plan("decode_scan", 11, absolute=True)])
        for r in reqs[:8]:
            await srv.submit(side.Request(**r))
        await _after_quantum(srv, 8)
        for r in reqs[8:]:
            await srv.submit(side.Request(**r))
        await srv.drain()

    drive, cfg = _served(go, max_len=128, max_batch=4, page_size=16,
                         prefill_chunk=16, prefill_pack=2, max_queue=6,
                         shed_policy="reject_lowest", pressure_clamp=8,
                         tenant_quota={"acme": (2, 0.0)}, max_retries=3)
    _, eng, _, _ = both(sides, drive, checked=True, **cfg)
    st = eng.stats()
    assert {k: st[k] for k in ("shed_count", "rate_limited",
                               "deadline_cancelled", "fault_retries")} == \
        dict(shed_count=2, rate_limited=1, deadline_cancelled=1,
             fault_retries=3)
    assert st["preemption_count"] >= 1
    reasons = {rid: r.finish_reason for rid, r in eng.responses.items()}
    assert (reasons[1], reasons[4], reasons[6], reasons[7]) == (
        "deadline", "rate_limited", "shed", "shed")
    assert sorted(s for s, _ in eng.faults.fired) == [
        "decode_scan", "page_alloc", "prefill_chunk"]
