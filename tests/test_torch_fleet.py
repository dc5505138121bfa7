"""The port's ``ShardedServingEngine`` against the JAX fleet, case for case:
the reference's ``tests/test_sharded_parity.py`` (9),
``tests/test_hetero_routing.py`` (10), ``tests/test_sharded_preemption.py``
(5 functions, 7 cases), the cases of ``tests/test_shard_loss.py`` that
need no shard loss (``test_launch_faults_under_carbon_routing``,
``test_faults_during_deferral_release`` and the reservation-mirror half of
``test_audit_catches_corruption``), ``test_sharded_engine_stats_match_
documented_keys`` of ``tests/test_methodology_contract.py``, and
``tests/test_scheduler.py`` on the port's copy of ``core/scheduler.py``.
The rest of ``tests/test_shard_loss.py`` and all of
``tests/test_migration.py`` (shard loss, rejoin, drain, power caps, live
migration) are held in ``tests/test_torch_fleet_admin.py``, which imports
this file's ``Side``, ``result`` and ``agree``.

The JAX fleet needs one host device per shard, and ``XLA_FLAGS`` must be
set before the first jax import of a process, so every JAX fleet scenario
runs in ONE subprocess per module: this file run as a script
(``python tests/test_torch_fleet.py OUT.json`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), which writes each
scenario's result as JSON. Meanwhile the module fixture runs the same
scenario functions on the port's fleet in this process, with the oracle
where the reference test has one: the JAX single paged engine, run here
(it needs one device). A scenario serves its trace and returns tokens,
finish reasons,
the shard each request ran on, every ``stats()`` key that is not a
wall-clock reading, per-shard modeled J and gCO2 and the checks it made
on the way (the reference's pin-aware allocator invariants every quantum,
a whole pool at the end). The port must equal the JAX fleet on all of it
(numbers to 1e-12 relative), and keep each reference test's own
assertions.

The reference's model of those suites (2 dense layers, d_model 64, 8
query heads on 2 kv heads, vocab 256, float32) from ``Model.init(
PRNGKey(0))``, converted by ``models/convert.params_from_jax``. The
reference tests draw prompts from a module-level generator shared across
tests; each scenario here seeds its own.

A ``moe`` model's fleet (``moe_per_shard``): Maverick smoke with full
attention (the reference's paged gate excludes chunk-local attention) at
capacity factor 1, 4 shards of 8 slots, where each shard's decode step
(8 tokens) and chunk launch (one lane of 8) can drop no token while the
32 rows of a step pooled over the fleet can. It must equal the JAX fleet,
whose ``shard_map`` body runs ``moe_ffn`` on each shard's rows, and give
other tokens with the port's capacity pooled across the shards.

One trace is held to the unshared engine instead of the JAX fleet: whole-
prompt adopters that wait through a decode chunk (``adopters``). The JAX
fleet decodes with ``freeze_inactive=True``, which writes such a parked
slot's next row into the page it shares with its donor (ROADMAP Queue 3);
the port routes that write to the trash page.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

PS = 8                                 # parity / hetero suites
CH = 8
S = 4
PRE_PS = 4                             # preemption / shard-loss suites
PRE_S = 2
TINY = dict(name="tiny-fleet", family="dense", n_layers=2, d_model=64,
            n_heads=8, n_kv_heads=2, d_ff=128, vocab=256, dtype="float32",
            vocab_pad_multiple=8)
WALL_CLOCK = ("queue_wait_",)
PHASES = ("prefill", "decode", "recompute")
NUMERIC = ("stats", "energy_j", "phase_j", "phase_tok", "fleet_phase_j")
LENS = (3, 5, 8, 11, 16, 21, 4, 30, 6, 13, 9, 18)
HET_PROFILES = ("rtx6000ada", "t4", "rtx6000ada", "t4")
HET_REGIONS = ("CISO", "QC", "PACE", "QC")
HET2 = dict(routing="carbon", shard_profiles=("rtx6000ada", "t4"),
            shard_regions=("CISO", "QC"))
DAYS = {"day_qc_pace": (("t4", "rtx6000ada", "t4", "rtx6000ada"),
                        ("QC", "PACE", "QC", "PACE")),
        "day_ciso": (("t4", "rtx6000ada", "t4", "rtx6000ada"),
                     ("CISO", "CISO", "CISO", "CISO"))}


class Side:
    """One package's serving API over the same model and parameters."""

    def __init__(self, name, jparams=None, oracle=None):
        import jax
        self.name = name
        # the single paged engine's runner for the oracle runs (the JAX
        # engine, in the test process); None in the subprocess
        self.oracle = oracle
        if name == "jax":
            from repro.core.scheduler import CIDirectedScheduler
            from repro.models import Model, ModelConfig
            from repro.models.config import repeat_pattern
            from repro.serving import (EngineConfig, FaultInjector,
                                       FaultPlan, Request, ServingEngine,
                                       ShardedServingEngine)
            self.model = Model(ModelConfig(
                **TINY, block_pattern=repeat_pattern(("dense",), 2)))
            self.params = self.model.init(jax.random.PRNGKey(0))
            self.kw = {}
            self.alloc = lambda eng: {
                k: np.asarray(v)
                for k, v in jax.device_get(eng.caches["paged"]).items()}
        else:
            from repro_torch.core.scheduler import CIDirectedScheduler
            from repro_torch.models import Model
            from repro_torch.models.config import ModelConfig, repeat_pattern
            from repro_torch.models.convert import params_from_jax
            from repro_torch.serving import (EngineConfig, FaultInjector,
                                             FaultPlan, Request,
                                             ServingEngine,
                                             ShardedServingEngine)
            cfg = ModelConfig(**TINY,
                              block_pattern=repeat_pattern(("dense",), 2))
            self.model = Model(cfg, "cpu")
            self.params = params_from_jax(
                jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
            self.kw = dict(device="cpu")
            self.alloc = lambda eng: {k: v.cpu().numpy()
                                      for k, v in eng.caches["paged"].items()}
        self.Config, self.Request = EngineConfig, Request
        self.Single, self.Fleet = ServingEngine, ShardedServingEngine
        self.Injector, self.Plan = FaultInjector, FaultPlan
        self.Scheduler = CIDirectedScheduler

    def fleet(self, checked=False, **kw):
        args = dict(max_batch=2, max_len=64, sync_every=8, paged=True,
                    page_size=PS, prefill_chunk=CH, shards=S)
        args.update(kw)
        eng = self.Fleet(self.model, self.params, self.Config(**args),
                         **self.kw)
        if checked:
            step = eng.step

            def checked_step(max_steps=10_000):
                ran = step(max_steps)
                check_alloc(self, eng)
                return ran

            eng.step = checked_step
        return eng

    def own_single(self, reqs, **kw):
        """This package's single paged engine over ``reqs``."""
        args = dict(max_batch=4, max_len=64, sync_every=8, paged=True,
                    page_size=PS, prefill_chunk=CH)
        args.update(kw)
        eng = self.Single(self.model, self.params, self.Config(**args),
                          **self.kw)
        for r in reqs:
            eng.submit(self.Request(**r))
        eng.run()
        return eng

    def single(self, reqs, **kw):
        """The oracle's tokens over ``reqs`` (None without an oracle)."""
        if self.oracle is None:
            return None
        return {str(k): r.tokens
                for k, r in self.oracle.own_single(reqs, **kw)
                .responses.items()}

    def submit(self, eng, reqs):
        for r in reqs:
            eng.submit(self.Request(**r))


def check_alloc(side, eng):
    """The reference's ``CheckedFleet.check_alloc``: per shard, refcounts
    == table mappings + pins, and page conservation."""
    a = side.alloc(eng)
    tbl, top, ref = a["tbl"], a["top"], a["ref"]
    P = ref.shape[1]
    for s in range(eng.S):
        counts = np.zeros((P,), int)
        for row in tbl[s]:
            for p in row[row >= 0]:
                counts[p] += 1
        for pin_s, pages in eng._pins.values():
            if pin_s == s:
                for p in pages:
                    counts[p] += 1
        assert (ref[s] == counts).all(), f"shard {s}: refcounts"
        assert int(top[s]) + int((counts > 0).sum()) == P, \
            f"shard {s}: page conservation"


def pool_clean(side, eng):
    """Every shard's allocator pristine and the host mirrors exact."""
    a = side.alloc(eng)
    P = a["free"].shape[1]
    return bool(all(int(a["top"][s]) == P and (a["tbl"][s] == -1).all()
                    and (a["ref"][s] == 0).all()
                    and sorted(a["free"][s].tolist()) == list(range(P))
                    for s in range(eng.S))
                and eng.free_pages == [eng.num_pages] * eng.S
                and not eng._pins)


def result(side, eng, **extra):
    """What the two fleets must agree on, JSON-ready."""
    resp = eng.responses
    return {
        "tokens": {str(k): r.tokens for k, r in resp.items()},
        "reason": {str(k): r.finish_reason for k, r in resp.items()},
        "finished": {str(k): r.finished for k, r in resp.items()},
        "rejected": {str(k): r.rejected for k, r in resp.items()},
        "preemptions": {str(k): r.preemptions for k, r in resp.items()},
        "energy_j": {str(k): r.energy_j for k, r in resp.items()},
        "shard": {str(k): int(v) for k, v in eng._req_shard.items()},
        "stats": {k: float(v) for k, v in eng.stats().items()
                  if not k.startswith(WALL_CLOCK)},
        "shard_j": [m.totals.energy_j for m in eng.meters],
        "shard_g": [m.totals.total_g for m in eng.meters],
        "phase_j": {ph: [m.phase(ph).energy_j for m in eng.meters]
                    for ph in PHASES},
        "phase_tok": {ph: [m.phase(ph).tokens for m in eng.meters]
                      for ph in PHASES},
        "fleet_phase_j": {ph: eng.meter.phase(ph).energy_j
                          for ph in PHASES},
        "free_pages": list(eng.free_pages),
        "peak_pages_reserved": list(eng.peak_pages_reserved),
        "pool_clean": pool_clean(side, eng),
        "faults": [list(f) for f in eng.faults.fired] if eng.faults else [],
        **extra,
    }


def _reqs(seed, lens, max_new=9, **kw):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[int(t) for t in rng.integers(0, 256, int(n))],
                 max_new_tokens=max_new, **kw)
            for i, n in enumerate(lens)]


def _pre_reqs(seed, rids, lens, max_new=16, **kw):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid, prompt=[int(t) for t in rng.integers(0, 256, n)],
                 max_new_tokens=max_new, **kw)
            for rid, n in zip(rids, lens)]


def serve(side, reqs, checked=False, **kw):
    eng = side.fleet(checked=checked, **kw)
    side.submit(eng, reqs)
    eng.run()
    return eng


# ---------------------------------------------------------------- scenarios
# name -> function(side) -> JSON-ready dict; run on the JAX fleet in the
# subprocess and on the port's fleet here

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def mid_stream(side):
    reqs = _reqs(7, LENS)
    return {"fleet": result(side, serve(side, reqs)),
            "single": side.single(reqs)}


@scenario
def uneven(side):
    reqs = _reqs(11, (10,) * 5, max_new=12)
    return {"fleet": result(side, serve(side, reqs)),
            "single": side.single(reqs)}


@scenario
def budget_eos(side):
    probe = side.own_single([dict(rid=0, prompt=[9, 8, 7, 6, 5],
                                  max_new_tokens=12)])
    eos = probe.responses[0].tokens[4]
    reqs = [dict(rid=0, prompt=[9, 8, 7, 6, 5], max_new_tokens=12,
                 eos_id=eos),
            dict(rid=1, prompt=[1, 2, 3], max_new_tokens=5),
            dict(rid=2, prompt=[4, 4, 4, 4], max_new_tokens=20),
            dict(rid=3, prompt=list(range(1, CH + 4)), max_new_tokens=1)]
    return {"fleet": result(side, serve(side, reqs)),
            "single": side.single(reqs)}


@scenario
def never_fits(side):
    reqs = [dict(rid=0, prompt=list(range(1, 63)), max_new_tokens=5),
            dict(rid=1, prompt=[1, 2, 3], max_new_tokens=5)]
    return {"fleet": result(side, serve(side, reqs)),
            "single": side.single(reqs)}


@scenario
def layout(side):
    reqs = _reqs(3, (6, 9, 12, 5, 17))
    return {"fleet": result(side, serve(side, reqs)),
            "single": side.single(reqs)}


@scenario
def syncs(side):
    lens = np.random.default_rng(5).integers(4, 20, 16)
    reqs = _reqs(5, lens, max_new=17)
    single = side.own_single(reqs[:4])
    return {"fleet": result(side, serve(side, reqs)),
            "single": {str(k): r.tokens
                       for k, r in single.responses.items()},
            "single_syncs": single.host_syncs}


@scenario
def prefix_local(side):
    rng = np.random.default_rng(13)
    common = [int(t) for t in rng.integers(0, 256, 2 * PS)]
    reqs = [dict(rid=i, prompt=common + [int(t) for t in
                                         rng.integers(0, 256, 3)],
                 max_new_tokens=(24 if i == 0 else 6)) for i in range(6)]
    eng = serve(side, reqs, max_batch=2, shards=2, sync_every=4,
                prefix_sharing=True)
    index_empty = all(not eng._prefix_index[s] and not eng._page_ref[s]
                      for s in range(eng.S))
    return {"fleet": result(side, eng, index_empty=index_empty),
            "single": side.single(reqs)}


@scenario
def steering(side):
    rng = np.random.default_rng(17)
    common = [int(t) for t in rng.integers(0, 256, 2 * PS)]
    donor = dict(rid=0, prompt=common + [7, 7, 7], max_new_tokens=40)
    follower = dict(rid=1, prompt=common + [3, 3, 3], max_new_tokens=6)
    eng = side.fleet(max_batch=2, sync_every=4, shards=2,
                     prefix_sharing=True)
    side.submit(eng, [donor])
    eng.run(max_steps=4)               # prefill + one chunk: donor active
    active = eng.active
    side.submit(eng, [follower])
    eng.run()
    return {"fleet": result(side, eng, active_after_warmup=active),
            "single": side.single([donor, follower])}


@scenario
def het_carbon(side):
    return {"fleet": result(side, serve(
        side, _reqs(7, LENS), shard_profiles=HET_PROFILES,
        shard_regions=HET_REGIONS, routing="carbon"))}


@scenario
def homog_carbon(side):
    return {"fleet": result(side, serve(side, _reqs(7, LENS),
                                        routing="carbon"))}


@scenario
def meters_sum(side):
    return {"fleet": result(side, serve(
        side, _reqs(3, LENS), shard_profiles=HET_PROFILES,
        shard_regions=HET_REGIONS, routing="carbon"))}


@scenario
def jpt(side):
    het = dict(shard_profiles=HET_PROFILES, shard_regions=HET_REGIONS)
    return {routing: result(side, serve(side, _reqs(5, (12,) * 10,
                                                    max_new=7),
                                        routing=routing, **het))
            for routing in ("free_pages", "carbon")}


@scenario
def low_ci(side):
    rng = np.random.default_rng(9)
    eng = side.fleet(shard_profiles=HET_PROFILES, shard_regions=HET_REGIONS,
                     routing="carbon")
    placed = []
    for i in range(6):
        side.submit(eng, [dict(rid=i, prompt=[int(t) for t in
                                              rng.integers(0, 256, 10)],
                               max_new_tokens=5)])
        eng.run()
        placed.append(eng._req_shard[i])
    return {"fleet": result(side, eng), "placed": placed}


@scenario
def slo(side):
    out = {}
    for name, slo_s in (("unpinned", None), ("pinned", 10.0)):
        rng = np.random.default_rng(21)
        eng = side.fleet(shard_profiles=HET_PROFILES,
                         shard_regions=HET_REGIONS, routing="carbon")
        side.submit(eng, [dict(rid=i, prompt=[int(t) for t in
                                              rng.integers(0, 256, 10)],
                               max_new_tokens=5, slo_s=slo_s)
                          for i in range(S)])
        eng.run()
        out[name] = result(side, eng,
                           placed=[eng._req_shard[i] for i in range(S)])
    return out


def _day(side, profiles, regions):
    eng = side.fleet(routing="carbon", use_diurnal_ci=True,
                     shard_profiles=profiles, shard_regions=regions)
    uniq = {}
    for sl in eng._slices:
        uniq.setdefault(sl.key, sl)
    sched = side.Scheduler(list(uniq.values()), eng.workload,
                           phase="prompt", batch=1)
    day = sched.simulate_day(requests_per_hour=60.0, hours=24)
    live = []
    for h in range(24):
        eng.clock.hours = float(h)
        placed = eng._place(side.Request(rid=1000 + h,
                                         prompt=list(range(45)),
                                         max_new_tokens=8))
        live.append(eng._slices[placed[0]].key)
    return {"live": live, "offline": list(day["choices"]),
            "total_g": float(day["total_g"])}


@scenario
def day_qc_pace(side):
    return _day(side, *DAYS["day_qc_pace"])


@scenario
def day_ciso(side):
    return _day(side, *DAYS["day_ciso"])


PRE = dict(max_batch=2, sync_every=4, page_size=PRE_PS, shards=PRE_S,
           preemption=True, prefix_sharing=True)


def _oracle(side, reqs):
    return side.single(reqs, max_batch=max(8, len(reqs)), sync_every=4,
                       page_size=PRE_PS)


def _preempted(side, low, high, warmup=6, faults=None):
    eng = side.fleet(checked=True, **PRE)
    if faults:
        eng.faults = side.Injector([side.Plan(site, at_quantum=q)
                                    for site, q in faults])
    side.submit(eng, low)
    for _ in range(warmup):
        eng.step()
    decoding = eng.decoding
    side.submit(eng, [{"priority": 1, **r} for r in high])
    eng.run()
    return result(side, eng, decoding_after_warmup=decoding,
                  prefix_hit_tokens=eng.prefix_hit_tokens)


@scenario
def pre_parity(side):
    low = _pre_reqs(31, (0, 1, 2, 3), (10, 13, 9, 11), max_new=24)
    high = _pre_reqs(32, (4, 5), (6, 5), max_new=6)
    return {"fleet": _preempted(side, low, high),
            "single": _oracle(side, low + high)}


@scenario
def pre_shared(side):
    common = [int(t) for t in np.random.default_rng(33).integers(0, 256, 8)]
    low = [dict(rid=0, prompt=common + [7, 8, 9], max_new_tokens=40),
           dict(rid=1, prompt=common + [1, 2, 3, 4], max_new_tokens=40),
           dict(rid=2, prompt=common + [5, 6], max_new_tokens=40),
           dict(rid=3, prompt=common + [2, 2, 2], max_new_tokens=40)]
    high = _pre_reqs(34, (4,), (6,), max_new=6)
    return {"fleet": _preempted(side, low, high),
            "single": _oracle(side, low + high)}


@scenario
def pre_no_cross(side):
    low = _pre_reqs(35, (0, 1), (8, 9), max_new=16)
    high = dict(rid=2, prompt=[1, 2, 3], max_new_tokens=4)
    eng = side.fleet(checked=True, **PRE)
    side.submit(eng, low)
    for _ in range(5):
        eng.step()
    side.submit(eng, [dict(high, priority=1)])
    eng.run()
    return {"fleet": result(side, eng),
            "single": _oracle(side, low + [high])}


FAULT_CASES = (("page_alloc", 1), ("prefill_chunk", 2), ("decode_scan", 4))


def _fault_runs(side, site, at):
    reqs = _pre_reqs(36, (0, 1, 2), (6, 9, 12), max_new=8)
    out = {}
    for name, plans in (("clean", []), ("faulted", [(site, at)])):
        eng = side.fleet(**dict(PRE, preemption=False))
        eng.faults = side.Injector([side.Plan(s, at_quantum=q)
                                    for s, q in plans])
        side.submit(eng, reqs)
        eng.run()
        out[name] = result(side, eng)
    return out


for _site, _at in FAULT_CASES:
    SCENARIOS[f"fault_{_site}"] = (
        lambda side, _site=_site, _at=_at: _fault_runs(side, _site, _at))


@scenario
def fault_preempt(side):
    low = _pre_reqs(37, (0, 1, 2, 3), (10, 8, 11, 9), max_new=24)
    high = _pre_reqs(38, (4,), (5,), max_new=4)
    return {"fleet": _preempted(side, low, high,
                                faults=[("decode_scan", 2)]),
            "single": _oracle(side, low + [dict(priority=1, **h)
                                           for h in high])}


LOSS = dict(max_batch=2, sync_every=4, page_size=PRE_PS, shards=PRE_S,
            preemption=True, prefix_sharing=True)


def _audited(side, **kw):
    eng = side.fleet(**dict(LOSS, **kw))
    step = eng.step

    def audited_step(max_steps=10_000):
        ran = step(max_steps)
        eng.audit()
        return ran

    eng.step = audited_step
    return eng


@scenario
def faults_carbon(side):
    specs = _pre_reqs(41, range(5), (5, 9, 14, 7, 11), max_new=12)
    out = {}
    for name, plans in (("clean", []),
                        ("faulted", [("page_alloc", 1, 1),
                                     ("prefill_chunk", 2, 2),
                                     ("decode_scan", 5, 1)])):
        eng = _audited(side, **HET2)
        eng.faults = side.Injector([side.Plan(s, at_quantum=q, count=c)
                                    for s, q, c in plans])
        side.submit(eng, specs)
        eng.run()
        eng.audit()
        out[name] = result(side, eng)
    return out


@scenario
def faults_deferral(side):
    eng = _audited(side, defer_below_priority=1, use_diurnal_ci=True)
    eng.faults = side.Injector([side.Plan("prefill_chunk", at_quantum=1,
                                          count=2),
                                side.Plan("decode_scan", at_quantum=4)])
    urgent = _pre_reqs(42, (0, 1), (6, 9), max_new=8, priority=1)
    parked = _pre_reqs(43, (10, 11, 12), (7, 5, 10), max_new=6)
    side.submit(eng, urgent + parked)
    eng.run()
    eng.audit()
    return {"fleet": result(side, eng, deferred_left=len(eng.deferred),
                            deferred_rids_left=len(eng.deferred_rids),
                            clock_hours=eng.clock.hours)}


@scenario
def audit_run(side):
    eng = _audited(side)
    side.submit(eng, _pre_reqs(44, range(2), (6, 9), max_new=12))
    eng.run()
    eng.audit()
    return {"fleet": result(side, eng)}


@scenario
def stats_keys(side):
    rng = np.random.default_rng(11)
    reqs = [dict(rid=i, prompt=[int(t) for t in
                                rng.integers(0, 256, 12 + 4 * i)],
                 max_new_tokens=6, priority=i % 2) for i in range(4)]
    eng = side.fleet(max_batch=4, sync_every=4, prefix_sharing=True)
    side.submit(eng, reqs)
    eng.run()
    return {"fleet": result(side, eng)}


@scenario
def adopters(side):
    """Whole-prompt twins of a resident donor wait mid-prefill (one
    copy-on-write row a launch) while decode chunks run."""
    rng = np.random.default_rng(21)
    donor = [int(t) for t in rng.integers(2, 256, 2 * PS)]
    long_prompt = [int(t) for t in rng.integers(2, 256, 6 * CH)]
    eng = side.fleet(max_batch=4, sync_every=4, prefix_sharing=True)
    side.submit(eng, [dict(rid=0, prompt=list(donor), max_new_tokens=6),
                      dict(rid=1, prompt=list(long_prompt),
                           max_new_tokens=4)])
    eng.run(max_steps=2)               # donor registered + decoding
    twins = [dict(rid=rid, prompt=list(donor), max_new_tokens=3)
             for rid in (2, 3)]
    side.submit(eng, twins)
    eng.run()
    reqs = [dict(rid=0, prompt=list(donor), max_new_tokens=6),
            dict(rid=1, prompt=list(long_prompt), max_new_tokens=4)] + twins
    return {"fleet": result(side, eng,
                            shared=eng.prefix_shared_requests),
            "single": side.single(reqs)}


MOE_ARCH = "llama4-maverick-400b-a17b"
MOE_CF = 1.0
MOE_FLEET = dict(max_batch=8, max_len=64, sync_every=8, paged=True,
                 page_size=PS, prefill_chunk=CH, shards=S)
MOE_LENS = (5, 12, 3, 20, 9, 16, 7, 25, 4, 11, 14, 6, 18, 10, 8, 13, 22, 3,
            15, 9)


def moe_model(side):
    """(model, params) of Maverick smoke with full attention at
    ``MOE_CF``, made once a side: the JAX package's from PRNGKey(0), the
    port's converted from the oracle's."""
    if getattr(side, "_moe", None) is None:
        import dataclasses
        import jax
        if side.name == "jax":
            from repro.configs import get_config
            from repro.models import Model
        else:
            from repro_torch.configs import get_config
            from repro_torch.models import Model
            from repro_torch.models.convert import params_from_jax
        cfg = get_config(MOE_ARCH, "smoke")
        cfg = dataclasses.replace(
            cfg, attn_chunk=None, global_attn_every=0,
            moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_CF))
        if side.name == "jax":
            model = Model(cfg)
            params = model.init(jax.random.PRNGKey(0))
        else:
            model = Model(cfg, "cpu")
            params = params_from_jax(jax.tree_util.tree_map(
                np.asarray, moe_model(side.oracle)[1]), cfg, "cpu")
        side._moe = (model, params)
    return side._moe


@scenario
def moe_per_shard(side):
    """20 requests over 4 shards of 8 slots, 10 new tokens each; on the
    port also with the capacity pooled (the forward's rows one group)."""
    model, params = moe_model(side)
    reqs = _reqs(33, MOE_LENS, max_new=10)

    def run():
        eng = side.Fleet(model, params, side.Config(**MOE_FLEET), **side.kw)
        side.submit(eng, reqs)
        eng.run()
        return eng

    out = {"fleet": result(side, run())}
    if side.name == "torch":
        from repro_torch.models import Model
        grouped = Model.grouped
        Model.grouped = lambda self, groups: self        # one group
        try:
            out["pooled"] = result(side, run())["tokens"]
        finally:
            Model.grouped = grouped
    return out


# ----------------------------------------------------------------- fixtures


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model's ops are far below what a
    second thread pays for, and test workers share the host's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def side():
    """The port's side; its oracle is the JAX single paged engine, run in
    this process (one host device is enough for it)."""
    oracle = Side("jax")
    return Side("torch", oracle.params, oracle)


@pytest.fixture(scope="module")
def runs(side, tmp_path_factory):
    """{scenario: (JAX fleet result, port result)}. The JAX fleet runs in a
    subprocess with four forced host devices while the port's scenarios
    run here; a scenario that raised on the port's side is re-raised by
    the test that reads it."""
    out = tmp_path_factory.mktemp("jax_fleet") / "jax_fleet.json"
    env = dict(os.environ)
    # one thread a device: the scenarios' programs are tiny
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        mine = {}
        for name, fn in SCENARIOS.items():
            try:
                mine[name] = json.loads(json.dumps(fn(side)))
            except Exception as e:     # re-raised by the reading test
                mine[name] = e
        log, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    with open(out) as f:
        theirs = json.load(f)
    return {name: (theirs[name], mine[name]) for name in SCENARIOS}


def pair(runs, name):
    want, got = runs[name]
    if isinstance(got, Exception):
        raise got
    return want, got


def agree(want, got):
    """The port's fleet result equals the JAX fleet's: every key exact,
    numbers to 1e-12 relative."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key in NUMERIC:
            assert set(g) == set(w), key
            for k, v in w.items():
                assert g[k] == pytest.approx(v, rel=1e-12, abs=0.0), (key, k)
        elif key in ("shard_j", "shard_g", "total_g"):
            assert g == pytest.approx(w, rel=1e-12, abs=0.0), key
        else:
            assert g == w, key


def assert_oracle(fleet, single):
    for rid, toks in single.items():
        assert fleet["tokens"][rid] == toks, f"request {rid} diverged"


# ------------------------------------------------- tests/test_sharded_parity


def test_mid_stream_admission_token_for_token(runs):
    """More requests than fleet slots (12 > 4 shards x 2): later requests
    admit mid-stream onto whichever shard frees pages first. Both fleets
    agree, every token equals the single paged engine's."""
    want, got = pair(runs, "mid_stream")
    agree(want["fleet"], got["fleet"])
    assert_oracle(got["fleet"], got["single"])
    st = got["fleet"]["stats"]
    assert st["peak_active"] > S and st["requests"] == 12
    assert got["fleet"]["pool_clean"]


def test_uneven_shard_occupancy(runs):
    """5 equal requests over 4 shards of 2 slots: placement doubles one
    shard up while the rest hold one."""
    want, got = pair(runs, "uneven")
    agree(want["fleet"], got["fleet"])
    peaks = got["fleet"]["peak_pages_reserved"]
    assert max(peaks) > min(peaks), "placement never doubled a shard up"
    assert got["fleet"]["pool_clean"]


def test_budget_death_and_eos_mid_chunk(runs):
    """Slots dying mid-chunk (budget exhaustion and EOS) coast on the
    trash page and release shard-locally."""
    want, got = pair(runs, "budget_eos")
    agree(want["fleet"], got["fleet"])
    assert got["fleet"]["reason"]["0"] == "eos"
    assert got["fleet"]["pool_clean"]


def test_never_fits_rejected_fitting_complete(runs, side):
    """A prompt + budget past one shard's table is rejected up front; a
    prompt past max_len is refused at submit."""
    want, got = pair(runs, "never_fits")
    agree(want["fleet"], got["fleet"])
    assert got["fleet"]["rejected"] == {"0": True, "1": False}
    assert got["fleet"]["pool_clean"]
    eng = side.fleet()
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(side.Request(rid=9, prompt=list(range(1, 70)),
                                max_new_tokens=5))


def test_mesh_sharding_preserved_through_programs(runs, side):
    """The reference checks that every fleet program keeps each leaf on
    the mesh's data axis. The port's counterpart: after a run, every
    allocator leaf keeps its leading shard axis, each pool its S*P + 1
    pages (one trash page), every per-slot row leaf its S*B rows — and the run equals the
    JAX fleet's."""
    want, got = pair(runs, "layout")
    agree(want["fleet"], got["fleet"])
    eng = serve(side, _reqs(3, (6, 9, 12, 5, 17)))
    a = eng.caches["paged"]
    P, B, M = eng.num_pages, eng.B, eng.max_pages_slot
    assert tuple(a["tbl"].shape) == (S, B, M)
    assert tuple(a["free"].shape) == (S, P) and tuple(a["ref"].shape) == (S, P)
    assert tuple(a["top"].shape) == (S,)
    assert tuple(eng.caches["t"].shape) == (S * B,)
    for layer in eng.caches["layers"]:
        assert layer["k_pages"].shape[1] == S * P + 1
        assert layer["v_pages"].shape[1] == S * P + 1
        assert layer["pos_ids"].shape[0] == S * B
        assert layer["length"].shape == (S * B,)
    assert tuple(eng.cur_tokens.shape) == (S * B, 1)
    assert all(v.shape == (S * B,) for v in eng.state.values())


def test_fleet_syncs_do_not_scale_with_shards(runs):
    """One decode sync per chunk and one first-token fetch per finishing
    launch for ALL shards: syncs per 100 decode tokens no higher than the
    single engine serving a quarter of the load."""
    want, got = pair(runs, "syncs")
    agree(want["fleet"], got["fleet"])
    assert got["single_syncs"] == want["single_syncs"]

    def per_100(toks, syncs):
        n = sum(max(len(t) - 1, 0) for t in toks.values())
        return 100.0 * syncs / max(n, 1)

    fleet = got["fleet"]
    assert per_100(fleet["tokens"], fleet["stats"]["host_syncs"]) <= \
        per_100(got["single"], got["single_syncs"]) + 1e-9
    ftoks = sum(len(t) for t in fleet["tokens"].values())
    stoks = sum(len(t) for t in got["single"].values())
    assert ftoks == 4 * stoks


def test_requires_paged_and_chunked(side):
    with pytest.raises(ValueError, match="chunked"):
        side.Fleet(side.model, side.params, side.Config(
            max_batch=2, max_len=64, paged=True, page_size=PS, shards=S),
            device="cpu")
    with pytest.raises(ValueError, match="chunked"):
        side.Fleet(side.model, side.params, side.Config(
            max_batch=2, max_len=64, shards=S), device="cpu")


def test_prefix_sharing_is_shard_local(runs):
    """Followers of a resident prefix are steered to the shard holding it
    and adopt its pages; tokens equal the unshared engine's, every shard's
    weak index empties with its last holder."""
    want, got = pair(runs, "prefix_local")
    agree(want["fleet"], got["fleet"])
    st = got["fleet"]["stats"]
    assert st["prefix_hit_tokens"] >= 2 * PS
    assert st["prefix_shared_requests"] >= 1
    assert got["fleet"]["index_empty"] and got["fleet"]["pool_clean"]


def test_prefix_steering_prefers_resident_shard(runs):
    """The donor's shard has fewer free pages, yet the follower lands on
    it: sharing is a placement input."""
    want, got = pair(runs, "steering")
    agree(want["fleet"], got["fleet"])
    assert got["fleet"]["active_after_warmup"] == 1
    assert got["fleet"]["shard"]["1"] == got["fleet"]["shard"]["0"]
    assert got["fleet"]["stats"]["prefix_hit_tokens"] >= 2 * PS
    assert got["fleet"]["pool_clean"]


# ------------------------------------------------ tests/test_hetero_routing


def test_hetero_carbon_matches_homogeneous_free_pages(runs):
    """A heterogeneous carbon-routed fleet reproduces the homogeneous
    free-pages fleet's tokens: different placement, same tokens."""
    want, got = pair(runs, "het_carbon")
    agree(want["fleet"], got["fleet"])
    base = runs["mid_stream"][1]["fleet"]
    assert got["fleet"]["tokens"] == base["tokens"]
    assert got["fleet"]["finished"] == base["finished"]
    assert got["fleet"]["stats"]["carbon_routing"] == 1.0


def test_homogeneous_carbon_degrades_to_free_pages_exactly(runs):
    want, got = pair(runs, "homog_carbon")
    agree(want["fleet"], got["fleet"])
    base = runs["mid_stream"][1]["fleet"]
    assert got["fleet"]["shard"] == base["shard"], "placement drifted"
    assert got["fleet"]["tokens"] == base["tokens"]
    for s in range(S):
        for k in ("requests", "tokens", "energy_j", "carbon_g"):
            assert got["fleet"]["stats"][f"shard{s}_{k}"] == \
                base["stats"][f"shard{s}_{k}"]


def test_per_shard_meters_sum_to_fleet_total(runs):
    want, got = pair(runs, "meters_sum")
    agree(want["fleet"], got["fleet"])
    fleet = got["fleet"]
    st = fleet["stats"]
    assert sum(st[f"shard{s}_tokens"] for s in range(S)) == \
        st["prefill_tokens"] + st["decode_tokens"]
    for ph in ("prefill", "decode"):
        assert sum(fleet["phase_j"][ph]) == pytest.approx(
            fleet["fleet_phase_j"][ph], rel=1e-12, abs=1e-15)
    assert sum(st[f"shard{s}_energy_j"] for s in range(S)) == \
        pytest.approx(st["total_energy_j"], rel=1e-12, abs=1e-15)
    assert sum(st[f"shard{s}_carbon_g"] for s in range(S)) == \
        pytest.approx(st["total_carbon_g"], rel=1e-12, abs=1e-15)
    assert sum(st[f"shard{s}_requests"] for s in range(S)) == len(LENS)


def test_j_per_token_invariant_to_routing_policy(runs):
    want, got = pair(runs, "jpt")
    for routing in ("free_pages", "carbon"):
        agree(want[routing], got[routing])
    fa, fb = got["free_pages"], got["carbon"]
    checked = 0
    for s in range(S):
        ta, tb = (f["phase_tok"]["prefill"][s] for f in (fa, fb))
        if ta == 0 or tb == 0:
            continue                   # a policy may starve a shard
        # uniform trace: each request's prefill is the same batch-1 launch
        assert fb["phase_j"]["prefill"][s] / tb == pytest.approx(
            fa["phase_j"]["prefill"][s] / ta, rel=1e-12)
        da, db = (f["phase_tok"]["decode"][s] for f in (fa, fb))
        if da and db:
            assert fb["phase_j"]["decode"][s] / db == pytest.approx(
                fa["phase_j"]["decode"][s] / da, rel=0.5)
        checked += 1
    assert checked > 0, "no shard served under both policies"


def test_carbon_routing_prefers_low_ci_shards(runs):
    want, got = pair(runs, "low_ci")
    agree(want["fleet"], got["fleet"])
    assert got["placed"] == want["placed"]
    qc = {s for s in range(S) if HET_REGIONS[s] == "QC"}
    assert set(got["placed"]) <= qc


def test_slo_pinned_requests_route_load_first(runs):
    want, got = pair(runs, "slo")
    for name in ("unpinned", "pinned"):
        agree(want[name], got[name])
    qc = {s for s in range(S) if HET_REGIONS[s] == "QC"}
    assert set(got["unpinned"]["placed"]) == qc
    assert sorted(got["pinned"]["placed"]) == list(range(S))
    assert got["pinned"]["placed"][0] in qc


def test_phase_steering_disaggregates_by_hardware():
    """Prefill-heavy requests score cheaper on the Ada, decode-heavy on
    the T4 — on the port's scheduler copy, equal to the JAX one."""
    from repro.core import scheduler as JS
    from repro.core.energy import LLAMA_7B as J7B
    from repro.core.hardware import get_profile as jprof
    from repro.core.intensity import get_region as jreg
    from repro_torch.core import scheduler as TS
    from repro_torch.core.energy import LLAMA_7B
    from repro_torch.core.hardware import get_profile
    from repro_torch.core.intensity import get_region
    got, want = {}, {}
    for dev in ("t4", "rtx6000ada"):
        sl = TS.FleetSlice(get_profile(dev), get_region("CISO"))
        jsl = JS.FleetSlice(jprof(dev), jreg("CISO"))
        for name, args in (("pf", (2000, 4, 0.25)), ("dc", (45, 500, 0.25))):
            got[dev, name] = TS.marginal_request_g(sl, LLAMA_7B, *args)
            want[dev, name] = JS.marginal_request_g(jsl, J7B, *args)
            assert got[dev, name] == pytest.approx(want[dev, name],
                                                   rel=1e-12, abs=0.0)
    assert got["rtx6000ada", "pf"][0] < got["t4", "pf"][0]
    assert got["t4", "dc"][0] < got["rtx6000ada", "dc"][0]


def test_oom_slice_scores_infeasible():
    from repro_torch.core.energy import LLAMA_7B, LLMWorkload
    from repro_torch.core.hardware import get_profile
    from repro_torch.core.intensity import get_region
    from repro_torch.core.scheduler import FleetSlice, marginal_request_g
    sl = FleetSlice(get_profile("t4"), get_region("QC"))
    g, t = marginal_request_g(sl, LLAMA_7B, 100, 10, 0.5)
    assert np.isfinite(g) and np.isfinite(t)
    huge = LLMWorkload.llama_like("huge", n_layers=80, d_model=8192,
                                  n_heads=64, n_kv_heads=8, d_ff=28672,
                                  vocab=32000)
    g, t = marginal_request_g(sl, huge, 100, 10, 0.5)
    assert g == float("inf") and t == float("inf")


@pytest.mark.parametrize("name", sorted(DAYS))
def test_simulate_day_matches_live_place(runs, name):
    """The offline CIDirectedScheduler and the live carbon _place agree at
    every hour of a synthetic day; both fleets agree on both."""
    want, got = pair(runs, name)
    assert got["live"] == want["live"] and got["offline"] == want["offline"]
    assert got["total_g"] == pytest.approx(want["total_g"], rel=1e-12)
    assert got["live"] == got["offline"]


def test_single_engine_rejects_bad_knobs(side):
    base = dict(max_batch=2, max_len=64, paged=True, page_size=PS,
                prefill_chunk=CH)
    cases = ((dict(routing="greedy"), "routing"),
             (dict(defer_horizon_h=0), "defer_horizon_h"),
             (dict(defer_deadline_frac=1.5), "defer_deadline_frac"))
    for knob, match in cases:
        with pytest.raises(ValueError, match=match):
            side.Single(side.model, side.params,
                        side.Config(**base, **knob), device="cpu")
    with pytest.raises(ValueError, match="shard_profiles"):
        side.Fleet(side.model, side.params, side.Config(
            shards=S, shard_profiles=("t4",), **base), device="cpu")
    with pytest.raises(ValueError, match="shard_regions"):
        side.Fleet(side.model, side.params, side.Config(
            shards=S, shard_regions=("QC", "QC"), **base), device="cpu")


# -------------------------------------------- tests/test_sharded_preemption


def _assert_preempted(want, got, n_tokens=None):
    agree(want["fleet"], got["fleet"])
    fleet = got["fleet"]
    assert fleet["decoding_after_warmup"] > 0
    assert fleet["stats"]["preemption_count"] >= 1, "no eviction happened"
    assert_oracle(fleet, got["single"])
    assert fleet["pool_clean"]
    preempted = [rid for rid, n in fleet["preemptions"].items() if n > 0]
    assert preempted
    for rid in preempted if n_tokens else ():
        assert len(fleet["tokens"][rid]) == n_tokens


def test_sharded_preemption_parity_and_invariants(runs):
    """All four fleet slots held by long low-priority decodes; two
    high-priority arrivals evict. Token-for-token vs the unpreempted
    oracle, pin invariants every quantum on every shard, pools drain."""
    want, got = pair(runs, "pre_parity")
    _assert_preempted(want, got, n_tokens=24)
    st = got["fleet"]["stats"]
    assert st["preempted_recompute_j"] > 0
    assert all(f for f in got["fleet"]["finished"].values())


def test_sharded_partially_shared_victim_parity(runs):
    want, got = pair(runs, "pre_shared")
    _assert_preempted(want, got)
    assert got["fleet"]["prefix_hit_tokens"] > 0


def test_sharded_no_cross_shard_victim_when_local_idle(runs):
    want, got = pair(runs, "pre_no_cross")
    agree(want["fleet"], got["fleet"])
    assert got["fleet"]["stats"]["preemption_count"] == 0


@pytest.mark.parametrize("site,at", FAULT_CASES)
def test_sharded_fault_recovery(runs, site, at):
    """One injected fault at each fleet launch site: tokens equal the
    fault-free fleet's, every pool drains."""
    want, got = pair(runs, f"fault_{site}")
    for name in ("clean", "faulted"):
        agree(want[name], got[name])
    faulted = got["faulted"]
    assert faulted["faults"], f"planned fault at {site} q{at} never fired"
    assert faulted["stats"]["fault_retries"] >= 1
    assert faulted["tokens"] == got["clean"]["tokens"]
    assert all(faulted["finished"].values()) and faulted["pool_clean"]


def test_sharded_fault_during_preemption(runs):
    want, got = pair(runs, "fault_preempt")
    _assert_preempted(want, got)
    assert got["fleet"]["faults"]


# ------------------------------------------------------ tests/test_shard_loss


def test_audit_catches_corruption(runs, side):
    """audit() is a real check: a drifted reservation mirror raises. (The
    reference's second half, a pin into a dead pool, is
    ``test_torch_fleet_admin.py::test_audit_catches_corruption_dead_pool_
    pin``.)"""
    want, got = pair(runs, "audit_run")
    agree(want["fleet"], got["fleet"])
    eng = _audited(side)
    side.submit(eng, _pre_reqs(44, range(2), (6, 9), max_new=12))
    eng.run()
    eng.audit()
    eng.free_pages[0] = eng.num_pages + 5
    with pytest.raises(RuntimeError, match="reservation mirror"):
        eng.audit()
    eng.free_pages[0] = eng.num_pages
    eng.audit()


def test_launch_faults_under_carbon_routing(runs):
    """Faulted launches on a heterogeneous carbon-routed fleet: tokens
    equal the fault-free run's, per-shard carbon sums to the total."""
    want, got = pair(runs, "faults_carbon")
    for name in ("clean", "faulted"):
        agree(want[name], got[name])
    faulted = got["faulted"]
    assert faulted["tokens"] == got["clean"]["tokens"]
    assert faulted["reason"] == got["clean"]["reason"]
    assert faulted["stats"]["fault_retries"] == len(faulted["faults"]) > 0
    st = faulted["stats"]
    assert sum(st[f"shard{s}_carbon_g"] for s in range(PRE_S)) == \
        pytest.approx(st["total_carbon_g"])


def test_faults_during_deferral_release(runs):
    """Launch faults while deferred work releases: every deferred request
    releases once and finishes, nothing stays parked."""
    want, got = pair(runs, "faults_deferral")
    agree(want["fleet"], got["fleet"])
    fleet = got["fleet"]
    st = fleet["stats"]
    assert st["deferred_requests"] == 3
    assert st["deferred_released"] == st["deferred_requests"]
    assert fleet["deferred_left"] == fleet["deferred_rids_left"] == 0
    assert all(fleet["finished"].values())
    assert st["fault_retries"] > 0


# ------------------------------------------- tests/test_methodology_contract


def test_sharded_engine_stats_match_documented_keys(runs):
    from test_methodology_contract import _check_surface
    want, got = pair(runs, "stats_keys")
    agree(want["fleet"], got["fleet"])
    _check_surface(got["fleet"]["stats"], "sharded")


# ------------------------------------------------------------- port-only


def test_waiting_whole_prompt_adopters_held_to_unshared_engine(runs):
    """Whole-prompt adopters parked mid-prefill through decode chunks:
    the port's tokens equal the UNSHARED single engine's (its parked
    slots write to the trash page); every modeled number still equals the
    JAX fleet's, whose own tokens may differ (ROADMAP Queue 3)."""
    want, got = pair(runs, "adopters")
    fleet = got["fleet"]
    assert fleet["shared"] >= 2
    assert_oracle(fleet, got["single"])
    assert fleet["pool_clean"]
    for key in ("stats", "shard", "shard_j", "shard_g", "reason"):
        agree({key: want["fleet"][key]}, {key: fleet[key]})


def test_moe_fleet_routes_each_shard_against_its_own_capacity(runs):
    """A ``moe`` model's fleet equals the JAX fleet: tokens, placements,
    per-shard gCO2 and every stats() key; pooled over the shards, the
    port's capacity gives other tokens, so per-shard capacity is what
    made them equal."""
    want, got = pair(runs, "moe_per_shard")
    agree(want["fleet"], got["fleet"])
    assert sorted(set(got["fleet"]["shard"].values())) == list(range(S))
    assert all(got["fleet"]["finished"].values())
    assert got["pooled"] != got["fleet"]["tokens"]


def test_one_forward_per_microstep_serves_every_shard(side, monkeypatch):
    """The fleet's hot path, counted on the CPU: each decode chunk is ONE
    ``fused_decode_steps`` call and one host sync for every shard; each
    micro-step and each chunk launch calls the paged-decode or chunked-
    prefill attention once per layer (over S*B rows for decode) and the
    RMSNorm ops as one forward does — the single engine's per-forward
    counts, not S times them."""
    from repro_torch.kernels import ops
    from repro_torch.serving import sampling
    from repro_torch.serving import sharded as sharded_mod
    calls = {"paged": [], "chunk": [], "norm": 0, "fused": 0}
    real = {n: getattr(ops, n) for n in ("paged_decode_attention",
                                         "chunked_prefill_attention",
                                         "rmsnorm", "add_rmsnorm")}

    def paged(q, *a, **k):
        calls["paged"].append(q.shape[0])
        return real["paged_decode_attention"](q, *a, **k)

    def chunk(q, *a, **k):
        calls["chunk"].append(q.shape[0])
        return real["chunked_prefill_attention"](q, *a, **k)

    def norm(name):
        def f(*a, **k):
            calls["norm"] += 1
            return real[name](*a, **k)
        return f

    fused = sampling.fused_decode_steps
    micro = [0]

    def counted(*a, **k):
        calls["fused"] += 1
        micro[0] += k["n_steps"]
        return fused(*a, **k)

    monkeypatch.setattr(ops, "paged_decode_attention", paged)
    monkeypatch.setattr(ops, "chunked_prefill_attention", chunk)
    monkeypatch.setattr(ops, "rmsnorm", norm("rmsnorm"))
    monkeypatch.setattr(ops, "add_rmsnorm", norm("add_rmsnorm"))
    monkeypatch.setattr(sharded_mod.sampling, "fused_decode_steps", counted)
    eng = side.fleet(routing="carbon", prefix_sharing=True,
                     shard_regions=("QC", "CISO", "PACE", "CISO"))
    side.submit(eng, _reqs(7, LENS))
    eng.run()
    st = eng.stats()
    L = side.model.cfg.n_layers
    assert len(set(eng._req_shard.values())) >= 3
    assert calls["fused"] == st["decode_chunks"]
    assert st["host_syncs"] == st["decode_chunks"] + st["prefill_batches"]
    assert len(calls["paged"]) == L * micro[0]
    assert set(calls["paged"]) == {S * eng.B}
    assert len(calls["chunk"]) == L * st["prefill_chunks"]
    assert calls["norm"] == (2 * L + 1) * (micro[0] + st["prefill_chunks"])


# ------------------------------------------------------ tests/test_scheduler


def _fleet_slices(pkg):
    get_profile, get_region, FleetSlice = pkg
    return [FleetSlice(get_profile("t4"), get_region("QC")),
            FleetSlice(get_profile("t4"), get_region("PACE")),
            FleetSlice(get_profile("rtx6000ada"), get_region("QC")),
            FleetSlice(get_profile("rtx6000ada"), get_region("CISO")),
            FleetSlice(get_profile("rtx6000ada"), get_region("PACE"))]


@pytest.fixture(scope="module")
def sched():
    """(port scheduler module, JAX one, port fleet, JAX fleet, port
    workloads, JAX workloads)."""
    from repro.core import energy as JE
    from repro.core import hardware as JH
    from repro.core import intensity as JI
    from repro.core import scheduler as JS
    from repro_torch.core import energy as TE
    from repro_torch.core import hardware as TH
    from repro_torch.core import intensity as TI
    from repro_torch.core import scheduler as TS
    return (TS, JS,
            _fleet_slices((TH.get_profile, TI.get_region, TS.FleetSlice)),
            _fleet_slices((JH.get_profile, JI.get_region, JS.FleetSlice)),
            (TE.LLAMA_1B, TE.LLAMA_7B), (JE.LLAMA_1B, JE.LLAMA_7B))


def _same_placement(got, want):
    if want is None:
        assert got is None
        return
    for f in ("slice_key", "batch", "phase"):
        assert getattr(got, f) == getattr(want, f)
    for f in ("latency_s", "energy_j", "carbon_g", "g_per_token"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=1e-12, abs=0.0), f


def test_low_ci_regions_win(sched):
    TS, JS, tf, jf, (t1, _), (j1, _) = sched
    t4qc = TS.evaluate(tf[0], t1, "prompt", 8)
    adapace = TS.evaluate(tf[4], t1, "prompt", 8)
    _same_placement(t4qc, JS.evaluate(jf[0], j1, "prompt", 8))
    _same_placement(adapace, JS.evaluate(jf[4], j1, "prompt", 8))
    assert t4qc.g_per_token < adapace.g_per_token
    assert t4qc.latency_s > adapace.latency_s


def test_winner_is_in_lowest_ci_region(sched):
    TS, JS, tf, jf, (t1, _), (j1, _) = sched
    win, table = TS.place_request_class(tf, t1, "prompt")
    jwin, jtable = JS.place_request_class(jf, j1, "prompt")
    _same_placement(win, jwin)
    assert len(table) == len(jtable)
    for a, b in zip(table, jtable):
        _same_placement(a, b)
    assert win is not None and win.slice_key.endswith("@QC")


def test_slo_changes_placement(sched):
    TS, JS, tf, jf, (_, t7), (_, j7) = sched
    loose, _ = TS.place_request_class(tf, t7, "prompt", slo_s=None,
                                      batches=(1,))
    t4_lat = TS.evaluate(tf[0], t7, "prompt", 1).latency_s
    tight, _ = TS.place_request_class(tf, t7, "prompt", slo_s=t4_lat * 0.6,
                                      batches=(1,))
    _same_placement(loose, JS.place_request_class(
        jf, j7, "prompt", slo_s=None, batches=(1,))[0])
    _same_placement(tight, JS.place_request_class(
        jf, j7, "prompt", slo_s=t4_lat * 0.6, batches=(1,))[0])
    assert tight is not None and tight.slice_key.startswith("rtx6000ada")
    assert loose.slice_key.startswith("t4")


def test_carbon_vs_throughput_batch_differ_somewhere(sched):
    TS, JS, tf, jf, (t1, _), (j1, _) = sched
    cb = TS.carbon_optimal_batch(tf[2], t1, "prefill")
    tb = TS.throughput_optimal_batch(tf[2], t1, "prefill")
    _same_placement(cb, JS.carbon_optimal_batch(jf[2], j1, "prefill"))
    _same_placement(tb, JS.throughput_optimal_batch(jf[2], j1, "prefill"))
    assert cb is not None and tb is not None and cb.batch != tb.batch


def test_disaggregation_prefill_decode_can_split(sched):
    TS, JS, tf, jf, (t1, _), (j1, _) = sched
    plan = TS.plan_disaggregated(tf, t1)
    jplan = JS.plan_disaggregated(jf, j1)
    assert set(plan) == set(jplan)
    for k in ("prefill", "decode"):
        _same_placement(plan[k], jplan[k])
        assert plan[k] is not None and plan[k].g_per_token > 0


def test_ci_directed_routing_beats_pinning(sched):
    TS, JS, tf, jf, (t1, _), (j1, _) = sched
    day = TS.CIDirectedScheduler(tf, t1, batch=8).simulate_day()
    jday = JS.CIDirectedScheduler(jf, j1, batch=8).simulate_day()
    assert day["choices"] == jday["choices"]
    assert day["total_g"] == pytest.approx(jday["total_g"], rel=1e-12)
    for key, pinned_total in day["pinned_g"].items():
        assert pinned_total == pytest.approx(jday["pinned_g"][key],
                                             rel=1e-12)
        assert day["total_g"] <= pinned_total * (1 + 1e-9)


def test_router_respects_infeasible_slices(sched):
    TS, JS, tf, jf, (_, t7), (_, j7) = sched
    with pytest.raises(RuntimeError):
        TS.CIDirectedScheduler(tf[:1], t7, batch=64).route(0.0)
    with pytest.raises(RuntimeError):
        JS.CIDirectedScheduler(jf[:1], j7, batch=64).route(0.0)


@pytest.mark.parametrize("seed", range(5))
def test_route_always_feasible_with_ada_present(sched, seed):
    """The reference's hypothesis property as a seeded sweep: every
    (batch, hour) routes to a feasible slice, equal on both copies."""
    TS, JS, tf, jf, (t1, _), (j1, _) = sched
    rng = np.random.default_rng(seed)
    for _ in range(5):
        b = int(rng.choice([1, 2, 4, 8, 16]))
        hour = float(rng.uniform(0, 24))
        sl, p = TS.CIDirectedScheduler(tf, t1, batch=b).route(hour)
        jsl, jp = JS.CIDirectedScheduler(jf, j1, batch=b).route(hour)
        assert sl.key == jsl.key
        _same_placement(p, jp)
        assert p.feasible and p.carbon_g > 0


# ------------------------------------------------------------ the subprocess


def _main(path):
    import jax
    if jax.device_count() < S:
        sys.exit(f"needs {S} host devices, have {jax.device_count()}: set "
                 "XLA_FLAGS=--xla_force_host_platform_device_count=4 "
                 "before the first jax import")
    side = Side("jax")
    out = {name: fn(side) for name, fn in SCENARIOS.items()}
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    _main(sys.argv[1])
