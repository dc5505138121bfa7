"""The port's fleet through shard loss, rejoin, drain, brown-out power caps
and live KV-page migration, against the JAX fleet, case for case: every
case of the reference's ``tests/test_shard_loss.py`` that
``tests/test_torch_fleet.py`` does not hold (14 functions, the arbitrary
quantum kill at its 5 quanta, and the dead-pool half of
``test_audit_catches_corruption``) and all 15 of
``tests/test_migration.py``, on the reference's tiny model (2 dense
layers, d_model 64, 8 query heads on 2 kv heads, vocab 256, float32) and
fleet (2 slots a shard, page size 4, chunk 8, preemption and prefix
sharing), 2 shards unless a case says otherwise.

As in ``tests/test_torch_fleet.py``, whose ``Side`` adapter, ``result``
and ``agree`` this file uses: the JAX fleet needs one host device per
shard, so every scenario runs once more in ONE subprocess (this file run
as a script with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
writing JSON, while the module fixture runs the same scenario functions on
the port's fleet in this process. A scenario returns tokens, finish
reasons, the shard of every request, every ``stats()`` key that is not a
wall-clock reading, per-shard and per-phase modeled J and gCO2, and what
its reference test checks on the way (raised errors, health events, the
dead shard's pool before and after, the mirrors at declaration). The port
must equal the JAX fleet on all of it (numbers to 1e-12 relative), and
each test keeps its reference test's own assertions, the fault-free
fleet's tokens as the oracle. Every quantum runs ``audit()`` (the
reference's ``CheckedFleet``). Each scenario seeds its own prompts.

Last, two port-only cases pin the one-card pool programs of
``serving/paged.py``: ``quarantine_table`` and ``scrub_pool`` touch only
the flagged shards, and ``migrate_slot`` copies a slot's pages bit for
bit onto the destination's LIFO pops, sharing-aware on the source.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_fleet import PRE_PS, Side, agree, result

S = 2
LOSS = dict(max_batch=2, max_len=64, sync_every=4, page_size=PRE_PS,
            prefill_chunk=8, shards=S, preemption=True, prefix_sharing=True)
LENS = (5, 9, 14, 7, 11, 6)
KILL_QUANTA = (1, 2, 4, 6, 8)


def fleet(side, checked=True, **kw):
    """The reference suites' ``make_fleet``: ``audit()`` after every
    quantum unless ``checked`` is False."""
    eng = side.fleet(**dict(LOSS, **kw))
    if checked:
        step = eng.step

        def audited_step(max_steps=10_000):
            ran = step(max_steps)
            eng.audit()
            return ran

        eng.step = audited_step
    return eng


def reqs(seed, rids, lens, max_new=12, **kw):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid, prompt=[int(t) for t in rng.integers(0, 256, n)],
                 max_new_tokens=max_new, **kw)
            for rid, n in zip(rids, lens)]


def serve(side, eng, rs):
    side.submit(eng, rs)
    eng.run()
    return eng


def clean(side, rs, **kw):
    """The fault-free fleet's result: the token oracle."""
    return result(side, serve(side, fleet(side, **kw), rs))


def steps(eng, n):
    for _ in range(n):
        eng.step()


def raised(fn):
    """(type name, message) of what ``fn`` raised, or None."""
    try:
        fn()
    except Exception as e:         # compared across the two packages
        return [type(e).__name__, str(e)]
    return None


def phase_j(eng, name):
    return [m.phase(name).energy_j for m in eng.meters]


def events(eng):
    return [list(e) for e in eng.health.events]


def plans(ps):
    return [dataclasses.asdict(p) for p in ps]


def dead_lane(side, eng, s):
    """Shard ``s``'s part of the device cache: its allocator rows, its
    cursor rows and its pages of every pool, the trash page excluded."""
    if side.name == "jax":
        import jax
        out = []
        for a in jax.tree_util.tree_leaves(jax.device_get(eng.caches)):
            a = np.asarray(a)[s]
            if a.ndim >= 4:            # ([R,] H, P+1, ps, hd): real pages
                sl = [slice(None)] * a.ndim
                sl[-3] = slice(0, a.shape[-3] - 1)
                a = a[tuple(sl)]
            out.append(a)
        return out
    B, P = eng.B, eng.num_pages
    c = eng.caches
    out = [v[s].cpu().numpy().copy() for v in c["paged"].values()]
    out.append(c["t"][s * B:(s + 1) * B].cpu().numpy().copy())
    for layer in c["layers"]:
        for name, v in layer.items():
            part = (v[:, s * P:(s + 1) * P] if name in ("k_pages", "v_pages")
                    else v[s * B:(s + 1) * B])
            out.append(part.cpu().numpy().copy())
    return out


# ---------------------------------------------------------------- scenarios

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ------------------------------------------------ tests/test_shard_loss.py


@scenario
def single_kill(side):
    rs = reqs(23, range(len(LENS)), LENS)
    eng = fleet(side)
    eng.faults = side.Injector([side.Plan("shard_down", at_quantum=3,
                                          shard=0)])
    serve(side, eng, rs)
    eng.audit()
    return {"want": clean(side, rs),
            "got": result(side, eng, events=events(eng),
                          evacuated=eng.shard_evacuated,
                          recompute_tokens=eng.meter.phase(
                              "recompute").tokens)}


def _kill_at(side, quantum):
    rs = reqs(24, range(4), (6, 13, 9, 16), max_new=20)
    eng = fleet(side)
    eng.faults = side.Injector([side.Plan("shard_down", at_quantum=quantum,
                                          shard=1)])
    serve(side, eng, rs)
    eng.audit()
    return {"want": clean(side, rs),
            "got": result(side, eng, dead1=eng.health.is_dead(1))}


for _q in KILL_QUANTA:
    SCENARIOS[f"kill_q{_q}"] = lambda side, _q=_q: _kill_at(side, _q)


@scenario
def kill_preempt_deadlines(side):
    low = reqs(25, (0, 1, 2, 3), (8, 10, 6, 12), max_new=14)
    # generous wall-clock deadlines: the sweep runs but never fires
    high = reqs(26, (10, 11), (7, 9), max_new=6, priority=1,
                deadline_s=60.0)

    def drive(kill):
        eng = fleet(side)
        if kill:
            eng.faults = side.Injector(
                [side.Plan("shard_down", at_quantum=4, shard=0)])
        side.submit(eng, low)
        steps(eng, 5)
        side.submit(eng, high)
        eng.run()
        eng.audit()
        return eng

    eng = drive(True)
    return {"want": result(side, drive(False)),
            "got": result(side, eng, dead0=eng.health.is_dead(0))}


@scenario
def repeated_kills(side):
    rs = reqs(27, range(8), (5, 9, 14, 7, 11, 6, 8, 12))
    eng = fleet(side, shards=4)
    # absolute: the plan must not re-fire when the later run() restarts
    # the relative time base
    eng.faults = side.Injector([side.Plan("shard_down", at_quantum=2,
                                          shard=0, absolute=True)])
    side.submit(eng, rs[:4])
    steps(eng, 6)
    dead0 = eng.health.is_dead(0)
    eng.rejoin(0)
    eng.fail_shard(2)
    serve(side, eng, rs[4:])
    eng.audit()
    return {"want": clean(side, rs, shards=4),
            "got": result(side, eng, events=events(eng), dead0=dead0)}


@scenario
def watchdog(side):
    rs = reqs(28, [0], [8], max_new=12)
    eng = fleet(side)
    # retries back off at +2, +4, +8: the site keeps faulting throughout
    eng.faults = side.Injector([side.Plan("decode_scan", at_quantum=3,
                                          count=20)])
    serve(side, eng, rs)
    eng.audit()
    return {"want": clean(side, rs),
            "got": result(side, eng, dead=sorted(eng.health.dead))}


@scenario
def page_alloc_exhaustion(side):
    eng = fleet(side)
    eng.faults = side.Injector([side.Plan("page_alloc", at_quantum=1,
                                          count=30)])
    side.submit(eng, reqs(29, [0], [8], max_new=4))
    err = raised(eng.run)
    eng.audit()
    return {"raised": err, "dead": sorted(eng.health.dead),
            "queue": len(eng.queue), "fleet": result(side, eng)}


@scenario
def last_live_shard(side):
    eng = fleet(side)
    eng.fail_shard(0)
    err = raised(lambda: eng.fail_shard(1))
    eng.audit()
    return {"raised": err, "live": list(eng.health.live),
            "fleet": result(side, eng)}


@scenario
def dead_pool_untouched(side):
    eng = fleet(side)
    side.submit(eng, reqs(30, range(6), LENS))
    steps(eng, 4)
    eng.fail_shard(0)
    before = dead_lane(side, eng, 0)
    eng.run()
    after = dead_lane(side, eng, 0)
    eng.audit()
    return {"untouched": all(bool((b == a).all())
                             for b, a in zip(before, after)),
            "fleet": result(side, eng)}


@scenario
def mirrors_invalidated(side):
    low = reqs(31, (0, 1, 2, 3), (8, 10, 6, 12), max_new=14)
    high = reqs(32, (10, 11), (7, 9), max_new=6, priority=1)
    eng = fleet(side)
    side.submit(eng, low)
    steps(eng, 5)
    side.submit(eng, high)
    steps(eng, 2)                      # preemption pins victims
    eng.fail_shard(0)
    at_death = {
        "pins_off_dead": all(ps != 0 for ps, _ in eng._pins.values()),
        "index_empty": not eng._prefix_index[0] and not eng._page_ref[0],
        "prefilling_empty": not eng._prefilling[0],
        "slots_empty": all(rid < 0 for rid in eng.slot_rid[0]),
        "free_whole": eng.free_pages[0] == eng.num_pages}
    eng.run()
    eng.audit()
    return {"at_death": at_death, "fleet": result(side, eng)}


@scenario
def rejoin_scrubbed(side):
    eng = fleet(side)
    serve(side, eng, reqs(33, range(4), (6, 9, 12, 7)))
    first = result(side, eng)
    eng.fail_shard(0)
    eng.rejoin(0)
    a = side.alloc(eng)
    scrubbed = {"top": int(a["top"][0]) == eng.num_pages,
                "tbl": bool((a["tbl"][0] == -1).all()),
                "ref": bool((a["ref"][0] == 0).all()),
                "index": not eng._prefix_index[0]}
    before = eng.stats()["shard0_requests"]
    # enough parallel work that placement must use both shards
    serve(side, eng, reqs(34, range(100, 106), LENS))
    eng.audit()
    return {"first": first, "scrubbed": scrubbed, "before": before,
            "fleet": result(side, eng)}


@scenario
def rejoin_validates(side):
    eng = fleet(side)
    return {"raised": [raised(lambda: eng.rejoin(0)),
                       raised(lambda: eng.rejoin(S)),
                       raised(lambda: eng.fail_shard(-1))]}


@scenario
def audit_dead_pins(side):
    eng = fleet(side)
    serve(side, eng, reqs(35, range(2), (6, 9)))
    eng.fail_shard(0)
    eng._pins[999] = (0, [0])
    err = raised(eng.audit)
    del eng._pins[999]
    eng.audit()
    return {"raised": err, "fleet": result(side, eng)}


@scenario
def kill_deferred_parked(side):
    eng = fleet(side, defer_below_priority=1, use_diurnal_ci=True)
    eng.faults = side.Injector([side.Plan("shard_down", at_quantum=2,
                                          shard=1)])
    urgent = reqs(36, (0, 1), (6, 9), max_new=10, priority=1)
    parked = reqs(37, (10, 11), (7, 5), max_new=6)
    serve(side, eng, urgent + parked)
    eng.audit()
    return {"fleet": result(side, eng, dead1=eng.health.is_dead(1),
                            clock_hours=eng.clock.hours)}


@scenario
def random_campaign(side):
    ps = side.Plan.random(17, n=6, shards=S)
    rs = reqs(38, range(5), (5, 9, 14, 7, 11))
    eng = fleet(side)
    eng.faults = side.Injector(side.Plan.random(17, n=6, shards=S))
    serve(side, eng, rs)
    eng.audit()
    return {"plans": plans(ps),
            "same": ps == side.Plan.random(17, n=6, shards=S),
            "no_shards": raised(lambda: side.Plan.random(
                1, sites=("shard_down",))),
            "want": clean(side, rs), "got": result(side, eng)}


# ------------------------------------------------- tests/test_migration.py


@scenario
def drain_parity(side):
    rs = reqs(41, range(len(LENS)), LENS, max_new=24)
    eng = fleet(side)
    side.submit(eng, rs)
    steps(eng, 4)
    eng.drain(0)
    eng.run()
    eng.audit()
    return {"want": clean(side, rs),
            "got": result(side, eng, dead0=eng.health.is_dead(0),
                          recompute_j=eng.meter.phase("recompute").energy_j,
                          resp_recompute=[r.recompute_j for r in
                                          eng.responses.values()])}


@scenario
def drain_both_endpoints(side):
    eng = fleet(side)
    side.submit(eng, reqs(42, range(2), (9, 13), max_new=24))
    steps(eng, 4)
    eng.drain(0)
    eng.run()
    return {"fleet": result(side, eng, migrate_j=phase_j(eng, "migrate"),
                            fleet_migrate_j=eng.meter.phase(
                                "migrate").energy_j)}


@scenario
def drain_then_rejoin(side):
    eng = fleet(side)
    serve(side, eng, reqs(43, range(4), (6, 9, 12, 7), max_new=16))
    side.submit(eng, reqs(44, range(10, 12), (8, 11), max_new=20))
    steps(eng, 3)
    eng.drain(0)
    eng.run()
    dead0 = eng.health.is_dead(0)
    eng.rejoin(0)
    before = eng.stats()["shard0_requests"]
    serve(side, eng, reqs(45, range(100, 106), LENS))
    eng.audit()
    return {"dead0": dead0, "before": before, "fleet": result(side, eng)}


@scenario
def drain_reindexes(side):
    prompt = [int(t) for t in np.random.default_rng(46).integers(0, 256, 16)]
    spec0 = dict(rid=0, prompt=list(prompt), max_new_tokens=30)
    spec1 = dict(rid=1, prompt=list(prompt), max_new_tokens=30)
    eng = fleet(side)
    side.submit(eng, [spec0])
    steps(eng, 4)                      # prompt resident + armed
    src = eng._req_shard[0]
    eng.drain(src)
    moved = eng.migrations
    serve(side, eng, [spec1])
    eng.audit()
    return {"want": clean(side, [spec0]), "src": src, "moved": moved,
            "got": result(side, eng,
                          recompute_j=eng.meter.phase("recompute").energy_j)}


@scenario
def drain_waits(side):
    # 4 long requests fill both shards (2 slots each): no free destination
    rs = reqs(47, range(4), (6, 9, 12, 7), max_new=28)
    eng = fleet(side)
    side.submit(eng, rs)
    steps(eng, 4)
    moved = [eng.drain(1)]
    draining = 1 in eng._draining
    moved.append(eng.drain(1))         # idempotent while draining
    eng.run()
    eng.audit()
    return {"want": clean(side, rs), "moved": moved, "draining": draining,
            "got": result(side, eng, still=1 in eng._draining)}


@scenario
def drain_deadline(side):
    rs = reqs(48, range(4), (6, 9, 12, 7), max_new=28)
    eng = fleet(side)
    side.submit(eng, rs)
    steps(eng, 4)
    eng.drain(1, deadline_s=0.0)       # expires at the next sweep
    eng.run()
    eng.audit()
    return {"want": clean(side, rs),
            "got": result(side, eng, dead1=eng.health.is_dead(1),
                          recompute_j=eng.meter.phase("recompute").energy_j)}


@scenario
def request_deadline_mid_drain(side):
    eng = fleet(side)
    side.submit(eng, reqs(49, range(2), (9, 13), max_new=30))
    steps(eng, 3)
    eng.drain(0)
    side.submit(eng, reqs(50, [9], [8], max_new=30, deadline_s=1e-6))
    eng.run()
    eng.audit()
    live = eng.health.live
    return {"fleet": result(side, eng),
            "live_free": sum(eng.free_pages[s] for s in live),
            "live_whole": len(live) * eng.num_pages}


@scenario
def deferred_not_draining(side):
    eng = fleet(side, defer_below_priority=1, use_diurnal_ci=True)
    side.submit(eng, reqs(51, (0, 1, 2, 3), (6, 9, 7, 11), max_new=24,
                          priority=1))
    steps(eng, 4)
    eng.drain(1)
    before = eng.stats()["shard1_requests"]
    serve(side, eng, reqs(52, (10, 11), (7, 5), max_new=6))
    eng.audit()
    return {"before": before,
            "fleet": result(side, eng, clock_hours=eng.clock.hours)}


@scenario
def drain_validates(side):
    eng = fleet(side)
    out = [raised(lambda: eng.drain(S))]
    eng.fail_shard(0)
    out += [raised(lambda: eng.drain(0)), raised(lambda: eng.drain(1))]
    eng.rejoin(0)
    moved = eng.drain(1)               # empty: drains at once
    dead1 = eng.health.is_dead(1)
    out.append(raised(lambda: eng.drain(1)))
    eng.audit()
    return {"raised": out, "moved": moved, "dead1": dead1,
            "fleet": result(side, eng)}


@scenario
def failover_modes(side):
    rs = reqs(53, range(4), (6, 13, 9, 16), max_new=20)
    eng = fleet(side, shards=3)
    side.submit(eng, rs)
    steps(eng, 4)
    eng.fail_shard(0)                  # reachable=True by default
    eng.run()
    eng2 = fleet(side, shards=3)
    eng2.faults = side.Injector([side.Plan("shard_down", at_quantum=4,
                                           shard=0)])
    serve(side, eng2, rs)
    return {"want": clean(side, rs, shards=3),
            "migrate": result(side, eng),
            "fold": result(side, eng2)}


@scenario
def cap_sheds(side):
    rs = reqs(54, range(2), (9, 13), max_new=24)
    eng = fleet(side)
    side.submit(eng, rs)
    steps(eng, 4)
    # both shards hold one slot each; cap shard 0 just above idle
    cap = eng.shard_profile[0].idle_w + 1e-6
    shed = eng.power_cap(0, cap)
    draw_after_cap = eng._modeled_draw(0)
    capped_stats = {k: float(v) for k, v in eng.stats().items()
                    if k in ("power_cap_events", "shard0_power_cap_w")}
    eng.run()
    draw_end = eng._modeled_draw(0)
    eng.power_cap(0, None)
    lifted = "shard0_power_cap_w" not in eng.stats()
    eng.audit()
    return {"want": clean(side, rs), "cap": cap, "shed": shed,
            "draw_after_cap": draw_after_cap, "draw_end": draw_end,
            "capped_stats": capped_stats, "lifted": lifted,
            "got": result(side, eng)}


@scenario
def cap_priority(side):
    eng = fleet(side, shards=3)
    side.submit(eng, reqs(55, [0], [9], max_new=24, priority=0)
                + reqs(56, [1], [11], max_new=24, priority=2))
    steps(eng, 4)
    s_lo = eng._req_shard[0]
    placed = dict(eng._req_shard)
    mid = eng._modeled_draw(s_lo)
    eng.power_cap(s_lo, max(eng.shard_profile[s_lo].idle_w + 1e-6,
                            mid * 0.5))
    after = dict(eng._req_shard)
    eng.run()
    eng.audit()
    return {"s_lo": s_lo, "placed": {str(k): v for k, v in placed.items()},
            "after_cap": {str(k): v for k, v in after.items()},
            "fleet": result(side, eng)}


@scenario
def cap_validates(side):
    eng = fleet(side)
    out = [raised(lambda: eng.power_cap(S, 100.0)),
           raised(lambda: eng.power_cap(
               0, eng.shard_profile[0].idle_w - 1.0))]
    lift = eng.power_cap(0, None)      # lifting a cap never set is fine
    eng.audit()
    return {"raised": out, "lift": lift}


@scenario
def admin_campaign(side):
    ps = side.Plan.random(41, n=8, shards=S, admin=True, max_quantum=10)
    from_pkg = importlib.import_module(
        ("repro" if side.name == "jax" else "repro_torch")
        + ".serving.faults")
    eng = fleet(side)
    eng.faults = side.Injector(side.Plan.random(41, n=8, shards=S,
                                                admin=True, max_quantum=10))
    serve(side, eng, reqs(57, range(6), LENS, max_new=16))
    eng.audit()
    default = side.Plan.random(17, n=6, shards=S)
    return {"plans": plans(ps),
            "same": ps == side.Plan.random(41, n=8, shards=S, admin=True,
                                           max_quantum=10),
            "any_admin": any(p.site in from_pkg.ADMIN_SITES for p in ps),
            "default_sites": all(p.site in from_pkg.SITES for p in default),
            "fired_admin": sum(1 for f in eng.faults.fired
                               if f[0] in from_pkg.ADMIN_SITES),
            "fleet": result(side, eng)}


def _nudge(side, eng, key, idx, delta):
    """Add ``delta`` to one allocator entry in place, on either package's
    layout (the JAX leaf through the host, onto its own sharding: an
    ``.at[]`` update of a mesh-sharded leaf outside a mesh context is
    refused by the installed jax)."""
    alloc = eng.caches["paged"]
    if side.name == "jax":
        import jax
        host = np.array(alloc[key])
        host[idx] += delta
        alloc[key] = jax.device_put(host, alloc[key].sharding)
    else:
        alloc[key][idx] += delta


@scenario
def conservation_leak(side):
    eng = fleet(side)
    serve(side, eng, reqs(58, range(2), (6, 9)))
    eng.fail_shard(0)                  # its books are frozen, not checked
    eng.audit()
    _nudge(side, eng, "top", 0, -1)    # leak one dead page
    leak = raised(eng.audit)
    _nudge(side, eng, "top", 0, 1)
    eng.audit()
    _nudge(side, eng, "ref", (1, 0), 1)     # a live shard's drift
    drift = raised(eng.audit)
    _nudge(side, eng, "ref", (1, 0), -1)
    eng.audit()
    return {"leak": leak, "drift": drift, "fleet": result(side, eng)}


# ----------------------------------------------------------------- fixtures


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{scenario: (JAX fleet result, port result)}: the JAX fleet in a
    subprocess with four forced host devices, the port here meanwhile; a
    scenario that raised on the port's side is re-raised by its test."""
    out = tmp_path_factory.mktemp("jax_fleet_admin") / "jax.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here,
         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        jside = Side("jax")
        side = Side("torch", jside.params)
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


def same(runs, name, *fleets):
    """Both fleets agree on the named results and every other key."""
    want, got = pair(runs, name)
    assert set(got) == set(want)
    for key in want:
        if key in fleets:
            agree(want[key], got[key])
        else:
            assert got[key] == want[key], key
    return got


def oracle(got, want, rids=None):
    """The reference's ``assert_matches_oracle``."""
    for rid in (want["tokens"] if rids is None else rids):
        assert got["tokens"][rid] == want["tokens"][rid], \
            f"request {rid} diverged"
        assert got["finished"][rid] == want["finished"][rid]
        assert got["reason"][rid] == want["reason"][rid]


# ------------------------------------------------ tests/test_shard_loss.py


def test_single_kill_parity_and_counters(runs):
    """Kill shard 0 at a quantum boundary mid-run: every request finishes
    token-identical to the fail-free fleet, the watchdog logs one
    transition, stats report the degraded fleet."""
    got = same(runs, "single_kill", "want", "got")
    g = got["got"]
    oracle(g, got["want"])
    assert g["events"] == [[3, "down", 0]]
    st = g["stats"]
    assert st["live_shards"] == S - 1 and st["dead_shards"] == 1
    assert st["shard_down_events"] == 1
    assert st["shard0_dead"] == 1.0 and st["shard1_dead"] == 0.0
    assert g["evacuated"] >= 1
    if any(n > 0 for n in g["preemptions"].values()):
        assert g["recompute_tokens"] > 0


@pytest.mark.parametrize("quantum", KILL_QUANTA)
def test_kill_at_arbitrary_quantum_is_token_invisible(runs, quantum):
    """Under a shard_down at any quantum (during prefill, mid-decode, or
    after some requests finished) the evacuated streams equal the
    fail-free fleet's."""
    got = same(runs, f"kill_q{quantum}", "want", "got")
    oracle(got["got"], got["want"])
    assert got["got"]["dead1"]


def test_kill_composed_with_preemption_and_deadlines(runs):
    """Shard loss composed with a high-priority burst that preempts, under
    deadlines that never fire: every stream equals the fail-free run."""
    got = same(runs, "kill_preempt_deadlines", "want", "got")
    assert got["got"]["dead0"]
    for rid, toks in got["want"]["tokens"].items():
        assert got["got"]["tokens"][rid] == toks, f"request {rid} diverged"


def test_repeated_kills_and_rejoins(runs):
    """On a 4-shard fleet: lose shard 0, rejoin it, lose shard 2 (an
    explicit, reachable declaration): parity holds throughout."""
    got = same(runs, "repeated_kills", "want", "got")
    g = got["got"]
    assert g["dead0"]
    oracle(g, got["want"])
    assert [e[1:] for e in g["events"]] == [["down", 0], ["up", 0],
                                            ["down", 2]]
    st = g["stats"]
    assert st["shard_rejoins"] == 1 and st["shard_down_events"] == 2
    assert st["live_shards"] == 3


def test_watchdog_converts_exhaustion_to_shard_loss(runs):
    """A decode launch that keeps faulting while one shard has armed work:
    past max_retries the watchdog declares that shard dead and the request
    finishes token-identical on the survivor."""
    got = same(runs, "watchdog", "want", "got")
    g = got["got"]
    assert g["dead"], "watchdog never fired"
    oracle(g, got["want"])
    st = g["stats"]
    assert st["fault_retries_decode_scan"] == st["fault_retries"] > 0
    assert st[f"shard{g['dead'][0]}_fault_retries_decode_scan"] > 0


def test_page_alloc_exhaustion_still_raises(runs):
    """The host-side reservation pass is no device's: its exhaustion
    raises FaultError out of run(), nothing declared dead, the request
    re-queued."""
    got = same(runs, "page_alloc_exhaustion", "fleet")
    assert got["raised"][0] == "FaultError"
    assert got["dead"] == [] and got["queue"] == 1


def test_last_live_shard_refuses_to_die(runs):
    got = same(runs, "last_live_shard", "fleet")
    assert got["raised"][0] == "FaultError"
    assert "last live shard" in got["raised"][1]
    assert got["live"] == [1]


def test_dead_pool_bit_identical_until_rejoin(runs):
    """From declaration on, the dead shard's part of the device cache (its
    allocator rows, cursor rows and every real page of its half of each
    pool) stays bit-identical while the fleet serves on; only the shared
    trash page takes its rows' writes."""
    got = same(runs, "dead_pool_untouched", "fleet")
    assert got["untouched"], "dead shard's pool was touched after death"


def test_dead_shard_mirrors_invalidated_atomically(runs):
    """At declaration the dead shard owns nothing host-side, and the
    preempted requests pinned there resume without adopting from it."""
    got = same(runs, "mirrors_invalidated", "fleet")
    assert all(got["at_death"].values()), got["at_death"]
    assert all(f for rid, f in got["fleet"]["finished"].items()
               if got["fleet"]["reason"][rid] != "cancelled")


def test_rejoin_scrubbed_and_placeable_next_quantum(runs):
    """A rejoined shard re-enters with a fresh allocator and an empty
    prefix index, and takes placements again."""
    got = same(runs, "rejoin_scrubbed", "first", "fleet")
    assert all(got["first"]["finished"].values())
    assert all(got["scrubbed"].values()), got["scrubbed"]
    assert all(got["fleet"]["finished"].values())
    assert got["fleet"]["stats"]["shard0_requests"] > got["before"]


def test_rejoin_validates(runs):
    got = same(runs, "rejoin_validates")
    (e0, m0), (e1, m1), (e2, m2) = got["raised"]
    assert e0 == "ValueError" and "not dead" in m0
    assert e1 == e2 == "ValueError"
    assert "out of range" in m1 and "out of range" in m2


def test_audit_catches_corruption_dead_pool_pin(runs):
    """The reference's second half of ``test_audit_catches_corruption``: a
    pin pointing into a dead pool raises."""
    got = same(runs, "audit_dead_pins", "fleet")
    assert got["raised"][0] == "RuntimeError"
    assert "preemption pins" in got["raised"][1]


def test_shard_down_with_deferred_work_parked(runs):
    """A shard dies while work is parked for deferral: the parking lot is
    untouched and the released work lands on the survivor."""
    got = same(runs, "kill_deferred_parked", "fleet")
    f = got["fleet"]
    assert f["dead1"]
    st = f["stats"]
    assert st["deferred_released"] == st["deferred_requests"] == 2
    assert all(f["finished"].values())
    assert all(s == 0 for s in f["shard"].values())


def test_random_campaign_reproducible_and_survivable(runs):
    """The seeded campaign (launch faults and a shard kill) is the same on
    both packages and drains with every stream equal to the fail-free
    fleet's, per-site retries summing to the total."""
    got = same(runs, "random_campaign", "want", "got")
    assert got["same"]
    assert got["no_shards"][0] == "ValueError" and \
        "shards" in got["no_shards"][1]
    oracle(got["got"], got["want"])
    st = got["got"]["stats"]
    assert sum(v for k, v in st.items()
               if k.startswith("fault_retries_")) == st["fault_retries"]


# ------------------------------------------------- tests/test_migration.py


def test_drain_parity_and_zero_recompute(runs):
    """A drained run equals the undrained one token for token, spends zero
    recompute J, meters the copy to the migrate phase and hands the empty
    shard to the shard-down machinery."""
    got = same(runs, "drain_parity", "want", "got")
    g = got["got"]
    oracle(g, got["want"])
    st = g["stats"]
    assert st["migrations"] >= 1 and st["migrated_pages"] >= 1
    assert g["recompute_j"] == 0.0
    assert all(j == 0.0 for j in g["resp_recompute"])
    assert st["drain_events"] == 1 and st["migrate_j"] > 0.0
    assert g["dead0"] and st["shard_down_events"] == 1


def test_drain_migrate_energy_on_both_endpoints(runs):
    got = same(runs, "drain_both_endpoints", "fleet")
    f = got["fleet"]
    assert f["stats"]["migrations"] >= 1
    src, dst = f["migrate_j"]
    assert src > 0.0 and dst > 0.0
    assert f["fleet_migrate_j"] == pytest.approx(src + dst)


def test_drain_then_rejoin_serves_again(runs):
    got = same(runs, "drain_then_rejoin", "fleet")
    assert got["dead0"]
    assert all(got["fleet"]["finished"].values())
    assert got["fleet"]["stats"]["shard0_requests"] > got["before"]


def test_drain_with_shared_prefix_reindexes_on_survivor(runs):
    """A migrated armed slot re-registers its prompt in the destination's
    index: a later twin adopts from the survivor and still decodes like
    the unshared run."""
    got = same(runs, "drain_reindexes", "want", "got")
    assert got["moved"] >= 1
    g, w = got["got"], got["want"]
    assert g["stats"]["prefix_hit_tokens"] > 0, "never adopted"
    assert g["tokens"]["0"] == w["tokens"]["0"]
    assert g["tokens"]["1"] == w["tokens"]["0"]
    assert g["recompute_j"] == 0.0


def test_drain_waits_for_capacity_without_stalling(runs):
    """With no survivor room the draining shard keeps decoding and
    migrates as capacity frees; the run equals the undrained one."""
    got = same(runs, "drain_waits", "want", "got")
    assert got["moved"] == [0, 0] and got["draining"]
    oracle(got["got"], got["want"])
    assert not got["got"]["still"]


def test_drain_deadline_forces_evacuation(runs):
    got = same(runs, "drain_deadline", "want", "got")
    g = got["got"]
    oracle(g, got["want"])
    assert g["dead1"]
    assert g["free_pages"][1] == g["stats"]["pages_per_shard"]
    assert g["recompute_j"] > 0.0


def test_request_deadline_expiring_mid_drain_reclaims_pages(runs):
    got = same(runs, "request_deadline_mid_drain", "fleet")
    f = got["fleet"]
    assert f["reason"]["9"] == "deadline"
    assert f["finished"]["0"] and f["finished"]["1"]
    assert got["live_free"] == got["live_whole"]


def test_deferred_work_never_targets_draining_shard(runs):
    got = same(runs, "deferred_not_draining", "fleet")
    st = got["fleet"]["stats"]
    assert st["deferred_released"] == st["deferred_requests"] == 2
    assert all(got["fleet"]["finished"].values())
    assert st["shard1_requests"] == got["before"]
    assert got["fleet"]["shard"]["10"] == got["fleet"]["shard"]["11"] == 0


def test_drain_validates(runs):
    got = same(runs, "drain_validates", "fleet")
    r = got["raised"]
    assert r[0][0] == "ValueError" and "out of range" in r[0][1]
    assert r[1][0] == "ValueError" and "dead" in r[1][1]
    assert r[2][0] == "FaultError" and "drainable" in r[2][1]
    assert got["moved"] == 0 and got["dead1"]
    assert r[3][0] == "ValueError" and "dead" in r[3][1]


def test_explicit_failover_migrates_watchdog_folds(runs):
    """An explicit fail_shard page-migrates (zero recompute J); a planned
    shard_down folds. Both equal the undisturbed fleet's tokens."""
    got = same(runs, "failover_modes", "want", "migrate", "fold")
    oracle(got["migrate"], got["want"])
    assert got["migrate"]["stats"]["migrations"] >= 1
    assert got["migrate"]["fleet_phase_j"]["recompute"] == 0.0
    oracle(got["fold"], got["want"])
    assert got["fold"]["stats"]["migrations"] == 0
    assert got["fold"]["fleet_phase_j"]["recompute"] > 0.0


def test_power_cap_sheds_by_migration_and_gates_placement(runs):
    got = same(runs, "cap_sheds", "want", "got")
    assert got["shed"] >= 1 and got["got"]["stats"]["migrations"] >= 1
    assert got["draw_after_cap"] <= got["cap"]
    assert got["capped_stats"]["power_cap_events"] == 1
    assert got["capped_stats"]["shard0_power_cap_w"] == \
        pytest.approx(got["cap"])
    oracle(got["got"], got["want"])
    assert got["draw_end"] <= got["cap"]
    assert got["lifted"]


def test_power_cap_sheds_lowest_priority_first(runs):
    got = same(runs, "cap_priority", "fleet")
    s_lo = got["s_lo"]
    before, after = got["placed"], got["after_cap"]
    if before["1"] == s_lo:            # co-located: the low one moves
        assert not (after["1"] != s_lo and after["0"] == s_lo), \
            "high-priority slot shed before the low-priority one"
    assert all(got["fleet"]["finished"].values())


def test_power_cap_validates(runs):
    got = same(runs, "cap_validates")
    r = got["raised"]
    assert r[0][0] == "ValueError" and "out of range" in r[0][1]
    assert r[1][0] == "ValueError" and "idle" in r[1][1]
    assert got["lift"] == 0


def test_random_admin_campaign_survivable(runs):
    got = same(runs, "admin_campaign", "fleet")
    assert got["same"] and got["any_admin"] and got["default_sites"]
    f = got["fleet"]
    assert all(f["finished"][rid] or f["reason"][rid] == "cancelled"
               for rid in f["finished"])
    assert got["fired_admin"] >= 1


def test_fleet_conservation_audit_catches_leak(runs):
    """A page leaked from a dead shard's frozen books breaks the fleet-wide
    sum; a live shard's refcount drift is caught too."""
    got = same(runs, "conservation_leak", "fleet")
    assert got["leak"][0] == "RuntimeError"
    assert "fleet-wide page conservation" in got["leak"][1]
    assert got["drift"][0] == "RuntimeError" and "audit" in got["drift"][1]


# ---------------------------------------------- the one-card pool programs


def _pool(S_, B, P, M, seed):
    """A random fleet cache tree: 2 paged layers (Hkv 2, ps 4, hd 8) over
    S_ shards of B slots and P pages, every page and row filled."""
    import torch
    from repro_torch.serving import paged as PG
    g = torch.Generator().manual_seed(seed)
    layers = [{"k_pages": torch.randn(2, S_ * P + 1, 4, 8, generator=g),
               "v_pages": torch.randn(2, S_ * P + 1, 4, 8, generator=g),
               "pos_ids": torch.randint(-1, 30, (S_ * B, M * 4),
                                        generator=g, dtype=torch.int32),
               "length": torch.randint(0, 30, (S_ * B,), generator=g,
                                       dtype=torch.int32)}
              for _ in range(2)]
    alloc = PG.init_allocator(B, M, P, "cpu", shards=S_)
    alloc["tbl"] = torch.randint(-1, P, (S_, B, M), generator=g,
                                 dtype=torch.int32)
    alloc["free"] = torch.stack([torch.randperm(P, generator=g)
                                 for _ in range(S_)]).to(torch.int32)
    alloc["top"] = torch.randint(0, P, (S_,), generator=g, dtype=torch.int32)
    alloc["ref"] = torch.randint(0, 3, (S_, P), generator=g,
                                 dtype=torch.int32)
    return {"t": torch.randint(0, 30, (S_ * B,), generator=g,
                               dtype=torch.int32),
            "layers": layers, "paged": alloc}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def test_quarantine_and_scrub_touch_only_their_shard():
    """``quarantine_table`` clears only the flagged shards' tables;
    ``scrub_pool`` resets only the flagged shards' allocator rows and
    cursor rows; neither writes a page; every other shard is
    bit-identical."""
    import torch
    from repro_torch.serving import paged as PG
    S_, B, P, M = 4, 3, 10, 5
    pool = _pool(S_, B, P, M, 0)
    old = _clone(pool)
    do = torch.tensor([False, True, False, True])
    q = PG.quarantine_table(pool["paged"], do)
    for s in range(S_):
        assert (q["tbl"][s] == -1).all() if do[s] else \
            torch.equal(q["tbl"][s], old["paged"]["tbl"][s])
    for k in ("free", "top", "ref"):
        assert torch.equal(q[k], old["paged"][k])
    PG.scrub_pool(pool, do)
    a, o = pool["paged"], old["paged"]
    for s in range(S_):
        rows = slice(s * B, (s + 1) * B)
        if do[s]:
            assert (a["tbl"][s] == -1).all() and (a["ref"][s] == 0).all()
            assert a["free"][s].tolist() == list(range(P))
            assert int(a["top"][s]) == P
            assert (pool["t"][rows] == 0).all()
        else:
            for k in ("tbl", "free", "ref"):
                assert torch.equal(a[k][s], o[k][s])
            assert int(a["top"][s]) == int(o["top"][s])
            assert torch.equal(pool["t"][rows], old["t"][rows])
        for layer, ol in zip(pool["layers"], old["layers"]):
            if do[s]:
                assert (layer["pos_ids"][rows] == -1).all()
                assert (layer["length"][rows] == 0).all()
            else:
                assert torch.equal(layer["pos_ids"][rows],
                                   ol["pos_ids"][rows])
                assert torch.equal(layer["length"][rows], ol["length"][rows])
    for layer, ol in zip(pool["layers"], old["layers"]):
        assert torch.equal(layer["k_pages"], ol["k_pages"])
        assert torch.equal(layer["v_pages"], ol["v_pages"])


def test_migrate_slot_copies_pages_onto_lifo_pops():
    """``migrate_slot`` from (s, b) to (d, bd): the destination pops its n
    pages in the reference's order (free[d, top-1-rank]), its row maps
    them and nothing else, each landed page equals its source page bit for
    bit in every layer, the cursor and decode rows are carried, and the
    source row releases sharing-aware (a page with another holder keeps
    it; the rest return to s's stack). No other shard changes."""
    import torch
    from repro_torch.serving import paged as PG
    from repro_torch.serving import sampling
    S_, B, P, M = 3, 2, 8, 4
    pool = _pool(S_, B, P, M, 1)
    a = pool["paged"]
    # a consistent allocator: shard 0 slot 1 maps pages 5, 2, 7 (page 2
    # shared with slot 0), shard 2's stack holds 6 free pages
    a["tbl"] = torch.full((S_, B, M), -1, dtype=torch.int32)
    a["tbl"][0, 1, :3] = torch.tensor([5, 2, 7], dtype=torch.int32)
    a["tbl"][0, 0, :2] = torch.tensor([2, 3], dtype=torch.int32)
    a["ref"] = torch.zeros((S_, P), dtype=torch.int32)
    a["ref"][0, [5, 7, 3]] = 1
    a["ref"][0, 2] = 2
    a["free"] = torch.tensor([[0, 1, 4, 6, 0, 0, 0, 0], list(range(P)),
                              [3, 0, 7, 1, 6, 2, 5, 4]], dtype=torch.int32)
    a["top"] = torch.tensor([4, P, 6], dtype=torch.int32)
    cur = torch.arange(S_ * B, dtype=torch.int32)[:, None] + 100
    state = sampling.init_slot_state(S_ * B, "cpu")
    state["active"][1] = True
    state["budget"][1] = 7
    state["eos"][1] = 42
    old = _clone(pool)
    row = PG.migrate_slot(pool, cur, state, (0, 1), (2, 1),
                          torch.tensor([5, 2, 7], dtype=torch.int32))
    new = pool["paged"]
    popped = [2, 6, 1]                 # free[2][top-1-rank], rank 0, 1, 2
    assert row.tolist() == popped + [-1]
    assert int(new["top"][2]) == 3
    assert new["ref"][2, popped].tolist() == [1, 1, 1]
    # source: row cleared, pages 5 and 7 back on shard 0's stack, page 2
    # kept by slot 0
    assert (new["tbl"][0, 1] == -1).all()
    assert torch.equal(new["tbl"][0, 0], old["paged"]["tbl"][0, 0])
    assert new["ref"][0].tolist() == [0, 0, 1, 1, 0, 0, 0, 0]
    assert int(new["top"][0]) == 6
    assert sorted(new["free"][0, :6].tolist()) == [0, 1, 4, 5, 6, 7]
    for k in ("tbl", "free", "ref"):
        assert torch.equal(new[k][1], old["paged"][k][1])
    for layer, ol in zip(pool["layers"], old["layers"]):
        for name in ("k_pages", "v_pages"):
            for src, dst in zip([5, 2, 7], popped):
                assert torch.equal(layer[name][:, 2 * P + dst],
                                   ol[name][:, src])
            untouched = [p for p in range(S_ * P + 1)
                         if p not in [2 * P + d for d in popped]]
            assert torch.equal(layer[name][:, untouched],
                               ol[name][:, untouched])
        assert torch.equal(layer["pos_ids"][2 * B + 1], ol["pos_ids"][1])
        assert torch.equal(layer["length"][2 * B + 1], ol["length"][1])
    assert int(pool["t"][2 * B + 1]) == int(old["t"][1])
    assert int(cur[2 * B + 1, 0]) == 101
    assert bool(state["active"][2 * B + 1]) and not bool(state["active"][1])
    assert int(state["budget"][2 * B + 1]) == 7
    assert int(state["eos"][2 * B + 1]) == 42


# ------------------------------------------------------------ the subprocess


def _main(path):
    import jax
    if jax.device_count() < 4:
        sys.exit("needs 4 host devices: set XLA_FLAGS=--xla_force_host_"
                 "platform_device_count=4 before the first jax import")
    side = Side("jax")
    out = {name: fn(side) for name, fn in SCENARIOS.items()}
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    _main(sys.argv[1])
