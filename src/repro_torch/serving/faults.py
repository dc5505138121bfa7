"""Fault injection for the serving engine's quantum loop (the port's copy
of ``repro.serving.faults``: plain Python, kept whole so the port imports
nothing of the reference package).

Robustness under partial failure is a sustainability lever, not just an
ops nicety: a serving fleet that drops in-flight requests on a transient
fault re-spends the full prefill + decode energy of every victim, and a
fleet that wedges leaks provisioned HBM (embodied carbon, paper Eq. 2-4)
until a human restarts it. The harness here lets tests and benches make
any of the engine's three device-work launch sites raise at a chosen
quantum, so the recovery contract — release the quantum's reservations,
re-queue (never drop) the in-flight requests, retry with exponential
backoff, keep every allocator invariant intact — is *asserted*, not
assumed.

Injectable sites (the strings ``ServingEngine._inject`` is called with):

  * ``"page_alloc"``     — the admission pass's page reservation, before
                           any slot is claimed for the quantum's takes.
  * ``"prefill_chunk"``  — the chunked-prefill launch, before the chunk
                           touches the device cache.
  * ``"decode_scan"``    — the fused decode chunk launch.
  * ``"shard_down"``     — whole-shard loss (fleet engines only): the
                           plan names a ``shard``; at the chosen quantum
                           the ``ShardedServingEngine`` declares it dead
                           and evacuates its in-flight work onto the
                           survivors. Not a retry site — there is no
                           backoff, the shard stays dead until an
                           explicit ``engine.rejoin(s)``.

Each site is placed BEFORE the corresponding device mutation, modelling a
launch failure (OOM, preempted device, lost worker): work that did not
happen must be retried, work that already happened is never double-done.

Beyond failures, campaigns can schedule ADMIN events (``ADMIN_SITES``):
``"drain"`` gracefully drains a shard (live KV-page migration to the
survivors, then a clean hand-off to the shard-down machinery) and
``"power_cap"`` imposes a brownout cap (the shard sheds low-priority
slots by migration until its modeled draw fits). Both name a ``shard``
like ``shard_down`` and are absorbed by ``admin_fires`` — declarations,
not retries.

``HealthMonitor`` is the fleet's watchdog: the sharded engine reports
which shards each faulted/successful launch touched, and a shard whose
CONSECUTIVE faulted-launch count exceeds ``max_retries`` is declared
dead (same budget the per-site backoff gives a launch site before
``FaultError`` — the watchdog converts "this site would wedge the run"
into "this shard is lost, keep serving on the rest" whenever a survivor
exists).

Usage::

    eng.faults = FaultInjector([FaultPlan("decode_scan", at_quantum=3)])
    eng.run()
    assert eng.faults.fired == [("decode_scan", 3)]

``FaultPlan(count=k)`` fires the site ``k`` consecutive times starting at
``at_quantum`` (measured in engine quanta, ``engine._quantum``); with
``count`` > ``EngineConfig.max_retries`` the engine gives up and raises
``FaultError`` with its state still consistent.
"""
from __future__ import annotations

import dataclasses
import random as _random
from typing import List, Optional, Sequence, Tuple

SITES = ("page_alloc", "prefill_chunk", "decode_scan", "shard_down")
# the retryable launch sites (everything but whole-shard loss)
LAUNCH_SITES = SITES[:3]
# admin events: not failures, but scheduled operator actions (graceful
# drain, brownout power cap) that random survivability campaigns can
# exercise alongside real faults. Opt-in (``FaultPlan.random(admin=True)``)
# so existing seeded campaigns keep their draw sequence bit-identical.
ADMIN_SITES = ("drain", "power_cap")


class InjectedFault(RuntimeError):
    """Raised by FaultInjector.check at a planned (site, quantum)."""


class FaultError(RuntimeError):
    """Raised out of ``engine.run()`` when a site keeps faulting past
    ``EngineConfig.max_retries`` consecutive attempts. Engine state is
    consistent: reservations returned, requests back on the queue."""


@dataclasses.dataclass
class FaultPlan:
    """Fire ``site`` for ``count`` consecutive quanta starting at
    ``at_quantum``. ``at_quantum`` counts the engine's scheduling quanta
    from the start of the CURRENT ``run()`` unless ``absolute`` is set
    (then it is the engine's lifetime quantum counter)."""
    site: str
    at_quantum: int
    count: int = 1
    absolute: bool = False
    # shard_down/drain/power_cap plans name a shard; launch-site plans
    # must not
    shard: Optional[int] = None
    # power_cap plans may name the cap in watts (None = the engine picks
    # a default between idle and TDP); meaningless for every other site
    watts: Optional[float] = None

    def __post_init__(self):
        if self.site not in SITES and self.site not in ADMIN_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; "
                f"one of {SITES + ADMIN_SITES}")
        if self.at_quantum < 0 or self.count < 1:
            raise ValueError("at_quantum must be >= 0 and count >= 1")
        if self.site in ("shard_down",) + ADMIN_SITES:
            if self.shard is None or self.shard < 0:
                raise ValueError(f"{self.site} plans need shard >= 0")
        elif self.shard is not None:
            raise ValueError(
                f"shard targets only apply to shard_down/admin sites, "
                f"not {self.site!r}")
        if self.watts is not None:
            if self.site != "power_cap":
                raise ValueError(
                    f"watts only applies to power_cap, not {self.site!r}")
            if self.watts <= 0:
                raise ValueError("watts must be > 0")

    @classmethod
    def random(cls, seed: int, n: int = 3,
               sites: Optional[Sequence[str]] = None,
               max_quantum: int = 16, max_count: int = 1,
               shards: Optional[int] = None,
               admin: bool = False) -> List["FaultPlan"]:
        """A reproducible randomized fault campaign: ``n`` plans drawn
        from ``sites`` (default: the launch sites, plus ``shard_down``
        when a fleet size ``shards`` is given, plus the admin sites
        ``drain``/``power_cap`` when additionally ``admin=True``) at
        quanta in ``[0, max_quantum]`` with counts in ``[1, max_count]``.
        The same ``seed`` yields the same campaign on every platform
        (stdlib ``random.Random``), so a CI failure names a replayable
        schedule — and ``admin`` defaults off so pre-existing seeded
        campaigns keep their exact draw sequence."""
        if sites is None:
            sites = LAUNCH_SITES + (("shard_down",) if shards else ())
            if admin and shards:
                sites = sites + ADMIN_SITES
        sharded_sites = ("shard_down",) + ADMIN_SITES
        if any(s in sharded_sites for s in sites) and not shards:
            raise ValueError(
                "shard_down/drain/power_cap campaigns need shards >= 1")
        rng = _random.Random(seed)
        plans = []
        for _ in range(n):
            site = rng.choice(list(sites))
            plans.append(cls(
                site,
                at_quantum=rng.randrange(max_quantum + 1),
                count=1 if site in sharded_sites
                else rng.randint(1, max_count),
                shard=rng.randrange(shards) if site in sharded_sites
                else None))
        return plans


class FaultInjector:
    """Holds the fault plans and a log of fired injections.

    The engine calls ``check(site, quantum, run_start)`` right before each
    launch; a matching live plan raises ``InjectedFault``. ``fired``
    records ``(site, quantum)`` per injection so tests can assert the
    exact fault schedule that actually executed.
    """

    def __init__(self, plans: Optional[List[FaultPlan]] = None):
        self.plans: List[FaultPlan] = list(plans or [])
        self.fired: List[Tuple[str, int]] = []

    def check(self, site: str, quantum: int, run_start: int = 0) -> None:
        for p in self.plans:
            q0 = p.at_quantum if p.absolute else run_start + p.at_quantum
            if p.site == site and q0 <= quantum < q0 + p.count:
                self.fired.append((site, quantum))
                raise InjectedFault(
                    f"injected fault at site={site!r} quantum={quantum}")

    def shard_down_fires(self, quantum: int, run_start: int = 0) -> List[int]:
        """Shard ids whose ``shard_down`` plans fire this quantum. Does
        not raise — shard loss is a declaration, not a retryable launch
        failure; the engine evacuates and keeps stepping. Each fired
        shard is logged once as ``("shard_down", quantum)``."""
        out = []
        for p in self.plans:
            if p.site != "shard_down":
                continue
            q0 = p.at_quantum if p.absolute else run_start + p.at_quantum
            if q0 <= quantum < q0 + p.count:
                self.fired.append(("shard_down", quantum))
                out.append(p.shard)
        return sorted(set(out))

    def admin_fires(self, quantum: int, run_start: int = 0
                    ) -> List[FaultPlan]:
        """Admin plans (``drain`` / ``power_cap``) firing this quantum.
        Like ``shard_down_fires``, a declaration rather than a retryable
        launch failure — the engine absorbs each returned plan (skipping
        shards that are already dead, draining, or the last live one) and
        keeps stepping. Each fired plan logs as ``(site, quantum)``."""
        out = []
        for p in self.plans:
            if p.site not in ADMIN_SITES:
                continue
            q0 = p.at_quantum if p.absolute else run_start + p.at_quantum
            if q0 <= quantum < q0 + p.count:
                self.fired.append((p.site, quantum))
                out.append(p)
        return out


class HealthMonitor:
    """Fleet health watchdog: per-shard consecutive-faulted-launch
    counters plus the authoritative dead set.

    The sharded engine reports every launch outcome with the set of
    shards the launch TOUCHED (shards with packed prefill work, armed
    decode slots, or admission takes this quantum). A successful launch
    clears its shards' counters; a shard whose consecutive count exceeds
    ``max_retries`` is returned by ``record_fault`` as newly-suspect and
    the engine declares it dead — the same budget a launch site gets
    before ``FaultError``, so the watchdog fires exactly when the site
    discipline would otherwise wedge the run. Explicit injection
    (``shard_down`` plans) and recovery (``engine.rejoin``) go through
    ``declare_down`` / ``declare_up``; ``events`` logs every transition
    as ``(quantum, "down"|"up", shard)`` for tests and benches."""

    def __init__(self, n_shards: int, max_retries: int = 3):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self.max_retries = max_retries
        self.fails = [0] * n_shards        # consecutive faulted launches
        self.dead: set = set()
        self.events: List[Tuple[int, str, int]] = []

    def record_fault(self, shards: Sequence[int]) -> List[int]:
        """A launch touching ``shards`` faulted; returns the shards whose
        consecutive count just exceeded ``max_retries`` (not yet declared
        — the engine owns declaration so evacuation is atomic with it)."""
        suspect = []
        for s in shards:
            if s in self.dead:
                continue
            self.fails[s] += 1
            if self.fails[s] > self.max_retries:
                suspect.append(s)
        return suspect

    def record_ok(self, shards: Sequence[int]) -> None:
        """A launch touching ``shards`` succeeded; their counters reset."""
        for s in shards:
            self.fails[s] = 0

    def declare_down(self, shard: int, quantum: int) -> None:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        if shard not in self.dead:
            self.dead.add(shard)
            self.fails[shard] = 0
            self.events.append((quantum, "down", shard))

    def declare_up(self, shard: int, quantum: int) -> None:
        if shard in self.dead:
            self.dead.discard(shard)
            self.fails[shard] = 0
            self.events.append((quantum, "up", shard))

    def is_dead(self, shard: int) -> bool:
        return shard in self.dead

    @property
    def live(self) -> List[int]:
        return [s for s in range(self.n_shards) if s not in self.dead]
