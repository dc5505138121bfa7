"""Data-parallel serving fleet (the port of ``repro.serving.sharded``): S
serving shards behind one queue, each with its own slots, page pool and
free stack, served on ONE card by one forward over all S·B slot rows.

The reference shards the engine over a JAX device mesh, one shard a
device, and runs the single-device step in a ``shard_map`` body. Here the
S shards are a leading axis of the device state on one device:

  * per-slot rows (``t``, each layer's ``pos_ids`` and ``length``) and
    the slot state are flat, (S*B, ...), shard s at rows [s*B, (s+1)*B);
  * each attention leaf's pool holds the S shards' pages side by side
    and one trash page, (Hkv, S*P + 1, ps, hd), shard s's page p at pool
    page s*P + p;
  * the allocator has a leading shard axis: tbl (S, B, M), free (S, P),
    top (S,), ref (S, P), and every allocator function of
    ``serving/paged.py`` runs all shards at once, each popping from and
    returning to its own stack (a single engine is S = 1);
  * a decode micro-step and a prefill chunk launch each run the model ONCE
    over the fleet's rows: ``paged.model_table`` turns the shard-local
    table into pool page ids ``s*P + p``, so each attention kernel
    launches once per layer for every shard, and one host sync per
    ``sync_every`` micro-steps serves the whole fleet on the stacked
    (n_steps, S, B) token and emission matrices.

A lane of a fleet-wide allocator call with nothing to do is the sentinel
slot B (one past the shard's slots): the reference relies on JAX dropping
out-of-range scatters and clamping gathers; here each such write lands in
a scratch row that is cut off (``paged._put_rows``), and the model sees
only real rows, except on a ``moe`` model.

A ``moe`` model routes each shard's tokens against that shard's own
expert capacity, as the reference's ``shard_map`` body runs the
single-device ``moe_ffn`` on each shard's rows: the fleet's forward takes
its rows as S groups (``Model.grouped``, ``moe.moe_apply``), each with
its own capacity, buffers and drops. A decode step's groups are the
shards' B slot rows; a prefill chunk launch runs every shard's n lanes,
an idle lane as the reference runs its sentinel: slot B read as slot B-1
(JAX's clamped gather), no token, its state not written back.

Host-side scheduling is shard-aware, as in the reference: admission
places each request on one shard (``routing="free_pages"``: the longest
resident prefix, then the most free pages; ``routing="carbon"``: the
lowest marginal gCO2 at each shard's hardware profile and grid region,
``core/scheduler.marginal_request_g``), with reservation accounting per
shard and FCFS; the prefix index, preemption pins and release accounting
are per shard, so adoption never crosses shards. Every shard prices its
work on its own ``CarbonMeter``, all on one ``SharedClock`` that advances
by the slowest shard's modeled time each quantum; ``FleetMeterView`` sums
them. Temporal deferral, the front door and fault recovery are the single
engine's, borrowed.

A shard is a fault domain, as in the reference. ``fail_shard`` (an
operator's declaration, a planned ``shard_down``, or the watchdog turning
a launch site's retry exhaustion into the loss of the shards it touched)
evacuates the shard's in-flight work onto the survivors, by page
migration where the shard can still serve a copy and through the
preemption fold otherwise, clears the dead shard's block table so its
rows, which ride every fleet forward, write only to the trash page, and
re-denominates its embodied rent onto the live shards; ``rejoin`` scrubs
its half of the allocator and its cursor rows. The admin paths ride live
KV-page migration (``paged.migrate_slot``: on one card an index copy from
the source shard's pages of each pool to fresh pages of the
destination's): ``drain`` moves a shard's slots to the survivors between
quanta and hands the empty shard to ``fail_shard``, and ``power_cap``
sheds a shard's lowest-priority slots until its modeled draw fits the
cap. A copy is metered to the ``migrate`` phase on both endpoints.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.energy import decode_counts, migrate_counts, step_energy
from repro_torch.core.hardware import HardwareProfile, get_profile
from repro_torch.core.intensity import Region, ci_at_hour, get_region
from repro_torch.core.meter import CarbonMeter, FleetMeterView, SharedClock
from repro_torch.core.scheduler import (FleetSlice, marginal_request_g,
                                        migration_cost_g)
from repro_torch.models.costing import workload_of
from repro_torch.models.model import Model
from repro_torch.serving import paged as PG
from repro_torch.serving import graphs, preempt, sampling
from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                        _prefill_phase_counts, pack_chunks)
from repro_torch.serving.faults import FaultError, HealthMonitor, InjectedFault
from repro_torch.serving.request import Request, Response

class ShardedServingEngine:
    """Data-parallel fleet of ``cfg.shards`` serving shards behind one
    queue: per-shard slot pools, page pools and free stacks; fleet-wide
    launches; shard-aware host scheduling. Requires the paged pool and
    chunked prefill (``cfg.paged`` + ``cfg.prefill_chunk``): the quantum
    scheduler is what lets one launch carry every shard's prefill chunk
    and decode step. ``cfg.max_batch`` and ``cfg.num_pages`` are PER
    SHARD ("4 shards of B", "equal per-device pool bytes")."""

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 device: Union[str, torch.device] = "cuda"):
        if cfg.shards < 1:
            raise ValueError("shards must be >= 1")
        if not cfg.paged or cfg.prefill_chunk is None:
            raise ValueError(
                "sharded serving requires the paged pool + chunked "
                "prefill (paged=True, prefill_chunk set): the quantum "
                "scheduler is what packs every shard's prefill chunk and "
                "decode step into single fleet-wide launches")
        # reuse the single-device engine's full validation (pool geometry,
        # model capability gates) on a throwaway instance, then discard its
        # device state — the fleet builds its own
        probe = ServingEngine(model, params, cfg, device=device)
        # expert capacity per shard: the forward's rows as S groups
        self.grouped = model.cfg.moe is not None
        if self.grouped:
            model = model.grouped(cfg.shards)
        self.model, self.params, self.cfg = model, params, cfg
        self.device = probe.device
        self.workload = workload_of(model.cfg)
        S, B = cfg.shards, cfg.max_batch
        self.S, self.B = S, B
        # ---- heterogeneous fleet: per-shard hardware profile + region.
        # The MODEL runs identically on every shard (one forward over the
        # fleet's rows); heterogeneity lives in attribution and placement.
        prof_names = (list(cfg.shard_profiles) if cfg.shard_profiles
                      is not None else [cfg.profile] * S)
        region_names = (list(cfg.shard_regions) if cfg.shard_regions
                        is not None else [cfg.region] * S)
        if len(prof_names) != S:
            raise ValueError(
                f"shard_profiles has {len(prof_names)} entries for "
                f"{S} shards")
        if len(region_names) != S:
            raise ValueError(
                f"shard_regions has {len(region_names)} entries for "
                f"{S} shards")
        self.shard_profile: List[HardwareProfile] = [
            get_profile(n) for n in prof_names]
        self.shard_region: List[Region] = [
            get_region(r) for r in region_names]
        # one meter PER SHARD at that shard's profile x region CI, all on
        # one fleet clock (shards run in parallel — the engine advances the
        # clock once per quantum by the slowest shard's modeled time, so
        # advances_clock=False here). Fleet totals are the exact sum of the
        # per-shard attribution via FleetMeterView; each shard's embodied
        # amortization covers ITS cfg.n_devices devices.
        self.clock = SharedClock()
        self.meters: List[CarbonMeter] = [
            CarbonMeter(self.shard_profile[s], self.shard_region[s],
                        lifetime_years=cfg.lifetime_years,
                        n_devices=cfg.n_devices,
                        use_diurnal_ci=cfg.use_diurnal_ci,
                        clock=self.clock, advances_clock=False)
            for s in range(S)]
        self.meter = FleetMeterView(self.meters)
        # the carbon router scores shards through the SAME FleetSlice /
        # marginal-g machinery as the offline CIDirectedScheduler
        self._slices: List[FleetSlice] = [
            FleetSlice(self.shard_profile[s], self.shard_region[s],
                       lifetime_years=cfg.lifetime_years)
            for s in range(S)]
        self._q_time = [0.0] * S       # per-shard modeled time this quantum
        self.shard_requests = [0] * S  # placements per shard (stats)
        self.max_pages_slot = probe.max_pages_slot
        self.num_pages = probe.num_pages        # per shard
        del probe

        # ---- device state: S shards' slots as flat rows, S pools side by
        # side, the allocator with a leading shard axis
        self.caches = PG.paginate_cache(
            model.init_cache(S * B, cfg.max_len), B, cfg.page_size,
            self.num_pages, shards=S)
        self.cur_tokens = torch.zeros((S * B, 1), dtype=torch.int32,
                                      device=self.device)
        self.state = sampling.init_slot_state(S * B, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self.graphs = graphs.DecodeGraphs(model, params, self.cur_tokens,
                                          self.state, self._gen)

        # ---- host mirrors, one entry per shard
        self.queue: deque = deque()
        self.responses: Dict[int, Response] = {}
        self.slot_rid = [[-1] * B for _ in range(S)]
        self.slot_budget = [[0] * B for _ in range(S)]
        self.slot_eos: List[List[Optional[int]]] = [[None] * B
                                                    for _ in range(S)]
        self._slot_ctx = [[0.0] * B for _ in range(S)]
        self._slot_armed = [[False] * B for _ in range(S)]
        self._req_slo: Dict[int, Optional[float]] = {}
        self.free_pages = [self.num_pages] * S
        self.peak_pages_reserved = [0] * S
        self._slot_pages = [[0] * B for _ in range(S)]
        self._prefilling: List[deque] = [deque() for _ in range(S)]
        self._req_shard: Dict[int, int] = {}
        # front-door mirrors + counters (see ServingEngine.__init__)
        self._slot_req: List[List[Optional[Request]]] = [
            [None] * B for _ in range(S)]
        self._slot_prio = [[0] * B for _ in range(S)]
        self._has_deadlines = False
        self._quantum = 0
        self._run_q0 = 0
        self.faults = None
        self._backoff: Dict[str, Tuple[int, int]] = {}
        self.fault_retries = 0
        self.fault_retry_site: Dict[str, int] = {}
        # per-(site, shard) retry counters: every faulted launch charges
        # the shards it touched (stats() splits fault_retries out by both)
        self._fault_retry_shard: Dict[Tuple[str, int], int] = {}
        # the fleet's health watchdog: a shard is declared dead by a
        # planned shard_down, an operator's fail_shard, or max_retries
        # consecutive faulted launches that touched it while a survivor
        # exists; declaration evacuates its in-flight work (fail_shard)
        self.health = HealthMonitor(S, cfg.max_retries)
        self.shard_down_events = 0
        self.shard_evacuated = 0       # requests moved off dead shards
        self.shard_rejoins = 0
        # live KV-page migration: draining shards take no new placements
        # and page-copy their slots to the survivors between quanta;
        # capped shards shed slots until their modeled draw fits
        self._draining: set = set()
        self._drain_deadline: Dict[int, Optional[float]] = {}
        self._power_cap: List[Optional[float]] = [None] * S
        self.migrations = 0            # completed slot migrations
        self.migrated_pages = 0        # pages copied between shards
        self.drain_events = 0
        self.power_cap_events = 0
        # the host's waits for the device outside ``host_syncs``: table
        # fetches of a migration sweep, destination rows re-indexed after
        # a migration, and audit()'s allocator fetches
        self.fetches = {"table": 0, "row": 0, "audit": 0}
        # per-tenant rate limiting (submit() is borrowed, so the fleet
        # carries the same bucket state as the single-device engine)
        self._tenant_buckets: Dict[str, List[float]] = {}
        self.rate_limited = 0
        self.shed_count = 0
        self._shed_by_class: Dict[int, int] = {}
        self.preemption_count = 0
        self.deadline_cancelled = 0
        self.clamped_requests = 0
        self.preempted_recompute_j = 0.0
        self._wait_samples: Dict[int, List[float]] = {}
        # preemption pins are shard-local: rid -> (shard, [phys pages])
        self._pins: Dict[int, Tuple[int, List[int]]] = {}
        # temporal deferral (borrowed policy; the clock is the fleet's)
        self.deferred: deque = deque()
        self.deferred_rids: set = set()
        self._defer_release_h: Dict[int, float] = {}
        self._forecasters: Dict[str, object] = {}
        self.deferred_total = 0
        self.deferred_released = 0
        self.deferred_forced = 0

        self.sharing = cfg.prefix_sharing
        if self.sharing:
            # SHARD-LOCAL prefix index: one index per shard, so adoption
            # never crosses shards and decref accounting stays local to the
            # holder's free stack
            self._prefix_index: List[Dict[bytes, int]] = [
                {} for _ in range(S)]
            self._page_key: List[Dict[int, bytes]] = [{} for _ in range(S)]
            self._page_ref: List[Dict[int, int]] = [{} for _ in range(S)]
            self._slot_shared_in: List[Dict[int, List[int]]] = [
                {} for _ in range(S)]
            self._slot_own_idx: List[Dict[int, List[int]]] = [
                {} for _ in range(S)]
            self.prefix_hit_tokens = 0
            self.prefix_shared_requests = 0

        # step counting matches the single-device engine exactly: a fleet
        # micro-step counts toward _steps only if SOME shard emitted, and
        # shard_steps counts (micro-step, shard) pairs with >= 1 emission
        self._steps = 0
        self.shard_steps = 0
        self.decode_chunks = 0         # fleet-wide device->host syncs
        self.prefill_batches = 0       # first-token syncs
        self.prefill_chunks = 0        # fleet chunk launches
        self.peak_active = 0

    # ---------------------------------------------------------- small utils
    def free_slots(self, s: int) -> List[int]:
        return [i for i, r in enumerate(self.slot_rid[s]) if r < 0]

    @property
    def active(self) -> int:
        return sum(1 for s in range(self.S)
                   for r in self.slot_rid[s] if r >= 0)

    @property
    def decoding(self) -> int:
        return sum(1 for s in range(self.S)
                   for a in self._slot_armed[s] if a)

    def _rows(self, pairs) -> List[int]:
        """Flat per-slot rows of (shard, slot) pairs."""
        return [s * self.B + b for s, b in pairs]

    # ------------------------------------------- borrowed host-side logic
    # identical to the single-device engine — borrowed, not copied, so a
    # fix there reaches the fleet. Queue/budget bookkeeping, the front
    # door and deferral are device-count agnostic by construction; the
    # chunk launch takes the allocator's (S, n) lanes as they are.
    _prompt_page_keys = ServingEngine._prompt_page_keys
    _over_budget = ServingEngine._over_budget
    _reject = ServingEngine._reject
    submit = ServingEngine.submit
    _enqueue = ServingEngine._enqueue
    _pick_shed_victim = ServingEngine._pick_shed_victim
    _shed = ServingEngine._shed
    _apply_pressure_clamp = ServingEngine._apply_pressure_clamp
    _stamp_admit = ServingEngine._stamp_admit
    _cancel = ServingEngine._cancel
    _inject = ServingEngine._inject
    _site_ready = ServingEngine._site_ready
    _faults_pending = ServingEngine._faults_pending
    _rate_limit = ServingEngine._rate_limit
    _tensor = ServingEngine._tensor
    _chunk_launch = ServingEngine._chunk_launch
    # temporal deferral is pure host-side policy too; only the TIME BASE
    # differs (the fleet's shared clock) — see the overrides below
    _defer = ServingEngine._defer
    _release_deferred = ServingEngine._release_deferred
    _fast_forward_deferred = ServingEngine._fast_forward_deferred
    _forecaster = ServingEngine._forecaster

    def _clock_hours(self) -> float:
        return self.clock.hours

    def _advance_clock_to(self, hours: float) -> None:
        self.clock.hours = max(self.clock.hours, hours)

    def _defer_regions(self) -> List[Region]:
        # dedup preserving order: S shards usually span few regions
        seen: Dict[str, Region] = {}
        for r in self.shard_region:
            seen.setdefault(r.name, r)
        return list(seen.values())

    # ---------------------------------------------------- per-shard metering
    # Same step counts as the single-device engine, priced at THIS shard's
    # profile and recorded on its meter; the per-quantum max of the shard
    # times advances the fleet clock (shards run in parallel).
    def _meter_prefill(self, batch: int, seq: int,
                       useful_seq: Optional[float] = None, skip: int = 0,
                       phase: str = "prefill", shard: int = 0):
        counts = _prefill_phase_counts(self.workload, batch, seq,
                                       useful_seq=useful_seq, skip=skip)
        rep = step_energy(self.shard_profile[shard], counts)
        self.meters[shard].record(phase, rep.tokens, rep.t_total,
                                  rep.energy_j)
        self._q_time[shard] += rep.t_total
        return rep

    def _meter_decode(self, batch: int, context: float, shard: int = 0):
        counts = decode_counts(self.workload, batch, context)
        rep = step_energy(self.shard_profile[shard], counts)
        self.meters[shard].record("decode", rep.tokens, rep.t_total,
                                  rep.energy_j)
        self._q_time[shard] += rep.t_total
        return rep

    def _meter_migrate(self, src: int, dst: int, kv_tokens: float) -> None:
        """Charge a page copy to the ``migrate`` phase on BOTH endpoints,
        each at its own profile (prefill and decode J per token stay
        invariant to migration policy); each side's modeled time joins its
        own quantum total."""
        counts = migrate_counts(self.workload, kv_tokens)
        for s in (src, dst):
            rep = step_energy(self.shard_profile[s], counts)
            self.meters[s].record("migrate", rep.tokens, rep.t_total,
                                  rep.energy_j)
            self._q_time[s] += rep.t_total

    # ------------------------------------------------------- prefix sharing
    def _match_prefix(self, req: Request, s: int) -> Tuple[int, List[int]]:
        """Longest prefix of the prompt resident in SHARD ``s``'s index."""
        phys: List[int] = []
        for k in self._prompt_page_keys(req):
            p = self._prefix_index[s].get(k)
            if p is None:
                break
            phys.append(p)
        return len(phys), phys

    def _drop_index_page(self, s: int, p: int) -> None:
        key = self._page_key[s].pop(p, None)
        if key is not None:
            self._prefix_index[s].pop(key, None)
        self._page_ref[s].pop(p, None)

    def _register_prefix(self, req: Request, s: int, slot: int,
                         row: np.ndarray) -> None:
        own = self._slot_own_idx[s].setdefault(slot, [])
        for i, key in enumerate(self._prompt_page_keys(req)):
            p = int(row[i])
            if key not in self._prefix_index[s]:
                self._prefix_index[s][key] = p
                self._page_key[s][p] = key
                self._page_ref[s][p] = self._page_ref[s].get(p, 0) + 1
                own.append(p)

    # -------------------------------------------------------------- release
    def _release_slots(self, pairs: List[Tuple[int, int]]) -> None:
        """Return finished (shard, slot) pairs' pages: ONE fleet-wide
        release + per-shard host reservation accounting (the same
        popper-charges-once / last-holder-credits-once flows as the
        single-device engine, applied within each shard)."""
        if not pairs:
            return
        mask = np.zeros((self.S, self.B), bool)
        for s, b in pairs:
            mask[s, b] = True
        self.caches["paged"] = PG.release_slots(
            self.caches["paged"], self._tensor(mask).bool())
        for s, b in pairs:
            ret = self._slot_pages[s][b]
            if self.sharing:
                for p in self._slot_own_idx[s].pop(b, []):
                    self._page_ref[s][p] -= 1
                    if self._page_ref[s][p] <= 0:
                        self._drop_index_page(s, p)
                    else:
                        ret -= 1       # survives under someone else's map
                for p in self._slot_shared_in[s].pop(b, []):
                    self._page_ref[s][p] -= 1
                    if self._page_ref[s][p] <= 0:
                        self._drop_index_page(s, p)
                        ret += 1       # last holder frees the original
            self.free_pages[s] += ret
            self._slot_pages[s][b] = 0

    # ------------------------------------------------------------ preemption
    # same eviction/resume contract as the single-device engine
    # (serving/preempt.py); pins and victims are SHARD-LOCAL, and _place's
    # longest-resident-prefix preference steers a resumed request back to
    # the shard still holding its pinned pages.

    def _drop_pin(self, rid: int) -> None:
        pin = self._pins.pop(rid, None)
        if pin is None:
            return
        s, pins = pin
        if self.health.is_dead(s):
            return                     # never decref a dead pool
        pages = np.full((self.S, self.max_pages_slot), -1, np.int32)
        pages[s, :len(pins)] = pins
        self.caches["paged"] = PG.decref_pages(self.caches["paged"],
                                               self._tensor(pages))
        for p in pins:
            self._page_ref[s][p] -= 1
            if self._page_ref[s][p] <= 0:
                self._drop_index_page(s, p)
                self.free_pages[s] += 1

    def _try_preempt(self, req: Request) -> bool:
        """Evict the fleet-wide best victim (lowest class, least progress,
        shard-local page return) strictly below ``req``'s class; True if a
        slot was freed somewhere. Placement re-runs afterwards."""
        if not self.cfg.preemption:
            return False
        best = None
        for s in range(self.S):
            progress = [
                (self._slot_req[s][b].max_new_tokens
                 - self.slot_budget[s][b])
                if self._slot_req[s][b] is not None else 0
                for b in range(self.B)]
            b = preempt.pick_victim(self._slot_armed[s],
                                    self._slot_prio[s], progress,
                                    req.priority)
            if b is None:
                continue
            key = (self._slot_prio[s][b], progress[b], -s)
            if best is None or key < best[0]:
                best = (key, s, b)
        if best is None:
            return False
        self._evict_slot(best[1], best[2])
        return True

    def _evict_slot(self, s: int, slot: int) -> None:
        req = self._slot_req[s][slot]
        resp = self.responses[req.rid]
        remaining = self.slot_budget[s][slot]
        preempt.fold_for_resume(req, resp, remaining)
        pinned: List[int] = []
        if self.sharing:
            held = set(self._slot_shared_in[s].get(slot, []))
            held |= set(self._slot_own_idx[s].get(slot, []))
            pinned = preempt.pinned_run(self._prompt_page_keys(req),
                                        self._prefix_index[s], held)
        mask = np.zeros((self.S, self.B), bool)
        mask[s, slot] = True
        n_keep = np.zeros((self.S, self.B), np.int32)
        n_keep[s, slot] = len(pinned)
        self.caches["paged"] = PG.release_slots_keep(
            self.caches["paged"], self._tensor(mask).bool(),
            self._tensor(n_keep))
        sampling.disarm_slots(self.state,
                              self._tensor(self._rows([(s, slot)])))
        self._account_eviction(s, slot, pinned)
        if pinned:
            self._pins[req.rid] = (s, pinned)
        self._clear_slot(s, slot)
        self._req_shard.pop(req.rid, None)
        self.preemption_count += 1
        self._enqueue(req, resume=True)

    def _account_eviction(self, s: int, slot: int,
                          pinned: List[int]) -> None:
        ret = self._slot_pages[s][slot]
        if self.sharing:
            keep = set(pinned)
            for p in self._slot_own_idx[s].pop(slot, []):
                if p in keep:
                    ret -= 1           # stays resident under the pin
                    continue
                self._page_ref[s][p] -= 1
                if self._page_ref[s][p] <= 0:
                    self._drop_index_page(s, p)
                else:
                    ret -= 1           # survives under someone else's map
            for p in self._slot_shared_in[s].pop(slot, []):
                if p in keep:
                    continue           # adopted ref transferred to the pin
                self._page_ref[s][p] -= 1
                if self._page_ref[s][p] <= 0:
                    self._drop_index_page(s, p)
                    ret += 1           # last holder frees the original
        self.free_pages[s] += ret
        self._slot_pages[s][slot] = 0

    def _clear_slot(self, s: int, slot: int) -> None:
        self.slot_rid[s][slot] = -1
        self.slot_budget[s][slot] = 0
        self.slot_eos[s][slot] = None
        self._slot_ctx[s][slot] = 0.0
        self._slot_armed[s][slot] = False
        self._slot_req[s][slot] = None
        self._slot_prio[s][slot] = 0

    # ------------------------------------------------- live KV-page migration
    # The recompute-free counterpart of evacuation: a slot's mapped pages
    # are COPIED to fresh pages of a survivor's half of the pool
    # (paged.migrate_slot), its host mirrors move with it, and decode
    # resumes on the destination from the same context: token for token
    # the undisturbed run, zero recompute J. Shared-prefix runs migrate as
    # private copies and re-register in the destination's index; the
    # source's entries survive under their remaining holders or fall out
    # with the last reference, as in an ordinary release. Three consumers:
    # drain(), reachable evacuation (fail_shard), power_cap().

    def _fetch_tbl(self) -> np.ndarray:
        # writable copy: shed sweeps mark migrated rows cleared in place
        self.fetches["table"] += 1
        return np.array(self.caches["paged"]["tbl"].cpu().numpy())

    def _resv_for_move(self, s: int, b: int) -> int:
        """Worst-case reservation the DESTINATION must hold for slot
        (s, b): the request's whole prompt + budget page count, with no
        sharing discount (migrated pages land as private copies)."""
        req = self._slot_req[s][b]
        return PG.pages_needed(
            len(req.prompt) + max(req.max_new_tokens - 1, 0),
            self.cfg.page_size)

    def _pick_migration_dest(self, s: int, resv_d: int) -> Optional[int]:
        """Best survivor to receive a slot from shard ``s``: live, not
        draining, a free slot and room for the whole private reservation.
        Most free pages, then lowest id; carbon routing breaks free-page
        ties by the cheaper copy (``migration_cost_g`` at the
        destination's profile and current CI)."""
        carbon = self.cfg.routing == "carbon"
        kv_tokens = float(resv_d * self.cfg.page_size)
        best = None
        for d in self.health.live:
            if d == s or d in self._draining:
                continue
            if not self.free_slots(d) or self.free_pages[d] < resv_d:
                continue
            key: Tuple = (self.free_pages[d], -d)
            if carbon:
                region = self.shard_region[d]
                ci = (ci_at_hour(region, self._clock_hours() % 24.0)
                      if self.cfg.use_diurnal_ci else region.ci_g_per_kwh)
                g, _ = migration_cost_g(self._slices[d], self.workload,
                                        kv_tokens, ci=ci)
                key = (self.free_pages[d], -g, -d)
            if best is None or key > best[0]:
                best = (key, d)
        return None if best is None else best[1]

    def _migrate_slot(self, s: int, b: int, d: int,
                      src_row: np.ndarray) -> None:
        """Move slot (s, b) to shard ``d``: the device copies its pages
        and decode rows and releases the source (``paged.migrate_slot``),
        then the host mirrors move: the source is credited like a release
        (sharing-aware), the destination claims a slot and the whole
        private reservation. An armed slot re-registers its prompt pages
        in the destination's prefix index from the NEW table row (one
        fetch); a mid-prefill slot registers at prefill completion."""
        req = self._slot_req[s][b]
        rid = self.slot_rid[s][b]
        n = int((src_row >= 0).sum())
        slot_d = self.free_slots(d)[0]
        resv_d = self._resv_for_move(s, b)
        budget, eos = self.slot_budget[s][b], self.slot_eos[s][b]
        ctx, armed = self._slot_ctx[s][b], self._slot_armed[s][b]
        prio = self._slot_prio[s][b]
        dst_row = PG.migrate_slot(self.caches, self.cur_tokens, self.state,
                                  (s, b), (d, slot_d),
                                  self._tensor(src_row[:n]))
        # source credit: the device release already ran; the same
        # popper-charges-once / last-holder-credits-once flows as
        # _release_slots
        ret = self._slot_pages[s][b]
        if self.sharing:
            for p in self._slot_own_idx[s].pop(b, []):
                self._page_ref[s][p] -= 1
                if self._page_ref[s][p] <= 0:
                    self._drop_index_page(s, p)
                else:
                    ret -= 1           # survives under someone else's map
            for p in self._slot_shared_in[s].pop(b, []):
                self._page_ref[s][p] -= 1
                if self._page_ref[s][p] <= 0:
                    self._drop_index_page(s, p)
                    ret += 1           # last holder frees the original
        self.free_pages[s] += ret
        self._slot_pages[s][b] = 0
        self._clear_slot(s, b)
        # destination claim: admission's mirror writes, but the slot
        # arrives mid-flight (context, budget and armed state kept)
        self.free_pages[d] -= resv_d
        self.peak_pages_reserved[d] = max(
            self.peak_pages_reserved[d],
            self.num_pages - self.free_pages[d])
        self.slot_rid[d][slot_d] = rid
        self.slot_budget[d][slot_d] = budget
        self.slot_eos[d][slot_d] = eos
        self._slot_ctx[d][slot_d] = ctx
        self._slot_armed[d][slot_d] = armed
        self._slot_pages[d][slot_d] = resv_d
        self._slot_req[d][slot_d] = req
        self._slot_prio[d][slot_d] = prio
        self._req_shard[rid] = d
        if self.sharing:
            # copy-then-reindex: the landed pages are private (ref 1); an
            # armed slot's completed prompt registers them in the
            # destination's index first-writer-wins, so later arrivals
            # adopt from the survivor
            self._slot_shared_in[d][slot_d] = []
            self._slot_own_idx[d][slot_d] = []
            if armed:
                self.fetches["row"] += 1
                self._register_prefix(req, d, slot_d,
                                      dst_row.cpu().numpy())
        if not armed:
            self._prefilling[s].remove((req, b))
            self._prefilling[d].append((req, slot_d))
        self._meter_migrate(s, d, float(n * self.cfg.page_size))
        self.migrations += 1
        self.migrated_pages += n

    # ------------------------------------------------------- graceful drain
    def drain(self, s: int, deadline_s: Optional[float] = None) -> int:
        """Gracefully drain shard ``s``: stop placing new work on it,
        page-copy its armed and mid-prefill slots to the survivors between
        quanta (token for token the undrained run, zero recompute J), then
        hand the empty shard to ``fail_shard``. ``deadline_s`` (wall
        clock) bounds the wait for destination capacity: past it the
        remainder is evacuated (migrate what fits, fold the rest). Returns
        the number of slots the immediate first sweep migrated."""
        if not 0 <= s < self.S:
            raise ValueError(f"shard {s} out of range for {self.S} shards")
        if self.health.is_dead(s):
            raise ValueError(f"shard {s} is dead")
        if s in self._draining:
            return 0
        if not [d for d in self.health.live
                if d != s and d not in self._draining]:
            raise FaultError(
                f"shard {s} is the last drainable shard — nowhere to "
                "migrate; fleet state is untouched")
        self._draining.add(s)
        self._drain_deadline[s] = (
            None if deadline_s is None
            else time.perf_counter() + deadline_s)
        self.drain_events += 1
        return self._drain_quantum(s)

    def _finish_drain(self, s: int) -> None:
        """The drained shard is empty: declare it down. If the fleet is
        down to one live shard, the drain aborts instead and the shard
        stays live and placeable."""
        self._draining.discard(s)
        self._drain_deadline.pop(s, None)
        if len(self.health.live) <= 1:
            return
        self.fail_shard(s)             # empty: evacuation is a no-op

    def _drain_quantum(self, s: int) -> int:
        """One drain sweep of shard ``s``: migrate every occupied slot a
        survivor can take now; the rest keep decoding on ``s`` until
        capacity frees. Finishes the drain when the shard is empty."""
        moved = 0
        occupied = [b for b in range(self.B) if self.slot_rid[s][b] >= 0]
        tbl: Optional[np.ndarray] = None
        for b in occupied:
            d = self._pick_migration_dest(s, self._resv_for_move(s, b))
            if d is None:
                continue               # wait for capacity, keep decoding
            if tbl is None:
                # one fetch serves the sweep: migrating slot b clears
                # only row b of the source
                tbl = self._fetch_tbl()
            self._migrate_slot(s, b, d, tbl[s][b])
            moved += 1
        if all(r < 0 for r in self.slot_rid[s]) and not self._prefilling[s]:
            self._finish_drain(s)
        return moved

    def _drain_sweep(self) -> int:
        """A quantum's drain progress for every draining shard; an expired
        drain deadline evacuates the remainder through ``fail_shard``."""
        moved = 0
        now = time.perf_counter()
        for s in sorted(self._draining):
            if self.health.is_dead(s):
                self._draining.discard(s)
                self._drain_deadline.pop(s, None)
                continue
            ddl = self._drain_deadline.get(s)
            if ddl is not None and now > ddl:
                self._draining.discard(s)
                self._drain_deadline.pop(s, None)
                if len(self.health.live) > 1:
                    self.fail_shard(s)
                continue
            moved += self._drain_quantum(s)
        return moved

    # ----------------------------------------------------- brown-out power cap
    def power_cap(self, s: int, watts: Optional[float]) -> int:
        """Impose (or, with ``watts=None``, lift) a brown-out power cap on
        shard ``s``: it keeps serving but sheds its lowest-priority slots,
        by migration where a survivor has room and by the preemption fold
        otherwise, until its modeled draw fits, and placement refuses work
        that would push it back over. Shed work is metered where it runs.
        Returns the number of slots shed at once."""
        if not 0 <= s < self.S:
            raise ValueError(f"shard {s} out of range for {self.S} shards")
        if watts is None:
            self._power_cap[s] = None
            return 0
        idle = self.shard_profile[s].idle_w
        if watts < idle:
            raise ValueError(
                f"cap {watts:.1f} W is below shard {s}'s idle draw "
                f"{idle:.1f} W — an idle device already violates it")
        self._power_cap[s] = float(watts)
        self.power_cap_events += 1
        return self._shed_to_cap(s)

    def _modeled_draw(self, s: int) -> float:
        """Shard ``s``'s modeled draw at its current load: the larger of
        its decode-step and prefill-chunk power (the ``step_power`` model
        the meters price), idle draw when empty."""
        draw = self.shard_profile[s].idle_w
        armed = [b for b in range(self.B) if self._slot_armed[s][b]]
        if armed:
            ctx = float(np.mean([self._slot_ctx[s][b] for b in armed]))
            rep = step_energy(self.shard_profile[s],
                              decode_counts(self.workload, len(armed),
                                            max(ctx, 1.0)))
            draw = max(draw, rep.power_w)
        if self._prefilling[s]:
            counts = _prefill_phase_counts(self.workload, 1,
                                           self.cfg.prefill_chunk)
            draw = max(draw, step_energy(self.shard_profile[s],
                                         counts).power_w)
        return draw

    def _prospective_draw(self, s: int, req: Request) -> float:
        """Shard ``s``'s draw if ``req`` were placed on it: one more armed
        slot at the blended context, and its prefill chunk."""
        armed = [b for b in range(self.B) if self._slot_armed[s][b]]
        ctxs = [self._slot_ctx[s][b] for b in armed]
        ctx = max(float(np.mean(ctxs + [float(len(req.prompt))])), 1.0)
        rep = step_energy(self.shard_profile[s],
                          decode_counts(self.workload, len(armed) + 1, ctx))
        counts = _prefill_phase_counts(
            self.workload, 1, min(len(req.prompt), self.cfg.prefill_chunk))
        pf = step_energy(self.shard_profile[s], counts)
        return max(rep.power_w, pf.power_w, self.shard_profile[s].idle_w)

    def _shed_to_cap(self, s: int) -> int:
        """Shed slots off capped shard ``s``, lowest priority and least
        progress first, until its modeled draw fits: migrate where a
        survivor has room, fold armed slots otherwise. Stops, still over
        the cap, when only unmovable mid-prefill work remains."""
        cap = self._power_cap[s]
        shed = 0
        tbl: Optional[np.ndarray] = None
        while cap is not None and self._modeled_draw(s) > cap:
            occupied = [b for b in range(self.B)
                        if self.slot_rid[s][b] >= 0]
            if not occupied:
                break                  # idle draw alone: nothing to shed
            victims = sorted(
                occupied,
                key=lambda b: (self._slot_prio[s][b],
                               len(self.responses[
                                   self.slot_rid[s][b]].tokens)))
            moved = False
            for b in victims:
                d = self._pick_migration_dest(s, self._resv_for_move(s, b))
                if d is not None:
                    if tbl is None:
                        tbl = self._fetch_tbl()
                    self._migrate_slot(s, b, d, tbl[s][b])
                    tbl[s][b] = -1     # row cleared by the migration
                    shed += 1
                    moved = True
                    break
                if self._slot_armed[s][b]:
                    self._evict_slot(s, b)
                    shed += 1
                    moved = True
                    break
            if not moved:
                break
        return shed

    def _absorb_admin(self, plan) -> None:
        """Apply a planned admin event mid-run, skipping shards where it
        is moot (dead, already draining, or the last drainable one): a
        random campaign is survivable by construction."""
        s = plan.shard
        if self.health.is_dead(s) or s in self._draining:
            return
        if plan.site == "drain":
            if [d for d in self.health.live
                    if d != s and d not in self._draining]:
                self.drain(s)
            return
        prof = self.shard_profile[s]
        watts = (plan.watts if plan.watts is not None
                 else prof.idle_w + 0.5 * (prof.tdp_w - prof.idle_w))
        self.power_cap(s, max(watts, prof.idle_w))

    # -------------------------------------------------------------- shard loss
    # One lost shard strands every armed slot, reservation, pinned page and
    # index entry on it. Declaration evacuates the in-flight work onto the
    # survivors, invalidates every host mirror that could reach the dead
    # pool (no adoption, release or decref targets it again; its rows ride
    # later forwards writing only to the trash page), and the degraded
    # fleet serves on with embodied rent re-denominated onto the live
    # shards. rejoin() scrubs the shard and makes it placeable next quantum.

    @property
    def live_shards(self) -> List[int]:
        return self.health.live

    def fail_shard(self, s: int, reachable: bool = True) -> int:
        """Declare shard ``s`` dead and evacuate its in-flight work onto
        the survivors; returns the number of evacuated requests. Queued
        and deferred work own nothing shard-local and stay. ``reachable``:
        whether the shard can still serve a page copy (an operator's
        declaration or a drain's hand-off) — its slots then page-migrate
        where a survivor has room; a planned ``shard_down`` and the
        watchdog pass False, and evacuation folds
        (``preempt.evacuation_mode``). Raises FaultError if ``s`` is the
        last live shard."""
        if not 0 <= s < self.S:
            raise ValueError(f"shard {s} out of range for {self.S} shards")
        if self.health.is_dead(s):
            return 0
        if len(self.health.live) <= 1:
            raise FaultError(
                f"shard {s} is the last live shard — nowhere to "
                "evacuate; queue and responses are intact")
        self.health.declare_down(s, self._quantum)
        self._draining.discard(s)      # a dying shard's drain is moot
        self._drain_deadline.pop(s, None)
        self._power_cap[s] = None
        self.shard_down_events += 1
        n = self._evacuate_shard(s, reachable)
        # the dead device keeps depreciating: its embodied rent
        # re-denominates onto the live shards' work
        self.meter.set_live(self.health.live)
        self.audit()
        return n

    def _evacuate_shard(self, s: int, reachable: bool = True) -> int:
        """Move every in-flight request off shard ``s`` and invalidate its
        host mirrors in one host-side pass. A REACHABLE shard's slots that
        a survivor can hold page-migrate first; the rest, and everything
        when unreachable, take the fold (armed) or restart (mid-prefill)
        path. The shard's rows are disarmed and its table cleared
        (``paged.quarantine_table``): nothing writes its pool again."""
        migrated = 0
        if reachable:
            tbl: Optional[np.ndarray] = None
            for b in [b for b in range(self.B)
                      if self.slot_rid[s][b] >= 0]:
                emitted = len(self.responses[self.slot_rid[s][b]].tokens)
                d = self._pick_migration_dest(s, self._resv_for_move(s, b))
                if preempt.evacuation_mode(reachable, emitted,
                                           d is not None) != "migrate":
                    continue
                if tbl is None:
                    tbl = self._fetch_tbl()
                self._migrate_slot(s, b, d, tbl[s][b])
                migrated += 1
        armed = [b for b in range(self.B) if self._slot_armed[s][b]]
        if armed:
            sampling.disarm_slots(self.state, self._tensor(
                self._rows((s, b) for b in armed)))
        do = np.zeros((self.S,), bool)
        do[s] = True
        self.caches["paged"] = PG.quarantine_table(
            self.caches["paged"], self._tensor(do).bool())
        # pins are residencies in the dead pool: dropped with NO decref —
        # the resumed requests re-prefill on a survivor
        for rid in [r for r, (ps, _) in self._pins.items() if ps == s]:
            del self._pins[rid]
        # armed slots fold (emitted tokens into the prompt, budget = what
        # remains; the resume prefill meters as recompute): greedy decode
        # depends only on context, so the fault-free fleet is the token
        # oracle. Mid-prefill requests emitted nothing and restart.
        requeue: List[Request] = []
        for b in armed:
            req = self._slot_req[s][b]
            preempt.fold_for_resume(req, self.responses[req.rid],
                                    self.slot_budget[s][b])
            requeue.append(req)
            self._req_shard.pop(req.rid, None)
            self._clear_slot(s, b)
        for req, b in self._prefilling[s]:
            req.prefill_pos = 0
            req.prefix_keys = None
            req.shared_prefix_tokens = 0
            req.cow_pending = False
            requeue.append(req)
            self._req_shard.pop(req.rid, None)
            self._clear_slot(s, b)
        self._prefilling[s].clear()
        # class-front re-admission, reversed so the list order survives
        # the front inserts (armed before mid-prefill, FCFS within each)
        for req in reversed(requeue):
            self._enqueue(req, resume=True)
        # the shard owes and owns nothing until rejoin; the mirror
        # anticipates the rejoin scrub
        for b in range(self.B):
            if self.slot_rid[s][b] >= 0 or self._slot_req[s][b] is not None:
                self._clear_slot(s, b)
        self._slot_pages[s] = [0] * self.B
        self.free_pages[s] = self.num_pages
        if self.sharing:
            self._prefix_index[s].clear()
            self._page_key[s].clear()
            self._page_ref[s].clear()
            self._slot_shared_in[s].clear()
            self._slot_own_idx[s].clear()
        self.shard_evacuated += len(requeue) + migrated
        return len(requeue) + migrated

    def rejoin(self, s: int) -> None:
        """Re-enter a recovered shard: its half of the allocator and its
        cursor rows are scrubbed to the fresh state (``paged.scrub_pool``;
        every other shard bit-identical), its host mirrors are already
        fresh since declaration, and it is placeable from the next quantum
        with an empty prefix index."""
        if not 0 <= s < self.S:
            raise ValueError(f"shard {s} out of range for {self.S} shards")
        if not self.health.is_dead(s):
            raise ValueError(f"shard {s} is not dead")
        do = np.zeros((self.S,), bool)
        do[s] = True
        PG.scrub_pool(self.caches, self._tensor(do).bool())
        self.health.declare_up(s, self._quantum)
        self.shard_rejoins += 1
        self.meter.set_live(self.health.live)
        self.audit()

    # ------------------------------------------------------- fault sites
    def _site_shards(self, site: str) -> List[int]:
        """Live shards a launch at ``site`` touches THIS quantum — the
        watchdog's attribution unit. The admission reservation pass
        (page_alloc) is host-side and not attributable to one device, so
        it touches every live shard."""
        live = self.health.live
        if site == "prefill_chunk":
            touched = [s for s in live if self._prefilling[s]]
        elif site == "decode_scan":
            touched = [s for s in live if any(self._slot_armed[s])]
        else:
            touched = list(live)
        return touched if touched else list(live)

    def _site_failed(self, site: str) -> None:
        """Fleet twin of ``ServingEngine._site_failed``: same backoff and
        counters, and every faulted launch also charges the shards it
        touched. Retry exhaustion becomes the loss of the suspect shards
        whenever they leave a survivor, and a FaultError otherwise."""
        touched = self._site_shards(site)
        fails = self._backoff.get(site, (0, 0))[0] + 1
        self.fault_retries += 1
        self.fault_retry_site[site] = self.fault_retry_site.get(site, 0) + 1
        for s in touched:
            self._fault_retry_shard[(site, s)] = (
                self._fault_retry_shard.get((site, s), 0) + 1)
        suspect = self.health.record_fault(touched)
        if fails > self.cfg.max_retries:
            if suspect and len(suspect) < len(self.health.live):
                # "this site would wedge the run" becomes "these shards
                # are lost": evacuate, clear the site's backoff (the bad
                # shards are out of the launch) and serve on
                self._backoff.pop(site, None)
                for s in suspect:
                    # a shard that stopped answering cannot serve a page
                    # copy, so its evacuation folds
                    self.fail_shard(s, reachable=False)
                return
            raise FaultError(
                f"site {site!r} failed {fails} consecutive launches "
                f"(max_retries={self.cfg.max_retries}) touching every "
                "live shard; in-flight requests are re-queued and "
                "reservations returned")
        self._backoff[site] = (fails, self._quantum + 2 ** fails)

    def _site_ok(self, site: str) -> None:
        # a successful launch breaks its shards' consecutive-fault chains
        self.health.record_ok(self._site_shards(site))
        self._backoff.pop(site, None)

    def stacked_state(self) -> Dict:
        """The device state with a leading shard axis on every leaf, views
        of the one-card layout (no copy): a flat (S*B, ...) row leaf as (S,
        B, ...), the allocator as it is, a pool (Hkv, S*P + 1, ps, hd) as
        (S, Hkv, P, ps, hd) without the shared trash page. This is the
        tree the reference's fleet places one shard a device
        (``sharding.rules.serving_shardings``)."""
        S, P = self.S, self.num_pages

        def leaf(name, x):
            if name in ("k_pages", "v_pages"):
                return x[:, :S * P].unflatten(1, (S, P)).movedim(1, 0)
            if name in ("tbl", "free", "top", "ref"):
                return x
            return x.unflatten(0, (S, x.shape[0] // S))

        def tree(t, name=""):
            if isinstance(t, dict):
                return {k: tree(v, k) for k, v in t.items()}
            if isinstance(t, list):
                return [tree(v) for v in t]
            return None if t is None else leaf(name, t)

        return {"caches": tree(self.caches), "cur_tokens": tree(
            self.cur_tokens), "state": tree(self.state)}

    def audit(self) -> None:
        """Consistency check of the fleet between quanta:

          * per live shard, device ``ref[p]`` == live block-table
            mappings of ``p`` plus host pins (refcount exactness);
          * per live shard, ``top`` + #uniquely-mapped == num_pages
            (conservation: no page both free and mapped, none leaked);
          * the host reservation mirror never promises more free pages
            than the device free stack holds (reservations are worst-
            case, so mirror <= device top);
          * dead shards' host mirrors hold NOTHING that could reach the
            dead pool: no occupied slot, no prefilling work, no index
            entry, no pin;
          * fleet-wide, sum(top) + #referenced pages == S * num_pages.

        Fleet-wide conservation counts from refcounts, so a dead shard's
        frozen pool (its table cleared, its ref, free and top kept) and a
        scrubbed one satisfy it too, and a migration that leaked or freed
        twice a page on either endpoint breaks it.

        Costs one device->host copy of the fleet allocator, so it never
        sits on the hot path. Raises RuntimeError on any violation."""
        alloc = self.caches["paged"]
        tbl, ref, top = (alloc[k] for k in ("tbl", "ref", "top"))
        flat = torch.cat([tbl.reshape(-1), ref.reshape(-1), top]).cpu()
        self.fetches["audit"] += 1
        tbl, ref, top = (x.reshape(y.shape).numpy() for x, y in zip(
            flat.split([tbl.numel(), ref.numel(), top.numel()]),
            (tbl, ref, top)))
        n_pg = ref.shape[1]
        for s in range(self.S):
            if self.health.is_dead(s):
                if any(r >= 0 for r in self.slot_rid[s]):
                    raise RuntimeError(
                        f"audit: dead shard {s} has occupied slots")
                if self._prefilling[s]:
                    raise RuntimeError(
                        f"audit: dead shard {s} has prefilling work")
                if self.sharing and (self._prefix_index[s]
                                     or self._page_ref[s]):
                    raise RuntimeError(
                        f"audit: dead shard {s} has live index entries")
                if any(ps == s for ps, _ in self._pins.values()):
                    raise RuntimeError(
                        f"audit: dead shard {s} holds preemption pins")
                continue
            counts = np.zeros(n_pg, np.int64)
            for b in range(self.B):
                for p in tbl[s][b]:
                    if p >= 0:
                        counts[p] += 1
            for ps, pages in self._pins.values():
                if ps == s:
                    for p in pages:
                        counts[p] += 1
            if not (ref[s] == counts).all():
                bad = np.flatnonzero(ref[s] != counts)
                raise RuntimeError(
                    f"audit: shard {s} refcount drift at pages "
                    f"{bad.tolist()}: device {ref[s][bad].tolist()} vs "
                    f"mapped+pinned {counts[bad].tolist()}")
            if int(top[s]) + int((counts > 0).sum()) != n_pg:
                raise RuntimeError(
                    f"audit: shard {s} page conservation broken: top="
                    f"{int(top[s])} + mapped={int((counts > 0).sum())} "
                    f"!= {n_pg}")
            if self.free_pages[s] > int(top[s]):
                raise RuntimeError(
                    f"audit: shard {s} reservation mirror promises "
                    f"{self.free_pages[s]} free pages but the device "
                    f"free stack holds {int(top[s])}")
        fleet = int(top.sum()) + int((ref > 0).sum())
        if fleet != self.S * n_pg:
            raise RuntimeError(
                f"audit: fleet-wide page conservation broken: "
                f"sum(top) + sum(ref>0) = {fleet} != "
                f"{self.S} * {n_pg} = {self.S * n_pg}")

    # ------------------------------------------------------------- deadlines
    def _sweep_deadlines(self) -> None:
        now = time.perf_counter()

        def expired(r: Request) -> bool:
            return (r.deadline_s is not None
                    and now - r.t_submit > r.deadline_s)

        for req in [r for r in self.queue if expired(r)]:
            self.queue.remove(req)
            self._cancel(req.rid, "deadline")
        for s in range(self.S):
            for req, slot in [p for p in self._prefilling[s]
                              if expired(p[0])]:
                self._prefilling[s].remove((req, slot))
                self._clear_slot(s, slot)
                self._release_slots([(s, slot)])
                self._cancel(req.rid, "deadline")
        doomed = [(s, b) for s in range(self.S) for b in range(self.B)
                  if self._slot_armed[s][b]
                  and self._slot_req[s][b] is not None
                  and expired(self._slot_req[s][b])]
        for s, b in doomed:
            sampling.disarm_slots(self.state,
                                  self._tensor(self._rows([(s, b)])))
            rid = self.slot_rid[s][b]
            self._clear_slot(s, b)
            self._release_slots([(s, b)])
            self._cancel(rid, "deadline")

    # ------------------------------------------------------------ admission
    def _shard_score(self, req: Request, s: int, resv: int,
                     shared_tokens: int) -> Tuple[bool, float]:
        """Marginal gCO2 of serving ``req`` on shard ``s`` right now:
        phase-specific operational J at the shard's profile priced at its
        region's CURRENT CI, plus embodied rent over the request's page
        reservation (prefix hits discount both the recomputed prefill
        tokens and the reserved pages). Returns (slo_ok, grams)."""
        region = self.shard_region[s]
        ci = (ci_at_hour(region, self._clock_hours() % 24.0)
              if self.cfg.use_diurnal_ci else region.ci_g_per_kwh)
        g, t_est = marginal_request_g(
            self._slices[s], self.workload,
            prefill_tokens=max(len(req.prompt) - shared_tokens, 0),
            decode_tokens=max(req.max_new_tokens, 1),
            resv_frac=resv / self.num_pages, ci=ci,
            n_devices=self.cfg.n_devices)
        slo_ok = req.slo_s is None or t_est <= req.slo_s
        return slo_ok, g

    def _place(self, req: Request):
        """Placement policy. Eligibility is policy-INDEPENDENT: live shards
        that are not draining, with a free slot whose pool fits the
        request's reservation, and, under a power cap, whose draw with the
        request would stay within it.

        ``routing="free_pages"`` (baseline): longest resident prefix of
        the prompt (sharing only), then most free pages, then lowest
        shard id.

        ``routing="carbon"``: lowest marginal gCO2 (``_shard_score``),
        SLO-feasible shards strictly first; exact carbon ties fall back
        to the free_pages key — so a homogeneous fleet reproduces the
        baseline's placement exactly. SLO-PINNED requests (``req.slo_s``
        set) keep the baseline's load-first ordering among SLO-feasible
        shards, with marginal gCO2 demoted to a tie-break below free
        pages: chasing the greenest shard concentrates work, and
        concentration queues prefills, a latency tax the pinned class
        cannot pay.

        Reads only host mirrors (free pages, slots, the prefix index).
        Returns (shard, resv, (n_pg, phys, first_tok)) or None if the head
        can't be placed."""
        L = len(req.prompt)
        ps = self.cfg.page_size
        n_total = PG.pages_needed(L + max(req.max_new_tokens - 1, 0), ps)
        carbon = self.cfg.routing == "carbon"
        best = None
        for s in self.health.live:
            if s in self._draining or not self.free_slots(s):
                continue               # draining shards take no placements
            if (self._power_cap[s] is not None
                    and self._prospective_draw(s, req)
                    > self._power_cap[s]):
                continue               # capped: refuse work that would
                                       # push its draw back over
            if self.sharing:
                n_pg, phys = self._match_prefix(req, s)
                first_tok = min(n_pg * ps, L - 1)
                resv = n_total - first_tok // ps
                share = (n_pg, phys, first_tok)
            else:
                resv, share = n_total, (0, [], 0)
            if resv > self.free_pages[s]:
                continue
            key = (share[0], self.free_pages[s], -s)
            if carbon:
                slo_ok, g = self._shard_score(req, s, resv, share[2])
                if req.slo_s is None:
                    key = (slo_ok, -g) + key
                else:
                    # latency-pinned: load-first among SLO-feasible
                    # shards, greener shard only breaks free-page ties
                    key = (slo_ok, share[0], self.free_pages[s], -g, -s)
            if best is None or key > best[0]:
                best = (key, s, resv, share)
        return None if best is None else best[1:]

    def _admit(self) -> int:
        """FCFS head-of-queue admission onto the best shard: claim a slot
        + a worst-case page reservation on that shard, queue the request
        for chunked prefill there, and reset every newly claimed slot in
        ONE fleet-wide call. Never-fits requests (prompt + budget
        exceeding a shard's whole pool or block table) are rejected up
        front: per-shard pools mean per-shard capacity limits."""
        if self._over_budget() and self.active > 0:
            return 0
        if self.queue:
            # the reservation pass sits behind the single engine's
            # ``page_alloc`` fault site; the injection point is BEFORE any
            # claim, so a fault needs no rollback
            if not self._site_ready("page_alloc"):
                return 0
            try:
                self._inject("page_alloc")
            except InjectedFault:
                self._site_failed("page_alloc")
                return 0
            self._site_ok("page_alloc")
        admitted: List[Tuple[Request, int, int]] = []
        adoptions: List[Tuple[Request, int, int, Tuple]] = []
        while self.queue:
            req = self.queue[0]
            L = len(req.prompt)
            n_total = PG.pages_needed(
                L + max(req.max_new_tokens - 1, 0), self.cfg.page_size)
            if n_total > self.max_pages_slot or n_total > self.num_pages:
                self.queue.popleft()
                self._reject(req)
                continue
            self._apply_pressure_clamp(req)
            placed = self._place(req)
            if placed is None:
                if self._try_preempt(req):
                    continue           # a lower-class slot just yielded
                break                  # keep waiting (FCFS, no overtaking)
            s, resv, share = placed
            self.queue.popleft()
            slot = self.free_slots(s)[0]
            self.free_pages[s] -= resv
            self.peak_pages_reserved[s] = max(
                self.peak_pages_reserved[s],
                self.num_pages - self.free_pages[s])
            self.slot_rid[s][slot] = req.rid
            self.slot_budget[s][slot] = 0    # armed after the last chunk
            self.slot_eos[s][slot] = req.eos_id
            self._slot_ctx[s][slot] = 0.0
            self._slot_pages[s][slot] = resv
            self._slot_req[s][slot] = req
            self._slot_prio[s][slot] = req.priority
            self._stamp_admit(req)
            self._req_shard[req.rid] = s
            self.shard_requests[s] += 1
            req.prefill_pos = 0
            self._prefilling[s].append((req, slot))
            admitted.append((req, s, slot))
            if self.sharing:
                adoptions.append((req, s, slot, share))
        if not admitted:
            return 0
        PG.begin_chunked_prefill(self.caches, self._tensor(
            self._rows((s, slot) for _, s, slot in admitted)))
        if self.sharing:
            for req, s, slot, (n_pg, phys, first_tok) in adoptions:
                self._adopt_prefix(req, s, slot, n_pg, phys, first_tok)
                # adopt-then-release: the resumed request now holds its
                # pinned prefix through the ordinary index increfs
                if req.rid in self._pins:
                    self._drop_pin(req.rid)
        return len(admitted)

    def _adopt_prefix(self, req: Request, s: int, slot: int, n_pg: int,
                      phys: List[int], first_tok: int) -> None:
        """Shard-local adoption: incref the matched run into the slot's
        block table on shard ``s`` only — every other shard's lane is the
        sentinel slot and writes nothing."""
        self._slot_shared_in[s][slot] = []
        self._slot_own_idx[s][slot] = []
        if n_pg == 0:
            return
        slot_a = np.full((self.S,), self.B, np.int32)
        slot_a[s] = slot
        pages = np.full((self.S, self.max_pages_slot), -1, np.int32)
        pages[s, :n_pg] = phys
        n_sh = np.zeros((self.S,), np.int32)
        n_sh[s] = n_pg * self.cfg.page_size
        st = np.zeros((self.S,), np.int32)
        st[s] = first_tok
        PG.map_shared_prefix(self.caches, self._tensor(slot_a),
                             self._tensor(pages), self._tensor(n_sh),
                             self._tensor(st))
        req.prefill_pos = first_tok
        req.shared_prefix_tokens = first_tok
        # whole prompt shared -> the first chunk will copy-on-write; the
        # per-shard packer admits one such row per launch (pack_chunks)
        req.cow_pending = first_tok < n_pg * self.cfg.page_size
        for p in phys:
            self._page_ref[s][p] += 1
        self._slot_shared_in[s][slot] = list(phys)
        self.prefix_hit_tokens += first_tok
        self.prefix_shared_requests += 1

    # ------------------------------------------------------ chunked prefill
    def _prefill_quantum(self) -> int:
        """One fleet-wide prefill launch per quantum: EVERY shard's FCFS
        head chunk (packed up to ``prefill_pack`` requests per shard when
        their combined tokens fit ``prefill_chunk``) rides one forward
        over the packed rows of all shards. The allocator sees (S, n)
        lanes, a shard's idle lanes the sentinel slot. Returns the number
        of launches (0 or 1)."""
        if not self._site_ready("prefill_chunk"):
            return 0                   # backing off a faulted chunk launch
        C = self.cfg.prefill_chunk
        packs = [pack_chunks(self._prefilling[s], C, self.cfg.prefill_pack)
                 for s in range(self.S)]
        n = max(len(p) for p in packs)
        if n == 0:
            return 0
        try:
            self._inject("prefill_chunk")
        except InjectedFault:
            # nothing launched: every shard's packed requests are still at
            # the head of its _prefilling deque, prefill_pos untouched
            self._site_failed("prefill_chunk")
            return 0
        self._site_ok("prefill_chunk")
        lanes = np.full((self.S, n), self.B, np.int32)
        pos0 = np.zeros((self.S, n), np.int32)
        n_tok = np.zeros((self.S, n), np.int32)
        real: List[Tuple[int, int]] = []       # (shard, lane) per model row
        for s, pk in enumerate(packs):
            for i, (_, slot, p0, piece) in enumerate(pk):
                lanes[s, i], pos0[s, i], n_tok[s, i] = slot, p0, len(piece)
                real.append((s, i))
        # a moe model runs every shard's n lanes, an idle one as slot B-1
        # with no token (the module docstring); the others the real ones
        lanes_run = ([(s, i) for s in range(self.S) for i in range(n)]
                     if self.grouped else real)
        tokens = np.zeros((len(lanes_run), C), np.int32)
        mask = np.zeros((len(lanes_run), C), np.int32)
        for k, (s, i) in enumerate(lanes_run):
            if i < len(packs[s]):
                piece = packs[s][i][3]
                tokens[k, :len(piece)] = piece
                mask[k, :len(piece)] = 1
        keep = None
        if self.grouped:
            keep = np.array([s * n + i for s, i in real], np.int32)
        first, rows = self._chunk_launch(
            tokens, mask, lanes, pos0, n_tok,
            np.array(self._rows((s, min(lanes[s, i], self.B - 1))
                                for s, i in lanes_run), np.int32), keep)
        self.prefill_chunks += 1
        finished: List[Tuple[int, int, int]] = []   # (shard, lane, row)
        for k, (s, i) in enumerate(real):
            req, slot, p0, piece = packs[s][i]
            req.prefill_pos += len(piece)
            if self.sharing and piece:
                shared = self._slot_shared_in[s].get(slot) or []
                lp = p0 // self.cfg.page_size
                if lp < len(shared) and self._page_ref[s][shared[lp]] > 1:
                    self._page_ref[s][shared[lp]] -= 1
                    self._slot_shared_in[s][slot] = shared[:lp]
                req.cow_pending = False   # its CoW (if any) just ran
            if req.prefill_pos >= len(req.prompt):
                finished.append((s, i, k))
        for s, pk in enumerate(packs):
            done = sum(1 for fs, _, _ in finished if fs == s)
            assert done in (0, len(pk)), "packed tail finished before head"
            for _ in range(done):
                self._prefilling[s].popleft()
        if not finished:
            return 1                   # intermediate chunks: no host sync
        # ONE first-token fetch for every request finishing fleet-wide
        both = torch.cat([first[:, None], rows], dim=1).cpu().numpy()
        first_h, rows_h = both[:, 0], both[:, 1:]
        self.prefill_batches += 1
        now = time.perf_counter()
        arm: List[Tuple[int, int, int, int]] = []   # row, tok, budget, eos
        released: List[Tuple[int, int]] = []
        for s, i, k in finished:
            req, slot, _, _ = packs[s][i]
            if self.sharing:
                self._register_prefix(req, s, slot, rows_h[k])
            rep = self._meter_prefill(
                1, len(req.prompt), skip=req.shared_prefix_tokens,
                phase="recompute" if req.preemptions else "prefill",
                shard=s)
            resp = self.responses[req.rid]
            resp.prefill_s += rep.t_total
            resp.energy_j += rep.energy_j
            if req.preemptions:
                resp.recompute_j += rep.energy_j
                self.preempted_recompute_j += rep.energy_j
            tok = int(first_h[k])
            resp.tokens.append(tok)
            resp.t_emit.append(now)
            budget = req.max_new_tokens - 1
            # resumed requests EOS-check their recomputed first token — it
            # is logically a mid-decode emission (engine.py comment)
            eos_hit = (req.preemptions > 0 and req.eos_id is not None
                       and tok == req.eos_id)
            if budget <= 0 or eos_hit:
                resp.finished = True   # prefill token was the whole budget
                resp.finish_reason = "eos" if eos_hit else "length"
                self.slot_rid[s][slot] = -1
                self._slot_req[s][slot] = None
                self._slot_prio[s][slot] = 0
                released.append((s, slot))
                continue
            arm.append((s * self.B + slot, tok, budget,
                        -1 if req.eos_id is None else req.eos_id))
            self.slot_budget[s][slot] = budget
            self._slot_ctx[s][slot] = float(len(req.prompt))
            self._slot_armed[s][slot] = True
        if arm:
            # one batched arm for every request finishing fleet-wide
            sampling.arm_slots(self.cur_tokens, self.state,
                               *(self._tensor([a[j] for a in arm])
                                 for j in range(4)))
        self._release_slots(released)
        return 1

    # --------------------------------------------------------------- decode
    def _decode_chunk(self, max_steps: int) -> bool:
        """One fused chunk of up to ``sync_every`` micro-steps for EVERY
        armed slot on EVERY shard — each micro-step one forward over the
        S*B rows, one host sync on the stacked (n, S, B) token/emission
        matrices for the whole fleet. Returns whether a chunk actually
        launched (False while the ``decode_scan`` site backs off a
        fault)."""
        if not self._site_ready("decode_scan"):
            return False
        try:
            self._inject("decode_scan")
        except InjectedFault:
            self._site_failed("decode_scan")
            return False
        self._site_ok("decode_scan")
        budgets = [self.slot_budget[s][b]
                   for s in range(self.S) for b in range(self.B)
                   if self._slot_armed[s][b]]
        n = min(self.cfg.sync_every, max(max(budgets), 1),
                max(max_steps - self._steps, 1))
        tok_mat, emit_mat = self.graphs.step(
            self.caches, n_steps=n, temperature=self.cfg.temperature,
            page_size=self.cfg.page_size, freeze_inactive=True)
        # the chunk's one host sync: tokens and emission flags together
        both = torch.stack([tok_mat, emit_mat.to(torch.int32)]).cpu().numpy()
        tok_h = both[0].reshape(n, self.S, self.B)
        emit_h = both[1].astype(bool).reshape(n, self.S, self.B)
        now = time.perf_counter()
        self.decode_chunks += 1
        self.peak_active = max(self.peak_active, self.active)
        released: List[Tuple[int, int]] = []
        for i in range(n):
            emitted_any = False
            for s in range(self.S):
                act = emit_h[i, s]
                n_active = int(act.sum())
                if n_active == 0:
                    continue           # this shard drained mid-chunk
                emitted_any = True
                self.shard_steps += 1
                ctx = float(np.mean([self._slot_ctx[s][b]
                                     for b in np.flatnonzero(act)]))
                rep = self._meter_decode(n_active, max(ctx, 1.0), shard=s)
                per_tok_t = rep.t_total / n_active
                per_tok_e = rep.energy_j / n_active
                for b in np.flatnonzero(act):
                    rid = self.slot_rid[s][b]
                    resp = self.responses[rid]
                    tok = int(tok_h[i, s, b])
                    resp.tokens.append(tok)
                    resp.t_emit.append(now)
                    resp.decode_s += per_tok_t
                    resp.energy_j += per_tok_e
                    self._slot_ctx[s][b] += 1.0
                    self.slot_budget[s][b] -= 1
                    eos_hit = (self.slot_eos[s][b] is not None
                               and tok == self.slot_eos[s][b])
                    if self.slot_budget[s][b] <= 0 or eos_hit:
                        resp.finished = True
                        resp.finish_reason = "eos" if eos_hit else "length"
                        self.slot_rid[s][b] = -1
                        self._slot_armed[s][b] = False
                        self._slot_req[s][b] = None
                        self._slot_prio[s][b] = 0
                        released.append((s, int(b)))
            if emitted_any:
                self._steps += 1
        self._release_slots(released)
        return True

    def _resolve_stall(self) -> None:
        """Fleet twin of ``ServingEngine._resolve_stall``: spill pins or
        fail the unplaceable head."""
        live = self.health.live
        if self._pins and any(self.free_pages[s] < self.num_pages
                              for s in live):
            for rid in list(self._pins):
                self._drop_pin(rid)
            return
        if all(self.free_pages[s] == self.num_pages for s in live):
            # nothing running, every live shard's whole pool free, and
            # placement still refused the head: it can never fit
            self._reject(self.queue.popleft())
        else:
            raise RuntimeError(        # unreachable: release returns
                "admission stalled with no active work — leaked "
                "page reservation")

    def step(self, max_steps: int = 10_000) -> bool:
        """One FLEET scheduling quantum (same contract as the single-
        device ``ServingEngine.step``): deferral release, deadline sweep,
        admission, one fleet-wide chunk launch, one fused decode chunk.
        The fleet clock then advances by the SLOWEST shard's modeled time
        this quantum — shards run in parallel, so that max is the
        quantum's wall time. Planned shard loss and admin events fire at
        the quantum's start; each draining shard sweeps its slots to the
        survivors and each capped shard sheds back under its cap before
        admission."""
        self._quantum += 1
        ev0 = self.shard_down_events
        mig0 = self.migrations
        if self.faults is not None:
            # a planned shard_down is a crashed device: not reachable,
            # its evacuation folds; it never surfaces as an exception
            for s in self.faults.shard_down_fires(self._quantum,
                                                  self._run_q0):
                if not self.health.is_dead(s):
                    self.fail_shard(s, reachable=False)
            for plan in self.faults.admin_fires(self._quantum,
                                                self._run_q0):
                self._absorb_admin(plan)
        released = self._release_deferred() if self.deferred else 0
        if self._has_deadlines:
            self._sweep_deadlines()
        if self._draining:
            self._drain_sweep()
        for s in self.health.live:
            # load that grew back over a live cap (a deepening context)
            # sheds again
            if self._power_cap[s] is not None:
                self._shed_to_cap(s)
        admitted = self._admit()
        chunks = self._prefill_quantum()
        decoded = self._decode_chunk(max_steps) if self.decoding else False
        dt = max(self._q_time)
        if dt > 0.0:
            self.clock.hours += dt / 3600.0
            self._q_time = [0.0] * self.S
        # a recovery event is progress: the watchdog can declare a shard
        # dead inside a launch (after this quantum's admission), and the
        # evacuees it re-queued must reach the next admission pass
        return bool(released or admitted or chunks or decoded
                    or self.shard_down_events != ev0
                    or self.migrations != mig0)

    # the drive loop and the reports are the single engine's: a fleet
    # quantum is one step(), and decode_chunks + prefill_batches count the
    # fleet's host syncs, S shards the same count as ONE engine
    run = ServingEngine.run
    carbon_report = ServingEngine.carbon_report
    host_syncs = ServingEngine.host_syncs

    def stats(self) -> Dict[str, float]:
        """The reference fleet's ``stats()`` keys."""
        t = self.meter.totals
        pf = self.meter.phase("prefill")
        dc = self.meter.phase("decode")
        finished = [r for r in self.responses.values() if r.finished]
        lat = [r.prefill_s + r.decode_s for r in finished]
        p50 = float(np.median(lat)) if lat else 0.0
        p99 = float(np.percentile(lat, 99)) if len(lat) > 1 else p50
        out: Dict[str, float] = {
            "shards": self.S,
            "paged": 1.0,
            "page_size": self.cfg.page_size,
            "pages_total": self.num_pages * self.S,
            "pages_per_shard": self.num_pages,
            "peak_pages_reserved": sum(self.peak_pages_reserved),
            "free_pages": sum(self.free_pages),
            "peak_kv_rows_reserved":
                sum(self.peak_pages_reserved) * self.cfg.page_size,
            "chunked": 1.0,
            "prefill_chunk": self.cfg.prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
            "requests": len(self.responses),
            "peak_active": self.peak_active,
            "p50_latency_s": p50,
            "p99_latency_s": p99,
            "steps": self._steps,
            "shard_steps": self.shard_steps,
            "decode_chunks": self.decode_chunks,
            "prefill_batches": self.prefill_batches,
            "host_syncs": self.host_syncs,
            "prefill_tokens": pf.tokens,
            "decode_tokens": dc.tokens,
            "prefill_j_per_token": pf.j_per_token,
            "decode_j_per_token": dc.j_per_token,
            "prefill_g_per_token": pf.g_per_token,
            "decode_g_per_token": dc.g_per_token,
            "total_energy_j": t.energy_j,
            "total_carbon_g": t.total_g,
            "embodied_fraction":
                (t.embodied_g / t.total_g) if t.total_g else 0.0,
            # multi-criteria impact ledger — fleet totals are the exact
            # sum of the per-shard rows below
            "total_water_l": t.water_l,
            "total_primary_mj": t.primary_mj,
            "total_adpe_mg": t.adpe_mg,
            "prefill_water_l": pf.water_l,
            "decode_water_l": dc.water_l,
            "prefill_primary_mj": pf.primary_mj,
            "decode_primary_mj": dc.primary_mj,
            "prefill_adpe_mg": pf.adpe_mg,
            "decode_adpe_mg": dc.adpe_mg,
            "water_per_token_l": t.water_per_token,
        }
        if self.sharing:
            out.update({
                "prefix_sharing": 1.0,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_shared_requests": self.prefix_shared_requests,
            })
        # heterogeneous fleet: routing policy + per-shard attribution
        # (each shard metered at its own profile x region CI; the fleet
        # totals above are the exact sum of these rows)
        out["carbon_routing"] = 1.0 if self.cfg.routing == "carbon" else 0.0
        for s in range(self.S):
            st = self.meters[s].totals
            out[f"shard{s}_requests"] = self.shard_requests[s]
            out[f"shard{s}_tokens"] = st.tokens
            out[f"shard{s}_energy_j"] = st.energy_j
            out[f"shard{s}_carbon_g"] = st.total_g
            out[f"shard{s}_g_per_token"] = st.g_per_token
            out[f"shard{s}_water_l"] = st.water_l
            out[f"shard{s}_primary_mj"] = st.primary_mj
            out[f"shard{s}_adpe_mg"] = st.adpe_mg
            out[f"shard{s}_dead"] = 1.0 if self.health.is_dead(s) else 0.0
        # shard loss: the watchdog's state and the recovery counters
        out.update({
            "live_shards": len(self.health.live),
            "dead_shards": self.S - len(self.health.live),
            "shard_down_events": self.shard_down_events,
            "shard_evacuated": self.shard_evacuated,
            "shard_rejoins": self.shard_rejoins,
        })
        # live KV-page migration: drain and brown-out counters and the
        # migrate phase's energy (its own phase, so prefill and decode J
        # per token stay invariant)
        out.update({
            "migrations": self.migrations,
            "migrated_pages": self.migrated_pages,
            "drain_events": self.drain_events,
            "migrate_j": self.meter.phase("migrate").energy_j,
            "power_cap_events": self.power_cap_events,
        })
        for s in range(self.S):
            if self._power_cap[s] is not None:
                out[f"shard{s}_power_cap_w"] = self._power_cap[s]
        # front door (same keys as the single-device engine)
        out.update({
            "queue_depth": len(self.queue),
            "deferred_depth": len(self.deferred),
            "deferred_requests": self.deferred_total,
            "deferred_released": self.deferred_released,
            "deferred_forced_releases": self.deferred_forced,
            "shed_count": self.shed_count,
            "preemption_count": self.preemption_count,
            "deadline_cancelled": self.deadline_cancelled,
            "clamped_requests": self.clamped_requests,
            "fault_retries": self.fault_retries,
            "rate_limited": self.rate_limited,
            "preempted_recompute_j": self.preempted_recompute_j,
            "timeout_requests": sum(
                1 for r in self.responses.values()
                if not r.finished and r.finish_reason == "timeout"),
        })
        # fault attribution: per-site, and per (site, shard)
        for site, n in sorted(self.fault_retry_site.items()):
            out[f"fault_retries_{site}"] = n
        for (site, s), n in sorted(self._fault_retry_shard.items()):
            out[f"shard{s}_fault_retries_{site}"] = n
        for p, waits in sorted(self._wait_samples.items()):
            out[f"queue_wait_p50_s_class_{p}"] = float(np.median(waits))
            out[f"queue_wait_p99_s_class_{p}"] = (
                float(np.percentile(waits, 99)) if len(waits) > 1
                else float(np.median(waits)))
        for p, n_shed in sorted(self._shed_by_class.items()):
            out[f"shed_class_{p}"] = n_shed
        return out
