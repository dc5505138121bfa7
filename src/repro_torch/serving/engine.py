"""Serving engine on the default path (the port of
``repro.serving.engine``): request queue, continuous batching over a
fixed pool of decode slots, prefill/decode phase split, per-phase carbon
metering.

The engine runs the model for real on the card while the energy and
carbon of each step are attributed by the calibrated analytical model
against a target hardware profile (paper §2), through the same
``CarbonMeter`` and Eq. 2-4 carbon model as the reference — so a run
prices bit-identically to the JAX engine's on the same trace.

Hot path, as in the reference:

  * admissions are batched: every waiting request that fits a free slot
    prefills in one launch per power-of-two length bucket (right padding
    plus position masking), padded to a power-of-two batch; the new
    caches enter the pool in one indexed copy per leaf;
  * decode runs ``sync_every`` fused micro-steps (decode -> sample ->
    EOS/budget masking) on the device per host sync.

The meter prices each prefill at its padded launch shape (that is what
the device ran) and attributes real tokens, exactly as the reference.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.energy import decode_counts, prefill_counts, step_energy
from repro_torch.core.hardware import HardwareProfile, get_profile
from repro_torch.core.meter import CarbonMeter
from repro_torch.device import resolve_device
from repro_torch.models.costing import workload_of
from repro_torch.models.model import Model
from repro_torch.serving import sampling
from repro_torch.serving.request import Request, Response


@dataclasses.dataclass
class EngineConfig:
    """Every serving knob of the reference ``repro.serving.EngineConfig``,
    with the same fields and defaults, so a config written for one engine
    means the same to the other. This slice of the port serves the default
    path: contiguous KV cache, monolithic power-of-two-bucketed batched
    prefill, fused decode. Knobs of later slices (``paged``,
    ``prefill_chunk``, ``preemption``, ``prefix_sharing``, ``max_queue``,
    ``shards`` > 1, deferral, ``tenant_quota``) raise NotImplementedError
    when set away from their defaults; see ``_LATER_SLICES``.
    """
    max_batch: int = 8                 # decode slot count
    max_len: int = 512                 # cache allocation per slot
    profile: str = "t4"                # hardware the meter attributes to
    region: str = "QC"
    lifetime_years: float = 5.0
    n_devices: int = 1
    temperature: float = 0.0           # 0 = greedy
    sync_every: int = 8                # decode steps per host sync (chunk)
    prefill_min_bucket: int = 8        # smallest padded-prefill bucket
    # carbon-budget admission (paper SS4): defer new prefills while the
    # run's cumulative carbon rate exceeds the budget (g CO2eq per 1000
    # generated tokens). None = unlimited.
    carbon_budget_g_per_ktok: Optional[float] = None
    # paged KV pool: slots share num_pages pages of page_size tokens per
    # cache leaf instead of owning max_len contiguous rows each — the same
    # pool memory serves more concurrent requests (embodied carbon per
    # request drops with provisioned-but-idle HBM). num_pages None =
    # equal-memory default, max_batch * max_len / page_size.
    paged: bool = False
    page_size: int = 16
    num_pages: Optional[int] = None
    # chunked prefill (requires paged): split prompts into fixed-size
    # chunks scheduled into the same quantum as decode — at most one chunk
    # plus one fused decode scan per host sync, so decode time-between-
    # tokens is bounded by one chunk's compute instead of a whole prompt's.
    # None = monolithic admission prefill (the parity oracle). 256 is the
    # production default; tests/benches use smaller chunks.
    prefill_chunk: Optional[int] = None
    # chunk packing: up to this many prefilling requests' next chunks ride
    # ONE quantum when their combined token count fits prefill_chunk (FCFS
    # order preserved — a request is packed only behind everything ahead of
    # it). 1 = the head-only schedule; packing changes launch grouping,
    # never any request's chunk boundaries, so greedy parity and the
    # per-request metering are exactly invariant to this knob.
    prefill_pack: int = 1
    # mesh-sharded serving (ShardedServingEngine): data-parallel shard
    # count. The base ServingEngine is single-device and ignores it.
    shards: int = 1
    # ---- front-door robustness (async server, PR 6) ----
    # bounded admission queue: a submission arriving with the queue at
    # max_queue is SHED per shed_policy instead of queued (the request's
    # Response finishes immediately with finish_reason="shed"). None =
    # unbounded (the pre-front-door behavior).
    max_queue: Optional[int] = None
    # "reject_newest": the incoming request is the one shed.
    # "reject_lowest": the newest request of the LOWEST waiting priority
    # class is shed to make room — unless the incoming request itself is
    # at or below that class, in which case it is shed instead (a burst
    # of high-priority traffic displaces queued low-priority work, never
    # the reverse).
    shed_policy: str = "reject_newest"
    # graceful degradation: when the bounded queue is at least half full,
    # requests admitted from a priority class strictly below the highest
    # waiting class get max_new_tokens clamped to this value — shorter
    # low-class answers free slots and pages for the classes the fleet is
    # actually backed up on. None = never clamp.
    pressure_clamp: Optional[int] = None
    # priority preemption (requires prefill_chunk): a request that cannot
    # be admitted for lack of a slot or pages may evict the lowest armed
    # slot of a STRICTLY lower priority class; the victim's computed
    # prefix stays resident via the prefix-index pin and the request
    # resumes by re-admission (see serving/preempt.py for the contract).
    preemption: bool = False
    # fault recovery: a launch site (page_alloc / prefill_chunk /
    # decode_scan) that keeps failing is retried with exponential backoff
    # up to this many CONSECUTIVE failures, after which run() raises
    # FaultError with engine state consistent (serving/faults.py).
    max_retries: int = 3
    # page-level prefix sharing (requires prefill_chunk): requests whose
    # prompts repeat a page-aligned prefix already resident in the pool map
    # those pages into their block table by refcount instead of recomputing
    # and re-storing them — admission reserves only the UNSHARED worst
    # case, prefill starts at the first unshared token, and writes into
    # shared pages go through copy-on-write. Off by default: the unshared
    # paged engine is the token-for-token parity oracle.
    prefix_sharing: bool = False
    # ---- heterogeneous fleet + carbon routing (PR 7) ----
    # per-shard hardware profile / grid region names for the
    # ShardedServingEngine (length must equal `shards`; None = every shard
    # uses `profile` / `region`). The model runs identically everywhere —
    # heterogeneity lives in the energy/carbon attribution and in
    # placement, never in the token streams.
    shard_profiles: Optional[Sequence[str]] = None
    shard_regions: Optional[Sequence[str]] = None
    # fleet placement policy: "free_pages" (PR 5 baseline — longest
    # resident prefix, then most free pages) or "carbon" (marginal gCO2:
    # phase-specific operational J at each shard's profile and CURRENT CI
    # plus embodied rent over the pages the request would reserve,
    # core/scheduler.marginal_request_g). Eligibility (free slot, fitting
    # reservation, FCFS head-only) is IDENTICAL under both policies, and
    # on a homogeneous fleet every shard scores equal so "carbon" degrades
    # to the exact "free_pages" order — routing regroups placement, never
    # chunk boundaries or greedy token streams.
    routing: str = "free_pages"
    # meter operational carbon (and score carbon routing) at the region's
    # synthetic diurnal CI trace as the engine's virtual clock advances,
    # instead of the flat Table 2 mean.
    use_diurnal_ci: bool = False
    # temporal deferral: requests with priority STRICTLY below this are
    # held OUT of the admission queue (no slot, no reservation, exempt
    # from max_queue — they own nothing) until the CI forecaster's
    # greenest window opens at the engine's virtual clock, or until
    # defer_deadline_frac of their wall-clock deadline budget has elapsed
    # (forced release: the remaining budget is reserved for service, so
    # deferral never violates deadline_s). None = never defer.
    defer_below_priority: Optional[int] = None
    # look-ahead horizon (virtual hours) for the greenest-window search
    defer_horizon_h: int = 24
    defer_deadline_frac: float = 0.5
    # ---- per-tenant rate limits (PR 8) ----
    # token bucket per tenant, checked at submit(): maps a tenant name (or
    # "*" as the default for any named tenant) to (capacity, refill_per_s).
    # Each submission costs one bucket token; an empty bucket sheds the
    # request as a terminal finish_reason="rate_limited" Response before
    # it owns anything (no queue position, no slot, no pages). None = no
    # limits; requests with tenant=None are never limited.
    tenant_quota: Optional[Dict[str, Tuple[float, float]]] = None


# Knobs of later slices of the port: (field, default, ROADMAP Queue 1 item).
# Any of them set away from its default raises NotImplementedError.
_LATER_SLICES = (
    ("paged", False, "Paged engine"),
    ("prefill_chunk", None, "Paged engine"),
    ("prefix_sharing", False, "Paged engine"),
    ("preemption", False, "Front door"),
    ("max_queue", None, "Front door"),
    ("tenant_quota", None, "Front door"),
    ("shards", 1, "Fleet"),
    ("defer_below_priority", None, "Fleet"),
)


def _check_slice(cfg: EngineConfig) -> None:
    for field, default, item in _LATER_SLICES:
        if getattr(cfg, field) != default:
            raise NotImplementedError(
                f"EngineConfig.{field}={getattr(cfg, field)!r} is not ported "
                f"yet (ROADMAP Queue 1, {item})")


class ServingEngine:
    def __init__(self, model: Model, params, cfg: EngineConfig,
                 device: Union[str, torch.device] = "cuda"):
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} but model on {model.device}")
        _check_slice(cfg)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = dev
        self.profile: HardwareProfile = get_profile(cfg.profile)
        self.meter = CarbonMeter(self.profile, cfg.region,
                                 lifetime_years=cfg.lifetime_years,
                                 n_devices=cfg.n_devices,
                                 use_diurnal_ci=cfg.use_diurnal_ci)
        self.workload = workload_of(model.cfg)
        self.queue: deque = deque()
        self.responses: Dict[int, Response] = {}
        B = cfg.max_batch
        self.caches = model.init_cache(B, cfg.max_len)
        self.cur_tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.state = sampling.init_slot_state(B, dev)  # device-side slot state
        # host mirrors (bookkeeping only; the device state drives the chunk)
        self.slot_rid = [-1] * B                       # -1 = free
        self.slot_budget = [0] * B
        self.slot_eos: List[Optional[int]] = [None] * B
        self._slot_ctx = [0.0] * B                     # context length mirror
        self._slot_armed = [False] * B
        self._req_slo: Dict[int, Optional[float]] = {}
        # sampling noise (temperature > 0 only); draws differ from the
        # reference's jax.random stream
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(0)
        self._steps = 0
        self.decode_chunks = 0                         # device->host syncs
        self.prefill_batches = 0
        self.peak_active = 0                           # max concurrent requests
        self._wait_samples: Dict[int, List[float]] = {}  # class -> waits (s)

    # ------------------------------------------------------------- metering
    def _meter_prefill(self, batch: int, seq: int,
                       useful_seq: Optional[float] = None):
        """Meter one prefill launch of ``batch`` sequences padded to
        ``seq``; ``useful_seq`` (mean real tokens per row) attributes only
        the real tokens while the energy covers the whole padded launch."""
        counts = prefill_counts(self.workload, batch, seq,
                                useful_seq=useful_seq)
        rep = step_energy(self.profile, counts)
        self.meter.record("prefill", rep.tokens, rep.t_total, rep.energy_j)
        return rep

    def _meter_decode(self, batch: int, context: float):
        counts = decode_counts(self.workload, batch, context)
        rep = step_energy(self.profile, counts)
        self.meter.record("decode", rep.tokens, rep.t_total, rep.energy_j)
        return rep

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request) -> None:
        """Validate, register and enqueue a request. Raises ValueError for
        requests that are malformed rather than merely unschedulable."""
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens <= 0:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}")
        if req.rid in self.responses:
            raise ValueError(f"request {req.rid}: duplicate rid")
        if req.deadline_s is not None:
            raise NotImplementedError(
                "request deadlines are not ported yet (ROADMAP Queue 1, "
                "Front door)")
        req.t_submit = time.perf_counter()
        self._req_slo[req.rid] = req.slo_s
        self.responses[req.rid] = Response(rid=req.rid, tokens=[],
                                           priority=req.priority)
        # priority-ordered insert, FCFS within a class
        q = self.queue
        i = len(q)
        while i > 0 and q[i - 1].priority < req.priority:
            i -= 1
        q.insert(i, req)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_rid) if r < 0]

    @property
    def active(self) -> int:
        return sum(1 for r in self.slot_rid if r >= 0)

    @property
    def decoding(self) -> int:
        """Slots armed for decode."""
        return sum(self._slot_armed)

    def _over_budget(self) -> bool:
        b = self.cfg.carbon_budget_g_per_ktok
        if b is None:
            return False
        t = self.meter.totals
        if t.tokens < 1:
            return False
        return (t.total_g / t.tokens * 1000.0) > b

    def _stamp_admit(self, req: Request) -> None:
        """Record the submit -> first admission wait (wall clock)."""
        if req.t_admit is not None:
            return
        req.t_admit = time.perf_counter()
        wait = req.t_admit - req.t_submit
        self.responses[req.rid].queue_wait_s = wait
        self._wait_samples.setdefault(req.priority, []).append(wait)

    # ------------------------------------------------------------ admission
    def _admit(self) -> int:
        """Batch-prefill waiting requests into free slots (phase 1), FCFS.
        Returns the number of requests admitted."""
        if self._over_budget() and self.active > 0:
            return 0                   # defer admissions; drain active work
        free = self.free_slots()
        take: List[Request] = []
        while self.queue and len(take) < len(free):
            take.append(self.queue.popleft())
        if not take:
            return 0
        # bucket prompts into padded power-of-two lengths, clamped to
        # max_len — past that the cache ring must keep the LAST W real
        # tokens, so those prompts prefill at exact length (every ported
        # block kind masks pad keys exactly, so padding is always safe)
        groups: Dict[int, List[Request]] = {}
        for req in take:
            L = len(req.prompt)
            if L <= self.cfg.max_len:
                b = min(sampling.prefill_bucket(L, self.cfg.prefill_min_bucket),
                        self.cfg.max_len)
            else:
                b = L
            groups.setdefault(b, []).append(req)
        slot_iter = iter(free)
        for bucket, reqs in groups.items():
            slots = [next(slot_iter) for _ in reqs]
            self._prefill_group(bucket, reqs, slots)
        return len(take)

    def _prefill_group(self, bucket: int, reqs: List[Request],
                       slots: List[int]) -> None:
        n = len(reqs)
        n_pad = 1                      # pow2 batch dim, as the reference
        while n_pad < n:
            n_pad *= 2
        tokens = np.zeros((n_pad, bucket), np.int32)
        mask = np.zeros((n_pad, bucket), np.int32)
        for i, req in enumerate(reqs):
            L = len(req.prompt)
            tokens[i, :L] = req.prompt
            mask[i, :L] = 1
        # pad rows replicate request 0 (dropped at insertion) rather than
        # run degenerate zero-length sequences through the model
        tokens[n:] = tokens[0]
        mask[n:] = mask[0]
        dev = self.device
        last, pcache = self.model.prefill(
            self.params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(mask).to(dev), max_len=self.cfg.max_len)
        first = sampling.sample(last[:, :self.model.cfg.vocab], self._gen,
                                self.cfg.temperature)
        budgets = torch.tensor([r.max_new_tokens - 1 for r in reqs],
                               dtype=torch.int32, device=dev)
        eos_ids = torch.tensor([-1 if r.eos_id is None else r.eos_id
                                for r in reqs], dtype=torch.int32, device=dev)
        sampling.insert_prefill(
            self.caches, pcache, torch.tensor(slots, device=dev),
            self.cur_tokens, first, self.state, budgets, eos_ids)
        first_h = first.cpu().numpy()  # the launch's one host sync
        self.prefill_batches += 1
        # meter the REAL padded launch once — the device ran ONE
        # (n_pad, bucket) batch. Real tokens are attributed (useful_seq);
        # per-request energy shares go by true prompt length, while each
        # request's modeled prefill TIME is the whole launch it waited on
        tot_real = sum(len(r.prompt) for r in reqs)
        rep = self._meter_prefill(n_pad, bucket, useful_seq=tot_real / n_pad)
        now = time.perf_counter()
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            self._stamp_admit(req)
            resp = self.responses[req.rid]
            resp.prefill_s += rep.t_total
            resp.energy_j += rep.energy_j * (len(req.prompt) / tot_real)
            resp.tokens.append(int(first_h[i]))
            resp.t_emit.append(now)
            if req.max_new_tokens <= 1:
                resp.finished = True   # prefill token was the whole budget
                resp.finish_reason = "length"
                continue               # slot stays free (device side agrees)
            self.slot_rid[slot] = req.rid
            self.slot_budget[slot] = req.max_new_tokens - 1
            self.slot_eos[slot] = req.eos_id
            self._slot_ctx[slot] = float(len(req.prompt))
            self._slot_armed[slot] = True

    # --------------------------------------------------------------- decode
    def _decode_chunk(self, max_steps: int) -> bool:
        """One fused on-device chunk of up to ``sync_every`` decode steps
        for all armed slots (phase 2); a single host sync at the end."""
        budgets = [self.slot_budget[s] for s in range(self.cfg.max_batch)
                   if self._slot_armed[s]]
        n = min(self.cfg.sync_every, max(max(budgets), 1),
                max(max_steps - self._steps, 1))
        tok_mat, emit_mat = sampling.fused_decode_steps(
            self.model, self.params, self.caches, self.cur_tokens,
            self.state, self._gen, n_steps=n,
            temperature=self.cfg.temperature)
        # the chunk's one host sync: tokens and emission flags together
        both = torch.stack([tok_mat, emit_mat.to(torch.int32)]).cpu().numpy()
        tok_h, emit_h = both[0], both[1].astype(bool)
        now = time.perf_counter()
        self.decode_chunks += 1
        self.peak_active = max(self.peak_active, self.active)
        for i in range(n):
            act = emit_h[i]
            n_active = int(act.sum())
            if n_active == 0:
                continue               # all slots drained mid-chunk
            ctx = float(np.mean([self._slot_ctx[s]
                                 for s in np.flatnonzero(act)]))
            rep = self._meter_decode(n_active, max(ctx, 1.0))
            per_tok_t = rep.t_total / n_active
            per_tok_e = rep.energy_j / n_active
            for slot in np.flatnonzero(act):
                rid = self.slot_rid[slot]
                resp = self.responses[rid]
                tok = int(tok_h[i, slot])
                resp.tokens.append(tok)
                resp.t_emit.append(now)
                resp.decode_s += per_tok_t
                resp.energy_j += per_tok_e
                self._slot_ctx[slot] += 1.0
                self.slot_budget[slot] -= 1
                eos_hit = (self.slot_eos[slot] is not None
                           and tok == self.slot_eos[slot])
                if self.slot_budget[slot] <= 0 or eos_hit:
                    resp.finished = True
                    resp.finish_reason = "eos" if eos_hit else "length"
                    self.slot_rid[slot] = -1
                    self._slot_armed[slot] = False
            self._steps += 1
        return True

    def step(self, max_steps: int = 10_000) -> bool:
        """Run ONE scheduling quantum: admission, then one fused decode
        chunk. Returns whether anything progressed."""
        admitted = self._admit()
        decoded = self._decode_chunk(max_steps) if self.decoding else False
        return bool(admitted or decoded)

    def run(self, max_steps: int = 10_000) -> List[Response]:
        """Drive until the queue drains and all slots finish. Exhausting
        ``max_steps`` marks every unfinished response ``"timeout"``
        without finishing it."""
        while (self.queue or self.active) and self._steps < max_steps:
            if not self.step(max_steps):
                # waiting work with a free slot is always admitted and an
                # occupied slot always decodes, so this cannot happen
                raise RuntimeError("engine made no progress with work queued")
        if self._steps >= max_steps:
            for r in self.responses.values():
                if not r.finished:
                    r.finish_reason = "timeout"
        return list(self.responses.values())

    # -------------------------------------------------------------- reports
    def carbon_report(self) -> str:
        return self.meter.report()

    @property
    def host_syncs(self) -> int:
        """Device->host synchronization points (decode chunk fetches plus
        one first-token fetch per prefill batch)."""
        return self.decode_chunks + self.prefill_batches

    def stats(self) -> Dict[str, float]:
        """The reference engine's ``stats()`` keys. Counters of features
        of later slices (shedding, deferral, preemption, deadlines, faults,
        rate limits) are kept at 0 so the two engines' stats compare key
        for key."""
        t = self.meter.totals
        pf = self.meter.phase("prefill")
        dc = self.meter.phase("decode")
        finished = [r for r in self.responses.values() if r.finished]
        lat = [r.prefill_s + r.decode_s for r in finished]
        p50 = float(np.median(lat)) if lat else 0.0
        # single-sample guard: a 1-request run reports its own latency
        p99 = float(np.percentile(lat, 99)) if len(lat) > 1 else p50
        slo_ok = slo_n = 0
        for r in finished:
            slo = self._req_slo.get(r.rid)
            if slo is not None:
                slo_n += 1
                slo_ok += (r.prefill_s + r.decode_s) <= slo
        out: Dict[str, float] = {
            "queue_depth": len(self.queue),
            "deferred_depth": 0,
            "deferred_requests": 0,
            "deferred_released": 0,
            "deferred_forced_releases": 0,
            "shed_count": 0,
            "preemption_count": 0,
            "deadline_cancelled": 0,
            "clamped_requests": 0,
            "fault_retries": 0,
            "rate_limited": 0,
            "preempted_recompute_j": 0.0,
            "timeout_requests": sum(
                1 for r in self.responses.values()
                if not r.finished and r.finish_reason == "timeout"),
        }
        for p, waits in sorted(self._wait_samples.items()):
            out[f"queue_wait_p50_s_class_{p}"] = float(np.median(waits))
            out[f"queue_wait_p99_s_class_{p}"] = (
                float(np.percentile(waits, 99)) if len(waits) > 1
                else float(np.median(waits)))
        out.update({
            "requests": len(self.responses),
            "peak_active": self.peak_active,
            "p50_latency_s": p50,
            "p99_latency_s": p99,
            "slo_attainment": (slo_ok / slo_n) if slo_n else 1.0,
            "steps": self._steps,
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
            "embodied_fraction": (t.embodied_g / t.total_g) if t.total_g else 0.0,
            # multi-criteria impact ledger: the same per-phase attribution
            # priced in water / primary energy / ADPe
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
        })
        return out
