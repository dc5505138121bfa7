"""Serving engine (the port of ``repro.serving.engine``): request queue,
continuous batching over a fixed pool of decode slots, prefill/decode
phase split, per-phase carbon metering — on the contiguous KV cache or on
the paged KV pool, with chunked prefill and page-level prefix sharing.

The engine runs the model for real on the card while the energy and
carbon of each step are attributed by the calibrated analytical model
against a target hardware profile (paper §2), through the same
``CarbonMeter`` and Eq. 2-4 carbon model as the reference — so a run
prices bit-identically to the JAX engine's on the same trace.

Hot path, as in the reference:

  * admissions are batched: every waiting request that fits a free slot
    prefills in one launch per power-of-two length bucket (right padding
    plus position masking, for models whose blocks mask pads exactly:
    dense, parallel, shared and mamba2), or per exact prompt length for a model
    with a block that takes no mask (rwkv6), padded to a power-of-two
    batch; the new caches enter the pool in one indexed copy per leaf;
  * decode runs ``sync_every`` fused micro-steps (decode -> sample ->
    EOS/budget masking) on the device per host sync: on the card one
    replay of a CUDA graph of the step (``serving/graphs.py``), captured
    once for each chunk length that occurs.

The meter prices each prefill at its padded launch shape (that is what
the device ran) and attributes real tokens, exactly as the reference.

The KV memory ladder, each rung requiring the previous, as the reference:

  * ``paged``: slots share one pool of ``num_pages`` pages per layer
    through block tables (``serving/paged.py``); admission reserves each
    request's worst case (prompt + decode budget) in pages, so the
    on-device free stack never underflows, and rejects a request that can
    never fit; decode runs the paged decode kernel. A hybrid model's
    recurrent state (mamba2) stays slot-addressed beside the pool; rwkv6
    is served on the contiguous engine only and refuses this rung, as in
    the reference;
  * ``prefill_chunk``: prompts are split into fixed-size chunks, and each
    scheduling quantum runs at most one chunk launch (``prefill_pack``
    requests packed into it) plus one fused decode chunk; the chunk runs
    the chunked-prefill kernel over the slot's paged history. A request's
    prefill is metered once, at batch 1 and its true prompt length, when
    its last chunk completes. Recurrent blocks do not chunk: a model with
    one refuses this rung, and with it ``prefix_sharing``;
  * ``prefix_sharing``: a host-side index (SHA-256 chain over page-size
    token chunks -> resident physical page) maps a new prompt's shared
    whole pages into its table by refcount; prefill starts at the first
    unshared token, admission reserves only the unshared worst case, and
    a chunk writing into a page with refcount > 1 copies it first. The
    shared tokens' compute is subtracted from the metered prefill.

The front door, as in the reference (``serving/server.py`` drives it
asynchronously): a bounded admission queue that sheds by policy
(``max_queue``, ``shed_policy``) and clamps low-class budgets under
pressure (``pressure_clamp``); per-tenant token buckets checked at submit
(``tenant_quota``); request deadlines, swept at the top of every quantum
wherever the request is; priority preemption (``preemption``, requires
chunked prefill): a high-class request short of a slot or pages evicts
the lowest armed slot of a strictly lower class, whose indexed prefix
stays resident under a host-side pin while the request, its tokens folded
into its prompt, waits at the front of its class (``serving/preempt.py``);
and fault recovery at the three launch sites (``page_alloc``,
``prefill_chunk``, ``decode_scan``; ``serving/faults.py``): an injected
fault fires before the site touches any device tensor, so the launch
never happened, and the site retries after 2**fails quanta, raising
``FaultError`` past ``max_retries`` consecutive failures; and temporal
deferral (``defer_below_priority``): batch-class requests wait, owning
nothing, for the CI forecaster's greenest window on the meter's virtual
clock, or until deadline pressure forces their release.

The data-parallel fleet (``serving/sharded.py``) borrows this engine's
host-side policy and its chunk launch; ``shards`` is ignored here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.energy import decode_counts, prefill_counts, step_energy
from repro_torch.core.forecast import CIForecaster
from repro_torch.core.hardware import HardwareProfile, get_profile
from repro_torch.core.intensity import Region, ci_trace
from repro_torch.core.meter import CarbonMeter
from repro_torch.device import resolve_device
from repro_torch.models.costing import workload_of
from repro_torch.models.model import Model
from repro_torch.serving import paged as PG
from repro_torch.serving import graphs, preempt, sampling
from repro_torch.serving.faults import FaultError, InjectedFault
from repro_torch.serving.request import Request, Response


def pack_chunks(prefilling, chunk: int, pack: int):
    """Select the prefill work of ONE quantum from the FCFS ``prefilling``
    deque of (request, slot) pairs: up to ``pack`` requests' next chunks
    whose combined token count fits the ``chunk`` budget.

    The head always contributes its next chunk (min(remaining, chunk)
    tokens). Requests behind it join only with their WHOLE remainder, and
    only while the budget holds, so every request's chunk boundaries are
    those of the head-only schedule — packing regroups launches, it never
    re-chunks anyone. FCFS is kept: the scan stops at the first request
    that does not fit. At most ONE ``cow_pending`` row (a whole-prompt-
    shared adopter about to recompute its tail token into a still-shared
    page) rides a launch: ``paged.cow_chunk_pages`` evaluates every row
    against one pre-launch refcount snapshot, so two such rows adopting
    the same page would both privatize it while the host mirror decrefs
    sequentially. Returns [(req, slot, pos0, piece), ...]."""
    take = []
    budget = chunk
    cow_seen = False
    for req, slot in prefilling:
        if len(take) >= pack:
            break
        rem = len(req.prompt) - req.prefill_pos
        piece = min(rem, chunk) if not take else rem
        if piece > budget:
            break
        if req.cow_pending and cow_seen:
            break                      # second CoW row waits its turn
        take.append((req, slot, req.prefill_pos,
                     req.prompt[req.prefill_pos:req.prefill_pos + piece]))
        budget -= piece
        cow_seen = cow_seen or req.cow_pending
    return take


def _prefill_phase_counts(workload, batch: int, seq: int,
                          useful_seq: Optional[float] = None, skip: int = 0):
    """Step counts for one prefill launch of ``batch`` sequences padded to
    ``seq``, with ``skip`` leading tokens already resident (prefix sharing:
    prefill(seq) - prefill(skip) is the cost of computing the suffix with
    attention over the full prefix; the suffix launch still streams the
    weights once)."""
    counts = prefill_counts(workload, batch, seq, useful_seq=useful_seq)
    if skip > 0:
        base = prefill_counts(workload, batch, skip)
        counts = dataclasses.replace(
            counts, flops=counts.flops - base.flops,
            hbm_bytes=(counts.hbm_bytes - base.hbm_bytes
                       + workload.params_bytes),
            kv_bytes=counts.kv_bytes - base.kv_bytes,
            compute_tokens=counts.compute_tokens - base.compute_tokens)
    return counts


@dataclasses.dataclass
class EngineConfig:
    """Every serving knob of the reference ``repro.serving.EngineConfig``,
    with the same fields and defaults, so a config written for one engine
    means the same to the other. The port serves the contiguous default
    path, the paged ladder (``paged``, ``prefill_chunk`` with
    ``prefill_pack``, ``prefix_sharing``), the front door (``max_queue``,
    ``shed_policy``, ``pressure_clamp``, ``preemption``, ``max_retries``,
    ``tenant_quota``) and temporal deferral (``defer_below_priority``,
    ``defer_horizon_h``, ``defer_deadline_frac``). The fleet's knobs
    (``shards``, ``shard_profiles``, ``shard_regions``, ``routing``) are
    read by ``ShardedServingEngine``; this single-device engine ignores
    ``shards``, as the reference's does.
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
    # fleet serving (ShardedServingEngine): the shard count, S shards of
    # max_batch slots and num_pages pages each on one device. The base
    # ServingEngine ignores it.
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


class ServingEngine:
    def __init__(self, model: Model, params, cfg: EngineConfig,
                 device: Union[str, torch.device] = "cuda"):
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} but model on {model.device}")
        if model.cfg.is_encdec:
            # the reference's engine fails at its first prefill (a
            # KeyError on 'frames'); this one says so before it starts
            raise ValueError(
                f"{model.cfg.name}: an encoder-decoder model prefills over "
                "the encoder's input, extras['frames'], and a Request "
                "carries no frames; neither engine serves it (drive "
                "Model.prefill(..., extras={'frames': ...}) and "
                "decode_step directly)")
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
        # slots ARMED for decode: in chunked mode a slot is occupied during
        # its whole prefill but decodes only after its last chunk
        self._slot_armed = [False] * B
        self._req_slo: Dict[int, Optional[float]] = {}
        # sampling noise (temperature > 0 only); draws differ from the
        # reference's jax.random stream
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(0)
        # the fused decode step: one CUDA graph a static key on the card
        self.graphs = graphs.DecodeGraphs(model, params, self.cur_tokens,
                                          self.state, self._gen)
        self._steps = 0
        self.decode_chunks = 0                         # device->host syncs
        self.prefill_batches = 0
        self.prefill_chunks = 0                        # chunked-prefill launches
        self.peak_active = 0                           # max concurrent requests
        self._wait_samples: Dict[int, List[float]] = {}  # class -> waits (s)
        # front-door mirrors: the Request occupying each slot (eviction and
        # deadline cancellation mutate it in place) and its priority class
        self._slot_req: List[Optional[Request]] = [None] * B
        self._slot_prio = [0] * B
        self._has_deadlines = False    # skip the sweep when nobody set one
        # scheduling-quantum counter (one per step()): the fault injector's
        # clock and the backoff schedule's time base
        self._quantum = 0
        self._run_q0 = 0               # quantum at the current run()'s start
        self.faults = None             # Optional[faults.FaultInjector]
        self._backoff: Dict[str, Tuple[int, int]] = {}   # site -> (fails, retry_at)
        self.fault_retries = 0
        self.fault_retry_site: Dict[str, int] = {}       # site -> retries
        # per-tenant token buckets: tenant -> [tokens, last_refill_t]
        self._tenant_buckets: Dict[str, List[float]] = {}
        self.rate_limited = 0
        self.shed_count = 0
        self._shed_by_class: Dict[int, int] = {}
        self.preemption_count = 0
        self.deadline_cancelled = 0
        self.clamped_requests = 0
        self.preempted_recompute_j = 0.0
        # preemption pins: rid -> physical pages whose references moved out
        # of the evicted slot (kept resident and indexed for the resume's
        # prefix hit); dropped after re-adoption, cancel or shed
        self._pins: Dict[int, List[int]] = {}
        if cfg.shed_policy not in ("reject_newest", "reject_lowest"):
            raise ValueError(f"unknown shed_policy {cfg.shed_policy!r}")
        if cfg.max_queue is not None and cfg.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if cfg.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if cfg.routing not in ("free_pages", "carbon"):
            raise ValueError(f"unknown routing {cfg.routing!r}")
        if cfg.defer_horizon_h < 1:
            raise ValueError("defer_horizon_h must be >= 1")
        if not (0.0 < cfg.defer_deadline_frac < 1.0):
            raise ValueError("defer_deadline_frac must be in (0, 1)")
        if cfg.tenant_quota is not None:
            for name, spec in cfg.tenant_quota.items():
                try:
                    cap, refill = spec
                except (TypeError, ValueError):
                    raise ValueError(
                        f"tenant_quota[{name!r}] must be (capacity, "
                        f"refill_per_s), got {spec!r}") from None
                if cap < 1 or refill < 0:
                    raise ValueError(
                        f"tenant_quota[{name!r}]: capacity must be >= 1 "
                        "and refill_per_s >= 0")
        # temporal deferral: held requests own NOTHING (no slot, no pages,
        # no queue position) until the CI forecaster's greenest window
        # opens at the virtual clock, or deadline pressure forces release
        self.deferred: deque = deque()
        self.deferred_rids: set = set()
        self._defer_release_h: Dict[int, float] = {}
        self._forecasters: Dict[str, CIForecaster] = {}
        self.deferred_total = 0
        self.deferred_released = 0
        self.deferred_forced = 0

        self.paged = cfg.paged
        if cfg.paged:
            if not model.supports_paged_decode:
                mla = model.kinds & {"mla", "mla_moe"}
                raise ValueError(
                    f"{model.cfg.name}: paged KV pool requires full-window "
                    "attention-family blocks (no ring eviction)"
                    + ("; MLA's latent cache (ckv, k_rope) has no paged "
                       "layout, as in the reference" if mla else ""))
            if cfg.max_len % cfg.page_size:
                raise ValueError("max_len must be a multiple of page_size")
            self.max_pages_slot = cfg.max_len // cfg.page_size
            # equal-memory default: the rows the contiguous pool would own
            self.num_pages = (B * self.max_pages_slot
                              if cfg.num_pages is None else cfg.num_pages)
            if self.num_pages < 1:
                raise ValueError("num_pages must be >= 1")
            PG.paginate_cache(self.caches, B, cfg.page_size, self.num_pages)
            # host mirror of worst-case page RESERVATIONS (>= device usage,
            # so the on-device free stack never underflows mid-flight)
            self.free_pages = self.num_pages
            self.peak_pages_reserved = 0
            self._slot_pages = [0] * B
            self._resv: Dict[int, int] = {}

        self.chunked = cfg.prefill_chunk is not None
        if self.chunked:
            if cfg.prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            if cfg.prefill_pack < 1:
                raise ValueError("prefill_pack must be >= 1")
            if not cfg.paged:
                raise ValueError("chunked prefill requires the paged KV "
                                 "pool (chunk i reads chunks 0..i-1 "
                                 "through the block table)")
            if not model.supports_chunked_prefill:
                raise ValueError(
                    f"{model.cfg.name}: chunked prefill requires all "
                    "stateful blocks to keep their KV in the paged pool "
                    "(recurrent blocks need carried-state chunk resume)")
            # FCFS queue of (request, slot) mid-prefill; req.prefill_pos
            # counts the prompt tokens already in the pool
            self._prefilling: deque = deque()
        if cfg.preemption and not self.chunked:
            raise ValueError(
                "preemption requires chunked prefill (prefill_chunk set): "
                "a preempted request resumes through the chunked admission "
                "path, adopting its pinned prefix and recomputing only the "
                "unshared tail")

        self.sharing = cfg.prefix_sharing
        if self.sharing:
            if not self.chunked:
                raise ValueError(
                    "prefix_sharing requires chunked prefill (prefill_chunk "
                    "set): sharing works by starting the chunk schedule at "
                    "the first unshared token")
            # host-side prefix index: SHA-256 chain digest of the first
            # (i+1) page-size token chunks -> physical page holding chunk i.
            # Weak entries: an index page is always mapped by >= 1 live
            # slot; _page_ref mirrors the device refcount of indexed pages
            # and the entry drops at decref-to-zero.
            self._prefix_index: Dict[bytes, int] = {}
            self._page_key: Dict[int, bytes] = {}        # reverse map
            self._page_ref: Dict[int, int] = {}
            # per-slot indexed pages: adopted from the index at admission
            # (not in this slot's reservation) vs registered by this slot
            # (popped under its reservation) — release accounting differs
            self._slot_shared_in: Dict[int, List[int]] = {}
            self._slot_own_idx: Dict[int, List[int]] = {}
            self.prefix_hit_tokens = 0     # prompt tokens never recomputed
            self.prefix_shared_requests = 0
            self.peak_shared_mappings = 0  # extra mappings beyond 1st copy

    # ------------------------------------------------------------- metering
    def _meter_prefill(self, batch: int, seq: int,
                       useful_seq: Optional[float] = None, skip: int = 0,
                       phase: str = "prefill"):
        """Meter one prefill launch of ``batch`` sequences padded to
        ``seq``; ``useful_seq`` (mean real tokens per row) attributes only
        the real tokens while the energy covers the whole padded launch.
        ``skip`` > 0 (prefix sharing, batch 1) removes the cost of the
        first ``skip`` tokens, whose compute and KV writes never ran.
        ``phase`` names the meter bucket."""
        counts = _prefill_phase_counts(self.workload, batch, seq,
                                       useful_seq=useful_seq, skip=skip)
        rep = step_energy(self.profile, counts)
        self.meter.record(phase, rep.tokens, rep.t_total, rep.energy_j)
        return rep

    def _meter_decode(self, batch: int, context: float):
        counts = decode_counts(self.workload, batch, context)
        rep = step_energy(self.profile, counts)
        self.meter.record("decode", rep.tokens, rep.t_total, rep.energy_j)
        return rep

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request) -> None:
        """Validate, register, and enqueue (or shed) a request. Raises
        ValueError for requests that are malformed rather than merely
        unschedulable."""
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens <= 0:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}")
        if self.cfg.paged and len(req.prompt) > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"exceeds max_len={self.cfg.max_len} — the paged block "
                "table has no ring eviction, so the prompt can never be "
                "represented (shorten it or raise max_len)")
        if req.rid in self.responses:
            raise ValueError(f"request {req.rid}: duplicate rid")
        req.t_submit = time.perf_counter()
        if req.deadline_s is not None:
            self._has_deadlines = True
        self._req_slo[req.rid] = req.slo_s
        self.responses[req.rid] = Response(rid=req.rid, tokens=[],
                                           priority=req.priority)
        if self._rate_limit(req):
            # over quota: terminal before the request owns anything — no
            # queue position, no max_queue charge, no slot, no pages
            resp = self.responses[req.rid]
            resp.finished = True
            resp.finish_reason = "rate_limited"
            self.rate_limited += 1
            return
        dbp = self.cfg.defer_below_priority
        if dbp is not None and req.priority < dbp:
            # batch-class work waits for the low-CI window; held requests
            # own nothing, so they bypass the bounded admission queue
            self._defer(req)
            return
        mq = self.cfg.max_queue
        if mq is not None and len(self.queue) >= mq:
            victim = self._pick_shed_victim(req)
            if victim is req:
                self._shed(req)
                return
            self.queue.remove(victim)
            self._shed(victim)
        self._enqueue(req)

    def _rate_limit(self, req: Request) -> bool:
        """Charge ``req``'s tenant one bucket token; True when the bucket
        is empty (the submission is shed as rate_limited). A tenant without
        a quota of its own takes the ``"*"`` default; ``tenant=None`` is
        never limited. Refill is continuous at ``refill_per_s`` against the
        host wall clock, capped at ``capacity``; with refill 0 the bucket
        is a hard budget of ``capacity`` submissions."""
        quota = self.cfg.tenant_quota
        if quota is None or req.tenant is None:
            return False
        spec = quota.get(req.tenant, quota.get("*"))
        if spec is None:
            return False
        cap, refill = float(spec[0]), float(spec[1])
        now = time.perf_counter()
        bucket = self._tenant_buckets.get(req.tenant)
        if bucket is None:
            bucket = [cap, now]
            self._tenant_buckets[req.tenant] = bucket
        bucket[0] = min(cap, bucket[0] + (now - bucket[1]) * refill)
        bucket[1] = now
        if bucket[0] < 1.0:
            return True
        bucket[0] -= 1.0
        return False

    def _enqueue(self, req: Request, resume: bool = False) -> None:
        """Priority-ordered insert, FCFS within a class. ``resume`` inserts
        at the FRONT of the request's class band: a preempted request
        already waited its turn once."""
        q = self.queue
        if resume:
            i = 0
            while i < len(q) and q[i].priority > req.priority:
                i += 1
        else:
            i = len(q)
            while i > 0 and q[i - 1].priority < req.priority:
                i -= 1
        q.insert(i, req)

    def _pick_shed_victim(self, incoming: Request) -> Request:
        if self.cfg.shed_policy == "reject_newest":
            return incoming
        # reject_lowest: shed the NEWEST request of the LOWEST waiting
        # class — unless the incoming request is at or below that class
        lowest = min(r.priority for r in self.queue)
        if incoming.priority <= lowest:
            return incoming
        for r in reversed(self.queue):
            if r.priority == lowest:
                return r
        return incoming                # unreachable: lowest came from queue

    def _shed(self, req: Request) -> None:
        resp = self.responses[req.rid]
        resp.finished = True
        resp.finish_reason = "shed"
        self.shed_count += 1
        self._shed_by_class[req.priority] = (
            self._shed_by_class.get(req.priority, 0) + 1)
        self._drop_pin(req.rid)        # a shed resumee abandons its pin

    def _drop_pin(self, rid: int) -> None:
        """Release a preemption pin: decref the pinned pages on the device
        and mirror the last-holder-credits-once flow on the host (pins exist
        only with prefix sharing: the pin IS an index residency)."""
        pins = self._pins.pop(rid, None)
        if not pins:
            return
        pages = np.full((self.max_pages_slot,), -1, np.int32)
        pages[:len(pins)] = pins
        self.caches["paged"] = PG.decref_pages(self.caches["paged"],
                                               self._tensor(pages))
        for p in pins:
            self._page_ref[p] -= 1
            if self._page_ref[p] <= 0:
                self._drop_index_page(p)
                self.free_pages += 1   # the pin was the last holder

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_rid) if r < 0]

    @property
    def active(self) -> int:
        return sum(1 for r in self.slot_rid if r >= 0)

    @property
    def decoding(self) -> int:
        """Slots armed for decode (excludes slots still mid-prefill)."""
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

    # ---------------------------------------------------- temporal deferral
    # Batch-class requests wait for the grid's greenest window (paper §4's
    # temporal lever): the CI forecaster picks the lowest-mean-CI window in
    # the look-ahead horizon at submit time, the request is parked owning
    # nothing, and it re-enters the FCFS queue when the engine's virtual
    # clock reaches that window — or earlier, when defer_deadline_frac of
    # its deadline budget has elapsed (the rest is reserved for service).

    def _clock_hours(self) -> float:
        """Virtual time in hours — the deferral time base."""
        return self.meter.clock_hours

    def _advance_clock_to(self, hours: float) -> None:
        self.meter.clock_hours = max(self.meter.clock_hours, hours)

    def _defer_regions(self) -> List[Region]:
        return [self.meter.region]

    def _forecaster(self, region: Region) -> CIForecaster:
        fc = self._forecasters.get(region.name)
        if fc is None:
            # fit on two synthetic days of the region's diurnal trace —
            # the stand-in for yesterday's telemetry feed
            hours = np.arange(0.0, 48.0)
            fc = CIForecaster().fit(hours, ci_trace(region, hours))
            self._forecasters[region.name] = fc
        return fc

    def _defer(self, req: Request) -> None:
        """Park ``req`` until the greenest forecast window across the
        engine's regions opens (fixed at submit — a day-ahead commitment,
        so release order within a class stays FCFS)."""
        now_h = self._clock_hours()
        best = now_h
        best_ci = None
        for region in self._defer_regions():
            start, mean_ci = self._forecaster(region).greenest_window(
                now_h, horizon_h=self.cfg.defer_horizon_h)
            if best_ci is None or mean_ci < best_ci:
                best, best_ci = start, mean_ci
        self._defer_release_h[req.rid] = best
        self.deferred.append(req)
        self.deferred_rids.add(req.rid)
        self.deferred_total += 1

    def _release_deferred(self) -> int:
        """Move due (window open) or forced (deadline pressure) requests
        from the deferral queue into the admission queue. Releases are
        prefix-closed per priority class: if request i of a class is
        released, everything of that class ahead of it is too — deferral
        can never reorder same-class FCFS."""
        if not self.deferred:
            return 0
        now_h = self._clock_hours()
        now_s = time.perf_counter()
        frac = self.cfg.defer_deadline_frac
        last_eligible: Dict[int, int] = {}
        forced_rids: set = set()
        for i, req in enumerate(self.deferred):
            due = now_h >= self._defer_release_h[req.rid]
            forced = (req.deadline_s is not None
                      and now_s - req.t_submit >= frac * req.deadline_s)
            if due or forced:
                last_eligible[req.priority] = i
                if forced and not due:
                    forced_rids.add(req.rid)
        if not last_eligible:
            return 0
        kept: deque = deque()
        released = 0
        for i, req in enumerate(self.deferred):
            if i <= last_eligible.get(req.priority, -1):
                self.deferred_rids.discard(req.rid)
                self._defer_release_h.pop(req.rid, None)
                self.deferred_released += 1
                if req.rid in forced_rids:
                    self.deferred_forced += 1
                self._enqueue(req)
                released += 1
            else:
                kept.append(req)
        self.deferred = kept
        return released

    def _fast_forward_deferred(self) -> None:
        """Nothing runnable remains but deferred work is parked: move the
        virtual clock forward to the earliest release window and release.
        (The modeled clock only advances with work, so an otherwise idle
        engine jumps to the window instead of busy-waiting toward it.)"""
        h = min(self._defer_release_h[r.rid] for r in self.deferred)
        self._advance_clock_to(h)
        self._release_deferred()

    def _tensor(self, values) -> torch.Tensor:
        """An int32 tensor on the engine's device. On the card the values
        are staged in pinned memory and copied without blocking: a copy
        from pageable memory would wait for the whole stream."""
        host = torch.from_numpy(np.array(values, np.int32))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------- prefix sharing
    def _prompt_page_keys(self, req: Request) -> List[bytes]:
        """Chain digest per full page-size chunk of the prompt: key[i]
        commits to tokens [0, (i+1)*page_size), so an index hit at i means
        the whole prefix through page i matches. Cached on the request."""
        if req.prefix_keys is None:
            ps = self.cfg.page_size
            keys: List[bytes] = []
            h = hashlib.sha256()
            for i in range(len(req.prompt) // ps):
                h.update(np.asarray(req.prompt[i * ps:(i + 1) * ps],
                                    np.int64).tobytes())
                keys.append(h.digest())
            req.prefix_keys = keys
        return req.prefix_keys

    def _match_prefix(self, req: Request) -> Tuple[int, List[int]]:
        """Longest resident prefix of the prompt: (#shared whole pages,
        their physical ids, in logical order)."""
        phys: List[int] = []
        for k in self._prompt_page_keys(req):
            p = self._prefix_index.get(k)
            if p is None:
                break
            phys.append(p)
        return len(phys), phys

    def _drop_index_page(self, p: int) -> None:
        key = self._page_key.pop(p, None)
        if key is not None:
            self._prefix_index.pop(key, None)
        self._page_ref.pop(p, None)

    def _reject(self, req: Request) -> None:
        """Fail a request that can never fit the pool without admitting
        it."""
        resp = self.responses[req.rid]
        resp.finished = True
        resp.rejected = True
        resp.finish_reason = "rejected"

    def _release_slots(self, slots: List[int]) -> None:
        """Return finished slots' pages to the pool: device free stack
        (decref-to-zero of the mapped pages) and host reservation mirror.
        With prefix sharing every physical page is charged once by the slot
        that popped it and credited once by its last holder."""
        if not self.paged or not slots:
            return
        mask = np.zeros((self.cfg.max_batch,), bool)
        mask[slots] = True
        self.caches["paged"] = PG.release_slots(
            self.caches["paged"], self._tensor(mask).bool())
        for s in slots:
            ret = self._slot_pages[s]
            if self.sharing:
                for p in self._slot_own_idx.pop(s, []):
                    self._page_ref[p] -= 1
                    if self._page_ref[p] <= 0:
                        self._drop_index_page(p)
                    else:
                        ret -= 1       # survives under someone else's map
                for p in self._slot_shared_in.pop(s, []):
                    self._page_ref[p] -= 1
                    if self._page_ref[p] <= 0:
                        self._drop_index_page(p)
                        ret += 1       # last holder frees the original
            self.free_pages += ret
            self._slot_pages[s] = 0

    # ---------------------------------------------------------------- faults
    # The three injectable launch sites (serving/faults.py) follow one
    # discipline: the injection point sits BEFORE any device mutation, so
    # a fault means the launch never happened — the site's work stays
    # queued (admission re-queues its takes explicitly; prefill and decode
    # work was never dequeued) and is retried after 2**fails quanta.
    # max_retries consecutive failures raise FaultError out of run() with
    # every reservation returned.

    def _inject(self, site: str) -> None:
        if self.faults is not None:
            self.faults.check(site, self._quantum, self._run_q0)

    def _site_ready(self, site: str) -> bool:
        return self._backoff.get(site, (0, 0))[1] <= self._quantum

    def _site_failed(self, site: str) -> None:
        fails = self._backoff.get(site, (0, 0))[0] + 1
        self.fault_retries += 1
        self.fault_retry_site[site] = self.fault_retry_site.get(site, 0) + 1
        if fails > self.cfg.max_retries:
            raise FaultError(
                f"site {site!r} failed {fails} consecutive launches "
                f"(max_retries={self.cfg.max_retries}); in-flight requests "
                "are re-queued and reservations returned")
        self._backoff[site] = (fails, self._quantum + 2 ** fails)

    def _site_ok(self, site: str) -> None:
        self._backoff.pop(site, None)

    def _faults_pending(self) -> bool:
        return bool(self._backoff)

    # ------------------------------------------------------------ preemption
    def _try_preempt(self, req: Request) -> bool:
        """Evict ONE armed slot of a strictly lower priority class so
        ``req`` (the queue head) can be admitted; True if a slot was freed.
        Admission re-evaluates the head afterwards, so repeated calls evict
        at most one victim per shortfall, lowest class first."""
        if not self.cfg.preemption:
            return False
        progress = [(r.max_new_tokens - self.slot_budget[s])
                    if r is not None else 0
                    for s, r in enumerate(self._slot_req)]
        victim = preempt.pick_victim(self._slot_armed, self._slot_prio,
                                     progress, req.priority)
        if victim is None:
            return False
        self._evict_slot(victim)
        return True

    def _evict_slot(self, slot: int) -> None:
        """Evict the ARMED ``slot`` mid-decode (``serving/preempt.py`` holds
        the contract): disarm its device state, release its pages except
        the leading indexed run (whose references move to a host pin, so
        the computed prefix stays resident and adoptable), fold the tokens
        generated so far into the request's prompt and requeue it at the
        front of its class. The disarmed slot's next decode writes go to
        the trash page (its table row is cleared here, and the fused step
        routes inactive slots there). Resume is ordinary re-admission: the
        folded prompt's leading pages hit the pinned prefix index, so only
        the unshared tail is recomputed, metered as 'recompute'."""
        req = self._slot_req[slot]
        resp = self.responses[req.rid]
        preempt.fold_for_resume(req, resp, self.slot_budget[slot])
        pinned: List[int] = []
        if self.sharing:
            held = set(self._slot_shared_in.get(slot, []))
            held |= set(self._slot_own_idx.get(slot, []))
            pinned = preempt.pinned_run(self._prompt_page_keys(req),
                                        self._prefix_index, held)
        mask = np.zeros((self.cfg.max_batch,), bool)
        mask[slot] = True
        n_keep = np.zeros((self.cfg.max_batch,), np.int32)
        n_keep[slot] = len(pinned)
        self.caches["paged"] = PG.release_slots_keep(
            self.caches["paged"], self._tensor(mask).bool(),
            self._tensor(n_keep))
        sampling.disarm_slots(self.state, self._tensor([slot]))
        self._account_eviction(slot, pinned)
        if pinned:
            self._pins[req.rid] = pinned
        self._clear_slot(slot)
        self.preemption_count += 1
        self._enqueue(req, resume=True)

    def _account_eviction(self, slot: int, pinned: List[int]) -> None:
        """Host mirror of ``release_slots_keep``: the pinned pages'
        references move to the pin (``_page_ref`` unchanged — the device
        refcount did not move either); everything else follows the
        ordinary popper-charges-once / last-holder-credits-once flows."""
        ret = self._slot_pages[slot]
        if self.sharing:
            keep = set(pinned)
            for p in self._slot_own_idx.pop(slot, []):
                if p in keep:
                    ret -= 1           # stays resident under the pin
                    continue
                self._page_ref[p] -= 1
                if self._page_ref[p] <= 0:
                    self._drop_index_page(p)
                else:
                    ret -= 1           # survives under someone else's map
            for p in self._slot_shared_in.pop(slot, []):
                if p in keep:
                    continue           # adopted reference moved to the pin
                self._page_ref[p] -= 1
                if self._page_ref[p] <= 0:
                    self._drop_index_page(p)
                    ret += 1           # last holder frees the original
        self.free_pages += ret
        self._slot_pages[slot] = 0

    def _clear_slot(self, slot: int) -> None:
        self.slot_rid[slot] = -1
        self.slot_budget[slot] = 0
        self.slot_eos[slot] = None
        self._slot_ctx[slot] = 0.0
        self._slot_armed[slot] = False
        self._slot_req[slot] = None
        self._slot_prio[slot] = 0

    # ------------------------------------------------------------- deadlines
    def _cancel(self, rid: int, reason: str) -> None:
        resp = self.responses[rid]
        resp.finished = True
        resp.finish_reason = reason
        if reason == "deadline":
            self.deadline_cancelled += 1
        self._drop_pin(rid)

    def _sweep_deadlines(self) -> None:
        """Cancel every request whose deadline expired, wherever it is:
        queued (dropped), mid-chunked-prefill (slot and reservation
        released), or armed mid-decode (disarmed, pages reclaimed in this
        same quantum). Runs at the top of each quantum, so a cancelled
        slot's pages are reusable by this quantum's own admission."""
        now = time.perf_counter()

        def expired(r: Request) -> bool:
            return (r.deadline_s is not None
                    and now - r.t_submit > r.deadline_s)

        for req in [r for r in self.queue if expired(r)]:
            self.queue.remove(req)
            self._cancel(req.rid, "deadline")
        if self.chunked:
            for req, slot in [p for p in self._prefilling
                              if expired(p[0])]:
                self._prefilling.remove((req, slot))
                self._clear_slot(slot)
                self._release_slots([slot])
                self._cancel(req.rid, "deadline")
        doomed = [s for s in range(self.cfg.max_batch)
                  if self._slot_armed[s] and self._slot_req[s] is not None
                  and expired(self._slot_req[s])]
        for s in doomed:
            sampling.disarm_slots(self.state, self._tensor([s]))
            rid = self.slot_rid[s]
            self._clear_slot(s)
            self._release_slots([s])
            self._cancel(rid, "deadline")

    # ------------------------------------------------------------ admission
    def _apply_pressure_clamp(self, req: Request) -> None:
        """Graceful degradation under queue pressure: once the admission
        queue is at least half full, clamp the decode budget of requests
        BELOW the best waiting class to ``pressure_clamp`` tokens. Applied
        at admission (not submit), so a queue that drains before the
        request's turn leaves it unclamped."""
        clamp = self.cfg.pressure_clamp
        if (clamp is None or self.cfg.max_queue is None
                or 2 * len(self.queue) < self.cfg.max_queue):
            return
        top = max(r.priority for r in self.queue)
        if req.priority < top and req.max_new_tokens > clamp:
            req.max_new_tokens = clamp
            self.clamped_requests += 1

    def _admit(self) -> int:
        """Admit waiting requests into free slots, FCFS. Returns the number
        admitted.

        Paged mode admits by worst-case page reservation (prompt + full
        decode budget, or with sharing the unshared worst case): a request
        that does not fit the REMAINING pool keeps waiting (no overtaking);
        one that can never fit the table or the TOTAL pool is rejected.
        Chunked mode only claims the slot and pages here; the prompt runs
        chunk by chunk in ``_prefill_quantum``.

        With ``preemption`` on, a shortfall (no free slot, or not enough
        free pages) for the queue head evicts ONE armed lower-priority slot
        per retry instead of waiting. The reservation pass sits behind the
        ``page_alloc`` fault site: an injected fault returns every
        reservation and puts the takes back at the queue head, so a failed
        admission is indistinguishable from one that never ran."""
        if self._over_budget() and self.active > 0:
            return 0                   # defer admissions; drain active work
        if self.queue and self.paged and not self._site_ready("page_alloc"):
            return 0                   # backing off a faulted reservation
        free = self.free_slots()
        take: List[Request] = []
        share: Dict[int, Tuple[int, List[int], int]] = {}
        while self.queue:
            req = self.queue[0]
            if len(take) >= len(free):
                if not self._try_preempt(req):
                    break              # no slot and nobody to evict
                free = self.free_slots()
                continue
            self._apply_pressure_clamp(req)
            if self.paged:
                L = len(req.prompt)
                ps = self.cfg.page_size
                n_total = PG.pages_needed(
                    L + max(req.max_new_tokens - 1, 0), ps)
                # no ring eviction: a request whose prompt + decode budget
                # exceeds the table or the whole pool can never be served
                if n_total > self.max_pages_slot or n_total > self.num_pages:
                    self.queue.popleft()
                    self._reject(req)
                    continue
                resv = n_total
                if self.sharing:
                    # reserve only the pages this request will pop itself:
                    # novel prompt pages + decode budget + (whole prompt
                    # shared) the one copy-on-write pop of the tail page
                    n_pg, phys = self._match_prefix(req)
                    first_tok = min(n_pg * ps, L - 1)
                    resv = n_total - first_tok // ps
                    share[req.rid] = (n_pg, phys, first_tok)
                if resv > self.free_pages:
                    if self._try_preempt(req):
                        free = self.free_slots()
                        continue       # evicted pages now in the pool
                    break              # keep waiting (FCFS, no overtaking)
                self.free_pages -= resv
                self._resv[req.rid] = resv
            take.append(self.queue.popleft())
        if take and self.paged:
            try:
                self._inject("page_alloc")
            except InjectedFault:
                # the reservation "failed": undo it exactly — every page
                # back, the takes back at the queue head in order; nothing
                # on the device moved yet
                for req in reversed(take):
                    self.free_pages += self._resv.pop(req.rid)
                    self.queue.appendleft(req)
                self._site_failed("page_alloc")
                return 0
            self._site_ok("page_alloc")
        if self.paged:
            self.peak_pages_reserved = max(self.peak_pages_reserved,
                                           self.num_pages - self.free_pages)
        if not take:
            return 0
        if self.chunked:
            slots = free[:len(take)]
            for req, slot in zip(take, slots):
                self.slot_rid[slot] = req.rid
                self.slot_budget[slot] = 0           # armed after last chunk
                self.slot_eos[slot] = req.eos_id
                self._slot_ctx[slot] = 0.0
                self._slot_pages[slot] = self._resv.pop(req.rid)
                self._slot_req[slot] = req
                self._slot_prio[slot] = req.priority
                self._stamp_admit(req)
                req.prefill_pos = 0
                self._prefilling.append((req, slot))
            PG.begin_chunked_prefill(self.caches, self._tensor(slots))
            if self.sharing:
                for req, slot in zip(take, slots):
                    self._adopt_prefix(req, slot, *share[req.rid])
                    # a resumed request re-adopted its pinned prefix through
                    # the index (the increfs above): the pin's own
                    # references go now, adopt then release, so the pages
                    # never pass through refcount zero
                    if req.rid in self._pins:
                        self._drop_pin(req.rid)
            return len(take)
        # bucket prompts: padded power-of-two buckets when the model masks
        # pad tokens exactly, exact-length groups otherwise. Buckets are
        # clamped to max_len — past that the cache ring must keep the LAST
        # W real tokens, so those prompts prefill at exact length
        padded = self.model.supports_padded_prefill
        groups: Dict[int, List[Request]] = {}
        for req in take:
            L = len(req.prompt)
            if padded and L <= self.cfg.max_len:
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
        last, pcache = self.model.prefill(
            self.params, self._tensor(tokens), self._tensor(mask),
            max_len=self.cfg.max_len)
        first = sampling.sample(last[:, :self.model.cfg.vocab], self._gen,
                                self.cfg.temperature)
        budgets = self._tensor([r.max_new_tokens - 1 for r in reqs])
        eos_ids = self._tensor([-1 if r.eos_id is None else r.eos_id
                                for r in reqs])
        insert = PG.insert_prefill_paged if self.paged else \
            sampling.insert_prefill
        kw = dict(page_size=self.cfg.page_size) if self.paged else {}
        insert(self.caches, pcache, self._tensor(slots), self.cur_tokens,
               first, self.state, budgets, eos_ids, **kw)
        first_h = first.cpu().numpy()  # the launch's one host sync
        self.prefill_batches += 1
        # meter the REAL padded launch once — the device ran ONE
        # (n_pad, bucket) batch. Real tokens are attributed (useful_seq);
        # per-request energy shares go by true prompt length, while each
        # request's modeled prefill TIME is the whole launch it waited on
        tot_real = sum(len(r.prompt) for r in reqs)
        rep = self._meter_prefill(n_pad, bucket, useful_seq=tot_real / n_pad)
        now = time.perf_counter()
        released: List[int] = []
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            self._stamp_admit(req)
            resp = self.responses[req.rid]
            resp.prefill_s += rep.t_total
            resp.energy_j += rep.energy_j * (len(req.prompt) / tot_real)
            resp.tokens.append(int(first_h[i]))
            resp.t_emit.append(now)
            if self.paged:
                self._slot_pages[slot] = self._resv.pop(req.rid)
            if req.max_new_tokens <= 1:
                resp.finished = True   # prefill token was the whole budget
                resp.finish_reason = "length"
                released.append(slot)  # return its prompt pages right away
                continue               # slot stays free (device side agrees)
            self.slot_rid[slot] = req.rid
            self.slot_budget[slot] = req.max_new_tokens - 1
            self.slot_eos[slot] = req.eos_id
            self._slot_ctx[slot] = float(len(req.prompt))
            self._slot_armed[slot] = True
            self._slot_req[slot] = req
            self._slot_prio[slot] = req.priority
        self._release_slots(released)

    def _adopt_prefix(self, req: Request, slot: int, n_pg: int,
                      phys: List[int], first_tok: int) -> None:
        """Map a matched prefix run into the freshly claimed slot (device
        increfs + logical-history rows) and start its chunk schedule at
        the first unshared token."""
        self._slot_shared_in[slot] = []
        self._slot_own_idx[slot] = []
        if n_pg == 0:
            return
        pages = np.full((self.max_pages_slot,), -1, np.int32)
        pages[:n_pg] = phys
        PG.map_shared_prefix(
            self.caches, self._tensor(slot), self._tensor(pages),
            self._tensor(n_pg * self.cfg.page_size),
            self._tensor(first_tok))
        req.prefill_pos = first_tok
        req.shared_prefix_tokens = first_tok
        # whole prompt shared: the first chunk recomputes the tail token
        # into a still-shared page and must copy-on-write — flag it so the
        # packer never puts two such rows in one launch
        req.cow_pending = first_tok < n_pg * self.cfg.page_size
        for p in phys:
            self._page_ref[p] += 1
        self._slot_shared_in[slot] = list(phys)
        self.prefix_hit_tokens += first_tok
        self.prefix_shared_requests += 1
        cur = sum(len(v) for v in self._slot_shared_in.values())
        self.peak_shared_mappings = max(self.peak_shared_mappings, cur)

    def _register_prefix(self, req: Request, slot: int,
                         row: np.ndarray) -> None:
        """After the LAST chunk, publish the prompt's whole pages into the
        prefix index (``row`` is the slot's block-table row, fetched with
        the first-token sync). First writer wins: a page already indexed
        under the same key is not re-registered."""
        own = self._slot_own_idx.setdefault(slot, [])
        for i, key in enumerate(self._prompt_page_keys(req)):
            p = int(row[i])
            if key not in self._prefix_index:
                self._prefix_index[key] = p
                self._page_key[p] = key
                self._page_ref[p] = self._page_ref.get(p, 0) + 1
                own.append(p)

    # ------------------------------------------------------ chunked prefill
    def _chunk_launch(self, tokens: np.ndarray, mask: np.ndarray,
                      lanes: np.ndarray, pos0: np.ndarray, n_tok: np.ndarray,
                      rows: np.ndarray, keep: Optional[np.ndarray] = None):
        """One chunked-prefill launch on the device: allocate the chunk's
        pages, copy-on-write any shared page it writes (with sharing), run
        the chunk through the model against a gathered slot view (its KV
        goes into the pool, its queries see each slot's whole logical
        history), and sample a candidate next token (meaningful after the
        LAST chunk only). ``lanes``, ``pos0`` and ``n_tok`` are the
        allocator's lanes — the slots, each one's first chunk token (its
        write cursor) and token count: (n,) here, (S, n) on the fleet,
        where a shard's idle lane is the sentinel slot B with 0 tokens;
        ``rows`` are the per-slot tree rows of ``tokens``' rows. ``keep``,
        if given, are the model rows whose slot state is written back and
        sampled (a ``moe`` fleet also runs its idle lanes, for their share
        of a shard's expert capacity). Returns (tokens (n,), shard-local
        block-table rows (n, M)) of the kept rows on the device; nothing
        here syncs with the host."""
        ps = self.cfg.page_size
        tok, msk = self._tensor(tokens), self._tensor(mask)
        self.caches["paged"] = PG.alloc_chunk_pages(
            self.caches["paged"], self._tensor(lanes),
            self._tensor(-(-pos0 // ps)),
            self._tensor(-(-(pos0 + n_tok) // ps)))
        if self.sharing:
            PG.cow_chunk_pages(self.caches, self._tensor(lanes),
                               self._tensor(pos0), self._tensor(n_tok), ps,
                               span=tokens.shape[1] // ps + 1)
        rows_t = self._tensor(rows)
        view = PG.gather_slot_view(self.caches, rows_t)
        last, view = self.model.prefill_chunk(self.params, view, tok, msk)
        if keep is not None:
            kt = self._tensor(keep).long()
            last, rows_t = last[kt], rows_t[kt]
            view = PG.slot_view_rows(view, kt)
        PG.scatter_slot_view(self.caches, view, rows_t)
        first = sampling.sample(last[:, :self.model.cfg.vocab], self._gen,
                                self.cfg.temperature)
        tbl = self.caches["paged"]["tbl"]
        return first, tbl.reshape(-1, tbl.shape[-1])[rows_t.long()]

    def _prefill_quantum(self) -> int:
        """Run AT MOST ONE prefill launch — the prefill half of a
        scheduling quantum: the FCFS head's next chunk plus (``prefill_pack``
        > 1) the whole remainders of requests behind it while the combined
        token count fits ``prefill_chunk``. Returns the launches (0 or 1)."""
        if not self._prefilling:
            return 0
        if not self._site_ready("prefill_chunk"):
            return 0                   # backing off a faulted chunk launch
        C = self.cfg.prefill_chunk
        packed = pack_chunks(self._prefilling, C, self.cfg.prefill_pack)
        try:
            self._inject("prefill_chunk")
        except InjectedFault:
            # the launch never ran: the packed requests are still at the
            # head of ``_prefilling`` with prefill_pos untouched, so the
            # SAME chunks relaunch after backoff
            self._site_failed("prefill_chunk")
            return 0
        self._site_ok("prefill_chunk")
        n = len(packed)
        tokens = np.zeros((n, C), np.int32)
        mask = np.zeros((n, C), np.int32)
        for i, (_, _, _, piece) in enumerate(packed):
            tokens[i, :len(piece)] = piece
            mask[i, :len(piece)] = 1
        slots = np.array([slot for _, slot, _, _ in packed], np.int32)
        first, tbl_rows = self._chunk_launch(
            tokens, mask, slots,
            np.array([pos0 for _, _, pos0, _ in packed], np.int32),
            mask.sum(axis=1, dtype=np.int32), slots)
        self.prefill_chunks += 1
        finished: List[int] = []
        for i, (req, slot, pos0, piece) in enumerate(packed):
            req.prefill_pos += len(piece)
            if self.sharing and piece:
                # mirror the device's copy-on-write: a chunk that wrote into
                # an adopted page still shared (refcount > 1) got a private
                # copy, so the slot no longer maps the indexed original
                shared = self._slot_shared_in.get(slot) or []
                lp = pos0 // self.cfg.page_size
                if lp < len(shared) and self._page_ref[shared[lp]] > 1:
                    self._page_ref[shared[lp]] -= 1
                    self._slot_shared_in[slot] = shared[:lp]
                req.cow_pending = False    # its CoW (if any) just ran
            if req.prefill_pos >= len(req.prompt):
                finished.append(i)
        if not finished:
            return 1                   # intermediate chunk: no host sync
        # only the head can be mid-prompt after a launch (packed tails
        # carried their whole remainder), so the finished rows are the
        # first len(finished) entries of the deque
        assert finished == list(range(n)), "packed tail finished before head"
        for _ in finished:
            self._prefilling.popleft()
        # last chunks: the sampled tokens are the requests' first emissions
        # — ONE host sync for every request finishing in this launch
        both = torch.cat([first[:, None], tbl_rows], dim=1).cpu().numpy()
        first_h, rows_h = both[:, 0], both[:, 1:]
        self.prefill_batches += 1      # one first-token host sync
        now = time.perf_counter()
        released: List[int] = []
        arm: List[Tuple[int, int, int, int]] = []   # slot, tok, budget, eos
        for i in finished:
            req, slot, _, _ = packed[i]
            if self.sharing:
                self._register_prefix(req, slot, rows_h[i])
            # chunking changes the schedule, not the modeled energy: the
            # request's prefill is attributed once, at its true prompt
            # length; the shared tokens' compute never ran and is skipped.
            # A preempted request's resume is charged to "recompute", so
            # every other request's modeled J/token is invariant to the
            # preemption policy
            rep = self._meter_prefill(
                1, len(req.prompt), skip=req.shared_prefix_tokens,
                phase="recompute" if req.preemptions else "prefill")
            resp = self.responses[req.rid]
            resp.prefill_s += rep.t_total
            resp.energy_j += rep.energy_j
            if req.preemptions:
                resp.recompute_j += rep.energy_j
                self.preempted_recompute_j += rep.energy_j
            tok = int(first_h[i])
            resp.tokens.append(tok)
            resp.t_emit.append(now)
            budget = req.max_new_tokens - 1
            # a fresh request's prefill token is never EOS-checked (EOS
            # only ends decode); a RESUMED request's first token is a
            # mid-decode emission of the original request and honors EOS,
            # for parity with the unpreempted run
            eos_hit = (req.preemptions > 0 and req.eos_id is not None
                       and tok == req.eos_id)
            if budget <= 0 or eos_hit:
                resp.finished = True   # prefill token was the whole budget
                resp.finish_reason = "eos" if eos_hit else "length"
                self.slot_rid[slot] = -1
                self._slot_req[slot] = None
                self._slot_prio[slot] = 0
                released.append(slot)
                continue
            arm.append((slot, tok, budget,
                        -1 if req.eos_id is None else req.eos_id))
            self.slot_budget[slot] = budget
            self._slot_ctx[slot] = float(len(req.prompt))
            self._slot_armed[slot] = True
        if arm:
            # one batched arm for every request finishing in this launch
            sampling.arm_slots(self.cur_tokens, self.state,
                               *(self._tensor([a[j] for a in arm])
                                 for j in range(4)))
        self._release_slots(released)
        return 1

    # --------------------------------------------------------------- decode
    def _decode_chunk(self, max_steps: int) -> bool:
        """One fused on-device chunk of up to ``sync_every`` decode steps
        for all armed slots; a single host sync at the end. Slots still
        mid-chunked-prefill ride along inert (device ``active`` false,
        cursors frozen). Finished slots' pages return to the pool at the
        chunk boundary. Returns whether a chunk launched (False while the
        ``decode_scan`` site backs off a fault: armed slots keep their
        state and relaunch later)."""
        if not self._site_ready("decode_scan"):
            return False               # backing off a faulted scan launch
        try:
            self._inject("decode_scan")
        except InjectedFault:
            # nothing launched: cur_tokens, state and caches hold their
            # pre-chunk values, so the relaunch after backoff samples the
            # identical chunk — no token lost or emitted twice
            self._site_failed("decode_scan")
            return False
        self._site_ok("decode_scan")
        budgets = [self.slot_budget[s] for s in range(self.cfg.max_batch)
                   if self._slot_armed[s]]
        n = min(self.cfg.sync_every, max(max(budgets), 1),
                max(max_steps - self._steps, 1))
        tok_mat, emit_mat = self.graphs.step(
            self.caches, n_steps=n, temperature=self.cfg.temperature,
            page_size=self.cfg.page_size if self.paged else 0,
            freeze_inactive=self.chunked)
        # the chunk's one host sync: tokens and emission flags together
        both = torch.stack([tok_mat, emit_mat.to(torch.int32)]).cpu().numpy()
        tok_h, emit_h = both[0], both[1].astype(bool)
        now = time.perf_counter()
        self.decode_chunks += 1
        self.peak_active = max(self.peak_active, self.active)
        released: List[int] = []
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
                    self._slot_req[slot] = None
                    self._slot_prio[slot] = 0
                    released.append(int(slot))
            self._steps += 1
        # page reclamation at the chunk boundary (finished slots coasted on
        # the trash page since their done flag rose mid-chunk)
        self._release_slots(released)
        return True

    def step(self, max_steps: int = 10_000) -> bool:
        """Run ONE scheduling quantum: deferral release, deadline sweep
        (when any request declared one), admission, at most one prefill
        chunk (chunked mode), one fused decode chunk. Returns whether
        anything progressed. The async server drives this directly, interleaving
        submissions and streaming tokens between quanta."""
        self._quantum += 1
        released = self._release_deferred() if self.deferred else 0
        if self._has_deadlines:
            self._sweep_deadlines()
        admitted = self._admit()
        chunks = self._prefill_quantum() if self.chunked else 0
        decoded = self._decode_chunk(max_steps) if self.decoding else False
        return bool(released or admitted or chunks or decoded)

    def _resolve_stall(self) -> None:
        """The quantum made no progress, nothing is armed, no fault site is
        backing off, yet requests wait: either preemption pins hold the
        missing pages (spill them: the resume just recomputes more) or,
        with the ENTIRE pool free, the head request can never fit and is
        failed; anything else is a leaked reservation. Shared by run() and
        the async server's drive loop."""
        if self.paged and self._pins and self.free_pages < self.num_pages:
            for rid in list(self._pins):
                self._drop_pin(rid)
            return
        if not self.paged or self.free_pages == self.num_pages:
            self._reject(self.queue.popleft())
        else:
            raise RuntimeError(        # unreachable: release returns
                "admission stalled with no active work — leaked "
                "page reservation")

    def run(self, max_steps: int = 10_000) -> List[Response]:
        """Drive until the queue drains and all slots finish. Exhausting
        ``max_steps`` marks every unfinished response ``"timeout"``
        without finishing it (a later run() with more steps clears the
        mark by finishing them). A fault site past ``max_retries`` raises
        ``FaultError`` with every reservation returned."""
        self._run_q0 = self._quantum
        while ((self.queue or self.active or self.deferred)
               and self._steps < max_steps):
            if self.step(max_steps):
                continue
            if self.decoding or self._faults_pending():
                continue               # armed slots or a site in backoff
            if self.queue:
                self._resolve_stall()
            elif self.deferred:
                # only parked work remains: move to the greenest window
                self._fast_forward_deferred()
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
        one first-token fetch per prefill batch, or per chunk launch that
        finishes a prompt)."""
        return self.decode_chunks + self.prefill_batches

    def stats(self) -> Dict[str, float]:
        """The reference engine's ``stats()`` keys."""
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
        out: Dict[str, float] = {}
        if self.paged:
            out.update({
                "paged": 1.0,
                "page_size": self.cfg.page_size,
                "pages_total": self.num_pages,
                "peak_pages_reserved": self.peak_pages_reserved,
                "free_pages": self.free_pages,
                # provisioned KV rows actually backing peak load — the
                # embodied-carbon memory model's input
                "peak_kv_rows_reserved":
                    self.peak_pages_reserved * self.cfg.page_size,
            })
        if self.chunked:
            out.update({
                "chunked": 1.0,
                "prefill_chunk": self.cfg.prefill_chunk,
                "prefill_chunks": self.prefill_chunks,
            })
        if self.sharing:
            out.update({
                "prefix_sharing": 1.0,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_shared_requests": self.prefix_shared_requests,
                # peak EXTRA table mappings of already-provisioned pages...
                "shared_pages": self.peak_shared_mappings,
                # ...while the physical footprint counts shared pages once
                "unique_pages": self.peak_pages_reserved,
            })
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
        for p, waits in sorted(self._wait_samples.items()):
            out[f"queue_wait_p50_s_class_{p}"] = float(np.median(waits))
            out[f"queue_wait_p99_s_class_{p}"] = (
                float(np.percentile(waits, 99)) if len(waits) > 1
                else float(np.median(waits)))
        for p, n_shed in sorted(self._shed_by_class.items()):
            out[f"shed_class_{p}"] = n_shed
        for site, n in sorted(self.fault_retry_site.items()):
            out[f"fault_retries_{site}"] = n
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
