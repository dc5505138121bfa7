"""Serving request/response types."""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]                  # token ids
    max_new_tokens: int = 150          # paper §2.1 times 150 generated tokens
    arrival_s: float = 0.0
    slo_s: Optional[float] = None
    eos_id: Optional[int] = None
    # serving-class fields (the async front door): higher priority wins
    # admission and may PREEMPT lower classes when the engine is configured
    # for it; a deadline (wall-clock seconds from submit) past which the
    # request is cancelled wherever it is — queued, mid-prefill, or
    # mid-decode — with its pages reclaimed in the same quantum.
    priority: int = 0
    deadline_s: Optional[float] = None
    # multi-tenancy: the billing identity this request draws quota from.
    # When the engine is configured with tenant rate limits, submit()
    # charges this tenant's token bucket and sheds over-quota work as a
    # terminal "rate_limited" Response. None = untracked (never limited).
    tenant: Optional[str] = None
    # chunked-prefill progress: prompt tokens already processed (the quantum
    # scheduler advances this one `prefill_chunk` slice at a time while
    # decode slots keep running)
    prefill_pos: int = 0
    # prefix sharing: chain digest per whole page of the prompt (computed
    # lazily by the engine; waiting requests re-match every admission pass
    # as the index fills, so the keys are cached here), and how many prompt
    # tokens were adopted from resident pages instead of recomputed
    prefix_keys: Optional[List[bytes]] = None
    shared_prefix_tokens: int = 0
    # True between adopting a prefix that covers the WHOLE prompt and the
    # first chunk launch: that chunk recomputes the last prompt token into
    # a still-shared page, i.e. it will copy-on-write. The chunk packer
    # admits at most one such row per launch — the device CoWs all rows of
    # a launch against ONE refcount snapshot, so two CoW rows on the same
    # page would free it while the host's sequential mirror kept it
    # indexed (see pack_chunks).
    cow_pending: bool = False
    # preemption bookkeeping: how many times this request was evicted
    # mid-flight (each resume folds the tokens generated so far into the
    # prompt and re-enters the queue), and wall-clock timestamps the engine
    # stamps at submit()/first admission for queue-wait accounting.
    preemptions: int = 0
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    # fault recovery: consecutive failed launch attempts for this request's
    # in-flight work (bounded by EngineConfig.max_retries)
    retries: int = 0


# Response.finish_reason values (None while the request is in flight):
#   "eos"      — the model emitted the request's EOS token
#   "length"   — the max_new_tokens budget was exhausted
#   "rejected" — the request can never fit the KV pool
#   "shed"     — dropped by the bounded admission queue under overload
#   "deadline" — cancelled because its deadline expired
#   "timeout"  — run(max_steps) ran out of steps with the request unfinished
#                (the request is NOT finished; a later run() may clear this)
#   "error"    — repeated faults exhausted the retry budget
#   "rate_limited" — the tenant's token bucket had no capacity at submit
FINISH_REASONS = ("eos", "length", "rejected", "shed", "deadline",
                  "timeout", "error", "rate_limited")


@dataclasses.dataclass
class Response:
    rid: int
    tokens: List[int]
    prefill_s: float = 0.0
    decode_s: float = 0.0
    energy_j: float = 0.0
    carbon_g: float = 0.0
    finished: bool = False
    rejected: bool = False             # could never fit the KV pool
    finish_reason: Optional[str] = None
    # serving-class observability: the request's priority class, how long
    # it waited in the admission queue before its FIRST admission, how many
    # times it was preempted, and the modeled energy spent RECOMPUTING
    # context on resume (prefill of the folded prompt minus any prefix-index
    # hit) — attributed here, and only here, so non-preempted requests'
    # modeled J/token is invariant to the preemption policy.
    priority: int = 0
    queue_wait_s: float = 0.0
    preemptions: int = 0
    recompute_j: float = 0.0
    # host wall-clock (time.perf_counter) at which each token became
    # visible to the host — one entry per token; tokens landing in the same
    # fused chunk share a timestamp. Feeds TTFT / inter-token-latency
    # percentiles in benchmarks/engine_bench.py.
    t_emit: List[float] = dataclasses.field(default_factory=list)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)
