"""Preemption policy: victim selection and the eviction/resume contract
(the port's copy of ``repro.serving.preempt``).

Why preempt at all, in a sustainability repo: decode dominates serving
energy (paper §2.3), so under overload the scarce resources — decode
slots and KV pages — should be carrying the requests the operator
actually prioritizes. Without preemption a burst of high-priority
traffic queues behind long low-priority decodes, and the energy those
slots keep burning is spent on exactly the wrong tokens; EcoServe
(arXiv:2502.05043) and GreenLLM (arXiv:2412.20322) both assume the
engine can reclaim and reassign resources mid-request.

The contract (implemented in ``ServingEngine._evict_slot`` and the
sharded twin; property-tested in tests/test_preemption.py):

  * Only ARMED slots (mid-decode) are victims — a mid-prefill slot has
    produced nothing a user has seen, so cancelling it is the deadline
    path's job, not preemption's.
  * Eviction releases the victim's pages EXCEPT the leading run that is
    registered in the prefix index: those pages' refcounts transfer to a
    host-side pin, so the computed prefix stays resident and adoptable.
  * The victim's generated tokens are folded into its prompt and the
    request re-enters the queue at the FRONT of its priority band with
    ``max_new_tokens`` set to the remaining budget. Resume is therefore
    re-admission + prefix hit + recompute of only the unshared tail.
  * Greedy decoding makes the unpreempted run a token-for-token oracle:
    the resumed prefill recomputes the same context at the same logical
    positions, so every subsequent token is identical.
  * The recompute energy is metered under the ``"recompute"`` phase and
    attributed to the preempted request alone (``Response.recompute_j``,
    engine-level ``preempted_recompute_j``) — non-preempted requests'
    modeled J/token is invariant to the preemption policy.

Shard-loss EVACUATION (the fleet) reuses the same machinery: when a fleet
shard is declared dead, every armed slot on it goes through the identical
``fold_for_resume`` fold and re-enters the queue at its class front — the
only differences from a preemption eviction are that no pages can be
pinned (a pin is a residency in the DEAD pool) and no release program is
issued against the dead shard. Greedy decode depends only on context, so
the fold + re-prefill on a SURVIVING shard reproduces the exact token
stream — the fail-free fleet is the token-for-token evacuation oracle,
the same oracle pattern preemption pinned.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.serving.request import Request, Response


def fold_for_resume(req: Request, resp: Response, remaining: int) -> None:
    """Fold the tokens emitted since (re)admission into the request's
    prompt and reset it for re-admission with ``max_new_tokens`` =
    ``remaining`` — the eviction/evacuation fold shared by preemption
    (``_evict_slot``, both engines) and shard-loss evacuation.

    The last emitted token is ``cur_tokens`` (not yet in the KV cache):
    the resumed prefill recomputes it as the prompt's final token and
    samples the NEXT token — exactly what the oracle's decode does.
    Prefix bookkeeping resets because the prompt changed (keys re-digest
    lazily at the next admission pass)."""
    emitted = req.max_new_tokens - remaining
    assert emitted > 0 and remaining > 0, "victim must be mid-decode"
    req.prompt = list(req.prompt) + resp.tokens[-emitted:]
    req.max_new_tokens = remaining
    req.prefill_pos = 0
    req.prefix_keys = None
    req.shared_prefix_tokens = 0
    req.cow_pending = False
    req.preemptions += 1
    resp.preemptions += 1


def pick_victim(armed: Sequence[bool], prio: Sequence[int],
                progress: Sequence[int],
                below_priority: int) -> Optional[int]:
    """Slot to evict so a ``below_priority``-class request can run, or
    None when no armed slot ranks strictly below it.

    Lowest priority first (the least-valued work yields); ties break to
    the LEAST progress since (re)admission — fewest tokens to recompute
    on resume, i.e. the cheapest eviction in modeled J — then to the
    highest slot id (most recently admitted)."""
    best = None
    for s, a in enumerate(armed):
        if not a or prio[s] >= below_priority:
            continue
        key = (prio[s], progress[s], -s)
        if best is None or key < best[0]:
            best = (key, s)
    return None if best is None else best[1]


def pinned_run(keys: List[bytes], index: Dict[bytes, int],
               held: set) -> List[int]:
    """The leading run of the victim's prompt pages to PIN at eviction:
    physical pages that are (a) registered in the prefix index under the
    victim's chain digests and (b) actually mapped by the victim (a
    private duplicate whose key lost first-writer-wins registration is
    not resident history the index can hand back — stop there).

    Returned in logical order; ``release_slots_keep`` keeps exactly this
    prefix and the engine records it as the pin whose references the
    resumed request re-adopts through the ordinary prefix-index path."""
    run: List[int] = []
    for k in keys:
        p = index.get(k)
        if p is None or p not in held:
            break
        run.append(p)
    return run


def evacuation_mode(reachable: bool, emitted: int, dest: bool) -> str:
    """Per-request evacuation strategy when a shard is leaving the fleet.

    ``"migrate"`` — the shard is still reachable (admin drain, power cap,
    explicit ``fail_shard``) and a survivor has room: page-copy the
    slot's KV to the destination, zero recompute J.  ``"fold"`` — no
    migration path (shard unreachable, or no survivor has a free slot +
    pages) but the slot has emitted tokens worth keeping: fold and
    requeue, recompute-on-resume.  ``"restart"`` — nothing emitted yet
    (mid-prefill) and no migration path: reset to position 0 and requeue;
    folding would be indistinguishable from a restart anyway.

    Watchdog-declared deaths pass ``reachable=False`` — a shard that
    stopped answering cannot serve a page copy, so the PR-8 fold path
    stays the fallback, selected here per-request rather than globally."""
    if reachable and dest:
        return "migrate"
    return "fold" if emitted > 0 else "restart"
