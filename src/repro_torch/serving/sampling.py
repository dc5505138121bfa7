"""On-device sampling, termination and slot-pool insertion for the fused
serving step (the port of ``repro.serving.sampling``).

``fused_decode_steps`` runs ``n_steps`` engine micro-steps (decode ->
sample -> EOS/budget masking -> done flags) as a loop of device
operations with no ``.item()`` and no other host sync inside: the host
syncs once per chunk, on the stacked (n_steps, B) token and emission
matrices. Where the reference threads the slot state and caches through
a ``lax.scan`` carry, here they are updated in place.

Slot state is a dict of fixed-shape device tensors::

    {"active": (B,) bool,   # slot is decoding
     "budget": (B,) int32,  # decode tokens still allowed
     "eos":    (B,) int32}  # per-slot EOS id, -1 = none

Termination semantics match the reference token for token: a step first
emits the sampled token for every active slot, then decrements the budget
and raises ``done`` on budget exhaustion or EOS — the EOS token itself is
emitted, and a request for N new tokens emits exactly N (1 from prefill +
N-1 decode).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def init_slot_state(max_batch: int, device) -> Dict[str, torch.Tensor]:
    return {
        "active": torch.zeros((max_batch,), dtype=torch.bool, device=device),
        "budget": torch.zeros((max_batch,), dtype=torch.int32, device=device),
        "eos": torch.full((max_batch,), -1, dtype=torch.int32, device=device),
    }


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float) -> torch.Tensor:
    """logits: (B, vocab) -> (B,) int32. temperature <= 0 means greedy
    (first maximal index, as ``jnp.argmax``). Sampled draws come from
    ``generator`` and differ from the reference's ``jax.random`` ones."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def fused_decode_steps(model, params, caches, cur_tokens: torch.Tensor,
                       state: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator], n_steps: int,
                       temperature: float, page_size: int = 0,
                       freeze_inactive: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``n_steps`` fused engine micro-steps on the device.

    cur_tokens: (B, 1) int32 — last token of every slot. ``caches``,
    ``cur_tokens`` and ``state`` are updated in place, the allocator at
    ``caches["paged"]`` too: every tensor the step reads or writes stays
    where it lies, so one CUDA graph of the step replays it (the engines
    call it through ``serving/graphs.py``). Returns (tok_mat, emit_mat),
    both (n_steps, B): the sampled token per step and whether the slot was
    active (the token is a real emission). Finished and free slots keep
    re-feeding their last token; their logits are computed but never read.

    ``page_size`` > 0 marks a paged KV pool: before each micro-step,
    alloc-on-write pops a free page for every ACTIVE slot whose next token
    starts a new logical page, so finished slots coasting to the chunk
    boundary write to the trash page instead of draining the pool.

    ``freeze_inactive`` (chunked-prefill engines) keeps inactive slots'
    write cursors at their pre-step values (``paged.freeze_inactive_
    cursors``), so a slot parked mid-chunked-prefill keeps its logical
    position exact while decode runs around it, and routes the garbage
    write of a parked slot whose next row is already history to the trash
    page (``paged.in_place_rows``, ``paged.model_table``).

    The fleet's tree (``ShardedServingEngine``) is S shards' B slots each:
    its per-slot rows and ``cur_tokens``/``state`` are flat (S*B, ...),
    its allocator has S shards (a single engine's has 1), and each
    micro-step is ONE forward over the S*B rows through
    ``paged.model_table``'s (S*B, M) table of pool page ids. Nothing in
    the loop syncs with the host.
    """
    from repro_torch.serving import paged as PG
    vocab = model.cfg.vocab
    active, budget, eos = state["active"], state["budget"], state["eos"]
    toks, emits = [], []
    old = tbl = None            # buffers the micro-steps refill
    for _ in range(n_steps):
        if page_size:
            PG.alloc_decode_pages(caches["paged"], caches["t"], active,
                                  page_size)
        if freeze_inactive:
            old = PG.snapshot_cursors(caches, old)
        alloc = caches.get("paged")
        if alloc is not None:
            tbl = PG.model_table(
                alloc, PG.in_place_rows(caches, active) if freeze_inactive
                else None, tbl)
            caches["paged"] = {"tbl": tbl}
        logits, caches = model.decode_step(params, caches, cur_tokens)
        if alloc is not None:
            caches["paged"] = alloc
        if freeze_inactive:
            PG.freeze_inactive_cursors(old, caches, active)
        nxt = sample(logits[:, :vocab], generator, temperature)
        nxt = torch.where(active, nxt, cur_tokens[:, 0])
        emitted = active.clone()
        budget -= emitted.to(torch.int32)
        done = emitted & ((budget <= 0) | ((eos >= 0) & (nxt == eos)))
        active &= ~done
        cur_tokens[:, 0] = nxt
        toks.append(nxt)
        emits.append(emitted)
    return torch.stack(toks), torch.stack(emits)


def insert_prefill(pool: Dict, src: Dict, slots: torch.Tensor,
                   cur_tokens: torch.Tensor, first_tokens: torch.Tensor,
                   state: Dict[str, torch.Tensor], budgets: torch.Tensor,
                   eos_ids: torch.Tensor) -> None:
    """Copy a batch-n prefilled cache into ``slots`` of the batch-B pool
    (in place, one indexed copy per leaf), set the slots' first decode
    tokens and arm their slot state. ``src`` may carry pad rows past n
    (the engine pads the prefill batch to a power of two); they are
    dropped here. A zero budget arms the slot inactive. Every leaf a layer
    holds is copied by name, whatever it is (a ``cross`` layer's ``k`` and
    ``v`` have no ``pos_ids`` or ``length``); the contiguous engine resets
    no leaf on release, so nothing else reads the names."""
    n = slots.shape[0]
    sl = slots.long()
    pool["t"][sl] = src["t"][:n]
    for dst, s in zip(pool["layers"], src["layers"]):
        for name, leaf in dst.items():
            leaf[sl] = s[name][:n]
    arm_slots(cur_tokens, state, slots, first_tokens, budgets, eos_ids)


def arm_slots(cur_tokens: torch.Tensor, state: Dict[str, torch.Tensor],
              slots: torch.Tensor, first_tokens: torch.Tensor,
              budgets: torch.Tensor, eos_ids: torch.Tensor) -> None:
    """Set the admitted slots' first decode tokens and arm their device
    state in place. A zero budget arms the slot inactive."""
    n = slots.shape[0]
    sl = slots.long()
    cur_tokens[sl, 0] = first_tokens[:n]
    state["active"][sl] = budgets > 0
    state["budget"][sl] = budgets
    state["eos"][sl] = eos_ids


def disarm_slots(state: Dict[str, torch.Tensor], slots: torch.Tensor) -> None:
    """Deactivate ``slots`` mid-decode (preemption eviction or deadline
    cancellation), in place: the inverse of ``arm_slots``. A disarmed slot
    stops sampling at the next fused chunk exactly like a slot whose
    ``done`` flag fired — budget zeroed so any stale read sees a spent
    slot. The caller snapshots the remaining budget from its host mirror
    BEFORE disarming (resume needs it)."""
    sl = slots.long()
    # index_fill_: a scalar assigned through a tensor index would be
    # copied from the host and wait for the stream
    state["active"].index_fill_(0, sl, False)
    state["budget"].index_fill_(0, sl, 0)
    state["eos"].index_fill_(0, sl, -1)


def prefill_bucket(length: int, min_bucket: int = 8) -> int:
    """Power-of-two length bucket (>= min_bucket): bounds the number of
    distinct prefill shapes to log2(max prompt length)."""
    b = min_bucket
    while b < length:
        b *= 2
    return b
