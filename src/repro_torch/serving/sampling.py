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
                       temperature: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``n_steps`` fused engine micro-steps on the device.

    cur_tokens: (B, 1) int32 — last token of every slot. ``caches``,
    ``cur_tokens`` and ``state`` are updated in place. Returns (tok_mat,
    emit_mat), both (n_steps, B): the sampled token per step and whether
    the slot was active (the token is a real emission). Finished and free
    slots keep re-feeding their last token; their logits are computed but
    never read.
    """
    vocab = model.cfg.vocab
    active, budget, eos = state["active"], state["budget"], state["eos"]
    toks, emits = [], []
    for _ in range(n_steps):
        logits, caches = model.decode_step(params, caches, cur_tokens)
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
    dropped here. A zero budget arms the slot inactive."""
    n = slots.shape[0]
    pool["t"][slots] = src["t"][:n]
    for dst, s in zip(pool["layers"], src["layers"]):
        for name, leaf in dst.items():
            leaf[slots] = s[name][:n]
    arm_slots(cur_tokens, state, slots, first_tokens, budgets, eos_ids)


def arm_slots(cur_tokens: torch.Tensor, state: Dict[str, torch.Tensor],
              slots: torch.Tensor, first_tokens: torch.Tensor,
              budgets: torch.Tensor, eos_ids: torch.Tensor) -> None:
    """Set the admitted slots' first decode tokens and arm their device
    state in place. A zero budget arms the slot inactive."""
    n = slots.shape[0]
    cur_tokens[slots, 0] = first_tokens[:n]
    state["active"][slots] = budgets > 0
    state["budget"][slots] = budgets
    state["eos"][slots] = eos_ids


def prefill_bucket(length: int, min_bucket: int = 8) -> int:
    """Power-of-two length bucket (>= min_bucket): bounds the number of
    distinct prefill shapes to log2(max prompt length)."""
    b = min_bucket
    while b < length:
        b *= 2
    return b
