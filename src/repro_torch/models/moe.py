"""Mixture-of-experts FFN with capacity dispatch (the port of
``repro.models.moe``).

The reference's design, kept: tokens are sorted by expert (a stable sort,
so each expert keeps its tokens in order), scattered into fixed
``(E*C, d)`` capacity buffers, run through three batched products
``(E,C,d) x (E,d,f)`` and gathered back, each weighted by its gate and
summed into its token in the reference's order. A token past its
expert's capacity ``C`` is dropped: its slot is the scratch row ``E*C``,
which no expert reads and whose output row is zero.
The router runs in float32; the gate is a softmax over the selected
logits. The reference has no Pallas kernel here: the products are
``torch.bmm``.

Everything stays on the device: the per-expert counts are a
``scatter_add_`` (``torch.bincount`` waits for the device on CUDA), the
scatter and gathers are index copies, and ``C`` follows from the shapes,
so a forward through a ``moe`` block adds no host sync.

Capacity depends on the token count ``T = B*S`` of the call, and pad
tokens of a right-padded batch are routed and take capacity like real
ones (as in the reference), so a batch's shape and its pad rows' values
decide which real tokens are dropped (``attention.self_attention`` gives
a fully masked query row the plain version's value on the card).

A call may carry ``groups`` G > 1 groups of B/G rows each (a fleet's
shards, as the reference's ``shard_map`` body runs ``moe_ffn`` on each
shard's rows): each group routes against its own capacity ``C =
capacity(cfg, T/G)`` with its own ``(E*C, d)`` buffers and drops, so a
group's pad rows compete only inside it. The groups ride one dispatch
(group g's expert e is buffer block g*E + e) and the same three ``bmm``,
each expert's G buffers side by side.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.sharding import api as SH
from repro_torch.sharding.api import shard


def moe_init(gen, cfg, device) -> Dict:
    m = cfg.moe
    dt = L.dtype_of(cfg)
    d = cfg.d_model
    E, f = m.n_experts, m.d_ff_expert
    p = {
        "router": L.dense_init(gen, d, E, torch.float32, device),
        "experts_gate": L.normal(gen, (E, d, f), 1.0 / (d ** 0.5), dt, device),
        "experts_up": L.normal(gen, (E, d, f), 1.0 / (d ** 0.5), dt, device),
        "experts_down": L.normal(gen, (E, f, d), 1.0 / (f ** 0.5), dt,
                                 device),
    }
    if m.n_shared_experts:
        p["shared"] = L.swiglu_init(gen, d, f * m.n_shared_experts, dt,
                                    device)
    return p


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for a call of ``tokens`` tokens: ``max(8,
    ceil(T k cf / E))`` rounded up to a multiple of 8 (the reference's
    expression, float floor division included)."""
    m = cfg.moe
    C = max(8, int(-(-tokens * m.top_k * m.capacity_factor // m.n_experts)))
    return -(-C // 8) * 8


def router_topk(router_logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (gates (T,k) softmax-normalized over the selected experts,
    expert_ids (T,k))."""
    vals, ids = torch.topk(router_logits, top_k, dim=-1)
    gates = torch.softmax(vals.float(), dim=-1)
    return gates, ids


def load_balance_loss(router_logits: torch.Tensor, expert_ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    p_mean = probs.mean(dim=0)                                    # (E,)
    flat = expert_ids.reshape(-1)
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    f = counts / max(expert_ids.numel(), 1)
    return n_experts * torch.sum(f * p_mean)


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    z = torch.logsumexp(router_logits.float(), dim=-1)
    return torch.mean(z * z)


def dispatch(ids: torch.Tensor, n_experts: int, cap: int):
    """Capacity dispatch of the (T, k) expert ids: the stable order of the
    T*k (token, choice) pairs by expert, each pair's buffer row (expert *
    cap + its rank in the expert; ``n_experts * cap``, the scratch row,
    past the capacity), the keep mask and each pair's source token.
    Returns (order, slot, keep, tok_idx), each (T*k,) in sorted order."""
    k = ids.shape[-1]
    flat_ids = ids.reshape(-1)                                    # (T*k,)
    # stable ordering: sort by expert id, tokens keep relative order
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids.index_select(0, order)
    # position within the expert's group
    counts = torch.zeros((n_experts,), dtype=torch.long, device=ids.device)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_ids.numel(), device=ids.device) - \
        offsets.index_select(0, sorted_ids)
    keep = pos < cap
    slot = torch.where(keep, sorted_ids * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return order, slot, keep, torch.div(order, k, rounding_mode="floor")


def scatter(xt: torch.Tensor, slot: torch.Tensor, tok_idx: torch.Tensor,
            n_experts: int, cap: int) -> torch.Tensor:
    """The (E, C, d) capacity buffers of the tokens ``xt`` (T, d): each
    (token, choice) pair's row at its ``slot``. Dropped pairs all land on
    the scratch row E*C, which is cut off."""
    return _scatter_into(xt.new_zeros((n_experts * cap + 1, xt.shape[-1])),
                         xt, slot, tok_idx, n_experts, cap)


def _scatter_into(buf: torch.Tensor, xt: torch.Tensor, slot: torch.Tensor,
                  tok_idx: torch.Tensor, n_experts: int, cap: int
                  ) -> torch.Tensor:
    """``scatter`` into the zero buffer ``buf`` (E*C + 1, d) (a copy: under
    a mesh ``buf`` is a DTensor's local view)."""
    d = xt.shape[-1]
    buf = buf.index_copy(0, slot, xt.index_select(0, tok_idx))
    return buf[:n_experts * cap].view(n_experts, cap, d)


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, pin: bool = False) -> torch.Tensor:
    """SwiGLU of each expert's buffer rows: (E, C, d) x (E, d, f) ->
    (E, C, d), three ``bmm`` (the SiLU in float32)."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = torch.nn.functional.silu(g.float()).to(buf.dtype) * u
    if pin:                             # the dense dispatch's site
        h = shard(h, "experts", None, None)
    return torch.bmm(h, w_down)


def combine(out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            gates: torch.Tensor, order: torch.Tensor, tok_idx: torch.Tensor,
            pin: bool = False) -> torch.Tensor:
    """Each token's (T, d) output from the experts' (E, C, d): its k rows
    gathered by ``slot``, weighted by their gates (0 where dropped), added
    one at a time in the reference's order."""
    E, C, d = out.shape
    T, k = gates.shape
    # row E*C: 0 (a product into a slice of a buffer has no gradient, so
    # the zero row is joined on)
    out = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
    weight = torch.where(keep, gates.reshape(-1).index_select(0, order),
                         torch.zeros((), device=out.device)).to(out.dtype)
    # each token's k contributions, added one at a time in x's type in the
    # reference's order (its scatter-add runs over the pairs sorted by
    # expert: a token's experts in increasing id). Deterministic on the
    # card, where an index_add_ of k rows into one token's row is not
    by_tok = torch.argsort(tok_idx, stable=True)
    pin_ = shard if pin else (lambda t, *axes: t)   # the dense dispatch's
    gathered = pin_(out.index_select(0, slot.index_select(0, by_tok)),
                    "expert_flat", None)
    contrib = (gathered * weight.index_select(0, by_tok)[:, None]).view(
        T, k, d)
    y = pin_(contrib[:, 0], "tokens", None)
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def can_drop(cfg, tokens: int) -> bool:
    """Whether a call of ``tokens`` tokens can drop one: more (token,
    choice) pairs than one expert's slots. Where it cannot, each token's
    output is its own experts' and the other tokens' values cannot change
    it."""
    return tokens * cfg.moe.top_k > capacity(cfg, tokens)


def moe_apply(p: Dict, cfg, x: torch.Tensor, groups: int = 1
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """x: (B, S, d) -> (B, S, d) and the routing that ``moe_aux`` reads:
    (router logits (T, E) float32, expert ids (T, k), keep mask (T*k,)).
    Serving calls this and launches no aux loss; training adds
    ``moe_aux`` of the routing (``moe_ffn``). ``groups``: the module
    docstring (rows [g*B/G, (g+1)*B/G) are group g).

    The reference's eleven sites of its dense dispatch stand at the same
    points (the accumulator's first site on the first contribution, which
    the combine starts from). Under a mesh whose expert axes are one rank
    (the expert-parallel layer takes the others: ``models/moe_sharded``)
    the index work (sort, counts, scatter, combine) runs on whole,
    replicated tables (``sharding.api.local_op``), the expert products on
    DTensors."""
    m = cfg.moe
    B, S, d = x.shape
    T, k, E, G = B * S, m.top_k, m.n_experts, groups
    if B % G:
        raise ValueError(f"{B} rows do not split into {G} groups")
    C = capacity(cfg, T // G)
    rep = (None,)

    xt = shard(x.reshape(T, d), "tokens", None)
    rl = shard(xt.float() @ p["router"], "tokens", None)          # (T, E)
    gates, ids = SH.local_op(lambda r: router_topk(r, k), [(None, None)],
                             ((None, None), (None, None)))(rl)   # (T, k)

    # group g's expert e is expert g*E + e of one dispatch
    gids = ids if G == 1 else ids + torch.div(
        torch.arange(T, device=ids.device), T // G,
        rounding_mode="floor")[:, None] * E
    order, slot, keep, tok_idx = SH.local_op(
        lambda i: dispatch(i, G * E, C), [(None, None)], (rep,) * 4)(gids)
    order = shard(order, "expert_flat")
    slot = shard(slot, "expert_flat")
    buf = shard(xt.new_zeros((G * E * C + 1, d)), "expert_flat", None)
    expert_in = SH.local_op(
        lambda b, x, s, t: _scatter_into(b, x, s, t, G * E, C),
        [(None, None), (None, None), rep, rep], (None, None, None))(
            buf, xt, slot, tok_idx)
    if G > 1:       # (G*E, C, d) -> each expert's G buffers: (E, G*C, d)
        expert_in = expert_in.view(G, E, C, d).transpose(0, 1).reshape(
            E, G * C, d)
    expert_in = shard(expert_in, "experts", None, None)
    out = expert_ffn(expert_in, p["experts_gate"], p["experts_up"],
                     p["experts_down"], pin=True)
    out = shard(out, "experts", None, None)
    if G > 1:
        out = out.view(E, G, C, d).transpose(0, 1).reshape(G * E, C, d)
    y = SH.local_op(functools.partial(combine, pin=True),
                    [(None, None, None), rep, rep, (None, None), rep, rep],
                    (None, None))(out, slot, keep, gates, order, tok_idx)
    y = shard(y, "tokens", None)
    if m.n_shared_experts:
        y = y + L.swiglu(p["shared"], xt)

    return y.reshape(B, S, d), (rl, ids, keep)


def moe_aux(cfg, rl: torch.Tensor, ids: torch.Tensor, keep: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """The aux-loss dict of ``moe_apply``'s routing (``moe_aux``,
    ``moe_z``, ``moe_drop_frac``: 0-d float32 tensors); under a mesh on
    the whole, replicated routing."""
    def aux(rl, ids, keep):
        return {"moe_aux": load_balance_loss(rl, ids, cfg.moe.n_experts),
                "moe_z": router_z_loss(rl),
                "moe_drop_frac": 1.0 - keep.float().mean()}
    return SH.local_op(aux, [(None, None), (None, None), (None,)],
                       dict.fromkeys(("moe_aux", "moe_z", "moe_drop_frac"),
                                     ()))(rl, ids, keep)


def moe_ffn(p: Dict, cfg, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d) and the aux-loss dict, as the
    reference's ``moe_ffn``."""
    y, routing = moe_apply(p, cfg, x)
    return y, moe_aux(cfg, *routing)
