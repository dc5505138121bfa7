"""Expert-parallel MoE over ``all_to_all`` (the port of
``repro.models.moe_sharded``).

The reference runs its body under ``shard_map``; here each rank of a
``DeviceMesh`` runs it eagerly on its own slice, with ``torch.distributed``
collectives where the reference has ``jax.lax`` ones:

  1. the (B, S, d) input is the same on every rank; each rank takes its
     ``T_pad / n`` tokens (zero rows pad T to a multiple of the mesh
     size), routes them locally and scatters them into an (E, C, d) send
     buffer, C a capacity per (sender, expert) (GShard-style local
     capacity: ``max(4, ceil(T_loc k cf / E))`` rounded up to 4);
  2. ``all_to_all`` over each expert axis ("ea") in turn moves the token
     buffers to their experts' owners (split the expert dim, concatenate
     the capacity dim in sender order: ``jax.lax.all_to_all(...,
     split_axis=0, concat_axis=1, tiled=True)``);
  3. where an expert's weights are also split on the FFN dim over the
     remaining axes ("fa"), the buffers are all-gathered over them and the
     partial outputs reduce-scattered back;
  4. the reverse ``all_to_all``, the weighted combine (a token's rows added
     one at a time in the reference's order: ``moe.combine``) and the
     shared expert on the rank's tokens; an all-gather over all ranks
     returns the global y on every rank, and the aux values are averaged
     over all ranks (the reference's ``pmean``).

``expert_axes(E, mesh)`` picks the axes, as in the reference: DeepSeek-V3
(E=256) on 16x16 is pure 256-way expert parallelism, Llama-4 (E=128)
16-way experts x 16-way FFN; the "pod" axis always replicates experts.

Gradients follow DTensor's convention for replicated values: the input,
the output and the replicated weights (router, shared expert) are the
same on every rank, and so is their gradient. So taking a rank's token
slice all-gathers in the backward, the final all-gather takes the rank's
slice back, and a replicated weight's gradient (each rank's tokens'
share) is summed over the ranks that replicate it; every collective's
backward is its transpose. The expert products are ``torch.bmm`` as in
``moe.py`` (plain ``einsum``s in the reference, outside any Pallas
kernel).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.sharding.api import (DTensor, axis_sizes, current_context,
                                      gather_fsdp, placements_of, replicated,
                                      shard)
from repro_torch.sharding.rules import expert_axes, full_spec, spec_for_param


def use_sharded_moe(cfg) -> bool:
    """True under a context whose expert axes have more than one rank."""
    ctx = current_context()
    if ctx is None:
        return False
    ea, _ = expert_axes(cfg.moe.n_experts, ctx.mesh)
    sizes = axis_sizes(ctx.mesh)
    return math.prod(sizes[a] for a in ea) > 1


def capacity(cfg, tokens_local: int) -> int:
    """Slots per (sender, expert): ``max(4, ceil(int(T_loc k cf) / E))``
    rounded up to a multiple of 4 (the reference's expression)."""
    m = cfg.moe
    C = max(4, -(-int(tokens_local * m.top_k * m.capacity_factor)
                 // m.n_experts))
    return -(-C // 4) * 4


# --- collectives that carry gradients ---------------------------------------

# newer torch renames the single-tensor forms (the old names warn there)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter_sum = getattr(dist, "reduce_scatter_single",
                              dist.reduce_scatter_tensor)


def _a2a(x: torch.Tensor, group, split: int, concat: int) -> torch.Tensor:
    """Tiled all-to-all: dim ``split`` cut into n blocks, block j sent to
    group rank j; the blocks received are joined on dim ``concat`` in
    sender order."""
    n = dist.get_world_size(group)
    inp = x.unflatten(split, (n, x.shape[split] // n)).movedim(
        split, 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return out.movedim(0, concat).flatten(concat, concat + 1)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Tiled all-gather on ``dim`` (group rank j's block j-th)."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x.contiguous(), group=group)
    return out.unflatten(0, (n, x.shape[0])).movedim(0, dim).flatten(
        dim, dim + 1)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Tiled reduce-scatter (sum) on ``dim``: group rank j keeps block j
    of the sum."""
    n = dist.get_world_size(group)
    inp = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    out = x.new_empty(tuple(inp.shape[1:]))
    _reduce_scatter_sum(out, inp.flatten(0, 1).contiguous(),
                        op=dist.ReduceOp.SUM, group=group)
    return out


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.args = (group, split, concat)
        return _a2a(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, split, concat = ctx.args
        return _a2a(g, group, concat, split), None, None, None


class AllGather(torch.autograd.Function):
    """Gather of values that differ by rank and are used apart: the
    backward sums the gradients back (reduce-scatter)."""
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _reduce_scatter(g, group, dim), None, None


class ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _gather(g, group, dim), None, None


class GatherReplicated(torch.autograd.Function):
    """Rank slices -> the replicated whole on dim 0 (all-gather over
    ``group``); the backward takes the rank's slice of the replicated
    gradient."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.args = (group, x.shape[0])
        return _gather(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        r = dist.get_rank(group)
        return g.narrow(0, r * n, n), None


class SliceReplicated(torch.autograd.Function):
    """A replicated tensor -> this rank's slice of dim 0; the backward
    all-gathers the slices' gradients into the replicated whole."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[0] // dist.get_world_size(group)
        return x.narrow(0, dist.get_rank(group) * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, 0), None


class SumGrad(torch.autograd.Function):
    """Identity on a weight replicated over ``groups``; the backward sums
    each rank's share of its gradient over them."""
    @staticmethod
    def forward(ctx, w, groups):
        ctx.groups = groups
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for group in ctx.groups:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g, None


class Mean(torch.autograd.Function):
    """Mean over the ranks of ``group`` (the reference's ``pmean``); every
    rank's value takes 1/n of the replicated gradient."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


# --- the layer ---------------------------------------------------------------


def _expert_shard(w, name: str, mesh, groups: Sequence) -> torch.Tensor:
    """An expert weight's shard on this rank: a DTensor placed as the rules
    place ``name`` (redistributed if it is not), its local tensor; or the
    whole tensor on a one-rank mesh. Its gradient is summed over
    ``groups``, the axes that replicate it."""
    if isinstance(w, DTensor):
        spec = full_spec(spec_for_param(name, tuple(w.shape), mesh), w.ndim)
        w = w.redistribute(mesh, placements_of(spec, mesh)).to_local()
    elif mesh.size() > 1:
        raise ValueError("on a mesh of more than one rank the expert weights "
                         "must be DTensors (sharding.distribute_params)")
    return SumGrad.apply(w, tuple(groups)) if groups else w


def _whole(w, world) -> torch.Tensor:
    """A weight every rank applies whole to its own tokens (the router, the
    shared expert): a DTensor gathered whole, its gradient summed over
    the ranks."""
    if isinstance(w, DTensor):
        w = w.full_tensor()
    return SumGrad.apply(w, (world,))


def _world(mesh):
    """The group of every rank of ``mesh``, which must be the world in
    rank order (``launch.mesh`` builds it so)."""
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("moe_ffn_sharded needs a mesh over the whole world "
                         "in rank order")
    return dist.group.WORLD


def moe_ffn_sharded(p: Dict, cfg, x: torch.Tensor,
                    mesh: Optional[object] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for ``moe.moe_ffn`` on the mesh of the active sharding
    context (or ``mesh``): x (B, S, d), the same on every rank, -> (y (B,
    S, d) on every rank, the aux dict averaged over the ranks). The expert
    weights are DTensors placed by ``sharding.distribute_params`` (their
    local tensors ``(E / |ea|, d, f / |fa|)``), or whole on a one-rank
    mesh."""
    if mesh is None:
        mesh = current_context().mesh
    # in the model's DTensor program (x a DTensor): the routed experts run
    # as below on the whole x, and the shared expert on DTensors between
    # the reference's two sites of its plain-SPMD shared expert
    x_dt = x if isinstance(x, DTensor) else None
    if x_dt is not None:
        x = x_dt.full_tensor()
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    sizes = axis_sizes(mesh)
    nd = mesh.size()
    ea, fa = expert_axes(E, mesh)
    world = _world(mesh)
    group = {a: mesh.get_group(a) for a in sizes}
    rest = [group[a] for a in sizes if a not in ea + fa]

    T_pad = -(-T // nd) * nd
    xt = x.reshape(T, d)
    if T_pad > T:
        xt = torch.cat([xt, xt.new_zeros((T_pad - T, d))])
    T_loc = T_pad // nd
    C = capacity(cfg, T_loc)
    xt_loc = SliceReplicated.apply(xt, world)

    router = _whole(p["router"], world)
    w_g, w_u, w_d = (_expert_shard(p[n], n, mesh, rest) for n in
                     ("experts_gate", "experts_up", "experts_down"))
    E_loc = E // math.prod(sizes[a] for a in ea)
    f_loc = m.d_ff_expert // math.prod(sizes[a] for a in fa)
    if tuple(w_g.shape) != (E_loc, d, f_loc):
        raise ValueError(f"experts_gate's local shard is {tuple(w_g.shape)}, "
                         f"expected {(E_loc, d, f_loc)} for ea={ea}, fa={fa}")

    rl = xt_loc.float() @ router                                # (T_loc, E)
    gates, ids = MOE.router_topk(rl, k)
    order, slot, keep, tok_idx = MOE.dispatch(ids, E, C)
    buf = MOE.scatter(xt_loc, slot, tok_idx, E, C)              # (E, C, d)

    # to the experts' owners: (E_loc, C * |ea|, d), then (.., C|ea||fa|, d)
    for a in ea:
        buf = AllToAll.apply(buf, group[a], 0, 1)
    for a in fa:
        buf = AllGather.apply(buf, group[a], 1)
    out = MOE.expert_ffn(buf, w_g, w_u, w_d)                    # partial in f
    for a in reversed(fa):
        out = ReduceScatter.apply(out, group[a], 1)
    for a in reversed(ea):
        out = AllToAll.apply(out, group[a], 1, 0)
    # out: (E, C, d), back at the sender
    y = MOE.combine(out, slot, keep, gates, order, tok_idx)     # (T_loc, d)
    if m.n_shared_experts and x_dt is None:
        y = y + L.swiglu({n: _whole(w, world)
                          for n, w in p["shared"].items()}, xt_loc)

    aux = torch.stack([MOE.load_balance_loss(rl, ids, E),
                       MOE.router_z_loss(rl),
                       1.0 - keep.float().mean()])
    aux = Mean.apply(aux, world)
    y = GatherReplicated.apply(y, world)[:T]
    if x_dt is not None:
        # DTensors out, so each gradient comes back as a local tensor
        y, aux = replicated(y, mesh), replicated(aux, mesh)
        if m.n_shared_experts:
            xt2 = shard(x_dt.reshape(T, d), "tokens", None)
            ys = shard(L.swiglu(gather_fsdp(p["shared"]), xt2), "tokens",
                       None)
            y = y + ys
    return y.reshape(B, S, d), {"moe_aux": aux[0], "moe_z": aux[1],
                                "moe_drop_frac": aux[2]}
