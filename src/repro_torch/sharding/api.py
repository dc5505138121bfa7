"""Logical-axis sharding (the port of ``repro.sharding.api``).

Model code names a tensor's dims by *logical* axes (``shard(x, "batch",
"seq", "heads", None)``). Under a ``ShardingContext`` the names resolve to
the axes of a ``DeviceMesh``, with the reference's rule: a mesh axis
appears at most once in a spec, and only axes the mesh has count.
``spec`` gives the reference's per-dim form (a tuple of mesh-axis names,
one entry a dim, as ``PartitionSpec``'s entries), ``placements`` the
DTensor form (one ``Shard(d)`` / ``Replicate()`` a mesh dim).

``shard`` is a no-op without a context, as in the reference. With one, a
DTensor is redistributed to the rule's placements; a plain tensor is a
rank-local value of an eager program (each rank runs the model itself)
and comes back as it is. A tensor dim is split only over mesh axes whose
product divides it (``fit_spec``: the longest leading run of the entry's
axes that does); over the rest it is replicated. GSPMD pads an uneven
dim instead; DTensor would shard it unevenly, and a rank could hold no
head at all (2 kv heads over a model axis of 4), which no kernel grid
takes.

``local_op`` runs a kernel op (or any function written for plain
tensors) on the local shards of its DTensor operands, over
``torch.distributed.tensor.experimental.local_map``: each operand is
redistributed to the placements its logical axes give (a plain tensor
among them is a rank-identical value, taken as replicated first), the
function sees ``to_local()`` of each, and its outputs are wrapped back
with the placements of their axes. Under autograd the function's own
backward (a kernel's ``autograd.Function``) runs on the shards too.
Without a context, or with no DTensor among the operands, the function
is called as it is.

``gather_fsdp`` is the weight all-gather of FSDP (ZeRO-3): each DTensor
leaf of a parameter subtree is redistributed to its placements with the
data-parallel axes (``pod``, ``data``) replicated, the model axis kept,
where the block uses it, as GSPMD gathers an FSDP-sharded weight before
its product. Its backward is the reduce-scatter of the gradient.

A plain tensor never meets a DTensor implicitly: what every rank holds
the same (the tokens, the stub frontend's inputs, a mask built from
positions, a zero carry) is wrapped as a replicated DTensor where the
model takes it in or builds it (``replicated``, ``replicated_like``),
and DTensor raises on any other.

The rules read only ``mesh.shape`` as a map of axis name to size
(``axis_sizes``): a ``DeviceMesh`` or any object whose ``shape`` is that
map (the reference's tests' fake meshes).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

try:                                    # torch >= 2.5: public module
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
except ImportError:                     # older torch
    from torch.distributed._tensor import (DTensor, Partial, Replicate,
                                           Shard)

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]

try:
    from torch.distributed.tensor.experimental import local_map
except ImportError:                     # older torch
    from torch.distributed._tensor.experimental import local_map

_STATE = threading.local()


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names``), or
    the ``shape`` map of a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def resolve_spec(entries: Sequence[AxisVal], mesh) -> Spec:
    """Per-dim mesh axes with each mesh axis used once, and only axes the
    mesh has; a tuple of one axis becomes the name (the reference's
    ``ShardingContext.spec`` over resolved entries)."""
    sizes = axis_sizes(mesh)
    resolved: List[AxisVal] = []
    used: set = set()
    for r in entries:
        if r is not None:
            rs = (r,) if isinstance(r, str) else tuple(r)
            rs = tuple(x for x in rs if x not in used and x in sizes)
            used.update(rs)
            r = rs if len(rs) > 1 else (rs[0] if rs else None)
        resolved.append(r)
    return tuple(resolved)


def placements_of(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dim i is
    ``Shard(d)`` where tensor dim d names its axis, else ``Replicate()``.
    A dim over several axes is split over them in mesh order (the first
    axis major), as the reference's tuple orders them; another order
    raises."""
    names = list(axis_sizes(mesh))
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard of ``shape`` under ``spec``: each sharded dim
    rounded up over the product of its axes (an uneven dim is padded, as
    XLA's per-device buffers and the first ranks of a DTensor hold it)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = 1
        for a in axes:
            n *= sizes[a]
        out[d] = -(-out[d] // n)
    return tuple(out)


def axes_of(entry: AxisVal) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fit_spec(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """``spec`` with each entry cut to the longest leading run of its axes
    whose product divides the dim (None where none does): a dim is never
    split unevenly (module docstring)."""
    sizes = axis_sizes(mesh)
    out: List[AxisVal] = []
    for entry, n in zip(spec, shape):
        keep: List[str] = []
        prod = 1
        for a in axes_of(entry):
            if n % (prod * sizes[a]):
                break
            prod *= sizes[a]
            keep.append(a)
        out.append(None if not keep else
                   (keep[0] if len(keep) == 1 else tuple(keep)))
    return tuple(out)


def axis_index(mesh, axes: AxisVal) -> int:
    """This rank's shard index along a dim split over ``axes`` (the first
    axis major, as DTensor splits a dim over several mesh dims)."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = axis_sizes(mesh)
    i = 0
    for a in axes_of(axes):
        i = i * sizes[a] + coord[names.index(a)]
    return i


def shard_offset(logical: str, n: int) -> int:
    """This rank's first index along a dim of ``n`` named ``logical``
    under the context: 0 without a ``DeviceMesh``, or where the rule does
    not split such a dim (``fit_spec``)."""
    ctx = current_context()
    if ctx is None or not on_mesh():
        return 0
    entry = ctx.fitted((logical,), (n,))[0]
    if entry is None:
        return 0
    for a in axes_of(entry):
        n //= axis_sizes(ctx.mesh)[a]
    return axis_index(ctx.mesh, entry) * n


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    mesh: object                        # a DeviceMesh (or a shape-only mesh)
    rules: Dict[str, AxisVal]           # logical name -> mesh axis (or tuple)

    def resolve(self, logical: Optional[str]) -> AxisVal:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, axes: Sequence[Optional[str]]) -> Spec:
        return resolve_spec([self.resolve(a) for a in axes], self.mesh)

    def placements(self, axes: Sequence[Optional[str]]) -> list:
        return placements_of(self.spec(axes), self.mesh)

    def fitted(self, axes: Sequence[Optional[str]],
               shape: Sequence[int]) -> Spec:
        """The spec of ``axes`` for a tensor of ``shape`` (``fit_spec``)."""
        return fit_spec(self.spec(axes), shape, self.mesh)


def current_context() -> Optional[ShardingContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: Dict[str, AxisVal]):
    """The context: logical names resolve on ``mesh`` under ``rules``. On
    a ``DeviceMesh`` the block is one SPMD program on DTensors."""
    prev = current_context()
    _STATE.ctx = ShardingContext(mesh=mesh, rules=rules)
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Place ``x`` by logical axis names: a no-op without a context; a
    DTensor is redistributed to the rule's placements, a plain (rank-local)
    tensor comes back as it is."""
    ctx = current_context()
    if ctx is None:
        return x
    if x.ndim != len(axes):
        raise ValueError(f"shard(): tensor rank {x.ndim} != {len(axes)} axes")
    if isinstance(x, DTensor):
        return x.redistribute(ctx.mesh, placements_of(
            ctx.fitted(axes, x.shape), ctx.mesh))
    return x


def place(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``shard`` for a placement that is no site of the reference (a
    cache leaf put back by its rule after a write)."""
    return shard(x, *axes)


def on_mesh() -> bool:
    """True under a context whose mesh is a ``DeviceMesh`` (the model's
    DTensor program), False without one or on a shape-only mesh."""
    ctx = current_context()
    return ctx is not None and hasattr(ctx.mesh, "mesh_dim_names")


def replicated(t: torch.Tensor, mesh) -> torch.Tensor:
    """A rank-identical plain tensor as a replicated DTensor (no copy)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a value every rank builds the same (a mask, a bias, a zero
    carry), as a replicated DTensor on ``ref``'s mesh where ``ref`` is a
    DTensor; else ``t`` as it is. DTensor refuses a plain tensor beside a
    DTensor, so the model wraps each such value where it meets one."""
    if isinstance(ref, DTensor):
        return replicated(t, ref.device_mesh)
    return t


def _leaves(tree, axes, out: list) -> list:
    """(leaf, its axes) over ``tree`` (tensors, dicts and lists / tuples of
    them) against the same structure of ``axes`` (None: no axes)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _leaves(v, None if axes is None else axes[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _leaves(v, None if axes is None else axes[i], out)
    else:
        out.append((tree, axes))
    return out


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _axes_leaves(axes, out: list) -> list:
    """The leaves of an axes structure in ``_leaves``' order: a tuple of
    names (or None), a list of placements, or None is one leaf."""
    if isinstance(axes, dict):
        for v in axes.values():
            _axes_leaves(v, out)
    elif axes is None or isinstance(axes, list) or all(
            isinstance(e, (str, type(None))) for e in axes):
        out.append(axes)
    else:
        for v in axes:
            _axes_leaves(v, out)
    return out


def local_op(fn, in_axes: Sequence[Any], out_axes: Any):
    """``fn`` run on the local shards of its operands (module docstring).

    ``in_axes`` has one entry a positional argument: a tuple of logical
    axes for a tensor (a list of ``Placement``s: those placements as they
    are), a dict / list of them for a dict / list of tensors, None for a
    value passed as it is. ``out_axes`` mirrors ``fn``'s result the same
    way. A logical axis of an output is split as it was on the inputs
    that name it (``fit_spec`` decided there), else as the rule says."""
    def run(*args):
        ctx = current_context()
        if ctx is None:
            return fn(*args)
        leaves = _leaves(list(args), list(in_axes), [])
        if not any(isinstance(t, DTensor) for t, _ in leaves):
            return fn(*args)
        mesh = ctx.mesh
        decided: Dict[str, AxisVal] = {}

        def placement_for(axes, shape=None):
            if isinstance(axes, list):
                return tuple(axes)
            if shape is None:
                spec = resolve_spec([decided[a] if a in decided
                                     else ctx.resolve(a) for a in axes], mesh)
            else:
                spec = ctx.fitted(axes, shape)
                for a, e in zip(axes, spec):
                    if a is not None:
                        decided.setdefault(a, e)
            return tuple(placements_of(spec, mesh))

        vals, ins = [], []
        for t, ax in leaves:
            if ax is None or not isinstance(t, torch.Tensor):
                vals.append(t)
                ins.append(None)
            else:
                vals.append(replicated(t, mesh))
                ins.append(placement_for(ax, t.shape))
        result: list = []

        def flat_fn(*local_vals):
            out = fn(*_rebuild(list(args), iter(local_vals)))
            result.append(out)
            return tuple(t for t, _ in _leaves(out, None, []))

        out_pl = tuple(None if ax is None else placement_for(ax)
                       for ax in _axes_leaves(out_axes, []))
        # the work is split over a mesh dim that splits any operand: there
        # an operand replicated over it gets each rank's share of its
        # gradient, a partial sum; a partial operand (a linear op's) gets
        # the whole gradient on every rank
        split = [any(p is not None and isinstance(p[i], Shard)
                     for p in ins) for i in range(mesh.ndim)]
        grads = tuple(None if p is None else tuple(
            Partial() if split[i] and isinstance(q, Replicate) else
            Replicate() if isinstance(q, Partial) else q
            for i, q in enumerate(p)) for p in ins)
        flat_out = local_map(flat_fn, out_placements=out_pl,
                             in_placements=tuple(ins),
                             in_grad_placements=grads, device_mesh=mesh,
                             redistribute_inputs=True)(*vals)
        return _rebuild(result[0], iter(flat_out))

    return run


def row_placements(x: torch.Tensor) -> list:
    """Placements for an op over the last dim of ``x`` (a norm): x's own,
    its last dim whole and a partial sum reduced."""
    last = x.ndim - 1
    return [Replicate() if isinstance(p, Partial) or (
        isinstance(p, Shard) and p.dim in (last, -1)) else p
        for p in x.placements]


def replicate_all(mesh) -> list:
    return [Replicate()] * mesh.ndim


def local_update(fn, state: Dict, leaves: Dict, in_axes: Sequence[Any],
                 out_axes: Any, *args):
    """``fn(state, *args)``, which writes the leaves ``leaves`` (name ->
    logical axes) of the dict ``state`` in place, through ``local_op``:
    under a mesh it runs on the local shards of those leaves placed by
    their axes and of ``args`` (``in_axes``, ``out_axes`` as
    ``local_op``'s, for ``args`` and the result); each written leaf comes
    back placed by the cache rule of its name
    (``sharding.rules.cache_axes``), so a leaf that had to be gathered for
    the write is split again. Returns ``fn``'s result."""
    if not on_mesh():
        return fn(state, *args)
    from repro_torch.sharding.rules import cache_axes
    sub = {n: state[n] for n in leaves}

    def run(c, *a):
        c = dict(c)
        out = fn(c, *a)
        return out, {n: c[n] for n in leaves}

    out, new = local_op(run, [leaves] + list(in_axes),
                        (out_axes, leaves))(sub, *args)
    for n, t in new.items():
        state[n] = place(t, cache_axes(n, t.ndim))
    return out


def gather_fsdp(tree, skip: Sequence[str] = ()):
    """A parameter subtree with each DTensor leaf all-gathered over the
    data-parallel axes (module docstring); subtrees under a key of
    ``skip`` (the expert-parallel MoE weights) and plain leaves are kept.
    Without a context, the tree as it is."""
    ctx = current_context()
    if ctx is None:
        return tree
    names = list(axis_sizes(ctx.mesh))
    dp = {"pod", "data"}

    def one(x):
        if not isinstance(x, DTensor):
            return x
        pl = [Replicate() if names[i] in dp and isinstance(p, Shard) else p
              for i, p in enumerate(x.placements)]
        return x if tuple(pl) == tuple(x.placements) else \
            x.redistribute(x.device_mesh, pl)

    def walk(t):
        if isinstance(t, dict):
            return {k: (v if k in skip else walk(v)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return one(t)

    return walk(tree)
