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
and comes back as it is.

The rules read only ``mesh.shape`` as a map of axis name to size
(``axis_sizes``): a ``DeviceMesh`` or any object whose ``shape`` is that
map (the reference's tests' fake meshes).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

try:                                    # torch >= 2.5: public module
    from torch.distributed.tensor import DTensor, Replicate, Shard
except ImportError:                     # older torch
    from torch.distributed._tensor import DTensor, Replicate, Shard

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]

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


def current_context() -> Optional[ShardingContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: Dict[str, AxisVal]):
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
        return x.redistribute(ctx.mesh, ctx.placements(axes))
    return x
