"""Production and test meshes (the port of ``repro.launch.mesh``).

Each mesh is ``init_device_mesh`` over the process group that is up:
gloo on the CPU, NCCL on the card, the ``fake`` group for the dry-run
(``fake_group``). Functions, not module constants: importing this module
starts no group.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape, axes):
    """A mesh of ``shape`` named ``axes`` over the whole process group."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group is up: call torch.distributed."
            "init_process_group (gloo on the CPU, nccl on the card) or "
            "enter launch.mesh.fake_group(n) first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs a world of {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; 2x16x16 = 512 chips across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False):
    """Small mesh for the CPU tests (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_serving_mesh(n_shards: int):
    """1-D data-parallel mesh for the mesh-sharded serving fleet: each
    shard owns a full model replica plus its own slot pool, page pool and
    free stack, so the only mesh axis is the fleet axis."""
    have = dist.get_world_size() if dist.is_initialized() else 0
    if n_shards > have:
        raise ValueError(
            f"serving mesh needs {n_shards} ranks, the process group has "
            f"{have} (start torch.distributed with world_size={n_shards}: "
            "one rank a card over nccl, or gloo ranks on the CPU)")
    return make_mesh((n_shards,), ("data",))


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks in this process,
    as rank 0: collectives dispatch and are counted but move nothing (the
    dry-run's meta tensors hold no data). Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        forget_groups()


def forget_groups() -> None:
    """Clear DTensor's sharding-propagation caches. Call it after a group
    is destroyed: they are keyed by meshes equal by shape and names, not by
    process group, so a later group's mesh of the same shape would be
    handed the dead group's collectives."""
    import torch
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                 # older torch
        from torch.distributed._tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
        cache = getattr(prop, name, None)
        if hasattr(cache, "cache_clear"):
            cache.cache_clear()
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)
    if clear is not None:
        clear()
