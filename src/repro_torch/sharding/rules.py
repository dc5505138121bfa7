"""Parameter / activation placement rules for the production meshes (the
port of ``repro.sharding.rules``).

The rule tables and the per-leaf rule (``spec_for_param``: a name-based
override table for the expert-parallel MoE weights and the small
recurrent tensors, else shard the largest dim divisible by the tensor
axis over ``model`` and, under FSDP, the largest remaining divisible dim
over the data axes) are the reference's, unchanged: pure functions of a
leaf name, a shape and ``mesh.shape``.

One structural difference. The reference stacks the layers of its
repeated unit (and an encoder's) on a leading scan axis, one tensor for
all of them; the port holds a tensor a layer (``convert.params_from_jax``).
``param_spec`` gives each port leaf the reference's spec of the stacked
tensor it is a slice of, minus the scan axis. Where the reference puts a
mesh axis on the scan axis itself (on 16x16 under FSDP, the (L, d) norm
scales of ``llama3.2-1b`` and ``internlm2-20b``, whose L divides 16), the
port's per-layer leaf cannot follow, and that axis replicates it.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

from repro_torch.sharding.api import (AxisVal, ShardingContext, Spec,
                                      axis_sizes, placements_of)

try:                                    # torch >= 2.5: public module
    from torch.distributed.tensor import distribute_tensor
except ImportError:                     # older torch
    from torch.distributed._tensor import distribute_tensor

# --- activation rules ------------------------------------------------------

DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "experts": ("data", "model"),
    "expert_flat": ("data", "model"),  # (E*C, d) dispatch buffers / sorted ids
    "tokens": ("pod", "data"),         # flattened (B*S, d) token tables
    "vocab": "model",
    "embed": None,
    "state": None,
    "frames": None,
}

# long-context decode (global_batch=1): batch cannot shard; shard the KV/seq
# dimension over the data axes instead (context parallelism).
LONG_CONTEXT_RULES: Dict[str, AxisVal] = dict(
    DEFAULT_RULES,
    batch=None,
    kv_seq=("pod", "data"),
    seq=("pod", "data"),
)

# --- parameter rules -------------------------------------------------------

# leaf-name overrides: dims where the shape heuristic would pick wrong.
# Value: tuple of logical roles per (trailing) dim; "tensor" -> model axis,
# "fsdp" -> data axes when FSDP is on, "expert" -> the combined
# (data, model) axes = full expert parallelism (each chip owns whole
# experts; no weight gather, tokens move via all-to-all), None -> replicated.
PARAM_OVERRIDES: Dict[str, Tuple[Optional[str], ...]] = {
    # MoE expert weights: expert-parallel (ea) x ffn-sharded (fa); see
    # expert_axes() and repro_torch.models.moe_sharded
    "experts_gate": ("expert", None, "expert_ffn"),
    "experts_up": ("expert", None, "expert_ffn"),
    "experts_down": ("expert", "expert_ffn", None),
    "router": (None, None),            # (d, E): replicate (small, latency)
    # mamba/rwkv small tensors: replicate
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
    "conv_w": (None, None), "conv_b": (None,),
    "u": (None, None), "w0": (None,),
    "mix_base": (None, None), "mix_x": (None,),
}


def expert_axes(E: int, mesh):
    """(ea, fa): expert-dim axes and ffn-dim axes for expert-parallel MoE.

    Largest (data, model) subset whose size divides E shards the expert dim;
    the remaining axes shard d_ff. Pure 256-way EP for E=256; 16x16
    expert x ffn hybrid for E=128.
    """
    sizes = axis_sizes(mesh)
    have = [a for a in ("data", "model") if a in sizes]
    best = ((), tuple(have))
    best_size = 1
    for mask in range(1, 2 ** len(have)):
        ea = tuple(a for i, a in enumerate(have) if mask >> i & 1)
        size = 1
        for a in ea:
            size *= sizes[a]
        if E % size == 0 and size > best_size:
            best_size = size
            best = (ea, tuple(a for a in have if a not in ea))
    return best


def _axes_size(sizes: Dict[str, int], axes: AxisVal) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def spec_for_param(path: str, shape: Tuple[int, ...], mesh,
                   fsdp: bool = False) -> Spec:
    """The reference's spec of one parameter leaf, as a tuple of per-dim
    entries (``PartitionSpec``'s; ``()`` where it returns ``P()``)."""
    sizes = axis_sizes(mesh)
    names = [p for p in path.split("/") if p]
    leaf = names[-1] if names else ""
    tensor_axis = "model" if "model" in sizes else None
    fsdp_axes: AxisVal = tuple(a for a in ("pod", "data") if a in sizes)
    if not fsdp_axes:
        fsdp = False

    if leaf in PARAM_OVERRIDES:
        roles = PARAM_OVERRIDES[leaf]
        spec: list = [None] * len(shape)
        # roles align to trailing dims (stacked-scan leading dim replicated)
        off = len(shape) - len(roles)
        if off < 0:
            return ()
        for i, role in enumerate(roles):
            dim = off + i
            if role == "tensor" and tensor_axis and \
                    shape[dim] % sizes[tensor_axis] == 0:
                spec[dim] = tensor_axis
            elif role == "fsdp" and fsdp and \
                    shape[dim] % _axes_size(sizes, fsdp_axes) == 0:
                spec[dim] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
            elif role in ("expert", "expert_ffn"):
                E = shape[off]          # expert count is the first role dim
                ea, fa = expert_axes(E, mesh)
                axes = ea if role == "expert" else fa
                if axes:
                    spec[dim] = axes if len(axes) > 1 else axes[0]
        return tuple(spec)

    if len(shape) < 2 or tensor_axis is None:
        return ()
    # shape heuristic: biggest divisible dim -> model; next -> fsdp
    spec = [None] * len(shape)
    tsize = sizes[tensor_axis]
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    tdim = next((i for i in order
                 if shape[i] % tsize == 0 and shape[i] >= tsize), None)
    if tdim is not None:
        spec[tdim] = tensor_axis
    if fsdp:
        fsize = _axes_size(sizes, fsdp_axes)
        fdim = next((i for i in order
                     if i != tdim and shape[i] % fsize == 0
                     and shape[i] >= fsize), None)
        if fdim is not None:
            spec[fdim] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return tuple(spec)


def full_spec(spec: Spec, ndim: int) -> Spec:
    """``spec`` with a None for each trailing dim it leaves out."""
    return tuple(spec) + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=64)
def _grouping(cfg):
    return cfg.grouping()          # a search over the pattern: kept per cfg


def scan_length(cfg, path: Tuple[str, ...]) -> int:
    """Length of the reference's leading scan axis over the stacked tensor
    this port leaf (``path`` of keys) is one layer of; 0 where the
    reference holds it unstacked (the prefix layers, the weight-shared
    block, everything outside the layers)."""
    if path[0] == "encoder":
        return cfg.n_encoder_layers
    if path[0] != "layers":
        return 0
    prefix, unit, repeats = _grouping(cfg)
    i = int(path[1]) - len(prefix)
    if i < 0 or unit[i % len(unit)] == "shared":
        return 0
    return repeats


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = (),
                       memo: Optional[dict] = None):
    """``fn(path, leaf)`` over a tree of dicts and lists; a leaf object met
    at several paths (Zamba2's shared block) maps once, at its first."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),), memo)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),), memo)
                          for i, v in enumerate(tree))
    if id(tree) not in memo:
        memo[id(tree)] = fn(path, tree)
    return memo[id(tree)]


def param_spec(cfg, path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               fsdp: bool = False) -> Spec:
    """The spec of one port leaf: the reference's spec of its stacked
    tensor, the scan axis dropped (module docstring)."""
    L = scan_length(cfg, path)
    name = "/".join(path)
    if not L:
        return full_spec(spec_for_param(name, shape, mesh, fsdp), len(shape))
    stacked = (L,) + tuple(shape)
    return full_spec(spec_for_param(name, stacked, mesh, fsdp),
                     len(stacked))[1:]


def param_shardings(cfg, params, mesh, fsdp: bool = False):
    """Tree of DTensor placements matching ``params``."""
    return tree_map_with_path(
        lambda p, x: placements_of(
            param_spec(cfg, p, tuple(x.shape), mesh, fsdp), mesh), params)


def distribute_params(cfg, params, mesh, fsdp: bool = False,
                      src_data_rank: Optional[int] = 0):
    """``params`` as DTensors on ``mesh`` (a ``DeviceMesh``), each leaf
    placed by ``param_shardings`` with ``distribute_tensor``; a leaf shared
    by several layers stays one DTensor. ``src_data_rank``: the rank whose
    tensors are sent (``distribute_tensor``'s); None: every rank holds the
    same tensors (one seed) and keeps its own shard, sending nothing."""
    return tree_map_with_path(
        lambda p, x: distribute_tensor(x, mesh, placements_of(
            param_spec(cfg, p, tuple(x.shape), mesh, fsdp), mesh),
            src_data_rank=src_data_rank), params)


FSDP_RULES = DEFAULT_RULES  # activations are unchanged under FSDP

# --------------------------------------------------------------------------
# cache placements by leaf name (the dry-run's argument bytes and the
# model's caches under a mesh)
# --------------------------------------------------------------------------

CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "xk": ("batch", None, "kv_heads", None),
    "xv": ("batch", None, "kv_heads", None),
    "ckv": ("batch", "kv_seq", None),
    "k_rope": ("batch", "kv_seq", None),
    "pos_ids": ("batch", "kv_seq"),
    "length": ("batch",),
    "t": ("batch",),
    "conv": ("batch", None, None),
    "state": ("batch", "heads", None, None),
    "wkv": ("batch", "heads", None, None),
    "att_shift": ("batch", None),
    "ffn_shift": ("batch", None),
}


def cache_axes(name: str, ndim: int):
    """Logical axes of a cache leaf by its name (replicated if unknown)."""
    axes = CACHE_AXES.get(name)
    if axes is None:
        return [None] * ndim
    lead = ndim - len(axes)
    if lead < 0:                      # scalar-ish leaf
        return list(axes[-ndim:]) if ndim else []
    return [None] * lead + list(axes)


def distribute_cache(caches, mesh, rules):
    """A cache tree (``Model.init_cache``) as DTensors on ``mesh``, each
    leaf placed by its name's logical axes (``cache_axes``) under
    ``rules``, a dim split only where its axes divide it
    (``sharding.api.fit_spec``). Every rank holds the same fresh state,
    so each keeps its own shard and nothing is sent."""
    ctx = ShardingContext(mesh=mesh, rules=rules)

    def one(path, x):
        if x is None:
            return None
        spec = ctx.fitted(cache_axes(path[-1], x.ndim), x.shape)
        return distribute_tensor(x, mesh, placements_of(spec, mesh),
                                 src_data_rank=None)
    return tree_map_with_path(one, caches)

# --- serving rules ---------------------------------------------------------

# Mesh-sharded serving: every leaf of the fleet's shard-stacked state
# (``ShardedServingEngine.stacked_state``) has a LEADING fleet axis named
# "shard", mapped onto the 1-D serving mesh's data axis; all other dims are
# shard-local (a shard owns whole page pools and whole KV heads, and its
# allocator's free stack stays device-local).
SERVING_RULES: Dict[str, AxisVal] = {"shard": "data"}


def serving_cache_axes(leaf) -> Tuple[Optional[str], ...]:
    """Logical axes of one leaf of a shard-stacked serving state tree: the
    leading axis is the fleet axis, every other dim shard-local (the
    reference's ``models.attention.serving_cache_axes``)."""
    return ("shard",) + (None,) * (leaf.ndim - 1)


def serving_shardings(mesh, tree):
    """DTensor placements for a shard-stacked serving state tree, each leaf
    resolved through SERVING_RULES."""
    ctx = ShardingContext(mesh=mesh, rules=SERVING_RULES)
    return tree_map_with_path(
        lambda p, x: ctx.placements(serving_cache_axes(x)), tree)
