"""Operation-level cost of one eager step (the port's counterpart of
``repro.launch.hlo_cost``, which reads the compiled HLO; the port has no
HLO, so this counts the ops PyTorch dispatches).

Inside ``OpCounter`` every op that reaches the dispatcher is counted:

  * FLOPs: ``torch.utils.flop_counter``'s registry (matrix products,
    convolutions, attention; elementwise FLOPs are ignored, as the
    reference ignores them);
  * bytes accessed: each op's tensor inputs and outputs, once each, as
    XLA's "bytes accessed" counts an op; views move nothing and are
    skipped (the reference's ``_SKIP_BYTES_OPS``), as are allocations
    that touch no memory (``empty``);
  * collectives: counts by op and per-chip wire bytes, the bytes one
    rank sends over a ring of the op's n ranks: the whole buffer's bytes
    (an all-gather's output, a reduce-scatter's input, an all-reduce's or
    all-to-all's buffer) times (n - 1) / n, times the reference's
    ``WIRE_FACTOR`` (all-reduce 2x: a reduce-scatter then an all-gather);
    a send moves its buffer. Split into intra-pod (ICI) and pod-crossing
    (DCN) bytes by the ranks of the op's group (``pod_size`` ranks a pod).

An eager program runs each loop iteration, so a scan of n bodies counts n
times with no trip-count reading. Run on ``meta`` tensors, nothing is
allocated or computed: the shapes are the real ones.

On DTensors the counter sees what one rank runs: it hands a DTensor op
to DTensor (``NotImplemented``), which runs the op's local form on the
rank's shards and the collectives its redistributions issue, and those
come back through the counter. So FLOPs and bytes are one rank's, and
every collective is counted, whether a ``shard()`` site, a kernel's
``local_op`` or DTensor's own sharding propagation issued it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

try:                                    # torch >= 2.5: public module
    from torch.distributed.tensor import DTensor
except ImportError:                     # older torch
    from torch.distributed._tensor import DTensor

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# torch dtypes under the reference's (HLO) names
DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}
for _name, _hlo in (("uint16", "u16"), ("uint32", "u32"), ("uint64", "u64")):
    if hasattr(torch, _name):
        DTYPE_NAMES[getattr(torch, _name)] = _hlo

WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

# dispatched collective ops (c10d's and the functional ones) -> HLO name
COLLECTIVES = {
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "_allgather_base_": "all-gather", "all_gather_into_tensor": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "send": "collective-permute",
}

# allocations that read and write nothing
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh"}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES[DTYPE_NAMES[t.dtype]]


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _group_ranks(args) -> List[int]:
    for a in tree_flatten(list(args))[0]:
        if isinstance(a, torch.ScriptObject):
            pg = torch._C._distributed_c10d.ProcessGroup.unbox(a)
            return dist.get_process_group_ranks(pg)
        if isinstance(a, str):            # a functional op's group name
            try:
                pg = dist.distributed_c10d._resolve_process_group(a)
            except (KeyError, RuntimeError, ValueError):
                continue
            return dist.get_process_group_ranks(pg)
    return []


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_wire: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    ici_bytes: float = 0.0
    dcn_bytes: float = 0.0

    def scaled(self, n: float) -> "OpCost":
        """This cost counted ``n`` times."""
        return OpCost(self.flops * n, self.bytes * n,
                      {k: v * n for k, v in self.collective_wire.items()},
                      {k: int(v * n)
                       for k, v in self.collective_counts.items()},
                      self.ici_bytes * n, self.dcn_bytes * n)


# DTensor's shape inference (a private method of its sharding
# propagator: the counts can move with DTensor's version, which each
# dry-run record states)
_INFER = "_propagate_tensor_meta_non_cached"


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside the ``with`` block (``.cost``).

    DTensor infers an op's output shape by running it on global-shape
    tensors once a new signature (its sharding propagation); those runs
    compute nothing on the device and are not counted (``paused``).
    Counters nest."""

    def __init__(self, pod_size: int = 0):
        super().__init__()
        self.pod_size = pod_size
        self.cost = OpCost()
        self.paused = 0

    def __enter__(self):
        prop = DTensor._op_dispatcher.sharding_propagator
        # the instance's own entry (an enclosing counter's), else None:
        # put back on exit, so counters nest
        self._prop, self._outer = prop, vars(prop).get(_INFER)
        infer = getattr(prop, _INFER)

        def uncounted(*args, **kwargs):
            self.paused += 1
            try:
                return infer(*args, **kwargs)
            finally:
                self.paused -= 1
        setattr(prop, _INFER, uncounted)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._outer is None:
            delattr(self._prop, _INFER)           # the class's again
        else:
            setattr(self._prop, _INFER, self._outer)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        c = self.cost
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        name = packet.__name__
        coll = COLLECTIVES.get(name)
        if coll is not None:
            # the op's result: c10d's in-place ops write their first
            # argument, the functional ones return it
            res = args[0] if func.namespace == "c10d" else out
            ranks = _group_ranks(args)
            n = max(len(ranks), 1)
            b = sum(tensor_bytes(t) for t in _tensors(res))
            if coll == "reduce-scatter":
                b *= n                  # the input: n outputs
            if coll != "collective-permute":
                b *= WIRE_FACTOR[coll] * (n - 1) / n
            c.collective_wire[coll] = c.collective_wire.get(coll, 0.0) + b
            c.collective_counts[coll] = c.collective_counts.get(coll, 0) + 1
            if self.pod_size and len({r // self.pod_size
                                      for r in ranks}) > 1:
                c.dcn_bytes += b
            else:
                c.ici_bytes += b
        if not func.is_view and name not in _NO_BYTES:
            c.bytes += sum(tensor_bytes(t)
                           for t in _tensors((args, kwargs, out)))
        return out
