"""The fused decode step as one device program: the port of the
reference's module-level ``_FUSED_STEPS = jax.jit(
sampling.fused_decode_steps, static_argnums=(0,), static_argnames=(
"n_steps", "temperature", "page_size", "freeze_inactive"))``.

``DecodeGraphs.step`` runs ``sampling.fused_decode_steps`` for an
engine. On the card it captures one ``torch.cuda.CUDAGraph`` for each
static key (``n_steps``, ``temperature``, ``page_size``,
``freeze_inactive``), as ``jax.jit`` compiles one program for each, the
first time the key occurs, and replays it for every decode chunk of that
key: a chunk is one graph launch instead of one host dispatch per op of
every layer of every micro-step. ``temperature`` is read as a Python
float in the step (``sampling.sample``), so the key holds its value. The
engine's shapes are fixed, so they need no key. All of an engine's
graphs share one memory pool (``torch.cuda.graph_pool_handle``), and
every capture runs on one side stream a device; an engine's graphs run
one at a time, each chunk reading its outputs before the next replay.

A graph reads and writes fixed addresses, so every tensor the step
touches must hold the engine's current value there at each replay:

* the caches' leaves, ``cur_tokens`` and the slot state are written in
  place by the model, the step and the host's ops between chunks; a
  replay checks that each still lies where it was captured, and raises
  if one was rebound;
* the paged allocator (``tbl``, ``free``, ``top``, ``ref``: kilobytes)
  is rebound by the host's pure allocator ops between chunks (release,
  decref, chunk pages, quarantine, migration), so the step runs on fixed
  buffers of its own: the engine's allocator is copied into them before
  the chunk, and copies of them become the engine's allocator after it.

Nothing is warmed up eagerly: a capture runs the step's Python once and
launches nothing, so the first chunk of a key replays like every other,
and the caches, tokens, budgets and generator advance exactly as the
eager step advances them. At ``temperature > 0`` the engine's generator
is registered with the graph, so each replay draws from the generator's
current offset and advances it, as the eager step does. A capture counts
its kernel launches apart (``ops.recorded_launches``) and each replay
adds them (``ops.add_launches``), so ``ops.launch_counts`` stays a true
count.

On the CPU the same wrapper runs the same Python body on the same fixed
buffers, with no capture and no replay (a plain call, as ``jax.jit``
always compiles where this port never captures)."""
from __future__ import annotations

import functools
import gc
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.serving import sampling


def _tensors(tree):
    """The tensor leaves of a cache tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream a device for every capture: each stream that runs a
    matmul keeps a cuBLAS workspace for the rest of the process."""
    return torch.cuda.Stream(device)


class _Graph:
    """One captured step: the graph, its outputs (in the graph's pool,
    overwritten by the next replay) and the addresses it reads."""

    def __init__(self, graph, out, addresses):
        self.graph = graph
        self.out = out
        self.addresses = addresses


class DecodeGraphs:
    """One engine's fused decode step: captured graphs by static key on
    the card, the plain call on the CPU. ``cur_tokens``, ``state`` and
    ``generator`` are the engine's own (updated in place); the caches
    tree is passed at each step, since the engine rebinds its allocator.

    Counters: ``captured`` graphs (one a key in ``launches``: key -> the
    kernel launches of one replay), ``replays``, ``capture_s`` (host
    seconds spent capturing), ``upload_s`` (host seconds of each graph's
    first replay, which uploads it to the card), ``replay_host_s`` (host
    seconds of the later replays: the launch of the graph, not its
    run)."""

    def __init__(self, model, params, cur_tokens: torch.Tensor,
                 state: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]):
        self.model = model
        self.params = params
        self.cur_tokens = cur_tokens
        self.state = state
        self.generator = generator
        self.on_card = cur_tokens.device.type == "cuda"
        self._alloc: Optional[Dict[str, torch.Tensor]] = None
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self.replays = 0
        self.capture_s = 0.0
        self.upload_s = 0.0
        self.replay_host_s = 0.0
        self.launches: Dict[tuple, Dict[str, int]] = {}

    @property
    def captured(self) -> int:
        return len(self._graphs)

    def step(self, caches: Dict, n_steps: int, temperature: float,
             page_size: int = 0, freeze_inactive: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sampling.fused_decode_steps`` on ``caches``: the same
        arguments and effects. ``caches["paged"]``, if any, is replaced by
        the step's new allocator; every other leaf is updated in place.
        The returned (tok_mat, emit_mat) are the graph's outputs on the
        card, valid until the next step."""
        alloc = caches.get("paged")
        tree = caches
        if alloc is not None:
            if self._alloc is None:
                self._alloc = {k: torch.empty_like(v)
                               for k, v in alloc.items()}
            for k, buf in self._alloc.items():
                buf.copy_(alloc[k])
            tree = dict(caches, paged=self._alloc)
        key = (n_steps, float(temperature), page_size, bool(freeze_inactive))
        out = (self._replay(tree, key) if self.on_card
               else self._call(tree, key))
        if alloc is not None:
            caches["paged"] = {k: v.clone() for k, v in self._alloc.items()}
        return out

    def _call(self, tree, key) -> Tuple[torch.Tensor, torch.Tensor]:
        n_steps, temperature, page_size, freeze_inactive = key
        return sampling.fused_decode_steps(
            self.model, self.params, tree, self.cur_tokens, self.state,
            self.generator, n_steps=n_steps, temperature=temperature,
            page_size=page_size, freeze_inactive=freeze_inactive)

    def _addresses(self, tree) -> tuple:
        leaves = list(_tensors(tree)) + [self.cur_tokens] + list(
            _tensors(self.state))
        return tuple(t.data_ptr() for t in leaves)

    def _replay(self, tree, key) -> Tuple[torch.Tensor, torch.Tensor]:
        g = self._graphs.get(key)
        first = g is None
        if first:
            g = self._graphs[key] = self._capture(tree, key)
        elif self._addresses(tree) != g.addresses:
            raise RuntimeError(
                "fused decode step: a tensor of the caches, cur_tokens or "
                "the slot state moved since its graph was captured; the "
                "engine must write them in place")
        t0 = time.perf_counter()
        g.graph.replay()
        ops.add_launches(self.launches[key])
        if first:
            self.upload_s += time.perf_counter() - t0
        else:
            self.replay_host_s += time.perf_counter() - t0
        self.replays += 1
        return g.out

    def _capture(self, tree, key) -> _Graph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream = _capture_stream(self.cur_tokens.device)
        graph = torch.cuda.CUDAGraph()
        if key[1] > 0:               # temperature: the step samples
            graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        # an unreachable graph destroyed by the collector inside a capture
        # would invalidate it: collect first, and not at all within
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        stream.wait_stream(torch.cuda.current_stream())
        try:
            with ops.recorded_launches() as launches, \
                    torch.cuda.stream(stream):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self._call(tree, key)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass           # the capture was already invalid
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream().wait_stream(stream)
        self.capture_s += time.perf_counter() - t0
        self.launches[key] = launches
        return _Graph(graph, out, self._addresses(tree))
