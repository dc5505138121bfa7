"""Async streaming front door for the serving engine (the port of
``repro.serving.server``).

The engines below this module are synchronous quantum loops: ``run()``
drains a pre-loaded queue. A real serving deployment is open-loop —
requests arrive while earlier ones decode, clients want tokens as they
are produced, and the operator wants the engine's robustness machinery
(priority preemption, deadline cancellation, overload shedding, fault
backoff) exercised against live traffic. ``AsyncServingServer`` provides
that surface with plain ``asyncio`` (no extra dependencies):

  * ``submit(req)``   — validate + enqueue; malformed requests raise
                        immediately, shed requests finish with reason
                        ``"shed"`` before a single quantum runs.
  * ``stream(rid)``   — async iterator of the request's tokens as the
                        drive loop produces them (true streaming: tokens
                        surface at every quantum boundary, not at the
                        end).
  * ``result(rid)``   — await the finished (or cancelled/stranded)
                        Response.
  * ``drain()``       — await the drive loop going idle.

One background task drives ``engine.step()`` — one scheduling quantum at
a time — through ``run_in_executor`` so the event loop stays responsive
during device work. An ``asyncio.Lock`` serializes every engine touch:
submissions interleave BETWEEN quanta, exactly the continuous-batching
contract the engine's admission pass was built for. The drive loop applies
the same stall policy as ``engine.run()`` (spill preemption pins, then
reject a head that can never fit) and the same ``max_steps`` timeout
marking, so server-driven and ``run()``-driven executions of the same
traffic are step-for-step identical.

A ``FaultError`` escaping the engine (a fault site exhausted its retry
budget) stops the drive loop, marks every unfinished response with
reason ``"error"``, ends all streams, and re-raises from ``result()`` /
``drain()`` — a wedged engine fails loudly, it never hangs clients.

Shard loss is NOT an error at this layer: when the fleet's health
watchdog turns a retry-exhausted launch site into a shard-down
declaration, the fleet evacuates its in-flight work onto the survivors
and keeps serving, so the server sees an ordinary (if slower) quantum.
Only a fault the watchdog cannot localize, or the loss of the last live
shard, still surfaces here as ``FaultError``.

On the card, ``engine.step()`` runs on the executor's worker thread: its
kernels launch on that thread's current stream (the default stream, as
the event loop's thread would use), the engine's ``torch.Generator`` is
touched only there, under the lock, and a kernel library built on first
use from that thread is built once (``kernels/build.library`` holds a
lock).
"""
from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict, List, Optional

from repro_torch.serving.faults import FaultError
from repro_torch.serving.request import Request, Response

_END = object()                        # per-stream end-of-tokens sentinel


class AsyncServingServer:
    """Wrap a ``ServingEngine`` or ``ShardedServingEngine`` (anything with
    ``submit``/``step``/``queue``/``active``/``decoding``/``deferred``/
    ``responses`` and the stall/fault/deferral helpers) behind an asyncio
    streaming API. Deferred (low-CI-window) work keeps the drive loop
    alive: when ONLY parked requests remain it moves the virtual clock to
    the release window instead of going idle, so a client awaiting a
    deferred result never hangs."""

    def __init__(self, engine, max_steps: int = 100_000):
        self.engine = engine
        self.max_steps = max_steps
        self._lock = asyncio.Lock()            # serializes engine access
        self._streams: Dict[int, asyncio.Queue] = {}
        self._sent: Dict[int, int] = {}        # tokens already streamed
        self._ended: Dict[int, bool] = {}      # sentinel already pushed
        self._finished: Dict[int, asyncio.Event] = {}
        self._drive_task: Optional[asyncio.Task] = None
        self.error: Optional[BaseException] = None

    # ------------------------------------------------------------ lifecycle
    async def submit(self, req: Request) -> int:
        """Validate and enqueue ``req``; returns its rid. ValueError from
        engine validation propagates to the caller immediately. A request
        shed at admission (bounded queue) gets its stream/result resolved
        right here — clients never wait on work the engine refused."""
        if self.error is not None:
            raise self.error
        async with self._lock:
            self.engine.submit(req)            # may raise ValueError
            self._streams[req.rid] = asyncio.Queue()
            self._sent[req.rid] = 0
            self._ended[req.rid] = False
            self._finished[req.rid] = asyncio.Event()
            self._pump()                       # shed -> resolve immediately
            self._ensure_drive_task()
        return req.rid

    async def stream(self, rid: int) -> AsyncIterator[int]:
        """Yield ``rid``'s tokens as the engine produces them; returns
        when the request finishes (any reason) or the server errors."""
        q = self._streams[rid]
        while True:
            tok = await q.get()
            if tok is _END:
                if self.error is not None:
                    raise self.error
                return
            yield tok

    async def result(self, rid: int) -> Response:
        """Await the request's terminal Response (finished, shed,
        cancelled, or stranded-by-timeout)."""
        await self._finished[rid].wait()
        if self.error is not None:
            raise self.error
        return self.engine.responses[rid]

    async def drain(self) -> None:
        """Await the drive loop going idle (all submitted work terminal);
        re-raises a FaultError that stopped it."""
        while self._drive_task is not None and not self._drive_task.done():
            await self._drive_task             # surfaces FaultError etc.

    def stats(self) -> Dict[str, float]:
        return self.engine.stats()

    # ----------------------------------------------------------- drive loop
    def _ensure_drive_task(self) -> None:
        if self._drive_task is None or self._drive_task.done():
            self._drive_task = asyncio.get_running_loop().create_task(
                self._drive())

    async def _drive(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                async with self._lock:
                    eng = self.engine
                    if not (eng.queue or eng.active or eng.deferred
                            or eng._faults_pending()):
                        self._pump()
                        return         # idle; next submit restarts us
                    if eng._steps >= self.max_steps:
                        for r in eng.responses.values():
                            if not r.finished:
                                r.finish_reason = "timeout"
                        self._pump()
                        return
                    # one scheduling quantum off the event loop; the lock
                    # holds so submissions land BETWEEN quanta
                    progressed = await loop.run_in_executor(
                        None, eng.step, self.max_steps)
                    if (not progressed and not eng.decoding
                            and not eng._faults_pending()):
                        if eng.queue:
                            eng._resolve_stall()
                        elif eng.deferred:
                            # only parked work remains: move the virtual
                            # clock to the greenest window and release
                            eng._fast_forward_deferred()
                    self._pump()
                # cooperative point: queued submit()s take the lock here
                await asyncio.sleep(0)
        except FaultError as e:
            self.error = e
            for r in self.engine.responses.values():
                if not r.finished:
                    r.finish_reason = "error"
            self._pump(force_end=True)
            raise

    # ------------------------------------------------------------ streaming
    def _pump(self, force_end: bool = False) -> None:
        """Push newly produced tokens into every stream and close streams
        whose requests reached a terminal state. Called with the lock held
        (or during error teardown)."""
        for rid, q in self._streams.items():
            resp = self.engine.responses.get(rid)
            if resp is None or self._ended[rid]:
                continue
            sent = self._sent[rid]
            for tok in resp.tokens[sent:]:
                q.put_nowait(tok)
            self._sent[rid] = len(resp.tokens)
            terminal = (resp.finished or force_end
                        or resp.finish_reason in ("timeout", "error"))
            if terminal:
                self._ended[rid] = True
                q.put_nowait(_END)
                self._finished[rid].set()
