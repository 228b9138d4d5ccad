"""Async serving front end over the synchronous ``ServingEngine`` —
counterpart of the JAX package's ``serving/async_runtime.py``.

Everything below the queue is the existing engine, untouched: one host
thread, slot-level continuous batching, the controller's migration
loop.  This module adds the *serving* shape production traffic needs —
admission, streaming, backpressure, drain — as cooperatively-scheduled
asyncio workers (the maxtext JetThread/queue-overlap pattern, expressed
as coroutines because the engine is single-host and not thread-safe):

``admission worker``   pops the bounded inbox and feeds the engine's
    FIFO (``engine.submit``) — prompts land in the engine queue while
    the decode worker is mid-step, so chunked prefill of the next
    request overlaps the current batch's decode at the scheduler level.
``decode worker``      drives ``engine.step()``: with ``pipeline_k=K``
    each step advances one in-flight group, so K tokens stay in flight
    across layer-disjoint stages exactly as in the synchronous engine.
``watchdog``           sweeps a ``HeartbeatMonitor`` over the workers;
    a hung worker (no heartbeat past the timeout) is detected, logged
    once into the monitor's event log, zeroed in ``availability`` and
    escalated to a controller replan.

Per-request streaming rides the engine's ``token_sink`` hook: every
generated token is routed to its request's ``AsyncRequestHandle``, an
async generator the caller iterates while other requests decode.

Backpressure is a TYPED reject at submit time (``QueueFullError``) when
the bounded inbox is full — load shedding happens at admission, never
mid-stream.

Determinism: the inbox is FIFO and admission is atomic (no await between
dequeue and ``engine.submit``), so the engine sees the same request
order as a synchronous caller issuing the same ``submit`` sequence — and
because greedy decode is per-slot independent, the async per-request
token streams are BIT-IDENTICAL to the synchronous engine's
(``tests/test_torch_async.py`` holds this on dense and paged engines).

    eng = ServingEngine(cfg, n_slots=4, paged=True)
    async with AsyncServingEngine(eng, queue_limit=64) as rt:
        h = rt.submit(prompt, max_new_tokens=32)
        async for tok in h.stream():
            ...
        await rt.drain()        # graceful: every accepted request done
"""
from __future__ import annotations

import asyncio
import collections
import time
from typing import AsyncIterator, Deque, Dict, List, Optional

import numpy as np

from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.serving.engine import Request, ServingEngine


class QueueFullError(RuntimeError):
    """Typed backpressure signal: the bounded admission queue is full.
    The caller sheds or retries; nothing was enqueued."""


_END = object()          # stream sentinel: the engine retired the request


class AsyncRequestHandle:
    """One submitted request: an async token stream plus completion
    bookkeeping.  ``tokens`` accumulates the full output (so ``result``
    and ``stream`` compose); wall-clock ``t_submit/t_first/t_done`` give
    the async bench its TTFT samples."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int):
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new_tokens = int(max_new_tokens)
        self.rid: Optional[int] = None        # engine id, set at admission
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self._q: asyncio.Queue = asyncio.Queue()
        self._finished = asyncio.Event()

    async def stream(self) -> AsyncIterator[int]:
        """Yield this request's tokens as the engine generates them; the
        generator ends when the engine retires the request.  Raises the
        admission error, if any, instead of silently ending empty."""
        while True:
            item = await self._q.get()
            if item is _END:
                if self.error is not None:
                    raise self.error
                return
            yield item

    async def result(self) -> List[int]:
        """Await completion and return the full output stream."""
        await self._finished.wait()
        if self.error is not None:
            raise self.error
        return self.tokens


class AsyncServingEngine:
    """Bounded-queue async runtime over one ``ServingEngine`` (wave
    engines have no incremental scheduler to drive).  Single event loop,
    three tasks; see the module docstring for the worker split."""

    ADMISSION, DECODE = 0, 1          # worker ids in the heartbeat monitor

    def __init__(self, engine: ServingEngine, *, queue_limit: int = 64,
                 heartbeat_timeout: float = 30.0,
                 idle_poll_s: float = 0.02,
                 heartbeat_clock=None,
                 escalate_hangs: bool = True):
        if not isinstance(engine, ServingEngine):
            raise TypeError("AsyncServingEngine drives the slot-level "
                            "ServingEngine (continuous batching); got "
                            f"{type(engine).__name__}")
        if engine.token_sink is not None:
            raise ValueError("engine already has a token_sink installed")
        self.engine = engine
        engine.token_sink = self._route
        self.queue_limit = int(queue_limit)
        self._inbox: Deque[AsyncRequestHandle] = collections.deque()
        self._handles: Dict[int, AsyncRequestHandle] = {}
        kw = {} if heartbeat_clock is None else {"clock": heartbeat_clock}
        # the serving path owns a heartbeat monitor over its workers, so
        # a hung decode loop is detected, logged and escalated
        self.monitor = HeartbeatMonitor(
            2, heartbeat_timeout=heartbeat_timeout, **kw)
        self.idle_poll_s = float(idle_poll_s)
        self.escalate_hangs = bool(escalate_hangs)
        self._wake: Optional[asyncio.Event] = None
        self._tasks: List[asyncio.Task] = []
        self._watch: Optional[asyncio.Task] = None
        self._draining = False
        self._started = False

    # ----------------------------------------------------------- intake
    @property
    def queue_depth(self) -> int:
        """Requests accepted but not yet resident in a slot."""
        return len(self._inbox) + len(self.engine.queue)

    def submit(self, prompt: np.ndarray,
               max_new_tokens: int = 32) -> AsyncRequestHandle:
        """Enqueue one request; returns its stream handle immediately.
        Raises ``QueueFullError`` (typed, nothing enqueued) when the
        bounded inbox is at ``queue_limit`` — backpressure belongs at
        admission, not mid-stream."""
        if self._draining:
            raise RuntimeError("runtime is draining: submissions closed")
        if len(self._inbox) >= self.queue_limit:
            raise QueueFullError(
                f"admission queue full ({self.queue_limit} pending); "
                f"shed or retry after the backlog drains")
        h = AsyncRequestHandle(prompt, max_new_tokens)
        self._inbox.append(h)
        if self._wake is not None:
            self._wake.set()
        return h

    # ------------------------------------------------------------ routing
    def _route(self, req: Request, tok: Optional[int], done: bool):
        """Engine token_sink: fan tokens out to per-request streams.
        Runs synchronously inside ``engine.step`` on the event-loop
        thread, so put_nowait ordering matches generation order."""
        h = self._handles.get(req.rid)
        if h is None:
            return            # request submitted around the runtime
        if done:
            h.t_done = time.monotonic()
            self._handles.pop(req.rid)
            h._finished.set()
            h._q.put_nowait(_END)
            return
        if h.t_first is None:
            h.t_first = time.monotonic()
        h.tokens.append(tok)
        h._q.put_nowait(tok)

    def _fail_handle(self, h: AsyncRequestHandle, e: BaseException):
        h.error = e
        h.t_done = time.monotonic()
        h._finished.set()
        h._q.put_nowait(_END)

    # ------------------------------------------------------------ workers
    async def _idle_wait(self):
        self._wake.clear()
        try:
            await asyncio.wait_for(self._wake.wait(),
                                   timeout=self.idle_poll_s)
        except asyncio.TimeoutError:
            pass              # periodic poll: re-check drain conditions

    async def _admission_worker(self):
        while True:
            self.monitor.record_heartbeat(self.ADMISSION)
            if self._inbox:
                h = self._inbox.popleft()
                # atomic dequeue->submit->register (no await in between):
                # the handle is routable before the decode worker can
                # emit its first token, and FIFO order is preserved — the
                # bit-identity-with-sync contract hangs on this
                try:
                    h.rid = self.engine.submit(h.prompt, h.max_new_tokens)
                    self._handles[h.rid] = h
                except ValueError as e:
                    # intake-time reject (e.g. prompt exceeds max bucket):
                    # surfaced on THIS handle's stream, not the runtime
                    self._fail_handle(h, e)
                self._wake.set()          # decode worker may be idling
                await asyncio.sleep(0)    # overlap: let decode interleave
                continue
            if self._draining:
                return
            await self._idle_wait()

    async def _decode_worker(self):
        while True:
            self.monitor.record_heartbeat(self.DECODE)
            t0 = time.monotonic()
            if self.engine.step():
                self.monitor.record_step(self.DECODE,
                                         time.monotonic() - t0)
                await asyncio.sleep(0)    # stream consumers + admission
                continue
            # idle: nothing resident.  A non-empty engine queue here can
            # never admit (all slots/pages are free and it still did not
            # fit) — fail loudly instead of spinning forever.
            if self.engine.queue:
                raise RuntimeError(
                    "idle engine cannot admit its head-of-line request "
                    f"(queue={len(self.engine.queue)}): request footprint "
                    "exceeds the engine's page pool / slot capacity")
            if self._draining and not self._inbox:
                return
            await self._idle_wait()

    async def _watchdog(self):
        period = max(self.monitor.heartbeat_timeout / 2.0,
                     self.idle_poll_s)
        while True:
            await asyncio.sleep(period)
            self.check_workers()

    def check_workers(self) -> List[int]:
        """Sweep the worker heartbeat monitor: newly-hung workers (silent
        past the timeout) are logged once into ``monitor.events`` and
        returned.  The watchdog calls this periodically; tests call it
        directly on a virtual clock.

        With ``escalate_hangs`` (the default) a newly-hung worker
        additionally ESCALATES to controller recovery instead of only
        being logged: the engine controller re-reads C_j(τ) from the
        device monitor (hung/failed devices estimate to zero) and the
        next scheduler step is forced to re-run Algorithm 1 — so a stall
        triggers re-placement in one watchdog period rather than waiting
        out the λ cadence."""
        on_hung = self._escalate if self.escalate_hangs else None
        return self.monitor.sweep_hung(on_hung=on_hung)

    def _escalate(self, worker: int):
        """worker_hung → controller recovery: refresh the controller's
        availability view from the engine's device monitor and force a
        replan at the next step."""
        eng = self.engine
        eng.controller.observe_monitor(eng.monitor,
                                       peak_flops=eng.net.compute_avail)
        eng.request_replan()

    # ---------------------------------------------------------- lifecycle
    def start(self):
        """Spawn the admission/decode workers + watchdog on the running
        event loop (``async with`` does this for you)."""
        if self._started:
            raise RuntimeError("runtime already started")
        self._started = True
        self._wake = asyncio.Event()
        self._tasks = [
            asyncio.create_task(self._admission_worker(), name="admission"),
            asyncio.create_task(self._decode_worker(), name="decode"),
        ]
        self._watch = asyncio.create_task(self._watchdog(), name="watchdog")

    async def drain(self):
        """Graceful shutdown: close intake, run every accepted request to
        completion, stop the workers.  Afterwards the engine is empty —
        no resident slots, and a paged engine holds zero live pages
        (asserted via ``check_invariants`` in the tests)."""
        if not self._started:
            raise RuntimeError("start() the runtime before draining")
        self._draining = True
        self._wake.set()
        try:
            await asyncio.gather(*self._tasks)
        finally:
            for t in self._tasks:
                t.cancel()
            await asyncio.gather(*self._tasks, return_exceptions=True)
            self._tasks = []
            await self._stop_watchdog()

    async def _stop_watchdog(self):
        if self._watch is not None:
            self._watch.cancel()
            try:
                await self._watch
            except asyncio.CancelledError:
                pass          # cooperative cancel is the expected exit
            self._watch = None

    async def aclose(self):
        """Idempotent close: drain if workers are still up."""
        if self._tasks:
            await self.drain()
        else:
            await self._stop_watchdog()

    async def __aenter__(self) -> "AsyncServingEngine":
        self.start()
        return self

    async def __aexit__(self, exc_type, exc, tb):
        if exc_type is None:
            await self.aclose()
        else:
            # error path: abandon in-flight work instead of draining
            for t in self._tasks:
                t.cancel()
            await asyncio.gather(*self._tasks, return_exceptions=True)
            self._tasks = []
            await self._stop_watchdog()
