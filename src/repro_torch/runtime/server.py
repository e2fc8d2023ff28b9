"""Asyncio front-end over the serving engine.

The counterpart of the JAX package's ``runtime/server.py``, nearly as it
is: the server touches the engine only through ``add_request``,
``has_work``, ``step`` and the sequences' states.

The engine itself is a synchronous, single-threaded step loop (and NOT
thread-safe: scheduler state, stats and the device pool handle all
mutate un-locked).  This module puts an asyncio facade in front of it:

* one **driver thread** owns the engine exclusively and spins
  :meth:`ServingEngine.step` while there is work;
* :meth:`AsyncServingServer.submit` is called from the event loop; it
  drops the request onto a thread-safe ingress queue, which the driver
  drains at step boundaries (the only point where adding requests is
  safe);
* tokens and results cross back via ``loop.call_soon_threadsafe`` into
  per-request asyncio queues, so ``async for tok in stream`` yields
  tokens as the engine emits them.

Admission control: ``max_queue`` bounds requests *waiting* for a slot
(queued in the scheduler or in transit on the ingress queue — slotted
requests don't count, they're being served).  When the bound is hit,
:meth:`submit` either raises :class:`ServerSaturatedError`
(``backpressure='reject'``, the load-shedding default) or awaits until
the queue drains (``backpressure='wait'``).  The page pool needs no
separate guard: the scheduler already head-of-line-blocks admission
when pages are short, so a bounded waiting queue bounds everything.

Works with either engine class; :class:`PipelinedEngine` is the point
(its step loop overlaps the host bookkeeping this server adds with
device compute).
"""

from __future__ import annotations

import asyncio
import queue
import threading

from repro_torch.runtime.engine import GenerationResult, ServingEngine
from repro_torch.runtime.scheduler import SeqState


class ServerSaturatedError(RuntimeError):
    """Raised by :meth:`AsyncServingServer.submit` when the waiting
    queue is at ``max_queue`` and backpressure is 'reject'."""


class RequestStream:
    """Async view of one in-flight request.

    Iterate for per-token streaming, or await :meth:`result` for the
    final :class:`GenerationResult` (which also drains any unconsumed
    tokens).
    """

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._tokens: asyncio.Queue = asyncio.Queue()
        # constructed by the async submit path, so this runs ON the loop
        # thread — the one sanctioned direct loop call
        self._result: asyncio.Future = loop.create_future()
        self.request_id: int | None = None

    # driver-thread side -------------------------------------------------

    def _emit_token(self, tok: int) -> None:
        self._loop.call_soon_threadsafe(self._tokens.put_nowait, tok)

    def _finish(self, res: GenerationResult) -> None:
        def _set() -> None:
            self._tokens.put_nowait(None)  # end-of-stream sentinel
            if not self._result.done():
                self._result.set_result(res)
        self._loop.call_soon_threadsafe(_set)

    def _fail(self, exc: BaseException) -> None:
        def _set() -> None:
            self._tokens.put_nowait(None)
            if not self._result.done():
                self._result.set_exception(exc)
        self._loop.call_soon_threadsafe(_set)

    # event-loop side ----------------------------------------------------

    def __aiter__(self) -> "RequestStream":
        return self

    async def __anext__(self) -> int:
        tok = await self._tokens.get()
        if tok is None:
            # re-raise a failure (e.g. server shutdown) for consumers
            # that only iterate and never await result()
            if self._result.done() and self._result.exception() is not None:
                raise self._result.exception()
            raise StopAsyncIteration
        return tok

    async def result(self) -> GenerationResult:
        return await self._result


class AsyncServingServer:
    """Drive a :class:`ServingEngine` from asyncio with streaming.

    Args:
      engine: a (fresh) engine; the server takes exclusive ownership of
        its step loop.
      max_queue: admission bound — max requests waiting (not yet
        slotted).  ``None`` → unbounded.
      backpressure: 'reject' raises :class:`ServerSaturatedError` at
        the bound; 'wait' makes :meth:`submit` await until space frees.

    Use as an async context manager, or call :meth:`start` /
    :meth:`shutdown` explicitly.
    """

    _POLL_S = 0.002  # idle driver poll (no engine work, empty ingress)

    def __init__(self, engine: ServingEngine, *, max_queue: int | None = None,
                 backpressure: str = "reject"):
        if backpressure not in ("reject", "wait"):
            raise ValueError(f"backpressure {backpressure!r}: "
                             "want 'reject' or 'wait'")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue {max_queue} < 1")
        self.engine = engine
        self.max_queue = max_queue
        self.backpressure = backpressure
        self._loop: asyncio.AbstractEventLoop | None = None
        self._ingress: queue.Queue = queue.Queue()
        self._streams: dict[int, RequestStream] = {}
        self._n_waiting = 0              # loop-thread: ingress + unslotted
        self._unslotted: set[int] = set()  # driver-thread mirror, by rid
        self._space = None               # event: waiting dropped below bound
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._driver_error: BaseException | None = None

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> "AsyncServingServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._loop = asyncio.get_running_loop()
        self._space = asyncio.Event()
        self._thread = threading.Thread(target=self._drive,
                                        name="engine-driver", daemon=True)
        self._thread.start()
        return self

    async def shutdown(self) -> None:
        """Stop the driver; in-flight requests fail with shutdown."""
        if self._thread is None:
            return
        self._stop.set()
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join)
        self._thread = None
        exc = self._driver_error or RuntimeError("server shut down")
        # requests still in transit on the ingress queue never reached
        # the engine — fail their streams too, or clients hang
        while True:
            try:
                stream, _ = self._ingress.get_nowait()
            except queue.Empty:
                break
            stream._fail(exc)
        for stream in list(self._streams.values()):
            stream._fail(exc)
        self._streams.clear()
        if self._driver_error is not None:
            raise self._driver_error

    async def __aenter__(self) -> "AsyncServingServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.shutdown()

    # -- submission -------------------------------------------------------

    async def submit(self, prompt, max_new_tokens: int, *,
                     temperature: float = 0.0, seed: int = 0,
                     eos_id: int | None = None) -> RequestStream:
        """Queue a request; returns its :class:`RequestStream`."""
        if self._thread is None:
            raise RuntimeError("server not started")
        while (self.max_queue is not None
               and self._n_waiting >= self.max_queue):
            if self.backpressure == "reject":
                raise ServerSaturatedError(
                    f"{self._n_waiting} requests waiting "
                    f"(max_queue={self.max_queue})")
            self._space.clear()
            await self._space.wait()
        self._n_waiting += 1
        stream = RequestStream(self._loop)
        self._ingress.put((stream, dict(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed, eos_id=eos_id)))
        return stream

    def _admitted(self) -> None:
        # a waiting request took a slot: wake one backpressured submit
        self._n_waiting -= 1
        if self._space is not None:
            self._space.set()

    # -- driver thread -----------------------------------------------------

    def _drain_ingress(self) -> None:
        while True:
            try:
                stream, kwargs = self._ingress.get_nowait()
            except queue.Empty:
                return
            try:
                handle = self.engine.add_request(
                    **kwargs, on_token=stream._emit_token)
            except Exception as exc:  # e.g. prompt exceeds max_context
                self._loop.call_soon_threadsafe(self._admitted)
                stream._fail(exc)
                continue
            stream.request_id = handle.id
            self._streams[handle.id] = stream
            self._unslotted.add(handle.id)

    def _count_slotted(self) -> None:
        # requests that moved waiting → slotted since the last step:
        # exactly one _admitted per request (an eviction re-queues the
        # sequence but does not re-count — its first admission spent
        # the queue credit)
        for rid in list(self._unslotted):
            seq = self.engine._seqs.get(rid)
            if seq is None or seq.state is not SeqState.WAITING:
                self._unslotted.discard(rid)
                self._loop.call_soon_threadsafe(self._admitted)

    def _drive(self) -> None:
        try:
            while not self._stop.is_set():
                self._drain_ingress()
                if not self.engine.has_work():
                    self._stop.wait(self._POLL_S)
                    continue
                for res in self.engine.step():
                    stream = self._streams.pop(res.request_id, None)
                    if stream is not None:
                        stream._finish(res)
                self._count_slotted()
        except BaseException as exc:  # surface crashes to awaiting clients
            self._driver_error = exc
            for stream in list(self._streams.values()):
                stream._fail(exc)
            self._streams.clear()
