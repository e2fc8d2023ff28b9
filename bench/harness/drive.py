"""Serving one cell through the program's own entry: a ``PipelinedEngine``
behind ``AsyncServingServer``, with one closed-loop client per decode
slot that submits through ``submit`` and consumes the token stream, as
``launch/serve.py --serve --engine pipelined`` does.

The clients start during warm-up, one after another over its first
half, so the window opens on full slots in a steady state.  At
the window's close they stop sending and the server shuts down; requests
still in flight are cut, not failed.

In a traced run the harness also records, from its own code, host spans
around the engine's device programs (``engine.chunk`` /
``engine.decode`` / ``engine.copy``, named ``record_function`` ranges),
its harvests and the server's ingress, and each program's lengths; and it
profiles a slice of ``trace_steps`` engine steps from the engine thread,
between two synchronisations, so that the slice holds exactly the device
work of the programs dispatched in it.
"""

from __future__ import annotations

import asyncio
import copy
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from harness.trace import read_chrome_trace


@dataclass
class Record:
    """One request as its client saw it."""

    index: int
    t_submit: float
    times: list = field(default_factory=list)    # each token's arrival
    tokens: list = field(default_factory=list)
    result: object = None                        # GenerationResult
    error: str | None = None
    cut: bool = False                            # in flight at the close


@dataclass
class Drive:
    records: list
    t0: float
    t1: float
    stats0: object
    stats1: object
    launches: list                # (host time, op, lengths) in trace runs
    trace: object = None          # TraceReading of the slice
    slice_launches: tuple = (0, 0)
    trace_error: str | None = None


class Tracer:
    """The traced run's host spans, launch log and profiled slice.

    torch.profiler (CUDA activity) is started and stopped by the main
    thread, where the profiler has to run; the server's engine thread
    bounds the slice: at a step boundary it synchronises and launches a
    marker kernel (``torch.cuda._sleep``: ``spin_kernel``), and
    ``trace_steps`` steps later does the same.  The markers' host launch
    times against their device times map the host spans, taken by the
    harness's own clock, onto the trace."""

    MARKER = "spin_kernel"

    def __init__(self, engine, server, steps: int):
        self.steps = steps
        self.launches: list = []
        self.spans: list = []          # (name, host t0, host t1)
        self.marks: list = []          # host launch times of the markers
        self.armed = False
        self.n = 0
        self.span = (0, 0)
        self.done = False
        self._install(engine, server)

    def _timed(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def _install(self, engine, server) -> None:
        launch, harvest, step = engine._launch, engine._harvest, engine.step
        ingress = server._drain_ingress

        def traced_launch(op, **plan):
            host = plan.get("host")
            if op == "decode":
                lens = host.lengths[host.lengths > 0].astype(np.int64) + 1
                info = (lens,)
            elif op == "chunk":
                info = (int(host.cache_lens[0]), int(host.chunk_lens[0]),
                        plan.get("first") is not None)
            else:
                info = ()
            self.launches.append((time.perf_counter(), op, info))
            return self._timed(f"engine.{op}", launch, op, **plan)

        def traced_step():
            if self.armed and not self.done and not self.marks:
                self._mark()
                self.span = (len(self.launches), len(self.launches))
            out = self._timed("engine.step", step)
            if self.marks and not self.done:
                self.n += 1
                if self.n >= self.steps:
                    self.span = (self.span[0], len(self.launches))
                    self._mark()
                    self.done = True
            return out

        engine._launch = traced_launch
        engine._harvest = lambda: self._timed("engine.harvest", harvest)
        engine.step = traced_step
        server._drain_ingress = lambda: self._timed("server.ingress",
                                                    ingress)

    def _mark(self) -> None:
        _sync()
        self.marks.append(time.perf_counter())
        if torch.cuda.is_available():
            torch.cuda._sleep(1000)
        _sync()

    def read(self, prof, max_bytes: int = 1 << 30):
        """The slice's reading from ``prof``'s chrome trace (written under
        TMPDIR and deleted once read)."""
        if not self.done:
            raise RuntimeError("the traced slice did not complete in the "
                               "window")
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            if size > max_bytes:
                raise RuntimeError(f"trace of {size} bytes over {max_bytes}")
            return read_chrome_trace(path, self.MARKER, self.marks,
                                     self.spans)
        finally:
            os.unlink(path)


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    return profile(activities=acts)


def _sync() -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU, where the engine's steps run synchronously)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


async def _client(srv, traffic, take, records, closing,
                  delay: float) -> None:
    await asyncio.sleep(delay)
    while not closing.is_set():
        req = traffic.request(take())
        rec = Record(req.index, time.perf_counter())
        records.append(rec)
        try:
            stream = await srv.submit(req.prompt, req.max_new_tokens)
            async for tok in stream:
                rec.times.append(time.perf_counter())
                rec.tokens.append(tok)
            rec.result = await stream.result()
        except Exception as exc:  # the shutdown at the close cuts requests
            if closing.is_set():
                rec.cut = True
                return
            rec.error = repr(exc)
            raise


async def serve(engine, traffic, clients: int, warmup_s: float,
                seconds: float, trace_steps: int | None = None) -> Drive:
    """Run the closed loop: ``warmup_s`` of set-up, then the measured
    window of ``seconds``.  With ``trace_steps`` the run is traced (:class:`Tracer`),
    its slice starting a quarter into the window."""
    from repro_torch.runtime.server import AsyncServingServer

    srv = AsyncServingServer(engine)
    tracer = (Tracer(engine, srv, trace_steps) if trace_steps else None)
    prof = None
    await srv.start()
    records: list = []
    counter = iter(range(1 << 62))
    closing = asyncio.Event()
    # the clients' first requests spread over the warm-up's first half,
    # so that the loop reaches its steady state before the window
    tasks = [asyncio.create_task(
        _client(srv, traffic, lambda: next(counter), records, closing,
                0.5 * warmup_s * i / clients))
        for i in range(clients)]
    try:
        await asyncio.sleep(warmup_s)
        t0 = time.perf_counter()
        stats0 = copy.copy(engine.stats)
        if tracer is not None:
            await asyncio.sleep(seconds / 4.0)
            prof = _profiler()
            t = time.perf_counter()
            prof.start()
            print(f"trace: the profiler took {time.perf_counter() - t:.2f} s "
                  f"to start", file=sys.stderr)
            tracer.armed = True
            while not tracer.done and time.perf_counter() < t0 + seconds:
                await asyncio.sleep(0.05)
            prof.stop()
        await asyncio.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        stats1 = copy.copy(engine.stats)
        closing.set()
    finally:
        closing.set()
        await srv.shutdown()
        outcomes = await asyncio.gather(*tasks, return_exceptions=True)
    for out in outcomes:
        if isinstance(out, BaseException):
            raise out
    drive = Drive(records, t0, t1, stats0, stats1,
                  tracer.launches if tracer else [])
    if tracer is not None:
        try:
            drive.trace = tracer.read(prof)
            drive.slice_launches = tracer.span
        except RuntimeError as exc:
            drive.trace_error = str(exc)
    return drive


def warm_shapes(engine) -> None:
    """One short request through the engine: a prompt chunk and a decode
    step, the only shapes the loop runs, so that the kernels are built
    and the products planned before the window (the first run in a
    checkout builds the CUDA libraries here).  Its prompt fills no page,
    so the prefix cache holds nothing of it."""
    engine.add_request(np.arange(8, dtype=np.int32), 2)
    engine.run()


def prefill_documents(engine, traffic) -> None:
    """Serve each document once as its own prompt (one token), so that its
    full pages sit in the prefix cache before the loop starts."""
    for doc in traffic.documents:
        engine.add_request(doc, 1)
    engine.run()
