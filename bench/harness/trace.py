"""Reading a torch.profiler chrome trace of the traced slice.

The slice lies between two marker kernels that the server's engine thread
launched after synchronising.  Within it: the device's busy time (the
union of its operations), time by device operation, and the
idle gaps between operations, each named by the innermost host span of
the harness (recorded by the host clock, mapped onto the trace by the
markers' launch times) that it fell in."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceReading:
    window_s: float
    busy_s: float
    op_s: dict = field(default_factory=dict)       # name → seconds
    gaps: list = field(default_factory=list)       # (span, seconds), longest first


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_chrome_trace(path: str, marker: str, marks, spans,
                      n_gaps: int = 10) -> TraceReading:
    """``marks``: the host times (s) the two markers were launched;
    ``spans``: (name, host t0, host t1) of the harness."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, found = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat", "") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        name = e.get("name", "?")
        (found if marker in name else ops).append((ts, ts + dur, name))
    if len(found) < 2:
        if found or ops:
            raise ValueError(f"{path}: {len(found)} marker kernels")
        return TraceReading(window_s=marks[1] - marks[0], busy_s=0.0)
    found.sort()
    (m0, m0_end, _), (m1, _, _) = found[0], found[-1]
    off = 0.5 * ((m0 - marks[0] * 1e6) + (m1 - marks[1] * 1e6))
    w0, w1 = m0_end, m1
    reading = TraceReading(window_s=(w1 - w0) * 1e-6, busy_s=0.0)
    clipped = []
    for a, b, name in ops:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        reading.op_s[name] = reading.op_s.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(clipped)
    reading.busy_s = sum(b - a for a, b in busy) * 1e-6
    host = [(t0 * 1e6 + off, t1 * 1e6 + off, name) for name, t0, t1 in spans]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inside = [s for s in host if s[0] <= mid <= s[1]]
        name = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                else "host.other")
        gaps.append((name, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    reading.gaps = gaps[:n_gaps]
    return reading
