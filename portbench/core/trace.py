"""The device trace of a traced run: torch.profiler with CUDA activity
only, its device events read from the exported chrome trace.

busy is the union of the device events' intervals (kernels, copies,
memsets), so overlap is counted once; a run's idle share is one less
busy over the traced window. The benchmark's own stream (its checks'
copies, its counting of live extents) is found by a marker that start()
launches on it and is left out of every reading.
"""
from __future__ import annotations

import json
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = 7.25      # the value the clock marker writes


class DeviceTrace:
    """A profiler session. start() launches a marker kernel first and
    keeps the host clock just before it, so that host spans can be placed
    on the trace's clock (offset_us), then a second marker on the
    benchmark's stream `side` where there is one."""

    def __init__(self):
        self.prof = None
        self.marker_host = None

    def start(self, side=None) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        x = torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter()
        x.fill_(MARKER)
        torch.cuda.synchronize()
        if side is not None:
            with torch.cuda.stream(side):
                x.fill_(MARKER)
            torch.cuda.synchronize()

    def stop(self, path: str) -> None:
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(path)
        self.prof = None


def device_events(path: str, side: bool = False):
    """(name, start us, end us) of the trace's device events, by start,
    and the clock marker's start: the first event, a fill, and with
    `side` the second (the side marker), whose stream's events are all
    left out. ([], None) where the markers are not found."""
    with open(path) as f:
        data = json.load(f)
    ev = data["traceEvents"] if isinstance(data, dict) else data
    out = [(e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(
        e.get("dur", 0.0)), (e.get("args") or {}).get("stream", e.get("tid")))
        for e in ev
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    out.sort(key=lambda x: x[1])
    n = 2 if side else 1
    if len(out) < n or not all("Fill" in x[0] for x in out[:n]):
        return [], None
    clock = out[0][1]
    # a side marker on the clock marker's stream would take the
    # program's events with it: then nothing is left out
    skip = out[1][3] if side and out[1][3] != out[0][3] else object()
    return [x[:3] for x in out[n:] if x[3] != skip], clock


def union(intervals) -> list[tuple[float, float]]:
    """Merged [start, end) intervals of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_us(events) -> float:
    return sum(e - s for s, e in union((s, e) for _n, s, e in events))


def kernel_s(events, name: str) -> float:
    """Seconds of the device events whose name holds `name`."""
    return sum(e - s for k, s, e in events if name in k) * 1e-6


def top_ops(events, n: int = 10) -> list[list]:
    """[[kernel name, seconds], ...]: the n names that took most time."""
    tot: dict[str, float] = {}
    for name, s, e in events:
        tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def idle_gaps(events, lo_us: float, hi_us: float, spans, offset_us: float,
              n: int = 10) -> list[list]:
    """[[what the host was doing, seconds], ...]: the n longest gaps
    between device work inside [lo_us, hi_us], each named by the
    innermost host span (layer, t0, t1 on the host clock) around its
    middle ("outside the layers" where none is)."""
    busy = union((max(s, lo_us), min(e, hi_us)) for _n, s, e in events
                 if e > lo_us and s < hi_us)
    gaps, prev = [], lo_us
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi_us > prev:
        gaps.append((prev, hi_us))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = ((s + e) / 2 - offset_us) * 1e-6
        inside = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = (min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside
                else "outside the layers")
        out.append([name, (e - s) * 1e-6])
    return out
