"""The port's spans and counters: where a job's host time goes, on the
clock a device trace is placed on.

- ``span(name, **attrs)``: a context manager, or a decorator, that
  records a span: an id, its parent's id (the innermost span open on
  this thread), the name, ``t0_ns`` and ``t1_ns`` by
  ``time.perf_counter_ns()``, the job and segment identifiers it
  inherits from its parents, and its attributes. ``job=`` and
  ``segment=`` set the identifiers of a span and of everything inside
  it.
- ``stage(name)``: closes the stage span that ``stage`` opened last on
  this thread, if it is still the innermost, and opens the next one
  (None: opens none) inside the span around it. A function's stages
  follow one another without re-indenting its body; the span around
  them closes the last.
- ``job(**attrs)``: the ``job`` span of one CLI call, with the process's
  job number. While a ``torch.profiler`` session records and the
  recorder is off, the recorder is on for the job, so a profiled job
  has its spans beside the profiler's trace.
- ``count(name, n=1, **key)``: adds to a counter, recorder on or off
  (one add under a lock). A ``job`` span recorded keeps, in its
  ``counters`` attribute, what each counter gained during the job.
- ``enable()``, ``disable()``, ``clear()``, ``drain() -> (spans,
  counters)``: spans as dicts, counters as ``{name: {key: total}}``
  (key ``"k=v,..."``, ``""`` for none).

Off, a span site costs one test of ``ON`` and a shared no-op object.
Spans and counters stay in memory until drained. ``STRELKA_TPU_TRACE=<dir>``
turns the recorder on at import and writes ``<dir>/trace_<pid>.json``
at exit: Chrome trace-event JSON (spans as "X" events, counters sampled
at each job's start and end as "C" events) that Perfetto opens beside
a ``torch.profiler`` export; each process, so each ``--jobs`` worker,
writes its own.
"""
from __future__ import annotations

import atexit
import functools
import itertools
import json
import os
import sys
import threading
import time

ON = False

_SPANS: list[tuple] = []   # (id, parent, name, t0_ns, t1_ns, job, segment, attrs)
_COUNTS: dict[tuple, int] = {}   # (name, key items) -> total
_SAMPLES: list[tuple] = []       # (t_ns, {(name, key items): total})
_COUNT_LOCK = threading.Lock()
_IDS = itertools.count(1)
_JOBS = itertools.count(1)
_LOCAL = threading.local()

TRACE_ENV = "STRELKA_TPU_TRACE"


def _stack() -> list:
    s = getattr(_LOCAL, "stack", None)
    if s is None:
        s = _LOCAL.stack = []
    return s


class _Site:
    """What a span site returns: a context manager, and a decorator
    whose wrapper records a span on each call while the recorder is
    on."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def spanned(*a, **k):
            if not ON:
                return fn(*a, **k)
            with _Span(name, dict(attrs)):
                return fn(*a, **k)
        return spanned


class _Noop(_Site):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOPS: dict[str, _Noop] = {}


class _Span(_Site):
    __slots__ = ("id", "parent", "job", "segment", "t0", "is_stage")

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = top.id if top is not None else None
        self.job = self.attrs.pop(
            "job", top.job if top is not None else None)
        self.segment = self.attrs.pop(
            "segment", top.segment if top is not None else None)
        self.is_stage = False
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.close(time.perf_counter_ns())
        return False

    def close(self, t1: int) -> None:
        """End this span at `t1` and every span still open inside it
        (a stage, or a span an exception left open)."""
        stack = _stack()
        if self not in stack:
            return
        while stack:
            s = stack.pop()
            _SPANS.append((s.id, s.parent, s.name, s.t0, t1, s.job,
                           s.segment, s.attrs))
            if s is self:
                return


def span(name: str, **attrs):
    """A span named `name` (see the module's docstring)."""
    if not ON:
        if attrs:
            return _Noop(name, attrs)
        noop = _NOOPS.get(name)
        if noop is None:
            noop = _NOOPS[name] = _Noop(name, {})
        return noop
    return _Span(name, attrs)


def stage(name: str | None) -> None:
    """Close the innermost span if `stage` opened it, then open a stage
    span `name` (None: none) inside the span now innermost; outside
    every span, nothing (no span would close it)."""
    if not ON:
        return
    stack = _stack()
    if stack and stack[-1].is_stage:
        stack[-1].close(time.perf_counter_ns())
    if name is not None and stack:
        _Span(name, {}).__enter__().is_stage = True


def count(name: str, n: int = 1, **key) -> None:
    """Add `n` to counter `name` under `key`."""
    k = (name, tuple(key.items()))
    with _COUNT_LOCK:
        _COUNTS[k] = _COUNTS.get(k, 0) + n


def _profiling() -> bool:
    """Whether a torch.profiler session is recording in this process."""
    torch = sys.modules.get("torch")
    enabled = getattr(getattr(torch, "autograd", None),
                      "_profiler_enabled", None)
    return enabled is not None and bool(enabled())


class job:
    """The ``job`` span of one CLI call (see the module's docstring)."""

    def __init__(self, **attrs):
        self.number = next(_JOBS)
        self.attrs = attrs
        self.follow = False
        self.span = None

    def __enter__(self):
        self.follow = not ON and _profiling()
        if self.follow:
            enable()
        if ON:
            with _COUNT_LOCK:
                self.before = dict(_COUNTS)
            self.span = _Span("job", {"job": self.number, **self.attrs})
            self.span.__enter__()
            _SAMPLES.append((self.span.t0, self.before))
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            t1 = time.perf_counter_ns()
            with _COUNT_LOCK:
                after = dict(_COUNTS)
            self.span.attrs["counters"] = _nested({
                k: v - self.before.get(k, 0) for k, v in after.items()
                if v != self.before.get(k, 0)})
            _SAMPLES.append((t1, after))
            self.span.close(t1)
        if self.follow:
            disable()
        return False


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def clear() -> None:
    """Forget the spans, counters and samples recorded so far."""
    with _COUNT_LOCK:
        _SPANS.clear()
        _COUNTS.clear()
        _SAMPLES.clear()


def _nested(counts: dict) -> dict[str, dict[str, int]]:
    out: dict[str, dict[str, int]] = {}
    for (name, key), v in counts.items():
        out.setdefault(name, {})[",".join(f"{a}={b}" for a, b in key)] = v
    return out


def drain() -> tuple[list[dict], dict[str, dict[str, int]]]:
    """(spans, counters) recorded so far, then `clear`."""
    with _COUNT_LOCK:
        spans, counts = list(_SPANS), dict(_COUNTS)
        _SPANS.clear()
        _COUNTS.clear()
        _SAMPLES.clear()
    keys = ("id", "parent", "name", "t0_ns", "t1_ns", "job", "segment",
            "attrs")
    return [dict(zip(keys, s)) for s in spans], _nested(counts)


def chrome_trace() -> dict:
    """The spans and the counter samples recorded so far as Chrome
    trace-event JSON (timestamps in microseconds of perf_counter)."""
    pid = os.getpid()
    events = []
    for sid, parent, name, t0, t1, job_, seg, attrs in list(_SPANS):
        args = {"id": sid, "parent": parent, "job": job_, "segment": seg}
        args.update(attrs)
        events.append({"name": name, "ph": "X", "pid": pid, "tid": pid,
                       "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                       "args": args})
    for t, counts in list(_SAMPLES):
        for name, by_key in _nested(counts).items():
            events.append({"name": name, "ph": "C", "pid": pid,
                           "ts": t / 1e3,
                           "args": {k or "total": v
                                    for k, v in by_key.items()}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _write_trace(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"trace_{os.getpid()}.json"),
              "w") as f:
        json.dump(chrome_trace(), f)


if os.environ.get(TRACE_ENV):
    enable()
    atexit.register(_write_trace, os.environ[TRACE_ENV])
