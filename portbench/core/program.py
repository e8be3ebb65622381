"""The port's own spans and counters in a traced run
(strelka_tpu_torch/utils/spans.py), read after the window.

The port records while a torch.profiler session records (its ``job``
span turns the recorder on for the job), so a ``--trace 1`` window on a
card holds the spans of the window's jobs, on ``perf_counter_ns``: the
clock the harness places host spans on the trace with. A run record
gains ``program_spans`` (the spans as the port's ``drain`` gives them,
inside the window) and ``counters`` (what each counter gained in the
window's jobs, from their ``job`` spans); a record without them takes
them from the port's recorder, once. A port without the recorder, or a
window that recorded nothing, gives none.
"""
from __future__ import annotations

# the spans whose host time job_host_s leaves out of the jobs'
LAYERS = ("decode", "region", "emit", "merge")


def _take(run: dict) -> list[dict]:
    """The port's recorded spans inside the run's window of jobs."""
    try:
        from strelka_tpu_torch.utils import spans as sp
    except ImportError:
        return []
    spans, _totals = sp.drain()
    jobs = run.get("jobs") or []
    if not jobs:
        return []
    lo = min(j["t0"] for j in jobs) * 1e9
    hi = max(j["t1"] for j in jobs) * 1e9
    return [s for s in spans if lo <= s["t0_ns"] and s["t1_ns"] <= hi]


def window_counters(spans: list[dict]) -> dict[str, dict[str, int]]:
    """{counter: {key: gained}} summed over the `job` spans."""
    out: dict[str, dict[str, int]] = {}
    for s in spans:
        if s["name"] != "job":
            continue
        for name, by_key in s["attrs"].get("counters", {}).items():
            d = out.setdefault(name, {})
            for k, v in by_key.items():
                d[k] = d.get(k, 0) + v
    return out


def spans(run: dict) -> list[dict]:
    """The window's program spans (see the module's docstring)."""
    if "program_spans" not in run:
        run["program_spans"] = _take(run)
    return run["program_spans"]


def counters(run: dict) -> dict[str, dict[str, int]]:
    """The window's counters (see the module's docstring)."""
    if "counters" not in run:
        run["counters"] = window_counters(spans(run))
    return run["counters"]


def _dur(s: dict) -> float:
    return (s["t1_ns"] - s["t0_ns"]) * 1e-9


def self_s(spans_: list[dict], name: str):
    """Seconds of the spans named `name` less their direct children's;
    None where there is no such span."""
    mine = [s for s in spans_ if s["name"] == name]
    if not mine:
        return None
    ids = {s["id"] for s in mine}
    inside = sum(_dur(c) for c in spans_ if c["parent"] in ids)
    return sum(_dur(s) for s in mine) - inside


def total_s(spans_: list[dict], names) -> float:
    return sum(_dur(s) for s in spans_ if s["name"] in names)


def outside_s(spans_: list[dict], outer: str, layers=LAYERS):
    """Seconds of the `outer` spans outside every span of `layers` in
    them (the outermost of those, so none is counted twice); None
    where there is no `outer` span."""
    by_id = {s["id"]: s for s in spans_}
    outers = [s for s in spans_ if s["name"] == outer]
    if not outers:
        return None
    covered = 0.0
    for s in spans_:
        if s["name"] not in layers:
            continue
        p = by_id.get(s["parent"])
        while p is not None and p["name"] not in layers:
            p = by_id.get(p["parent"])
        if p is None:
            covered += _dur(s)
    return sum(_dur(s) for s in outers) - covered


def host_spans(spans_: list[dict]) -> list[tuple]:
    """(name, t0 s, t1 s) of the program's spans, the form of the
    benchmark's own host spans (trace.idle_gaps names gaps from
    them)."""
    return [(s["name"], s["t0_ns"] * 1e-9, s["t1_ns"] * 1e-9)
            for s in spans_]


def innermost_at(spans_: list[tuple], t: float):
    """The name of the shortest host span around time `t` (seconds),
    None where none is."""
    inside = [s for s in spans_ if s[1] <= t <= s[2]]
    return min(inside, key=lambda s: s[2] - s[1])[0] if inside else None


def idle_by_span(busy, lo_us: float, hi_us: float, spans_: list[tuple],
                 offset_us: float, n: int = 15) -> list[list]:
    """[[span name, idle seconds], ...]: the device-idle time inside
    [lo_us, hi_us] (trace clock; `busy` the union of the device's
    intervals there) split over the innermost host span at each
    instant ("outside the layers" where none is), top n. The split is
    exact: idle time is cut at every span edge."""
    edges = sorted({lo_us, hi_us}
                   | {t * 1e6 + offset_us for _n, a, b in spans_
                      for t in (a, b)
                      if lo_us < t * 1e6 + offset_us < hi_us})
    idle, prev = [], lo_us
    for s, e in busy:
        s, e = max(s, lo_us), min(e, hi_us)
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if hi_us > prev:
        idle.append((prev, hi_us))
    out: dict[str, float] = {}
    j = 0
    for a, b in idle:
        while j < len(edges) and edges[j] <= a:
            j += 1
        cuts, k = [a], j
        while k < len(edges) and edges[k] < b:
            cuts.append(edges[k])
            k += 1
        cuts.append(b)
        for c0, c1 in zip(cuts, cuts[1:]):
            mid = ((c0 + c1) / 2 - offset_us) * 1e-6
            name = innermost_at(spans_, mid) or "outside the layers"
            out[name] = out.get(name, 0.0) + (c1 - c0) * 1e-6
    return [[k, v] for k, v in sorted(out.items(), key=lambda x: -x[1])[:n]]
