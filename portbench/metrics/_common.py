"""Shared arithmetic of the per-layer readers (not a metric itself)."""
from __future__ import annotations


def span_s(run: dict, layer: str) -> float:
    return sum(t1 - t0 for name, t0, t1 in run["spans"] if name == layer)


def per_mread(run: dict, seconds: float):
    reads = run["reads"]
    return seconds / (reads / 1e6) if reads else None


def roofline_pct(run: dict, entry: str):
    """100 x the summed bound of an entry's calls in the window (their
    live extents' work) over its kernel's summed time in the profiler's
    trace; None where it had no call or the trace no kernel of it."""
    from portbench.core.peaks import bound_ms
    calls = [c for c in run["calls"] if c["entry"] == entry]
    kernel_s = run.get("kernel_s", {}).get(entry, 0.0)
    if not calls or kernel_s <= 0:
        return None
    bound = sum(bound_ms(c.get("nbytes", 0), c.get("int8_ops", 0),
                         c.get("f32_ops", 0), c.get("f64_ops", 0))
                for c in calls)
    return 100.0 * bound * 1e-3 / kernel_s
