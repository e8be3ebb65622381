#!/usr/bin/env python3
"""One ``--trace 1`` run of a cell (portbench/run.py, unchanged) read
against the port's own spans and counters:

    python3 portbench/trace_report.py --workload <cell> --seed <n> \\
        --seconds <s> [--contig-bp <bp>] [--out <file.json>]

on a card. Beside the run's result line it writes one JSON object: the
program's span counts a job, the region stages' self times and what
they leave of the region spans, the program's and the benchmark's
region totals, the window's copy counters against the trace's memcpy
events on the program's stream (and the share of those events that
start inside an h2d / d2h span placed on the trace's clock, within
0.1 ms), the longest idle gaps named by the benchmark's spans alone and
with the program's, and the device-idle time split over the innermost
program span (core/program.idle_by_span).
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TOLERANCE_US = 100.0


def _copies(path: str, lo: float, hi: float):
    """{kind: [(start us, bytes)]} of the trace's memcpy events inside
    [lo, hi], the benchmark's stream left out as trace.device_events
    leaves it out."""
    with open(path) as f:
        data = json.load(f)
    ev = data["traceEvents"] if isinstance(data, dict) else data
    dev = sorted((e for e in ev if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: float(e["ts"]))
    stream = [(e.get("args") or {}).get("stream", e.get("tid"))
              for e in dev[:2]]
    side = stream[1] if len(stream) == 2 and stream[0] != stream[1] else None
    out = {"h2d": [], "d2h": []}
    for e in dev:
        args = e.get("args") or {}
        if e.get("cat") != "gpu_memcpy" or args.get(
                "stream", e.get("tid")) == side:
            continue
        ts = float(e["ts"])
        if not lo <= ts <= hi:
            continue
        name = e.get("name", "")
        kind = "h2d" if "HtoD" in name else "d2h" if "DtoH" in name else None
        if kind:
            out[kind].append((ts, int(args.get("bytes", 0))))
    return out


def _residuals(placed, got, lo) -> dict:
    """The i-th copy event against the i-th span (both in time order,
    as many of each): where the event starts from its span's start and
    end, in us, their quartiles, and a least-squares line of the start
    residual over the window (us a second: the drift of the trace's
    clock from perf_counter, if the copies start at their spans)."""
    import statistics
    r0 = [ts - a for (a, _b), (ts, _n) in zip(placed, got)]
    r1 = [ts - b for (_a, b), (ts, _n) in zip(placed, got)]
    t = [(a - lo) * 1e-6 for a, _b in placed]
    q = statistics.quantiles
    n = len(t)
    slope = None
    if n > 2:
        mt, mr = sum(t) / n, sum(r0) / n
        var = sum((x - mt) ** 2 for x in t)
        slope = (sum((x - mt) * (y - mr) for x, y in zip(t, r0)) / var
                 if var else None)
    return {"start_minus_span_t0_us": q(r0, n=4) if n > 1 else r0,
            "start_minus_span_t1_us": q(r1, n=4) if n > 1 else r1,
            "first_last_start_minus_t0_us": [r0[0], r0[-1]],
            "drift_us_per_s": slope}


def report(rec: dict, run, trace_path: str) -> dict:
    from portbench.core import program
    from portbench.core import trace as tr
    spans = program.spans(rec)
    jobs = [s for s in spans if s["name"] == "job"]
    out = {"jobs": len(jobs), "reads": rec["reads"],
           "window_s": rec["window_s"]}
    names: dict[str, int] = {}
    for s in spans:
        names[s["name"]] = names.get(s["name"], 0) + 1
    out["spans_a_job"] = {k: v / max(len(jobs), 1)
                          for k, v in sorted(names.items())}
    mread = rec["reads"] / 1e6
    stages = {}
    for st in ("prep", "discover", "candidates", "score", "realign",
               "pileup", "genotype"):
        v = program.self_s(spans, f"region.{st}")
        if v is not None:
            stages[st] = v / mread
    region = program.total_s(spans, ("region",))
    wait = program.total_s(spans, ("h2d", "d2h"))
    out["stage_s_per_mread"] = stages
    out["device_wait_s_per_mread"] = wait / mread
    by_site: dict[str, float] = {}
    for s in spans:
        if s["name"] in ("h2d", "d2h"):
            k = f'{s["name"]}.{s["attrs"].get("site")}'
            by_site[k] = by_site.get(k, 0.0) + (s["t1_ns"] - s["t0_ns"]) * 1e-9
    out["device_wait_s_per_mread_by_site"] = {
        k: v / mread for k, v in sorted(by_site.items())}
    out["region_self_s_per_mread"] = (program.self_s(spans, "region")
                                      or 0.0) / mread
    out["region_s_per_mread"] = region / mread
    out["region_remainder_share"] = (
        (program.self_s(spans, "region") or 0.0) / region if region
        else None)
    bench_region = sum(t1 - t0 for n, t0, t1 in rec["spans"]
                       if n == "region")
    out["bench_region_s_per_mread"] = bench_region / mread
    out["region_vs_bench"] = region / bench_region if bench_region else None
    out["job_host_s_per_mread"] = (program.outside_s(spans, "job")
                                   or 0.0) / mread
    out["counters"] = program.counters(rec)
    events, clock = tr.device_events(trace_path, run.inst.side is not None)
    if clock is None:
        out["trace"] = "no clock marker"
        return out
    offset = clock - run.marker_host * 1e6
    lo, hi = run.w0 * 1e6 + offset, run.w1 * 1e6 + offset
    copies = _copies(trace_path, lo, hi)
    for kind in ("h2d", "d2h"):
        got = copies[kind]
        counted = out["counters"].get(f"{kind}.copies", {})
        nbytes = out["counters"].get(f"{kind}.bytes", {})
        placed = sorted((s["t0_ns"] / 1e3 + offset,
                         s["t1_ns"] / 1e3 + offset)
                        for s in spans if s["name"] == kind)
        inside = sum(any(a - TOLERANCE_US <= ts <= b + TOLERANCE_US
                         for a, b in placed) for ts, _ in got)
        out[f"{kind}_match"] = {
            "counted_copies": sum(counted.values()),
            "trace_copies": len(got),
            "counted_bytes": sum(nbytes.values()),
            "trace_bytes": sum(b for _t, b in got),
            "spans": len(placed),
            "share_in_span": inside / len(got) if got else None}
        if len(placed) == len(got) and got:
            out[f"{kind}_match"].update(_residuals(placed, got, lo))
    # a pull starts after its span starts: the least d2h residual is the
    # most the placement can be early; shifted by it, the share of
    # events inside their own span (i-th event, i-th span)
    pairs = {}
    for kind in ("h2d", "d2h"):
        placed = sorted((s["t0_ns"] / 1e3 + offset, s["t1_ns"] / 1e3 + offset)
                        for s in spans if s["name"] == kind)
        if len(placed) == len(copies[kind]) and placed:
            pairs[kind] = list(zip(placed, copies[kind]))
    if pairs.get("d2h"):
        shift = min(ts - a for (a, _b), (ts, _n) in pairs["d2h"])
        out["placement_shift_us"] = shift
        for kind, pr in pairs.items():
            out[f"{kind}_match"]["share_in_own_span_shifted"] = sum(
                a + shift - TOLERANCE_US <= ts <= b + shift + TOLERANCE_US
                for (a, b), (ts, _n) in pr) / len(pr)
    bench = rec["spans"] + [(c["entry"], c["t0"], c["t1"])
                            for c in rec["calls"]]
    mine = program.host_spans(spans)
    out["idle_gaps_bench"] = tr.idle_gaps(events, lo, hi, bench, offset)
    out["idle_gaps_program"] = tr.idle_gaps(events, lo, hi, bench + mine,
                                            offset)
    job_spans = [s for s in mine if s[0] == "job"]
    busy = tr.union((max(s, lo), min(e, hi)) for _n, s, e in events
                    if e > lo and s < hi)
    out["idle_by_span"] = program.idle_by_span(busy, lo, hi, mine, offset)
    out["idle_s"] = (hi - lo) * 1e-6 - sum(e - s for s, e in busy) * 1e-6
    # gaps of 0.5 s or more named outside every layer: inside a job?
    long_outside = []
    for name, secs in out["idle_gaps_program"]:
        if name == "outside the layers" and secs >= 0.5:
            long_outside.append(secs)
    out["long_gaps_outside"] = long_outside
    out["job_walls_s"] = [(s[2] - s[1]) for s in job_spans]
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None)
    args, rest = p.parse_known_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import run as pbrun
    from portbench.core import harness
    kept: dict = {}
    keep_dir = tempfile.mkdtemp(prefix="portbench-report-")
    layer_record, close = harness.Run.layer_record, harness.Run.close

    def recorded(self):
        kept["rec"] = layer_record(self)
        return kept["rec"]

    def closing(self):
        kept["run"] = self
        if getattr(self, "trace_path", None):
            kept["trace"] = shutil.copy(self.trace_path, keep_dir)
        close(self)

    harness.Run.layer_record, harness.Run.close = recorded, closing
    try:
        rc = pbrun.main(rest + ["--trace", "1"])
        if rc != 0 or "trace" not in kept:
            return rc or 1
        out = report(kept["rec"], kept["run"], kept["trace"])
    finally:
        shutil.rmtree(keep_dir, ignore_errors=True)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
