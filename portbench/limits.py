#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process:

    python3 portbench/limits.py --workload <cell> --seeds <n>,<n>,...

For each seed: set-up as a run's (the inputs, the warm-up job), then one
sound job and the numbers compared for ``correct`` on it; the control
(the reference in bfloat16 in the program's place) on the same calls;
and one job under each fault of the timed path (core/instrument.py:
FAULTS). One JSON line a reading on standard output, then a summary
line of each number's least and largest reading by kind. No check runs
this; PERF.md gives the readings that each limit was set from.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="altered,half,unchanged,"
                   "records_half,records_none")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--contig-bp", type=int, default=None)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cache = os.path.join(ROOT, "build", "portbench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    from portbench.core import harness, manifest
    man = manifest.load(ROOT)
    cell = harness.Cell(man, args.workload)
    if args.contig_bp:
        cell.config["genome"]["contig_bp"] = args.contig_bp
    faults = [f for f in args.faults.split(",") if f]
    summary: dict = {}

    def emit(seed, kind, readings, rc=0):
        line = {"seed": seed, "kind": kind, "rc": rc,
                "readings": {k: v[0] for k, v in readings.items()}}
        print(json.dumps(line), flush=True)
        for k, v in line["readings"].items():
            lo, hi = summary.setdefault(kind, {}).get(k, (v, v))
            summary[kind][k] = (min(lo, v), max(hi, v))

    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell, seed, 0.0, False, args.device)
        try:
            run.setup()
            run.inst.install_record_faults()
            job = run.job("sound", run.data)
            emit(seed, "sound", run.readings([job]), job["rc"])
            emit(seed, "control", run.readings([job], control=True))
            for fault in faults:
                run.inst.clear()
                run.inst.fault = fault
                job = run.job(fault, run.data)
                run.inst.fault = "none"
                emit(seed, fault, run.readings([job]), job["rc"])
            run.inst.restore()
        finally:
            run.close()
    print(json.dumps({"summary": summary, "limits": cell.config["limits"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
