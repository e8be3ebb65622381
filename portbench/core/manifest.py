"""What BENCHMARK.json names, found by name under portbench/.

- a configuration: ``configs/<name>.json`` (its ``file`` in the manifest);
- a traffic mix: ``traffic/<name>.json``;
- a per-layer metric: ``metrics/<name>.py``, a reader with
  ``read(run) -> float | None`` (None: nothing to read in this run).

A later cell, mix or metric is new files and new manifest entries; no
file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench: str = BENCH) -> dict:
    with open(os.path.join(bench, "traffic", f"{name}.json")) as f:
        return json.load(f)


def reader(name: str, bench: str = BENCH):
    """The module of metrics/<name>.py."""
    path = os.path.join(bench, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(man: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones
    (trace on): those whose ``workloads`` list it, or that have none."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
