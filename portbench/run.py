#!/usr/bin/env python3
"""The benchmark of strelka_tpu_torch, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell
asks for. Set-up makes the cell's inputs from the seed, loads (and on a
checkout's first run builds) the port's kernels and runs one warm-up
job on the same inputs; the window then runs whole CLI jobs for
--seconds and finishes the job in flight. The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device, and with
--trace 1 breakdown); the numbers compared for ``correct`` close both
that object (``checks``) and standard error, each beside its limit.

--trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer ones. Options for the benchmark's own tests and for setting
limits (no check passes them): --device cpu (a rehearsal on the CPU,
not a measurement), --contig-bp (a smaller input), --control (the
reference in bfloat16 in the program's place).

For steady runs the process keeps its host thread pools at THREADS
(OpenMP, BLAS, torch's intra- and inter-op pools; the port's BGZF
decoder keeps its own) and freezes what set-up made out of the
collector's way before the window.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "strelka_tpu")
THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--contig-bp", type=int, default=None)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the run may not hold: JAX,
    its libraries and the JAX package (compared whole: the port's name
    starts with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # every cache of the program inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "build", "portbench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    from portbench.core import harness, manifest
    man = manifest.load(ROOT)
    cell = harness.Cell(man, args.workload)
    if args.contig_bp:
        cell.config["genome"]["contig_bp"] = args.contig_bp
    import torch
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(1)
    if args.device == "cuda":
        want = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            print(f"portbench: {want} CUDA device(s) needed, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  " found", file=sys.stderr)
            return 2
    result = harness.execute(cell, args.seed, args.seconds,
                             bool(args.trace), args.device,
                             control=args.control, t_start=T_START, man=man)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"calls {c['calls']}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
