"""Timing probe of KE-F's fit entry on the card: where a step's time goes.

    python tools/kef_probe.py [variant ...]

Builds the fit entry (strelka_tpu_torch/csrc/error_fit_step.cu) and
variants of it that are textual edits of its source, into
build/kef_probe/ (one nvcc a library, started together), and times each
whole 600-step fit from its start (the parameters, zero moments: the
state reset before each launch, outside the CUDA events around it), the
mean of five launches after a warm one, in two rounds, at four seeded
contexts (fit_kernels.synthetic_counts, seed 9): ``p1`` (one pattern:
the chain floor), ``p145`` (one block, like phase 15's contexts of
93-275 patterns), ``p4050`` (a cluster of 16 blocks) and ``p107k``
(107,434 patterns, 210 blocks, the grid regime). The variants:

- ``source``: the fit entry as built; its state after a fit is held bit
  for bit against the port's own launch (fit_kernels.error_fit_run);
- ``grid``: the source on the grid regime (a cooperative launch and the
  counter barrier) where fit_grid picks the cluster regime (p1, p145,
  p4050), held bit for bit against the port's launch too;

and the edits, timed only (each computes another function):

- ``noterms``: no locus terms (each thread adds zeros: no loads, no
  transcendentals of the loci);
- ``nobarrier``: the step's barrier a block barrier (no cluster or grid
  barrier; each block stages the partials where they lie);
- ``notail``: no scalar tail (no gradient chain, Adam, best step or next
  step's rates: every step at the first step's rates);
- ``bare``: all three (the loop, its block barriers and the folds).

Prints ptxas's registers and spills of each build, then one JSON line a
variant, context and round: ms a fit and us a step. Exits 1 where a
build, a launch or a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from strelka_tpu_torch import _build  # noqa: E402
from strelka_tpu_torch.models import error_fit as ef  # noqa: E402
from strelka_tpu_torch.ops import fit_kernels as fk  # noqa: E402

OUT = os.path.join(_build.BUILD_DIR, "kef_probe")
SOURCE = "error_fit_step.cu"
STEPS = 600
CONTEXTS = {"p1": (9, 1, 5), "p145": (9, 150, 8), "p4050": (9, 4500, 60),
            "p107k": (9, 130_000, 500)}

_TERMS = "                locus_terms(v, li, ld, lr, ln, lcl, c, term);\n"
EDITS = {
    "noterms": [(_TERMS,
                 "#pragma unroll\n"
                 "                for (int k = 0; k < kSums; ++k) "
                 "term[k] = 0.0;\n", 1)],
    "nobarrier": [("            if (blocks > 1)\n"
                   "                cluster.sync();\n"
                   "            else\n"
                   "                __syncthreads();\n",
                   "            __syncthreads();\n", 1),
                  ("*cluster.map_shared_rank(&xpart[par][i % kSums],\n"
                   "                                                    "
                   "i / kSums);",
                   "xpart[par][i % kSums];", 1),
                  ("            grid_barrier(a.arrivals, "
                   "static_cast<unsigned>(t) * blocks);\n",
                   "            __syncthreads();\n", 1)],
    "notail": [("            if (lane < 3) {\n",
                "            if (false) {\n", 1),
               ("            if (lane == 0) {\n"
                "                const double v = -tot[0];\n",
                "            if (false) {\n"
                "                const double v = -tot[0];\n", 1),
               ("        const Rates& r = rs[par];\n",
                "        const Rates& r = rs[1];\n", 1)],
}
EDITS["bare"] = [e for k in ("noterms", "nobarrier", "notail")
                 for e in EDITS[k]]
VARIANTS = ("source", "grid", *EDITS)
# the variants that compute the fit entry's own function
EXACT = ("source", "grid")


def variant_source(name: str) -> str:
    """The fit entry's source with variant `name`'s edits; raises where
    an edit does not apply as often as it should."""
    with open(os.path.join(_build.CSRC, SOURCE)) as f:
        text = f.read()
    for old, new, count in EDITS.get(name, []):
        if text.count(old) != count:
            raise ValueError(f"variant {name}: edit {old[:40]!r} found "
                             f"{text.count(old)} times, not {count}")
        text = text.replace(old, new)
    return text


def build(names) -> dict:
    """{variant: its launch function}, each built from its source in
    build/kef_probe/<variant>/ (beside a copy of csrc's headers), one
    nvcc a library at once ("grid" launches the source's); prints
    ptxas's registers and spills."""
    procs = {}
    for name in {"source" if n == "grid" else n for n in names}:
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for h in os.listdir(_build.CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(_build.CSRC, h), d)
        src = os.path.join(d, SOURCE)
        with open(src, "w") as f:
            f.write(variant_source(name))
        lib = os.path.join(d, "liberror_fit_step.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{text}")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        print(json.dumps({"variant": name, "registers": regs,
                          "spill_store_bytes": spills}), flush=True)
        fn = ctypes.CDLL(lib).error_fit_run_launch
        fn.restype = ctypes.c_int
        fn.argtypes = fk._ARGTYPES["error_fit_run_launch"]
        fns[name] = fn
    if "grid" in names:
        fns["grid"] = fns["source"]
    return {n: fns[n] for n in names}


def launcher(run, fn, dev):
    """A launch of `run`'s operands through launch function `fn`."""
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = fn(*run._args, stream)
        if rc != 0:
            raise RuntimeError(f"a variant's launch failed: CUDA error {rc}")
    return launch


def fit_ms(run, launch, reps: int = 5) -> float:
    """Device ms of one whole fit of `run` from its start through
    `launch`: the mean of `reps` launches after a warm one, each reset
    outside the CUDA events around it."""
    run.reset()
    launch()
    total = 0.0
    for _ in range(reps):
        run.reset()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        launch()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kef_probe needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    fns = build(opts.variants)
    lt = float(np.log(0.001))
    c = ef.kernel_consts(lt, 0.05)
    p0 = torch.tensor([np.log(1e-3), np.log(1e-3), np.log(0.5)],
                      dtype=torch.float64)
    runs = {}
    for ctx, (seed, n, ref_max) in CONTEXTS.items():
        cc = fk.synthetic_counts(seed, n, ref_max)
        obs = [torch.as_tensor(np.asarray(a, np.float64), device=dev)
               for a in (cc.ref_obs, cc.alt_obs, cc.instance_count)]
        want = fk.error_fit_run(*obs, p0, c, STEPS)
        blocks, per, regime = want.grid
        runs[ctx] = {name: fk.FitRun(*obs, p0, c, STEPS) for name in fns
                     if name != "grid"}
        if "grid" in fns and regime == "cluster":
            runs[ctx]["grid"] = fk.FitRun(*obs, p0, c, STEPS,
                                          grid=(blocks, per, "grid"))
        for name, run in runs[ctx].items():
            if name in EXACT:
                run.reset()
                launcher(run, fns[name], dev)()
                if not torch.equal(run.state.view(torch.int64),
                                   want.state.view(torch.int64)):
                    print(f"{name} at {ctx}: the fit differs from the "
                          f"port's launch", file=sys.stderr)
                    return 1
    for rnd in (1, 2):
        for ctx, by_name in runs.items():
            for name, run in by_name.items():
                ms = fit_ms(run, launcher(run, fns[name], dev))
                print(json.dumps({
                    "variant": name, "context": ctx, "round": rnd,
                    "patterns": run._args[3], "grid": list(run.grid),
                    "ms_a_fit": ms, "us_a_step": ms * 1e3 / STEPS}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
