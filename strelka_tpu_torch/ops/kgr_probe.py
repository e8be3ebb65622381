"""Timing probe of KG-R's and KG-SB's designs on the card.

    python -m strelka_tpu_torch.ops.kgr_probe [--parent DIR] [variant ...]

Builds KG-R (csrc/snv_rna_tile.cu) and KG-SB (csrc/snv_strand_bias.cu),
and variants of KG-R that are textual edits of its source, into
build/kgr_probe/ (one nvcc a library, started together), and times them
by the replay of 20 launches captured in one CUDA graph, the least of
three replays, in two rounds. `--parent DIR` names a directory that
holds another tree's csrc (a `git archive <commit>
strelka_tpu_torch/csrc` unpacked there); its variants are named
``parent`` and ``parent-<edit>``. The inputs, made from seed 14:

- ``kgr_cli``: KG-R on a chunk like phase 14's first (131,072 x 64,
  int16 qual, every call at one quality, 1% alt, 20-64 used calls a
  row, deltas on a tenth of them, 9 het-ratio steps);
- ``kgsb_p4``: KG-SB on 499 rows like phase 4's first call (64 calls,
  deltas, no extension, every target a het);
- ``kgsb_p14``: KG-SB on 512 rows like phase 14's (the extension, 9
  steps, four in five targets a het);
- ``empty``: a kernel that does nothing, launched on KG-SB's grid at
  ``kgsb_p4`` (KG-SB's launch floor).

KG-R's edits, timed only (each computes another function):

- ``nosums``: no walk over the row's calls (nothing staged, counted or
  summed);
- ``nolse``: no logsumexp (the het lhood plus one sum);
- ``nodot``: no walk over the live slots;
- ``notail``: no float64 tail (the lhoods stored alone);
- ``bare``: all four;
- ``nocount``: no histogram count (the dot walk sees no live slot);
- ``minb3``: launch bounds of 3 blocks an SM (85 registers);
- ``unroll8``: the walk's call loop unrolled by 8, not 4.

Prints ptxas's registers and spills of each build, then one JSON line a
variant and round.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from .. import convert
from . import snv_kernels as snk
from .kgh_probe import graph_ms

OUT = os.path.join(_build.BUILD_DIR, "kgr_probe")
EXT, INC = 0.45, 0.0501           # 9 het-ratio steps, RNA mode's
L, D = 131072, 64

# KG-R's edits: {name: [(text of the source, its replacement, count)]},
# the current source's and the first design's (one sum a lane: the
# redesign's parent, under --parent)
_STAGE = "            stage_row(batch, batch.n, lh, v, row, o, lane);\n"
_STORE = "            if (lane < kGt) o.lhood[row * kGt + lane] = lh;\n"
_TAIL = "        batch_tail(s, batch, step, o, lane);\n"
EDITS = {
    "current": {
        "nosums": [("            for (int it0 = 0; it0 < n_items; "
                    "it0 += kPass) {",
                    "            for (int it0 = 0; it0 < 0; it0 += kPass) {",
                    1)],
        "nolse": [("            lh = lse_spread(",
                   "            if (false) lh = lse_spread(", 1)],
        "nodot": [("            for_live_slots(h, lane,",
                   "            if (false) for_live_slots(h, lane,", 1)],
        "notail": [(_STAGE, _STORE, 1), (_TAIL, "", 1)],
        "nocount": [("                    if (it0 == 0) count_call(h, c.m, "
                     "c.b, c.q);\n", "", 1)],
        "minb3": [("__launch_bounds__(kWarps * 32, 2)",
                   "__launch_bounds__(kWarps * 32, 3)", 1)],
        "unroll8": [("snv_xla_math.cuh",
                     "#pragma unroll 4\n            for (int i = 0; i < nj;",
                     "#pragma unroll 8\n            for (int i = 0; i < nj;",
                     1)],
    },
    "first": {
        "nosums": [("            row_sums(win, n_items, lane, load, prep, "
                    "term, variant, res);\n", "", 1)],
        "nolse": [("het_combine(lh, res + (g - kBases) * 2 * n_steps,\n"
                   "                                 n_steps)",
                   "__fadd_rn(lh, res[(g - kBases) * 2 * n_steps])", 1)],
        "nodot": [("            for_live_slots(h, lane,",
                   "            if (false) for_live_slots(h, lane,", 1)],
        "notail": [(_STAGE, _STORE, 1), (_TAIL, "", 1)],
    },
}
PARTS = ("nosums", "nolse", "nodot", "notail")
_EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
    empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
"""


def variant_sources(name: str, parent: str | None) -> dict:
    """{file: text} of variant `name`: snv_rna_tile.cu, the tree's
    snv_strand_bias.cu for a variant with no edits, and each header that
    an edit changes (an edit of four items names its file); raises where
    an edit does not apply as often as it should."""
    tree = _build.CSRC
    if name.startswith("parent"):
        if parent is None:
            raise ValueError(f"variant {name} needs --parent")
        tree = parent
    base = name.split("-", 1)[1] if name.startswith("parent-") else (
        "" if name in ("source", "parent") else name)
    table = EDITS["first" if name.startswith("parent") else "current"]
    edits = [] if not base else (
        sum((table[p] for p in PARTS), []) if base == "bare"
        else table[base])
    edits = [e if len(e) == 4 else ("snv_rna_tile.cu", *e) for e in edits]
    files = {"snv_rna_tile.cu"} | {e[0] for e in edits}
    if not base:
        files.add("snv_strand_bias.cu")
    out = {}
    for fname in sorted(files):
        with open(os.path.join(tree, fname)) as f:
            text = f.read()
        for _, old, new, n in (e for e in edits if e[0] == fname):
            if text.count(old) != n:
                raise ValueError(f"variant {name}: {fname} no longer "
                                 f"holds {old.strip()[:60]!r} {n} times")
            text = text.replace(old, new)
        out[fname] = text
    return out


def _ptxas(out: str) -> dict:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", out)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", out)]
    return {"registers": regs, "spill_stores": spills}


def build(names, parent) -> dict:
    """{(name, source): (ctypes library, ptxas's report)}, one nvcc a
    library, all started together; each variant's files in its own
    directory under build/kgr_probe/, which its includes search first,
    the other headers from the variant's tree."""
    jobs = {}
    for name in names:
        inc = parent if name.startswith("parent") else _build.CSRC
        vdir = os.path.join(OUT, name)
        os.makedirs(vdir, exist_ok=True)
        for fname, text in variant_sources(name, parent).items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
            if fname.endswith(".cu"):
                jobs[name, fname[:-3]] = (os.path.join(vdir, fname), inc)
    os.makedirs(OUT, exist_ok=True)
    jobs["empty", "empty"] = (os.path.join(OUT, "empty.cu"), _build.CSRC)
    with open(jobs["empty", "empty"][0], "w") as f:
        f.write(_EMPTY)
    running = {}
    for key, (path, inc) in jobs.items():
        lib = os.path.join(OUT, f"lib{key[0]}.{key[1]}.so")
        running[key] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-Xptxas", "-v",
             "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, p) in running.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = (ctypes.CDLL(lib), _ptxas(out))
    return libs


def inputs(dev):
    """The probe's tiles, from seed 14: KG-R's chunk and the two
    strand-bias calls' rows, as the wrappers take them."""
    rng = np.random.default_rng(14)

    def lanes(n):
        ref = rng.integers(0, 4, n).astype(np.int32)
        base = np.where(rng.random((n, D)) < 0.01,
                        rng.integers(0, 4, (n, D)),
                        ref[:, None]).astype(np.int8)
        depth = rng.integers(20, D + 1, n)
        mask = np.arange(D)[None, :] < depth[:, None]
        dd = np.where(mask & (rng.random((n, D)) < 0.1),
                      -rng.random((n, D)) * 0.5, 0.0).astype(np.float32)
        t = [torch.from_numpy(a).to(dev) for a in (
            base, np.full((n, D), 32, np.int16), mask,
            rng.random((n, D)) < 0.5, ref, dd)]
        return dict(zip(("base", "qual", "mask", "fwd", "ref", "dd"), t))
    kgr = lanes(L)
    sb = []
    for n, het in ((499, 1.0), (512, 0.8)):
        x = lanes(n)
        x["tgt"] = torch.from_numpy(np.where(
            rng.random(n) < het, rng.integers(4, 10, n),
            rng.integers(0, 4, n)).astype(np.int32)).to(dev)
        x["lt"] = torch.from_numpy(
            rng.normal(-50, 10, n).astype(np.float32)).to(dev)
        sb.append(x)
    return kgr, sb


def empty_launch_ms(blocks: int, threads: int) -> float:
    """Device ms of an empty kernel's launch on a grid of `blocks` blocks
    of `threads` (graph_ms): a launch floor. Builds build/kgr_probe/
    libempty.empty.so first."""
    lib = os.path.join(OUT, "libempty.empty.so")
    if not os.path.exists(lib):
        os.makedirs(OUT, exist_ok=True)
        src = os.path.join(OUT, "empty.cu")
        with open(src, "w") as f:
            f.write(_EMPTY)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(lib).empty_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return graph_ms(lambda: fn(blocks, threads,
                               torch.cuda.current_stream().cuda_stream))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="KG-R's and KG-SB's design variants timed on the card")
    ap.add_argument("variants", nargs="*",
                    default=["source", *PARTS, "bare"],
                    help="source, parent, nosums, nolse, nodot, notail, "
                         "bare, parent-<edit> (default: source and its "
                         "edits)")
    ap.add_argument("--parent", help="a directory holding another tree's "
                                     "csrc")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kgr_probe needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build(opts.variants, opts.parent)
    for (name, src), (_, rep) in libs.items():
        print(json.dumps({"variant": name, "source": src, **rep}),
              flush=True)
    from ..models import snv_digt as sd
    tabs = convert.device_tables(0.001, dev)
    het = sd._xla_tables(EXT, INC, dev)["het_vf"]
    vals = sd._xla_tables(EXT, INC, dev)["call_vals"]
    n_steps = het.shape[0]
    kgr, sb = inputs(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = [torch.empty((L, 10), dtype=torch.float32, device=dev),
            *[torch.empty(L, **i32) for _ in range(5)],
            torch.empty((L, 10), **i32),
            torch.empty(L, dtype=torch.float64, device=dev)]
    tail = [tabs["snv_qtab"].data_ptr(), tabs["e0_tab"].data_ptr(),
            *[tabs[f"prior_{k}"].data_ptr() for k in snk._PRIORS], L,
            *[t.data_ptr() for t in outs]]
    sb_out = torch.empty(512, dtype=torch.float32, device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def calls(name):
        out = {}
        lib = libs[name, "snv_rna_tile"][0]
        kr = lib.snv_rna_tile_launch
        kr.restype, kr.argtypes = ctypes.c_int, snk._ARGTYPES["snv_rna_tile"]
        out["kgr_cli"] = lambda: kr(
            kgr["base"].data_ptr(), kgr["qual"].data_ptr(), 2,
            kgr["mask"].data_ptr(), D, het.data_ptr(), n_steps,
            kgr["ref"].data_ptr(), None, kgr["dd"].data_ptr(), *tail,
            stream())
        if (name, "snv_strand_bias") in libs:
            ks = libs[name, "snv_strand_bias"][0].snv_strand_bias_tile_launch
            ks.restype = ctypes.c_int
            ks.argtypes = snk._ARGTYPES["snv_strand_bias_tile"]
            for tag, x, h, n in (("kgsb_p4", sb[0], None, 0),
                                 ("kgsb_p14", sb[1], het, n_steps)):
                def f(x=x, h=h, n=n):
                    return ks(x["base"].data_ptr(), x["qual"].data_ptr(), 2,
                              x["fwd"].data_ptr(), x["mask"].data_ptr(), D,
                              x["ref"].data_ptr(), x["tgt"].data_ptr(),
                              x["lt"].data_ptr(), x["dd"].data_ptr(),
                              vals.data_ptr(),
                              None if h is None else h.data_ptr(), n,
                              x["base"].shape[0], sb_out.data_ptr(),
                              stream())
                out[tag] = f
        return out
    empty = libs["empty", "empty"][0].empty_launch
    empty.restype = ctypes.c_int
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for rnd in range(2):
        for name in opts.variants:
            row = {}
            for k, f in calls(name).items():
                rc = f()
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"{name} {k}: CUDA error {rc}")
                row[k] = graph_ms(f)
            print(json.dumps({"variant": name, "round": rnd, **row}),
                  flush=True)
        print(json.dumps({"variant": "empty", "round": rnd,
                          "blocks": (499 + 3) // 4, "threads": 128,
                          "ms": graph_ms(lambda: empty(125, 128,
                                                       stream()))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
