"""Timing probe of KG-H's design on the card.

    python -m strelka_tpu_torch.ops.kgh_probe [variant ...]

Builds variants of csrc/snv_hist_tile.cu, each a textual edit of the
source, into build/kgh_probe/ (one nvcc per variant, started together),
and times both entries of each beside the source as it stands: device
ms by the replay of 20 launches captured in one CUDA graph, the least of
three replays, in two rounds. The tiles, made from seed 9 and 5: the
dense entry on a random D = 32 tile's int8 histogram (131,072 rows, 45
qualities, about 19 live slots a row; ``dense3``) and the lanes entry
on its lanes (``lanes3``); the lanes entry on a chunk like the germline
CLI's (131,072 x 64, int16 qual, every call at one quality, 10% alt,
half the lanes masked: 2-4 live slots a row; ``lanes_cli``) and the
dense entry on that chunk's histogram (``dense_cli``). Variants, timed
only (the ablations compute another function):

- ``notail``: no tail (the walk and the lhoods alone);
- ``batch1``: the tail one row at a time instead of three;
- ``l2``: every warp's rows among 1,024 rows past the tile's empty
  ones, so that the counts and the row inputs stay in L2;
- ``warps5``, ``warps6``: launch bounds of 5 and 6 blocks an SM (fewer
  registers, more resident warps);
- ``setsplit``: the two result sets one after the other, not side by
  side;
- ``shflsum``: the 10-wide sums by shuffles, not through shared memory;
- ``majority``: the lanes entry counts a step's most common bin by a
  ballot and one add, the rest by shared atomics.

Prints ptxas's registers of each build (the four kernels: dense int8 and
int32, lanes uint8 and int16), then one JSON line a variant and round.
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

SOURCE = os.path.join(_build.CSRC, "snv_hist_tile.cu")
OUT = os.path.join(_build.BUILD_DIR, "kgh_probe")
_LB = "__global__ void __launch_bounds__(kWarps * 32)\n"
_COUNT = """            for (long long d = lane; d < D; d += 32) {
                const long long i = row * D + d;
                const bool m = mask[i];
                const int b = base[i];
                const int q = qual[i];
                if (m && b >= 0 && b < kBases)
                    atomicAdd(&h[(q < 0 ? 0 : (q > kQ - 1 ? kQ - 1 : q))
                                 * kBases + b], 1);
            }"""
_MAJORITY = """            for (long long d0 = 0; d0 < D; d0 += 32) {
                const long long d = d0 + lane;
                int bin = -1;
                if (d < D) {
                    const long long i = row * D + d;
                    const int b = base[i];
                    const int q = qual[i];
                    if (mask[i] && b >= 0 && b < kBases)
                        bin = (q < 0 ? 0 : (q > kQ - 1 ? kQ - 1 : q))
                              * kBases + b;
                }
                const unsigned vm = __ballot_sync(kAll, bin >= 0);
                if (vm) {
                    const int lead = __ffs(vm) - 1;
                    const int lb = __shfl_sync(kAll, bin, lead);
                    const unsigned same = __ballot_sync(kAll, bin == lb);
                    if (lane == lead) atomicAdd(&h[lb], __popc(same));
                    else if (bin >= 0 && bin != lb) atomicAdd(&h[bin], 1);
                }
            }"""
_SUM = """    x[lane] = v;
    __syncwarp();
    double s = x[base];
#pragma unroll
    for (int g = 1; g < kGt; ++g) s = __dadd_rn(s, x[(base + g) & 31]);
    __syncwarp();     // the scratch is rewritten
    return s;"""
_SHFL_SUM = """    double s = __shfl_sync(kAll, v, base);
#pragma unroll
    for (int g = 1; g < kGt; ++g)
        s = __dadd_rn(s, __shfl_sync(kAll, v, base + g));
    return s;"""
_STAGE = ("            stage_row(batch, batch.n, add_smis(s, lh, v, in, g), "
          "v, row, o,\n                      lane);\n")
_L2_ROW = "(4096 + (row & 1023))"
# name -> [(text of the source, its replacement, count), ...]
VARIANTS = {
    "notail": [(_STAGE, "            if (lane < kGt) "
                        "o.lhood[row * kGt + lane] = lh;\n", 2),
               ("        batch_tail(s, batch, step, o, lane);\n", "", 2)],
    "batch1": [("constexpr int kBatch = 3;", "constexpr int kBatch = 1;", 1)],
    "l2": [("if (row < L) c.load(hist + row * kSlots, lane);",
            f"if (row < L) c.load(hist + {_L2_ROW} * kSlots, lane);", 1),
           ("c.load(hist + (row + step) * kSlots, lane);",
            "c.load(hist + (4096 + ((row + step) & 1023)) * kSlots, lane);",
            1),
           ("const long long i = row * D + d;",
            f"const long long i = {_L2_ROW} * D + d;", 1),
           ("load_row(in, row)", f"load_row(in, {_L2_ROW})", 2)],
    "warps5": [(_LB, "__global__ void __launch_bounds__(kWarps * 32, 5)\n",
                2)],
    "warps6": [(_LB, "__global__ void __launch_bounds__(kWarps * 32, 6)\n",
                2)],
    "setsplit": [("#pragma unroll\n    for (int set = 0;",
                  "#pragma unroll 1\n    for (int set = 0;", 1)],
    "shflsum": [(_SUM, _SHFL_SUM, 1)],
    "majority": [(_COUNT, _MAJORITY, 1)],
}
L = 131072


def variant_source(name: str) -> str:
    """The source with `name`'s edits (none for "source"); raises if one
    does not apply as often as it should."""
    with open(SOURCE) as f:
        text = f.read()
    for old, new, n in VARIANTS.get(name, []):
        if text.count(old) != n:
            raise ValueError(f"variant {name}: the source no longer holds "
                             f"{old.strip()[:60]!r} {n} times")
        text = text.replace(old, new)
    return text


def build(names) -> dict:
    """{name: (ctypes library, ptxas's registers)}, one nvcc each, all
    started together."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
             "-Xptxas", "-v", "-o", os.path.join(OUT, f"lib{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", out)]
        libs[name] = (ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")), regs)
    return libs


def tiles(dev):
    """The probe's two tiles: ((base, qual, mask) lanes, ref_gt, s_mis,
    int8 histogram) of the random D = 32 tile and of the CLI-like
    chunk."""
    from ..models import snv_digt as sd
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, 32)) < 0.3, rng.integers(-1, 5, (L, 32)),
                    np.minimum(ref, 3)[:, None]).astype(np.int8)
    qual = rng.integers(0, 45, (L, 32)).astype(np.int16)
    mask = rng.random((L, 32)) < 0.8
    mask[:L // 50] = False
    smis = np.where(rng.random((L, 4)) < 0.05, rng.random((L, 4)) * 0.5,
                    0.0).astype(np.float32)
    rng = np.random.default_rng(5)
    cref = rng.integers(0, 4, L).astype(np.int32)
    cbase = np.where(rng.random((L, 64)) < 0.1, rng.integers(0, 4, (L, 64)),
                     cref[:, None]).astype(np.int8)
    out = []
    for lanes, r, s in (((base, qual, mask), ref, smis),
                        ((cbase, np.full((L, 64), 32, np.int16),
                          rng.random((L, 64)) < 0.5), cref,
                         np.zeros((L, 4), np.float32))):
        t = [torch.from_numpy(a).to(dev) for a in (*lanes, r, s)]
        out.append((t[:3], t[3], t[4],
                    sd._tile_hist(*t[:3]).to(torch.int8)))
    return out


def graph_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device ms a call of fn: `iters` calls captured in one CUDA graph,
    its replay timed by CUDA events, the least of `reps` replays."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    best = float("inf")
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        torch.cuda.synchronize()
        best = min(best, s.elapsed_time(e) / iters)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="KG-H's design variants timed on the card")
    ap.add_argument("variants", nargs="*", default=sorted(VARIANTS),
                    help=f"of {sorted(VARIANTS)} (default: all)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kgh_probe needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    names = ["source", *opts.variants]
    libs = build(names)
    for name, (_, regs) in libs.items():
        print(json.dumps({"variant": name, "registers": regs}), flush=True)
    tabs = convert.device_tables(0.001, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = [torch.empty((L, 10), dtype=torch.float32, device=dev),
            *[torch.empty(L, **i32) for _ in range(5)],
            torch.empty((L, 10), **i32),
            torch.empty(L, dtype=torch.float64, device=dev)]
    tail = [tabs["snv_qtab"].data_ptr(), tabs["e0_tab"].data_ptr(),
            *[tabs[f"prior_{k}"].data_ptr() for k in snk._PRIORS], L,
            *[t.data_ptr() for t in outs]]
    shapes = tiles(dev)

    def calls(lib):
        dense = lib.snv_hist_tile_launch
        dense.restype, dense.argtypes = (ctypes.c_int,
                                         snk._ARGTYPES["snv_hist_tile"])
        lanes = lib.snv_lanes_tile_launch
        lanes.restype, lanes.argtypes = (ctypes.c_int,
                                         snk._ARGTYPES["snv_lanes_tile"])
        out = {}
        for tag, (lns, ref, smis, hist) in zip(("3", "_cli"), shapes):
            def d(hist=hist, ref=ref, smis=smis):
                return dense(hist.data_ptr(), 1, ref.data_ptr(), None,
                             smis.data_ptr(), *tail,
                             torch.cuda.current_stream().cuda_stream)

            def n(lns=lns, ref=ref, smis=smis):
                b, q, m = lns
                return lanes(b.data_ptr(), q.data_ptr(), 2, m.data_ptr(),
                             b.shape[1], ref.data_ptr(), None,
                             smis.data_ptr(), *tail,
                             torch.cuda.current_stream().cuda_stream)
            out[f"dense{tag}"], out[f"lanes{tag}"] = d, n
        return out
    for rnd in range(2):
        for name, (lib, _) in libs.items():
            row = {k: graph_ms(f) for k, f in calls(lib).items()}
            print(json.dumps({"variant": name, "round": rnd, **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
