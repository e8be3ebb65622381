"""Timing probe of the tensor-core K1's design on the card.

    python -m strelka_tpu_torch.ops.score_tc_probe [variant ...]

Builds variants of csrc/score_best_offsets_tc.cu, each a textual edit of
the source, into build/tc_probe/ (one nvcc per variant, started
together), and times each beside the source as it stands at the main
path's shapes: CUDA events around 50 launches back to back, after
warm-up, in turns (source, variants, variants reversed, source; the
least of each kernel's two times). Variants:

- ``wg2``, ``wg1``: a CTA capped at 2 or 1 warpgroups instead of 4,
  and ``nofence``: no accumulator fence in front of each step's wgmma
  (exact: held bit for bit to the plain version);
- the stage ablations, wrong by design and timed only: ``nomma`` (no
  wgmma), ``nobw`` (no one-hot expansion of the window), ``nocopy`` (no
  window copies or waits in the loop), ``noa`` (no expansion of the
  reads).

Prints what ptxas reports for the source (registers, spills, injected
waits), then one JSON line per shape: each kernel's ms, and K1-s's.

    python -m strelka_tpu_torch.ops.score_tc_probe --hap [variant ...]

times KX-H instead (the same source's hap output form, held to its plain
version) at the variants runner's hap shapes, without K1-s's column.

    python -m strelka_tpu_torch.ops.score_tc_probe --now G [G ...]

times KX-A noW (score_variants.score_ablation, as built) at each group
size G beside K1, at the harness's shape and the main path's two: each
held to now_best_offsets, device ms by the replay of 50 calls captured
in one CUDA graph, in turns (K1, the G, the G reversed, K1; the least of
each's two times). One JSON line a shape, with the plan it took. It
shows what a group's shared window saves against what the group's
fewer CTAs cost.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from .. import _build
from .. import device as devmod
from . import score_variants as sv
from .score_kernel import exact_best_offsets

SOURCE = os.path.join(_build.CSRC, "score_best_offsets_tc.cu")
OUT = os.path.join(_build.BUILD_DIR, "tc_probe")
_CAP = "constexpr int kMaxWg = 4;"
_MMA = """                wgmma_u8(acc, desc(a_op + 2 * s * kCore, kCore, sbo_a),
                         desc(b_op + 2 * s * kCore, kCore, 8 * kChunkK),
                         kc > 0 || s > 0);"""
# name -> (exact, [(text of the source, its replacement), ...])
VARIANTS = {
    "wg2": (True, [(_CAP, "constexpr int kMaxWg = 2;")]),
    "wg1": (True, [(_CAP, "constexpr int kMaxWg = 1;")]),
    "nofence": (True, [("            fence_acc(acc);\n"
                         "            wgmma_fence();",
                         "            wgmma_fence();")]),
    "nomma": (False, [(_MMA, "                acc[s] += (int)(size_t)a_op + "
                             "(int)(size_t)b_op;")]),
    "nobw": (False, [("            expand_w<kHap>(a, it + 1, raw + s1 * "
                      "kRawBytes,\n                           bw + (kSlab ? "
                      "it + 1 : s1) * kOpBytes);\n", "")]),
    "nocopy": (False, [("        if (it + 2 < total)\n            stage_window",
                        "        if (false)\n            stage_window"),
                       ("            mbar_wait(&full[s1], ((it + 1) / kStages)"
                        " & 1);\n", "")]),
    "noa": (False, [("    expand_a<kSrc>(a, b, r0, n_reads, 0,\n"
                     "                   a.resident ? a.Lp / 4 : kChunkBases"
                     " / 4, as, sbo_a);\n", "")]),
}
SHAPES = [(256, r, 160, w) for r in (32, 128, 512) for w in (256, 320)] + [
    (256, 128, 128, 192), (128, 32, 128, 192), (512, 128, 128, 128),
    (256, 32, 160, 192)]
# KX-H's loci, reads, read length and window width (x HAP_WINDOWS)
HAP_SHAPES = [(256, 128, 128, 128), (128, 128, 160, 256)]
# noW's: the harness's, the main path's and its top launch shape
NOW_SHAPES = [(512, 128, 128, 128), (256, 128, 160, 256), (256, 32, 160, 192)]


def variant_source(name: str) -> str:
    """The source with `name`'s edits; raises if one does not apply."""
    with open(SOURCE) as f:
        text = f.read()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: the source no longer holds "
                             f"{old.strip()[:60]!r} once")
        text = text.replace(old, new)
    return text


def bind_k1(lib):
    fn = lib.score_best_offsets_tc_launch
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.restype = ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, vp, vp, vp]
    return fn


def bind_hap(lib):
    fn = lib.score_hap_tc_launch
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.restype = ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, ll, vp, vp, vp]
    return fn


def build(names, bind=bind_k1) -> dict:
    """{name: bind(its library)} of the source ("k1") and each variant,
    built together."""
    os.makedirs(OUT, exist_ok=True)
    with open(SOURCE) as f:
        source = f.read()
    procs = {}
    for name in ["k1", *names]:
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(source if name == "k1" else variant_source(name))
        lib = os.path.join(OUT, f"lib{name}.so")
        verbose = ["-Xptxas", "-v"] if name == "k1" else []
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *verbose,
             "-I", _build.CSRC, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        for line in out.splitlines():
            if any(k in line for k in ("registers", "spill", "C75")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        fns[name] = bind(ctypes.CDLL(lib))
    return fns


def launch(fn, codes, delta, lnmis, win_t):
    B, R, L = codes.shape
    best, off = sv._best_off((B, R), codes.device)
    sv._launch_on(
        "probe", codes.device, fn, codes.data_ptr(), delta.data_ptr(),
        lnmis.data_ptr(), win_t.data_ptr(), B, R, L, win_t.shape[2],
        best.data_ptr(), off.data_ptr())
    return best, off


def loop_ms(fn, dev, iters=50) -> float:
    """Mean ms a call of `fn` over `iters` calls back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=50) -> float:
    """Device ms a call of `fn`: `iters` calls captured in one CUDA
    graph, its replay timed by CUDA events (no host time between the
    calls)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe_now(groups, dev) -> None:
    """noW at each G in `groups` beside K1 at NOW_SHAPES (see the
    module's docstring); prints one JSON line a shape."""
    for B, R, L, W in NOW_SHAPES:
        t = [torch.from_numpy(a).to(dev)
             for a in sv.harness_inputs(B, R, L, W)]
        fns = {"k1": lambda: sv.score_best_offsets(*t)}
        for g in groups:
            got = sv.score_ablation("noW", *t, G=g)
            want = sv.now_best_offsets(*t, g)
            torch.cuda.synchronize(dev)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"noW G={g} at {[B, R, L, W]} differs "
                                     f"from the plain version")
            fns[f"G{g}"] = (lambda g=g: sv.score_ablation("noW", *t, G=g))
        names = list(fns)[1:]
        times = {n: [] for n in fns}
        for name in ["k1", *names, *names[::-1], "k1"]:
            times[name].append(graph_ms(fns[name]))
        print(json.dumps({"shape": [B, R, L, W],
                          "plan": sv.now_plan(B, R, L, W, groups[0], dev),
                          **{n: min(v) for n, v in times.items()}}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m strelka_tpu_torch.ops.score_tc_probe",
        description="Time variants of the tensor-core K1 beside it.")
    ap.add_argument("variants", nargs="*",
                    help=f"of {' '.join(VARIANTS)} (default: all)")
    ap.add_argument("--hap", action="store_true",
                    help="time KX-H (H windows) instead of K1")
    ap.add_argument("--now", type=int, nargs="+", metavar="G",
                    help="time KX-A noW at these group sizes beside K1 "
                         "instead")
    args = ap.parse_args(argv)
    if args.now:
        if args.variants or args.hap or min(args.now) < 1:
            ap.error("--now takes group sizes of 1 or more, alone")
        probe_now(args.now, devmod.resolve("cuda"))
        return 0
    names = args.variants or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    dev = devmod.resolve("cuda")
    H = sv.HAP_WINDOWS if args.hap else 1
    fns = build(names, bind_hap if args.hap else bind_k1)
    if args.hap:
        max_len = sv._tc_lib().score_best_offsets_tc_max_len()

        def call(fn, *t):
            return sv._launch_hap("probe", fn, max_len, *t, H)

        def plain(*t):
            return sv.hap_best_offsets(*t, H)
    else:
        call, plain = launch, exact_best_offsets
    order = ["k1", *names, *names[::-1], "k1"]
    for B, R, L, W in HAP_SHAPES if args.hap else SHAPES:
        shape = [B, R, L, W]
        t = [torch.from_numpy(a).to(dev)
             for a in sv.harness_inputs(B, R, L, H * W)]
        want = plain(*t)
        times = {n: [] for n in fns}
        for name in order:
            got = call(fns[name], *t)
            torch.cuda.synchronize(dev)
            if (name == "k1" or VARIANTS[name][0]) and not all(
                    torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} at {shape} differs from the "
                                     f"plain version")
            times[name].append(loop_ms(lambda: call(fns[name], *t), dev))
        row = {"shape": shape, **{n: min(v) for n, v in times.items()}}
        if args.hap:
            row["windows"] = H
        else:
            row["k1_s"] = loop_ms(lambda: sv.score_simt(*t), dev)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
