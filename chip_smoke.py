#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (strelka_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card, default sizes

Phases, each of which fails the run (non-zero exit, no result line):

1. build: the host library (make -C native) and every CUDA kernel of
   strelka_tpu_torch/csrc (one nvcc per source, started together);
2. k1: the scoring kernel against its plain torch version on the card,
   bit for bit, at the main path's shapes plus tie and code-4 cases,
   with both timed by CUDA events;
2b. k1h: the kernel's mode="highest" instantiation against its plain
   version (one-hot f32 bmm), scores within 1e-4 and offsets equal
   outside near-ties, at bench.py's shape and two main-path shapes,
   timed; plus bench.py's unquantized deltas held to an f32 rounding
   bound;
2c. kx: the K1-x variants' runner (python -m
   strelka_tpu_torch.ops.score_variants) on every variant name of the
   harness at its shapes, with the launch counters set to 0 just before
   and read just after (every variant equal to its body's function,
   every K1-x kernel and K1 launched); its times are the kernels' times
   at the harness's shape. Then each K1-x kernel of
   ops/score_variants.KERNELS (KX-P in two instantiations, KX-K, KX-H,
   KX-I, the four ablations KX-A) against its plain version bit for bit
   at the harness's shape and the main path's, with tie, ragged and
   code-4 cases; its plain version timed at both shapes, the kernel and
   K1 at the main path's;
3. snv: the SNV tile functions on the card against the port's CPU path
   (integer fields equal, lhood bit-equal);
3b. somatic: the somatic SNV model on the card against the port's CPU
   path on a 200,000-row random tile (grid states bit-equal, integer
   fields equal), and its peak bytes per row against the sizes from
   which the port chooses its chunk heights;
4. e2e: the germline CLI with --device cuda (WGS mode) on a synthetic
   contig (default 4 Mb at 30x, 150 bp reads), with the launch counters
   set to 0 just before and read just after (the K1-x kernels' must
   read 0);
5. cuda-vs-cpu: the same CLI with --device cpu on the same data; no
   record may differ in CHROM, POS, REF, ALT, FILTER or GT;
6. somatic e2e: the somatic CLI with --device cuda (WGS mode) on a
   synthetic tumor/normal contig (default 2 Mb, normal 30x, tumor 60x,
   150 bp reads), counters set to 0 just before and read just after;
   90% or more of the planted somatic SNVs must be called with FILTER
   PASS;
7. somatic cuda-vs-cpu: the same with --device cpu; no record may
   differ in CHROM, POS, REF, ALT, FILTER, QSS/QSI or NT.

The second-to-last lines are the card's name and power limit
(nvidia-smi) and one JSON line {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Work files go to build/smoke/.

--rehearse runs the same control flow on the CPU at a small size (the
kernel checks then hold the plain version against itself) and prints
no result line; it is for checking the script without a card.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s and
# f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
K1H_ATOL = 1e-4   # tests/test_pallas_kernel.py:107-108


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


class StreamTimer:
    """CUDA events around every call of a wrapped function: the stream
    time between the two events, summed per phase (on the CPU: host
    wall time)."""

    def __init__(self, torch, cuda: bool):
        self.torch = torch
        self.cuda = cuda
        self.spans: dict[str, list] = {}
        self.patched = []

    def wrap(self, mod, name: str, phase: str):
        fn = getattr(mod, name)
        torch = self.torch

        def timed(*a, **k):
            if self.cuda:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*a, **k)
                e.record()
                self.spans.setdefault(phase, []).append((s, e))
            else:
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.spans.setdefault(phase, []).append(
                    (time.perf_counter() - t0) * 1e3)
            return out
        setattr(mod, name, timed)
        self.patched.append((mod, name, fn))

    def restore(self):
        for mod, name, fn in reversed(self.patched):
            setattr(mod, name, fn)
        self.patched = []

    def totals_ms(self) -> dict[str, float]:
        if self.cuda:
            self.torch.cuda.synchronize()
            return {p: sum(s.elapsed_time(e) for s, e in v)
                    for p, v in self.spans.items()}
        return {p: sum(v) for p, v in self.spans.items()}


def time_ms(torch, cuda: bool, fn, iters: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def bound_ms(nbytes, ops, ops_per_s) -> tuple[float, str]:
    """The larger of the bytes over HBM's rate and the operations over
    the engine's peak, and which of the two it is."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_bytes(B, R, L, W) -> int:
    """codes and delta (5 bytes a base), the window, lnmis in, best and
    off out: each read or written once."""
    return B * (5 * R * L + L * W + 12 * R)


def k1_bound_ms(B, R, L, W) -> tuple[float, str]:
    """Least time for the function on the card: its bytes over HBM
    against 2*B*R*L*W int8 compare-adds at the tensor-core peak."""
    return bound_ms(k1_bytes(B, R, L, W), 2 * B * R * L * W, INT8_OPS_PER_S)


def k1h_bound_ms(B, R, L, W) -> tuple[float, str]:
    """K1-h's least time: K1's bytes against 2*B*R*L*W f32 operations at
    the non-tensor FP32 peak."""
    return bound_ms(k1_bytes(B, R, L, W), 2 * B * R * L * W, F32_OPS_PER_S)


def kx_bound_ms(kind, B, R, L, W, H=1, G=1) -> tuple[float, str]:
    """A K1-x kernel's least time, by K1's rule: the bytes of its own
    operands (packed: 4 bytes a base; folded: lnmis inside the packed
    rows; hap: H windows and H outputs a read; noA: no codes; noW: one
    window in G pairs; nodot: the bases and window rows its slices
    read) against its compare-adds at the int8 tensor-core peak (KX-I:
    the 2R x 4L x W product's multiply-adds, which its tensor cores
    run; nodot: 2 f32 operations an output score)."""
    ops, peak = 2 * H * B * R * L * W, INT8_OPS_PER_S
    if kind == "packed":
        nbytes = B * (4 * R * L + 4 * R + L * W + 8 * R)
    elif kind == "packed_fold":
        nbytes = B * (4 * (R + -(-R // L)) * L + L * W + 8 * R)
    elif kind == "hap":
        nbytes = B * (5 * R * L + 4 * R + L * H * W + 8 * R * H)
    elif kind == "noA":
        nbytes = B * (4 * R * L + L * W + 12 * R)
    elif kind == "noW":
        nbytes = B * (5 * R * L + 12 * R) + -(-B // G) * L * W
    elif kind == "nodot":
        nbytes = B * (5 * R * min(L, W) + min(R, L) * W + 12 * R)
        ops, peak = 2 * B * R * W, F32_OPS_PER_S
    else:
        nbytes = k1_bytes(B, R, L, W)
    if kind == "int8":
        ops = 16 * B * R * L * W
    return bound_ms(nbytes, ops, peak)


def k1_random(np, rng, B, R, L, W):
    from strelka_tpu_torch.ops import readlik
    dl, ll = readlik.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)  # 4 under delta
    delta = dl[q]
    lnmis = np.where(codes < 4, ll[q], 0.0).sum(axis=2).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    return codes, delta, lnmis, win


def k1_ties(np, rng, B, R, L, W):
    """Windows that tie exactly (the read content tiled with period L,
    so offsets w and w+L tie, across the kernel's 128-offset chunks)
    plus one near-tie per pair a single q=2 base away."""
    from strelka_tpu_torch.ops import readlik
    dl, ll = readlik.quantized_qscore_luts()
    read = rng.integers(0, 4, (L,))
    q = np.full((B, R, L), 2)
    codes = np.broadcast_to(read, (B, R, L)).astype(np.int8).copy()
    hp = np.tile(read, (W + L) // L + 1)
    win = np.stack([hp[l:l + W] for l in range(L)], axis=0)
    win = np.broadcast_to(win, (B, L, W)).astype(np.int8).copy()
    for b in range(B):
        l = int(rng.integers(0, L))
        win[b, l, min(37, W - 1)] = (win[b, l, min(37, W - 1)] + 1) % 4
    delta = dl[q]
    lnmis = ll[q].sum(axis=2).astype(np.float32)
    return codes, delta, lnmis, win


def k1_code4(np, rng, B, R, L, W):
    """Random inputs with pair 0's reads all code 4 under non-zero
    deltas and its window code 4 at the first 7 offsets: pair 0 scores
    exactly lnmis at offset 0."""
    codes, delta, lnmis, win = k1_random(np, rng, B, R, L, W)
    codes[0] = 4
    win[0, :, :7] = 4
    return codes, delta, lnmis, win


# the variant whose runner time is each K1-x kernel's at the harness's
# shape: the kernel alone, on operands staged as it takes them
KX_TIMED_BY = {"packed": "fusedin", "packed_fold": "fusedlm",
               "onesum": "limb2k", "hap": "hap2", "int8": "int8",
               "noA": "limb2-noA", "noW": "limb2-noW",
               "nomax": "limb2-nomax", "nodot": "limb2-nodot"}


def kx_zero(sv):
    for k in sv.KERNELS.values():
        setattr(sv, k.counter, 0)


def kx_read(sv) -> dict[str, int]:
    return {k.counter: getattr(sv, k.counter) for k in sv.KERNELS.values()}


def phase_kx_runner(torch, sv, sk, dev, cuda: bool, B: int, R: int):
    """The variants runner, this slice's path, on every variant name,
    with every counter set to 0 just before and read just after. Fails
    unless every variant equals its body's function and, on the card,
    every K1-x kernel and K1 launched. Returns (counters, {name: row})."""
    names = [*sv.K1_VARIANTS, "limb2r@8", "fused", "fusedwhole", "fusedin",
             "fusedlm", "limb2k", "hap2", "int8", "limb2-noA", "limb2-noW",
             "limb2-nomax", "limb2-nodot"]
    kx_zero(sv)
    sk.LAUNCHES = 0
    sk.LAUNCHES_HIGHEST = 0
    try:
        rows = sv.run(names, dev.type, B, R)
    finally:
        got = kx_read(sv)
        got["k1"] = sk.LAUNCHES
        got["k1h"] = sk.LAUNCHES_HIGHEST
    bad = [r["name"] for r in rows if not r["body_exact"]]
    if bad:
        fail(f"the variants runner: {bad} differ from their body's function")
    idle = [c for c, n in got.items() if c != "k1h" and n == 0]
    if cuda and idle:
        fail(f"the variants runner launched {idle} no time")
    log("kx runner launches: " + json.dumps(got))
    return got, {r["name"]: r for r in rows}


def phase_kx(np, torch, dev, cuda: bool, shapes, hap_shapes, edge,
             runner):
    """Each K1-x kernel against its plain version, bit for bit, at
    `shapes` (hap: `hap_shapes`, B loci x sv.HAP_WINDOWS windows of W) on
    random inputs (code 4 under non-zero deltas), plus the `edge` cases
    (ties, ragged, code 4). At the first shape, the harness's, the
    kernel's and K1's times are the runner's (`runner` rows); at the
    others both are timed here, K1 at the same shape (hap: one launch a
    window). The plain version is timed at each shape. Returns {kind:
    rows}."""
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.ops import score_variants as sv
    rng = np.random.default_rng(2026)
    H, G = sv.HAP_WINDOWS, sv.DEFAULT_G
    cache = {}

    def inputs(make, B, R, L, W):
        key = (make.__name__, B, R, L, W)
        if key not in cache:
            arrs = make(np, rng, B, R, L, W)
            cache[key] = [torch.from_numpy(a).to(dev) for a in arrs]
        return cache[key]

    def ms(fn, iters=20, warm=3):
        return sv.median_ms(fn, dev, iters if cuda else 1, warm if cuda else 0)

    out = {}
    for kind, k in sv.KERNELS.items():
        hap = kind == "hap"
        cases = [("random", s, k1_random)
                 for s in (hap_shapes if hap else shapes)] + edge
        rows = []
        for i, (case, (B, R, L, W), make) in enumerate(cases):
            t = inputs(make, B, R, L, H * W if hap else W)
            args = k.prepare(t, G)
            got, want = k.call(*args), k.plain(*args)
            if cuda:
                torch.cuda.synchronize()
            bad = [int((a.view(torch.int32) != b.view(torch.int32)).sum())
                   for a, b in zip(got, want)]
            if any(bad):
                fail(f"kx {k.label} {case} {[B, R, L, W]}: kernel differs "
                     f"from the plain version ({bad} entries)")
            row = {"case": case, "shape": [B, R, L, W],
                   "max_abs_err": float((got[0] - want[0]).abs().max())}
            if hap:
                row["windows"] = H
            if kind == "noW":
                row["G"] = G
            if case == "random":
                if i == 0:
                    row["ms"] = runner[KX_TIMED_BY[kind]]["step_ms"]
                    row["k1_ms"] = runner["base"]["step_ms"]
                    row["timed_by"] = "runner"
                else:
                    row["ms"] = ms(lambda: k.call(*args))
                    if hap:
                        c, d, m, w = t
                        wins = [w[:, :, h * W:(h + 1) * W].contiguous()
                                for h in range(H)]
                        k1 = lambda: [sk.score_best_offsets(c, d, m, x)  # noqa: E731
                                      for x in wins]
                    else:
                        k1 = lambda: sk.score_best_offsets(*t)  # noqa: E731
                    row["k1_ms"] = ms(k1)
                row["plain_ms"] = ms(lambda: k.plain(*args), 5, 1)
                row["bound_ms"], row["bound_by"] = kx_bound_ms(
                    kind, B, R, L, W, H if hap else 1, G)
            rows.append(row)
            log(f"kx {k.label}: " + json.dumps(row))
            del t, args, got, want
        out[kind] = rows
    return out


def phase_build(torch, cuda: bool):
    from strelka_tpu_torch.io import native
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-C", os.path.join(HERE, "native")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"make -C native failed:\n{r.stdout}\n{r.stderr}")
    lib = native.get_lib()
    if lib is None:
        fail("host library native/libstrelka_tpu_native.so did not load: "
             "BAM decode and pileup would run as pure Python")
    log(f"build: host library loaded ({time.perf_counter() - t0:.1f} s)")
    if cuda:
        from strelka_tpu_torch import _build
        t0 = time.perf_counter()
        took = _build.build_all()
        for name in _build.sources():
            _build.load(name)
        log(f"build: nvcc {sorted(_build.sources())} in "
            f"{time.perf_counter() - t0:.1f} s ({took})")
        log(f"card: {nvidia_smi_line()}")


def phase_k1(np, torch, dev, cuda: bool, shapes, iters: int,
             edge_cases: bool = True):
    """Kernel vs plain version at each shape (random inputs, code 4
    under non-zero deltas), plus exact ties across offset chunks and a
    ragged shape; returns per-case rows."""
    from strelka_tpu_torch.ops import score_kernel as sk
    rng = np.random.default_rng(2024)
    rows = []
    cases = [("random", s, k1_random) for s in shapes]
    if edge_cases:
        cases += [("ties", (64, 32, 128, 320), k1_ties),
                  ("ties", (16, 128, 160, 256), k1_ties),
                  ("ragged", (3, 40, 100, 70), k1_random)]
    max_err = 0.0
    for kind, (B, R, L, W), make in cases:
        arrs = make(np, rng, B, R, L, W)
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        kb, ko = sk.score_best_offsets(*t)
        pb, po = sk.exact_best_offsets(*t)
        if cuda:
            torch.cuda.synchronize()
        if not torch.equal(kb, pb) or not torch.equal(ko, po):
            nb = int((kb != pb).sum())
            no = int((ko != po).sum())
            fail(f"k1 {kind} {[B, R, L, W]}: kernel differs from the plain "
                 f"version ({nb} scores, {no} offsets)")
        err = float((kb - pb).abs().max())
        max_err = max(max_err, err)
        row = {"case": kind, "shape": [B, R, L, W], "max_abs_err": err}
        if kind == "random":
            row["ms"] = time_ms(torch, cuda,
                                lambda: sk.score_best_offsets(*t), iters)
            row["plain_ms"] = time_ms(torch, cuda,
                                      lambda: sk.exact_best_offsets(*t),
                                      max(1, iters // 5), warm=1)
            row["bound_ms"], row["bound_by"] = k1_bound_ms(B, R, L, W)
        rows.append(row)
        log("k1: " + json.dumps(row))
        del t
    return rows, max_err


def bench_inputs(np, rng, B, R, L, W):
    """bench.py's inputs: unquantized deltas uniform(2, 20)."""
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    delta = rng.uniform(2, 20, (B, R, L)).astype(np.float32)
    lnmis = rng.normal(-100, 10, (B, R)).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    return codes, delta, lnmis, win


def phase_k1h(np, torch, dev, cuda: bool, shapes, iters: int):
    """mode="highest" kernel vs its plain version: scores within
    K1H_ATOL with the quantized LUT's deltas (whose f32 sums are exact),
    offsets equal except where the plain version's top two scores lie
    within K1H_ATOL (counted); bench.py's unquantized deltas at the first
    shape, held per row to the f32 bound 2 (L+1) 2^-24 sum|terms| of two
    summation orders. Returns (rows, max_abs_err)."""
    from strelka_tpu_torch.ops import score_kernel as sk
    rng = np.random.default_rng(2025)
    rows = []
    max_err = 0.0
    cases = [("lut", s, k1_random) for s in shapes]
    cases.append(("bench_unquantized", shapes[0], bench_inputs))
    for kind, (B, R, L, W), make in cases:
        arrs = make(np, rng, B, R, L, W)
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        kb, ko = sk.score_best_offsets(*t, mode="highest")
        s = sk.highest_scores(*t)
        top2 = torch.topk(s, 2, dim=-1).values
        del s
        pb, po = sk.reference_best_offsets(*t)
        if cuda:
            torch.cuda.synchronize()
        err = (kb - pb).abs()
        if kind == "lut":
            bad = int((err > K1H_ATOL).sum())
        else:
            c, d, m, _w = t
            terms = torch.where((c >= 0) & (c < 4), d.abs(), 0.0).sum(-1)
            bound = 2 * (L + 1) * 2.0 ** -24 * (terms + m.abs())
            bad = int((err > bound).sum())
        near = (top2[..., 0] - top2[..., 1]) <= K1H_ATOL
        differ = ko != po
        n_off_bad = int((differ & ~near).sum())
        if bad or n_off_bad:
            fail(f"k1h {kind} {[B, R, L, W]}: {bad} scores outside the "
                 f"tolerance (max err {float(err.max())}), {n_off_bad} "
                 f"offsets differ outside near-ties")
        row = {"case": kind, "shape": [B, R, L, W],
               "max_abs_err": float(err.max()),
               "near_ties": int(near.sum()),
               "near_tie_offsets_differ": int((differ & near).sum())}
        max_err = max(max_err, row["max_abs_err"])
        if kind == "lut":
            row["ms"] = time_ms(torch, cuda, lambda: sk.score_best_offsets(
                *t, mode="highest"), iters)
            row["plain_ms"] = time_ms(
                torch, cuda, lambda: sk.reference_best_offsets(*t),
                max(1, iters // 5), warm=1)
            row["bound_ms"], row["bound_by"] = k1h_bound_ms(B, R, L, W)
        rows.append(row)
        log("k1h: " + json.dumps(row))
        del t
    return rows, max_err


def phase_snv(np, torch, dev, cuda: bool, L: int):
    """Tile functions on `dev` against the port's CPU path."""
    from strelka_tpu_torch.models import snv_digt as sd
    rng = np.random.default_rng(7)
    for D in (64, 160):
        n = L if D <= 127 else L // 8
        base = rng.integers(0, 4, (n, D)).astype(np.int8)
        qual = rng.integers(0, 45, (n, D)).astype(np.uint8)
        mask = rng.random((n, D)) < 0.8
        fwd = rng.random((n, D)) < 0.5
        # mostly-ref sites with a minority alt so some rows are SNPs
        ref = rng.integers(0, 5, n).astype(np.int32)
        alt = rng.random((n, D)) < 0.3
        base = np.where(alt, base, np.minimum(ref, 3)[:, None]).astype(
            np.int8)
        tile = sd.SnvPileupTile(base_id=base, qual=qual, is_fwd=fwd,
                                mask=mask, ref_gt=ref)
        hap = rng.random(n) < 0.1
        smis = np.where(rng.random((n, 4)) < 0.05,
                        rng.random((n, 4)).astype(np.float32) * 0.5,
                        0.0).astype(np.float32)
        dep = (smis, lambda rows: np.zeros((len(rows), D), np.float32))
        got = sd.call_snv_tile_chunked(tile, 0.001, hap, dep=dep,
                                       device=dev)
        want = sd.call_snv_tile_chunked(tile, 0.001, hap, dep=dep,
                                        device="cpu")
        for f in ("genome_max_gt", "poly_max_gt", "snv_qphred",
                  "genome_max_gt_qphred", "poly_max_gt_qphred",
                  "phred_loghood"):
            a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            if not np.array_equal(a, b):
                fail(f"snv D={D}: {f} differs at "
                     f"{int((a != b).sum())} entries")
        if not np.array_equal(got.lhood.view(np.int32),
                              want.lhood.view(np.int32)):
            fail(f"snv D={D}: lhood not bit-equal "
                 f"({int((got.lhood != want.lhood).sum())} entries)")
        diffs = {
            "rows": n,
            "snp_rows": int((np.asarray(want.snv_qphred) != 0).sum()),
            "ln_ref_max_abs_diff": float(np.abs(
                got.ln_ref_pprob - want.ln_ref_pprob).max()),
            "strand_bias_max_abs_diff": float(np.abs(
                got.strand_bias - want.strand_bias).max()),
        }
        log(f"snv D={D}: " + json.dumps(diffs))


def phase_somatic_snv(np, torch, dev, L: int):
    """Grid lhoods and joint posterior on `dev` against the port's CPU
    path on a random tumor/normal tile with q=0 calls, masked lanes and
    all-masked rows: -inf positions and grid states bit-equal, integer
    fields equal; prints the lhood ulp distance and the phred flips."""
    from strelka_tpu_torch.models import somatic_snv as ss
    rng = np.random.default_rng(8)
    tiles = []
    for D, alt in ((32, 0.1), (96, 0.3)):
        ref = rng.integers(0, 5, L).astype(np.int32)
        base = rng.integers(-1, 4, (L, D)).astype(np.int8)
        base = np.where(rng.random((L, D)) < 1 - alt,
                        np.minimum(ref, 3)[:, None], base).astype(np.int8)
        qual = rng.integers(0, 45, (L, D)).astype(np.int16)
        qual = np.where(rng.random((L, D)) < 0.02, 0, qual).astype(np.int16)
        mask = rng.random((L, D)) < 0.85
        mask[10:20] = False
        tiles.append((base, qual, mask, rng.random((L, D)) < 0.5, ref))
    res = {}
    for d in (dev, torch.device("cpu")):
        lh = [ss.freq_grid_lhoods(*(torch.from_numpy(a).to(d) for a in t))
              for t in tiles]
        post = ss.somatic_snv_call_capped(*lh)
        res[d.type] = ([x.cpu() for x in lh],
                       {f: getattr(post, f).cpu()
                        for f in ss.SomaticSnvResult._fields})
    (lh_d, post_d), (lh_c, post_c) = res[dev.type], res["cpu"]
    max_ulp = {}
    for i, (a, b) in enumerate(zip(lh_d, lh_c)):
        if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
            fail(f"somatic tile {i}: -inf positions differ")
        fin = torch.isfinite(a) & torch.isfinite(b)
        u = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
        u = torch.where(fin, u, 0)
        g = ss.PRESTRAND_SIZE
        if int(u[:, :g].max()):
            fail(f"somatic tile {i}: grid states differ by up to "
                 f"{int(u[:, :g].max())} ulp")
        max_ulp[f"sample{i}"] = int(u.max())
    flips = {f: int((post_d[f] != post_c[f]).sum())
             for f in ("qphred", "from_ntype_qphred", "nonsomatic_qphred",
                       "ntype", "max_gt")}
    if any(flips.values()):
        fail(f"somatic posterior: integer fields differ {flips}")
    log("somatic: " + json.dumps({
        "rows": L, "lhood_max_ulp": max_ulp, "phred_flips": flips,
        "somatic_rows": int((post_c["qphred"] > 0).sum()),
        "strand_bias_max_abs_diff": float(
            (post_d["strand_bias"] - post_c["strand_bias"]).abs().max())}))
    if dev.type == "cuda":
        somatic_row_bytes(torch, dev, ss, tiles)


def somatic_row_bytes(torch, dev, ss, tiles):
    """Peak bytes per row that the caching allocator hands out while
    freq_grid_lhoods and one somatic_snv_call run on the card, against
    the per-row sizes from which the port chooses its chunk heights
    (somatic_snv.CALL_ROW_BYTES, GRID_ROW_BYTES + GRID_LANE_BYTES * D)."""
    def peak_per_row(fn, rows):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
        return peak / rows
    got = {}
    lh = []
    for t in tiles:
        L, D = t[0].shape
        x = [torch.from_numpy(a).to(dev) for a in t]
        got[f"grid_D{D}"] = peak_per_row(lambda: ss.freq_grid_lhoods(*x), L)
        limit = ss.GRID_ROW_BYTES + ss.GRID_LANE_BYTES * D
        if got[f"grid_D{D}"] > limit:
            fail(f"freq_grid_lhoods held {got[f'grid_D{D}']:.0f} bytes a "
                 f"row at D={D}, over the {limit} the chunking assumes")
        lh.append(ss.freq_grid_lhoods(*x))
    got["call"] = peak_per_row(lambda: ss.somatic_snv_call(*lh),
                               lh[0].shape[0])
    if got["call"] > ss.CALL_ROW_BYTES:
        fail(f"somatic_snv_call held {got['call']:.0f} bytes a row, over "
             f"the {ss.CALL_ROW_BYTES} the chunking assumes")
    log("somatic row bytes (measured peak): " + json.dumps(got) + " chunk "
        f"rows now: posterior {ss.rows_per_launch(dev, ss.CALL_ROW_BYTES)}")


def make_dataset(np, workdir: str, mb: float, seed: int = 11):
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    t0 = time.perf_counter()
    L = int(mb * 1_000_000)
    refs, batch, _truth = synth.generate(L=L, depth=30, read_len=150,
                                         snv_every=1000, indel_every=1500,
                                         seed=seed)
    os.makedirs(workdir, exist_ok=True)
    fa = os.path.join(workdir, "ref.fa")
    with open(fa, "w") as f:
        f.write(">syn\n")
        for i in range(0, len(refs), 60):
            f.write(refs[i:i + 60] + "\n")
    bam = os.path.join(workdir, "sample.bam")
    write_bam(bam, BamHeader(text="", ref_names=["syn"],
                             ref_lengths=[len(refs)]), batch)
    log(f"data: {mb} Mb contig, {batch.n} reads at 30x/150 bp, "
        f"made in {time.perf_counter() - t0:.1f} s")
    return fa, bam, batch.n


def make_tn_dataset(np, workdir: str, mb: float):
    """Tumor/normal on one contig: a germline grid (SNVs every 900 bp,
    indels every 1200 bp) in both, the normal at 30x and the tumor at 60x
    with somatic SNVs every 1500 bp at VAF 0.35 and somatic indels every
    2100 bp; 150 bp reads. Returns (fa, normal bam, tumor bam, reads,
    planted somatic SNV positions)."""
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    t0 = time.perf_counter()
    common = dict(L=int(mb * 1_000_000), read_len=150, snv_every=900,
                  indel_every=1200, ref_seed=11)
    refs, normal, _ = synth.generate(depth=30, seed=21, **common)
    _, tumor, truth = synth.generate(depth=60, seed=22, somatic_every=1500,
                                     somatic_vaf=0.35,
                                     somatic_indel_every=2100, **common)
    os.makedirs(workdir, exist_ok=True)
    fa = os.path.join(workdir, "tn_ref.fa")
    with open(fa, "w") as f:
        f.write(">syn\n")
        for i in range(0, len(refs), 60):
            f.write(refs[i:i + 60] + "\n")
    hdr = BamHeader(text="", ref_names=["syn"], ref_lengths=[len(refs)])
    nbam = os.path.join(workdir, "normal.bam")
    tbam = os.path.join(workdir, "tumor.bam")
    write_bam(nbam, hdr, normal)
    write_bam(tbam, hdr, tumor)
    n = normal.n + tumor.n
    log(f"data: {mb} Mb tumor/normal contig, {normal.n} normal reads at "
        f"30x + {tumor.n} tumor reads at 60x, 150 bp, "
        f"{len(truth['som_snv'])} somatic SNVs planted, made in "
        f"{time.perf_counter() - t0:.1f} s")
    return fa, nbam, tbam, n, truth["som_snv"]


def run_somatic_cli(fa, nbam, tbam, out, device):
    from strelka_tpu_torch.__main__ import main
    if os.path.exists(out):
        import shutil
        shutil.rmtree(out)
    t0 = time.perf_counter()
    rc = main(["somatic", "--reference", fa, "--normal-align-file", nbam,
               "--tumor-align-file", tbam, "--output-dir", out,
               "--device", device])
    wall = time.perf_counter() - t0
    if rc not in (0, None):
        fail(f"somatic --device {device} exited {rc}")
    return wall


SOMATIC_OUTPUTS = ("somatic.snvs.vcf.gz", "somatic.indels.vcf.gz")


def info_of(rec, keys):
    kv = dict(f.split("=", 1) for f in rec[7].split(";") if "=" in f)
    return tuple(kv.get(k) for k in keys)


def phase_somatic_e2e(torch, cuda: bool, fa, nbam, tbam, n_reads, som_snv,
                      mb, out, device):
    """The somatic CLI on `device` with the counters set to 0 just before
    and read just after; stream time of each device phase by CUDA
    events; somatic SNV recall against the planted truth (all records,
    and the PASS records that the 0.9 gate reads). Returns the kernel
    launches (mode="exact", mode="highest", the K1-x counters)."""
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.ops import score_variants as sv
    timer = StreamTimer(torch, cuda)
    timer.wrap(sk, "score_best_offsets", "k1_score_best_offsets")
    timer.wrap(ss, "freq_grid_lhoods", "somatic_grid_lhoods")
    timer.wrap(ss, "somatic_snv_call", "somatic_posterior")
    sk.LAUNCHES = 0
    sk.LAUNCHES_HIGHEST = 0
    kx_zero(sv)
    ss.LAUNCH_STATS.clear()
    try:
        wall = run_somatic_cli(fa, nbam, tbam, out, device)
    finally:
        launches = sk.LAUNCHES
        launches_highest = sk.LAUNCHES_HIGHEST
        kx = kx_read(sv)
        tiles = dict(ss.LAUNCH_STATS)
        timer.restore()
    phase_ms = timer.totals_ms()
    snvs = vcf_records(os.path.join(out, SOMATIC_OUTPUTS[0]))
    indels = vcf_records(os.path.join(out, SOMATIC_OUTPUTS[1]))
    for rec in snvs + indels:
        if len(rec) != 11:
            fail(f"malformed somatic record: {rec[:5]}")
    called = {int(r[1]) - 1 for r in snvs}
    passed = {int(r[1]) - 1 for r in snvs if r[6] == "PASS"}
    recall = sum(p in called for p in som_snv) / max(len(som_snv), 1)
    pass_recall = sum(p in passed for p in som_snv) / max(len(som_snv), 1)
    n_grid = sum(v for k, v in tiles.items()
                 if k[0] == "grid" and k[1] == device)
    n_post = sum(v for k, v in tiles.items()
                 if k[0] == "post" and k[1] == device)
    if cuda and launches == 0:
        fail("the somatic path launched the k1 kernel no time")
    if n_grid == 0 or n_post == 0:
        fail(f"the somatic path ran no grid-lhood or posterior tile on "
             f"{device}")
    if pass_recall < 0.9:
        fail(f"somatic SNV PASS recall {pass_recall:.4f} is below 0.9")
    if any(kx.values()):
        fail(f"the somatic path launched a K1-x kernel: {kx}")
    dev_ms = sum(phase_ms.values())
    log("somatic_e2e: " + json.dumps({
        "device": device, "contig_mb": mb, "reads": n_reads, "wall_s": wall,
        "reads_per_s": n_reads / wall, "snv_records": len(snvs),
        "indel_records": len(indels), "som_snv_planted": len(som_snv),
        "som_snv_recall": recall, "som_snv_pass_recall": pass_recall,
        "k1_launches": launches, "k1h_launches": launches_highest,
        "kx_launches": kx,
        "grid_tile_launches": n_grid, "posterior_launches": n_post,
        "stream_ms_by_phase": phase_ms,
        "device_phase_share_of_wall": dev_ms / 1e3 / wall}))
    return launches, launches_highest, kx


def compare_somatic_runs(a_dir, b_dir):
    """(records compared, records differing beyond the key fields);
    fails on any CHROM/POS/REF/ALT/FILTER/QSS/QSI/NT difference."""
    n = other = 0
    for name in SOMATIC_OUTPUTS:
        a = vcf_records(os.path.join(a_dir, name))
        b = vcf_records(os.path.join(b_dir, name))
        if len(a) != len(b):
            fail(f"{name}: {len(a)} records on cuda, {len(b)} on cpu")
        for ra, rb in zip(a, b):
            keys = ("QSS", "QSI", "NT")
            key_a = (*ra[:2], ra[3], ra[4], ra[6], *info_of(ra, keys))
            key_b = (*rb[:2], rb[3], rb[4], rb[6], *info_of(rb, keys))
            if key_a != key_b:
                fail(f"{name}: record differs in a key field:\n "
                     f"cuda {ra[:8]}\n cpu  {rb[:8]}")
            n += 1
            if ra != rb:
                other += 1
                if other <= 5:
                    log(f"cuda-vs-cpu {name} differs:\n  cuda "
                        f"{chr(9).join(ra)}\n  cpu  {chr(9).join(rb)}")
    return n, other


def run_cli(fa, bam, out, device):
    from strelka_tpu_torch.__main__ import main
    if os.path.exists(out):
        import shutil
        shutil.rmtree(out)
    t0 = time.perf_counter()
    rc = main(["germline", "--reference", fa, "--align-file", bam,
               "--output-dir", out, "--device", device])
    wall = time.perf_counter() - t0
    if rc not in (0, None):
        fail(f"germline --device {device} exited {rc}")
    return wall


def vcf_records(path):
    with gzip.open(path, "rt") as f:
        return [l.rstrip("\n").split("\t") for l in f
                if not l.startswith("#")]


def check_outputs(out, n_reads):
    var = vcf_records(os.path.join(out, "variants.vcf.gz"))
    gv = vcf_records(os.path.join(out, "genome.S1.vcf.gz"))
    if len(var) < n_reads // 2000:
        fail(f"too few variant records: {len(var)}")
    for rec in var + gv:
        if len(rec) != 10:
            fail(f"malformed record: {rec[:5]}")
    return var, gv


def gt_of(rec):
    fmt = rec[8].split(":")
    return rec[9].split(":")[fmt.index("GT")] if "GT" in fmt else None


def compare_runs(a_dir, b_dir):
    """(records compared, records differing beyond the key fields);
    fails on any CHROM/POS/REF/ALT/FILTER/GT difference."""
    n = other = 0
    for name in ("variants.vcf.gz", "genome.S1.vcf.gz"):
        a = vcf_records(os.path.join(a_dir, name))
        b = vcf_records(os.path.join(b_dir, name))
        if len(a) != len(b):
            fail(f"{name}: {len(a)} records on cuda, {len(b)} on cpu")
        for ra, rb in zip(a, b):
            key_a = (ra[0], ra[1], ra[3], ra[4], ra[6], gt_of(ra))
            key_b = (rb[0], rb[1], rb[3], rb[4], rb[6], gt_of(rb))
            if key_a != key_b:
                fail(f"{name}: record differs in a key field:\n "
                     f"cuda {ra[:7]}\n cpu  {rb[:7]}")
            n += 1
            if ra != rb:
                other += 1
                if other <= 5:
                    log(f"cuda-vs-cpu {name} differs:\n  cuda "
                        f"{chr(9).join(ra)}\n  cpu  {chr(9).join(rb)}")
    return n, other


def phase_e2e(torch, cuda: bool, fa, bam, n_reads, mb, out, device):
    """The CLI on `device` with the launch counters set to 0 just before
    and read just after; stream time of each device phase by CUDA
    events. Returns (k1 launches, k1h launches, k1 launch shapes, the
    K1-x counters)."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.ops import score_variants as sv
    from strelka_tpu_torch.pipeline import realign_batch as rb
    if cuda:
        from strelka_tpu_torch import _build
        _build.load("score_best_offsets")
    timer = StreamTimer(torch, cuda)
    timer.wrap(sk, "score_best_offsets", "k1_score_best_offsets")
    timer.wrap(sd, "call_snv_hist_tile", "snv_genotype_tiles")
    timer.wrap(sd, "snv_strand_bias_tile", "snv_strand_bias_tiles")
    sk.LAUNCHES = 0
    sk.LAUNCHES_HIGHEST = 0
    kx_zero(sv)
    sd.LAUNCH_STATS.clear()
    rb.LAUNCH_STATS = {}
    try:
        wall = run_cli(fa, bam, out, device)
    finally:
        launches = sk.LAUNCHES
        launches_highest = sk.LAUNCHES_HIGHEST
        kx = kx_read(sv)
        snv_tiles = dict(sd.LAUNCH_STATS)
        score_shapes = dict(rb.LAUNCH_STATS)
        rb.LAUNCH_STATS = None
        timer.restore()
    phase_ms = timer.totals_ms()
    var, gv = check_outputs(out, n_reads)
    n_dev_tiles = sum(v for k, v in snv_tiles.items()
                      if k[0] == "tile" and k[1] == device)
    if cuda and launches == 0:
        fail("the main path launched the k1 kernel no time")
    if cuda and n_dev_tiles == 0:
        fail("the main path ran no SNV tile on the card")
    if not score_shapes:
        fail("the main path scored no read x haplotype pair")
    if any(kx.values()):
        fail(f"the germline path launched a K1-x kernel: {kx}")
    e2e = {"contig_mb": mb, "reads": n_reads, "wall_s": wall,
           "reads_per_s": n_reads / wall,
           "variant_records": len(var), "gvcf_records": len(gv),
           "k1_launches": launches, "k1h_launches": launches_highest,
           "kx_launches": kx,
           "snv_tile_launches": {",".join(map(str, k)): v
                                 for k, v in snv_tiles.items()},
           "stream_ms_by_phase": phase_ms,
           "k1_launch_shapes": {",".join(map(str, k)): v
                                for k, v in score_shapes.items()}}
    log("e2e: " + json.dumps(e2e))
    return launches, launches_highest, score_shapes, kx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at a small size; no result line")
    rehearse = ap.parse_args(argv).rehearse

    import numpy as np
    import torch
    cuda = not rehearse
    if cuda and not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    try:
        import strelka_tpu_torch  # noqa: F401
        from strelka_tpu_torch.pipeline import germline_caller  # noqa: F401
        from strelka_tpu_torch.pipeline import somatic_caller  # noqa: F401
    except ImportError as e:
        fail(f"strelka_tpu_torch is not importable beside chip_smoke.py: "
             f"{e}")
    if "jax" in sys.modules or "strelka_tpu" in sys.modules:
        fail("jax or strelka_tpu was imported")
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    mb = 0.1 if rehearse else 4.0
    tn_mb = 0.1 if rehearse else 2.0
    t_start = time.perf_counter()

    log("== phase 1: build")
    phase_build(torch, cuda)

    main_shapes = [(256, r, 160, w) for r in (32, 128, 512)
                   for w in (256, 320)]
    main_shapes += [(256, 128, 128, 192), (128, 32, 128, 192),
                    (512, 128, 128, 128)]   # the K1-x harness's shape
    if rehearse:
        main_shapes = [(8, 32, 64, 64), (4, 128, 96, 128)]
    log("== phase 2: k1 kernel vs plain version")
    k1_rows, k1_err = phase_k1(np, torch, dev, cuda, main_shapes,
                               iters=1 if rehearse else 20)

    log("== phase 2b: k1h (mode=highest) kernel vs plain version")
    k1h_shapes = [(512, 128, 128, 128), (256, 128, 160, 256),
                  (256, 32, 160, 192)]
    if rehearse:
        k1h_shapes = [(8, 128, 128, 128), (4, 32, 160, 192)]
    k1h_rows, k1h_err = phase_k1h(np, torch, dev, cuda, k1h_shapes,
                                  iters=1 if rehearse else 20)

    log("== phase 2c: the K1-x variants' runner, then each kernel vs its "
        "plain version")
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.ops import score_variants as sv
    t_kx = time.perf_counter()
    B, R, L, W = sv.HARNESS_SHAPE
    if rehearse:
        B, R = 8, 16
    kx_runner, runner_rows = phase_kx_runner(torch, sv, sk, dev, cuda, B, R)
    kx_shapes = [(B, R, L, W), (256, 128, 160, 256)]
    kx_hap = [(B // 2, R, L, W), (128, 128, 160, 256)]
    if rehearse:
        kx_shapes = [(B, R, L, W), (4, 32, 160, 64)]
        kx_hap = [(B // 2, R, L, W), (2, 32, 160, 64)]
    kx_edge = [("ties", (8, 32, 32, 96) if rehearse else (64, 32, 128, 320),
                k1_ties),
               ("ties", (4, 32, 64, 64) if rehearse else (16, 128, 160, 256),
                k1_ties),
               ("ragged", (3, 40, 100, 70), k1_random),
               ("code4", (4, 32, 64, 64), k1_code4)]
    kx_rows = phase_kx(np, torch, dev, cuda, kx_shapes, kx_hap, kx_edge,
                       runner_rows)
    log(f"phase 2c took {time.perf_counter() - t_kx:.1f} s")

    log("== phase 3: snv tiles vs the CPU path")
    phase_snv(np, torch, dev, cuda, 2000 if rehearse else 200_000)

    log("== phase 3b: somatic SNV model vs the CPU path")
    phase_somatic_snv(np, torch, dev, 2000 if rehearse else 200_000)

    workdir = os.path.join(HERE, "build", "smoke")
    log(f"== phase 4: germline --device {dev.type} end to end")
    fa, bam, n_reads = make_dataset(np, workdir, mb)
    out_dev = os.path.join(workdir, f"out_{dev.type}")
    launches, h_launches, score_shapes, kx_germline = phase_e2e(
        torch, cuda, fa, bam, n_reads, mb, out_dev, dev.type)
    # k1 again at the main path's most frequent launch shape
    top = max(score_shapes, key=score_shapes.get)
    rows, err = phase_k1(np, torch, dev, cuda, [top],
                         iters=1 if rehearse else 20, edge_cases=False)
    k1_rows.append(dict(rows[0], case="main_path_top"))
    k1_err = max(k1_err, err)

    if cuda:
        log("== phase 5: the same run with --device cpu")
        out_cpu = os.path.join(workdir, "out_cpu")
        wall_cpu = run_cli(fa, bam, out_cpu, "cpu")
        n, other = compare_runs(out_dev, out_cpu)
        log("cuda-vs-cpu: " + json.dumps({
            "records": n, "differ_other_fields": other,
            "cpu_wall_s": wall_cpu}))

    log(f"== phase 6: somatic --device {dev.type} end to end")
    tn = make_tn_dataset(np, workdir, tn_mb)
    fa_tn, nbam, tbam, n_tn, som_snv = tn
    som_dev = os.path.join(workdir, f"som_{dev.type}")
    som_launches, som_h_launches, kx_somatic = phase_somatic_e2e(
        torch, cuda, fa_tn, nbam, tbam, n_tn, som_snv, tn_mb, som_dev,
        dev.type)
    if cuda:
        log("== phase 7: the same somatic run with --device cpu")
        som_cpu = os.path.join(workdir, "som_cpu")
        phase_somatic_e2e(torch, False, fa_tn, nbam, tbam, n_tn, som_snv,
                          tn_mb, som_cpu, "cpu")
        n, other = compare_somatic_runs(som_dev, som_cpu)
        log("somatic cuda-vs-cpu: " + json.dumps({
            "records": n, "differ_other_fields": other}))

    log(f"total {time.perf_counter() - t_start:.1f} s")

    top = k1_rows[-1]
    k1h = k1h_rows[0]   # bench.py's shape
    kernels = [{
        "name": "score_best_offsets",
        "route": "cuda",
        "source": "strelka_tpu_torch/csrc/score_best_offsets.cu",
        "replaces": "strelka_tpu/ops/pallas_readlik.py:76",
        "launches": launches + som_launches + kx_runner["k1"],
        "launches_by_path": {"germline": launches,
                             "somatic": som_launches,
                             "variants_runner": kx_runner["k1"]},
        "max_abs_err": k1_err,
        "shape": top["shape"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
    }, {
        "name": "score_best_offsets_highest",
        "route": "cuda",
        "source": "strelka_tpu_torch/csrc/score_best_offsets.cu",
        "replaces": "strelka_tpu/ops/pallas_readlik.py:170",
        # counted in phases 4 and 6 like K1; no CLI path runs
        # mode="highest", so phase 2b alone is expected to launch it
        "launches": h_launches + som_h_launches + kx_runner["k1h"],
        "launches_by_path": {"germline": h_launches,
                             "somatic": som_h_launches,
                             "variants_runner": kx_runner["k1h"]},
        "max_abs_err": k1h_err,
        "tolerance": f"atol {K1H_ATOL} (quantized deltas); f32 rounding "
                     f"bound (unquantized)",
        "shape": k1h["shape"],
        "ms": k1h["ms"],
        "plain_ms": k1h["plain_ms"],
        "bound_ms": k1h["bound_ms"],
        "bound_by": k1h["bound_by"],
        "library_ms": None,
    }]
    for kind, k in sv.KERNELS.items():
        rows = kx_rows[kind]
        top = rows[0]   # the harness's shape
        c = k.counter
        kernels.append({
            "name": k.label,
            "route": "cuda",
            "source": sv.SOURCE,
            "replaces": k.replaces,
            "launches": kx_runner[c] + kx_germline[c] + kx_somatic[c],
            "launches_by_path": {"germline": kx_germline[c],
                                 "somatic": kx_somatic[c],
                                 "variants_runner": kx_runner[c]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": "bit for bit",
            "shape": top["shape"] + ([sv.HAP_WINDOWS] if kind == "hap"
                                     else []),
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "k1_ms": top["k1_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            # no PyTorch call computes max and first argmax over the
            # product (torch._int_mm gives only KX-I's product)
            "library_ms": None,
        })
    if rehearse:
        log(json.dumps({"kernels": kernels}))
        log("rehearsal done (CPU): no result line")
        return 0
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
