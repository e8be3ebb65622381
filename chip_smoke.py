#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (strelka_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card, default sizes

Phases, each of which fails the run (non-zero exit, no result line):

1. build: the host library (make -C native) and every CUDA kernel of
   strelka_tpu_torch/csrc (one nvcc per source, started together);
2. k1: the scoring kernel (u8 tensor cores, csrc/score_best_offsets_tc.cu)
   against its plain torch version on the card, bit for bit, at the main
   path's shapes plus tie, ragged and code-4 cases, timed by CUDA events
   beside the plain version, K1-s (the earlier SIMT kernel, held bit for
   bit too) and the library route, with each time's share of the bound;
2b. k1h: mode="highest" on the bf16 tensor cores (K1-h,
   csrc/score_highest_tc.cu) and K1-h-s (its SIMT before-number) against
   their plain version (one-hot f32 bmm), scores within 1e-4 (with the
   LUT's deltas, whose sums are exact in any order, max_abs_err 0
   expected) and offsets equal outside near-ties, at bench.py's shape
   and two main-path shapes plus ties, ties across N tiles, ragged and
   code-4 cases, timed beside the plain version and the library route;
   plus bench.py's unquantized deltas held per row to the f32 bound
   2 (L+1) 2^-24 (sum|terms| + |lnmis|), which the tensor cores' worst
   case (3L/4 truncations of a score, 1.5 L 2^-24 sum) fits;
2c. kx: the K1-x variants' runner (python -m
   strelka_tpu_torch.ops.score_variants) on every variant name of the
   harness at its shapes, with the launch counters set to 0 just before
   and read just after (every variant equal to its body's function,
   every K1-x kernel and K1 launched, the SIMT before-numbers K1-s,
   KX-P-s, KX-K-s, KX-H-s and the four KX-A-s no time); its times are
   the kernels' times at the harness's shape. Then each kernel of
   ops/score_variants.KERNELS (KX-P, KX-H and the four ablations noA,
   noW, nomax and nodot on K1's u8 tensor-core pipeline, KX-K on K1-h's
   bf16 one, KX-I on K1's u8 pipeline with the limbs clamped, their
   before-numbers, and K1-s) against its
   plain version bit for bit at the harness's shape and the main
   path's, with tie, ragged and code-4 cases (KX-H also ties at its
   window boundaries and windows of 96 and 160 offsets; KX-K also its
   largest sum, L = 256 with every v = 0xFFFF; the ablations also L =
   224, where K1's pipeline keeps A in its ring, nodot at R = 4L and W
   = 4L and ties across N tiles, nomax ties across N tiles, KX-I and its
   mma.sync before-number limbs at 126, 127, 128 and 255 with negative
   deltas and ties across N tiles, noA, noW
   and nomax at L = 1000; noW, whose rows name the plan it took (S: a
   group's window expanded once into a slab; R: K1's ring on it), in
   plan S at the harness's shape and at 256,32,160,192, in plan R at
   the main path's, and with a partial last group in both); its plain
   version and library route timed at both shapes, the kernel and K1
   at the main path's (the before-numbers, which no variant name runs,
   at both; noW also at 256,32,160,192);
   KX-K's row also carries its design's own floor, two bf16 passes of
   the one-hot product;
3. snv: the SNV tile functions on the card against the port's CPU path
   (integer fields equal, lhood bit-equal), and RNA mode's tiles (the
   het-VF extension with per-call dependent-eprob deltas, at a tile's
   own D and in chunks padded to 32) with lhood, strand bias and the
   integer fields bit-equal; then KG-H (csrc/snv_hist_tile.cu, the
   germline histogram tile) against its plain version on the card, every
   field bit for bit (a NaN as a NaN), at D = 32, 96 and 127, int32
   counts, rows that s_mis makes -inf or NaN, rows without calls (ties),
   a ragged and a one-row tile, timed at the main path's chunk by CUDA
   events and by graph replay beside the plain version, with a
   torch.profiler trace of one call of each (kernels and device us);
3b. somatic: the somatic SNV model on the card against the port's CPU
   path on a 200,000-row random tile (grid states bit-equal, integer
   fields equal); KS-G (csrc/somatic_grid.cu) and KS-P
   (csrc/somatic_posterior.cu) against their plain versions on the card
   bit for bit at its edges: KS-G at D = 32 and 96 on the native
   pileup's int8 base and int16 qual lanes (q = 0 calls, masked lanes,
   all-masked rows), on int32 lanes (the Python pileup's, which
   freq_grid_lhoods casts), a ragged and a one-row tile, KS-P on
   all -inf normal or tumour rows, -inf normal pre-strand states, tied
   states and a one-row tile (both are timed at the main path's shape
   in phase 6b); KS-G on tiles at the qualities runs give (every call at
   32, binned Illumina qualities, all 128 slots live) at D = 64 and 200
   and KS-P on their lhoods with NaN and +inf rows, 20,000 rows each;
   and the peak bytes per row of the plain versions and
   of the kernels against the sizes from which the port chooses its
   chunk heights;
4. e2e: the germline CLI with --device cuda (WGS mode) on a synthetic
   contig (default 4 Mb at 30x, 150 bp reads), with the launch counters
   set to 0 just before and read just after (the K1-x kernels' and
   K1-s's must read 0, KG-H must read the SNV tile tally and no plain
   SNV model version may run on the card), K1's launches by shape and
   its stream ms;
5. cuda-vs-cpu: the same CLI with --device cpu on the same data; no
   record may differ in CHROM, POS, REF, ALT, FILTER or GT;
6. somatic e2e: the somatic CLI with --device cuda (WGS mode) on a
   synthetic tumor/normal contig (default 2 Mb, normal 30x, tumor 60x,
   150 bp reads), counters set to 0 just before and read just after
   (KS-G and KS-P must read the grid and posterior tallies, no plain
   version may run on the card), K1's launches by shape and its stream
   ms; 90% or more of the
   planted somatic SNVs must be called with FILTER PASS;
6b. KS-G and KS-P at the main path's shape: phase 6's first two grid
   calls (the first chunk's normal and tumour: up to MAX_ROWS rows of
   the native pileup's int8/int16 lanes at its padded depth) and its first
   posterior call, kept as the CLI made them, replayed through each
   kernel and held bit for bit against its plain version (over the
   plain chunk heights of rows_per_launch), timed and traced as KG-H;
   with the live qscore slots a row (mean, max), KS-G's library route
   (ksg_library_route) as library_ms, each kernel's registers and spills
   (nvcc -Xptxas -v), KS-P's terms (rows without NaN or +inf lhoods, the
   share of terms whose exp is +0 on the card, the sweep's threshold) and
   its float64 floor from the SASS (ksp_fp64_floor);
7. somatic cuda-vs-cpu: the same with --device cpu; no record may
   differ in CHROM, POS, REF, ALT, FILTER, QSS/QSI or NT;
8. germline fan-out: phase 4's contig with --jobs 4 (one 1 Mb segment a
   worker), started cold (the host library removed and every kernel
   library stale, so that the --jobs parent builds each once before it
   spawns and no worker builds one), the parent in a process of its own
   that must end with CUDA uninitialized; every record equal to phase
   4's; the workers' launches from their STRELKA_TPU_LAUNCH_STATS
   dumps, each worker's wall (its taskstate) and peak reserved device
   memory (its log);
9. somatic fan-out: phase 6's T/N contig with --jobs 4 (four 500 kb
   segments, four posteriors sharing the card's memory budget); every
   record equal to phase 6's, PASS recall of the planted SNVs;
10. joint germline: three samples of one 1 Mb contig (shared reference
   and planted variants, 30x each), --device cuda and --device cpu with
   identical records in variants.vcf.gz and genome.S{1,2,3}.vcf.gz; the
   calls at the planted sites per sample;
11. CRAM: germline --device cuda on tests/data/cram/synth.cram (the
   repository has no CRAM writer: the fixture is the only CRAM input)
   and on synth.bam, with identical records. The fixture's pairs are
   all improper, so no read reaches tier 1 and K1 is launched no time.
12. EVS model files: phase 4's contig with SNV and indel forests that
   forest_json writes from numpy seed 12 (the card's machine has no
   sklearn), cuda then cpu, every record equal; the records EVS changed
   against phase 4 (none fails);
13. continuous-VF: germline --call-continuous-vf on phase 4's contig's
   first CONT_MB Mb (host code: no K1, no SNV tile), cuda then cpu,
   every record equal;
14. RNA: germline --rna --disable-evs on phase 4's contig's first
   RNA_MB Mb (2 of its 4, for the time limit), cuda then cpu, every
   record equal; the SNV tiles' launches and stream ms on the card (the
   het-VF extension there);
15. error estimation: germline --estimate-sequence-error on phase 4's
   contig's first CONT_MB Mb, cuda then cpu: the allele counts' npz
   arrays equal, the model's rates within ERR_FLAT_RTOL, every record
   equal, K1's launches counted on the cuda run; then tools
   estimate-parameters <npz> indelIndy, cuda against cpu within
   ERR_FIT_RTOL, on three of the counts' contexts. It logs the
   counting's host wall, the fit's wall, Adam steps, launches a step
   (a torch.profiler trace of a short fit) and stream ms, and each
   run's wall.
Phases 12-15 log each run's size, wall and stream ms by device phase.
16. denovo: per-sample mode on phase 10's gVCFs (sample 1 the proband)
   and multi-sample mode on its variants.vcf.gz (host code): every input
   record kept, changed in DQ alone; the scored sites logged;
17. noise panel: two more 30x normals of phase 6's reference over its
   first NOISE_MB Mb through noise-extractor, then the somatic CLI with
   --noise-vcf on phase 6's T/N over that --region, cuda then cpu (every
   record equal), and on cuda without the panel (the records whose
   PNOISE/PNOISE2 or FILTER moved logged);
18. sim: SIM_SITES het and hom-ref sites from simulate_germline_sites
   through the SNV tiles and SIM_STRELKA sites of each state from
   simulate_strelka_sites through the somatic SNV model, cuda then cpu,
   every field equal; tests/test_simulators.py's gates on the card's
   results (het rate > 0.97, FP rate < 0.01 at Q >= 30; somatic Q >= 15
   in > 90% of SOMATIC sites and < 5% of REF and GERMLINE ones); the
   counters set to 0 just before each run and read just after (the
   card's run: KG-H, KS-G and KS-P once a tally, no plain version);
19. mesh: germline --mesh auto and --mesh 1 on phase 4's data and
   somatic --mesh 1 on phase 6's (every record equal to phases 4 and 6,
   the counters set to 0 just before each and read just after: K1 one
   launch a shard, the SNV model kernels once a tally);
   sharded_best_offsets over meshes that repeat the card at MESH_SHAPES and 256,32,160,192 with padding-window ties and
   all-N reads, bit for bit one unsharded K1 launch, one launch a shard;
   the SNV and somatic chunks split over the card four times, bit for
   bit; dryrun(1); --mesh past the visible cards exits 2. The card's
   machine has one card, so a mesh's shards there run on one card.

The second-to-last lines are the card's name and power limit
(nvidia-smi) and one JSON line {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Work files go to build/smoke/.

A kernel's ms is CUDA events around calls from the host, which also
hold the wrapper's host time wherever that is longer than the kernel;
its device_ms is the replay of 20 calls captured in one CUDA graph
(graph_ms), the kernel alone.

library_ms is the yardstick of a kernel's function in PyTorch calls:
one f32 torch.bmm of the one-hot or limb slabs (TF32 off, operands built
before the timer), the elementwise combine and torch.max over offsets
(library_route; nodot, which has no product, adds its two slab slices),
checked against the plain version bit for bit (library_equal). No path
of the port calls it.

--rehearse runs the same control flow on the CPU at a small size (the
kernel checks then hold the plain version against itself) and prints
no result line; it is for checking the script without a card.

--mesh-cards runs, after the build, only the engine mesh over every
visible card (two or more; phase_mesh_cards: K1 on each card, K1 sharded
over the cards, germline and somatic with --mesh against without, on a
1 Mb contig and a 0.5 Mb T/N contig) and prints no result line; with
--rehearse, over the CPU four times.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 and bf16
# tensor-core operations/s and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
# float64 outside the tensor cores (NVIDIA data sheet, H100 SXM)
F64_OPS_PER_S = 34e12
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
        self.host: dict[str, list] = {}
        self.kept: dict[str, list] = {}
        self.patched = []

    def wrap(self, mod, name: str, phase: str, keep: int = 0):
        """Time every call of mod.name under `phase`; the arguments of
        the first `keep` calls go to self.kept[phase]."""
        fn = getattr(mod, name)
        torch = self.torch
        kept = self.kept.setdefault(phase, [])

        def timed(*a, **k):
            if len(kept) < keep:
                kept.append((a, k))
            if self.cuda:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.host.setdefault(phase, []).append(
                    (time.perf_counter() - t0) * 1e3)
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

    def host_ms(self, phase: str) -> list[float]:
        """Each call's host wall of `phase` (ms; on a card the host's
        part of its span: while the stream has nothing queued, the span
        holds this host time too), in call order."""
        return list(self.host.get(phase, []))

    def per_call_ms(self, phase: str) -> list[float]:
        """Each call's span of `phase` (ms), in call order."""
        if self.cuda:
            self.torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in self.spans.get(phase, [])]
        return list(self.spans.get(phase, []))

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


def graph_ms(torch, fn, iters: int = 20, reps: int = 3) -> float:
    """Device ms a call of `fn`, with no host work between the calls:
    `iters` calls captured in one CUDA graph, its replay timed by CUDA
    events, the least of `reps` replays. time_ms's events around calls
    from the host also hold the wrapper's host time wherever that is
    longer than the kernel."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
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
    del g
    return best


def device_share(row) -> None:
    """The row's bound over its device_ms (and prev_device_ms), where
    those were measured."""
    for key in ("device", "prev_device"):
        if f"{key}_ms" in row:
            row[f"{key}_bound_share"] = row["bound_ms"] / row[f"{key}_ms"]


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


def k1h_bound_ms(B, R, L, W) -> tuple[float, str, str]:
    """K1-h's least time: K1's bytes against the operations of the
    fastest engine that computes the function at f32 accuracy, the bf16
    tensor cores' three passes of the one-hot product (3 * 2*B*R*4L*W at
    989 TFLOP/s) or the CUDA cores' 2*B*R*L*W f32 operations (67
    TFLOP/s), whichever takes less. Returns (ms, "bytes" or
    "operations", the engine that sets it)."""
    engines = [(3 * 2 * B * R * 4 * L * W, BF16_OPS_PER_S,
                "bf16 tensor cores"),
               (2 * B * R * L * W, F32_OPS_PER_S, "f32 CUDA cores")]
    ops, peak, engine = min(engines, key=lambda e: e[0] / e[1])
    ms, by = bound_ms(k1_bytes(B, R, L, W), ops, peak)
    return ms, by, engine if by == "operations" else "HBM"


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


def library_route(torch, kind, codes, delta, lnmis, win, H=1, G=1):
    """The library yardstick of a kernel's function on its standard
    operands: the operands built here, before any timer, and the call
    to time, which returns (best, off): one f32 torch.bmm of the one-hot
    or limb slabs (TF32 off), the elementwise combine and torch.max over
    the offsets. kind (sv.KERNELS[...].function): "k1" (K1's function,
    limb slabs stacked along M: K1, K1-s, KX-P), "onesum" (one slab of
    limb_1*256 + limb_0: KX-K), "int8" (K1's on limbs clamped to 127:
    KX-I), "hap" (K1's against H windows in one bmm: KX-H), "highest"
    (deltas times the one-hot: K1-h), or an ablation of KX-A: "noA"
    (the limbs [B,2R,L] against the window's [0 <= win < 4], a product
    over L), "noW" (K1's limb slabs of a group of G pairs stacked along
    M against the one-hot of the group's first window; where G does not
    divide B, K1's route on the gathered windows), "nomax" (K1's route
    with torch.amax, offsets 0) or "nodot" (no product: the slab slices
    A[:, :R, :W] and Wo[:, :R, :W] added). No path of the port calls
    these routes."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the library yardstick would not be f32")
    B, R, L = codes.shape
    W = win.shape[2] // H
    ls = lnmis[..., None]
    d = (delta * 2048.0).to(torch.int32)

    def combine(p):   # limb sums [B,2R,W'] -> s [B,R,W']
        return (p[:, :R] * 256.0 + p[:, R:]) * (1.0 / 2048.0) + ls
    if kind == "noA":
        a = torch.cat([(d >> 8) & 255, d & 255], dim=1).float()  # [B,2R,L]
        valid = ((win >= 0) & (win < 4)).float()                 # [B,L,W]

        def call():
            return torch.max(combine(torch.bmm(a, valid)), dim=-1)
        return call
    c = codes.long()
    if kind == "nodot":
        hi = (d >> 8) & 255
        a = torch.cat([torch.where(c == k, hi, 0) for k in range(4)],
                      dim=2)[:, :, :W].float().contiguous()      # [B,R,W]
        wo = torch.cat([win.long() == k for k in range(4)],
                       dim=1)[:, :R].float().contiguous()        # [B,R,W]

        def call():
            return torch.max((a + wo) * (1.0 / 2048.0) + ls, dim=-1)
        return call
    oh_r = torch.stack([c == k for k in range(4)], dim=-1)     # [B,R,L,4]
    oh_w = torch.stack([win.long() == k for k in range(4)], dim=2)
    oh_w = oh_w.float().reshape(B, 4 * L, H * W)               # k = 4l + c
    if kind == "highest":
        a = (oh_r.float() * delta[..., None]).reshape(B, R, 4 * L)

        def call():
            return torch.max(torch.bmm(a, oh_w) + ls, dim=-1)
        return call
    limbs = ([d & 0xFFFF] if kind == "onesum"
             else [(d >> 8) & 255, d & 255])
    if kind == "int8":
        limbs = [x.clamp(max=127) for x in limbs]
    a = torch.cat([(oh_r * x[..., None]).reshape(B, R, 4 * L)
                   for x in limbs], dim=1).float()             # [B,nR,4L]
    if kind == "onesum":
        def call():
            return torch.max(torch.bmm(a, oh_w) * (1.0 / 2048.0) + ls,
                             dim=-1)
        return call
    if kind == "noW" and B % G == 0:
        ag = a.reshape(B // G, G * 2 * R, 4 * L)
        firsts = oh_w[::G].contiguous()                        # [B/G,4L,W]

        def call():
            p = torch.bmm(ag, firsts).view(B, 2 * R, W)
            return torch.max(combine(p), dim=-1)
        return call
    if kind == "noW":
        oh_w = oh_w[torch.arange(B, device=codes.device) // G * G]
    if kind == "nomax":
        zeros = torch.zeros((B, R), dtype=torch.int64, device=codes.device)

        def call():
            return torch.amax(combine(torch.bmm(a, oh_w)), dim=-1), zeros
        return call

    def call():
        s = combine(torch.bmm(a, oh_w))
        return torch.max(s.view(B, R, H, W) if H > 1 else s, dim=-1)
    return call


def library_row(torch, call, want, timer) -> dict:
    """library_ms of `call` by `timer`, and whether its (best, off)
    equals `want` bit for bit (library_equal)."""
    lb, lo = call()
    equal = (torch.equal(lb.view(torch.int32), want[0].view(torch.int32))
             and torch.equal(lo.int(), want[1].int()))
    return {"library_ms": timer(call), "library_equal": equal}


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
    so offsets w and w+L tie, across K1's 64-offset N tiles and K1-s's
    128-offset chunks) plus one near-tie per pair a single q=2 base
    away."""
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


def k1_tile_ties(np, rng, B, R, L, W):
    """Each pair's reads all carry one sequence, and two offsets of its
    window carry it exactly, so they tie at the top for every read: on
    both sides of, left of, right of and a tile across a boundary of
    K1's N tiles, the pairs taking the boundaries and placements in
    turn."""
    from strelka_tpu_torch.ops import readlik
    from strelka_tpu_torch.ops.score_kernel import TC_N_TILE as n_tile
    dl, ll = readlik.quantized_qscore_luts()
    cols = [(t + a, t + b) for t in range(n_tile, W, n_tile)
            for a, b in ((-1, 0), (-2, -1), (0, 1), (-1, n_tile))
            if t + b < W]
    reads = rng.integers(0, 4, (B, L))
    codes = np.repeat(reads[:, None], R, axis=1).astype(np.int8)
    q = rng.integers(2, 42, (B, R, L))
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b in range(B):
        for w in cols[b % len(cols)]:
            win[b, :, w] = reads[b]
    lnmis = ll[q].sum(axis=2).astype(np.float32)
    return codes, dl[q], lnmis, win


def onesum_max(np, rng, B, R, L, W):
    """KX-K's largest sums: every read all code 0 with d_int & 0xFFFF =
    0xFFFF (delta 65535 * 2^-11 in even pairs, -2^-11 in odd ones: a
    negative d_int keeps its low 16 bits), the window all code 0 but at
    odd offsets, so the even offsets sum S = 65535 * L (16,776,960 <
    2^24 at L = 256) and tie, the first of them winning."""
    codes = np.zeros((B, R, L), np.int8)
    delta = np.where(np.arange(B)[:, None, None] % 2 == 0,
                     np.float32(65535 / 2048), np.float32(-1 / 2048))
    delta = np.broadcast_to(delta, (B, R, L)).astype(np.float32)
    lnmis = rng.normal(-100, 10, (B, R)).astype(np.float32)
    win = np.zeros((B, L, W), np.int8)
    win[:, :, 1::2] = rng.integers(0, 5, (B, L, W // 2))
    return codes, delta, lnmis, win


def hap_window_ties(np, rng, B, R, L, W):
    """KX-H's windows (W = H * Wh, H = HAP_WINDOWS): every read of a
    pair carries one sequence, found exactly at the last offset of
    window h and at the first of window h+1, and in odd pairs also at
    both sides of window 0's first N-tile boundary (where Wh allows):
    a window's best must not leak into the next."""
    from strelka_tpu_torch.ops import readlik
    from strelka_tpu_torch.ops import score_variants as sv
    from strelka_tpu_torch.ops.score_kernel import TC_N_TILE as n_tile
    dl, ll = readlik.quantized_qscore_luts()
    wh = W // sv.HAP_WINDOWS
    reads = rng.integers(0, 4, (B, L))
    codes = np.repeat(reads[:, None], R, axis=1).astype(np.int8)
    q = rng.integers(2, 42, (B, R, L))
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b in range(B):
        cols = [c for h in range(1, sv.HAP_WINDOWS) for c in
                (h * wh - 1, h * wh)]
        if b % 2 and wh > n_tile:
            cols += [n_tile - 1, n_tile]
        for w in cols:
            win[b, :, w] = reads[b]
    lnmis = ll[q].sum(axis=2).astype(np.float32)
    return codes, dl[q], lnmis, win


def nodot_tile_ties(np, rng, B, R, L, W):
    """nodot's ties across N tiles: deltas below 2^-3 (limb 1 = 0, so
    its A slab is 0) and windows of codes 1..4 but for code 0 at two
    offsets of window row r, for each read r, so that read r's row of
    the Wo slab (code r div L = 0) is 1 there alone: on both sides of,
    left of, right of and a tile across a boundary of K1's N tiles, the
    reads taking the placements in turn. The first of the two wins.
    Needs R <= L and W > 64."""
    from strelka_tpu_torch.ops.score_kernel import TC_N_TILE as n_tile
    cols = [(t + a, t + b) for t in range(n_tile, W, n_tile)
            for a, b in ((-1, 0), (-2, -1), (0, 1), (-1, n_tile))
            if t + b < W]
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    delta = (rng.integers(0, 256, (B, R, L)) / 2048).astype(np.float32)
    lnmis = rng.normal(-100, 10, (B, R)).astype(np.float32)
    win = rng.integers(1, 5, (B, L, W)).astype(np.int8)
    for r in range(R):
        for w in cols[r % len(cols)]:
            win[:, r, w] = 0
    return codes, delta, lnmis, win


def int8_limbs(np, rng, B, R, L, W):
    """KX-I's clamp: each limb of d_int one of 126, 127, 128 and 255, a
    quarter of the deltas negative (their two's complement bytes clamp),
    codes -1..4 and windows -1..4."""
    edge = np.array([126, 127, 128, 255])
    d = (edge[rng.integers(0, 4, (B, R, L))] * 256
         + edge[rng.integers(0, 4, (B, R, L))])
    d = np.where(rng.random((B, R, L)) < 0.25, -d, d)
    return (rng.integers(-1, 5, (B, R, L)).astype(np.int8),
            (d / 2048).astype(np.float32),
            rng.normal(-80, 10, (B, R)).astype(np.float32),
            rng.integers(-1, 5, (B, L, W)).astype(np.int8))


def k1_code4(np, rng, B, R, L, W):
    """Random inputs with pair 0's reads all code 4 under non-zero
    deltas and its window code 4 at the first 7 offsets: pair 0 scores
    exactly lnmis at offset 0."""
    codes, delta, lnmis, win = k1_random(np, rng, B, R, L, W)
    codes[0] = 4
    win[0, :, :7] = 4
    return codes, delta, lnmis, win


# the variant whose runner time is each K1-x kernel's at the harness's
# shape: the kernel alone, on operands staged as it takes them (K1-s,
# which no variant name runs, is timed by phase_kx itself)
KX_TIMED_BY = {"packed": "fusedin", "packed_fold": "fusedlm",
               "onesum": "limb2k", "hap": "hap2", "int8": "int8",
               "noA": "limb2-noA", "noW": "limb2-noW",
               "nomax": "limb2-nomax", "nodot": "limb2-nodot"}


def kx_before(sv) -> dict[str, str]:
    """{redesigned K1-x kind: its SIMT before-number's kind} in
    sv.KERNELS (K1-s stands beside K1, which is not a K1-x kernel)."""
    kind_of = {k.label: kind for kind, k in sv.KERNELS.items()}
    return {kind_of[k.before_of]: kind for kind, k in sv.KERNELS.items()
            if k.before_of in kind_of}


def onesum_floor_ms(B, R, L, W) -> float:
    """KX-K's design floor: its two bf16 passes of the one-hot product,
    2 * 2*B*R*4L*W operations at the bf16 tensor-core peak."""
    return 2 * 2 * B * R * 4 * L * W / BF16_OPS_PER_S * 1e3


def kx_zero(sv):
    for k in sv.KERNELS.values():
        setattr(sv, k.counter, 0)


def kx_read(sv) -> dict[str, int]:
    return {k.counter: getattr(sv, k.counter) for k in sv.KERNELS.values()}


def phase_kx_runner(torch, sv, sk, dev, cuda: bool, B: int, R: int):
    """The variants runner, this slice's path, on every variant name,
    with every counter set to 0 just before and read just after. Fails
    unless every variant equals its body's function and, on the card,
    every K1-x kernel and K1 launched, and the SIMT before-numbers
    (K1-s, KX-P-s, KX-K-s, KX-H-s and the four KX-A-s) no time.
    Returns (counters, {name: row})."""
    names = [*sv.K1_VARIANTS, "limb2r@8", "fused", "fusedwhole", "fusedin",
             "fusedlm", "limb2k", "hap2", "int8", "limb2-noA", "limb2-noW",
             "limb2-nomax", "limb2-nodot"]
    kx_zero(sv)
    sk.LAUNCHES = 0
    sk.LAUNCHES_HIGHEST = 0
    sk.LAUNCHES_HIGHEST_SIMT = 0
    try:
        rows = sv.run(names, dev.type, B, R)
    finally:
        got = kx_read(sv)
        got["k1"] = sk.LAUNCHES
        got["k1h"] = sk.LAUNCHES_HIGHEST
        got["k1h_simt"] = sk.LAUNCHES_HIGHEST_SIMT
    bad = [r["name"] for r in rows if not r["body_exact"]]
    if bad:
        fail(f"the variants runner: {bad} differ from their body's function")
    runs = {sv.KERNELS[k].counter for k in KX_TIMED_BY} | {"k1"}
    idle = [c for c, n in got.items() if c in runs and n == 0]
    if cuda and idle:
        fail(f"the variants runner launched {idle} no time")
    before = [sv.KERNELS[k].counter for k in sv.KERNELS
              if k not in KX_TIMED_BY]
    ran = [c for c in before if got[c]]
    if ran:
        fail(f"the variants runner launched the before-numbers {ran}")
    log("kx runner launches: " + json.dumps(got))
    return got, {r["name"]: r for r in rows}


def phase_kx(np, torch, dev, cuda: bool, shapes, hap_shapes, edge,
             kind_edge, runner):
    """Each K1-x kernel against its plain version, bit for bit, at
    `shapes` (hap: `hap_shapes`, B loci x sv.HAP_WINDOWS windows of W) on
    random inputs (code 4 under non-zero deltas), plus the `edge` cases
    (ties, ragged, code 4) and those of `kind_edge` (its kinds only). At
    the first shape, the harness's, the kernel's and K1's times are the
    runner's (`runner` rows); at the others both are timed here, K1 at
    the same shape (hap: one launch a window). The plain version and the
    library route of the function (Kernel.function) are timed at each
    shape; the redesigned kernels' rows (kx_before) get their SIMT
    before-number's time at the same shape as prev_ms, and KX-K's its
    design floor. Returns {kind: rows}."""
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.ops import score_variants as sv
    rng = np.random.default_rng(2026)
    H, G = sv.HAP_WINDOWS, sv.DEFAULT_G
    before = kx_before(sv)
    # the operands whose bound a before-number's row carries: its redesign's
    bound_kind = {v: k for k, v in before.items()}
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
        hap = kind in sv.HAP_KINDS
        cases = [("random", s, k1_random)
                 for s in (hap_shapes if hap else shapes)] + edge + [
                     c for kinds, cs in kind_edge for c in cs
                     if kind in kinds]
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
            if k.function == "noW":
                row["G"] = G
                if kind == "noW":
                    row["plan"] = sv.now_plan(B, R, L, W, G, dev)
            if case == "random":
                if i == 0 and kind in KX_TIMED_BY:
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
                    if i == 0:
                        row["timed_by"] = "phase_kx"
                if cuda:
                    row["device_ms"] = graph_ms(torch, lambda: k.call(*args))
                row["plain_ms"] = ms(lambda: k.plain(*args), 5, 1)
                row.update(library_row(torch, library_route(
                    torch, k.function, *t, H if hap else 1, G), want, ms))
                row["bound_ms"], row["bound_by"] = kx_bound_ms(
                    bound_kind.get(kind, kind), B, R, L, W, H if hap else 1,
                    G)
                if kind == "onesum":
                    row["design_floor_ms"] = onesum_floor_ms(B, R, L, W)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                device_share(row)
            rows.append(row)
            log(f"kx {k.label}: " + json.dumps(row))
            del t, args, got, want
        out[kind] = rows
    for kind, prev in before.items():
        for row, before in zip(out[kind], out[prev]):
            for key in ("ms", "device_ms"):
                if key in row:
                    row[f"prev_{key}"] = before[key]
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
    under non-zero deltas), plus exact ties across N tiles and offset
    chunks, a ragged shape and code 4 against window code 4; K1-s held
    to the same plain version. At each random shape the kernel, K1-s
    (prev_ms), the plain version and the library route (library_route
    "k1") are timed, and the kernel's time set against the bound
    (bound_share). Returns per-case rows."""
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.ops import score_variants as sv
    rng = np.random.default_rng(2024)
    rows = []
    cases = [("random", s, k1_random) for s in shapes]
    if edge_cases:
        cases += [("ties", (64, 32, 128, 320), k1_ties),
                  ("ties", (16, 128, 160, 256), k1_ties),
                  ("tile_ties", (64, 40, 160, 320), k1_tile_ties),
                  ("tile_ties", (32, 128, 128, 192), k1_tile_ties),
                  ("ragged", (3, 40, 100, 70), k1_random),
                  ("code4", (4, 32, 160, 192), k1_code4)]
    max_err = 0.0
    for kind, (B, R, L, W), make in cases:
        arrs = make(np, rng, B, R, L, W)
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        pb, po = sk.exact_best_offsets(*t)
        for name, fn in (("k1", sk.score_best_offsets),
                         ("k1-s", sv.score_simt)):
            kb, ko = fn(*t)
            if cuda:
                torch.cuda.synchronize()
            if not torch.equal(kb, pb) or not torch.equal(ko, po):
                nb = int((kb != pb).sum())
                no = int((ko != po).sum())
                fail(f"{name} {kind} {[B, R, L, W]}: kernel differs from "
                     f"the plain version ({nb} scores, {no} offsets)")
            if name == "k1":
                err = float((kb - pb).abs().max())
        max_err = max(max_err, err)
        row = {"case": kind, "shape": [B, R, L, W], "max_abs_err": err}
        if kind == "random":
            row["ms"] = time_ms(torch, cuda,
                                lambda: sk.score_best_offsets(*t), iters)
            row["prev_ms"] = time_ms(torch, cuda,
                                     lambda: sv.score_simt(*t), iters)
            if cuda:
                row["device_ms"] = graph_ms(
                    torch, lambda: sk.score_best_offsets(*t))
                row["prev_device_ms"] = graph_ms(
                    torch, lambda: sv.score_simt(*t))
            # the wrapper's host time a call (checks, outputs, launch),
            # which the phase 4 and 6 stream spans also hold
            t0 = time.perf_counter()
            for _ in range(iters):
                sk.score_best_offsets(*t)
            row["wrapper_host_ms"] = (time.perf_counter() - t0) * 1e3 / iters
            if cuda:
                torch.cuda.synchronize()
            row["plain_ms"] = time_ms(torch, cuda,
                                      lambda: sk.exact_best_offsets(*t),
                                      max(1, iters // 5), warm=1)
            row.update(library_row(
                torch, library_route(torch, "k1", *t), (pb, po),
                lambda f: time_ms(torch, cuda, f, iters)))
            row["bound_ms"], row["bound_by"] = k1_bound_ms(B, R, L, W)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            device_share(row)
            row["prev_bound_share"] = row["bound_ms"] / row["prev_ms"]
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
    """K1-h, mode="highest" on the bf16 tensor cores, and K1-h-s, its
    SIMT before-number, each against the plain version (one-hot f32
    bmm): scores within K1H_ATOL with the quantized LUT's deltas (whose
    f32 sums are exact in any order: max_abs_err 0 expected), offsets
    equal except where the plain version's top two scores lie within
    K1H_ATOL (counted), at bench.py's shape and two main-path shapes
    plus exact ties, ties across K1-h's N tiles, a ragged shape and code
    4; bench.py's unquantized deltas at the first shape held per row to
    the f32 bound 2 (L+1) 2^-24 (sum|terms| + |lnmis|) of two summation
    orders, whose worst case for the tensor cores (3L/4 truncations of
    one score, 1.5 L 2^-24 sum) fits inside it with the bmm's own
    rounding. At each LUT shape the kernel, K1-h-s (prev_ms), the plain
    version and the library route (library_route "highest") are timed.
    Returns (rows, max_abs_err of the LUT cases)."""
    from strelka_tpu_torch.ops import score_kernel as sk
    rng = np.random.default_rng(2025)
    rows = []
    max_err = 0.0
    cases = [("lut", s, k1_random) for s in shapes]
    cases += [("bench_unquantized", shapes[0], bench_inputs),
              ("ties", (64, 32, 128, 320), k1_ties),
              ("tile_ties", (64, 40, 160, 320), k1_tile_ties),
              ("ragged", (3, 40, 100, 70), k1_random),
              ("code4", (4, 32, 160, 192), k1_code4)]
    kernels = (("k1h", lambda *a: sk.score_best_offsets(*a, mode="highest")),
               ("k1h-s", sk.score_highest_simt))
    for kind, (B, R, L, W), make in cases:
        arrs = make(np, rng, B, R, L, W)
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        s = sk.highest_scores(*t)
        top2 = torch.topk(s, 2, dim=-1).values
        del s
        pb, po = sk.reference_best_offsets(*t)
        near = (top2[..., 0] - top2[..., 1]) <= K1H_ATOL
        row = {"case": kind, "shape": [B, R, L, W],
               "near_ties": int(near.sum())}
        for name, fn in kernels:
            kb, ko = fn(*t)
            if cuda:
                torch.cuda.synchronize()
            err = (kb - pb).abs()
            if kind == "bench_unquantized":
                c, d, m, _w = t
                terms = torch.where((c >= 0) & (c < 4), d.abs(), 0.0).sum(-1)
                bound = 2 * (L + 1) * 2.0 ** -24 * (terms + m.abs())
                bad = int((err > bound).sum())
                row[f"{name}_err_over_bound"] = float((err / bound).max())
            else:
                bad = int((err > K1H_ATOL).sum())
            differ = ko != po
            n_off_bad = int((differ & ~near).sum())
            if bad or n_off_bad:
                fail(f"{name} {kind} {[B, R, L, W]}: {bad} scores outside "
                     f"the tolerance (max err {float(err.max())}), "
                     f"{n_off_bad} offsets differ outside near-ties")
            prefix = "" if name == "k1h" else "prev_"
            row[f"{prefix}max_abs_err"] = float(err.max())
            row[f"{prefix}near_tie_offsets_differ"] = int((differ & near).sum())
        if kind != "bench_unquantized":
            max_err = max(max_err, row["max_abs_err"])
        if kind == "lut":
            row["ms"] = time_ms(torch, cuda, lambda: sk.score_best_offsets(
                *t, mode="highest"), iters)
            row["prev_ms"] = time_ms(
                torch, cuda, lambda: sk.score_highest_simt(*t), iters)
            if cuda:
                row["device_ms"] = graph_ms(torch, lambda: sk.score_best_offsets(
                    *t, mode="highest"))
                row["prev_device_ms"] = graph_ms(
                    torch, lambda: sk.score_highest_simt(*t))
            row["plain_ms"] = time_ms(
                torch, cuda, lambda: sk.reference_best_offsets(*t),
                max(1, iters // 5), warm=1)
            row.update(library_row(
                torch, library_route(torch, "highest", *t), (pb, po),
                lambda f: time_ms(torch, cuda, f, iters)))
            (row["bound_ms"], row["bound_by"],
             row["bound_engine"]) = k1h_bound_ms(B, R, L, W)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["prev_bound_share"] = row["bound_ms"] / row["prev_ms"]
            device_share(row)
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
    phase_snv_rna(np, dev, L // 8)
    return phase_kgh(np, torch, dev, cuda, L)


def phase_snv_rna(np, dev, n: int):
    """RNA mode's tiles (the het-VF extension, per-call dependent-eprob
    deltas) on `dev` against the port's CPU path: lhood, strand bias
    and the integer fields bit for bit, at one tile's D and in chunks
    whose D is padded to 32 (a region longer than SNV_TILE_L)."""
    from strelka_tpu_torch.models import snv_digt as sd
    rng = np.random.default_rng(8)
    for D, L in ((45, n), (70, sd.SNV_TILE_L + n)):
        ref = rng.integers(0, 5, L).astype(np.int32)
        base = np.where(rng.random((L, D)) < 0.3,
                        rng.integers(0, 4, (L, D)),
                        np.minimum(ref, 3)[:, None]).astype(np.int8)
        qual = rng.integers(0, 45, (L, D)).astype(np.uint8)
        mask = rng.random((L, D)) < 0.8
        fwd = rng.random((L, D)) < 0.5
        plane = np.where(rng.random((L, D)) < 0.1,
                         -rng.random((L, D)), 0.0).astype(np.float32)
        # RNA mode reads the per-call deltas alone (dep[1])
        dep = (np.zeros((L, 4), np.float32),
               lambda rows: plane[np.arange(L) if rows is None else rows])
        tile = sd.SnvPileupTile(base_id=base, qual=qual, is_fwd=fwd,
                                mask=mask, ref_gt=ref)
        got, want = (sd.call_snv_tile_chunked(tile, 0.001, None, 0.45,
                                              0.0501, dep=dep, device=d)
                     for d in (dev, "cpu"))
        for f in ("genome_max_gt", "poly_max_gt", "snv_qphred",
                  "genome_max_gt_qphred", "poly_max_gt_qphred",
                  "phred_loghood", "lhood", "strand_bias"):
            a = np.ascontiguousarray(getattr(got, f))
            b = np.ascontiguousarray(getattr(want, f))
            if a.tobytes() != b.tobytes():
                fail(f"snv rna D={D} L={L}: {f} differs from the CPU path")
        log(f"snv rna D={D}: " + json.dumps({
            "rows": L, "snp_rows": int((want.snv_qphred != 0).sum()),
            "ln_ref_max_abs_diff": float(np.abs(
                got.ln_ref_pprob - want.ln_ref_pprob).max())}))


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit, any NaN equal to any NaN."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a[~nan], b[~nan]
        w = torch.int64 if a.dtype == torch.float64 else torch.int32
        return torch.equal(a.view(w), b.view(w))
    return torch.equal(a, b)


def hold(torch, label, got: dict, want: dict) -> float:
    """Fails unless every field of `got` equals `want`'s bit for bit (a
    NaN as a NaN); returns the largest absolute difference of the float
    fields' finite entries (0.0)."""
    err = 0.0
    for f, a in got.items():
        b = want[f]
        if not same_bits(torch, a, b):
            n = int((a.cpu() != b.cpu()).sum())
            fail(f"{label}: {f} differs from the plain version ({n} "
                 f"entries)")
        if a.is_floating_point():
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                err = max(err, float((a[fin].double()
                                      - b[fin].double()).abs().max()))
    return err


# the runtime calls that launch a kernel, as kineto names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def profile_call(torch, fn, tries: int = 3) -> dict:
    """One call of fn (after a warm call) under torch.profiler, read from
    the trace's kineto events after the profiler stops: the kernel
    launches that its host side recorded, the kernels and copies that
    its device side holds, their summed device microseconds and the
    most frequent names. kineto at times keeps a launch's runtime call
    but not its kernel (H100, torch 2.11: the kernels of this repo's own
    libraries, most often in phase 6b, while the aten kernels of the
    plain versions stay), so the session holds 20 ms of host time on
    each side of the call, and one whose device side holds fewer
    kernels than launches is taken again, up to `tries` in all; where
    every session lost some, lost_kernels says how many and device_us
    is the call's span by CUDA events on an idle stream (device_us_from:
    "events", else "trace")."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        events = prof.profiler.kineto_results.events()
        ev = [(e.name(), e.duration_ns() / 1e3) for e in events
              if e.device_type() == cuda]
        launched = sum(e.name() in LAUNCH_CALLS for e in events
                       if e.device_type() != cuda)
        copies = [n for n, _ in ev if n.startswith(("Memcpy", "Memset"))]
        lost = launched - (len(ev) - len(copies))
        if lost <= 0:
            break
    if not launched:
        fail("torch.profiler recorded no kernel launch in a call on the "
             "card")
    names: dict[str, int] = {}
    for n, _ in ev:
        names[n[:48]] = names.get(n[:48], 0) + 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:4]
    row = {"launches": launched, "kernels": len(ev) - len(copies),
           "copies": len(copies), "sessions": attempt,
           "lost_kernels": max(lost, 0), "device_us_from": "trace",
           "device_us": sum(us for _, us in ev), "top_names": dict(top)}
    if lost > 0:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        row.update(device_us=s.elapsed_time(e) * 1e3,
                   device_us_from="events")
    return row


def kernel_row(torch, cuda: bool, kernel, plain, nbytes, f32_ops, f64_ops,
               iters: int, shape) -> dict:
    """A kernel's times beside its plain version's and its bound: ms by
    CUDA events around host calls, device_ms by graph replay, a profiler
    trace of one call of each; bound_ms the larger of the bytes over HBM
    and the f32 and float64 operations over their peaks. The plain
    versions read data back to the host or copy from it, so no graph
    captures them."""
    row = {"shape": shape, "ms": time_ms(torch, cuda, kernel, iters),
           "plain_ms": time_ms(torch, cuda, plain, max(1, iters // 10),
                               warm=1)}
    if cuda:
        row["trace"] = profile_call(torch, kernel)
        row["plain_trace"] = profile_call(torch, plain)
        row["device_ms"] = graph_ms(torch, kernel)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = (f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
    row.update(bytes=int(nbytes), f32_ops=int(f32_ops),
               f64_ops=int(f64_ops), library_ms=None)
    row["bound_ms"], row["bound_by"] = ((tb, "bytes") if tb >= to
                                        else (to, "operations"))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    device_share(row)
    return row


# float64 operations a row counted in the bounds (each exp, log and
# division as one): KG-H's two result sets (10 adds, 10 subtractions, 10
# exps, 10 divisions, 18 adds of the sequential sums, 2 log10) and its
# PLs (10 divisions, 10 adds); KS-G's 9 strand logaddexps (subtraction,
# exp, log1p, add, the f32 rounding's add); KS-P's 7 logsumexps of 441
# (an exp and an add a term) and one of 21, and its tail. f32 operations
# a row: KS-P's 6 x 441 x 2 adds of the joint sums and 441 + 42 of the
# nonsomatic terms.
KGH_F64_PER_ROW = 2 * (10 + 10 + 10 + 10 + 18 + 2) + 20
KSG_F64_PER_ROW = 9 * 5
KSP_F64_PER_ROW = 2 * (7 * 441 + 21) + 40
KSP_F32_PER_ROW = 6 * 441 * 2 + 441 + 42


def hist_case(np, rng, L, D, hist_dtype):
    """A germline (qscore, base) histogram of a random depth-D tile with
    q = 0 calls and rows without calls, haploid rows and dependent-eprob
    deltas: (hist, ref_gt, is_haploid, s_mis)."""
    from strelka_tpu_torch.models import snv_digt as sd
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.3, rng.integers(0, 4, (L, D)),
                    np.minimum(ref, 3)[:, None]).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(np.uint8)
    qual[rng.random((L, D)) < 0.02] = 0
    mask = rng.random((L, D)) < 0.8
    mask[:L // 50] = False
    h = np.zeros((L, 512), np.int8)
    sd._np_snv_hist(base, qual, mask, h)
    hap = rng.random(L) < 0.1
    smis = np.where(rng.random((L, 4)) < 0.05,
                    rng.random((L, 4)) * 0.5, 0.0).astype(np.float32)
    return h.astype(hist_dtype), ref, hap, smis


def phase_kgh(np, torch, dev, cuda: bool, L: int):
    """KG-H (call_snv_hist_tile on the card) against its plain version
    on the card, every _PULL field bit for bit: random tiles at D = 32,
    96 and 127 (int8 counts, haploid rows, s_mis), int32 counts, rows
    that s_mis makes -inf or NaN, rows without calls (all ten lhoods 0:
    ties everywhere), a ragged and a one-row tile; timed at the main
    path's chunk (SNV_TILE_L * 4 rows) beside the plain version as the
    main path ran it (with the live slots). Returns the kernel's row."""
    from strelka_tpu_torch.models import snv_digt as sd
    rng = np.random.default_rng(9)
    rows = sd.SNV_TILE_L * 4 if cuda else L
    cases = [("random", rows, 32, np.int8), ("random", L // 4, 96, np.int8),
             ("random", L // 4, 127, np.int8), ("int32", L // 8, 96, np.int32),
             ("ninf", 2000, 64, np.int8), ("nan", 2000, 64, np.int8),
             ("ragged", 1031, 50, np.int8), ("one_row", 1, 40, np.int8)]
    err, timed = 0.0, None
    for kind, n, D, dt in cases:
        h, ref, hap, smis = hist_case(np, rng, n, D, dt)
        if kind in ("ninf", "nan"):
            smis[:n // 4] = -np.inf if kind == "ninf" else np.nan
        cols = np.nonzero(h.any(axis=0))[0].tolist()
        t = [torch.from_numpy(a).to(dev) for a in (h, ref, hap, smis)]
        got = sd.call_snv_hist_tile(t[0], t[1], t[2], s_mis=t[3])
        want = sd.call_snv_hist_tile_plain(t[0], t[1], t[2], s_mis=t[3],
                                           cols=cols)
        err = max(err, hold(torch, f"kg-h {kind} L={n} D={D}",
                            {f: getattr(got, f) for f in sd._PULL},
                            {f: getattr(want, f) for f in sd._PULL}))
        if timed is None:
            nnz = int((h != 0).sum())
            nbytes = (n * (512 * h.itemsize + 4 + 1 + 16 + 40 + 20 + 40 + 8)
                      + 512 * 10 * 4 + 4 * 10 * 4 + 4 * 5 * 10 * 8)
            timed = kernel_row(
                torch, cuda,
                lambda t=t: sd.call_snv_hist_tile(t[0], t[1], t[2],
                                                  s_mis=t[3]),
                lambda t=t, cols=cols: sd.call_snv_hist_tile_plain(
                    t[0], t[1], t[2], s_mis=t[3], cols=cols),
                nbytes, 2 * 10 * nnz + 8 * 10 * n, KGH_F64_PER_ROW * n,
                1 if not cuda else 20, [n, 512, D])
        del t
    timed["max_abs_err"] = err
    log("kg-h: " + json.dumps(timed))
    return timed


def grid_counts(torch, base, qual, mask, fwd, ref):
    """(live bins, live h_ref slots, live h_alt slots, live qscore slots
    a row: mean and max) of a somatic tile's (qscore, class) histograms,
    counted on the tile's device."""
    L = base.shape[0]
    q = qual.long().clamp(0, 127)
    cls = ((base.long() != ref.long()[:, None]).long() << 1) | fwd.long()
    idx = torch.where(mask, q * 4 + cls, 512)
    h = torch.zeros((L, 513), dtype=torch.int32, device=base.device)
    h.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    h = h[:, :512].reshape(L, 128, 4)
    slots = (h.sum(dim=2) > 0).sum(dim=1).double()
    return (int((h > 0).sum()), int(((h[..., 0] + h[..., 1]) > 0).sum()),
            int(((h[..., 2] + h[..., 3]) > 0).sum()),
            {"mean": float(slots.mean()), "max": int(slots.max())})


SPARSE_KINDS = ("single", "binned", "dense")


def sparse_somatic_tile(np, rng, L, D, kind):
    """A somatic pileup tile (int8 base, int16 qual) at the base qualities
    that runs give, with q = 0 calls (2%), masked lanes and all-masked
    rows (3-5): "single", every call at 32 (synth.py's reads: 1-2 live
    qscore slots a row); "binned", the binned Illumina qualities 2, 12,
    23, 37; "dense", qualities 0-127 and a few past 127, all 128 slots
    live in each row where D >= 128 (tests/test_torch_cuda.sparse_tile)."""
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.8, np.minimum(ref, 3)[:, None],
                    rng.integers(-1, 4, (L, D))).astype(np.int8)
    if kind == "single":
        qual = np.full((L, D), 32)
    elif kind == "binned":
        qual = rng.choice((2, 12, 23, 37), (L, D))
    else:
        qual = rng.integers(0, 128, (L, D))
        qual[rng.random((L, D)) < 0.01] = 200
    qual = np.where(rng.random((L, D)) < 0.02, 0, qual)
    mask = rng.random((L, D)) < 0.9
    if kind == "dense" and D >= 128:
        qual[:, :128] = rng.permuted(np.tile(np.arange(128), (L, 1)), axis=1)
        mask[:, :128] = True
    mask[3:6] = False
    return (base, qual.astype(np.int16), mask, rng.random((L, D)) < 0.5,
            ref)


def phase_sparse_tiles(np, torch, dev, L: int):
    """Phase 3b's tiles at the qualities runs give: KS-G on the single,
    binned and dense tiles at D = 64 and 200 (1-2, 5 and 128 live slots
    a row), KS-P on their lhoods with NaN and +inf rows, each bit for bit
    against its plain version on the card."""
    from strelka_tpu_torch.models import somatic_snv as ss
    rng = np.random.default_rng(15)
    lh = {}
    for kind in SPARSE_KINDS:
        for D in (64, 200):
            t = [torch.from_numpy(a).to(dev)
                 for a in sparse_somatic_tile(np, rng, L, D, kind)]
            got = ss.freq_grid_lhoods(*t)
            hold(torch, f"ks-g {kind} D={D}", {"lhood": got},
                 {"lhood": ss.freq_grid_lhoods_plain(*t)})
            lh[kind, D] = got
            del t
    fields = ss.SomaticSnvResult._fields
    for a, b in ((("single", 64), ("binned", 64)),
                 (("binned", 64), ("dense", 200)),
                 (("single", 200), ("dense", 64))):
        n, t = lh[a].clone(), lh[b].clone()
        n[10:12, 4] = float("nan")
        t[12:14, 7] = float("inf")
        got, want = ss.somatic_snv_call(n, t), ss.somatic_snv_call_plain(n, t)
        hold(torch, f"ks-p {a} x {b}", {f: getattr(got, f) for f in fields},
             {f: getattr(want, f) for f in fields})
    log(f"ks-g, ks-p sparse and dense tiles: 6 + 3 tiles of {L} rows bit "
        f"for bit")


def phase_somatic_kernels(np, torch, dev, tiles):
    """KS-G and KS-P on the card against their plain versions on the
    card, bit for bit, at their edges: KS-G on phase 3b's tiles (int8
    base and int16 qual, the native pileup's lanes; q = 0 calls, masked
    lanes, all-masked rows), on the first as int32 lanes (the Python
    pileup's, which freq_grid_lhoods casts), a ragged and a one-row
    tile; KS-P on their lhoods, on them with all -inf normal or
    tumour rows or -inf normal pre-strand states, on rows whose states
    all tie, and on a one-row tile. Phase 6b times both at the main
    path's shape."""
    from strelka_tpu_torch.models import somatic_snv as ss
    i32 = tuple(a.astype(np.int32) if a.dtype.kind == "i" else a
                for a in tiles[0])
    lh = []
    cases = [("d32", tiles[0]), ("d96", tiles[1]), ("int32", i32),
             ("ragged", tuple(a[:1031] for a in tiles[1])),
             ("one_row", tuple(a[20:21] for a in tiles[1]))]
    for kind, tile in cases:
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in tile]
        got = ss.freq_grid_lhoods(*t)
        hold(torch, f"ks-g {kind}", {"lhood": got},
             {"lhood": ss.freq_grid_lhoods_plain(*t)})
        if kind in ("d32", "d96"):
            lh.append(got.cpu().numpy())
        del t

    n0, t0 = lh
    k = min(2000, n0.shape[0])
    cases = []
    for kind in ("normal_all_ninf", "tumor_all_ninf",
                 "normal_prestrand_ninf", "ties"):
        n, t = n0[:k].copy(), t0[:k].copy()
        if kind == "normal_all_ninf":
            n[:k // 2] = -np.inf
        elif kind == "tumor_all_ninf":
            t[:k // 2] = -np.inf
        elif kind == "normal_prestrand_ninf":
            n[:k // 2, :ss.PRESTRAND_SIZE] = -np.inf
        else:
            n[:k // 2] = -3.0
            t[:k // 2] = t[:k // 2, :1]
        cases.append((kind, n, t))
    cases.append(("one_row", n0[:1], t0[:1]))
    for kind, n, t in cases:
        x = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (n, t)]
        got = ss.somatic_snv_call(*x)
        want = ss.somatic_snv_call_plain(*x)
        fields = ss.SomaticSnvResult._fields
        hold(torch, f"ks-p {kind}", {f: getattr(got, f) for f in fields},
             {f: getattr(want, f) for f in fields})
        if kind.endswith("ninf") and bool((got.qphred[:k // 2] != 0).any()):
            fail(f"ks-p {kind}: a -inf row's qphred is not 0")
        del x
    log(f"ks-g, ks-p edges: {len(cases) + 5} tiles bit for bit")


def plain_chunks(torch, fn, rows: int, *a, **kw):
    """fn (a plain version) over row chunks of `rows` (the plain chunk
    heights of rows_per_launch: rows are independent, so the chunks
    change no result), each field concatenated."""
    L = a[0].shape[0]
    parts = [fn(*(x[i:i + rows] for x in a), **kw)
             for i in range(0, L, rows)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))


def phase_somatic_main_shape(np, torch, dev, cuda: bool, kept):
    """Phase 6b: KS-G and KS-P on the inputs that phase 6's CLI gave
    them (`kept`: StreamTimer.kept, the first two grid calls and the
    first posterior call), each against its plain version bit for bit,
    timed by CUDA events and graph replay beside it, one call of each
    traced. Returns the kernels' rows (the grid's at the larger depth)."""
    from strelka_tpu_torch.models import somatic_snv as ss
    iters = 20 if cuda else 1
    g_rows = []
    for i, (a, kw) in enumerate(kept["somatic_grid_lhoods"]):
        base, qual, mask, fwd, ref = a
        L, D = base.shape
        rows = ss.rows_per_launch(dev, ss.GRID_ROW_BYTES
                                  + ss.GRID_LANE_BYTES * D)

        def plain(a=a, rows=rows):
            return plain_chunks(torch, ss.freq_grid_lhoods_plain, rows, *a)
        err = hold(torch, f"ks-g main path call {i}",
                   {"lhood": ss.freq_grid_lhoods(*a)}, {"lhood": plain()})
        bins, refs, alts, slots = grid_counts(torch, *a)
        nbytes = (L * D * (base.element_size() + qual.element_size() + 2)
                  + L * (ref.element_size() + 30 * 4) + 128 * 78 * 4)
        row = kernel_row(
            torch, cuda, lambda a=a: ss.freq_grid_lhoods(*a), plain, nbytes,
            2 * (21 * (refs + alts) + 18 * bins), KSG_F64_PER_ROW * L,
            iters, [L, D])
        row.update(max_abs_err=err, dtypes=[str(base.dtype),
                                            str(qual.dtype)],
                   plain_rows_per_chunk=rows, live_bins=bins,
                   live_slots_a_row=slots)
        lib = ksg_library_route(torch, *a)
        row["library_ms"] = time_ms(torch, cuda, lib, iters)
        row["library_max_abs_diff"] = float(
            (lib() - ss.freq_grid_lhoods(*a)).abs().nan_to_num(0.0).max())
        log(f"ks-g main path call {i}: " + json.dumps(row))
        g_rows.append(row)
    (a, kw), = kept["somatic_posterior"]
    L = a[0].shape[0]
    rows = ss.rows_per_launch(dev, ss.CALL_ROW_BYTES)

    def plain(a=a, kw=kw, rows=rows):
        return plain_chunks(torch, ss.somatic_snv_call_plain, rows, *a, **kw)
    got, want = ss.somatic_snv_call(*a, **kw), plain()
    fields = ss.SomaticSnvResult._fields
    err = hold(torch, "ks-p main path", {f: getattr(got, f) for f in fields},
               {f: getattr(want, f) for f in fields})
    nbytes = (L * (2 * 30 * 4 + 6 * 4)
              + 6 * 441 * 4 + 6 * 4 + 21 * 4 + 441 * 8)
    p_row = kernel_row(
        torch, cuda, lambda: ss.somatic_snv_call(*a, **kw), plain, nbytes,
        KSP_F32_PER_ROW * L, KSP_F64_PER_ROW * L, iters, [L, 30])
    p_row.update(max_abs_err=err, plain_rows_per_chunk=rows,
                 **ksp_term_shares(torch, *a, **kw))
    g_row = max(g_rows, key=lambda r: r["shape"][1])
    if cuda:
        report = ptxas_report()
        g_row["registers"] = report["somatic_grid"]
        p_row["registers"] = report["somatic_posterior"]
        p_row.update(ksp_fp64_floor(torch, report["fp64_per_call"], L,
                                    p_row["clean_row_share"]))
    log("ks-p main path: " + json.dumps(p_row))
    if cuda:
        torch.cuda.empty_cache()
    g_row["max_abs_err"] = max(r["max_abs_err"] for r in g_rows)
    return g_row, p_row


def ksg_library_route(torch, base, qual, mask, fwd, ref):
    """KS-G's function by library calls, its yardstick (not bit for bit:
    cuBLAS sums in its own order): an f32 scatter_add_ histogram, one f32
    torch.matmul of the six class histograms against the tables stacked
    [768, 39] (TF32 off), the q = 0 -inf entries, then the strand states'
    f32 logaddexp and ln 0.5. The stacked tables are built before the
    timer."""
    from strelka_tpu_torch.convert import somatic_grid_tables
    from strelka_tpu_torch.models import somatic_snv as ss
    dev = base.device
    g = somatic_grid_tables(dev)
    z21 = torch.zeros((128, 21), dtype=torch.float32, device=dev)
    z9 = torch.zeros((128, 9), dtype=torch.float32, device=dev)
    w = torch.cat([
        torch.cat([g["grid_ref"], z9, z9], 1),                       # ref
        torch.cat([g["grid_alt"], z9, z9], 1),                       # alt
        torch.cat([z21, g["grid_on_ref"], g["grid_off_ref"]], 1),    # rf
        torch.cat([z21, g["grid_on_alt"], g["grid_off_alt"]], 1),    # af
        torch.cat([z21, g["grid_off_ref"], g["grid_on_ref"]], 1),    # rr
        torch.cat([z21, g["grid_off_alt"], g["grid_on_alt"]], 1)])   # ar
    L = base.shape[0]
    ninf = float("-inf")

    def call():
        q = qual.long().clamp(0, 127)
        cls = ((base.long() != ref.long()[:, None]).long() << 1) | fwd.long()
        idx = torch.where(mask, q * 4 + cls, 512)
        h = torch.zeros((L, 513), dtype=torch.float32, device=dev)
        h.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
        h = h[:, :512].view(L, 128, 4)
        x = torch.cat([h[..., 0] + h[..., 1], h[..., 2] + h[..., 3],
                       h[..., 1], h[..., 3], h[..., 0], h[..., 2]], 1)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            y = torch.matmul(x, w)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        h0 = h[:, 0]
        lh = y[:, :21].clone()
        lh[:, 0].masked_fill_((h0[:, 0] + h0[:, 1]) > 0, ninf)
        lh[:, 1].masked_fill_((h0[:, 2] + h0[:, 3]) > 0, ninf)
        lf = y[:, 21:30].masked_fill((h0[:, 0] > 0)[:, None], ninf)
        lr = y[:, 30:].masked_fill((h0[:, 1] > 0)[:, None], ninf)
        return torch.cat([lh, torch.logaddexp(lf, lr) + ss._LN_HALF_F32], 1)
    return call


def ksp_term_shares(torch, normal, tumor, **kw):
    """KS-P's terms on these rows: the share of rows whose 42 lhoods are
    all below +inf (KS-P takes only the terms whose prior is not -inf
    there), the terms a list holds, and, over the first 16,384 rows, the
    share of the 7 x 441 terms whose float64 exp(v - max) is exactly +0
    on the card, of all and of the listed ones; exp_zero_below is the
    largest x at which the card's exp(double) gives +0, by a sweep of
    -760..-700 at steps of 1e-4."""
    from strelka_tpu_torch.models import somatic_snv as ss
    args = tuple(kw.get(k, d) for k, d in (
        ("contam_tolerance", 0.15), ("shared_error_rate", 5e-10),
        ("somatic_rate", 1e-4), ("theta", 0.001),
        ("sse_strand_fraction", 0.0)))
    pf, _gp, _eq, off, eye = ss._posterior_tables(normal.device, *args)
    F = ss.PRESTRAND_SIZE
    nl, tl = normal[:, :F], tumor[:, :F]
    clean = (nl < float("inf")).all(1) & (tl < float("inf")).all(1)
    pf = pf.reshape(6, F * F)
    listed = torch.cat([pf != float("-inf"),
                        (~eye & (off != float("-inf"))).reshape(1, -1)])
    r = min(16_384, nl.shape[0])
    fn = torch.arange(F * F, device=nl.device) // F
    ft = torch.arange(F * F, device=nl.device) % F
    v = torch.cat([((pf[None] + nl[:r, None, fn]) + tl[:r, None, ft])
                   .double(),
                   torch.where(eye.reshape(1, 1, -1), float("-inf"),
                               (nl[:r, None, fn] + tl[:r, None, ft]).double()
                               + off.reshape(1, 1, -1))], 1)
    mx = v.amax(dim=2, keepdim=True)
    zero = torch.exp(v - torch.where(torch.isfinite(mx), mx, 0.0)) == 0
    x = torch.arange(-760.0, -700.0, 1e-4, dtype=torch.float64,
                     device=nl.device)
    return {"clean_row_share": float(clean.double().mean()),
            "listed_terms": [int(n) for n in listed.sum(1)],
            "exp_zero_share": float(zero.double().mean()),
            "exp_zero_share_listed": float(
                zero[:, listed].double().mean()),
            "exp_zero_below": float(x[torch.exp(x) == 0].max())}


FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
# one call of each float64 function KS-P takes, for the SASS count
FP64_PROBE = """
extern "C" __global__ void p_exp(const double* x, double* y)
{ y[threadIdx.x] = exp(x[threadIdx.x]); }
extern "C" __global__ void p_log(const double* x, double* y)
{ y[threadIdx.x] = log(x[threadIdx.x]); }
extern "C" __global__ void p_log1p(const double* x, double* y)
{ y[threadIdx.x] = log1p(x[threadIdx.x]); }
extern "C" __global__ void p_div(const double* x, double* y)
{ y[threadIdx.x] = x[threadIdx.x] / x[threadIdx.x + 32]; }
"""


def ptxas_report() -> dict:
    """KS-G's and KS-P's registers and spills (nvcc -Xptxas -v on their
    sources, the build's flags) and the FP64 SASS instructions (D* ops,
    by cuobjdump) of one call of exp, log, log1p and a division, from a
    probe built the same way: three nvcc at once."""
    import re
    from strelka_tpu_torch import _build
    out = os.path.join(HERE, "build", "smoke", "ptxas")
    os.makedirs(out, exist_ok=True)
    probe = os.path.join(out, "fp64_probe.cu")
    with open(probe, "w") as f:
        f.write(FP64_PROBE)
    srcs = {"somatic_grid": os.path.join(_build.CSRC, "somatic_grid.cu"),
            "somatic_posterior": os.path.join(_build.CSRC,
                                              "somatic_posterior.cu"),
            "fp64_probe": probe}
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",
                                                       "-Xcompiler",
                                                       "-fPIC")]
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         os.path.join(out, f"{k}.cubin"), src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, src in srcs.items()}
    report = {}
    for k, p in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            fail(f"nvcc -Xptxas -v {k}: {text}")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        report[k] = {"registers": max(regs), "spill_store_bytes": max(
            spills, default=0)}
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass",
                        os.path.join(out, "fp64_probe.cubin")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"cuobjdump: {r.stderr}")
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : p_(\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if fn and m and m.group(1) in FP64_OPS:
            counts[fn] += 1
    report["fp64_per_call"] = counts
    log("ptxas and SASS: " + json.dumps(report))
    return report


# float64 adds a row-warp of KS-P besides its calls of exp, log, log1p and
# the division: each list's tree (6 + 4 + 2 + 1 in the lanes, 5 shuffle
# steps), the diagonal's 5 steps, the 8 shift adds, and the tail's 16
# (the six-term sum, nonsom, total, the errors, the logaddexp, a phred's
# multiply and add)
KSP_ADDS_PER_ROW = 7 * 18 + 5 + 8 + 16


def ksp_fp64_floor(torch, per_call, rows, clean_share) -> dict:
    """KS-P's float64 floor on this card: FP64 warp instructions a row
    (each D* SASS instruction of a call of exp, log, log1p and the
    division, times its warp rounds a row: a list's exps in rounds of 32
    on a row without NaN or +inf, 14 rounds a list elsewhere; the
    diagonal's and the tail's 3 exps; 2 logs, a log1p, a division; one
    subtraction an exp round; KSP_ADDS_PER_ROW adds), each issuing on 32
    of an SM's 64 FP64 lanes, over the SMs at the card's largest SM
    clock. The D* ops outside these calls are left out, so it is a floor."""
    from strelka_tpu_torch.models import somatic_snv as ss
    pf, _gp, _eq, off, eye = ss._posterior_tables(torch.device("cpu"), 0.15,
                                                  5e-10, 1e-4, 0.001, 0.0)
    listed = [int((pf.reshape(6, -1)[g] != float("-inf")).sum())
              for g in range(6)]
    listed.append(int((~eye & (off != float("-inf"))).sum()))
    clean_rounds = sum(-(-n // 32) for n in listed)
    exp_rounds = (clean_share * clean_rounds + (1 - clean_share) * 7 * 14
                  + 3)
    per_row = (exp_rounds * (per_call["exp"] + 1) + 2 * per_call["log"]
               + per_call["log1p"] + per_call["div"] + KSP_ADDS_PER_ROW)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    mhz = float(r.stdout.strip().splitlines()[0])
    floor_ms = rows * per_row * 32 / (sms * 64 * mhz * 1e6) * 1e3
    return {"sass_fp64_per_row_warp": per_row, "sms": sms,
            "clock_max_sm_mhz": mhz, "sass_fp64_floor_ms": floor_ms}


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
    phase_somatic_kernels(np, torch, dev, tiles)
    phase_sparse_tiles(np, torch, dev, min(L, 20_000))
    if dev.type == "cuda":
        somatic_row_bytes(torch, dev, ss, tiles)


def somatic_row_bytes(torch, dev, ss, tiles):
    """Peak bytes per row that the caching allocator hands out while
    the grid lhoods and one posterior run on the card, against the
    per-row sizes from which the port chooses its chunk heights: the
    plain versions' (somatic_snv.CALL_ROW_BYTES, GRID_ROW_BYTES +
    GRID_LANE_BYTES * D) and the kernels' (KERNEL_CALL_ROW_BYTES,
    KERNEL_GRID_ROW_BYTES; the tile's lanes are in place before)."""
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
        for key, fn, limit in (
                (f"grid_plain_D{D}", ss.freq_grid_lhoods_plain,
                 ss.GRID_ROW_BYTES + ss.GRID_LANE_BYTES * D),
                (f"grid_kernel_D{D}", ss.freq_grid_lhoods,
                 ss.KERNEL_GRID_ROW_BYTES)):
            got[key] = peak_per_row(lambda: fn(*x), L)  # noqa: B023
            if got[key] > limit:
                fail(f"{key} held {got[key]:.0f} bytes a row, over the "
                     f"{limit} the chunking assumes")
        lh.append(ss.freq_grid_lhoods(*x))
    for key, fn, limit in (
            ("call_plain", ss.somatic_snv_call_plain, ss.CALL_ROW_BYTES),
            ("call_kernel", ss.somatic_snv_call, ss.KERNEL_CALL_ROW_BYTES)):
        got[key] = peak_per_row(lambda: fn(*lh), lh[0].shape[0])  # noqa: B023
        if got[key] > limit:
            fail(f"{key} held {got[key]:.0f} bytes a row, over the {limit} "
                 f"the chunking assumes")
    log("somatic row bytes (measured peak): " + json.dumps(got) + " chunk "
        "rows now: posterior "
        f"{ss.rows_per_launch(dev, ss.call_row_bytes(dev))}")


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
                      mb, out, device, kept=None):
    """The somatic CLI on `device` with the counters set to 0 just before
    and read just after; stream time of each device phase by CUDA
    events; somatic SNV recall against the planted truth (all records,
    and the PASS records that the 0.9 gate reads). Returns the launch
    counts of launches_during; with `kept` (a dict), the arguments of
    the first two grid calls and the first posterior call go there."""
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.ops import score_kernel as sk
    timer = StreamTimer(torch, cuda)
    keep = kept is not None
    timer.wrap(sk, "score_best_offsets", "k1_score_best_offsets")
    timer.wrap(ss, "freq_grid_lhoods", "somatic_grid_lhoods", 2 * keep)
    timer.wrap(ss, "somatic_snv_call", "somatic_posterior", keep)
    try:
        wall, _, counts = launches_during(
            lambda: run_somatic_cli(fa, nbam, tbam, out, device))
    finally:
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
    n_grid = tile_count(counts, "somatic", "grid", device)
    n_post = tile_count(counts, "somatic", "post", device)
    check_path_launches("the somatic path", counts, cuda)
    check_snv_kernels("the somatic path", counts,
                      cuda and device == "cuda", somatic=True)
    if n_grid == 0 or n_post == 0:
        fail(f"the somatic path ran no grid-lhood or posterior tile on "
             f"{device}")
    if pass_recall < 0.9:
        fail(f"somatic SNV PASS recall {pass_recall:.4f} is below 0.9")
    dev_ms = sum(phase_ms.values())
    log("somatic_e2e: " + json.dumps({
        "device": device, "contig_mb": mb, "reads": n_reads, "wall_s": wall,
        "reads_per_s": n_reads / wall, "snv_records": len(snvs),
        "indel_records": len(indels), "som_snv_planted": len(som_snv),
        "som_snv_recall": recall, "som_snv_pass_recall": pass_recall,
        "k1_launches": counts["k1"], "k1h_launches": counts["k1h"],
        "kx_launches": counts["kx"],
        "grid_tile_launches": n_grid, "posterior_launches": n_post,
        "snv_kernel_launches": counts["snv_kernels"],
        "somatic_tallies": counts["somatic"],
        "grid_stream_ms_per_call": timer.per_call_ms("somatic_grid_lhoods"),
        "grid_host_ms_per_call": timer.host_ms("somatic_grid_lhoods"),
        "posterior_stream_ms_per_call": timer.per_call_ms(
            "somatic_posterior"),
        "posterior_host_ms_per_call": timer.host_ms("somatic_posterior"),
        "k1_launch_shapes": counts["score"],
        "k1_stream_ms": phase_ms.get("k1_score_best_offsets", 0.0),
        "stream_ms_by_phase": phase_ms,
        "device_phase_share_of_wall": dev_ms / 1e3 / wall}))
    if keep:
        kept.update(timer.kept)
    return counts


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


def run_cli(fa, bam, out, device, extra=()):
    from strelka_tpu_torch.__main__ import main
    if os.path.exists(out):
        shutil.rmtree(out)
    t0 = time.perf_counter()
    rc = main(["germline", "--reference", fa, "--align-file", bam,
               "--output-dir", out, "--device", device, *extra])
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


def phase_e2e(torch, cuda: bool, fa, bam, n_reads, mb, out, device,
              extra=()):
    """The CLI on `device` with the launch counters set to 0 just before
    and read just after; stream time of each device phase by CUDA
    events. Returns (the launch counts of launches_during, the wall s)."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import score_kernel as sk
    if cuda:
        from strelka_tpu_torch import _build
        _build.load(sk.KERNEL_FUNCTIONS["exact"][0])
    timer = StreamTimer(torch, cuda)
    timer.wrap(sk, "score_best_offsets", "k1_score_best_offsets")
    timer.wrap(sd, "call_snv_hist_tile", "snv_genotype_tiles")
    timer.wrap(sd, "snv_strand_bias_tile", "snv_strand_bias_tiles")
    try:
        wall, _, counts = launches_during(
            lambda: run_cli(fa, bam, out, device, extra))
    finally:
        timer.restore()
    phase_ms = timer.totals_ms()
    var, gv = check_outputs(out, n_reads)
    check_path_launches("the germline path", counts, cuda)
    check_snv_kernels("the germline path", counts, cuda and device == "cuda")
    if cuda and tile_count(counts, "snv", "tile", device) == 0:
        fail("the main path ran no SNV tile on the card")
    if not counts["score"]:
        fail("the main path scored no read x haplotype pair")
    e2e = {"contig_mb": mb, "reads": n_reads, "wall_s": wall,
           "reads_per_s": n_reads / wall,
           "variant_records": len(var), "gvcf_records": len(gv),
           "k1_launches": counts["k1"], "k1h_launches": counts["k1h"],
           "kx_launches": counts["kx"], "snv_tile_launches": counts["snv"],
           "snv_kernel_launches": counts["snv_kernels"],
           "k1_stream_ms": phase_ms.get("k1_score_best_offsets", 0.0),
           "stream_ms_by_phase": phase_ms,
           "k1_launch_shapes": counts["score"]}
    log("e2e: " + json.dumps(e2e))
    return counts, wall


def keyed(counts):
    """{tuple: n} as JSON keys "a,b,c"."""
    return {",".join(map(str, k)): v for k, v in counts.items()}


def launches_during(fn):
    """fn() with every launch counter set to 0 just before and read just
    after: (fn's result, the wall s, {"k1", "k1h", "k1h_simt", "kx",
    "score", "snv", "somatic", "snv_kernels", "snv_plain"} in the layout
    of the workers' STRELKA_TPU_LAUNCH_STATS dumps)."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.ops import score_variants as sv
    from strelka_tpu_torch.ops import snv_kernels as snk
    from strelka_tpu_torch.pipeline import realign_batch as rb
    sk.LAUNCHES = 0
    sk.LAUNCHES_HIGHEST = 0
    sk.LAUNCHES_HIGHEST_SIMT = 0
    kx_zero(sv)
    sd.LAUNCH_STATS.clear()
    ss.LAUNCH_STATS.clear()
    snk.reset()
    rb.LAUNCH_STATS = {}
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        wall = time.perf_counter() - t0
        counts = {"k1": sk.LAUNCHES, "k1h": sk.LAUNCHES_HIGHEST,
                  "k1h_simt": sk.LAUNCHES_HIGHEST_SIMT, "kx": kx_read(sv), "score": keyed(rb.LAUNCH_STATS),
                  "snv": keyed(sd.LAUNCH_STATS),
                  "somatic": keyed(ss.LAUNCH_STATS),
                  "snv_kernels": dict(snk.LAUNCHES),
                  "snv_plain": dict(snk.PLAIN_ON_CUDA)}
        rb.LAUNCH_STATS = None
    return out, wall, counts


def tile_count(counts, group, kind, device):
    return sum(v for k, v in counts[group].items()
               if k.startswith(f"{kind},{device},"))


def check_path_launches(label, counts, cuda, k1_expected=True):
    """Fails where the path launched a K1-x kernel, K1-h or K1-h-s, or,
    on the card, K1 no time (where its input has reads to score)."""
    if any(counts["kx"].values()) or counts["k1h"] or counts["k1h_simt"]:
        fail(f"{label} launched K1-x or K1-h: {counts['kx']}, "
             f"k1h {counts['k1h']}, k1h_simt {counts['k1h_simt']}")
    if cuda and k1_expected and counts["k1"] == 0:
        fail(f"{label} launched the k1 kernel no time")


def tally_rows(counts, group, kind) -> int:
    """Tile calls of `kind` on the card that had rows."""
    return sum(v for k, v in counts[group].items()
               if k.startswith(f"{kind},cuda,") and int(k.split(",")[2]))


def check_snv_kernels(label, counts, cuda, somatic=False):
    """On the card: KG-H launched once a germline SNV tile tally (a
    non-RNA path's tiles are all histogram tiles), KS-G once a grid and
    KS-P once a posterior tally, and no plain version ran there."""
    if not cuda:
        return
    want = {"snv_hist_tile": tally_rows(counts, "snv", "tile"),
            "somatic_grid": tally_rows(counts, "somatic", "grid"),
            "somatic_posterior": tally_rows(counts, "somatic", "post")}
    if counts["snv_kernels"] != want:
        fail(f"{label}: the SNV kernels launched {counts['snv_kernels']}, "
             f"the tallies are {want}")
    if any(counts["snv_plain"].values()):
        fail(f"{label}: a plain SNV model version ran on the card: "
             f"{counts['snv_plain']}")
    if somatic and not (want["somatic_grid"] and want["somatic_posterior"]):
        fail(f"{label}: KS-G or KS-P was launched no time")
    if not somatic and not want["snv_hist_tile"]:
        fail(f"{label}: KG-H was launched no time")


def compare_records(a_dir, b_dir, names, label) -> int:
    """Fails unless every record of each output in `names` is the same
    in both runs; returns the records compared."""
    n = 0
    for name in names:
        a = vcf_records(os.path.join(a_dir, name))
        b = vcf_records(os.path.join(b_dir, name))
        if a != b:
            diff = [(x, y) for x, y in zip(a, b) if x != y][:3]
            fail(f"{label} {name}: {len(a)} and {len(b)} records, "
                 f"first differing: {diff}")
        n += len(a)
    return n


def card_free_gib(cuda: bool):
    """The card's free memory after this process returns its cached
    blocks, so that fan-out workers find the card as a deployment
    would (None on the CPU)."""
    if not cuda:
        return None
    import torch
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0] / 2**30


def fanout_parent(args, stats_dir, timeout=900):
    """`python -m strelka_tpu_torch <args>` with --jobs, the parent in a
    process of its own (with its workers in a session of their own, so
    that a timeout ends them all) and STRELKA_TPU_LAUNCH_STATS=stats_dir
    (every process dumps its launch counts at exit). Fails unless the
    parent exits 0 with CUDA uninitialized. Returns (wall s, stderr)."""
    import signal
    if os.path.exists(stats_dir):
        shutil.rmtree(stats_dir)
    code = ("import sys, torch\n"
            "from strelka_tpu_torch.__main__ import main\n"
            "rc = main(sys.argv[1:])\n"
            "if torch.cuda.is_initialized():\n"
            "    sys.exit('the --jobs parent initialized CUDA')\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, STRELKA_TPU_LAUNCH_STATS=stats_dir)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code, *args], cwd=HERE,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        _out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{args[0]} --jobs took over {timeout} s")
    wall = time.perf_counter() - t0
    try:   # no worker outlives its parent
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    if proc.returncode != 0:
        fail(f"{args[0]} --jobs exited {proc.returncode}:\n{err[-3000:]}")
    return wall, err


def read_launch_dumps(stats_dir) -> dict:
    """The sum of every process's launch dump, and how many there are."""
    tot = {"processes": 0, "k1": 0, "k1h": 0, "k1h_simt": 0, "kx": {},
           "score": {}, "snv": {}, "somatic": {}, "snv_kernels": {},
           "snv_plain": {}}
    for name in sorted(os.listdir(stats_dir)):
        with open(os.path.join(stats_dir, name)) as f:
            d = json.load(f)
        tot["processes"] += 1
        for k in ("k1", "k1h", "k1h_simt"):
            tot[k] += d[k]
        for group in ("kx", "score", "snv", "somatic", "snv_kernels",
                      "snv_plain"):
            for k, v in d[group].items():
                tot[group][k] = tot[group].get(k, 0) + v
    return tot


def segment_walls(out, i=0) -> list[float]:
    """The segment walls of process `i` of a run, from its taskstate."""
    with open(os.path.join(out, "workspace", f"taskstate.p{i}.jsonl")) as f:
        return [json.loads(l)["wall_sec"] for l in f if l.strip()]


def worker_report(out, n, cuda: bool) -> list[dict]:
    """Each worker's segments and wall (the sum of its taskstate walls)
    and its peak reserved device memory (its log's done line); fails
    where a worker built a kernel library itself."""
    import re
    ws = os.path.join(out, "workspace")
    rows = []
    for i in range(n):
        walls = segment_walls(out, i)
        with open(os.path.join(ws, "logs", f"worker.p{i}.stderr.log")) as f:
            text = f.read()
        if "built lib" in text:
            fail(f"worker {i} built a kernel library itself:\n{text[-2000:]}")
        m = re.search(r"peak device memory reserved ([0-9.]+) MiB", text)
        if cuda and m is None:
            fail(f"worker {i} reported no peak device memory:\n"
                 f"{text[-2000:]}")
        rows.append({"worker": i, "segments": len(walls),
                     "wall_s": sum(walls),
                     "peak_reserved_mib": float(m.group(1)) if m else None})
    return rows


JOBS = 4
CONT_MB = 1.0   # phase 13's region (continuous-VF is host code)
# phase 14's region: the contig's first 2 Mb (4 Mb until phases 16-19
# came, when a smoke from git archive took 1078.7 s of its 1200 s)
RNA_MB = 2.0
# phase 15's bounds, the tests' (tests/test_torch_error_fit.py FLAT_RTOL:
# the fit keeps its least-loss step, and an ulp can pick another among
# steps whose losses tie; tests/test_torch_error_zoo.py FIT_RTOL: the
# zoo's fits keep their last step)
ERR_FLAT_RTOL = 1e-6
ERR_FIT_RTOL = 1e-10
ERR_CONTEXTS = ((1, 1), (1, 2), (2, 2))   # phase 15's estimate-parameters


def phase_germline_jobs(cuda: bool, fa, bam, n_reads, seg, ref_out,
                        ref_wall, workdir):
    """Phase 4's contig with --jobs 4 from a cold start; every record
    equal to phase 4's. Returns the workers' summed launch counts."""
    import re
    from strelka_tpu_torch import _build
    from strelka_tpu_torch.io import native
    from strelka_tpu_torch.parallel import hardware
    device = "cuda" if cuda else "cpu"
    so = native.LIB_PATHS[0]
    os.replace(so, so + ".prev")
    if cuda:
        for name in _build.sources():
            os.utime(_build.lib_path(name), (0, 0))
    out = os.path.join(workdir, "jobs_germline")
    stats = os.path.join(workdir, "launches_germline_jobs")
    free_gib = card_free_gib(cuda)
    try:
        wall, err = fanout_parent(
            ["germline", "--reference", fa, "--align-file", bam,
             "--output-dir", out, "--device", device, "--jobs", str(JOBS),
             "--max-region-size", str(seg)], stats)
    finally:
        if os.path.exists(so):
            os.remove(so + ".prev")
        else:
            os.replace(so + ".prev", so)
            fail("the --jobs parent did not build the host library")
    builds = re.findall(r"^built .*$", err, re.M)
    if cuda and not any("before spawning" in b for b in builds):
        fail(f"the --jobs parent built no kernel library:\n{err[-2000:]}")
    n = compare_records(ref_out, out, ("variants.vcf.gz", "genome.S1.vcf.gz"),
                        "germline --jobs 4 against phase 4")
    workers = worker_report(out, JOBS, cuda)
    counts = read_launch_dumps(stats)
    check_path_launches("germline --jobs 4", counts, cuda)
    check_snv_kernels("germline --jobs 4", counts, cuda)
    tiles = tile_count(counts, "snv", "tile", device)
    if cuda and tiles == 0:
        fail("germline --jobs 4 ran no SNV tile on the card")
    log("germline_jobs: " + json.dumps({
        "jobs": JOBS, "segment_bp": seg, "reads": n_reads, "wall_s": wall,
        "reads_per_s": n_reads / wall, "single_wall_s": ref_wall,
        "single_reads_per_s": n_reads / ref_wall,
        "single_segment_walls_s": segment_walls(ref_out), "records_equal": n,
        "parent_builds": builds, "card_free_gib_at_spawn": free_gib,
        "workers": workers,
        "k1_launches": counts["k1"], "snv_tile_launches": tiles,
        "launch_dumps": counts["processes"],
        "k1_launch_shapes": counts["score"],
        "suggest_jobs": hardware.suggest_jobs(),
        "host_cores": hardware.core_count(),
        "host_mem_mb": hardware.mem_total_mb()}))
    return counts


def phase_somatic_jobs(cuda: bool, fa, nbam, tbam, n_reads, som_snv, seg,
                       ref_out, workdir):
    """Phase 6's T/N contig with --jobs 4; every record equal to phase
    6's. Returns the workers' summed launch counts."""
    device = "cuda" if cuda else "cpu"
    out = os.path.join(workdir, "jobs_somatic")
    stats = os.path.join(workdir, "launches_somatic_jobs")
    free_gib = card_free_gib(cuda)
    wall, _err = fanout_parent(
        ["somatic", "--reference", fa, "--normal-align-file", nbam,
         "--tumor-align-file", tbam, "--output-dir", out, "--device",
         device, "--jobs", str(JOBS), "--max-region-size", str(seg)],
        stats)
    n = compare_records(ref_out, out, SOMATIC_OUTPUTS,
                        "somatic --jobs 4 against phase 6")
    workers = worker_report(out, JOBS, cuda)
    counts = read_launch_dumps(stats)
    check_path_launches("somatic --jobs 4", counts, cuda)
    check_snv_kernels("somatic --jobs 4", counts, cuda, somatic=True)
    n_grid = tile_count(counts, "somatic", "grid", device)
    n_post = tile_count(counts, "somatic", "post", device)
    if n_grid == 0 or n_post == 0:
        fail(f"somatic --jobs 4 ran no grid-lhood or posterior tile on "
             f"{device}")
    snvs = vcf_records(os.path.join(out, SOMATIC_OUTPUTS[0]))
    passed = {int(r[1]) - 1 for r in snvs if r[6] == "PASS"}
    log("somatic_jobs: " + json.dumps({
        "jobs": JOBS, "segment_bp": seg, "reads": n_reads, "wall_s": wall,
        "reads_per_s": n_reads / wall,
        "single_segment_walls_s": segment_walls(ref_out), "records_equal": n,
        "som_snv_pass_recall": sum(p in passed for p in som_snv)
        / max(len(som_snv), 1),
        "card_free_gib_at_spawn": free_gib,
        "workers": workers, "k1_launches": counts["k1"],
        "grid_tile_launches": n_grid, "posterior_launches": n_post,
        "launch_dumps": counts["processes"],
        "k1_launch_shapes": counts["score"]}))
    return counts


def make_joint_dataset(workdir: str, mb: float, n: int = 3):
    """`n` samples of one contig: the reference and the planted variants
    from ref_seed 11 (SNVs every 1000 bp, indels every 1500 bp), each
    sample's reads from its own seed at 30x, 150 bp. Returns (fa, bams,
    reads, truth)."""
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    t0 = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    bams, n_reads = [], 0
    for i in range(n):
        refs, batch, truth = synth.generate(
            L=int(mb * 1_000_000), depth=30, read_len=150, snv_every=1000,
            indel_every=1500, seed=31 + i, ref_seed=11)
        bam = os.path.join(workdir, f"joint_S{i + 1}.bam")
        write_bam(bam, BamHeader(text="", ref_names=["syn"],
                                 ref_lengths=[len(refs)]), batch)
        bams.append(bam)
        n_reads += batch.n
    fa = os.path.join(workdir, "joint_ref.fa")
    with open(fa, "w") as f:
        f.write(">syn\n")
        for i in range(0, len(refs), 60):
            f.write(refs[i:i + 60] + "\n")
    log(f"data: {mb} Mb contig, {n} samples, {n_reads} reads at 30x/150 bp "
        f"each, made in {time.perf_counter() - t0:.1f} s")
    return fa, bams, n_reads, truth


def planted_calls(var_path, truth, n_samples):
    """Per sample, the planted SNVs (same position, a non-reference
    allele in the sample's GT) and indels (a length-changing record
    within 2 bp) that variants.vcf.gz calls, and how many PASS."""
    recs = vcf_records(var_path)
    by_pos = {}
    for r in recs:
        by_pos.setdefault(int(r[1]) - 1, []).append(r)

    def has_alt(r, s):
        gt = gt_of([*r[:8], r[8], r[9 + s]])
        return gt is not None and any(a not in ("0", ".")
                                      for a in gt.replace("|", "/").split("/"))
    rows = []
    for s in range(n_samples):
        row = {"sample": s + 1}
        for kind in ("snv", "del", "ins"):
            hits = passed = 0
            for p in truth[kind]:
                near = [r for q in ((p,) if kind == "snv"
                                    else range(p - 2, p + 3))
                        for r in by_pos.get(q, [])
                        if (kind == "snv") == (len(r[3]) == len(r[4]))]
                hit = [r for r in near if has_alt(r, s)]
                hits += bool(hit)
                passed += any(r[6] == "PASS" for r in hit)
            row[kind] = {"planted": len(truth[kind]), "called": hits,
                         "pass": passed}
        rows.append(row)
    return rows


def phase_joint(cuda: bool, fa, bams, n_reads, truth, workdir):
    """Joint germline calling of the samples on cuda and on cpu:
    identical records in every output. Returns the cuda run's launch
    counts (the cpu run's in a rehearsal)."""
    from strelka_tpu_torch.__main__ import main
    outs, runs = {}, {}
    for device in (("cuda", "cpu") if cuda else ("cpu",)):
        out = os.path.join(workdir, f"joint_{device}")
        args = ["germline", "--reference", fa, "--output-dir", out,
                "--device", device]
        for bam in bams:
            args += ["--align-file", bam]
        rc, wall, counts = launches_during(lambda: main(args))  # noqa: B023
        if rc not in (0, None):
            fail(f"joint germline --device {device} exited {rc}")
        outs[device], runs[device] = out, (wall, counts)
    names = ["variants.vcf.gz"] + [f"genome.S{i + 1}.vcf.gz"
                                   for i in range(len(bams))]
    for rec in vcf_records(os.path.join(outs["cpu"], names[0])):
        if len(rec) != 9 + len(bams):
            fail(f"malformed joint record: {rec[:5]}")
    n = (compare_records(outs["cuda"], outs["cpu"], names,
                         "joint germline cuda against cpu")
         if cuda else 0)
    wall, counts = runs["cuda" if cuda else "cpu"]
    check_path_launches("joint germline", counts, cuda)
    calls = planted_calls(os.path.join(outs["cpu"], names[0]), truth,
                          len(bams))
    filters: dict[str, int] = {}
    for rec in vcf_records(os.path.join(outs["cpu"], names[0])):
        filters[rec[6]] = filters.get(rec[6], 0) + 1
    for row in calls:
        if row["snv"]["called"] < 0.9 * row["snv"]["planted"]:
            fail(f"joint germline called under 90% of the planted SNVs: "
                 f"{row}")
    log("germline_joint: " + json.dumps({
        "samples": len(bams), "reads": n_reads, "wall_s": wall,
        "reads_per_s": n_reads / wall,
        "cpu_wall_s": runs["cpu"][0], "records_equal": n,
        "k1_launches": counts["k1"],
        "snv_tile_launches": tile_count(counts, "snv", "tile",
                                        "cuda" if cuda else "cpu"),
        "k1_launch_shapes": counts["score"], "planted_calls": calls,
        "variant_filters": filters}))
    return counts


def phase_cram(cuda: bool, workdir):
    """Germline on the CRAM fixture and on the BAM of the same records:
    identical records. Returns the CRAM run's launch counts."""
    from strelka_tpu_torch.__main__ import main
    from strelka_tpu_torch.io.bam import read_alignments
    data = os.path.join(HERE, "tests", "data", "cram")
    fa = os.path.join(data, "synth.fa")
    device = "cuda" if cuda else "cpu"
    outs, runs = {}, {}
    for label in ("cram", "bam"):
        path = os.path.join(data, f"synth.{label}")
        out = os.path.join(workdir, f"cram_{label}")
        rc, wall, counts = launches_during(lambda: main(  # noqa: B023
            ["germline", "--reference", fa, "--align-file", path,
             "--output-dir", out, "--device", device]))
        if rc not in (0, None):
            fail(f"germline on synth.{label} exited {rc}")
        outs[label], runs[label] = out, (wall, counts)
    n = compare_records(outs["cram"], outs["bam"],
                        ("variants.vcf.gz", "genome.S1.vcf.gz"),
                        "germline on CRAM against BAM")
    _hdr, batch = read_alignments(os.path.join(data, "synth.cram"), fa)
    wall, counts = runs["cram"]
    # the fixture's pairs are all improper (flag 0x2 unset): no read
    # reaches tier 1, so no locus is scored
    check_path_launches("germline on CRAM", counts, cuda,
                        k1_expected=False)
    log("cram: " + json.dumps({
        "reads": batch.n, "wall_s": wall, "records_equal": n,
        "improper_pairs": int(((batch.flag & 0x3) == 0x1).sum()),
        "k1_launches": counts["k1"]}))
    return counts


# the germline EVS features of phase 12's forests (the names the port's
# gVCF writer computes; tests/test_germline_snv_evs.py and
# tests/test_germline_indel_evs.py train on the same)
EVS_SNV_FEATURES = [
    "SiteHomopolymerLength", "SampleStrandBias",
    "SamplePrimaryAltAlleleDepth", "VariantAlleleQuality",
    "SampleMeanDistanceFromReadEdge", "SamplePrimaryAltAlleleDepthFraction",
    "SampleRMSMappingQuality", "SampleUsedDepthFraction"]
EVS_INDEL_FEATURES = [
    "GenotypeCategory", "SampleIndelRepeatCount",
    "SampleIndelRepeatUnitSize", "SampleIndelAlleleBiasLower",
    "SampleIndelAlleleBias", "SampleProxyRMSMappingQuality",
    "RelativeTotalLocusDepth", "SamplePrimaryAltAlleleDepthFraction",
    "ConservativeGenotypeQuality", "InterruptedHomopolymerLength",
    "ContextCompressability", "IndelCategory",
    "SampleAlleleCountStrandBias", "NormalizedAltHaplotypeCountRatio"]


def forest_json(np, rng, features, kind, key, cut, path, n_trees=8,
                depth=4):
    """A seeded random forest in the reference's scoring-model JSON
    (CalibrationModels -> Germline -> kind; each tree's "tree",
    "decisions" and "node_votes", as ops/rf.load_scoring_model reads
    them), written without sklearn: full trees of `depth` splits whose
    root splits feature `key` near `cut` and sends the calls below it to
    leaves voting mostly false positive."""
    trees = []
    n_inner = 2 ** depth - 1
    for _ in range(n_trees):
        tree, dec, votes = {}, {}, {}
        for i in range(2 ** (depth + 1) - 1):
            if i < n_inner:
                tree[str(i)] = [2 * i + 1, 2 * i + 2]
                f = key if i == 0 else int(rng.integers(0, len(features)))
                thr = (cut * float(rng.uniform(0.7, 1.3)) if f == key
                       else float(rng.normal(0.5, 1.0)))
                dec[str(i)] = [f, thr]
            else:
                tree[str(i)] = [-1, -1]
            node, low = i, False   # below the root's split?
            while node > 0:
                parent = (node - 1) // 2
                low = node == 2 * parent + 1
                node = parent
            fp = float(rng.integers(6, 10) if low else rng.integers(0, 4))
            votes[str(i)] = [fp, 10.0 - fp]
        trees.append({"tree": tree, "decisions": dec, "node_votes": votes})
    doc = {"CalibrationModels": {"Germline": {kind: {
        "Features": features, "Calibration": {"Scale": 1.0, "Power": 1.0},
        "FilterCutoff": 3.0, "ModelType": "RandomForest",
        "Date": "2026-01-01T00:00:00+00:00", "Model": trees}}}}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def phase_mode(torch, cuda: bool, label, fa, bam, n_reads, mb, workdir,
               extra, k1_expected=True, tiles_expected=True):
    """The germline CLI with `extra` on the card (launch counters set to
    0 just before and read just after, stream time of the device phases)
    and then on the CPU, on phase 4's data; every record of
    variants.vcf.gz and genome.S1.vcf.gz equal. Returns (the card run's
    counts, its output directory, the row of numbers logged)."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import score_kernel as sk
    devices = ["cuda", "cpu"] if cuda else ["cpu"]
    outs, row = {}, {"contig_mb": mb, "reads": n_reads, "extra": extra}
    counts = None
    for device in devices:
        out = os.path.join(workdir, f"{label}_{device}")
        timer = StreamTimer(torch, device == "cuda")
        timer.wrap(sk, "score_best_offsets", "k1_score_best_offsets")
        timer.wrap(sd, "call_snv_hist_tile", "snv_genotype_tiles")
        timer.wrap(sd, "call_snv_tile", "snv_call_tiles")
        timer.wrap(sd, "snv_strand_bias_tile", "snv_strand_bias_tiles")
        try:
            wall, _, c = launches_during(
                lambda: run_cli(fa, bam, out, device, extra))  # noqa: B023
        finally:
            timer.restore()
        var, gv = check_outputs(out, n_reads)
        row[f"{device}_wall_s"] = wall
        row[f"{device}_stream_ms_by_phase"] = timer.totals_ms()
        row["variant_records"], row["gvcf_records"] = len(var), len(gv)
        outs[device] = out
        if counts is None:
            counts = c
            check_path_launches(label, c, cuda, k1_expected)
            row["k1_launches"] = c["k1"]
            row["snv_tile_launches"] = c["snv"]
            if cuda and tiles_expected and tile_count(
                    c, "snv", "tile", "cuda") == 0:
                fail(f"{label} ran no SNV tile on the card")
    if cuda:
        row["records_equal"] = compare_records(
            outs["cuda"], outs["cpu"], ("variants.vcf.gz",
                                        "genome.S1.vcf.gz"),
            f"{label}: cuda against cpu")
    log(f"{label}: " + json.dumps(row))
    return counts, outs[devices[0]], row


def phase_evs(np, torch, cuda, fa, bam, n_reads, mb, workdir, extra,
              plain_out):
    """Phase 12: SNV and indel forests from forest_json; how many records
    EVS changed against phase 4's run (none changed fails: the models
    were not applied)."""
    rng = np.random.default_rng(12)
    snv = forest_json(np, rng, EVS_SNV_FEATURES, "SNV", 3, 40.0,
                      os.path.join(workdir, "germlineSNV.json"))
    indel = forest_json(np, rng, EVS_INDEL_FEATURES, "INDEL", 8, 30.0,
                        os.path.join(workdir, "germlineIndel.json"))
    counts, out, row = phase_mode(
        torch, cuda, "evs", fa, bam, n_reads, mb, workdir,
        [*extra, "--snv-scoring-model-file", snv,
         "--indel-scoring-model-file", indel])
    a = vcf_records(os.path.join(plain_out, "variants.vcf.gz"))
    b = vcf_records(os.path.join(out, "variants.vcf.gz"))
    changed = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    if changed == 0:
        fail("phase 12: EVS changed no record against phase 4")
    log("evs: " + json.dumps({"records_changed_by_evs": changed,
                              "records": len(b)}))
    return counts


def fit_launches_per_step(torch, ef, cc, log_theta, steps=20) -> dict:
    """The device work of one Adam step of fit_context on the card: the
    kernels and copies of a torch.profiler trace of a `steps`-step fit,
    each per step (None where the trace holds no device event)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ef.fit_context(cc, log_theta, n_steps=steps, device="cuda")
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in ev)
    return {"kernels_per_step": (len(ev) - copies) / steps if ev else None,
            "copies_per_step": copies / steps if ev else None,
            "trace_device_events": len(ev)}


def read_json(path):
    with open(path) as f:
        return json.load(f)


def npz_arrays(path):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def phase_error(np, torch, cuda: bool, fa, bam, n_reads, mb, workdir,
                extra):
    """Phase 15: germline --estimate-sequence-error, cuda then cpu (the
    launch counters set to 0 just before the cuda run and read just
    after); the counts' npz arrays equal, the model's rates within
    ERR_FLAT_RTOL, every record equal; then tools estimate-parameters on
    ERR_CONTEXTS of the counts, cuda against cpu within ERR_FIT_RTOL.
    Returns the cuda run's launch counts."""
    from strelka_tpu_torch.__main__ import main as torch_main
    from strelka_tpu_torch.models import error_fit as ef
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.pipeline import allele_counts as ac
    devices = ["cuda", "cpu"] if cuda else ["cpu"]
    npz, model = ("sequenceAlleleCounts.Sample000.npz",
                  "sequenceErrorModel.Sample000.json")
    row = {"contig_mb": mb, "reads": n_reads, "extra": extra}
    outs, counts = {}, None
    for device in devices:
        out = os.path.join(workdir, f"error_{device}")
        timer = StreamTimer(torch, device == "cuda")
        timer.wrap(ef, "fit_context", "error_fit")
        timer.wrap(sk, "score_best_offsets", "k1_score_best_offsets")
        host = StreamTimer(torch, False)
        host.wrap(ac, "collect_context_counts", "counting")
        fits0 = dict(ef.FIT_STATS)
        try:
            wall, _, c = launches_during(
                lambda: run_cli(fa, bam, out, device, extra))  # noqa: B023
        finally:
            timer.restore()
            host.restore()
        var, gv = check_outputs(out, n_reads)
        stream = timer.totals_ms()
        row[device] = {
            "wall_s": wall,
            "counting_host_s": host.totals_ms().get("counting", 0.0) / 1e3,
            "fit_wall_s": ef.FIT_STATS["seconds"] - fits0["seconds"],
            "fits": ef.FIT_STATS["fits"] - fits0["fits"],
            "adam_steps": ef.FIT_STATS["steps"] - fits0["steps"],
            "fit_stream_ms": stream.get("error_fit", 0.0),
            "stream_ms_by_phase": stream}
        row["variant_records"], row["gvcf_records"] = len(var), len(gv)
        outs[device] = out
        if counts is None:
            counts = c
            check_path_launches("error estimation", c, cuda)
            row["k1_launches"] = c["k1"]
        if not row[device]["fits"]:
            fail(f"phase 15 on {device}: no context was fitted")
    if cuda:
        a = npz_arrays(os.path.join(outs["cuda"], npz))
        b = npz_arrays(os.path.join(outs["cpu"], npz))
        if sorted(a) != sorted(b) or any(
                not np.array_equal(a[k], b[k]) for k in a):
            fail("phase 15: the allele counts differ, cuda against cpu")
        row["count_arrays_equal"] = len(a)
        mg, mc = (read_json(os.path.join(outs[d], model))["sample"][0]
                  for d in ("cuda", "cpu"))

        def motifs(m):
            return [(x["repeatPatternSize"], x["repeatCount"])
                    for x in m["motif"]], m["isStatic"]
        if motifs(mg) != motifs(mc):
            fail("phase 15: the models' motifs differ, cuda against cpu")
        worst = 0.0
        for x, y in zip(mg["motif"], mc["motif"]):
            for f in ("indelRate", "noisyLocusRate"):
                worst = max(worst, abs(x[f] - y[f]) / abs(y[f]))
        if worst > ERR_FLAT_RTOL:
            fail(f"phase 15: model rates differ by {worst:.3g} relative, "
                 f"over {ERR_FLAT_RTOL}")
        row["model_rates_max_rel_diff"] = worst
        row["records_equal"] = compare_records(
            outs["cuda"], outs["cpu"], ("variants.vcf.gz",
                                        "genome.S1.vcf.gz"),
            "error estimation: cuda against cpu")
    # tools estimate-parameters on ERR_CONTEXTS of the counts, each
    # device's JSON from its stdout
    full = ac.load_context_counts(os.path.join(outs[devices[0]], npz))
    sub = os.path.join(workdir, "error_contexts.npz")
    ac.save_context_counts(sub, {k: full[k] for k in ERR_CONTEXTS
                                 if k in full})
    if cuda:
        row["fit_launches"] = fit_launches_per_step(
            torch, ef, full[(1, 1)], float(np.log(0.001)))
    est = {}
    for device in devices:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = torch_main(["tools", "estimate-parameters", sub,
                             "indelIndy", "--device", device])
        if rc != 0:
            fail(f"tools estimate-parameters --device {device} exited {rc}")
        est[device] = json.loads(buf.getvalue())
        row[f"estimate_parameters_{device}_wall_s"] = (
            time.perf_counter() - t0)
    if cuda:
        worst = 0.0
        if list(est["cuda"]) != list(est["cpu"]):
            fail("phase 15: estimate-parameters contexts differ")
        for ctx, want in est["cpu"].items():
            for k, v in want.items():
                worst = max(worst, abs(est["cuda"][ctx][k] - v) / abs(v))
        if worst > ERR_FIT_RTOL:
            fail(f"phase 15: estimate-parameters differs by {worst:.3g} "
                 f"relative, over {ERR_FIT_RTOL}")
        row["estimate_parameters_max_rel_diff"] = worst
    row["estimate_parameters_contexts"] = len(est["cpu"])
    log("error: " + json.dumps(row))
    return counts


NOISE_MB = 0.4     # phase 17's span: the panel's normals and the --region
SIM_SITES = 20_000  # phase 18's het and hom-ref germline sites each
SIM_STRELKA = 2_000  # phase 18's somatic sites per simulated state
MESH_SHAPES = ((2, 1), (1, 2), (2, 2), (4, 1))   # phase 19's (dp, sp)
# the wall each of phases 16-19 is sized to fit (s), logged beside its wall
BUDGET_S = {16: 15, 17: 120, 18: 20, 19: 60}


def quiet(fn):
    """fn() with its stderr captured: (fn's result, the captured text)."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        out = fn()
    return out, buf.getvalue()


def check_dq_only(src, out, label) -> dict:
    """Fails unless `out` holds every record of `src` in order, each
    unchanged but for a DQ= appended to INFO; returns the counts."""
    a, b = vcf_records(src), vcf_records(out)
    if len(a) != len(b):
        fail(f"{label}: {len(a)} records in, {len(b)} out")
    dq = []
    for ra, rb in zip(a, b):
        if ra == rb:
            continue
        info = ra[7]
        ok = (ra[:7] == rb[:7] and ra[8:] == rb[8:]
              and (rb[7].startswith(info + ";DQ=") if info != "."
                   else rb[7].startswith("DQ=")))
        if not ok:
            fail(f"{label}: a record changed beyond DQ:\n {ra[:8]}\n "
                 f"{rb[:8]}")
        dq.append(float(rb[7].rsplit("DQ=", 1)[1].split(";")[0]))
    return {"records": len(b), "scored": len(dq),
            "dq_max": max(dq) if dq else None,
            "dq_ge_20": sum(x >= 20 for x in dq)}


def phase_denovo(cuda: bool, workdir, n_samples=3):
    """Phase 16: denovo in per-sample mode on phase 10's gVCFs (sample 1
    the proband, 2 the mother, 3 the father) and in multi-sample mode on
    its variants.vcf.gz; every input record kept, changed in DQ alone."""
    from strelka_tpu_torch.__main__ import main as torch_main
    joint = os.path.join(workdir, f"joint_{'cuda' if cuda else 'cpu'}")
    gv = [os.path.join(joint, f"genome.S{i + 1}.vcf.gz")
          for i in range(n_samples)]
    var = os.path.join(joint, "variants.vcf.gz")
    ids = [f"joint_S{i + 1}" for i in range(n_samples)]
    row = {}
    for label, argv, src in (
            ("per_sample", ["--proband", gv[0], "--mother", gv[1],
                            "--father", gv[2]], gv[0]),
            ("multi_sample", ["--vcf", var, "--proband-id", ids[0],
                              "--mother-id", ids[1], "--father-id", ids[2]],
             var)):
        out = os.path.join(workdir, f"denovo_{label}.vcf.gz")
        t0 = time.perf_counter()
        rc, err = quiet(lambda: torch_main(  # noqa: B023
            ["denovo", *argv, "--output", out]))
        if rc != 0:
            fail(f"denovo ({label}) exited {rc}: {err.strip()}")
        row[label] = dict(check_dq_only(src, out, f"denovo {label}"),
                          wall_s=time.perf_counter() - t0,
                          message=err.strip())
    log("denovo: " + json.dumps(row))


def phase_noise(cuda: bool, fa, nbam, tbam, tn_mb, workdir):
    """Phase 17: two more 30x normals of phase 6's reference (ref_seed
    11, seeds 23 and 24) over its first NOISE_MB Mb through
    noise-extractor; then the somatic CLI with --noise-vcf on phase 6's
    T/N, --region over that span, cuda then cpu (every record equal),
    and on cuda without the panel: the records whose PNOISE/PNOISE2 or
    FILTER the panel moved are logged."""
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.__main__ import main as torch_main
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    from strelka_tpu_torch.io.fasta import FastaReference, decode_bases
    span = int(min(NOISE_MB, tn_mb) * 1_000_000)
    ref = FastaReference(fa)
    full = ref.contig_length("syn")
    t0 = time.perf_counter()
    bams, n_reads = [], 0
    for seed in (23, 24):
        refs, batch, _ = synth.generate(L=span, depth=30, read_len=150,
                                        snv_every=900, indel_every=1200,
                                        seed=seed, ref_seed=11)
        if refs != decode_bases(ref.fetch("syn", 0, span)):
            fail("phase 17: the panel's reference is not phase 6's")
        bam = os.path.join(workdir, f"panel_normal{seed}.bam")
        write_bam(bam, BamHeader(text="", ref_names=["syn"],
                                 ref_lengths=[full]), batch)
        bams.append(bam)
        n_reads += batch.n
    row = {"span_mb": span / 1e6, "panel_reads": n_reads,
           "data_s": time.perf_counter() - t0}
    panel = os.path.join(workdir, "noise_panel.vcf.gz")
    t0 = time.perf_counter()
    rc, err = quiet(lambda: torch_main(
        ["noise-extractor", "--reference", fa, "--output", panel,
         "--align-file", bams[0], "--align-file", bams[1]]))
    if rc != 0:
        fail(f"noise-extractor exited {rc}: {err.strip()}")
    row["extractor_wall_s"] = time.perf_counter() - t0
    sites = vcf_records(panel)
    if not sites or any(r[8] != "DP:AD" or len(r) != 11 for r in sites):
        fail(f"phase 17: malformed or empty panel ({len(sites)} sites)")
    row["panel_sites"] = len(sites)
    region = ["--region", f"syn:1-{span}"]
    outs = {}
    runs = [("cuda", True), ("cpu", True), ("cuda", False)] if cuda else [
        ("cpu", True), ("cpu", False)]
    for device, with_panel in runs:
        tag = f"noise_{device}" + ("" if with_panel else "_bare")
        out = os.path.join(workdir, tag)
        extra = ["--noise-vcf", panel] if with_panel else []
        t0 = time.perf_counter()
        rc = torch_main(["somatic", "--reference", fa, "--normal-align-file",
                         nbam, "--tumor-align-file", tbam, "--output-dir",
                         out, "--device", device, *region, *extra])
        if rc not in (0, None):
            fail(f"phase 17: somatic {tag} exited {rc}")
        row[f"{tag}_wall_s"] = time.perf_counter() - t0
        outs[tag] = out
    dev = "cuda" if cuda else "cpu"
    if cuda:
        row["records_equal"] = compare_records(
            outs["noise_cuda"], outs["noise_cpu"], SOMATIC_OUTPUTS,
            "phase 17: somatic with the panel, cuda against cpu")
    moved = annotated = 0
    for name in SOMATIC_OUTPUTS:
        a = vcf_records(os.path.join(outs[f"noise_{dev}"], name))
        b = vcf_records(os.path.join(outs[f"noise_{dev}_bare"], name))
        if [r[:5] for r in a] != [r[:5] for r in b]:
            fail(f"phase 17: {name}'s sites moved with the panel")
        for ra, rb in zip(a, b):
            pn = info_of(ra, ("PNOISE", "PNOISE2"))
            annotated += pn != (None, None)
            moved += (pn != info_of(rb, ("PNOISE", "PNOISE2"))
                      or ra[6] != rb[6])
    row.update(records_moved_by_panel=moved, records_with_pnoise=annotated)
    log("noise: " + json.dumps(row))


def phase_sim(np, torch, dev, cuda: bool, n_sites: int, n_strelka: int):
    """Phase 18: germline sites from simulate_germline_sites (het A/C and
    hom-ref, n_sites each) through the SNV tiles, and
    simulate_strelka_sites (SOMATIC, REF, GERMLINE and NOISE states)
    through the somatic SNV model, on `dev` then on the CPU: every field
    equal; tests/test_simulators.py's gates on the card's results."""
    from strelka_tpu_torch import sim
    from strelka_tpu_torch.models import digt
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.models import somatic_snv as ss
    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    opt = sim.SimOptions(depth=30, qscore=30, ref_base=0)
    germ = {gt: sim.simulate_germline_sites(rng, n_sites, gt, opt)
            for gt in ((0, 1), (0, 0))}
    strelka = {}
    for mode in (sim.SIM_SOMATIC, sim.SIM_REF, sim.SIM_GERMLINE,
                 sim.SIM_NOISE):
        o = sim.StrelkaSimOptions(total_sites=n_strelka, ncov=35, tcov=60,
                                  mode=mode)
        strelka[mode] = list(sim.simulate_strelka_sites(rng, o))
    row = {"sites_germline": 2 * n_sites,
           "sites_somatic": len(strelka) * n_strelka,
           "draw_s": time.perf_counter() - t0}
    devices = [dev, torch.device("cpu")] if cuda else [dev]
    res, counts = {}, None

    def run(d):
        out = {}
        for gt, (b, q, f, m) in germ.items():
            tile = sd.SnvPileupTile(base_id=b, qual=q, is_fwd=f, mask=m,
                                    ref_gt=np.zeros(len(b), np.int32))
            out[gt] = sd.call_snv_tile_chunked(tile, device=d)
        for mode, sites in strelka.items():
            lh = []
            for key in ("normal", "tumor"):
                piles = [getattr(x, key) for x in sites]
                D = max(max(len(p[0]) for p in piles), 1)
                arr = [np.full((len(piles), D), -1, np.int32),
                       np.zeros((len(piles), D), np.int32),
                       np.zeros((len(piles), D), bool),
                       np.zeros((len(piles), D), bool)]
                for i, (pb, pq, pf) in enumerate(piles):
                    k = len(pb)
                    arr[0][i, :k], arr[1][i, :k] = pb, pq
                    arr[2][i, :k], arr[3][i, :k] = pf, True
                t = [torch.from_numpy(a).to(d) for a in arr]
                lh.append(ss.freq_grid_lhoods(
                    t[0], t[1], t[3], t[2],
                    torch.zeros(len(piles), dtype=torch.int32, device=d)))
            r = ss.somatic_snv_call_capped(*lh)
            out[mode] = {f: getattr(r, f).cpu().numpy()
                         for f in ss.SomaticSnvResult._fields}
        return out

    for d in devices:
        # the counters set to 0 just before each run and read just after
        res[d.type], row[f"{d.type}_s"], c = launches_during(
            lambda: run(d))  # noqa: B023
        if counts is None:
            counts = c
            check_snv_kernels("phase 18 germline", c, d.type == "cuda")
            check_snv_kernels("phase 18 somatic", c, d.type == "cuda",
                              somatic=True)
            row["snv_kernel_launches"] = c["snv_kernels"]
    if cuda:
        a, b = res["cuda"], res["cpu"]
        for gt in germ:
            for f in ("genome_max_gt", "poly_max_gt", "snv_qphred",
                      "genome_max_gt_qphred", "poly_max_gt_qphred",
                      "phred_loghood", "lhood"):
                if not np.array_equal(getattr(a[gt], f), getattr(b[gt], f)):
                    fail(f"phase 18: germline {gt} {f} differs, cuda "
                         f"against cpu")
        for mode in strelka:
            for f in ("qphred", "from_ntype_qphred", "ntype", "max_gt",
                      "nonsomatic_qphred"):
                if not np.array_equal(a[mode][f], b[mode][f]):
                    fail(f"phase 18: somatic {mode} {f} differs, cuda "
                         f"against cpu")
    got = res[dev.type]
    het = float((got[(0, 1)].genome_max_gt == digt.LABELS.index("AC")).mean())
    fp = float((got[(0, 0)].snv_qphred >= 30).mean())
    q15 = {m: float((got[m]["qphred"] >= 15).mean()) for m in strelka}
    row.update(het_rate=het, homref_fp_rate_q30=fp, somatic_q15_rate=q15)
    if het <= 0.97 or fp >= 0.01:
        fail(f"phase 18: germline gates missed: het {het}, FP {fp}")
    if (q15[sim.SIM_SOMATIC] <= 0.9 or q15[sim.SIM_REF] >= 0.05
            or q15[sim.SIM_GERMLINE] >= 0.05):
        fail(f"phase 18: somatic gates missed: {q15}")
    log("sim: " + json.dumps(row))
    return counts


def mesh_inputs(np, B, R, L, W):
    """K1 inputs with padding windows that tie real offsets and all-N
    reads that tie everywhere at lnmis (tests/test_mesh.py's cases)."""
    codes, delta, lnmis, win = k1_random(np, np.random.default_rng(19),
                                         B, R, L, W)
    win[:, :, W // 2:] = 4
    codes[:, :2] = 4
    delta[:, :2] = 0.0
    lnmis[:, :2] = 0.0
    return codes, delta, lnmis, win


def phase_mesh(np, torch, dev, cuda: bool, fa, bam, seg, out_dev, tn,
               som_dev, workdir):
    """Phase 19: germline --mesh auto and --mesh 1 on phase 4's data and
    somatic --mesh 1 on phase 6's (on the card), every record equal to
    phases 4 and 6, K1 launched one time a shard; sharded_best_offsets
    over meshes that repeat the one card at MESH_SHAPES, bit for bit one
    unsharded K1 launch, one launch a shard; the SNV and somatic chunks
    split over a mesh of the card four times, bit for bit; dryrun(1);
    --mesh with more cards than are visible exits 2. Returns the CLI
    runs' launch counts by path."""
    from strelka_tpu_torch.__main__ import main as torch_main
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.parallel import mesh as pm
    from strelka_tpu_torch.pipeline import somatic_caller as sc
    device = dev.type
    row, paths = {}, {}
    for spec in ("auto", "1"):
        out = os.path.join(workdir, f"mesh_{spec}")
        wall, _, c = launches_during(lambda: run_cli(  # noqa: B023
            fa, bam, out, device, ["--max-region-size", str(seg), "--mesh",
                                   spec]))
        check_path_launches(f"germline --mesh {spec}", c, cuda)
        check_snv_kernels(f"germline --mesh {spec}", c, cuda)
        row[f"germline_mesh_{spec}"] = {
            "wall_s": wall, "k1_launches": c["k1"],
            "records_equal": compare_records(
                out, out_dev, ("variants.vcf.gz", "genome.S1.vcf.gz"),
                f"germline --mesh {spec} against phase 4")}
        paths[f"germline_mesh_{spec}"] = c
    fa_tn, nbam, tbam = tn[:3]
    out = os.path.join(workdir, "mesh_somatic")
    shutil.rmtree(out, ignore_errors=True)
    rc, wall, c = launches_during(lambda: torch_main(
        ["somatic", "--reference", fa_tn, "--normal-align-file", nbam,
         "--tumor-align-file", tbam, "--output-dir", out, "--device", device,
         "--mesh", "1"]))
    if rc not in (0, None):
        fail(f"somatic --mesh 1 exited {rc}")
    check_path_launches("somatic --mesh 1", c, cuda)
    check_snv_kernels("somatic --mesh 1", c, cuda, somatic=True)
    row["somatic_mesh_1"] = {
        "wall_s": wall, "k1_launches": c["k1"],
        "records_equal": compare_records(out, som_dev, SOMATIC_OUTPUTS,
                                         "somatic --mesh 1 against phase 6")}
    paths["somatic_mesh_1"] = c
    # one card: a mesh of one entry; each run launches K1 as the
    # unmeshed run does, one launch a chunk (a shard)
    if cuda:   # on the CPU a mesh repeats the CPU: any N is there
        too_many = str(torch.cuda.device_count() + 1)
        rc, err = quiet(lambda: torch_main(
            ["germline", "--reference", fa, "--align-file", bam,
             "--output-dir", os.path.join(workdir, "mesh_too_many"),
             "--device", device, "--mesh", too_many]))
        if rc == 0 or "visible" not in err:
            fail(f"germline --mesh {too_many} exited {rc}: {err.strip()}")
        row["mesh_past_the_cards"] = {"spec": too_many, "exit": rc,
                                      "message": err.strip()}
    # sharded K1 over meshes that repeat the card
    B, R, L, W = 256, 32, 160, 192
    host = [torch.from_numpy(a) for a in mesh_inputs(np, B, R, L, W)]
    one = sk.score_best_offsets(*(t.to(dev) for t in host))
    want = (one[0].cpu(), one[1].cpu())
    sharded = {}
    for dp, sp in MESH_SHAPES:
        fn = pm.sharded_best_offsets(
            sk.score_best_offsets, pm.make_mesh([dev] * (dp * sp), dp=dp,
                                                sp=sp))
        before = sk.LAUNCHES
        got = fn(*host)
        n = sk.LAUNCHES - before
        if cuda and n != dp * sp:
            fail(f"sharded K1 ({dp},{sp}) launched {n} times, not {dp * sp}")
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            fail(f"sharded K1 ({dp},{sp}) differs from one launch")
        sharded[f"{dp}x{sp}"] = {"launches": n, "ms": time_ms(
            torch, cuda, lambda: fn(*host), 1 if not cuda else 10)}  # noqa: B023
    row["sharded_k1"] = dict(shape=[B, R, L, W], **sharded)
    # the SNV chunks (two full and a tail) and the somatic tier1 chunks
    # split over the card four times
    rng = np.random.default_rng(20)
    Lr, D = 2 * (sd.SNV_TILE_L * 4 if cuda else sd.SNV_TILE_L) + 777, 40
    refc = rng.integers(0, 4, Lr).astype(np.int32)
    base = np.where(rng.random((Lr, D)) < 0.2, rng.integers(0, 4, (Lr, D)),
                    refc[:, None]).astype(np.int8)
    tile = sd.SnvPileupTile(
        base_id=base, qual=rng.integers(0, 45, (Lr, D)).astype(np.uint8),
        is_fwd=rng.random((Lr, D)) < 0.5, mask=rng.random((Lr, D)) < 0.8,
        ref_gt=refc)
    ns = __import__("types").SimpleNamespace
    pus = [ns(base_id=base, qual=tile.qual.astype(np.int16),
              is_fwd=tile.is_fwd, valid=tile.mask,
              used=rng.random((Lr, D)) < 0.9, tier2_used=tile.mask)
           for _ in range(2)]

    def chunks(n):
        # a 1x1 mesh is the unsharded run, on the torch tiles on either
        # device (without a mesh the CPU takes the native tail)
        pm.set_engine_mesh(pm.make_mesh([dev] * n, dp=n, sp=1))
        try:
            return (sd.call_snv_tile_chunked(tile, device=dev),
                    sc._snv_tier1_fused(pus, refc,
                                        ss.somatic_snv_call_capped, dev))
        finally:
            pm.set_engine_mesh(None)
    plain, meshed = chunks(1), chunks(4)
    for a, b in zip(plain, meshed):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if x is not None and (np.asarray(x).tobytes()
                                  != np.asarray(y).tobytes()):
                fail(f"phase 19: chunks over the mesh differ in {f}")
    row["mesh_chunks_equal"] = {"snv_rows": Lr, "somatic_rows": Lr}
    q, gt, best = pm.dryrun(1, device)
    row["dryrun"] = {"loci": int(q.shape[0]), "best": list(best.shape),
                     "finite": bool(torch.isfinite(best).all())}
    if not row["dryrun"]["finite"]:
        fail("phase 19: dryrun(1) gave a non-finite score")
    log("mesh: " + json.dumps(row))
    return paths


def phase_mesh_cards(np, torch, cuda: bool, workdir, mb, tn_mb):
    """--mesh-cards: the engine mesh over every visible card (at least
    two; on the CPU, in a rehearsal, the CPU four times). K1 on each
    card, launched with card 0 current, against card 0; K1 sharded over
    the cards (n x 1 and n/2 x 2) against one launch, one launch a
    shard, timed; germline without --mesh, with --mesh 1, auto and 2x2
    (four cards) on a `mb` Mb contig, and somatic without and with
    --mesh auto on a `tn_mb` Mb T/N contig: every record equal, K1's
    launches and each run's wall logged."""
    from strelka_tpu_torch.__main__ import main as torch_main
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.parallel import mesh as pm
    device = "cuda" if cuda else "cpu"
    n = torch.cuda.device_count() if cuda else 4
    if n < 2:
        fail(f"--mesh-cards needs two cards or more; {n} visible")
    cards = pm.local_devices(device, n)
    row = {"cards": n}
    host = [torch.from_numpy(a) for a in mesh_inputs(np, 256, 32, 160, 192)]
    one = sk.score_best_offsets(*(t.to(cards[0]) for t in host))
    want = (one[0].cpu(), one[1].cpu())
    for d in cards[1:]:
        with (torch.cuda.device(0) if cuda else contextlib.nullcontext()):
            got = sk.score_best_offsets(*(t.to(d) for t in host))
        if got[0].device != d or not (torch.equal(got[0].cpu(), want[0])
                                      and torch.equal(got[1].cpu(),
                                                      want[1])):
            fail(f"K1 on {d} with card 0 current differs from card 0")
    row["k1_on_every_card_equal"] = True
    sharded = {}
    for dp, sp in [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 else []):
        fn = pm.sharded_best_offsets(sk.score_best_offsets,
                                     pm.make_mesh(cards, dp=dp, sp=sp))
        before = sk.LAUNCHES
        got = fn(*host)
        launched = sk.LAUNCHES - before
        if cuda and launched != dp * sp:
            fail(f"sharded K1 ({dp},{sp}) launched {launched} times")
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            fail(f"sharded K1 ({dp},{sp}) over the cards differs")
        sharded[f"{dp}x{sp}"] = {"launches": launched, "ms": time_ms(
            torch, cuda, lambda: fn(*host), 10 if cuda else 1)}  # noqa: B023
    row["sharded_k1"] = dict(shape=[256, 32, 160, 192], **sharded)
    fa, bam, n_reads = make_dataset(np, workdir, mb)
    specs = ["", "1", "auto"] + (["2x2"] if n == 4 else [])
    for spec in specs:
        out = os.path.join(workdir, f"cards_mesh_{spec or 'none'}")
        extra = ["--mesh", spec] if spec else []
        wall, _, c = launches_during(lambda: run_cli(  # noqa: B023
            fa, bam, out, device, extra))
        row[f"germline_mesh_{spec or 'none'}"] = {
            "wall_s": wall, "k1_launches": c["k1"], "records_equal": (
                compare_records(out, os.path.join(workdir, "cards_mesh_none"),
                                ("variants.vcf.gz", "genome.S1.vcf.gz"),
                                f"germline --mesh {spec}") if spec else None)}
    fa_tn, nbam, tbam = make_tn_dataset(np, workdir, tn_mb)[:3]
    for spec in ("", "auto"):
        out = os.path.join(workdir, f"cards_somatic_{spec or 'none'}")
        shutil.rmtree(out, ignore_errors=True)
        extra = ["--mesh", spec] if spec else []
        rc, wall, c = launches_during(lambda: torch_main(  # noqa: B023
            ["somatic", "--reference", fa_tn, "--normal-align-file", nbam,
             "--tumor-align-file", tbam, "--output-dir", out, "--device",
             device, *extra]))
        if rc not in (0, None):
            fail(f"somatic --mesh {spec} exited {rc}")
        row[f"somatic_mesh_{spec or 'none'}"] = {
            "wall_s": wall, "k1_launches": c["k1"], "records_equal": (
                compare_records(out, os.path.join(workdir,
                                                  "cards_somatic_none"),
                                SOMATIC_OUTPUTS, "somatic --mesh auto")
                if spec else None)}
    log("mesh_cards: " + json.dumps(row))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at a small size; no result line")
    ap.add_argument("--mesh-cards", action="store_true",
                    help="only the engine mesh over every visible card "
                         "(two or more); no result line")
    opts = ap.parse_args(argv)
    rehearse = opts.rehearse

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
    joint_mb = 0.1 if rehearse else 1.0
    t_start = time.perf_counter()

    log("== phase 1: build")
    phase_build(torch, cuda)
    if opts.mesh_cards:
        log("== the engine mesh over every visible card")
        workdir = os.path.join(HERE, "build", "smoke_cards")
        shutil.rmtree(workdir, ignore_errors=True)
        phase_mesh_cards(np, torch, cuda, workdir, 0.1 if rehearse else 1.0,
                         0.1 if rehearse else 0.5)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0

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
    # each (kinds, cases): KX-H's window boundaries and widths (W of one
    # window), KX-K's largest sums; the ablations at L = 224 (A in K1's
    # ring at R = 128), nodot's whole slabs (R = W = 4L) and ties across
    # N tiles, nomax's ties across N tiles, KX-I's limbs at its clamp
    # (126, 127, 128, 255 and negative deltas) and ties across N tiles,
    # noW timed in plan S at the main path's top shape and with a partial
    # last group (B % 4 = 2) in both plans; last, as their before-numbers
    # lack them, the tensor-core ablations and KX-I beyond the SIMT and
    # mma.sync kernels' L
    ablations = ("noA", "noW", "nomax", "nodot")
    kx_kind_edge = [
        (sv.HAP_KINDS, [("window_ties", (8, 40, 128, 96), hap_window_ties),
                        ("window_ties", (8, 128, 160, 160), hap_window_ties),
                        ("ragged", (4, 33, 99, 160), k1_random)]),
        (("onesum", "onesum_simt"), [("max_sum", (4, 64, 256, 128),
                                      onesum_max)]),
        (ablations + tuple(f"{a}_simt" for a in ablations),
         [("ring", (8, 128, 224, 256), k1_random)]),
        (("nodot", "nodot_simt"),
         [("whole_slabs", (4, 128, 32, 128), k1_random),
          ("whole_slabs", (2, 256, 64, 256), k1_random),
          ("tile_ties", (4, 128, 128, 192), nodot_tile_ties)]),
        (("nomax", "nomax_simt"),
         [("tile_ties", (8, 128, 128, 192), k1_tile_ties)]),
        (("int8", "int8_mma"),
         [("limbs", (64, 128, 128, 128), int8_limbs),
          ("limbs", (16, 128, 160, 256), int8_limbs),
          ("tile_ties", (8, 128, 128, 192), k1_tile_ties)]),
        (("noW", "noW_simt"),
         [("random", (256, 32, 160, 192), k1_random),
          ("partial_group", (10, 128, 128, 128), k1_code4),
          ("partial_group", (10, 128, 160, 256), k1_code4)]),
        (("noA", "noW", "nomax", "int8"),
         [("long", (2, 64, 1000, 128), k1_random)])]
    kx_rows = phase_kx(np, torch, dev, cuda, kx_shapes, kx_hap, kx_edge,
                       kx_kind_edge, runner_rows)
    log(f"phase 2c took {time.perf_counter() - t_kx:.1f} s")

    log("== phase 3: snv tiles vs the CPU path; KG-H vs its plain version")
    t0 = time.perf_counter()
    kgh_row = phase_snv(np, torch, dev, cuda, 2000 if rehearse else 200_000)
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")

    log("== phase 3b: somatic SNV model vs the CPU path; KS-G and KS-P vs "
        "their plain versions")
    t0 = time.perf_counter()
    phase_somatic_snv(np, torch, dev, 2000 if rehearse else 200_000)
    log(f"phase 3b took {time.perf_counter() - t0:.1f} s")

    # a fresh work directory: a --jobs run would resume from the
    # taskstates of an earlier smoke's outputs
    workdir = os.path.join(HERE, "build", "smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"== phase 4: germline --device {dev.type} end to end")
    fa, bam, n_reads = make_dataset(np, workdir, mb)
    out_dev = os.path.join(workdir, f"out_{dev.type}")
    # one segment a worker in phase 8: the CLI's default 1 Mb on the card
    seg = int(mb * 1_000_000) // JOBS
    germline, wall_dev = phase_e2e(torch, cuda, fa, bam, n_reads, mb,
                                   out_dev, dev.type,
                                   ["--max-region-size", str(seg)])
    # k1 again at the main path's most frequent launch shape
    shapes = germline["score"]
    top = tuple(map(int, max(shapes, key=shapes.get).split(",")))
    rows, err = phase_k1(np, torch, dev, cuda, [top],
                         iters=1 if rehearse else 20, edge_cases=False)
    k1_rows.append(dict(rows[0], case="main_path_top"))
    k1_err = max(k1_err, err)

    if cuda:
        log("== phase 5: the same run with --device cpu")
        out_cpu = os.path.join(workdir, "out_cpu")
        wall_cpu = run_cli(fa, bam, out_cpu, "cpu",
                           ["--max-region-size", str(seg)])
        n, other = compare_runs(out_dev, out_cpu)
        log("cuda-vs-cpu: " + json.dumps({
            "records": n, "differ_other_fields": other,
            "cpu_wall_s": wall_cpu}))

    log(f"== phase 6: somatic --device {dev.type} end to end")
    tn = make_tn_dataset(np, workdir, tn_mb)
    fa_tn, nbam, tbam, n_tn, som_snv = tn
    som_dev = os.path.join(workdir, f"som_{dev.type}")
    kept: dict = {}
    somatic = phase_somatic_e2e(torch, cuda, fa_tn, nbam, tbam, n_tn,
                                som_snv, tn_mb, som_dev, dev.type, kept)
    log("== phase 6b: KS-G and KS-P on phase 6's first chunk vs their "
        "plain versions")
    t0 = time.perf_counter()
    ksg_row, ksp_row = phase_somatic_main_shape(np, torch, dev, cuda, kept)
    del kept
    log(f"phase 6b took {time.perf_counter() - t0:.1f} s")
    if cuda:
        log("== phase 7: the same somatic run with --device cpu")
        som_cpu = os.path.join(workdir, "som_cpu")
        phase_somatic_e2e(torch, False, fa_tn, nbam, tbam, n_tn, som_snv,
                          tn_mb, som_cpu, "cpu")
        n, other = compare_somatic_runs(som_dev, som_cpu)
        log("somatic cuda-vs-cpu: " + json.dumps({
            "records": n, "differ_other_fields": other}))

    log(f"== phase 8: germline --device {dev.type} --jobs {JOBS}, cold")
    jobs_g = phase_germline_jobs(cuda, fa, bam, n_reads, seg, out_dev,
                                 wall_dev, workdir)

    log(f"== phase 9: somatic --device {dev.type} --jobs {JOBS}")
    jobs_s = phase_somatic_jobs(cuda, fa_tn, nbam, tbam, n_tn, som_snv,
                                int(tn_mb * 1_000_000) // JOBS, som_dev,
                                workdir)

    log("== phase 10: joint germline, three samples, cuda against cpu")
    joint = phase_joint(cuda, *make_joint_dataset(workdir, joint_mb),
                        workdir)

    log(f"== phase 11: germline --device {dev.type} on CRAM against BAM")
    cram = phase_cram(cuda, workdir)

    # phases 12-14 on phase 4's data, one segment a worker's size as in
    # phase 4; phase 13 (host code) on the contig's first CONT_MB Mb
    base_args = ["--max-region-size", str(seg)]
    log("== phase 12: germline EVS model files, cuda then cpu")
    t0 = time.perf_counter()
    evs = phase_evs(np, torch, cuda, fa, bam, n_reads, mb, workdir,
                    base_args, out_dev)
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    log("== phase 13: germline --call-continuous-vf, cuda then cpu")
    t0 = time.perf_counter()
    cont_mb = min(mb, CONT_MB)
    region = f"syn:1-{int(cont_mb * 1_000_000)}"
    continuous, _, _ = phase_mode(
        torch, cuda, "continuous", fa, bam, n_reads, cont_mb, workdir,
        [*base_args, "--call-continuous-vf", "syn", "--region", region],
        k1_expected=False, tiles_expected=False)
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    log("== phase 14: germline --rna --disable-evs, cuda then cpu")
    t0 = time.perf_counter()
    rna_mb = min(mb, RNA_MB)
    rna, _, _ = phase_mode(torch, cuda, "rna", fa, bam, n_reads, rna_mb,
                           workdir, [*base_args, "--rna", "--disable-evs",
                                     "--region",
                                     f"syn:1-{int(rna_mb * 1_000_000)}"])
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    log("== phase 15: germline --estimate-sequence-error, cuda then cpu; "
        "tools estimate-parameters")
    t0 = time.perf_counter()
    error = phase_error(np, torch, cuda, fa, bam, n_reads, cont_mb, workdir,
                        [*base_args, "--region", region,
                         "--estimate-sequence-error"])
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")

    log("== phase 16: denovo on phase 10's trio, per-sample and "
        "multi-sample")
    t0 = time.perf_counter()
    phase_denovo(cuda, workdir)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s of its "
        f"{BUDGET_S[16]} s budget")
    log("== phase 17: noise-extractor panel, then somatic --noise-vcf, "
        "cuda then cpu")
    t0 = time.perf_counter()
    phase_noise(cuda, fa_tn, nbam, tbam, tn_mb, workdir)
    log(f"phase 17 took {time.perf_counter() - t0:.1f} s of its "
        f"{BUDGET_S[17]} s budget")
    log("== phase 18: the site simulators through the SNV tiles and the "
        "somatic model, cuda then cpu")
    t0 = time.perf_counter()
    sim_counts = phase_sim(np, torch, dev, cuda,
                           2000 if rehearse else SIM_SITES,
                           200 if rehearse else SIM_STRELKA)
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s of its "
        f"{BUDGET_S[18]} s budget")
    log(f"== phase 19: the engine mesh (--mesh) on {dev.type}")
    t0 = time.perf_counter()
    mesh_paths = phase_mesh(np, torch, dev, cuda, fa, bam, seg, out_dev, tn,
                            som_dev, workdir)
    log(f"phase 19 took {time.perf_counter() - t0:.1f} s of its "
        f"{BUDGET_S[19]} s budget")

    # each CLI path's launch counts, read just after it ran
    paths = {"germline": germline, "somatic": somatic,
             "germline_jobs": jobs_g, "somatic_jobs": jobs_s,
             "germline_joint": joint, "cram": cram, "germline_evs": evs,
             "germline_continuous": continuous, "germline_rna": rna,
             "germline_error_estimation": error, **mesh_paths,
             "simulators": sim_counts}

    log(f"total {time.perf_counter() - t_start:.1f} s")

    top = k1_rows[-1]
    k1h = k1h_rows[0]   # bench.py's shape

    def launches(key):
        """(launches on every path and in the runner, by path)."""
        by = {**{p: c[key] for p, c in paths.items()},
              "variants_runner": kx_runner[key]}
        return sum(by.values()), by

    kernels = [{
        "name": "score_best_offsets",
        "route": "cuda",
        "source": "strelka_tpu_torch/csrc/score_best_offsets_tc.cu",
        "replaces": sv.K1_TPU,
        "launches": launches("k1")[0],
        "launches_by_path": launches("k1")[1],
        "launches_by_shape": {p: c["score"] for p, c in paths.items()},
        "max_abs_err": k1_err,
        "tolerance": "bit for bit",
        "shape": top["shape"],
        "ms": top["ms"],
        "device_ms": top.get("device_ms"),
        "prev_ms": top["prev_ms"],
        "prev_device_ms": top.get("prev_device_ms"),
        "plain_ms": top["plain_ms"],
        "library_ms": top["library_ms"],
        "library_equal": top["library_equal"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "bound_share": top["bound_share"],
        "device_bound_share": top.get("device_bound_share"),
    }]
    # K1-h, then K1-h-s (its before-number); no CLI path runs
    # mode="highest", so phase 2b alone is expected to launch them
    for key, name, source, prefix in (
            ("k1h", "score_best_offsets_highest",
             "strelka_tpu_torch/csrc/score_highest_tc.cu", ""),
            ("k1h_simt", "score_best_offsets_highest_simt",
             "strelka_tpu_torch/csrc/score_best_offsets.cu", "prev_")):
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "strelka_tpu/ops/pallas_readlik.py:170",
            "launches": launches(key)[0],
            "launches_by_path": launches(key)[1],
            "max_abs_err": max(r[f"{prefix}max_abs_err"] for r in k1h_rows
                               if r["case"] != "bench_unquantized"),
            "tolerance": f"atol {K1H_ATOL} (quantized deltas); f32 rounding "
                         f"bound (unquantized)",
            "shape": k1h["shape"],
            "ms": k1h[f"{prefix}ms"],
            "device_ms": k1h.get(f"{prefix}device_ms"),
            "plain_ms": k1h["plain_ms"],
            "library_ms": k1h["library_ms"],
            "library_equal": k1h["library_equal"],
            "bound_ms": k1h["bound_ms"],
            "bound_by": k1h["bound_by"],
            "bound_engine": k1h["bound_engine"],
            "bound_share": k1h["bound_ms"] / k1h[f"{prefix}ms"],
            "device_bound_share": k1h.get(f"{prefix}device_bound_share"),
        }
        if key == "k1h":
            row["prev_ms"] = k1h["prev_ms"]
            row["prev_device_ms"] = k1h.get("prev_device_ms")
        else:
            row["before_number_of"] = "score_best_offsets_highest"
        kernels.append(row)
    for kind, k in sv.KERNELS.items():
        rows = kx_rows[kind]
        top = rows[0]   # the harness's shape
        c = k.counter
        row = {
            "name": k.label,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": kx_runner[c] + sum(n["kx"].get(c, 0)
                                           for n in paths.values()),
            "launches_by_path": {**{p: n["kx"].get(c, 0)
                                    for p, n in paths.items()},
                                 "variants_runner": kx_runner[c]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": "bit for bit",
            "shape": top["shape"] + ([sv.HAP_WINDOWS]
                                     if kind in sv.HAP_KINDS else []),
            "ms": top["ms"],
            "device_ms": top.get("device_ms"),
            "plain_ms": top["plain_ms"],
            "k1_ms": top["k1_ms"],
            "library_ms": top["library_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "bound_share": top["bound_share"],
            "device_bound_share": top.get("device_bound_share"),
        }
        row["library_equal"] = top["library_equal"]
        if kind == "noW":
            row["G"] = top["G"]
            row["plan"] = top["plan"]
            row["plans"] = {",".join(map(str, r["shape"])): r["plan"]
                            for r in rows}
        if "prev_ms" in top:
            row["prev_ms"] = top["prev_ms"]
            row["prev_device_ms"] = top.get("prev_device_ms")
        if k.before_of:
            row["before_number_of"] = k.before_of
        kernels.append(row)
    # the SNV models' kernels: their launches on every path, their rows
    # from phases 3 and 3b
    from strelka_tpu_torch.ops import snv_kernels as snk
    for name, source, krow in (
            ("snv_hist_tile", "snv_hist_tile.cu", kgh_row),
            ("somatic_grid", "somatic_grid.cu", ksg_row),
            ("somatic_posterior", "somatic_posterior.cu", ksp_row)):
        by = {p: c["snv_kernels"].get(name, 0) for p, c in paths.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"strelka_tpu_torch/csrc/{source}",
            "replaces": snk.REPLACES[name],
            "launches": sum(by.values()),
            "launches_by_path": by,
            "max_abs_err": krow["max_abs_err"],
            "tolerance": "bit for bit (a NaN as a NaN)",
            "shape": krow["shape"],
            "ms": krow["ms"],
            "device_ms": krow.get("device_ms"),
            "plain_ms": krow["plain_ms"],
            "library_ms": krow["library_ms"],
            "bound_ms": krow["bound_ms"],
            "bound_by": krow["bound_by"],
            "bound_share": krow["bound_share"],
            "device_bound_share": krow.get("device_bound_share"),
            "trace": krow.get("trace"),
            "plain_trace": krow.get("plain_trace"),
            **{k: krow[k] for k in (
                "registers", "live_slots_a_row", "library_max_abs_diff",
                "sass_fp64_floor_ms", "clean_row_share", "exp_zero_share",
                "exp_zero_share_listed") if k in krow},
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
