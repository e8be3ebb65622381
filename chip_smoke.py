#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (strelka_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card, default sizes

Phases, each of which fails the run (non-zero exit, no result line):

1. build: the host library (make -C native) and every CUDA kernel of
   strelka_tpu_torch/csrc (one nvcc per source, started together);
2. k1: the scoring kernel against its plain torch version on the card,
   bit for bit, at the main path's shapes plus tie and code-4 cases,
   with both timed by CUDA events;
3. snv: the SNV tile functions on the card against the port's CPU path
   (integer fields equal, lhood bit-equal);
4. e2e: the germline CLI with --device cuda (WGS mode) on a synthetic
   contig (default 4 Mb at 30x, 150 bp reads), with the launch counters
   set to 0 just before and read just after;
5. cuda-vs-cpu: the same CLI with --device cpu on the same data; no
   record may differ in CHROM, POS, REF, ALT, FILTER or GT.

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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


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


def k1_bound_ms(B, R, L, W) -> tuple[float, str]:
    """Least time for the function on the card: each input read once
    and each output written once over HBM, against 2*B*R*L*W int8
    compare-adds at the tensor-core peak."""
    nbytes = B * (5 * R * L + L * W + 8 * R)
    ops = 2 * B * R * L * W
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
    events. Returns (k1 launches, k1 launch shapes)."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.pipeline import realign_batch as rb
    if cuda:
        from strelka_tpu_torch import _build
        _build.load("score_best_offsets")
    timer = StreamTimer(torch, cuda)
    timer.wrap(sk, "score_best_offsets", "k1_score_best_offsets")
    timer.wrap(sd, "call_snv_hist_tile", "snv_genotype_tiles")
    timer.wrap(sd, "snv_strand_bias_tile", "snv_strand_bias_tiles")
    sk.LAUNCHES = 0
    sd.LAUNCH_STATS.clear()
    rb.LAUNCH_STATS = {}
    try:
        wall = run_cli(fa, bam, out, device)
    finally:
        launches = sk.LAUNCHES
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
    e2e = {"contig_mb": mb, "reads": n_reads, "wall_s": wall,
           "reads_per_s": n_reads / wall,
           "variant_records": len(var), "gvcf_records": len(gv),
           "k1_launches": launches,
           "snv_tile_launches": {",".join(map(str, k)): v
                                 for k, v in snv_tiles.items()},
           "stream_ms_by_phase": phase_ms,
           "k1_launch_shapes": {",".join(map(str, k)): v
                                for k, v in score_shapes.items()}}
    log("e2e: " + json.dumps(e2e))
    return launches, score_shapes


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
    except ImportError as e:
        fail(f"strelka_tpu_torch is not importable beside chip_smoke.py: "
             f"{e}")
    if "jax" in sys.modules or "strelka_tpu" in sys.modules:
        fail("jax or strelka_tpu was imported")
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    mb = 0.1 if rehearse else 4.0
    t_start = time.perf_counter()

    log("== phase 1: build")
    phase_build(torch, cuda)

    main_shapes = [(256, r, 160, w) for r in (32, 128, 512)
                   for w in (256, 320)]
    main_shapes += [(256, 128, 128, 192), (128, 32, 128, 192)]
    if rehearse:
        main_shapes = [(8, 32, 64, 64), (4, 128, 96, 128)]
    log("== phase 2: k1 kernel vs plain version")
    k1_rows, k1_err = phase_k1(np, torch, dev, cuda, main_shapes,
                               iters=1 if rehearse else 20)

    log("== phase 3: snv tiles vs the CPU path")
    phase_snv(np, torch, dev, cuda, 2000 if rehearse else 200_000)

    workdir = os.path.join(HERE, "build", "smoke")
    log(f"== phase 4: germline --device {dev.type} end to end")
    fa, bam, n_reads = make_dataset(np, workdir, mb)
    out_dev = os.path.join(workdir, f"out_{dev.type}")
    launches, score_shapes = phase_e2e(torch, cuda, fa, bam, n_reads, mb,
                                       out_dev, dev.type)
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

    log(f"total {time.perf_counter() - t_start:.1f} s")

    top = k1_rows[-1]
    kernels = [{
        "name": "score_best_offsets",
        "route": "cuda",
        "source": "strelka_tpu_torch/csrc/score_best_offsets.cu",
        "replaces": "strelka_tpu/ops/pallas_readlik.py:76",
        "launches": launches,
        "max_abs_err": k1_err,
        "shape": top["shape"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
    }]
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
