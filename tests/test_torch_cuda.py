"""Tests of the port that need the card: the CUDA kernels (K1, the
tensor-core kernel, and K1-h on the bf16 tensor cores with K1-h-s, its
SIMT before-number; the K1-x variants, KX-P, KX-H, KX-I and the four
ablations (noA, noW in both its plans, nomax, nodot) on K1's pipeline and
KX-K on K1-h's among them, their before-numbers, and K1-s)
against their plain versions, the SNV tiles and the somatic SNV model on the card
against the CPU path, the SNV model kernels (KG-H, KG-SB, KG-R, KS-G,
KS-P) against their plain versions bit for bit, one launch a tile (and
on cuda:1 with two cards), the germline and somatic CLIs with --device
cuda against --device cpu, a cold --jobs 2 germline run on the card
against a single-process one, the error-model fits (the emulated
FMA, Adam, fit_context, two error_zoo fits) on the card against the CPU,
KE-F (the error fit, one launch a fit) against its plain step and its
torch model at the CLI's sizes, a 16-block cluster, 50,000 and 100,000
patterns and past what the card holds on chip, KZ (the zoo's fits behind
tools estimate-parameters: a run's fit starts side by side, one cluster a
start) against its torch model bit for bit in every regime, each start of
a batched launch against the same start alone, the tool's launches, and
against the plain version,
and the engine mesh: K1 sharded over a mesh that repeats cuda:0 against
one launch, a launch on cuda:1 against one on cuda:0 (with two cards),
the SNV and somatic chunks split over the mesh, and --mesh on the CLI.
They skip without a GPU. On a machine with one (which need not have
jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

This file imports nothing of jax or the JAX package.
"""
import gzip
import os

import numpy as np
import pytest
import torch

from strelka_tpu_torch.ops import fit_kernels
from strelka_tpu_torch.ops import score_variants as sv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def k1_inputs(rng, B, R, L, W):
    from strelka_tpu_torch.ops import readlik
    dl, ll = readlik.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    lnmis = np.where(codes < 4, ll[q], 0.0).sum(axis=2).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    return codes, dl[q], lnmis, win


@pytest.mark.parametrize("B,R,L,W", [(8, 32, 160, 256), (4, 128, 128, 192),
                                     (2, 512, 160, 320), (3, 40, 100, 70),
                                     (1, 32, 512, 64), (5, 200, 1000, 100),
                                     (2, 33, 99, 129), (2, 7, 1816, 257)])
def test_k1_kernel_bit_identical_to_plain(cuda, B, R, L, W):
    from strelka_tpu_torch.ops import score_kernel as sk
    arrs = k1_inputs(np.random.default_rng(B + R + L + W), B, R, L, W)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = sk.LAUNCHES
    kb, ko = sk.score_best_offsets(*t)
    assert sk.LAUNCHES == before + 1
    pb, po = sk.exact_best_offsets(*t)
    cb, co = sk.exact_best_offsets(*(torch.from_numpy(a) for a in arrs))
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(ko, po)
    assert torch.equal(kb.cpu(), cb) and torch.equal(ko.cpu(), co)


def test_k1_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from strelka_tpu_torch.ops import score_kernel as sk
    c, d, m, w = (torch.from_numpy(a).to(cuda)
                  for a in k1_inputs(np.random.default_rng(0), 2, 32, 64, 64))
    before = sk.LAUNCHES
    with pytest.raises(ValueError):
        sk.score_best_offsets(c.to(torch.int32), d, m, w)
    with pytest.raises(ValueError):
        sk.score_best_offsets(c, d.double(), m, w)
    with pytest.raises(ValueError):  # not contiguous
        sk.score_best_offsets(c, d, m, w.transpose(1, 2))
    with pytest.raises(ValueError):  # not contiguous
        sk.score_best_offsets(c[:, :, ::2], d[:, :, ::2], m, w[:, ::2])
    with pytest.raises(ValueError):  # window rows do not match L
        sk.score_best_offsets(c, d, m, w[:, :32].contiguous())
    with pytest.raises(ValueError):
        sk.score_best_offsets(c, d.cpu(), m, w)
    L = 1817                          # one past the kernel's range
    with pytest.raises(ValueError, match="range"):
        sk.score_best_offsets(*(torch.zeros(s, dtype=dt, device=cuda)
                                for s, dt in (((1, 2, L), torch.int8),
                                              ((1, 2, L), torch.float32),
                                              ((1, 2), torch.float32),
                                              ((1, L, 8), torch.int8))))
    assert sk.LAUNCHES == before


def tile_tie_inputs(rng, L, W, n_tile):
    """One pair per (N-tile boundary, placement): every read of a pair
    has the same bases and two offsets of its window carry them, so they
    tie at the top: across the boundary, both left, both right, and a
    tile apart. Returns the inputs and the first offsets."""
    from strelka_tpu_torch.ops import readlik
    dl, ll = readlik.quantized_qscore_luts()
    pairs = [(t + a, t + b) for t in range(n_tile, W, n_tile)
             for a, b in ((-1, 0), (-2, -1), (0, 1), (-1, n_tile))
             if t + b < W]
    B, R = len(pairs), 40
    reads = rng.integers(0, 4, (B, L))
    codes = np.repeat(reads[:, None], R, axis=1).astype(np.int8)
    q = rng.integers(2, 42, (B, R, L))
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b, cols in enumerate(pairs):
        for w in cols:
            win[b, :, w] = reads[b]
    lnmis = ll[q].sum(axis=2).astype(np.float32)
    return (codes, dl[q], lnmis, win), [p[0] for p in pairs]


@pytest.mark.parametrize("L,W", [(160, 320), (128, 192), (100, 200)])
def test_k1_ties_across_n_tile_boundaries(cuda, L, W):
    from strelka_tpu_torch.ops import score_kernel as sk
    arrs, first = tile_tie_inputs(np.random.default_rng(L + W), L, W,
                                  sk.TC_N_TILE)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    kb, ko = sk.score_best_offsets(*t)
    pb, po = sk.exact_best_offsets(*t)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(ko, po)
    assert ko[:, 0].tolist() == first


def test_k1_longest_reads_all_limbs_255(cuda):
    """L at the wrapper's maximum with every limb at 255: the sums pass
    2^24 and f32(S) rounds; still bit for bit."""
    from strelka_tpu_torch.ops import score_kernel as sk
    rng = np.random.default_rng(5)
    B, R, L, W = 3, 40, 1816, 130
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    delta = np.full((B, R, L), np.float32(65535 / 2048))
    lnmis = rng.uniform(-500, -100, (B, R)).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    t = [torch.from_numpy(a).to(cuda) for a in (codes, delta, lnmis, win)]
    kb, ko = sk.score_best_offsets(*t)
    pb, po = sk.exact_best_offsets(*t)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(ko, po)


def test_k1_launches_the_tensor_core_kernel_not_k1s(cuda):
    from strelka_tpu_torch.ops import score_kernel as sk
    t = [torch.from_numpy(a).to(cuda)
         for a in k1_inputs(np.random.default_rng(2), 4, 32, 160, 192)]
    before = (sk.LAUNCHES, sv.LAUNCHES_SIMT)
    got = sk.score_best_offsets(*t)
    assert (sk.LAUNCHES, sv.LAUNCHES_SIMT) == (before[0] + 1, before[1])
    prev = sv.score_simt(*t)
    assert (sk.LAUNCHES, sv.LAUNCHES_SIMT) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, prev))


def test_snv_tiles_on_card_match_cpu_path(cuda):
    from strelka_tpu_torch.models import snv_digt as sd
    rng = np.random.default_rng(1)
    for D in (64, 160):
        n = 5000
        ref = rng.integers(0, 5, n).astype(np.int32)
        base = rng.integers(0, 4, (n, D)).astype(np.int8)
        base = np.where(rng.random((n, D)) < 0.3, base,
                        np.minimum(ref, 3)[:, None]).astype(np.int8)
        tile = sd.SnvPileupTile(
            base_id=base, qual=rng.integers(0, 45, (n, D)).astype(np.uint8),
            is_fwd=rng.random((n, D)) < 0.5, mask=rng.random((n, D)) < 0.8,
            ref_gt=ref)
        hap = rng.random(n) < 0.1
        got = sd.call_snv_tile_chunked(tile, 0.001, hap, device=cuda)
        want = sd.call_snv_tile_chunked(tile, 0.001, hap, device="cpu")
        np.testing.assert_array_equal(got.lhood.view(np.int32),
                                      want.lhood.view(np.int32))
        for f in ("genome_max_gt", "poly_max_gt", "snv_qphred",
                  "genome_max_gt_qphred", "poly_max_gt_qphred",
                  "phred_loghood"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("D,L", [(45, 3000), (70, 33_000)])
def test_rna_snv_tiles_on_card_match_cpu_path(cuda, D, L):
    """RNA mode (the het-VF extension, per-call dependent-eprob deltas)
    on the card equals the CPU path: lhood, strand bias and the integer
    fields bit for bit, at one tile's D and, past SNV_TILE_L rows, in
    chunks whose D is padded to 32."""
    from strelka_tpu_torch.models import snv_digt as sd
    rng = np.random.default_rng(D)
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.3, rng.integers(0, 4, (L, D)),
                    np.minimum(ref, 3)[:, None]).astype(np.int8)
    plane = np.where(rng.random((L, D)) < 0.1, -rng.random((L, D)),
                     0.0).astype(np.float32)
    dep = (np.zeros((L, 4), np.float32),
           lambda rows: plane[np.arange(L) if rows is None else rows])
    tile = sd.SnvPileupTile(
        base_id=base, qual=rng.integers(0, 45, (L, D)).astype(np.uint8),
        is_fwd=rng.random((L, D)) < 0.5, mask=rng.random((L, D)) < 0.8,
        ref_gt=ref)
    got, want = (sd.call_snv_tile_chunked(tile, 0.001, None, 0.45, 0.0501,
                                          dep=dep, device=d)
                 for d in (cuda, "cpu"))
    assert (want.snv_qphred != 0).any()
    for f in ("lhood", "strand_bias", "genome_max_gt", "poly_max_gt",
              "snv_qphred", "genome_max_gt_qphred", "poly_max_gt_qphred",
              "phred_loghood"):
        a, b = np.ascontiguousarray(getattr(got, f)), np.ascontiguousarray(
            getattr(want, f))
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("extra", [[], ["--rna", "--disable-evs"]],
                         ids=["wgs", "rna"])
def test_germline_cli_cuda_matches_cpu(cuda, tmp_path, extra):
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.__main__ import main
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    from strelka_tpu_torch.ops import score_kernel as sk
    refs, batch, _ = synth.generate(L=60_000, depth=25, snv_every=700,
                                    indel_every=1000, seed=11)
    fa = tmp_path / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    bam = str(tmp_path / "s.bam")
    write_bam(bam, BamHeader(text="", ref_names=["syn"],
                             ref_lengths=[len(refs)]), batch)
    before = sk.LAUNCHES
    outs = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / dev)
        assert main(["germline", "--reference", str(fa), "--align-file", bam,
                     "--output-dir", out, "--device", dev, *extra]) == 0
        outs[dev] = out
    assert sk.LAUNCHES > before
    for name in ("variants.vcf.gz", "genome.S1.vcf.gz"):
        recs = []
        for dev in ("cuda", "cpu"):
            with gzip.open(os.path.join(outs[dev], name), "rt") as f:
                recs.append([l for l in f if not l.startswith("#")])
        assert recs[0] == recs[1], name


def test_germline_jobs_cold_on_card_matches_single(cuda, tmp_path):
    """A cold --jobs 2 run on the card (every kernel library made stale
    first): the parent builds each library once before it spawns, no
    worker builds one, the parent initializes no CUDA, and the records
    equal a single-process --device cuda run's."""
    import subprocess
    import sys

    from strelka_tpu_torch import _build, synth
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    refs, batch, _ = synth.generate(L=60_000, depth=25, snv_every=700,
                                    indel_every=1000, seed=11)
    fa = tmp_path / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    bam = str(tmp_path / "s.bam")
    write_bam(bam, BamHeader(text="", ref_names=["syn"],
                             ref_lengths=[len(refs)]), batch)
    base = ["germline", "--reference", str(fa), "--align-file", bam,
            "--max-region-size", "15000", "--device", "cuda"]
    for name in _build.sources():
        if os.path.exists(_build.lib_path(name)):
            os.utime(_build.lib_path(name), (0, 0))
    parent = ("import sys, torch\n"
              "from strelka_tpu_torch.__main__ import main\n"
              "rc = main(sys.argv[1:])\n"
              "assert not torch.cuda.is_initialized()\n"
              "sys.exit(rc)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    jobs = tmp_path / "jobs"
    r = subprocess.run([sys.executable, "-c", parent, *base, "--output-dir",
                        str(jobs), "--jobs", "2"], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "built before spawning the workers" in r.stderr, r.stderr[-2000:]
    for name in _build.sources():
        assert os.path.getmtime(_build.lib_path(name)) > 0, name
    for i in (0, 1):
        log = (jobs / "workspace" / "logs" /
               f"worker.p{i}.stderr.log").read_text()
        assert "built lib" not in log, log[-2000:]
        assert "peak device memory reserved" in log, log[-2000:]
    from strelka_tpu_torch.__main__ import main
    single = str(tmp_path / "single")
    assert main([*base, "--output-dir", single]) == 0
    for name in ("variants.vcf.gz", "genome.S1.vcf.gz"):
        recs = []
        for out in (single, str(jobs)):
            with gzip.open(os.path.join(out, name), "rt") as f:
                recs.append([l for l in f if not l.startswith("#")])
        assert recs[0] == recs[1] and recs[0], name


@pytest.mark.parametrize("B,R,L,W", [(512, 128, 128, 128), (64, 32, 160, 256),
                                     (3, 40, 100, 70)])
def test_k1_highest_kernel_matches_plain(cuda, B, R, L, W):
    """mode="highest": scores within 1e-4 of the one-hot bmm (with the
    quantized LUT's deltas the f32 sums are exact), offsets equal."""
    from strelka_tpu_torch.ops import score_kernel as sk
    arrs = k1_inputs(np.random.default_rng(B + R + L + W), B, R, L, W)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = (sk.LAUNCHES, sk.LAUNCHES_HIGHEST)
    kb, ko = sk.score_best_offsets(*t, mode="highest")
    assert (sk.LAUNCHES, sk.LAUNCHES_HIGHEST) == (before[0], before[1] + 1)
    pb, po = sk.reference_best_offsets(*t)
    torch.cuda.synchronize()
    assert float((kb - pb).abs().max()) <= 1e-4
    assert torch.equal(ko, po)


K1H_SHAPES = [(512, 128, 128, 128), (256, 128, 160, 256), (256, 32, 160, 192)]


def k1h_counts():
    from strelka_tpu_torch.ops import score_kernel as sk
    return sk.LAUNCHES, sk.LAUNCHES_HIGHEST, sk.LAUNCHES_HIGHEST_SIMT


@pytest.mark.parametrize("B,R,L,W", K1H_SHAPES + [(2, 33, 99, 129),
                                                  (1, 7, 1816, 70)])
def test_k1h_tensor_cores_bit_identical_on_lut_deltas(cuda, B, R, L, W):
    """K1-h on the bf16 tensor cores, at chip_smoke.py phase 2b's shapes
    and ragged ones: with the LUT's deltas (multiples of 2^-11, partial
    sums below 2^13) the three-piece product is exact in any order, so
    scores and offsets equal the one-hot f32 bmm bit for bit."""
    from strelka_tpu_torch.ops import score_kernel as sk
    arrs = k1_inputs(np.random.default_rng(B * R + L + W), B, R, L, W)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = k1h_counts()
    kb, ko = sk.score_best_offsets(*t, mode="highest")
    assert k1h_counts() == (before[0], before[1] + 1, before[2])
    pb, po = sk.reference_best_offsets(*t)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(ko, po)


def test_k1h_unquantized_deltas_within_the_f32_bound(cuda):
    """bench.py's deltas, uniform(2, 20): the tensor cores and the bmm
    round in different orders; each score within 2 (L+1) 2^-24 (sum of
    |matching deltas| + |lnmis|) of the bmm's, offsets equal outside
    near-ties (top two within 1e-4)."""
    from strelka_tpu_torch.ops import score_kernel as sk
    B, R, L, W = K1H_SHAPES[0]
    rng = np.random.default_rng(25)
    arrs = (rng.integers(0, 5, (B, R, L)).astype(np.int8),
            rng.uniform(2, 20, (B, R, L)).astype(np.float32),
            rng.normal(-100, 10, (B, R)).astype(np.float32),
            rng.integers(0, 5, (B, L, W)).astype(np.int8))
    c, d, m, w = (torch.from_numpy(a).to(cuda) for a in arrs)
    kb, ko = sk.score_best_offsets(c, d, m, w, mode="highest")
    pb, po = sk.reference_best_offsets(c, d, m, w)
    top2 = torch.topk(sk.highest_scores(c, d, m, w), 2, dim=-1).values
    terms = torch.where((c >= 0) & (c < 4), d.abs(), 0.0).sum(-1)
    bound = 2 * (L + 1) * 2.0 ** -24 * (terms + m.abs())
    assert bool(((kb - pb).abs() <= bound).all())
    near = (top2[..., 0] - top2[..., 1]) <= 1e-4
    assert not bool(((ko != po) & ~near).any())


@pytest.mark.parametrize("L,W", [(160, 320), (128, 192), (100, 200)])
def test_k1h_ties_across_n_tile_boundaries_and_code4(cuda, L, W):
    """Exact ties on both sides of every N-tile boundary resolve to the
    first offset; reads all code 4 score exactly lnmis at offset 0."""
    from strelka_tpu_torch.ops import score_kernel as sk
    arrs, first = tile_tie_inputs(np.random.default_rng(L * W), L, W,
                                  sk.TC_N_TILE)
    arrs[0][0] = 4                      # pair 0: all code 4 under deltas
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    kb, ko = sk.score_best_offsets(*t, mode="highest")
    pb, po = sk.reference_best_offsets(*t)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(ko, po)
    assert ko[1:, 0].tolist() == first[1:]
    assert torch.equal(kb[0], t[2][0]) and not bool(ko[0].any())


@pytest.mark.parametrize("B,R,L,W", [(64, 128, 128, 128), (3, 40, 100, 70)])
def test_k1h_simt_before_number_matches_plain(cuda, B, R, L, W):
    """K1-h-s, the SIMT kernel kept as the before-number, still equals
    the plain version (exact sums on the LUT's deltas) and counts its
    own launches."""
    from strelka_tpu_torch.ops import score_kernel as sk
    arrs = k1_inputs(np.random.default_rng(B + L), B, R, L, W)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = k1h_counts()
    kb, ko = sk.score_highest_simt(*t)
    assert k1h_counts() == (before[0], before[1], before[2] + 1)
    pb, po = sk.reference_best_offsets(*t)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(ko, po)


def test_k1h_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from strelka_tpu_torch.ops import score_kernel as sk
    c, d, m, w = (torch.from_numpy(a).to(cuda)
                  for a in k1_inputs(np.random.default_rng(0), 2, 32, 64, 64))
    before = k1h_counts()
    for fn in (lambda *a: sk.score_best_offsets(*a, mode="highest"),
               sk.score_highest_simt):
        with pytest.raises(ValueError):
            fn(c.to(torch.int32), d, m, w)
        with pytest.raises(ValueError):
            fn(c, d.double(), m, w)
        with pytest.raises(ValueError):
            fn(c, d, m.cpu(), w)
        with pytest.raises(ValueError):  # window rows do not match L
            fn(c, d, m, w[:, :32].contiguous())
        with pytest.raises(ValueError):  # not contiguous
            fn(c, d, m, w.transpose(1, 2))
    assert k1h_counts() == before


def somatic_tile(rng, L, D, alt_frac):
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = rng.integers(-1, 4, (L, D)).astype(np.int8)
    base = np.where(rng.random((L, D)) < 1 - alt_frac,
                    np.minimum(ref, 3)[:, None], base).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(np.int16)
    qual = np.where(rng.random((L, D)) < 0.02, 0, qual).astype(np.int16)
    mask = rng.random((L, D)) < 0.85
    mask[10:20] = False
    return base, qual, mask, rng.random((L, D)) < 0.5, ref


SPARSE_KINDS = ("single", "binned", "dense")
BINNED_QUALS = (2, 12, 23, 37)


def sparse_tile(rng, L, D, kind):
    """A somatic pileup tile (int8 base, int16 qual, the native pileup's
    lanes) at the base qualities that runs give, with q = 0 calls (2%),
    masked lanes and all-masked rows (3-5): "single", every call at 32
    (synth.py's reads, so 1-2 live qscore slots a row); "binned", the
    binned Illumina qualities 2, 12, 23, 37; "dense", qualities 0-127
    and a few past 127 (clamped), every one of the 128 slots live in
    each row where D >= 128."""
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.8, np.minimum(ref, 3)[:, None],
                    rng.integers(-1, 4, (L, D))).astype(np.int8)
    if kind == "single":
        qual = np.full((L, D), 32)
    elif kind == "binned":
        qual = rng.choice(BINNED_QUALS, (L, D))
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


def test_somatic_snv_on_card_matches_cpu_path(cuda):
    from strelka_tpu_torch.models import somatic_snv as ss
    rng = np.random.default_rng(3)
    tiles = [somatic_tile(rng, 20_000, d, f) for d, f in ((32, 0.1),
                                                          (96, 0.3))]
    res = {}
    for dev in (cuda, torch.device("cpu")):
        lh = [ss.freq_grid_lhoods(*(torch.from_numpy(a).to(dev) for a in t))
              for t in tiles]
        res[dev.type] = ([x.cpu() for x in lh],
                         ss.somatic_snv_call_capped(*lh))
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))
        g = ss.PRESTRAND_SIZE
        assert torch.equal(a[:, :g].view(torch.int32),
                           b[:, :g].view(torch.int32))
    for f in ("qphred", "from_ntype_qphred", "ntype", "max_gt",
              "nonsomatic_qphred"):
        assert torch.equal(getattr(res["cuda"][1], f).cpu(),
                           getattr(res["cpu"][1], f)), f


def test_somatic_cli_cuda_matches_cpu(cuda, tmp_path):
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.__main__ import main
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.ops import score_kernel as sk
    common = dict(L=60_000, snv_every=900, indel_every=1200, ref_seed=11)
    refs, normal, _ = synth.generate(depth=25, seed=21, **common)
    _, tumor, _ = synth.generate(depth=50, seed=22, somatic_every=1500,
                                 somatic_vaf=0.35, somatic_indel_every=2100,
                                 **common)
    fa = tmp_path / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    hdr = BamHeader(text="", ref_names=["syn"], ref_lengths=[len(refs)])
    nbam, tbam = str(tmp_path / "n.bam"), str(tmp_path / "t.bam")
    write_bam(nbam, hdr, normal)
    write_bam(tbam, hdr, tumor)
    before = sk.LAUNCHES
    ss.LAUNCH_STATS.clear()
    outs = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / dev)
        assert main(["somatic", "--reference", str(fa),
                     "--normal-align-file", nbam, "--tumor-align-file", tbam,
                     "--output-dir", out, "--device", dev]) == 0
        outs[dev] = out
    assert sk.LAUNCHES > before
    assert any(k[1] == "cuda" for k in ss.LAUNCH_STATS)
    for name in ("somatic.snvs.vcf.gz", "somatic.indels.vcf.gz"):
        recs = []
        for dev in ("cuda", "cpu"):
            with gzip.open(os.path.join(outs[dev], name), "rt") as f:
                recs.append([l for l in f if not l.startswith("#")])
        assert recs[0] == recs[1], name
        assert recs[0], name


# --- the K1-x kernels (ops/score_variants.py) -------------------------------

KX_KINDS = tuple(sv.KERNELS)   # the K1-x kernels, their SIMT ones, K1-s


@pytest.mark.parametrize("kind", KX_KINDS)
@pytest.mark.parametrize("B,R,L,W", [(16, 128, 160, 256), (3, 40, 100, 70)])
def test_kx_kernel_bit_identical_to_plain(cuda, kind, B, R, L, W):
    """Each K1-x kernel (ops/score_variants.KERNELS) equals its plain
    version bit for bit, with pair 0's reads all code 4 under non-zero
    deltas (K1's functions then score exactly lnmis there)."""
    k = sv.KERNELS[kind]
    Wt = 2 * W if kind in sv.HAP_KINDS else W
    arrs = k1_inputs(np.random.default_rng(B + R + L + W), B, R, L, Wt)
    arrs[0][0] = 4                      # pair 0: all code 4 under deltas
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    args = k.prepare(t, 2)
    before = getattr(sv, k.counter)
    got = k.call(*args)
    assert getattr(sv, k.counter) == before + 1
    want = k.plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if kind not in ("noA", "nodot", "noA_simt", "nodot_simt"):
        assert torch.equal(got[0][0].reshape(R, -1)[:, 0], t[2][0])


def packed_counts():
    return (sv.LAUNCHES_PACKED, sv.LAUNCHES_PACKED_FOLD,
            sv.LAUNCHES_PACKED_SIMT, sv.LAUNCHES_PACKED_FOLD_SIMT)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("B,R,L,W", [(512, 128, 128, 128), (256, 128, 160, 256),
                                     (3, 40, 100, 70), (2, 33, 99, 129),
                                     (2, 7, 1816, 70)])
def test_kxp_tensor_cores_bit_identical_to_plain(cuda, fold, B, R, L, W):
    """KX-P on K1's u8 tensor-core pipeline, lnmis beside or folded into
    ceil(R/L) extra rows, equals packed_best_offsets bit for bit, codes
    5-7 in the low bits (they match nothing) and ragged L and W
    included; it counts its own launches, the SIMT ones none."""
    arrs = k1_inputs(np.random.default_rng(B + R + L + W + fold), B, R, L, W)
    c, d, m, w = (torch.from_numpy(a).to(cuda) for a in arrs)
    p = sv.pack_operands(c, d, m, fold_lnmis=fold)
    p[:, :R] = torch.where(p[:, :R] & 7 == 4,
                           p[:, :R] | (p[:, :R] >> 3) % 4 + 4, p[:, :R])
    assert bool(((p[:, :R] & 7) > 4).any())
    before = packed_counts()
    got = sv.score_packed(p, None if fold else m, w, n_reads=R)
    want = sv.packed_best_offsets(p, None if fold else m, w, n_reads=R)
    assert packed_counts() == tuple(
        n + (i == int(fold)) for i, n in enumerate(before))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(sv.unpack_best_offsets(got)[0],
                       sk_exact(c, d, m, w)[0])


def onesum_counts():
    return sv.LAUNCHES_ONESUM, sv.LAUNCHES_ONESUM_SIMT


def hap_counts():
    return sv.LAUNCHES_HAP, sv.LAUNCHES_HAP_SIMT


@pytest.mark.parametrize("B,R,L,W", [(512, 128, 128, 128), (256, 128, 160, 256),
                                     (3, 40, 100, 70), (2, 33, 99, 129),
                                     (2, 7, 256, 70), (4, 64, 32, 64)])
def test_kxk_tensor_cores_bit_identical_to_plain(cuda, B, R, L, W):
    """KX-K on K1-h's bf16 pipeline equals onesum_best_offsets and K1's
    function bit for bit, negative and unquantized deltas and code 4
    under non-zero deltas included; it counts its own launches, the
    SIMT one none."""
    rng = np.random.default_rng(B + R + L + W)
    arrs = k1_inputs(rng, B, R, L, W)
    arrs[1][0] = -arrs[1][0]                        # negative deltas
    arrs[1][-1] = rng.uniform(-20, 20, arrs[1][-1].shape)   # unquantized
    c, d, m, w = t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = onesum_counts()
    got = sv.score_onesum(*t)
    assert onesum_counts() == (before[0] + 1, before[1])
    want = sv.onesum_best_offsets(*t)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(got, sk_exact(*t)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_kxk_largest_sum_at_L256(cuda):
    """L = 256 with every base of every read matching at the even
    offsets and v = d_int & 0xFFFF = 0xFFFF (delta 65535 * 2^-11, and
    -2^-11 in odd pairs): S = 16,776,960 < 2^24 through the tensor
    cores' f32 accumulation, exactly."""
    B, R, L, W = 4, 64, 256, 128
    rng = np.random.default_rng(256)
    codes = np.zeros((B, R, L), np.int8)
    delta = np.where(np.arange(B)[:, None, None] % 2 == 0,
                     np.float32(65535 / 2048), np.float32(-1 / 2048))
    delta = np.broadcast_to(delta, (B, R, L)).astype(np.float32)
    lnmis = rng.normal(-100, 10, (B, R)).astype(np.float32)
    win = np.zeros((B, L, W), np.int8)
    win[:, :, 1::2] = rng.integers(1, 5, (B, L, W // 2))
    t = [torch.from_numpy(a).to(cuda) for a in (codes, delta, lnmis, win)]
    best, off = sv.score_onesum(*t)
    want = sv.onesum_best_offsets(*t)
    torch.cuda.synchronize()
    assert torch.equal(best.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(off, want[1])
    assert bool((off == 0).all())
    S = torch.tensor(65535 * L * 2.0 ** -11, dtype=torch.float32)
    assert torch.equal(best.cpu(), S + t[2].cpu())


@pytest.mark.parametrize("H,B,R,L,W", [
    (2, 256, 128, 128, 128), (2, 128, 128, 160, 256),   # the harness's
    (1, 64, 128, 160, 256), (3, 3, 40, 100, 70), (2, 4, 33, 99, 96),
    (3, 4, 64, 160, 160), (1, 2, 7, 1816, 64), (2, 2, 200, 1000, 96)])
def test_kxh_tensor_cores_bit_identical_to_plain(cuda, H, B, R, L, W):
    """KX-H on K1's u8 pipeline, B loci against H windows of W, equals
    hap_best_offsets (K1's function on each window's slice) bit for bit,
    ragged L and W, windows that are not 16-byte aligned and reads too
    long for A to stay resident included; it counts its own launches,
    the SIMT one none."""
    arrs = k1_inputs(np.random.default_rng(B + R + L + W + H), B, R, L, H * W)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = hap_counts()
    got = sv.score_hap(*t, H)
    assert hap_counts() == (before[0] + 1, before[1])
    want = sv.hap_best_offsets(*t, H)
    torch.cuda.synchronize()
    assert got[0].shape == (B, R, H) and got[1].dtype == torch.int32
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("H", [2, 3])
@pytest.mark.parametrize("W", [96, 128, 160])
def test_kxh_ties_at_window_boundaries(cuda, H, W):
    """Every read of a pair carries one sequence, found exactly at the
    last offset of window h and the first of window h+1 (and at window
    0's first N-tile boundary in odd pairs): each window keeps its own
    first max."""
    rng = np.random.default_rng(W + H)
    B, R, L = 4, 40, 128
    codes, delta, lnmis, win = k1_inputs(rng, B, R, L, H * W)
    win[win == 4] = 0
    for b in range(B):
        read = rng.integers(0, 4, L)
        codes[b] = read
        cols = [c for h in range(1, H) for c in (h * W - 1, h * W)]
        if b % 2 and W > 64:
            cols += [63, 64]
        for w in cols:
            win[b, :, w] = read
    t = [torch.from_numpy(a).to(cuda) for a in (codes, delta, lnmis, win)]
    best, off = sv.score_hap(*t, H)
    want = sv.hap_best_offsets(*t, H)
    torch.cuda.synchronize()
    assert torch.equal(best.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(off, want[1])
    first = torch.tensor([63 if b % 2 and W > 64 else W - 1
                          for b in range(B)], device=cuda, dtype=torch.int32)
    assert torch.equal(off[..., 0], first[:, None].expand(B, R))
    assert bool((off[..., 1:] == 0).all())


def kxa_counts(which):
    return (getattr(sv, f"LAUNCHES_{which.upper()}"),
            getattr(sv, f"LAUNCHES_{which.upper()}_SIMT"))


@pytest.mark.parametrize("which", ["noA", "nodot"])
@pytest.mark.parametrize("B,R,L,W", [(512, 128, 128, 128), (256, 128, 160, 256),
                                     (8, 128, 224, 256), (3, 40, 100, 70),
                                     (2, 33, 99, 129), (4, 128, 32, 128),
                                     (2, 256, 64, 256)])
def test_kxa_tensor_cores_bit_identical_to_plain(cuda, which, B, R, L, W):
    """noA and nodot on K1's u8 pipeline equal their plain versions bit
    for bit: the harness's and the main path's shapes, L = 224 (A in
    the ring at R = 128), ragged shapes, R = W = 4L, codes 4 and below
    0 under non-zero deltas; each counts its own launches, its SIMT
    before-number none."""
    rng = np.random.default_rng(B + R + L + W)
    arrs = k1_inputs(rng, B, R, L, W)
    arrs[0][0] = 4
    arrs[0][-1, :, ::3] = -1
    arrs[3][-1, ::5] = -1
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = kxa_counts(which)
    got = sv.score_ablation(which, *t)
    assert kxa_counts(which) == (before[0] + 1, before[1])
    want = sv.ablation_best_offsets(which, *t)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if L <= sv._lib().score_variants_max_len():
        simt = sv.score_ablation_simt(which, *t)
        assert kxa_counts(which) == (before[0] + 1, before[1] + 1)
        for a, b in zip(simt, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_kxa_noa_beyond_the_simt_kernels_length(cuda):
    """noA on K1's pipeline takes K1's read lengths (1816), past the
    SIMT kernel's 907."""
    assert sv._tc_lib().score_best_offsets_tc_max_len() == 1816
    t = [torch.from_numpy(a).to(cuda)
         for a in k1_inputs(np.random.default_rng(1000), 2, 64, 1000, 128)]
    got = sv.score_ablation("noA", *t)
    want = sv.noa_best_offsets(*t)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError, match="outside the kernel's range"):
        sv.score_ablation_simt("noA", *t)


@pytest.mark.parametrize("W", [128, 192, 256])
def test_kxa_nodot_ties_across_n_tiles(cuda, W):
    """nodot with an A slab of 0 (limb 1 = 0) and read r's Wo row 1 at
    two offsets around an N-tile boundary: the first of them wins."""
    rng = np.random.default_rng(W)
    B, R, L = 4, 128, 128
    cols = [(t + a, t + b) for t in range(64, W, 64)
            for a, b in ((-1, 0), (-2, -1), (0, 1), (-1, 64)) if t + b < W]
    codes = rng.integers(-1, 5, (B, R, L)).astype(np.int8)
    delta = (rng.integers(0, 256, (B, R, L)) / 2048).astype(np.float32)
    lnmis = rng.normal(-100, 10, (B, R)).astype(np.float32)
    win = rng.integers(1, 5, (B, L, W)).astype(np.int8)
    for r in range(R):
        for w in cols[r % len(cols)]:
            win[:, r, w] = 0
    t = [torch.from_numpy(a).to(cuda) for a in (codes, delta, lnmis, win)]
    best, off = sv.score_ablation("nodot", *t)
    want = sv.nodot_best_offsets(*t)
    torch.cuda.synchronize()
    assert torch.equal(best.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(off, want[1])
    first = torch.tensor([cols[r % len(cols)][0] for r in range(R)],
                         dtype=torch.int32, device=cuda)
    assert torch.equal(off, first.expand(B, R))


# noW's plan at each shape (sv.now_slab_bytes against 232,448 bytes)
NOW_PLANS = {(512, 128, 128, 128): "S", (256, 32, 160, 192): "S",
             (256, 128, 160, 256): "R", (256, 128, 128, 192): "R"}


@pytest.mark.parametrize("which", ["noW", "nomax"])
@pytest.mark.parametrize("B,R,L,W,plan", [
    (512, 128, 128, 128, "S"), (256, 128, 160, 256, "R"),   # both shapes
    (256, 32, 160, 192, "S"), (8, 128, 224, 256, "R"),      # A in the ring
    (2, 64, 1000, 128, "R"),          # beyond the SIMT kernel's 907
    (10, 128, 128, 128, "S"), (10, 128, 160, 256, "R"),     # B % 4 = 2
    (3, 40, 100, 70, "S"), (6, 33, 99, 129, "S")])
def test_kxa_now_nomax_tensor_cores_bit_identical_to_plain(cuda, which, B,
                                                           R, L, W, plan):
    """noW (G = 4, in the plan the shape gets) and nomax on K1's u8
    pipeline equal their plain versions bit for bit: both shapes, both
    plans, a partial last group, L = 224 and L = 1000, ragged shapes,
    codes 4 and below 0 under non-zero deltas; each counts its own
    launches, its SIMT before-number none; nomax's best is K1's."""
    rng = np.random.default_rng(B + R + L + W + len(which))
    arrs = k1_inputs(rng, B, R, L, W)
    arrs[0][0] = 4
    arrs[0][-1, :, ::3] = -1
    arrs[3][-1, ::5] = -1
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    if which == "noW":
        assert sv.now_plan(B, R, L, W, 4, cuda) == plan
    before = kxa_counts(which)
    got = sv.score_ablation(which, *t, G=4)
    assert kxa_counts(which) == (before[0] + 1, before[1])
    want = sv.ablation_best_offsets(which, *t, G=4)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if which == "nomax":
        k1 = sk_exact(*t)[0]
        assert torch.equal(got[0].view(torch.int32), k1.view(torch.int32))
        assert bool((got[1] == 0).all())
    if L <= sv._lib().score_variants_max_len():
        simt = sv.score_ablation_simt(which, *t, G=4)
        assert kxa_counts(which) == (before[0] + 1, before[1] + 1)
        for a, b in zip(simt, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    else:
        with pytest.raises(ValueError, match="outside the kernel's range"):
            sv.score_ablation_simt(which, *t, G=4)


def test_kxa_now_plan_query_gives_the_tables_answers(cuda):
    """The kernel library's plan (score_now_tc_plan) is S where the
    slab fits beside K1's resident A and R elsewhere, the table's answer
    at its shapes and the Python rule's at every shape, whatever G; it
    refuses what the launch refuses."""
    for (B, R, L, W), plan in NOW_PLANS.items():
        for G in (1, 4, B, 2 * B):
            assert sv.now_plan(B, R, L, W, G, cuda) == plan
    for R in (1, 32, 33, 96, 128, 512):
        for L in (1, 32, 100, 128, 160, 224, 1000, 1816):
            for W in (1, 64, 128, 192, 256, 320):
                assert (sv.now_plan(8, R, L, W, 4, cuda)
                        == sv.now_plan(8, R, L, W, 4)), (R, L, W)
    lib = sv._tc_lib()
    assert lib.score_now_tc_plan(8, 32, 1817, 64, 4) == -1
    assert lib.score_now_tc_plan(65536, 32, 128, 64, 4) == -1
    assert lib.score_now_tc_plan(8, 32, 128, 64, 0) == -1


@pytest.mark.parametrize("W", [128, 192, 256])
def test_kxa_nomax_ties_across_n_tiles(cuda, W):
    """Each pair's reads carry one sequence found exactly at two offsets
    around an N-tile boundary: K1 takes the first, nomax keeps K1's best
    bits and offset 0."""
    rng = np.random.default_rng(W + 1)
    B, R, L = 8, 128, 128
    cols = [(t + a, t + b) for t in range(64, W, 64)
            for a, b in ((-1, 0), (-2, -1), (0, 1), (-1, 64)) if t + b < W]
    codes, delta, lnmis, win = k1_inputs(rng, B, R, L, W)
    reads = rng.integers(0, 4, (B, L))
    codes[:] = reads[:, None]
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b in range(B):
        for w in cols[b % len(cols)]:
            win[b, :, w] = reads[b]
    t = [torch.from_numpy(a).to(cuda) for a in (codes, delta, lnmis, win)]
    best, off = sv.score_ablation("nomax", *t)
    k1_best, k1_off = sk_exact(*t)
    torch.cuda.synchronize()
    first = torch.tensor([cols[b % len(cols)][0] for b in range(B)],
                         dtype=torch.int32, device=cuda)
    assert torch.equal(k1_off, first[:, None].expand(B, R))
    assert torch.equal(best.view(torch.int32), k1_best.view(torch.int32))
    assert bool((off == 0).all())


def int8_counts():
    return sv.LAUNCHES_INT8, sv.LAUNCHES_INT8_MMA


def limb_edge_inputs(rng, B, R, L, W):
    """Deltas whose two limbs are each one of 126, 127, 128 and 255, a
    quarter of them negative, codes -1..4, windows -1..4."""
    edge = np.array([126, 127, 128, 255])
    d = (edge[rng.integers(0, 4, (B, R, L))] * 256
         + edge[rng.integers(0, 4, (B, R, L))])
    d = np.where(rng.random((B, R, L)) < 0.25, -d, d)
    return (rng.integers(-1, 5, (B, R, L)).astype(np.int8),
            (d / 2048).astype(np.float32),
            rng.normal(-80, 10, (B, R)).astype(np.float32),
            rng.integers(-1, 5, (B, L, W)).astype(np.int8))


@pytest.mark.parametrize("make", ["random", "limbs"])
@pytest.mark.parametrize("B,R,L,W", [(512, 128, 128, 128), (256, 128, 160, 256),
                                     (256, 32, 160, 192), (8, 128, 224, 256),
                                     (3, 40, 100, 70), (2, 33, 99, 129),
                                     (2, 64, 1000, 128)])
def test_kxi_tensor_cores_bit_identical_to_plain(cuda, make, B, R, L, W):
    """KX-I on K1's u8 pipeline (<kClamped, kBestOff>) equals
    int8_best_offsets bit for bit: the harness's and the main path's
    shapes, L = 224 (A in the ring), ragged shapes, L = 1000 (past the
    mma.sync kernel's length); LUT deltas with codes 4 and -1, or limbs
    at 126, 127, 128 and 255 with negative deltas. It counts its own
    launches, its mma.sync before-number none; the before-number equals
    the plain version too where it takes the shape."""
    rng = np.random.default_rng(B + R + L + W)
    if make == "random":
        arrs = k1_inputs(rng, B, R, L, W)
        arrs[0][0] = 4
        arrs[0][-1, :, ::3] = -1
    else:
        arrs = limb_edge_inputs(rng, B, R, L, W)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = int8_counts()
    got = sv.score_int8(*t)
    assert int8_counts() == (before[0] + 1, before[1])
    want = sv.int8_best_offsets(*t)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if L <= sv._lib().score_variants_max_len():
        mma = sv.score_int8_mma(*t)
        assert int8_counts() == (before[0] + 1, before[1] + 1)
        for a, b in zip(mma, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("W", [128, 192, 256])
def test_kxi_ties_across_n_tiles(cuda, W):
    """Each pair's reads carry one sequence found exactly at two offsets
    around an N-tile boundary: KX-I takes the first, as its plain
    version does."""
    rng = np.random.default_rng(W + 2)
    B, R, L = 8, 128, 128
    cols = [(t + a, t + b) for t in range(64, W, 64)
            for a, b in ((-1, 0), (-2, -1), (0, 1), (-1, 64)) if t + b < W]
    codes, delta, lnmis, win = k1_inputs(rng, B, R, L, W)
    reads = rng.integers(0, 4, (B, L))
    codes[:] = reads[:, None]
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b in range(B):
        for w in cols[b % len(cols)]:
            win[b, :, w] = reads[b]
    t = [torch.from_numpy(a).to(cuda) for a in (codes, delta, lnmis, win)]
    best, off = sv.score_int8(*t)
    want = sv.int8_best_offsets(*t)
    torch.cuda.synchronize()
    first = torch.tensor([cols[b % len(cols)][0] for b in range(B)],
                         dtype=torch.int32, device=cuda)
    assert torch.equal(off, first[:, None].expand(B, R))
    assert torch.equal(best.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(off, want[1])


@pytest.mark.parametrize("G", [1, 3, 4, 6, 8])
@pytest.mark.parametrize("R,L,W", [(128, 128, 128), (128, 160, 256)])
def test_kxa_now_groups_of_every_size(cuda, G, R, L, W):
    """B = 6 in groups of G, in plan S (128,128,128) and plan R
    (128,160,256): a partial last group (G = 4), G = 1 (K1's result),
    G = 3, G >= B (one group) all equal now_best_offsets."""
    B = 6
    t = [torch.from_numpy(a).to(cuda) for a in k1_inputs(
        np.random.default_rng(G + L), B, R, L, W)]
    got = sv.score_ablation("noW", *t, G=G)
    want = sv.now_best_offsets(*t, G)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if G == 1:
        for a, b in zip(got, sk_exact(*t)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_kxa_wrappers_reject_what_the_kernels_do_not_take(cuda):
    c, d, m, w = (torch.from_numpy(a).to(cuda)
                  for a in k1_inputs(np.random.default_rng(3), 2, 32, 64, 64))
    before = [kxa_counts(w) for w in sv.TC_ABLATIONS]
    for fn in (sv.score_ablation, sv.score_ablation_simt):
        for which in sv.TC_ABLATIONS:
            with pytest.raises(ValueError):
                fn(which, c.to(torch.int32), d, m, w)
            with pytest.raises(ValueError):  # not contiguous
                fn(which, c, d, m, w.transpose(1, 2))
            with pytest.raises(ValueError):
                fn(which, c, d.cpu(), m, w)
        with pytest.raises(ValueError, match="4L"):
            fn("nodot", c, d, m, torch.zeros((2, 64, 257), dtype=torch.int8,
                                             device=cuda))
    long = [torch.zeros(s, dtype=dt, device=cuda) for s, dt in (
        ((1, 2, 1817), torch.int8), ((1, 2, 1817), torch.float32),
        ((1, 2), torch.float32), ((1, 1817, 8), torch.int8))]
    with pytest.raises(ValueError, match="L <= 1816"):
        sv.score_ablation("noA", *long)
    for fn in (sv.score_ablation, sv.score_ablation_simt):
        with pytest.raises(ValueError, match="G must be at least 1"):
            fn("noW", c, d, m, w, G=0)
    assert [kxa_counts(w) for w in sv.TC_ABLATIONS] == before


def test_kxk_kxh_wrappers_reject_what_the_kernels_do_not_take(cuda):
    c, d, m, w = (torch.from_numpy(a).to(cuda)
                  for a in k1_inputs(np.random.default_rng(2), 2, 32, 64, 128))
    assert (sv._highest_lib().score_onesum_tc_max_len()
            == sv._lib().score_onesum_max_len() == sv.ONESUM_MAX_LEN)
    before = onesum_counts() + hap_counts()
    long = [torch.zeros(s, dtype=dt, device=cuda) for s, dt in (
        ((1, 2, 257), torch.int8), ((1, 2, 257), torch.float32),
        ((1, 2), torch.float32), ((1, 257, 8), torch.int8))]
    for fn in (sv.score_onesum, sv.score_onesum_simt):
        with pytest.raises(ValueError, match="L <= 256"):
            fn(*long)
    for fn in (sv.score_hap, sv.score_hap_simt):
        with pytest.raises(ValueError, match="multiple of n_haps"):
            fn(c, d, m, w[..., :127].contiguous(), 2)
        with pytest.raises(ValueError, match="multiple of n_haps"):
            fn(c, d, m, w, 0)
    for fn in (sv.score_onesum, lambda *a: sv.score_hap(*a, 2)):
        with pytest.raises(ValueError):
            fn(c, d.double(), m, w)
        with pytest.raises(ValueError):
            fn(c.to(torch.int32), d, m, w)
        with pytest.raises(ValueError):  # not contiguous
            fn(c, d, m, w.transpose(1, 2).contiguous().transpose(1, 2))
        with pytest.raises(ValueError):  # not contiguous
            fn(c[:, :, ::2], d[:, :, ::2], m, w[:, ::2])
    assert onesum_counts() + hap_counts() == before


def sk_exact(*t):
    from strelka_tpu_torch.ops import score_kernel as sk
    return sk.exact_best_offsets(*t)


def test_kx_wrappers_reject_what_the_kernels_do_not_take(cuda):
    c, d, m, w = (torch.from_numpy(a).to(cuda)
                  for a in k1_inputs(np.random.default_rng(1), 2, 32, 64, 64))
    for fn in (sv.score_onesum, sv.score_int8,
               lambda *a: sv.score_hap(*a, 2),
               lambda *a: sv.score_ablation("noW", *a, G=2)):
        with pytest.raises(ValueError):
            fn(c.to(torch.int32), d, m, w)
        with pytest.raises(ValueError):  # not contiguous
            fn(c, d, m, w.transpose(1, 2))
        with pytest.raises(ValueError):
            fn(c, d.cpu(), m, w)
    p = sv.pack_operands(c, d, m)
    before = packed_counts()
    for fn in (sv.score_packed, sv.score_packed_simt):
        with pytest.raises(ValueError):
            fn(p.to(torch.int64), m, w)
        with pytest.raises(ValueError):
            fn(p[:, :, ::2], m, w[:, ::2])
        with pytest.raises(ValueError):
            fn(p, m.cpu(), w)
        with pytest.raises(ValueError):  # window rows do not match L
            fn(p, m, w[:, :32].contiguous())
        with pytest.raises(ValueError):  # folded rows need the read count
            fn(sv.pack_operands(c, d, m, fold_lnmis=True), None, w)
    assert packed_counts() == before
    with pytest.raises(ValueError):
        sv.score_onesum(*(torch.zeros(s, dtype=dt, device=cuda) for s, dt in (
            ((1, 2, 257), torch.int8), ((1, 2, 257), torch.float32),
            ((1, 2), torch.float32), ((1, 257, 8), torch.int8))))
    with pytest.raises(ValueError, match="4L"):
        sv.score_ablation("nodot", c, d, m,
                          torch.zeros((2, 64, 257), dtype=torch.int8,
                                      device=cuda))


def test_kx_runner_on_card_is_exact(cuda, capsys):
    """K1's function and hap2 are exact against the harness's oracle;
    every variant, int8 and the ablations included, equals its body's
    own function."""
    names = ["base", "fused", "fusedin", "fusedlm", "limb2k", "hap2",
             "int8", "limb2-noA", "limb2-noW", "limb2-nomax", "limb2-nodot"]
    before = packed_counts()
    before_kh = onesum_counts() + hap_counts()
    before_a = [kxa_counts(w) for w in sv.TC_ABLATIONS]
    before_i = int8_counts()
    assert sv.main([*names, "--B", "64", "--R", "128"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(names)
    assert all("body_exact=True" in l for l in lines)
    assert all(" exact=True" in l for l in lines[:6])
    # fused and fusedin reach KX-P on the tensor cores, fusedlm its
    # folded form; the SIMT kernels are on no path
    after = packed_counts()
    assert after[0] > before[0] and after[1] > before[1]
    assert after[2:] == before[2:]
    # limb2k reaches KX-K on K1-h's pipeline and hap2 KX-H on K1's
    after_kh = onesum_counts() + hap_counts()
    assert after_kh[0] > before_kh[0] and after_kh[2] > before_kh[2]
    assert (after_kh[1], after_kh[3]) == (before_kh[1], before_kh[3])
    assert "kernel=score_highest_tc_kernel<kOneSum>" in lines[4]
    assert ("kernel=score_best_offsets_tc_kernel<kStandard, kHapOut>"
            in lines[5])
    # the four ablations reach K1's pipeline, their SIMT kernels are on
    # no path; limb2-noW takes plan S at the harness's L and W
    after_a = [kxa_counts(w) for w in sv.TC_ABLATIONS]
    for (tc, simt), (tc0, simt0) in zip(after_a, before_a):
        assert tc > tc0 and simt == simt0
    assert "kernel=score_best_offsets_tc_kernel<kUnmasked, kBestOff>" in (
        lines[7])
    assert ("kernel=score_best_offsets_tc_kernel<kStandard, kBestOff, "
            "kProduct, kGroupSlab | kGroupRing> plan=S") in lines[8]
    assert ("kernel=score_best_offsets_tc_kernel<kStandard, kBestOnly>"
            in lines[9])
    # int8 reaches KX-I on K1's pipeline, its mma.sync kernel no path
    after_i = int8_counts()
    assert after_i[0] > before_i[0] and after_i[1] == before_i[1]
    assert ("kernel=score_best_offsets_tc_kernel<kClamped, kBestOff>"
            in lines[6])


# --- the error-model fits (error estimation and tools) on the card ------

# tests/test_torch_error_fit.py's bounds: FLAT_RTOL where the fit keeps
# its least-loss step (an ulp can pick another among tied steps),
# FIT_RTOL (tests/test_torch_error_zoo.py) where it keeps its last
FLAT_RTOL = 1e-6
FIT_RTOL = 1e-10


def indel_counts(seed, n, depth, rate, noisy):
    """(ref, alt[6]) of n loci at `depth` reads (or a (lo, hi) range of
    depths drawn a locus): noisy ones with indel errors at `rate`, a few
    het indels; deduplicated by the port's error_fit."""
    from strelka_tpu_torch.models import error_fit as ef
    rng = np.random.default_rng(seed)
    if not np.isscalar(depth):
        depth = rng.integers(*depth, n)
    e = np.where(rng.random(n) < noisy, rate, 1e-8)
    ins, dels = rng.binomial(depth, e), rng.binomial(depth, e)
    het = rng.random(n) < 0.002
    ins = np.where(het, rng.binomial(depth, 0.5, n), ins)
    alt = np.zeros((n, 6), np.int64)
    alt[:, 0], alt[:, 3] = ins, np.where(het, 0, dels)
    return ef.dedupe_counts(depth - alt.sum(axis=1), alt)


def test_special_fma_and_adam_on_card_match_cpu(cuda):
    """The emulated f64 FMA and the Adam step give the CPU's bits on the
    card (each torch op is its own kernel, so nothing contracts)."""
    from strelka_tpu_torch.utils import special as sp
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=50_000) * np.exp(rng.normal(0, 10, 50_000))
               for _ in range(3))
    c[:10_000] = -(a[:10_000] * b[:10_000])
    args = [torch.from_numpy(x) for x in (a, b, c)]
    assert torch.equal(sp.fma(*(x.to(cuda) for x in args)).cpu(),
                       sp.fma(*args))
    G = rng.normal(0, 1, (600, 5)) * np.exp(rng.normal(0, 3, (600, 5)))
    p0 = torch.from_numpy(rng.normal(size=5))
    pc, pg = p0.clone(), p0.to(cuda)
    ac, ag = sp.Adam(pc, 0.05), sp.Adam(pg, 0.05)
    for g in G:
        pc = ac.step(pc, torch.from_numpy(g))
        pg = ag.step(pg, torch.from_numpy(g).to(cuda))
    assert torch.equal(pg.cpu(), pc)


@pytest.mark.parametrize("seed,rate,noisy", [(0, 5e-3, 1.0), (1, 2e-2, 0.3)])
def test_fit_context_on_card_matches_cpu(cuda, seed, rate, noisy):
    from strelka_tpu_torch.models import error_fit as ef
    cc = indel_counts(seed, 3000, 35, rate, noisy)
    want = ef.fit_context(cc, float(np.log(0.001)), device="cpu")
    got = ef.fit_context(cc, float(np.log(0.001)), device=cuda)
    assert (got.acceptable, got.n_instances) == (want.acceptable,
                                                 want.n_instances)
    for f in ("log_error_rate", "log_noisy_locus_rate", "log_insert_rate",
              "log_delete_rate"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=FLAT_RTOL, abs=0), f


# KE-F (csrc/error_fit_step.cu) against its plain step on the card, with
# tests/test_torch_error_fit.py's bounds: the loss within KEF_LOSS_RTOL
# and the gradient within KEF_GRAD_RTOL of its largest component or
# 2 eps N times its terms' scale (the sums over loci run in another
# order), Adam bit for bit given the kernel's gradient, and the kernel
# bit for bit with ops/fit_kernels' torch model of its order on the card
KEF_LOSS_RTOL = 1e-14
KEF_GRAD_RTOL = 1e-12
KEF_LOSS_AT_FIT_RTOL = 1e-12


# fit_kernels.synthetic_counts: over 50,000 patterns, one locus a thread;
# over 100,000, two a thread; 4,050 patterns, a cluster of 16 blocks; and
# 305,159, past what the card holds on chip (the global regime)
KEF_CASES = {
    "smoke_size": lambda: indel_counts(1, 3000, 35, 2e-2, 0.3),
    "flat": lambda: indel_counts(3, 3000, 35, 1e-4, 1.0),
    "cluster_16": lambda: fit_kernels.synthetic_counts(9, 4500, 60),
    "patterns_50k": lambda: fit_kernels.synthetic_counts(9, 60_000, 300),
    "patterns_100k": lambda: fit_kernels.synthetic_counts(9, 130_000, 500),
    "past_on_chip": lambda: fit_kernels.synthetic_counts(9, 360_000, 2000)}


def kef_inputs(cuda, cc, lt):
    from strelka_tpu_torch.models import error_fit as ef
    obs = [torch.as_tensor(np.asarray(a, np.float64), device=cuda)
           for a in (cc.ref_obs, cc.alt_obs, cc.instance_count)]
    return obs, ef.kernel_consts(lt, 0.05)


def same(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    return a.shape == b.shape and torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))


def kef_p0(cuda):
    return torch.tensor([np.log(1e-3), np.log(1e-3), np.log(0.5)],
                        dtype=torch.float64, device=cuda)


@pytest.mark.parametrize("case", list(KEF_CASES))
def test_kef_step_matches_plain_step_and_model(cuda, case):
    """KE-F's prep bit for bit with fit_prep_plain; a one-step fit of its
    fit entry: the loss and gradient against fit_step_plain's, its Adam
    state bit for bit with special.Adam's given its gradient, and all of
    it bit for bit with fit_step_model and adam_model on the card on the
    entry's grid; one launch each."""
    from strelka_tpu_torch.models import error_fit as ef
    from strelka_tpu_torch.ops import fit_kernels as fk
    from strelka_tpu_torch.utils import special as sp
    cc = KEF_CASES[case]()
    lt = float(np.log(0.001))
    obs, c = kef_inputs(cuda, cc, lt)
    fk.reset()
    loc = fk.error_fit_prep(*obs, c)
    assert same(loc, ef.fit_prep_plain(*obs, lt))
    p0 = kef_p0(cuda)
    run = fk.error_fit_run(*obs, p0, c, 1)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {"error_fit_prep": 1, "error_fit_run": 1}
    n = loc.shape[1]
    assert run.grid == fk.fit_grid(n, fk.resident_blocks(cuda))
    assert (run.grid[2] == "global") == (case == "past_on_chip")
    st = run.state.cpu()
    opt = sp.Adam(p0, 0.05)
    _, v, g = ef.fit_step_plain(p0, opt, lt, *obs)
    assert float(st[fk.V]) == pytest.approx(float(v), rel=KEF_LOSS_RTOL,
                                            abs=0)
    model = fk.fit_step_model(loc, p0, c, run.grid[:2])
    scale = model["scale"].cpu().numpy()
    g = g.cpu().numpy()
    bound = np.maximum(KEF_GRAD_RTOL * np.abs(g).max(),
                       2 * np.finfo(np.float64).eps * n * scale)
    assert np.all(np.abs(st[fk.GRAD].numpy() - g) <= bound)
    gk = st[fk.GRAD].to(cuda)
    ref_opt = sp.Adam(p0, 0.05)
    p1 = ref_opt.step(p0, gk)
    assert same(st[fk.PARAMS], p1) and same(st[fk.MU], ref_opt.mu)
    assert same(st[fk.NU], ref_opt.nu)
    assert same(st[fk.BEST_PARAMS], p1) and st[fk.BEST_V] == st[fk.V]
    # the model of the kernel's order gives its bits
    assert same(st[fk.V], model["v"]) and same(st[fk.GRAD], model["g"])
    pm, mu, nu = fk.adam_model(p0, torch.zeros_like(p0), torch.zeros_like(p0),
                               model["g"], 1, c)
    assert same(st[fk.PARAMS], pm) and same(st[fk.MU], mu)
    assert fk.PLAIN_ON_CUDA["error_fit_step"] == 1   # the plain step above


@pytest.mark.parametrize("case", list(KEF_CASES))
def test_kef_fit_matches_plain_fit_on_card(cuda, case):
    """fit_context on the card through KE-F (one launch of its fit entry,
    no prep launch, no plain step) against the plain step's fit on the
    card: the rates within FLAT_RTOL and the plain loss at both fits'
    rates within KEF_LOSS_AT_FIT_RTOL; a second run gives the same
    bits."""
    from strelka_tpu_torch.models import error_fit as ef
    from strelka_tpu_torch.ops import fit_kernels as fk
    cc = KEF_CASES[case]()
    lt = float(np.log(0.001))
    fk.reset()
    got = ef.fit_context(cc, lt, device=cuda)
    assert fk.LAUNCHES == {"error_fit_prep": 0, "error_fit_run": 1}
    assert not any(fk.PLAIN_ON_CUDA.values())
    again = ef.fit_context(cc, lt, device=cuda)
    want = ef.fit_context_plain(cc, lt, device=cuda)
    assert fk.PLAIN_ON_CUDA["error_fit_step"] == 600
    fields = ("log_error_rate", "log_noisy_locus_rate", "log_insert_rate",
              "log_delete_rate")
    for f in fields:
        assert getattr(again, f) == getattr(got, f), f
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=FLAT_RTOL, abs=0), f
    obs, _ = kef_inputs(cuda, cc, lt)

    def loss(fit):
        r = [torch.tensor(x, dtype=torch.float64, device=cuda) for x in
             (fit.log_insert_rate, fit.log_delete_rate,
              fit.log_noisy_locus_rate)]
        return -float(ef.context_log_lhood(*r, lt, *obs))
    assert loss(got) == pytest.approx(loss(want), rel=KEF_LOSS_AT_FIT_RTOL,
                                      abs=0)


@pytest.mark.parametrize("case", list(KEF_CASES))
def test_kef_fit_bit_for_bit_with_the_model_on_card(cuda, case):
    """A whole 600-step fit in one launch of KE-F's fit entry keeps
    fit_model's state bit for bit on the card at the grid it used: the
    best loss and parameters, the last parameters, Adam's moments and
    the last step's loss and gradient."""
    from strelka_tpu_torch.models import error_fit as ef
    from strelka_tpu_torch.ops import fit_kernels as fk
    cc = KEF_CASES[case]()
    lt = float(np.log(0.001))
    obs, c = kef_inputs(cuda, cc, lt)
    p0 = kef_p0(cuda)
    fk.reset()
    run = fk.error_fit_run(*obs, p0, c, 600)
    st = run.state.cpu()
    assert fk.LAUNCHES == {"error_fit_prep": 0, "error_fit_run": 1}
    loc = ef.fit_prep_plain(*obs, lt)
    best_v, best_p, losses, want = fk.fit_model(loc, p0, c, 600,
                                                run.grid[:2])
    assert st[fk.BEST_V].item() == best_v
    assert same(st[fk.BEST_PARAMS], best_p)
    assert same(st, want)
    assert st[fk.V].item() == losses[-1].item()


@pytest.mark.parametrize("refused", ["past_max_blocks",
                                     "cluster_past_the_card"])
def test_kef_refused_launch_raises(cuda, monkeypatch, refused):
    """A fit entry whose grid cannot run raises and counts nothing; the
    plain step never runs in its place: more blocks than the entry's
    limit (as a card that kept more resident would give; the C entry
    refuses it), or the whole grid one thread-block cluster of 196
    blocks, past the card's largest (cudaLaunchKernelEx refuses it)."""
    from strelka_tpu_torch.models import error_fit as ef
    from strelka_tpu_torch.ops import fit_kernels as fk
    lt = float(np.log(0.001))
    if refused == "past_max_blocks":
        cc = KEF_CASES["patterns_100k"]()
        monkeypatch.setattr(fk, "resident_blocks",
                            lambda dev: 2 * fk.MAX_BLOCKS)
    else:
        cc = KEF_CASES["patterns_50k"]()
        monkeypatch.setattr(fk, "fit_grid", lambda n, resident: (
            -(-n // fk.THREADS), 1, "cluster"))
    fk.reset()
    with pytest.raises(RuntimeError, match="error_fit_run launch failed"):
        ef.fit_context(cc, lt, device=cuda)
    assert fk.LAUNCHES == {"error_fit_prep": 0, "error_fit_run": 0}
    assert not any(fk.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize("case", ["smoke_size", "cluster_16"])
def test_kef_relaunch_and_grid_regime_keep_the_bits(cuda, case):
    """A FitRun launched again after reset() gives its first fit's bits,
    also after the observations it was made from are dropped and their
    memory written over (it holds them); the grid regime's cooperative
    launch and counter barrier on the cluster regime's grid gives the
    same bits (the same sums in the same order)."""
    from strelka_tpu_torch.ops import fit_kernels as fk
    cc = KEF_CASES[case]()
    obs, c = kef_inputs(cuda, cc, float(np.log(0.001)))
    p0 = kef_p0(cuda)
    run = fk.FitRun(*(o.clone() for o in obs), p0, c, 600)
    assert run.grid[2] == "cluster"
    run.launch()
    first = run.state.clone()
    junk = [torch.full_like(o, float("nan")) for o in obs for _ in range(4)]
    run.reset()
    run.launch()
    assert same(run.state, first)
    other = fk.FitRun(*obs, p0, c, 600, grid=(*run.grid[:2], "grid"))
    other.launch()
    assert same(other.state, first)
    del junk


@pytest.mark.parametrize("name", ["fit_indel_indy",
                                  "fit_indel_binom_mixture"])
def test_error_zoo_fit_on_card_matches_cpu(cuda, name):
    from strelka_tpu_torch.models import error_zoo as ez
    cc = indel_counts(2, 2000, 30, 1e-2, 0.5)
    want = getattr(ez, name)(cc, steps=200, device="cpu")
    got = getattr(ez, name)(cc, steps=200, device=cuda)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=FIT_RTOL, abs=0), k


# KZ (csrc/error_zoo_fit.cu: the zoo's fits, one launch a fit start)
# against its torch model (ops/zoo_kernels.zoo_fit_model) bit for bit on
# the card, and against the plain version (the autograd fit) within
# FIT_RTOL: the fits keep their last step, so the sums' order moves
# their fields by ulps
KZ_CASES = {
    "tool_size": lambda: indel_counts(2, 2000, 30, 1e-2, 0.5),
    "cluster_16": lambda: fit_kernels.synthetic_counts(9, 4500, 60),
    "patterns_100k": lambda: fit_kernels.synthetic_counts(9, 130_000, 500)}
# the tool's fitted model names: (fit function, positional args, family)
KZ_FITS = {
    "indelIndy": ("fit_indel_indy", (), "indy"),
    "indelBinomialMixture": ("fit_indel_binom_mixture", (),
                             "binom_mixture"),
    "indelBetaBinomialInsert": ("fit_indel_beta_binomial", (True,),
                                "beta_binomial"),
    "indelBetaBinomialDelete": ("fit_indel_beta_binomial", (False,),
                                "beta_binomial"),
    "indelIndyNoOverlapInsert": ("fit_indel_indy_noovl", (True,),
                                 "indy_noovl"),
    "indelIndyNoOverlapDelete": ("fit_indel_indy_noovl", (False,),
                                 "indy_noovl"),
    "indelBinomialMixtureNoOverlapInsert": (
        "fit_indel_binom_mixture_noovl", (True,), "binom_mixture_noovl"),
    "indelBinomialMixtureNoOverlapDelete": (
        "fit_indel_binom_mixture_noovl", (False,), "binom_mixture_noovl")}


def kz_run(cuda, family, cc, steps, lock, is_insert, grid=None):
    """(a ZooRun of family's first start on cc after its launch, its
    observations)."""
    from strelka_tpu_torch.models import error_zoo as ez
    from strelka_tpu_torch.ops import zoo_kernels as zk
    p = ez.IndelPatterns.build(cc, cuda)
    obs = (p.ref_obs, p.alt_obs, p.inst, p.max1, p.max2)
    run = zk.ZooRun(family, obs, ez.fit_starts(family)[0],
                    ez.kernel_consts(family, lock), steps, lock, is_insert,
                    grid=grid)
    run.launch()
    return run, obs


@pytest.mark.parametrize("case", list(KZ_CASES))
@pytest.mark.parametrize("family", ["indy", "binom_mixture", "indy_noovl",
                                    "binom_mixture_noovl", "beta_binomial"])
def test_kz_bit_for_bit_with_the_model_on_card(cuda, family, case):
    """A whole fit start in one launch of KZ's kernel keeps zoo_fit_model's
    state bit for bit on the card at the grid it used (the parameters,
    Adam's moments, the last step's loss and gradient, the final loss):
    the tool's full steps at its size, fewer past it; theta free and
    locked, deletions for the NoOverlap and beta-binomial families."""
    from strelka_tpu_torch.models import error_zoo as ez
    from strelka_tpu_torch.ops import zoo_kernels as zk
    cc = KZ_CASES[case]()
    steps = 600 if case == "tool_size" else 40
    for lock in (False, True):
        zk.reset()
        run, obs = kz_run(cuda, family, cc, steps, lock, False)
        st = run.state.cpu()
        assert zk.LAUNCHES[zk.FAMILIES[family].kernel] == 1
        assert sum(zk.LAUNCHES.values()) == 1
        want, losses = zk.zoo_fit_model(
            family, obs, ez.fit_starts(family)[0],
            ez.kernel_consts(family, lock), steps, lock, False,
            grid=run.grid[:2])
        assert same(st, want), (lock, run.grid)
        assert bool(torch.isfinite(losses).all())


@pytest.mark.parametrize("family", ["binom_mixture", "beta_binomial",
                                    "binom_mixture_noovl"])
def test_kz_grid_and_global_regimes_keep_the_bits(cuda, family):
    """The grid regime (a cooperative launch and its counter barrier) on
    the cluster regime's grid, and the global regime (the loci read from
    global memory) forced past the family's on-chip loci a thread, each
    bit for bit with zoo_fit_model on its grid; a ZooRun launched again
    after reset() gives its first bits."""
    from strelka_tpu_torch.models import error_zoo as ez
    from strelka_tpu_torch.ops import zoo_kernels as zk
    f = zk.FAMILIES[family]
    cc = KZ_CASES["cluster_16"]()
    n = len(cc.ref_obs)
    per = f.on_chip_per + 1
    for grid in ((16, 1, "grid"), (-(-n // (256 * per)), per, "global")):
        run, obs = kz_run(cuda, family, cc, 30, False, True, grid=grid)
        first = run.state.clone()
        want, _ = zk.zoo_fit_model(family, obs, ez.fit_starts(family)[0],
                                   ez.kernel_consts(family, False), 30,
                                   False, True, grid=grid[:2])
        assert same(first, want), grid
        run.reset()
        run.launch()
        assert same(run.state, first), grid


@pytest.mark.parametrize("name", list(KZ_FITS))
def test_kz_fit_matches_plain_fit_on_card(cuda, name):
    """Each of the tool's fitted model names on the card through KZ (its
    starts side by side: one launch, the plain version no time) against
    the plain version on the card (plain=True) and on the CPU: every field
    within FIT_RTOL; a second run gives the same bits."""
    from strelka_tpu_torch.models import error_zoo as ez
    from strelka_tpu_torch.ops import zoo_kernels as zk
    fn, args, family = KZ_FITS[name]
    f = zk.FAMILIES[family]
    starts = len(ez.fit_starts(family))
    cc = indel_counts(2, 2000, 30, 1e-2, 0.5)
    steps = 300
    zk.reset()
    got = getattr(ez, fn)(cc, *args, steps=steps, device=cuda)
    assert zk.LAUNCHES[f.kernel] == 1 == zk.tool_launches(
        family, [len(cc.ref_obs)], starts, zk.resident_blocks(f, cuda))
    assert sum(zk.LAUNCHES.values()) == 1
    assert zk.PLAIN_ON_CUDA == {"zoo_fit": 0}
    again = getattr(ez, fn)(cc, *args, steps=steps, device=cuda)
    assert again == got
    plain = getattr(ez, fn)(cc, *args, steps=steps, device=cuda, plain=True)
    assert zk.PLAIN_ON_CUDA == {"zoo_fit": starts}
    cpu = getattr(ez, fn)(cc, *args, steps=steps, device="cpu")
    for want in (plain, cpu):
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=FIT_RTOL, abs=0), k


def test_kz_refused_launch_raises(cuda, monkeypatch):
    """A fit whose grid cannot be placed raises and counts nothing: the
    whole grid one thread-block cluster of 196 blocks, past the card's
    largest (the batched entry refuses it); the plain version never runs
    in its place."""
    from strelka_tpu_torch.models import error_zoo as ez
    from strelka_tpu_torch.ops import zoo_kernels as zk
    cc = fit_kernels.synthetic_counts(9, 60_000, 300)
    monkeypatch.setattr(fit_kernels, "fit_grid",
                        lambda n, resident, per=4: (-(-n // 256), 1,
                                                    "cluster"))
    zk.reset()
    with pytest.raises(RuntimeError, match="KZ-4 batched launch failed"):
        ez.fit_indel_indy(cc, steps=5, device=cuda)
    assert zk.LAUNCHES == {"KZ-4": 0, "KZ-3": 0, "KZ-B": 0}
    assert zk.PLAIN_ON_CUDA == {"zoo_fit": 0}


def kz_contexts():
    """A counts file's contexts for the batched path, slices of the
    107,434 seeded patterns: two cluster blocks (275 patterns), a 16-block
    cluster at two loci a thread (5,000), one block (93) and past the
    cluster (40,000: the grid regime)."""
    from strelka_tpu_torch.models.error_fit import ContextCounts
    big = fit_kernels.synthetic_counts(9, 130_000, 500)

    def cut(a, b):
        return ContextCounts(big.ref_obs[a:b], big.alt_obs[a:b],
                             big.instance_count[a:b])
    return [cut(0, 275), cut(1000, 6000), cut(300, 393), cut(6000, 46_000)]


@pytest.mark.parametrize("resident", [None, 3])
@pytest.mark.parametrize("family", ["indy", "binom_mixture", "indy_noovl",
                                    "binom_mixture_noovl", "beta_binomial"])
def test_kz_zoo_batch_starts_bit_for_bit_with_alone_and_model(
        cuda, monkeypatch, family, resident):
    """A tool run's fit starts side by side (ZooBatch: one launch padded
    to the widest cluster, and the large starts alone, on the card's
    resident blocks or with the card taken to keep 3, which moves the
    large starts' grids): each start's state bit for bit with the same
    start launched alone (ZooRun on its grid: a batched launch of one in
    the cluster regime) and with zoo_fit_model on that grid; KZ launched
    ZooBatch.launches times; a relaunch after reset() gives the same
    bits."""
    from strelka_tpu_torch.models import error_zoo as ez
    from strelka_tpu_torch.ops import zoo_kernels as zk
    f = zk.FAMILIES[family]
    if resident:
        monkeypatch.setattr(zk, "resident_blocks", lambda f, dev: resident)
    ctxs = kz_contexts()
    obs = [ez._host_obs(cc) for cc in ctxs]
    x0s = ez.fit_starts(family)
    lock, is_insert, steps = False, family != "beta_binomial", 40
    c = ez.kernel_consts(family, lock)
    zk.reset()
    batch = zk.ZooBatch(family, obs, x0s, c, steps, lock, is_insert, cuda)
    batch.launch()
    got = batch.states.cpu()
    assert zk.LAUNCHES[f.kernel] == batch.launches
    assert batch.batched and batch.launches == 1 + len(batch.large)
    grids = [w.grid for w in batch.work]
    assert grids[len(x0s)] == zk.kz_grid(5000, zk.resident_blocks(f, cuda),
                                         f)
    if f.cluster_per >= 2:
        assert grids[len(x0s)] == (10, 2, "cluster")
    for i, w in enumerate(batch.work):
        o = tuple(t[w.offset:w.offset + w.n] for t in batch.obs)
        alone = zk.ZooRun(family, o, x0s[w.start], c, steps, lock,
                          is_insert, grid=w.grid)
        alone.launch()
        assert same(got[i], alone.state), (i, w)
        want, _ = zk.zoo_fit_model(family, o, x0s[w.start], c, steps, lock,
                                   is_insert, grid=w.grid[:2])
        assert same(got[i], want), (i, w)
    batch.reset()
    batch.launch()
    assert same(batch.states, got)


# the tool-run contexts of test_kz_zoo_tool_run_launches_and_matches_cpu
# by data: indel counts (1,272, 20,586 and 16 patterns: 5 cluster blocks,
# past the cluster, one block) and slices of the seeded synthetic patterns
# (275, 5,000 and 93: 2 cluster blocks, a 16-block cluster or past it by
# family, one block), at KZ_TOOL_STEPS Adam steps a start
KZ_TOOL_STEPS = 200
KZ_TOOL_DATA = {
    "indel_counts": lambda: [indel_counts(2, 4000, (10, 200), 1e-2, 0.5),
                             indel_counts(3, 60_000, (10, 600), 2e-2, 0.5),
                             indel_counts(4, 2000, 30, 1e-2, 0.5)],
    "synthetic": lambda: kz_contexts()[:3]}
# (data, model name, context index): a fit whose loss is flat along its
# first listed field, which any change in the order of the loss's sums
# moves past FIT_RTOL, and the fields that move with it. At KZ_TOOL_STEPS
# on the CPU (tests/test_torch_zoo_batch.py::
# test_sum_order_moves_a_flat_fit): the 93-pattern synthetic context's
# noisy-locus rate of indelBinomialMixtureNoOverlapInsert is 5.86e-8
# relative from the plain fit through KZ's arithmetic (zoo_fit_model),
# and 1.90e-8 through the JAX package's; its indel rate 1.41e-11 and
# 4.94e-11 there, and 1.22e-10 on an H100 (the card's exp and log);
# its log likelihood agrees to 2e-16.
KZ_SUM_ORDER_SENSITIVE = {
    ("synthetic", "indelBinomialMixtureNoOverlapInsert", 2):
        ("noisy_locus_rate", "indel_rate")}
# the bound that such a field keeps against the CPU (a flat direction,
# not a wrong fit)
KZ_FLAT_RTOL = 1e-6


@pytest.mark.parametrize("data", list(KZ_TOOL_DATA))
def test_kz_zoo_tool_run_launches_and_matches_cpu(cuda, data):
    """Each fitted model name of tools estimate-parameters on three
    contexts (KZ_TOOL_DATA) through fit_contexts, as the tool calls it,
    at KZ_TOOL_STEPS steps on the card: KZ launched tool_launches times
    (one padded batched launch, then each large start alone), the plain
    version no time; every field within FIT_RTOL of the CPU's, but on a
    fit of KZ_SUM_ORDER_SENSITIVE: there the record equals that of
    zoo_fit_model's starts on the card bit for bit (KZ's own arithmetic;
    the tool's pick of the lower final loss), and each listed field stays
    within KZ_FLAT_RTOL of the CPU's, its distance printed."""
    from strelka_tpu_torch.models import error_zoo as ez
    from strelka_tpu_torch.ops import zoo_kernels as zk
    from strelka_tpu_torch.workflow import tools
    ctxs = KZ_TOOL_DATA[data]()
    sizes = [len(cc.ref_obs) for cc in ctxs]
    steps = KZ_TOOL_STEPS
    for name, (family, is_insert) in tools.FITTED_MODELS.items():
        f = zk.FAMILIES[family]
        starts = len(ez.fit_starts(family))
        zk.reset()
        got = ez.fit_contexts(family, ctxs, is_insert, False, steps, cuda)
        launches = zk.tool_launches(family, sizes, starts,
                                    zk.resident_blocks(f, cuda))
        assert zk.LAUNCHES[f.kernel] == sum(zk.LAUNCHES.values()) == \
            launches, name
        if data == "indel_counts":
            assert launches == 1 + starts, name
        assert zk.PLAIN_ON_CUDA == {"zoo_fit": 0}
        want = ez.fit_contexts(family, ctxs, is_insert, False, steps, "cpu")
        for i, (g, w) in enumerate(zip(got, want)):
            assert list(g) == list(w)
            flat = KZ_SUM_ORDER_SENSITIVE.get((data, name, i), ())
            if flat:
                obs = tuple(torch.as_tensor(a).to(cuda)
                            for a in ez._host_obs(ctxs[i]))
                at = zk.state_slots(f)
                ends = []
                for x0 in ez.fit_starts(family):
                    st, _ = zk.zoo_fit_model(
                        family, obs, x0, ez.kernel_consts(family, False),
                        steps, False, is_insert)
                    ends.append((st[at["params"]].cpu().numpy(),
                                 float(st[at["final"]])))
                best = ends[0]
                for e in ends[1:]:
                    best = e if e[1] < best[1] else best
                assert g == ez._result(family, *best, False), (name, i)
            for k, v in w.items():
                if k in flat:
                    rel = abs(g[k] - v) / abs(v)
                    print(f"{name} context {i} {k}: {rel:.3e} from the CPU")
                    assert rel <= KZ_FLAT_RTOL, (name, i, k)
                else:
                    assert g[k] == pytest.approx(v, rel=FIT_RTOL, abs=0), (
                        name, i, k)


def test_kz_zoo_large_start_refused_launch_raises(cuda, monkeypatch):
    """A start past the cluster whose launch fails raises, counts nothing
    and runs no plain fit: its grid forced to 420 blocks of one locus a
    thread, past the 264 that the grid regime takes (the entry refuses
    it)."""
    from strelka_tpu_torch.models import error_zoo as ez
    from strelka_tpu_torch.ops import zoo_kernels as zk
    monkeypatch.setattr(zk, "kz_grid", lambda n, resident, f: (
        -(-n // 256), 1, "grid"))
    zk.reset()
    with pytest.raises(RuntimeError, match="KZ-4 launch failed"):
        ez.fit_indel_indy(fit_kernels.synthetic_counts(9, 130_000, 500),
                          steps=5, device=cuda)
    assert zk.LAUNCHES == {"KZ-4": 0, "KZ-3": 0, "KZ-B": 0}
    assert zk.PLAIN_ON_CUDA == {"zoo_fit": 0}


# --- the engine mesh (parallel/mesh.py) on the card -------------------------

@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2), (4, 1)])
def test_sharded_k1_over_repeated_card_matches_one_launch(cuda, dp, sp):
    """sharded_best_offsets over a mesh that repeats cuda:0: one K1 launch
    a shard, the result bit for bit one unsharded launch's, with padding
    windows that tie real offsets and all-N reads that tie everywhere."""
    from strelka_tpu_torch.ops import score_kernel as sk
    from strelka_tpu_torch.parallel import mesh as pm
    B, R, L, W = 16, 32, 160, 192
    codes, delta, lnmis, win = k1_inputs(np.random.default_rng(dp * 10 + sp),
                                         B, R, L, W)
    win[:, :, W // 2:] = 4
    codes[:, :2] = 4
    delta[:, :2] = 0.0
    lnmis[:, :2] = 0.0
    host = [torch.from_numpy(a) for a in (codes, delta, lnmis, win)]
    want = sk.score_best_offsets(*(t.to(cuda) for t in host))
    mesh = pm.make_mesh([cuda] * (dp * sp), dp=dp, sp=sp)
    before = sk.LAUNCHES
    got = pm.sharded_best_offsets(sk.score_best_offsets, mesh)(*host)
    assert sk.LAUNCHES == before + dp * sp
    assert torch.equal(got[0], want[0].cpu())
    assert torch.equal(got[1], want[1].cpu())


def test_k1_on_second_card_matches_first(cuda):
    """A K1 launch on cuda:1, with cuda:0 the current device, equals one
    on cuda:0 (the launch makes its own card current)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from strelka_tpu_torch.ops import score_kernel as sk
    host = [torch.from_numpy(a) for a in k1_inputs(np.random.default_rng(2),
                                                   8, 128, 160, 256)]
    with torch.cuda.device(0):
        a = sk.score_best_offsets(*(t.to("cuda:0") for t in host))
        b = sk.score_best_offsets(*(t.to("cuda:1") for t in host))
    assert b[0].device == torch.device("cuda", 1)
    assert torch.equal(a[0].cpu(), b[0].cpu())
    assert torch.equal(a[1].cpu(), b[1].cpu())


def test_mesh_snv_and_somatic_chunks_on_repeated_card(cuda, monkeypatch):
    """The SNV chunks (two full chunks and a partial tail) and the
    somatic tier1 chunks with every chunk split over a mesh of cuda:0
    four times equal the unsharded card run bit for bit."""
    import types

    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.parallel import mesh as pm
    from strelka_tpu_torch.pipeline import somatic_caller as sc
    rng = np.random.default_rng(4)
    monkeypatch.setattr(sd, "SNV_TILE_L", 2048)
    L, D = 2 * 4 * 2048 + 777, 40
    ref = rng.integers(0, 4, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.2, rng.integers(0, 4, (L, D)),
                    ref[:, None]).astype(np.int8)
    tile = sd.SnvPileupTile(
        base_id=base, qual=rng.integers(0, 45, (L, D)).astype(np.uint8),
        is_fwd=rng.random((L, D)) < 0.5, mask=rng.random((L, D)) < 0.8,
        ref_gt=ref)
    pus = [types.SimpleNamespace(
        base_id=base, qual=tile.qual.astype(np.int16), is_fwd=tile.is_fwd,
        valid=tile.mask, used=rng.random((L, D)) < 0.9,
        tier2_used=tile.mask) for _ in range(2)]
    monkeypatch.setattr(sc, "_tile_rows", lambda pus, dev: 4096)

    def run(nlh, tlh):
        return ss.somatic_snv_call_capped(nlh, tlh)

    def both():
        return (sd.call_snv_tile_chunked(tile, device=cuda),
                sc._snv_tier1_fused(pus, ref, run, cuda))
    plain = both()
    pm.set_engine_mesh(pm.make_mesh([cuda] * 4, dp=4, sp=1))
    try:
        meshed = both()
    finally:
        pm.set_engine_mesh(None)
    for a, b in zip(plain, meshed):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if x is not None:
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), f


def test_germline_cli_mesh_on_card_matches_plain(cuda, tmp_path):
    """germline --device cuda --mesh 1 and --mesh auto equal the run
    without --mesh; --mesh N past the visible cards exits 2."""
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.__main__ import main
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    refs, batch, _ = synth.generate(L=60_000, depth=25, snv_every=700,
                                    indel_every=1000, seed=11)
    fa = tmp_path / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    bam = str(tmp_path / "s.bam")
    write_bam(bam, BamHeader(text="", ref_names=["syn"],
                             ref_lengths=[len(refs)]), batch)
    recs = {}
    for tag, extra in (("plain", []), ("one", ["--mesh", "1"]),
                       ("auto", ["--mesh", "auto"])):
        out = str(tmp_path / tag)
        assert main(["germline", "--reference", str(fa), "--align-file", bam,
                     "--output-dir", out, "--device", "cuda", *extra]) == 0
        with gzip.open(os.path.join(out, "variants.vcf.gz"), "rt") as f:
            recs[tag] = [l for l in f if not l.startswith("#")]
    assert recs["one"] == recs["plain"] == recs["auto"]
    n = torch.cuda.device_count() + 1
    assert main(["germline", "--reference", str(fa), "--align-file", bam,
                 "--output-dir", str(tmp_path / "too_many"), "--device",
                 "cuda", "--mesh", str(n)]) == 2


# --- the SNV models' kernels KG-H, KS-G and KS-P against their plain
# versions on the card, bit for bit on every field (a NaN as a NaN)

def same_bits(a, b):
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


def hist_tile(rng, L, D, hist_dtype=np.int8):
    """A germline (qscore, base) histogram of a random tile of depth D,
    with q = 0 calls, haploid rows and dependent-eprob deltas."""
    from strelka_tpu_torch.models import snv_digt as sd
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.3, rng.integers(0, 4, (L, D)),
                    np.minimum(ref, 3)[:, None]).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(np.uint8)
    qual[rng.random((L, D)) < 0.02] = 0
    mask = rng.random((L, D)) < 0.8
    mask[:L // 50] = False            # rows with no call
    h = np.zeros((L, 512), np.int8)
    sd._np_snv_hist(base, qual, mask, h)
    hap = rng.random(L) < 0.1
    smis = np.where(rng.random((L, 4)) < 0.05,
                    rng.random((L, 4)) * 0.5, 0.0).astype(np.float32)
    return h.astype(hist_dtype), ref, hap, smis


def lane_tile(rng, L, D, kind, qual_dtype=np.int16):
    """A germline tile of `kind`: the live slots a row that it gives
    (0, 1, 4, 32 or all 512 of a full row), or "random" (45 qualities, q
    = 0 calls, 20% masked lanes, all-masked rows)."""
    ref = rng.integers(0, 5, L).astype(np.int32)
    refb = np.minimum(ref, 3)[:, None]
    mask = np.ones((L, D), bool)
    if kind == "random":
        base = np.where(rng.random((L, D)) < 0.3, rng.integers(-1, 5, (L, D)),
                        refb).astype(np.int8)
        qual = rng.integers(0, 45, (L, D))
        qual[rng.random((L, D)) < 0.02] = 0
        mask = rng.random((L, D)) < 0.8
        mask[:max(L // 50, 1)] = False
    elif kind == 0:
        base = np.broadcast_to(refb, (L, D)).astype(np.int8)
        qual = np.full((L, D), 32)
        mask[:] = False
    elif kind in (1, 4, 32):
        # one quality (the CLI's reads), two qualities x ref/alt, or
        # eight qualities x four bases; every slot met where D allows
        nq, nb = {1: (1, 1), 4: (2, 2), 32: (8, 4)}[kind]
        pick = np.arange(D)[None] % (nq * nb)
        pick = np.take_along_axis(
            np.broadcast_to(pick, (L, D)),
            np.argsort(rng.random((L, D)), axis=1), axis=1)
        qs = np.array([32, 37, 12, 25, 2, 40, 20, 30])[:nq]
        qual = qs[pick // nb]
        base = ((refb + pick % nb) % 4).astype(np.int8)
    else:                       # 512: every (q, base) slot once a row
        assert D >= 512
        slot = np.argsort(rng.random((L, D)), axis=1) % 512
        qual, base = slot // 4, (slot % 4).astype(np.int8)
    hap = rng.random(L) < 0.2
    smis = np.where(rng.random((L, 4)) < 0.1,
                    rng.random((L, 4)) * 0.5, 0.0).astype(np.float32)
    return (base, np.asarray(qual).astype(qual_dtype), mask, ref, hap,
            smis)


def kgh_against_plain(dev, hist, ref, hap, smis):
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import snv_kernels as snk
    t = [None if a is None else torch.from_numpy(a).to(dev)
         for a in (hist, ref, hap, smis)]
    before = dict(snk.LAUNCHES)
    got = sd.call_snv_hist_tile(t[0], t[1], t[2], 0.001, s_mis=t[3])
    assert snk.LAUNCHES["snv_hist_tile"] == (before["snv_hist_tile"]
                                             + (len(ref) > 0))
    want = sd.call_snv_hist_tile_plain(t[0], t[1], t[2], 0.001, s_mis=t[3])
    torch.cuda.synchronize()
    for f in sd._PULL:
        assert same_bits(getattr(got, f), getattr(want, f)), f
    return got


@pytest.mark.parametrize("D", [32, 96, 127])
@pytest.mark.parametrize("with_hap,with_smis", [(False, False), (True, True)])
def test_kgh_bit_identical_to_plain(cuda, D, with_hap, with_smis):
    h, ref, hap, smis = hist_tile(np.random.default_rng(D), 3000, D)
    kgh_against_plain(cuda, h, ref, hap if with_hap else None,
                      smis if with_smis else None)


def test_kgh_int32_counts_bit_identical_to_plain(cuda):
    """The histogram that call_snv_tile counts on the card (D > 127)."""
    h, ref, hap, smis = hist_tile(np.random.default_rng(5), 2000, 96,
                                  np.int32)
    h[:100] *= 3                      # counts past int8's range
    kgh_against_plain(cuda, h, ref, hap, smis)


@pytest.mark.parametrize("fill", ["ninf", "nan"])
def test_kgh_ninf_and_nan_rows_bit_identical_to_plain(cuda, fill):
    """Rows whose lhoods go -inf or NaN through s_mis: phreds and PLs 0
    (XLA's convert), the rest as the plain version gives it."""
    h, ref, hap, smis = hist_tile(np.random.default_rng(6), 500, 64)
    smis[:40] = -np.inf if fill == "ninf" else np.nan
    got = kgh_against_plain(cuda, h, ref, hap, smis)
    assert (got.snv_qphred[:40] == 0).all()
    assert (got.phred_loghood[:40] == 0).all()


@pytest.mark.parametrize("L", [0, 1, 33, 1031])
def test_kgh_ragged_and_tiny_tiles(cuda, L):
    h, ref, hap, smis = hist_tile(np.random.default_rng(L), L, 50)
    kgh_against_plain(cuda, h, ref, hap, smis)


@pytest.mark.parametrize("kind,D", [(1, 64), (4, 64), (32, 64),
                                    (512, 512)])
def test_kgh_sparse_and_full_rows_bit_identical_to_plain(cuda, kind, D):
    """Rows with 1, 4, 32 and all 512 live slots: the dense entry walks
    its live list only."""
    from strelka_tpu_torch.models import snv_digt as sd
    base, qual, mask, ref, hap, smis = lane_tile(np.random.default_rng(D),
                                                 1500, D, kind)
    h = sd._tile_hist(*(torch.from_numpy(a) for a in (base, qual, mask)))
    kgh_against_plain(cuda, h.numpy().astype(np.int8 if D < 128
                                             else np.int32), ref, hap, smis)


def lanes_against_plain(dev, base, qual, mask, ref, hap, smis):
    """KG-H's lanes entry against _tile_hist plus the plain version (the
    lanes entry's plain version), every field bit for bit, one launch."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import snv_kernels as snk
    t = [None if a is None else torch.from_numpy(a).to(dev)
         for a in (base, qual, mask, ref, hap, smis)]
    before = dict(snk.LAUNCHES)
    got = sd.call_snv_lanes_tile(*t[:5], 0.001, s_mis=t[5])
    assert snk.LAUNCHES == dict(before, snv_lanes_tile=(
        before["snv_lanes_tile"] + (len(ref) > 0)))
    want = sd.call_snv_lanes_tile_plain(*t[:5], 0.001, s_mis=t[5])
    torch.cuda.synchronize()
    for f in sd._PULL:
        assert same_bits(getattr(got, f), getattr(want, f)), f
    return got


@pytest.mark.parametrize("D", [32, 64, 127, 160, 300])
@pytest.mark.parametrize("qual_dtype", [np.int16, np.uint8])
def test_kgh_lanes_bit_identical_to_plain(cuda, D, qual_dtype):
    """Random tiles (q = 0 calls, bases -1 and 4, masked lanes, all-masked
    rows, haploid rows, s_mis) at the pileup's qual widths; D > 127 is
    call_snv_tile's deep pass."""
    lanes_against_plain(cuda, *lane_tile(np.random.default_rng(D), 3001, D,
                                         "random", qual_dtype))


@pytest.mark.parametrize("kind", [0, 1, 4, 32, 512])
def test_kgh_lanes_sparse_and_full_rows_bit_identical_to_plain(cuda, kind):
    D = 512 if kind == 512 else 64
    lanes_against_plain(cuda, *lane_tile(np.random.default_rng(kind + 40),
                                         2000, D, kind))


@pytest.mark.parametrize("fill", ["ninf", "nan"])
def test_kgh_lanes_ninf_and_nan_rows_bit_identical_to_plain(cuda, fill):
    base, qual, mask, ref, hap, smis = lane_tile(np.random.default_rng(7),
                                                 500, 64, "random")
    smis[:40] = -np.inf if fill == "ninf" else np.nan
    got = lanes_against_plain(cuda, base, qual, mask, ref, hap, smis)
    assert (got.snv_qphred[:40] == 0).all()
    assert (got.phred_loghood[:40] == 0).all()


@pytest.mark.parametrize("L,D", [(0, 40), (1, 40), (33, 0), (1031, 50)])
def test_kgh_lanes_ragged_and_tiny_tiles(cuda, L, D):
    lanes_against_plain(cuda, *lane_tile(np.random.default_rng(L + 3), L, D,
                                         "random"))


def test_kgh_lanes_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """On the card too: qual of another width, lanes on two devices, a
    strided tile; nothing launches."""
    from strelka_tpu_torch import convert
    from strelka_tpu_torch.ops import snv_kernels as snk
    base, qual, mask, ref, hap, smis = (
        torch.from_numpy(a).to(cuda)
        for a in lane_tile(np.random.default_rng(3), 64, 32, "random"))
    tabs = convert.device_tables(0.001, cuda)
    before = dict(snk.LAUNCHES)
    for args in ((base, qual.int(), mask, ref, hap, smis),
                 (base, qual, mask.cpu(), ref, hap, smis),
                 (base[:, ::2], qual[:, ::2], mask[:, ::2], ref, hap, smis)):
        with pytest.raises(ValueError):
            snk.snv_lanes_tile(*args, tabs)
    assert snk.LAUNCHES == before


# KG-SB and KG-R: the depths where XLA's orders change (the strand-bias
# tile's CLI pads D to 32 and 64 here), RNA mode's extension
XLA_DEPTHS = [1, 15, 16, 20, 23, 24, 31, 32, 33, 64, 300, 1024, 1025]
RNA_EXT, RNA_INC = 0.45, 0.0501


def xla_tile(rng, L, D, qual_dtype=np.int16, dep=True):
    """An RNA-like tile: (base, qual, fwd, mask, ref, hap, dd, tgt, lt).
    Bases -1..4, mostly the reference; qscores 0..44, the last 3 calls of
    a row at q = 0 (forced-ref keys on the eprob floor); 85% used, every
    25th row all masked; strands at random; deltas on 10% of the calls;
    tgt any genotype; 20% haploid rows."""
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.6, np.minimum(ref, 3)[:, None],
                    rng.integers(-1, 5, (L, D))).astype(np.int8)
    qual = rng.integers(0, 45, (L, D))
    qual[:, -3:] = 0
    mask = rng.random((L, D)) < 0.85
    mask[::25] = False
    fwd = rng.random((L, D)) < 0.5
    dd = (np.where(rng.random((L, D)) < 0.1, -rng.random((L, D)), 0.0)
          .astype(np.float32) if dep else None)
    hap = rng.random(L) < 0.2
    tgt = rng.integers(0, 10, L).astype(np.int32)
    lt = rng.normal(-50, 10, L).astype(np.float32)
    return (base, qual.astype(qual_dtype), fwd, mask, ref, hap, dd, tgt, lt)


def kgsb_against_plain(dev, base, qual, fwd, mask, ref, hap, dd, tgt, lt,
                       ext, inc=RNA_INC):
    """KG-SB against snv_strand_bias_tile_plain on the card, bit for bit
    (a NaN as a NaN), one launch."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import snv_kernels as snk
    t = [None if a is None else torch.from_numpy(a).to(dev)
         for a in (base, qual, fwd, mask, ref, dd, tgt, lt)]
    tile = sd.SnvPileupTile(t[0], t[1], t[2], t[3], t[4])
    before = dict(snk.LAUNCHES)
    got = sd.snv_strand_bias_tile(tile, t[6], t[7], t[5], ext, inc)
    assert snk.LAUNCHES == dict(before, snv_strand_bias_tile=(
        before["snv_strand_bias_tile"] + (len(ref) > 0)))
    want = sd.snv_strand_bias_tile_plain(tile, t[6], t[7], t[5], ext, inc)
    torch.cuda.synchronize()
    assert same_bits(got, want)
    return got


def kgr_against_plain(dev, base, qual, fwd, mask, ref, hap, dd, tgt, lt,
                      ext=RNA_EXT, inc=RNA_INC):
    """KG-R (call_snv_tile's RNA pass) against call_snv_rna_tile_plain on
    the card, every _PULL field bit for bit (a NaN as a NaN), one launch."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import snv_kernels as snk
    t = [None if a is None else torch.from_numpy(a).to(dev)
         for a in (base, qual, fwd, mask, ref, hap, dd)]
    tile = sd.SnvPileupTile(t[0], t[1], t[2], t[3], t[4])
    before = dict(snk.LAUNCHES)
    got = sd.call_snv_tile(tile, 0.001, t[5], het_vf_extension=ext,
                           het_vf_increment=inc, dep_delta=t[6])
    assert snk.LAUNCHES == dict(before, snv_rna_tile=(
        before["snv_rna_tile"] + (len(ref) > 0)))
    want = sd.call_snv_rna_tile_plain(tile, 0.001, t[5], ext, inc, t[6])
    torch.cuda.synchronize()
    for f in sd._PULL:
        assert same_bits(getattr(got, f), getattr(want, f)), f
    return got


@pytest.mark.parametrize("D", XLA_DEPTHS)
@pytest.mark.parametrize("ext", [0.0, RNA_EXT])
def test_kgsb_bit_identical_to_plain(cuda, D, ext):
    """KG-SB at every depth where XLA's orders change, with and without
    the het-VF extension; deltas at odd depths, none at even ones; int16
    qual, uint8 at D = 32 and 64 (the CLI's padded D)."""
    rng = np.random.default_rng(D + int(ext * 100))
    L = 300 if D < 1000 else 40
    qt = np.uint8 if D in (32, 64) and ext else np.int16
    kgsb_against_plain(cuda, *xla_tile(rng, L, D, qt, dep=D % 2 == 1), ext)


@pytest.mark.parametrize("D", XLA_DEPTHS)
def test_kgr_bit_identical_to_plain(cuda, D):
    """KG-R at every depth where XLA's orders change (windows of windows
    past 1,024), deltas at odd depths, haploid and all-masked rows."""
    rng = np.random.default_rng(D + 7)
    L = 600 if D < 1000 else 40
    qt = np.uint8 if D == 64 else np.int16
    kgr_against_plain(cuda, *xla_tile(rng, L, D, qt, dep=D % 2 == 1))


@pytest.mark.parametrize("ext,inc,n_steps", [
    (0.03, RNA_INC, 1), (0.394, 0.0101, 40)])
@pytest.mark.parametrize("D", [32, 64, 300])
def test_kgsb_and_kgr_at_the_step_limits(cuda, ext, inc, n_steps, D):
    """KG-SB and KG-R at the fewest and the most het-ratio steps the
    wrappers take (snv_kernels.MAX_STEPS: KG-R's largest shared-memory
    table; RNA mode's options give 9), with deltas, haploid and
    all-masked rows."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import snv_kernels as snk
    assert sd._het_vf_table(ext, inc)[0].shape[0] == n_steps
    assert n_steps in (1, snk.MAX_STEPS)
    x = xla_tile(np.random.default_rng(D + n_steps), 500, D)
    kgr_against_plain(cuda, *x, ext=ext, inc=inc)
    kgsb_against_plain(cuda, *x, ext, inc)


@pytest.mark.parametrize("fill", ["ninf", "nan"])
def test_kgsb_and_kgr_ninf_and_nan_rows_bit_identical_to_plain(cuda, fill):
    """Rows whose deltas are -inf or NaN: KG-R's lhoods go -inf or NaN
    (phreds 0), KG-SB's strand bias with them, and lt -inf or NaN on
    others; each as its plain version gives it."""
    rng = np.random.default_rng(17)
    x = list(xla_tile(rng, 400, 64))
    v = -np.inf if fill == "ninf" else np.nan
    x[6][:40] = v
    x[8][40:60] = v
    got = kgr_against_plain(cuda, *x)
    if fill == "nan":
        assert (got.snv_qphred[:40] == 0).all()
    for ext in (0.0, RNA_EXT):
        kgsb_against_plain(cuda, *x, ext)


@pytest.mark.parametrize("L", [0, 1, 33, 1031])
def test_kgsb_and_kgr_ragged_and_tiny_tiles(cuda, L):
    rng = np.random.default_rng(L + 11)
    x = xla_tile(rng, L, 40)
    kgr_against_plain(cuda, *x)
    kgsb_against_plain(cuda, *x, RNA_EXT)


def test_kgsb_and_kgr_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """On the card too: qual of another width, lanes on two devices, a
    strided tile; nothing launches."""
    from strelka_tpu_torch import convert
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import snv_kernels as snk
    b, q, f, m, r, hap, dd, g, lt = (
        torch.from_numpy(a).to(cuda)
        for a in xla_tile(np.random.default_rng(3), 64, 32))
    xt = sd._xla_tables(RNA_EXT, RNA_INC, cuda)
    tabs = convert.device_tables(0.001, cuda)
    before = dict(snk.LAUNCHES)
    for args in ((b, q.int(), f, m, r, g, lt, dd),
                 (b, q, f, m.cpu(), r, g, lt, dd),
                 (b[:, ::2], q[:, ::2], f[:, ::2], m[:, ::2], r, g, lt,
                  dd[:, ::2])):
        with pytest.raises(ValueError):
            snk.snv_strand_bias_tile(*args, xt)
        with pytest.raises(ValueError):
            snk.snv_rna_tile(args[0], args[1], args[3], r, hap, args[7],
                             tabs, xt["het_vf"])
    assert snk.LAUNCHES == before


# the het-ratio steps the kernels take (1, RNA mode's 9, the most) as
# (extension, increment)
XLA_STEPS = {1: (0.03, RNA_INC), 9: (RNA_EXT, RNA_INC), 40: (0.394, 0.0101)}


@pytest.mark.parametrize("qual_dtype,dep", [(np.uint8, True),
                                            (np.uint8, False),
                                            (np.int16, True),
                                            (np.int16, False)])
@pytest.mark.parametrize("D", [1, 20, 32, 33, 64, 1025])
@pytest.mark.parametrize("n_steps", [1, 9, 40])
def test_kgsb_and_kgr_walk_bit_identical_to_plain(cuda, n_steps, D,
                                                  qual_dtype, dep):
    """The redesigned walk of both kernels (items several to a lane in
    passes, call rows, spread logsumexps) at 1, 9 and 40 het-ratio steps,
    at the depths where their sums change shape (one vectorized window,
    a partial one, windows of windows), with uint8 and int16 qual, with
    and without deltas, haploid and all-masked rows; KG-SB also without
    the extension."""
    from strelka_tpu_torch.models import snv_digt as sd
    ext, inc = XLA_STEPS[n_steps]
    assert sd._het_vf_table(ext, inc)[0].shape[0] == n_steps
    x = xla_tile(np.random.default_rng(D * 7 + n_steps),
                 160 if D < 1000 else 40, D, qual_dtype, dep)
    kgr_against_plain(cuda, *x, ext=ext, inc=inc)
    kgsb_against_plain(cuda, *x, ext, inc)
    if n_steps == 9:
        kgsb_against_plain(cuda, *x, 0.0)


@pytest.mark.parametrize("n_steps", [9, 40])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("name", ["snv_rna_tile", "snv_strand_bias_tile"])
def test_kgsb_and_kgr_grids_count_the_dynamic_shared_memory(cuda, name, D,
                                                            n_steps):
    """For more rows than the card holds at once, each kernel's grid is
    the blocks an SM holds by the occupancy API with the launch's dynamic
    shared memory, times the SMs (snv::resident_blocks keeps its count
    per byte count)."""
    from strelka_tpu_torch.ops import snv_kernels as snk
    g = snk.launch_grid(name, 1 << 24, n_steps, D, cuda)
    assert g["per_sm"] >= 1 and g["sms"] >= 1
    assert g["blocks"] == g["per_sm"] * g["sms"]
    small = snk.launch_grid(name, 3, n_steps, D, cuda)
    assert small["blocks"] == 1


def test_rna_path_launches_the_kernels_not_the_plain_versions(cuda):
    """call_snv_tile_chunked in RNA mode on the card: KG-R once a genotype
    tile tally, KG-SB once a strand-bias tally, no plain version; lhood,
    strand bias and the integer fields equal to the CPU path's bit for
    bit, ln_ref_pprob (torch's float64 exp and log on each device) within
    1e-13 (relative, or absolute near 0)."""
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.ops import snv_kernels as snk
    rng = np.random.default_rng(15)
    L, D = 4000, 64
    base, qual, fwd, mask, ref, hap, dd, _, _ = xla_tile(rng, L, D)
    base = np.where(rng.random((L, D)) < 0.7, np.minimum(ref, 3)[:, None],
                    base).astype(np.int8)
    dep = (np.zeros((L, 4), np.float32),
           lambda rows: dd[np.arange(L) if rows is None else rows])
    tile = sd.SnvPileupTile(base, qual, fwd, mask, ref)
    snk.reset()
    sd.LAUNCH_STATS.clear()
    got = sd.call_snv_tile_chunked(tile, 0.001, hap, RNA_EXT, RNA_INC,
                                   dep=dep, device=cuda)
    tallies = {k: sum(v for (kind, dev, rows, _), v in
                      sd.LAUNCH_STATS.items()
                      if kind == k and dev == "cuda" and rows)
               for k in ("tile", "sb")}
    assert tallies["tile"] and tallies["sb"]
    assert snk.LAUNCHES == dict({k: 0 for k in snk.LAUNCHES},
                                snv_rna_tile=tallies["tile"],
                                snv_strand_bias_tile=tallies["sb"])
    assert not any(snk.PLAIN_ON_CUDA.values())
    want = sd.call_snv_tile_chunked(tile, 0.001, hap, RNA_EXT, RNA_INC,
                                    dep=dep, device="cpu")
    for f in (*sd._PULL, "strand_bias"):
        a, b = (np.ascontiguousarray(getattr(x, f)) for x in (got, want))
        if f == "ln_ref_pprob":
            np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-13)
        else:
            assert a.tobytes() == b.tobytes(), f


def ksg_against_plain(dev, tile):
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.ops import snv_kernels as snk
    t = [torch.from_numpy(a).to(dev) for a in tile]
    before = snk.LAUNCHES["somatic_grid"]
    got = ss.freq_grid_lhoods(*t)
    assert snk.LAUNCHES["somatic_grid"] == before + (len(tile[4]) > 0)
    want = ss.freq_grid_lhoods_plain(*t)
    torch.cuda.synchronize()
    assert same_bits(got, want)
    return got


@pytest.mark.parametrize("D", [32, 96, 127])
@pytest.mark.parametrize("dtypes", ["i8,i16", "i32,i32"])
def test_ksg_bit_identical_to_plain(cuda, D, dtypes):
    """q = 0 calls, masked lanes, all-masked rows; the native pileup's
    int8/int16 lanes, and the Python pileup's int32 ones, which
    freq_grid_lhoods casts to those widths for KS-G."""
    base, qual, mask, fwd, ref = somatic_tile(np.random.default_rng(D),
                                              3001, D, 0.2)
    if dtypes == "i32,i32":
        base, qual = base.astype(np.int32), qual.astype(np.int32)
    ksg_against_plain(cuda, (base, qual, mask, fwd, ref))


@pytest.mark.parametrize("L", [0, 1, 9])
def test_ksg_tiny_tiles(cuda, L):
    ksg_against_plain(cuda, somatic_tile(np.random.default_rng(L + 1),
                                         L, 40, 0.3))


@pytest.mark.parametrize("D", [32, 64, 96, 127, 200])
@pytest.mark.parametrize("kind", SPARSE_KINDS)
def test_ksg_sparse_and_dense_tiles_bit_identical_to_plain(cuda, kind, D):
    """The CLI's one base quality (every call in one or two histogram
    bins), binned qualities and all 128 slots live: KS-G walks a row's
    live slots only."""
    ksg_against_plain(cuda, sparse_tile(np.random.default_rng(D), 2001, D,
                                        kind))


def ksp_against_plain(dev, n, t):
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.ops import snv_kernels as snk
    nt, tt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (n, t))
    before = snk.LAUNCHES["somatic_posterior"]
    got = ss.somatic_snv_call(nt, tt)
    assert snk.LAUNCHES["somatic_posterior"] == before + (len(n) > 0)
    want = ss.somatic_snv_call_plain(nt, tt)
    torch.cuda.synchronize()
    for f in ss.SomaticSnvResult._fields:
        assert same_bits(getattr(got, f), getattr(want, f)), f
    return got


def grid_pair(dev, rng, L):
    from strelka_tpu_torch.models import somatic_snv as ss
    return [ss.freq_grid_lhoods_plain(*(torch.from_numpy(a).to(dev)
                                        for a in somatic_tile(rng, L, D, f)))
            .cpu().numpy() for D, f in ((32, 0.05), (96, 0.3))]


def test_ksp_bit_identical_to_plain(cuda):
    n, t = grid_pair(cuda, np.random.default_rng(11), 20_000)
    ksp_against_plain(cuda, n, t)


@pytest.mark.parametrize("case", ["normal_all_ninf", "tumor_all_ninf",
                                  "normal_prestrand_ninf", "ties"])
def test_ksp_ninf_rows_and_ties_bit_identical_to_plain(cuda, case):
    n, t = grid_pair(cuda, np.random.default_rng(12), 600)
    rows = slice(0, 200)
    if case == "normal_all_ninf":
        n[rows] = -np.inf
    elif case == "tumor_all_ninf":
        t[rows] = -np.inf
    elif case == "normal_prestrand_ninf":
        n[rows, :21] = -np.inf
    else:      # every state equal: ties in every max, argmax and argmin
        n[rows] = -3.0
        t[rows] = -3.0
        t[200:400] = t[200:400, :1]
    got = ksp_against_plain(cuda, n, t)
    if case.endswith("ninf"):
        assert (got.qphred[:200] == 0).all()


@pytest.mark.parametrize("kinds", [("single", "binned"),
                                   ("binned", "dense"), ("single", "dense")])
def test_ksp_on_sparse_and_dense_lhoods_bit_identical_to_plain(cuda, kinds):
    """The posterior of the sparse and dense tiles' lhoods (normal,
    tumour), with rows of NaN and +inf lhoods, which take every term."""
    from strelka_tpu_torch.models import somatic_snv as ss
    rng = np.random.default_rng(len(kinds[0]) + 7 * len(kinds[1]))
    n, t = (ss.freq_grid_lhoods_plain(*(torch.from_numpy(a).to(cuda)
                                        for a in sparse_tile(rng, 3000, D,
                                                             k)))
            .cpu().numpy() for k, D in zip(kinds, (64, 128)))
    n[10:12, 4] = np.nan
    t[12:14, 7] = np.inf
    ksp_against_plain(cuda, n, t)


@pytest.mark.parametrize("L", [0, 1, 13])
def test_ksp_tiny_tiles(cuda, L):
    n, t = grid_pair(cuda, np.random.default_rng(L + 2), L)
    ksp_against_plain(cuda, n, t)


def test_snv_kernels_on_second_card(cuda):
    """All three kernels on cuda:1 with cuda:0 current equal their runs
    on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.models import somatic_snv as ss
    rng = np.random.default_rng(13)
    h, ref, hap, smis = hist_tile(rng, 1000, 64)
    tiles = [somatic_tile(rng, 1000, 48, f) for f in (0.05, 0.3)]
    out = {}
    for d in (torch.device("cuda", 0), torch.device("cuda", 1)):
        with torch.cuda.device(0):
            t = [torch.from_numpy(a).to(d) for a in (h, ref, hap, smis)]
            g = sd.call_snv_hist_tile(t[0], t[1], t[2], s_mis=t[3])
            lh = [ss.freq_grid_lhoods(*(torch.from_numpy(a).to(d)
                                        for a in x)) for x in tiles]
            p = ss.somatic_snv_call(*lh)
            out[d.index] = [getattr(g, f) for f in sd._PULL] + lh + list(p)
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert all(same_bits(a, b) for a, b in zip(out[0], out[1]))


def test_kgsb_and_kgr_on_second_card(cuda):
    """KG-SB and KG-R on cuda:1 with cuda:0 current equal their runs on
    cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from strelka_tpu_torch.models import snv_digt as sd
    x = xla_tile(np.random.default_rng(19), 1000, 64)
    out = {}
    for d in (torch.device("cuda", 0), torch.device("cuda", 1)):
        with torch.cuda.device(0):
            b, q, f, m, r, hap, dd, g, lt = (torch.from_numpy(a).to(d)
                                             for a in x)
            tile = sd.SnvPileupTile(b, q, f, m, r)
            res = sd.call_snv_tile(tile, 0.001, hap,
                                   het_vf_extension=RNA_EXT,
                                   het_vf_increment=RNA_INC, dep_delta=dd)
            out[d.index] = [getattr(res, k) for k in sd._PULL] + [
                sd.snv_strand_bias_tile(tile, g, lt, dd, e, RNA_INC)
                for e in (0.0, RNA_EXT)]
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert all(same_bits(a, b) for a, b in zip(out[0], out[1]))


def test_snv_paths_launch_the_kernels_not_the_plain_versions(cuda):
    """The germline chunks and the somatic tier1 chunks on the card: one
    kernel launch a tile, strand-bias, grid and posterior tally, no plain
    version."""
    import types

    from strelka_tpu_torch.models import snv_digt as sd
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.ops import snv_kernels as snk
    from strelka_tpu_torch.pipeline import somatic_caller as sc
    rng = np.random.default_rng(14)
    L, D = 5000, 60
    ref = rng.integers(0, 4, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.2, rng.integers(0, 4, (L, D)),
                    ref[:, None]).astype(np.int8)
    tile = sd.SnvPileupTile(
        base_id=base, qual=rng.integers(0, 45, (L, D)).astype(np.uint8),
        is_fwd=rng.random((L, D)) < 0.5, mask=rng.random((L, D)) < 0.8,
        ref_gt=ref)
    pus = [types.SimpleNamespace(
        base_id=base.astype(np.int32), qual=tile.qual.astype(np.int32),
        is_fwd=tile.is_fwd, valid=tile.mask, used=rng.random((L, D)) < 0.9,
        tier2_used=tile.mask) for _ in range(2)]
    snk.reset()
    sd.LAUNCH_STATS.clear()
    ss.LAUNCH_STATS.clear()
    sd.call_snv_tile_chunked(tile, device=cuda)
    sc._snv_tier1_fused(pus, ref, ss.somatic_snv_call_capped, cuda)
    tallies = {k: sum(v for (kind, dev, rows, _), v in stats.items()
                      if kind == k and dev == "cuda" and rows)
               for k, stats in (("tile", sd.LAUNCH_STATS),
                                ("grid", ss.LAUNCH_STATS),
                                ("post", ss.LAUNCH_STATS))}
    sb = sum(v for (kind, dev, rows, _), v in sd.LAUNCH_STATS.items()
             if kind == "sb" and dev == "cuda" and rows)
    assert snk.LAUNCHES == {"snv_hist_tile": 0,
                            "snv_lanes_tile": tallies["tile"],
                            "snv_strand_bias_tile": sb, "snv_rna_tile": 0,
                            "somatic_grid": tallies["grid"],
                            "somatic_posterior": tallies["post"]}
    assert all(tallies.values())
    assert not any(snk.PLAIN_ON_CUDA.values())
