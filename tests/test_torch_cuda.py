"""Tests of the port that need the card: the CUDA kernels (K1 in both
modes and the K1-x variants) against their plain versions, the SNV
tiles and the somatic SNV model on the card against the CPU path, and
the germline and somatic CLIs with --device cuda against --device cpu.
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
                                     (1, 32, 512, 64)])
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
    with pytest.raises(ValueError):
        sk.score_best_offsets(c.to(torch.int32), d, m, w)
    with pytest.raises(ValueError):  # not contiguous
        sk.score_best_offsets(c, d, m, w.transpose(1, 2))
    with pytest.raises(ValueError):  # window rows do not match L
        sk.score_best_offsets(c, d, m, w[:, :32].contiguous())
    with pytest.raises(ValueError):
        sk.score_best_offsets(c, d.cpu(), m, w)


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


def test_germline_cli_cuda_matches_cpu(cuda, tmp_path):
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
                     "--output-dir", out, "--device", dev]) == 0
        outs[dev] = out
    assert sk.LAUNCHES > before
    for name in ("variants.vcf.gz", "genome.S1.vcf.gz"):
        recs = []
        for dev in ("cuda", "cpu"):
            with gzip.open(os.path.join(outs[dev], name), "rt") as f:
                recs.append([l for l in f if not l.startswith("#")])
        assert recs[0] == recs[1], name


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

KX_KINDS = ("packed", "packed_fold", "onesum", "hap", "int8", "noA", "noW",
            "nomax", "nodot")


@pytest.mark.parametrize("kind", KX_KINDS)
@pytest.mark.parametrize("B,R,L,W", [(16, 128, 160, 256), (3, 40, 100, 70)])
def test_kx_kernel_bit_identical_to_plain(cuda, kind, B, R, L, W):
    """Each K1-x kernel (ops/score_variants.KERNELS) equals its plain
    version bit for bit, with pair 0's reads all code 4 under non-zero
    deltas (K1's functions then score exactly lnmis there)."""
    from strelka_tpu_torch.ops import score_variants as sv
    k = sv.KERNELS[kind]
    Wt = 2 * W if kind == "hap" else W
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
    if kind not in ("noA", "nodot"):
        assert torch.equal(got[0][0].reshape(R, -1)[:, 0], t[2][0])


def test_kx_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from strelka_tpu_torch.ops import score_variants as sv
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
    with pytest.raises(ValueError):
        sv.score_packed(p.to(torch.int64), m, w)
    with pytest.raises(ValueError):
        sv.score_packed(p[:, :, ::2], m, w[:, ::2])
    with pytest.raises(ValueError):
        sv.score_packed(p, m.cpu(), w)
    with pytest.raises(ValueError):  # folded rows need the read count
        sv.score_packed(sv.pack_operands(c, d, m, fold_lnmis=True), None, w)
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
    from strelka_tpu_torch.ops import score_variants as sv
    names = ["base", "fused", "fusedin", "fusedlm", "limb2k", "hap2",
             "int8", "limb2-noA", "limb2-noW", "limb2-nomax", "limb2-nodot"]
    assert sv.main([*names, "--B", "64", "--R", "128"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(names)
    assert all("body_exact=True" in l for l in lines)
    assert all(" exact=True" in l for l in lines[:6])
