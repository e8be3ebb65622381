"""RNA mode of the port (germline --rna: the het-VF extension of the SNV
genotype tiles) against the JAX package, on the CPU.

With het_vf_extension > 0 the JAX package skips the native SNV path and
runs its XLA tiles on the CPU (strelka_tpu/models/snv_digt.py:707-727),
so the port follows XLA's CPU arithmetic there, and every comparison
below is bit for bit:

- the per-call values (_call_vals, the het-VF table): XLA multiplies by
  the reciprocal of 10, folds (1/3) * cr, fuses the sums, and its log is
  Cephes' polynomial (_xla_log_f32);
- the logsumexp of the het-VF terms: XLA's Cephes exp and log
  (_xla_exp_f32, _xla_log_f32), its terms in order;
- the sums over a tile's calls: XLA's tree-reduction rewrite (windows
  of 32 calls, the padding split around them) and LLVM's vectorized
  order below 32 calls (xla_sum_minor, xla_sum_major), held here up to
  300 calls (past 480, 16 windows and more, the rule was not held);
- the strand-bias tile at the D the JAX package pads it to (a multiple
  of 32), the genotype tile at any D;
- the extension terms of the 6 het genotypes, the only ones the JAX
  package's logsumexp keeps (it computes the hom genotypes' too).

One field is not bit for bit: ln_ref_pprob (f64, the posterior's ln of
the reference genotype) may differ in its last bits (f64 exp and sums of
torch against XLA's), within LN_REF_RTOL; every integer field and lhood
are equal. End to end, the VCFs of --rna --disable-evs and of --rna
with RNAseq forests trained here are byte-identical to strelka_tpu's.
"""
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu.workflow.germline import run_germline as jax_germline
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.models import snv_digt as tsd
from tests.test_torch_germline_e2e import DROP, OUTPUTS, dataset  # noqa: F401
from tests.test_torch_germline_evs import (GERMLINE_INDEL_FEATURES,
                                           GERMLINE_SNV_FEATURES,
                                           train_model)

EXT, INC = 0.45, 0.0501     # RNA mode's extension, the default increment
INT_FIELDS = ("genome_max_gt", "poly_max_gt", "snv_qphred",
              "genome_max_gt_qphred", "poly_max_gt_qphred", "phred_loghood")
LN_REF_RTOL = 1e-13
# the het genotypes' columns: the only ones the extension changes (the
# port computes no others)
HET = slice(4, 10)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def rna_tile(seed, L, D, dep=True):
    """A seeded tile: bases -1..4 (mostly the reference), qscores 0..44
    with the last 3 calls of each row at q=0, 85% used, strands at
    random, dependent-eprob deltas on 10% of the calls."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = rng.integers(-1, 5, (L, D))
    keep = rng.random((L, D)) < 0.6
    base = np.where(keep, np.minimum(ref, 3)[:, None], base).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(np.int32)
    qual[:, -3:] = 0
    mask = rng.random((L, D)) < 0.85
    fwd = rng.random((L, D)) < 0.5
    dd = None
    if dep:
        dd = np.where(rng.random((L, D)) < 0.1,
                      -rng.random((L, D)), 0.0).astype(np.float32)
    return base, qual, mask, fwd, ref, dd


# --- XLA's functions --------------------------------------------------------

def test_xla_log_and_exp_bit_identical_to_jnp():
    """_xla_log_f32 on normal positive f32 and _xla_exp_f32 on [-87.3,
    88.7] equal XLA's jnp.log and jnp.exp on the CPU bit for bit."""
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.random(100_000) * 20,
                        np.exp(rng.normal(0, 20, 100_000)),
                        np.arange(1, 20)]).astype(np.float32)
    y = y[(y >= np.finfo(np.float32).tiny) & np.isfinite(y)]
    assert (bits(tsd._xla_log_f32(t(y))) ==
            bits(jax.jit(jnp.log)(y))).all()
    x = np.concatenate([rng.random(100_000) * -87.3,
                        rng.random(50_000) * 88.7, [0.0]]).astype(np.float32)
    assert (bits(tsd._xla_exp_f32(t(x))) ==
            bits(jax.jit(jnp.exp)(x))).all()


def test_per_call_value_tables_bit_identical():
    """_call_vals and the het-VF extension's per-call values equal the
    JAX package's for every qscore 0..255 (the het-VF values read one
    call a row, so no sum is involved)."""
    q = np.arange(256, dtype=np.int32)
    want = np.asarray(jax.jit(jsd._call_vals)(q[None]))[0]
    assert (bits(tsd._call_vals(t(q))) == bits(want)).all()
    qv = np.repeat(q, 4)[:, None]
    bv = np.tile(np.arange(4), 256)[:, None].astype(np.int32)
    one = np.ones_like(bv, dtype=bool)
    fn = jax.jit(jsd._het_vf_extension_lhoods, static_argnums=(3, 4))
    jterms, n_sub = fn(bv, qv, one, EXT, INC)
    got = tsd._het_vf_extension_lhoods(t(bv), t(qv), t(one), EXT, INC)
    assert n_sub == got.shape[0] + 1
    assert (bits(got) == bits(np.asarray(jterms)[..., HET])).all()


# --- the tiles --------------------------------------------------------------

DEPTHS = [5, 13, 20, 31, 32, 33, 50, 64, 100, 200, 300]


@pytest.mark.parametrize("D", DEPTHS)
def test_het_vf_extension_lhoods_bit_identical(D):
    """The extension terms, free and with forced-ref keys (the strand
    recomputation) and dependent-eprob deltas, equal JAX's bit for bit;
    q=0 entries under forced-ref keys stay finite (the eprob floor)."""
    base, qual, mask, fwd, ref, dd = rna_tile(D, 64, D)
    rc = np.minimum(ref, 3)
    fn = jax.jit(jsd._het_vf_extension_lhoods, static_argnums=(3, 4))
    for force in (None, ~fwd):
        kw = {} if force is None else dict(force_ref=force, ref_gt=rc)
        want, _ = fn(base.astype(np.int32), qual, mask, EXT, INC,
                     dep_delta=dd, **kw)
        tkw = ({} if force is None else
               dict(force_ref=t(force), ref_clamped=t(rc).long()))
        got = tsd._het_vf_extension_lhoods(t(base), t(qual), t(mask), EXT,
                                           INC, dep_delta=t(dd), **tkw)
        assert torch.isfinite(got).all()
        assert (bits(got) == bits(np.asarray(want)[..., HET])).all()


@pytest.mark.parametrize("dep", [False, True])
@pytest.mark.parametrize("D", DEPTHS)
def test_rna_genotype_tile_bit_identical(D, dep):
    """call_snv_tile with the het-VF extension: lhood bit for bit and
    every integer field equal to JAX's call_snv_tile (compute_sb=False,
    as call_snv_tile_chunked calls it), ln_ref_pprob within
    LN_REF_RTOL."""
    base, qual, mask, fwd, ref, dd = rna_tile(100 + D, 300, D, dep)
    jt = jsd.SnvPileupTile(jnp.asarray(base), jnp.asarray(qual),
                           jnp.asarray(fwd), jnp.asarray(mask),
                           jnp.asarray(ref))
    want = jsd.call_snv_tile(jt, 0.001, None, EXT, INC, False,
                             None if dd is None else jnp.asarray(dd))
    got = tsd.call_snv_tile(
        tsd.SnvPileupTile(t(base), t(qual), t(fwd), t(mask), t(ref)),
        0.001, None, het_vf_extension=EXT, het_vf_increment=INC,
        dep_delta=None if dd is None else t(dd))
    assert (bits(got.lhood) == bits(want.lhood)).all()
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.ln_ref_pprob.numpy(),
                               np.asarray(want.ln_ref_pprob),
                               rtol=LN_REF_RTOL, atol=0)


@pytest.mark.parametrize("ext", [0.0, EXT])
@pytest.mark.parametrize("D", [32, 64, 96])
def test_strand_bias_tile_bit_identical(D, ext):
    """snv_strand_bias_tile at the D the JAX package pads it to, with
    and without the extension, bases -1..4, q=0 calls under forced-ref
    keys and dependent-eprob deltas: bit for bit, finite."""
    base, qual, mask, fwd, ref, dd = rna_tile(200 + D, 512, D)
    rng = np.random.default_rng(D)
    tgt = rng.integers(0, 10, 512).astype(np.int32)
    lt = rng.normal(-50, 10, 512).astype(np.float32)
    jt = jsd.SnvPileupTile(jnp.asarray(base), jnp.asarray(qual),
                           jnp.asarray(fwd), jnp.asarray(mask),
                           jnp.asarray(ref))
    want = jsd.snv_strand_bias_tile(jt, jnp.asarray(tgt), jnp.asarray(lt),
                                    jnp.asarray(dd), ext, INC)
    got = tsd.snv_strand_bias_tile(
        tsd.SnvPileupTile(t(base), t(qual), t(fwd), t(mask), t(ref)),
        t(tgt), t(lt), t(dd), ext, INC)
    assert torch.isfinite(got).all()
    assert (bits(got) == bits(want)).all()


@pytest.mark.parametrize("L,D,tile_l", [(700, 20, None), (700, 45, None),
                                        (700, 20, 256), (700, 90, 256)])
def test_chunked_rna_matches_jax(monkeypatch, L, D, tile_l):
    """call_snv_tile_chunked in RNA mode with dependent-eprob deltas:
    every field equal to the JAX package's (strand bias bit for bit,
    ln_ref_pprob within LN_REF_RTOL), a region of one tile and, with
    SNV_TILE_L cut to 256 in both packages, one of several chunks, whose
    D the JAX package pads to a multiple of 32."""
    if tile_l:
        monkeypatch.setattr(jsd, "SNV_TILE_L", tile_l)
        monkeypatch.setattr(tsd, "SNV_TILE_L", tile_l)
    base, qual, mask, fwd, ref, _ = rna_tile(300 + D, L, D, dep=False)
    base = np.clip(base, 0, 3).astype(np.int8)
    qual = qual.astype(np.uint8)
    nb = np.random.default_rng(D).random((L, D)) < 0.3
    jdep = jsd.dependent_eprob_deltas(base, qual, mask, fwd, nb, 0.96, 0.85)
    tdep = tsd.dependent_eprob_deltas(base, qual, mask, fwd, nb, 0.96, 0.85)
    want = jsd.call_snv_tile_chunked(
        jsd.SnvPileupTile(base, qual, fwd, mask, ref), 0.001, None, EXT, INC,
        dep=jdep)
    got = tsd.call_snv_tile_chunked(
        tsd.SnvPileupTile(base, qual, fwd, mask, ref), 0.001, None, EXT, INC,
        dep=tdep, device="cpu")
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.strand_bias, want.strand_bias)
    assert (got.snv_qphred != 0).any()     # the strand-bias pass ran
    np.testing.assert_allclose(got.ln_ref_pprob, want.ln_ref_pprob,
                               rtol=LN_REF_RTOL, atol=0)


# --- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def rna_models(tmp_path_factory):
    """RNAseq SNV and indel forests over the germline feature names, in
    a directory laid out as $STRELKA_TPU_MODEL_DIR expects."""
    d = tmp_path_factory.mktemp("rna_models")
    return (d, train_model(d / "RNASNVScoringModels.json",
                           GERMLINE_SNV_FEATURES, "SNV", "RNAseq", 21, 3, 40),
            train_model(d / "RNAIndelScoringModels.json",
                        GERMLINE_INDEL_FEATURES, "INDEL", "RNAseq", 22, 8,
                        30))


def lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


def run_both(dataset, tag, extra, env=None, monkeypatch=None):
    d, fa, bam = dataset
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    jout, tout = str(d / f"jax_{tag}"), str(d / f"torch_{tag}")
    assert jax_germline(["--reference", fa, "--align-file", bam,
                         "--output-dir", jout, *extra]) in (0, None)
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", tout, "--device", "cpu",
                       *extra]) == 0
    for name in OUTPUTS:
        assert lines(jout, name) == lines(tout, name), name
    return tout


def test_rna_disable_evs_byte_identical_to_jax(dataset):
    """--rna --disable-evs: the VCFs equal the JAX package's, and the
    extension moved them against the run without --rna."""
    tout = run_both(dataset, "rna_noevs", ["--rna", "--disable-evs"])
    d, fa, bam = dataset
    plain = str(d / "torch_rna_plain")
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", plain, "--device", "cpu"]) == 0
    assert lines(plain, "genome.S1.vcf.gz") != lines(tout, "genome.S1.vcf.gz")


def test_rna_with_forests_byte_identical_to_jax(dataset, rna_models,
                                                monkeypatch):
    """--rna with RNAseq forests, from the flags and from
    $STRELKA_TPU_MODEL_DIR: the VCFs equal the JAX package's."""
    d, snv, indel = rna_models
    run_both(dataset, "rna_flags", ["--rna", "--snv-scoring-model-file", snv,
                                    "--indel-scoring-model-file", indel])
    run_both(dataset, "rna_envdir", ["--rna"],
             env={"STRELKA_TPU_MODEL_DIR": str(d)}, monkeypatch=monkeypatch)


def test_rna_without_models_is_an_error(dataset, monkeypatch, capsys):
    """--rna without models and without --disable-evs stops with the
    JAX package's message."""
    d, fa, bam = dataset
    monkeypatch.delenv("STRELKA_TPU_MODEL_DIR", raising=False)
    with pytest.raises(SystemExit):
        torch_main(["germline", "--reference", fa, "--align-file", bam,
                    "--output-dir", str(d / "rna_err"), "--device", "cpu",
                    "--rna"])
    assert "--rna requires an SNV EVS model" in capsys.readouterr().err
