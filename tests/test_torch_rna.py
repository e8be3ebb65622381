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
  of 32 calls, the padding split around them, and the window sums
  reduced again by the same rule) and LLVM's vectorized order below 32
  calls (xla_sum_minor, xla_sum_major), held here up to 300 calls and
  in tests/test_torch_rna_deep.py at 512, 1024 and 2048;
- the strand-bias tile at the D the JAX package pads it to (a multiple
  of 32), the genotype tile at any D (tests/test_torch_rna_tiles.py);
- the extension terms of the 6 het genotypes, the only ones the JAX
  package's logsumexp keeps (it computes the hom genotypes' too).

One field is not bit for bit: ln_ref_pprob (f64, the posterior's ln of
the reference genotype) may differ in its last bits (f64 exp and sums of
torch against XLA's), within LN_REF_RTOL; every integer field and lhood
are equal. The region driver is tests/test_torch_rna_chunked.py's, the
CLI, whose VCFs are byte-identical to strelka_tpu's,
tests/test_torch_rna_e2e.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu_torch.models import snv_digt as tsd

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
