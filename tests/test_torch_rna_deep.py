"""RNA mode's tiles at deep sites: 512, 1024 and 2048 calls a site,
past the 480 where the reduction of XLA's window sums (16 windows of 32
calls and more) had not been held. The JAX pileup pads D to the
region's largest depth and caps nothing (strelka_tpu/pipeline/
pileup.py:189-190), so a deep RNA locus reaches these sums. Each case
holds a few rows bit for bit against the JAX package's XLA tile on the
CPU, as tests/test_torch_rna.py does at up to 300 calls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu_torch.models import snv_digt as tsd
from tests.test_torch_rna import (EXT, HET, INC, INT_FIELDS, LN_REF_RTOL,
                                  bits, rna_tile, t)

DEEP = [512, 1024, 2048]
ROWS = 8


@pytest.mark.parametrize("D", DEEP)
def test_het_vf_extension_lhoods_bit_identical_deep(D):
    """The extension terms, free and with forced-ref keys, with
    dependent-eprob deltas: bit for bit, finite."""
    base, qual, mask, fwd, ref, dd = rna_tile(D, ROWS, D)
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
@pytest.mark.parametrize("D", DEEP)
def test_rna_genotype_tile_bit_identical_deep(D, dep):
    """call_snv_tile with the het-VF extension: lhood bit for bit, every
    integer field equal, ln_ref_pprob within LN_REF_RTOL."""
    base, qual, mask, fwd, ref, dd = rna_tile(100 + D, ROWS, D, dep)
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
@pytest.mark.parametrize("D", DEEP)
def test_strand_bias_tile_bit_identical_deep(D, ext):
    """snv_strand_bias_tile with and without the extension: bit for
    bit, finite."""
    base, qual, mask, fwd, ref, dd = rna_tile(200 + D, ROWS, D)
    rng = np.random.default_rng(D)
    tgt = rng.integers(0, 10, ROWS).astype(np.int32)
    lt = rng.normal(-50, 10, ROWS).astype(np.float32)
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
