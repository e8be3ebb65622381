"""RNA mode's genotype tile (call_snv_tile with the het-VF extension)
against the JAX package's XLA tile on the CPU, bit for bit, at depths up
to 300 calls. The rules the port follows, and the helpers, are
tests/test_torch_rna.py's; depths past 300 are in
tests/test_torch_rna_deep.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu_torch.models import snv_digt as tsd
from tests.test_torch_rna import (DEPTHS, EXT, INC, INT_FIELDS, LN_REF_RTOL,
                                  bits, rna_tile, t)


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
