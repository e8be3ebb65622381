"""RNA mode's region driver (call_snv_tile_chunked with the het-VF
extension and dependent-eprob deltas) against the JAX package's on the
CPU: every field equal, in one tile and in several chunks. The
tile-level rules are tests/test_torch_rna.py's.
"""
import numpy as np
import pytest

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu_torch.models import snv_digt as tsd
from tests.test_torch_rna import EXT, INC, INT_FIELDS, LN_REF_RTOL, rna_tile


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
