"""The port's SNV genotype tiles (strelka_tpu_torch.models.snv_digt)
against the JAX package's, on the CPU.

- call_snv_hist_tile vs the native CPU path (_call_snv_tile_native,
  the canonical order of native/snvcall.cpp, D <= 127): integer fields
  equal, lhood bit-equal.
- call_snv_hist_tile / call_snv_tile vs the XLA tiles: genotypes
  equal; lhood within LHOOD_ULPS ulp, because XLA sums the
  [L, Q*4] @ [Q*4, 10] product in its blocked matmul order while the
  port (like native/snvcall.cpp) adds one slot at a time. A phred value
  rounded from a lhood that moved by an ulp can flip by one at a
  rounding boundary: phred fields are equal except at most
  PHRED_FLIP_SHARE of entries, each off by one (the bound that
  tests/test_native_snvcall.py holds the native path to against XLA).
- snv_strand_bias_tile vs XLA's within SB_ATOL (it follows XLA's order
  and per-call values since the RNA slice, and tests/test_torch_rna.py
  holds it bit for bit at the D the JAX package pads the tile to).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu_torch.models import snv_digt as tsd

INT_FIELDS = ("genome_max_gt", "poly_max_gt", "snv_qphred",
              "genome_max_gt_qphred", "poly_max_gt_qphred", "phred_loghood")
# XLA's blocked f32 matmul order vs the sequential one: |lhood| <= ~3000
# at these depths, and the sums differ by a few roundings
LHOOD_ULPS = 64
PHRED_FLIP_SHARE = 1e-3
SB_ATOL = 2e-3


def make_tile(seed, L=400, D=64, alt_frac=0.3):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = rng.integers(0, 4, (L, D)).astype(np.int8)
    alt = rng.random((L, D)) < alt_frac
    base = np.where(alt, base, np.minimum(ref, 3)[:, None]).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(np.int32)
    mask = rng.random((L, D)) < 0.85
    fwd = rng.random((L, D)) < 0.5
    hap = rng.random(L) < 0.1
    smis = np.where(rng.random((L, 4)) < 0.05,
                    rng.random((L, 4)) * 0.5, 0.0).astype(np.float32)
    return base, qual, mask, fwd, ref, hap, smis


def hist_of(base, qual, mask):
    h = np.zeros((base.shape[0], jsd._SNV_QTAB_SIZE * 4), np.int8)
    jsd._np_snv_hist(base, qual, mask, h)
    return h


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("with_dep,with_hap", [(False, False), (True, True)])
def test_hist_tile_bit_identical_to_native(with_dep, with_hap):
    base, qual, mask, _fwd, ref, hap, smis = make_tile(1, L=3000)
    hap = hap if with_hap else None
    smis = smis if with_dep else None
    want = jsd._call_snv_tile_native(base, qual, mask, ref, 0.001, hap, smis)
    assert want is not None, "native library unavailable"
    got = tsd.call_snv_hist_tile(
        t(hist_of(base, qual, mask)), t(ref),
        None if hap is None else t(hap), 0.001,
        s_mis=None if smis is None else t(smis))
    np.testing.assert_array_equal(got.lhood.numpy().view(np.int32),
                                  want.lhood.view(np.int32))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    np.testing.assert_allclose(got.ln_ref_pprob.numpy(), want.ln_ref_pprob,
                               rtol=1e-12, atol=0)


def _check_vs_xla(got, want):
    for f in INT_FIELDS:
        a = getattr(got, f).numpy().astype(np.int64)
        b = np.asarray(getattr(want, f)).astype(np.int64)
        if f.endswith("max_gt"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert np.abs(a - b).max() <= 1, f
            assert (a != b).mean() <= PHRED_FLIP_SHARE, f
    assert ulps(got.lhood.numpy(), want.lhood).max() <= LHOOD_ULPS


def test_hist_tile_vs_xla():
    base, qual, mask, _fwd, ref, hap, smis = make_tile(2)
    h = hist_of(base, qual, mask)
    want = jsd.call_snv_hist_tile(jnp.asarray(h), jnp.asarray(ref),
                                  jnp.asarray(hap), 0.001,
                                  s_mis=jnp.asarray(smis))
    got = tsd.call_snv_hist_tile(t(h), t(ref), t(hap), 0.001, s_mis=t(smis))
    _check_vs_xla(got, want)


@pytest.mark.parametrize("D", [64, 160])
def test_call_snv_tile_vs_xla(D):
    """The full-tile entry (taken on the device when D > 127: int32
    counts on the device)."""
    base, qual, mask, fwd, ref, hap, smis = make_tile(3 + D, L=300, D=D)
    jtile = jsd.SnvPileupTile(base_id=jnp.asarray(base),
                              qual=jnp.asarray(qual),
                              is_fwd=jnp.asarray(fwd),
                              mask=jnp.asarray(mask), ref_gt=jnp.asarray(ref))
    want = jsd.call_snv_tile(jtile, 0.001, jnp.asarray(hap),
                             compute_sb=False, dep_smis=jnp.asarray(smis))
    ttile = tsd.SnvPileupTile(base_id=t(base), qual=t(qual), is_fwd=t(fwd),
                              mask=t(mask), ref_gt=t(ref))
    got = tsd.call_snv_tile(ttile, 0.001, t(hap), dep_smis=t(smis))
    _check_vs_xla(got, want)


def test_strand_bias_tile_vs_xla():
    base, qual, mask, fwd, ref, _hap, _smis = make_tile(4, L=256)
    rng = np.random.default_rng(4)
    tgt = rng.integers(0, 10, 256).astype(np.int32)
    lt = (-rng.random(256) * 100).astype(np.float32)
    dd = np.where(rng.random(base.shape) < 0.05,
                  rng.random(base.shape) * 0.3, 0.0).astype(np.float32)
    jtile = jsd.SnvPileupTile(base_id=jnp.asarray(base),
                              qual=jnp.asarray(qual),
                              is_fwd=jnp.asarray(fwd),
                              mask=jnp.asarray(mask), ref_gt=jnp.asarray(ref))
    ttile = tsd.SnvPileupTile(base_id=t(base), qual=t(qual), is_fwd=t(fwd),
                              mask=t(mask), ref_gt=t(ref))
    for dep in (None, dd):
        want = np.asarray(jsd.snv_strand_bias_tile(
            jtile, jnp.asarray(tgt), jnp.asarray(lt),
            None if dep is None else jnp.asarray(dep)))
        got = tsd.snv_strand_bias_tile(ttile, t(tgt), t(lt),
                                       None if dep is None else t(dep))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SB_ATOL)


def test_chunked_matches_jax_on_cpu():
    """Both call_snv_tile_chunked on the CPU take the native genotype pass, then the
    strand-bias tiles on the SNP rows."""
    base, qual, mask, fwd, ref, hap, smis = make_tile(5, L=2000)
    dep = (smis, lambda rows: np.zeros((len(rows), base.shape[1]),
                                       np.float32))
    kw = dict(theta=0.001, is_haploid=hap, dep=dep)
    want = jsd.call_snv_tile_chunked(
        jsd.SnvPileupTile(base, qual, fwd, mask, ref), **kw)
    got = tsd.call_snv_tile_chunked(
        tsd.SnvPileupTile(base, qual, fwd, mask, ref), device="cpu", **kw)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (np.asarray(want.snv_qphred) != 0).sum() > 100
    np.testing.assert_allclose(got.strand_bias, want.strand_bias, rtol=0,
                               atol=SB_ATOL)


def test_chunked_torch_tiles_match_native_path():
    """The torch tile path of call_snv_tile_chunked (what runs on the
    card) gives the native CPU path's genotype fields and bits, here on
    the CPU."""
    base, qual, mask, fwd, ref, hap, smis = make_tile(6, L=1500)
    dep = (smis, lambda rows: np.zeros((len(rows), base.shape[1]),
                                       np.float32))
    tile = tsd.SnvPileupTile(base, qual, fwd, mask, ref)
    want = tsd.call_snv_tile_chunked(tile, 0.001, hap, dep=dep,
                                     device="cpu")
    before = sum(tsd.LAUNCH_STATS.values())
    got = tsd._genotype_chunks(torch.device("cpu"), base, qual, mask, ref,
                               hap, smis, 0.001)
    assert sum(tsd.LAUNCH_STATS.values()) == before + 1
    np.testing.assert_array_equal(got.lhood.view(np.int32),
                                  want.lhood.view(np.int32))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)

