"""The port's read x haplotype scorer (strelka_tpu_torch.ops) against the
JAX package's, on the CPU.

The plain torch exact_best_offsets must be BIT-IDENTICAL — scores and
first-max argmax offsets — to pallas_readlik.exact_best_offsets and to
the Pallas kernel in interpret mode: the quantized-limb formulation is
exact by construction, so the tolerance is zero. Mirrors
tests/test_pallas_kernel.py. The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strelka_tpu.ops import pallas_readlik as pk
from strelka_tpu.ops import readlik as rl
from strelka_tpu_torch.ops import readlik as trl
from strelka_tpu_torch.ops import score_kernel as sk


def make_inputs(rng, B=4, R=16, L=128, W=128):
    """numpy inputs; codes include 4 under non-zero deltas."""
    delta_lut, lmis_lut = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    delta = delta_lut[q]
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    lnmis = np.where(codes < 4, lmis_lut[q], 0.0).sum(axis=2).astype(
        np.float32)
    win_t = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    return codes, delta, lnmis, win_t


def port(codes, delta, lnmis, win_t):
    b, o = sk.exact_best_offsets(*(torch.from_numpy(np.asarray(a))
                                   for a in (codes, delta, lnmis, win_t)))
    return b.numpy(), o.numpy()


def jax_oracle(codes, delta, lnmis, win_t):
    b, o = pk.exact_best_offsets(*(jnp.asarray(a)
                                   for a in (codes, delta, lnmis, win_t)))
    return np.asarray(b), np.asarray(o)


def jax_interpret(codes, delta, lnmis, win_t):
    b, o = pk.score_best_offsets(*(jnp.asarray(a)
                                   for a in (codes, delta, lnmis, win_t)),
                                 interpret=True, mode="exact")
    return np.asarray(b), np.asarray(o)


def assert_same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == np.float32 and b[0].dtype == np.float32


@pytest.mark.parametrize("B,R,L,W", [
    (4, 32, 128, 128), (2, 128, 160, 256), (2, 512, 64, 64),
    (3, 32, 96, 320), (2, 128, 32, 192)])
def test_plain_bit_identical_to_xla_oracle(B, R, L, W):
    inp = make_inputs(np.random.default_rng(B * R + L + W), B, R, L, W)
    assert_same(port(*inp), jax_oracle(*inp))


@pytest.mark.parametrize("B,R,L,W", [
    (2, 32, 64, 64), (1, 128, 96, 128), (1, 512, 32, 64)])
def test_plain_bit_identical_to_interpret_kernel(B, R, L, W):
    inp = make_inputs(np.random.default_rng(R + W), B, R, L, W)
    assert_same(port(*inp), jax_interpret(*inp))


def test_near_ties_and_exact_ties():
    """Windows that tie exactly (the read tiled, so many offsets tie)
    and near-ties a single q=2 base apart: exact ties resolve to the
    first offset on every path, near-ties never flip."""
    rng = np.random.default_rng(7)
    B, R, L, W = 8, 32, 128, 128
    delta_lut, lmis_lut = rl.quantized_qscore_luts()
    read = rng.integers(0, 4, (L,))
    q = np.full((B, R, L), 2)
    codes = np.broadcast_to(read, (B, R, L)).astype(np.int8).copy()
    hp = np.tile(read, 3)
    win_t = np.stack([hp[l:l + W] for l in range(L)], axis=0)
    win_t = np.broadcast_to(win_t, (B, L, W)).astype(np.int8).copy()
    for b in range(B):
        l = int(rng.integers(0, L))
        win_t[b, l, 37] = (win_t[b, l, 37] + 1) % 4
    delta = delta_lut[q]
    lnmis = lmis_lut[q].sum(axis=2).astype(np.float32)
    inp = (codes, delta, lnmis, win_t)
    got = port(*inp)
    assert_same(got, jax_oracle(*inp))
    assert_same(got, jax_interpret(*inp))
    assert int(got[1].min()) == 0


def test_code4_matches_nothing():
    """A read code of 4 scores nothing, even against a window code of 4
    and under a non-zero delta: all-4 reads score exactly lnmis."""
    rng = np.random.default_rng(3)
    codes, delta, lnmis, win_t = make_inputs(rng, B=2, R=32, L=64, W=64)
    codes[0] = 4
    win_t[0, :, :7] = 4
    assert (delta[0] > 0).all()
    got = port(codes, delta, lnmis, win_t)
    assert_same(got, jax_oracle(codes, delta, lnmis, win_t))
    np.testing.assert_array_equal(got[0][0], lnmis[0])
    np.testing.assert_array_equal(got[1][0], 0)


def test_scores_independent_of_cobatched_rows():
    rng = np.random.default_rng(3)
    codes, delta, lnmis, win_t = make_inputs(rng, B=8)
    b_all = port(codes, delta, lnmis, win_t)
    b_one = port(codes[:1], delta[:1], lnmis[:1], win_t[:1])
    np.testing.assert_array_equal(b_all[0][0], b_one[0][0])
    np.testing.assert_array_equal(b_all[1][0], b_one[1][0])


def test_wrapper_on_cpu_runs_plain_version():
    inp = make_inputs(np.random.default_rng(5), B=2, R=32, L=64, W=128)
    before = sk.LAUNCHES
    b, o = sk.score_best_offsets(*(torch.from_numpy(a) for a in inp))
    assert sk.LAUNCHES == before  # no kernel launch on the CPU
    assert o.dtype == torch.int32
    assert_same((b.numpy(), o.numpy()), port(*inp))


def test_luts_and_limbs_copied_exactly():
    for a, b in zip(trl.quantized_qscore_luts(), rl.quantized_qscore_luts()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert trl.LIMBS == rl.LIMBS
    assert trl.QUANT_BITS == rl.QUANT_BITS
    assert trl.QUANT_SCALE == rl.QUANT_SCALE and trl.QUANT_INV == rl.QUANT_INV


def _locus(rng, R, L, W):
    Lh = L + W - 1
    seqs = rng.integers(0, 5, (R, L)).astype(np.uint8)
    quals = rng.integers(2, 42, (R, L)).astype(np.int32)
    mask = np.ones((R, L), dtype=bool)
    mask[:, L - 5:] = rng.random((R, 5)) < 0.5
    haps = rng.integers(0, 5, (3, Lh)).astype(np.uint8)
    return seqs, quals, mask, haps


@pytest.mark.parametrize("R,L,W", [(8, 64, 33), (32, 96, 65)])
def test_score_all_offsets_bit_identical_to_jax(R, L, W):
    seqs, quals, mask, haps = _locus(np.random.default_rng(R + L), R, L, W)
    jt = rl.build_read_tile(seqs, quals, mask)
    tt = trl.build_read_tile(seqs, quals, mask, device="cpu")
    np.testing.assert_array_equal(np.asarray(jt.delta), tt.delta.numpy())
    np.testing.assert_array_equal(np.asarray(jt.lnmis_sum),
                                  tt.lnmis_sum.numpy())
    np.testing.assert_array_equal(np.asarray(jt.n_valid), tt.n_valid)
    np.testing.assert_array_equal(np.asarray(jt.read_len), tt.read_len)
    oh = rl.build_hap_onehot(haps)
    np.testing.assert_array_equal(oh, trl.build_hap_onehot(haps))
    js = np.asarray(rl.score_all_offsets(jt.delta, jt.lnmis_sum,
                                         jnp.asarray(oh)))
    ts = trl.score_all_offsets(tt.delta, tt.lnmis_sum,
                               torch.from_numpy(oh)).numpy()
    np.testing.assert_array_equal(js, ts)
    jb, jo = rl.score_reads_vs_haps(jt, oh)
    tb, to = trl.score_reads_vs_haps(tt, oh)
    np.testing.assert_array_equal(np.asarray(jb), tb)
    np.testing.assert_array_equal(np.asarray(jo), to)


def test_per_locus_path_bit_identical_to_batched():
    """The port's per-locus scoring equals its batched plain scorer for
    matching window geometry (as the JAX package's two paths do)."""
    rng = np.random.default_rng(11)
    R, L, W = 8, 64, 33
    seqs, quals, mask, haps = _locus(rng, R, L, W)
    mask[:] = True
    hap = haps[:1]
    delta_lut, lmis_lut = trl.quantized_qscore_luts()
    tile = trl.build_read_tile(seqs, quals, mask, device="cpu")
    best, off = trl.score_reads_vs_haps(tile, trl.build_hap_onehot(hap))
    codes = seqs[None].astype(np.int8)
    delta = np.where(seqs < 4, delta_lut[quals], 0.0).astype(np.float32)[None]
    lnmis = np.where(seqs < 4, lmis_lut[quals], 0.0).sum(axis=1).astype(
        np.float32)[None]
    win_t = np.stack([hap[0][l:l + W] for l in range(L)], axis=0)[None]
    bb, bo = port(codes, delta, lnmis, win_t.astype(np.int8))
    np.testing.assert_array_equal(best[:, 0], bb[0])
    np.testing.assert_array_equal(off[:, 0], bo[0])


# --- K1-h: mode="highest" (pallas_readlik.py:139-180) ----------------------

HIGHEST_ATOL = 1e-4   # test_pallas_kernel.py:107-108


def highest_inputs(rng, B, R, L, W, quantized):
    """mode="highest" takes any f32 delta: the quantized LUT's, or
    unquantized values in the LUT's range (whose f32 sums round)."""
    codes, delta, lnmis, win_t = make_inputs(rng, B, R, L, W)
    if not quantized:
        delta = rng.uniform(0.5, 9.5, delta.shape).astype(np.float32)
    return codes, delta, lnmis, win_t


def port_highest(codes, delta, lnmis, win_t):
    b, o = sk.reference_best_offsets(*(torch.from_numpy(np.asarray(a))
                                       for a in (codes, delta, lnmis, win_t)))
    return b.numpy(), o.numpy()


def jax_highest_reference(codes, delta, lnmis, win_t):
    b, o = pk.reference_best_offsets(*(jnp.asarray(a)
                                       for a in (codes, delta, lnmis, win_t)))
    return np.asarray(b), np.asarray(o)


def jax_highest_interpret(codes, delta, lnmis, win_t):
    b, o = pk.score_best_offsets(*(jnp.asarray(a)
                                   for a in (codes, delta, lnmis, win_t)),
                                 interpret=True, mode="highest")
    return np.asarray(b), np.asarray(o)


def near_tie_rows(codes, delta, lnmis, win_t):
    """[B, R] bool: the top two scores (f64) lie within HIGHEST_ATOL, so
    an f32 sum in another order may pick either offset."""
    oh_r = (codes[..., None] == np.arange(4)) * delta[..., None].astype(
        np.float64)
    oh_w = (win_t[..., None] == np.arange(4)).astype(np.float64)
    s = np.einsum("brlc,blwc->brw", oh_r, oh_w) + lnmis[..., None]
    s = np.sort(s, axis=-1)
    return (s[..., -1] - s[..., -2]) <= HIGHEST_ATOL


def assert_highest_close(got, want, inp):
    """Scores within HIGHEST_ATOL; offsets equal outside near-ties.
    Returns the number of near-tie rows whose offsets differ."""
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=HIGHEST_ATOL)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    differ = got[1] != want[1]
    near = near_tie_rows(*inp)
    assert not (differ & ~near).any()
    return int((differ & near).sum())


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B,R,L,W", [(4, 32, 128, 128), (2, 128, 160, 256),
                                     (3, 40, 100, 70)])
def test_highest_plain_matches_jax_reference(B, R, L, W, quantized):
    inp = highest_inputs(np.random.default_rng(B + R + L + W), B, R, L, W,
                         quantized)
    flips = assert_highest_close(port_highest(*inp),
                                 jax_highest_reference(*inp), inp)
    assert flips <= B * R // 100


@pytest.mark.parametrize("quantized", [True, False])
def test_highest_plain_matches_interpret_kernel(quantized):
    inp = highest_inputs(np.random.default_rng(17), 2, 32, 64, 128,
                         quantized)
    assert_highest_close(port_highest(*inp), jax_highest_interpret(*inp),
                         inp)


def test_highest_quantized_deltas_are_exact():
    """With the quantized LUT's deltas every partial sum is a multiple
    of 2^-11 below 2^13, so the f32 sums are exact in any order: the
    highest path then equals the JAX reference bit for bit."""
    inp = highest_inputs(np.random.default_rng(4), 4, 32, 128, 128, True)
    assert_same(port_highest(*inp), jax_highest_reference(*inp))


def test_highest_ties_and_code4():
    """Exact ties (the read tiled across the window) resolve to the
    first offset; a code of 4 on either side matches nothing."""
    rng = np.random.default_rng(9)
    B, R, L, W = 4, 32, 64, 192
    read = rng.integers(0, 4, (L,))
    codes = np.broadcast_to(read, (B, R, L)).astype(np.int8).copy()
    hp = np.tile(read, (W + L) // L + 1)
    win_t = np.stack([hp[l:l + W] for l in range(L)], axis=0)
    win_t = np.broadcast_to(win_t, (B, L, W)).astype(np.int8).copy()
    delta_lut, lmis_lut = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    delta = delta_lut[q]
    lnmis = lmis_lut[q].sum(axis=2).astype(np.float32)
    codes[1, :, :5] = 4
    win_t[1, :5, :] = 4
    codes[2] = 4                      # all-4 reads score exactly lnmis
    inp = (codes, delta, lnmis, win_t)
    got = port_highest(*inp)
    for want in (jax_highest_reference(*inp), jax_highest_interpret(*inp)):
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=HIGHEST_ATOL)
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][2], lnmis[2])
    np.testing.assert_array_equal(got[1][2], 0)
    assert int(got[1][0].max()) == 0  # ties at w and w+L: the first


def test_wrapper_highest_on_cpu_runs_plain_version():
    inp = highest_inputs(np.random.default_rng(6), 2, 32, 64, 128, False)
    before = (sk.LAUNCHES, sk.LAUNCHES_HIGHEST)
    b, o = sk.score_best_offsets(*(torch.from_numpy(a) for a in inp),
                                 mode="highest")
    assert (sk.LAUNCHES, sk.LAUNCHES_HIGHEST) == before
    assert_same((b.numpy(), o.numpy()), port_highest(*inp))
    with pytest.raises(ValueError):
        sk.score_best_offsets(*(torch.from_numpy(a) for a in inp),
                              mode="fast")
