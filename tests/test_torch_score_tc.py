"""The integer formulation of the tensor-core K1
(strelka_tpu_torch/csrc/score_best_offsets_tc.cu) against the JAX
package, on the CPU.

The kernel cannot run here, so this file models its arithmetic in numpy
and holds the model to pallas_readlik.exact_best_offsets and to the
port's plain exact_best_offsets:

- u8 limbs of d_int = int(delta * 2^11) times the one-hot of the window
  along a 4L contraction axis, summed exactly (int64 here, s32 on the
  card);
- the two limbs combined in int32, S = S1 * 256 + S0;
- one f32 conversion, RN(S), then * 2^-11 + lnmis in f32;
- the first max per N tile of score_kernel.TC_N_TILE offsets, merged in
  ascending tiles with a strict >.

The identity is exact, bit for bit in scores and offsets, not a
tolerance: RN(S) equals the reference's RN(RN(f32(S1) * 256) + f32(S0))
for every S < 2^31, as f32(S1) * 256 is exact. The L = 1816 case puts S
above 2^24, where both forms really round.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strelka_tpu.ops import pallas_readlik as pk
from strelka_tpu.ops import readlik as rl
from strelka_tpu_torch.ops import score_kernel as sk

N_TILE = sk.TC_N_TILE
MAX_LEN = 1816      # the largest L the kernel takes


def onehot_product_sums(codes, delta, win_t):
    """(S1, S0) int64 [B,R,W]: the u8 limbs times the window's one-hot
    along k = 4l + c; a code outside 0..3 is a zero column or row."""
    d = (delta.astype(np.float32) * np.float32(2048)).astype(np.int32)
    c = codes.astype(np.int64)
    oh_r = (c[..., None] == np.arange(4))                      # [B,R,L,4]
    oh_w = (win_t.astype(np.int64)[..., None] == np.arange(4))  # [B,L,W,4]
    B, L, W = win_t.shape
    bw = oh_w.transpose(0, 1, 3, 2).reshape(B, 4 * L, W).astype(np.int64)
    sums = []
    for limb in ((d >> 8) & 255, d & 255):
        a = np.where(oh_r, limb[..., None].astype(np.int64), 0)
        assert a.min() >= 0 and a.max() <= 255          # u8 operands
        sums.append(np.matmul(a.reshape(B, -1, 4 * L), bw))
    return sums


def tc_model(codes, delta, lnmis, win_t, n_tile=N_TILE):
    """The kernel's arithmetic: int32 combine, one f32 conversion, the
    first max per N tile merged in ascending tiles."""
    s1, s0 = onehot_product_sums(codes, delta, win_t)
    S = s1 * 256 + s0
    assert S.max() < 2 ** 31
    s = S.astype(np.int32).astype(np.float32)
    s = s * np.float32(1.0 / 2048.0) + lnmis[..., None]
    assert s.dtype == np.float32
    W = s.shape[-1]
    best = np.full(s.shape[:2], -np.inf, np.float32)
    off = np.full(s.shape[:2], np.iinfo(np.int32).max, np.int32)
    for w0 in range(0, W, n_tile):
        tile = s[..., w0:w0 + n_tile]
        tb, to = tile.max(axis=-1), tile.argmax(axis=-1) + w0   # first max
        take = tb > best                                     # strict
        best = np.where(take, tb, best)
        off = np.where(take, to, off).astype(np.int32)
    return best, off


def jax_oracle(*inp):
    b, o = pk.exact_best_offsets(*(jnp.asarray(a) for a in inp))
    return np.asarray(b), np.asarray(o)


def port_plain(*inp):
    b, o = sk.exact_best_offsets(*(torch.from_numpy(np.asarray(a))
                                   for a in inp))
    return b.numpy(), o.numpy()


def assert_bits(got, want):
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


def check(inp):
    got = tc_model(*inp)
    assert_bits(got, jax_oracle(*inp))
    assert_bits(got, port_plain(*inp))
    return got


def random_inputs(rng, B, R, L, W):
    """The LUT's deltas, codes 0..4 (4 under non-zero deltas), windows
    0..4."""
    dl, ll = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    lnmis = np.where(codes < 4, ll[q], 0.0).sum(axis=2).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    return codes, dl[q], lnmis, win


@pytest.mark.parametrize("W", [192, 256, 320])
@pytest.mark.parametrize("L", [128, 160])
def test_random_bit_identical(L, W):
    check(random_inputs(np.random.default_rng(L + W), 3, 24, L, W))


def tile_tie_inputs(rng, L, W):
    """One pair per (N-tile boundary, placement): every read of a pair
    has the same bases (random deltas), and two window offsets carry them
    exactly, so they tie at the top for every read. Placements: across
    the boundary (t-1, t), both left of it (t-2, t-1), both right (t,
    t+1), and far apart (t-1, t+n_tile). Returns the inputs and the
    expected (first) offsets."""
    dl, ll = rl.quantized_qscore_luts()
    bounds = range(N_TILE, W, N_TILE)
    places = [(-1, 0), (-2, -1), (0, 1), (-1, N_TILE)]
    pairs = [(t + a, t + b) for t in bounds for a, b in places
             if t + b < W]
    B, R = len(pairs), 16
    reads = rng.integers(0, 4, (B, L))
    codes = np.repeat(reads[:, None], R, axis=1).astype(np.int8)
    q = rng.integers(2, 42, (B, R, L))
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b, cols in enumerate(pairs):
        for w in cols:
            win[b, :, w] = reads[b]
    lnmis = ll[q].sum(axis=2).astype(np.float32)
    return (codes, dl[q], lnmis, win), np.array([p[0] for p in pairs])


@pytest.mark.parametrize("L,W", [(128, 320), (160, 256), (160, 192)])
def test_ties_on_both_sides_of_every_tile_boundary(L, W):
    inp, first = tile_tie_inputs(np.random.default_rng(L * W), L, W)
    got = check(inp)
    np.testing.assert_array_equal(got[1], first[:, None].repeat(16, axis=1))


def test_code4_under_nonzero_deltas():
    """A read code of 4 matches nothing, a window code of 4 included:
    all-4 reads score exactly lnmis, at offset 0."""
    rng = np.random.default_rng(4)
    codes, delta, lnmis, win = random_inputs(rng, 3, 32, 160, 192)
    codes[0] = 4
    codes[1, :, ::3] = 4
    win[0, :, :9] = 4
    win[1] = np.where(rng.random(win[1].shape) < 0.3, 4, win[1])
    assert (delta > 0).all()
    got = check((codes, delta, lnmis, win))
    np.testing.assert_array_equal(got[0][0], lnmis[0])
    np.testing.assert_array_equal(got[1][0], 0)


def test_longest_reads_with_all_limbs_255_round_alike():
    """L = 1816 with every limb at 255 (d_int = 0xFFFF): S = 65535 *
    matches passes 2^24, so f32(S) rounds; the int32 combine with one
    conversion equals the reference's f32 combine at every offset."""
    rng = np.random.default_rng(1816)
    B, R, L, W = 2, 8, MAX_LEN, 192
    delta = np.full((B, R, L), np.float32(65535 / 2048))
    assert ((delta * np.float32(2048)).astype(np.int32) == 0xFFFF).all()
    codes = rng.integers(0, 4, (B, R, L)).astype(np.int8)
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    win[0, :, 100] = codes[0, 0]          # one offset matches every base
    lnmis = rng.uniform(-500, -100, (B, R)).astype(np.float32)
    s1, s0 = onehot_product_sums(codes, delta, win)
    S = s1 * 256 + s0
    assert S.max() == 65535 * L and S.max() > 2 ** 24
    f_once = S.astype(np.int32).astype(np.float32)
    f_ref = (s1.astype(np.float32) * np.float32(256)
             + s0.astype(np.float32))
    assert (f_once.astype(np.int64) != S).mean() > 0.25   # really rounds
    np.testing.assert_array_equal(f_once.view(np.int32), f_ref.view(np.int32))
    got = check((codes, delta, lnmis, win))
    assert got[1][0, 0] == 100


def test_model_merge_equals_flat_first_max():
    """The per-tile merge at another tile width gives the same result:
    the first max does not depend on how the offsets are tiled."""
    inp = random_inputs(np.random.default_rng(9), 2, 16, 128, 320)
    for n_tile in (8, 64, 320):
        assert_bits(tc_model(*inp, n_tile=n_tile), tc_model(*inp))


def test_probe_variants_apply_to_the_source():
    """The design probe's variants (ops/score_tc_probe.py) are edits of
    the kernel's source: each still applies once, so the probe builds."""
    from strelka_tpu_torch.ops import score_tc_probe as probe
    with open(probe.SOURCE) as f:
        source = f.read()
    for name, (exact, edits) in probe.VARIANTS.items():
        text = probe.variant_source(name)
        assert text != source and len(edits) >= 1
    assert {n for n, v in probe.VARIANTS.items() if v[0]} == {
        "wg1", "wg2", "nofence"}
