"""The bf16 tensor-core K1-h (strelka_tpu_torch/csrc/score_highest_tc.cu)
against the JAX package, on the CPU.

The kernel cannot run here, so this file models its arithmetic in
numpy and torch and holds the model to pallas_readlik.
reference_best_offsets (the f32-HIGHEST oracle of mode="highest") and
to the port's plain reference_best_offsets:

- each delta split into three bf16 pieces, hi = bf16(d), mid = bf16(d -
  hi), lo = bf16(d - hi - mid), with hi + mid + lo == d exactly;
- the three one-hot slabs' products, each exact, added into one f32
  accumulator one k16 block and piece at a time in the kernel's k order
  (in a 32-base chunk, step q takes bases 16*(q//4) + q%4 + {0,4,8,12}),
  each addition rounded to nearest or, the worst the tensor cores'
  alignment can do, toward zero;
- + lnmis in f32, then the first max per N tile of TC_N_TILE offsets
  merged in ascending tiles with a strict >.

With the quantized LUT's deltas every piece and partial sum is a
multiple of 2^-11 below 2^13, exact in any order: the model equals the
reference bit for bit. With unquantized deltas (bench.py's uniform(2,
20)) it stays within the f32 bound that chip_smoke.py phase 2b holds the
card to, 2 (L+1) 2^-24 (sum |matching deltas| + |lnmis|), whose
worst case for this order is the 3L/4 truncations of one score
(3L/4 * 2^-23 * sum = 1.5 L 2^-24 sum) plus the reference's own
rounding.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strelka_tpu.ops import pallas_readlik as pk
from strelka_tpu.ops import readlik as rl
from strelka_tpu_torch.ops import score_kernel as sk

N_TILE = sk.TC_N_TILE
CHUNK = 32          # bases per K chunk


def split3(d):
    """(hi, mid, lo) f32 arrays of bf16 values: each the bf16 rounding
    (nearest even) of what the ones before leave of d."""
    rest = torch.from_numpy(np.asarray(d, np.float32))
    pieces = []
    for _ in range(3):
        p = rest.to(torch.bfloat16).to(torch.float32)
        pieces.append(p.numpy())
        rest = rest - p          # exact in f32
    return pieces


def k16_blocks(L):
    """The kernel's k16 steps as lists of bases: in chunk kc, step q
    holds base 32*kc + 16*(q//4) + q%4 + 4t of thread t = 0..3."""
    blocks = []
    for l0 in range(0, L, CHUNK):
        for q in range(8):
            b = [l0 + 16 * (q >> 2) + (q & 3) + 4 * t for t in range(4)]
            blocks.append([l for l in b if l < L])
    return blocks


def round_f32(x, toward_zero):
    """f64 values to f32, to nearest or toward zero."""
    r = x.astype(np.float32)
    if toward_zero:
        over = np.abs(r.astype(np.float64)) > np.abs(x)
        r = np.where(over, np.nextafter(r, np.float32(0)), r)
    return r


def tc_highest_model(codes, delta, lnmis, win_t, toward_zero=False,
                     n_tile=N_TILE):
    """The kernel's (best, off): three-piece products accumulated in f32
    per k16 block and piece, + lnmis, per-tile first max."""
    B, R, L = codes.shape
    W = win_t.shape[2]
    c = codes.astype(np.int64)
    match = ((c[..., None] == win_t.astype(np.int64)[:, None])
             & (c[..., None] >= 0) & (c[..., None] < 4))   # [B,R,L,W]
    pieces = split3(delta)
    acc = np.zeros((B, R, W), np.float32)
    for block in k16_blocks(L):
        for p in pieces:
            part = np.einsum("brl,brlw->brw", p[:, :, block].astype(np.float64),
                             match[:, :, block])           # exact: < 5 terms
            acc = round_f32(acc.astype(np.float64) + part, toward_zero)
    s = acc + lnmis[..., None]
    assert s.dtype == np.float32
    best = np.full((B, R), -np.inf, np.float32)
    off = np.full((B, R), np.iinfo(np.int32).max, np.int32)
    for w0 in range(0, W, n_tile):
        tile = s[..., w0:w0 + n_tile]
        tb, to = tile.max(axis=-1), tile.argmax(axis=-1) + w0   # first max
        take = tb > best                                     # strict
        best = np.where(take, tb, best)
        off = np.where(take, to, off).astype(np.int32)
    return best, off


def jax_reference(*inp):
    b, o = pk.reference_best_offsets(*(jnp.asarray(a) for a in inp))
    return np.asarray(b), np.asarray(o)


def port_reference(*inp):
    b, o = sk.reference_best_offsets(*(torch.from_numpy(np.asarray(a))
                                       for a in inp))
    return b.numpy(), o.numpy()


def assert_bits(got, want):
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


def lut_inputs(rng, B, R, L, W):
    """The LUT's deltas, codes 0..4 (4 under non-zero deltas), windows
    0..4."""
    dl, ll = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    lnmis = np.where(codes < 4, ll[q], 0.0).sum(axis=2).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    return codes, dl[q], lnmis, win


def bench_inputs(rng, B, R, L, W):
    """bench.py's unquantized deltas, uniform(2, 20)."""
    return (rng.integers(0, 5, (B, R, L)).astype(np.int8),
            rng.uniform(2, 20, (B, R, L)).astype(np.float32),
            rng.normal(-100, 10, (B, R)).astype(np.float32),
            rng.integers(0, 5, (B, L, W)).astype(np.int8))


def test_split_is_exact_for_every_lut_delta_and_uniform_draws():
    dl, _ = rl.quantized_qscore_luts()
    draws = np.random.default_rng(0).uniform(2, 20, 100_000).astype(
        np.float32)
    for d in (dl, draws):
        hi, mid, lo = split3(d)
        for p in (hi, mid, lo):   # each piece a bf16 value
            bf = torch.from_numpy(p).to(torch.bfloat16).to(torch.float32)
            np.testing.assert_array_equal(bf.numpy(), p)
        total = hi.astype(np.float64) + mid + lo
        np.testing.assert_array_equal(total, d.astype(np.float64))
        # nothing is left after lo: 3 x 8 significand bits cover 24
        np.testing.assert_array_equal(split3(d - hi - mid)[0], lo)


def test_lut_deltas_are_multiples_of_2_pow_11_piece_by_piece():
    """Why the LUT's scores are exact in any order: every piece is a
    multiple of 2^-11, so every partial sum below 2^13 is an f32."""
    dl, _ = rl.quantized_qscore_luts()
    for p in split3(dl):
        scaled = p.astype(np.float64) * 2048
        np.testing.assert_array_equal(scaled, np.round(scaled))


def test_k_order_covers_every_base_once():
    for L in (99, 128, 160, 1816):
        bases = [l for block in k16_blocks(L) for l in block]
        assert sorted(bases) == list(range(L))


@pytest.mark.parametrize("toward_zero", [False, True])
@pytest.mark.parametrize("B,R,L,W", [(3, 24, 128, 192), (2, 16, 160, 256),
                                     (3, 20, 100, 70)])
def test_three_piece_product_bit_identical_on_lut_deltas(B, R, L, W,
                                                         toward_zero):
    inp = lut_inputs(np.random.default_rng(B * L + W), B, R, L, W)
    got = tc_highest_model(*inp, toward_zero=toward_zero)
    assert_bits(got, jax_reference(*inp))
    assert_bits(got, port_reference(*inp))


def near_tie_rows(codes, delta, lnmis, win_t, atol=1e-4):
    """[B, R] bool: the top two scores (f64) lie within atol."""
    a = (codes[..., None] == np.arange(4)) * delta[..., None].astype(
        np.float64)
    w = (win_t[..., None] == np.arange(4)).astype(np.float64)
    s = np.sort(np.einsum("brlc,blwc->brw", a, w) + lnmis[..., None], -1)
    return (s[..., -1] - s[..., -2]) <= atol


@pytest.mark.parametrize("toward_zero", [False, True])
@pytest.mark.parametrize("B,R,L,W", [(3, 24, 128, 128), (2, 16, 160, 256)])
def test_unquantized_deltas_within_the_stated_bound(B, R, L, W,
                                                    toward_zero):
    codes, delta, lnmis, win = inp = bench_inputs(
        np.random.default_rng(L + W), B, R, L, W)
    got = tc_highest_model(*inp, toward_zero=toward_zero)
    want = jax_reference(*inp)
    terms = np.where((codes >= 0) & (codes < 4), np.abs(delta), 0).sum(-1)
    bound = 2 * (L + 1) * 2.0 ** -24 * (terms + np.abs(lnmis))
    err = np.abs(got[0].astype(np.float64) - want[0])
    assert (err <= bound).all(), float((err / bound).max())
    assert err.max() > 0          # the sums really round
    differ = got[1] != want[1]
    assert not (differ & ~near_tie_rows(*inp)).any()


def tile_tie_inputs(rng, L, W):
    """One pair per (N-tile boundary, placement): every read of a pair
    has the same bases and two window offsets carry them, so they tie at
    the top: across the boundary, both left of it, both right, and a
    tile apart. Returns the inputs and the first offsets."""
    dl, ll = rl.quantized_qscore_luts()
    places = [(-1, 0), (-2, -1), (0, 1), (-1, N_TILE)]
    pairs = [(t + a, t + b) for t in range(N_TILE, W, N_TILE)
             for a, b in places if t + b < W]
    B, R = len(pairs), 8
    reads = rng.integers(0, 4, (B, L))
    codes = np.repeat(reads[:, None], R, axis=1).astype(np.int8)
    q = rng.integers(2, 42, (B, R, L))
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b, cols in enumerate(pairs):
        for w in cols:
            win[b, :, w] = reads[b]
    lnmis = ll[q].sum(axis=2).astype(np.float32)
    return (codes, dl[q], lnmis, win), np.array([p[0] for p in pairs])


@pytest.mark.parametrize("L,W", [(128, 320), (160, 256)])
def test_tile_merge_equals_flat_first_max_with_ties_at_boundaries(L, W):
    inp, first = tile_tie_inputs(np.random.default_rng(L * W), L, W)
    got = tc_highest_model(*inp)
    flat = tc_highest_model(*inp, n_tile=W)
    assert_bits(got, flat)
    assert_bits(got, jax_reference(*inp))
    np.testing.assert_array_equal(got[1], first[:, None].repeat(8, axis=1))


def test_code4_and_negative_codes_match_nothing():
    """A read code of 4 (or a negative one) matches nothing, a window
    code of 4 included: such reads score exactly lnmis, at offset 0."""
    codes, delta, lnmis, win = lut_inputs(np.random.default_rng(4), 3, 16,
                                          96, 128)
    codes[0] = 4
    codes[1] = -1
    win[0, :, :9] = 4
    got = tc_highest_model(codes, delta, lnmis, win)
    assert_bits(got, jax_reference(codes, delta, lnmis, win))
    for b in (0, 1):
        np.testing.assert_array_equal(got[0][b], lnmis[b])
        np.testing.assert_array_equal(got[1][b], 0)
