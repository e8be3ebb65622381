"""KX-K on K1-h's bf16 tensor-core pipeline (strelka_tpu_torch/csrc/
score_highest_tc.cu, score_highest_tc_kernel<kOneSum>) against the JAX
package's harness, on the CPU.

KX-K is K1's function with both limbs in one accumulator, for L <= 256:
s = f32(S) * 2^-11 + lnmis with S = sum_l v * match, v = d_int & 0xFFFF
= limb_1*256 + limb_0 (benchmarks/exp_exact_kernel.py _kernel_limb2k).
The kernel cannot run here, so this file models its arithmetic in torch
and holds the model bit for bit to the interpret-mode limb2k body, to
the port's plain onesum_best_offsets and to pallas_readlik.
exact_best_offsets:

- v from d_int = (int)(delta * 2^11), truncated toward zero as K1 takes
  it, negative deltas included (& 0xFFFF keeps the low 16 bits);
- two bf16 pieces a base, p1 = ((v >> 8) & 255) * 2^-3 and p0 = (v &
  255) * 2^-11, each exact in bf16, p1 + p0 = v * 2^-11;
- each piece's one-hot product added into one f32 accumulator one k16
  block at a time in K1-h's k order (in a 32-base chunk, step q takes
  bases 16*(q//4) + q%4 + {0,4,8,12}), each addition rounded to nearest
  or, the worst the tensor cores' alignment can do, toward zero;
- + lnmis in f32, then the first max per N tile of TC_N_TILE offsets
  merged in ascending tiles with a strict >.

Every partial sum is S' * 2^-11 for an integer S' < 2^24 (L <= 256), so
no addition rounds in either mode.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from benchmarks import exp_exact_kernel as xk
from strelka_tpu.ops import pallas_readlik as pk
from strelka_tpu.ops import readlik as rl
from strelka_tpu_torch.ops import score_kernel as sk
from strelka_tpu_torch.ops import score_variants as sv

N_TILE = sk.TC_N_TILE
CHUNK = 32          # bases per K chunk
B, R, G = 4, 24, 2


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call of the harness runs in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def onesum_v(delta):
    """v = d_int & 0xFFFF, d_int = (int)(delta * 2^11) truncated."""
    return sv._d_int(torch.as_tensor(delta)) & 0xFFFF


def onesum_pieces(delta):
    """(p1, p0) f32 tensors, before any bf16 conversion."""
    v = onesum_v(delta)
    return (((v >> 8) & 255).to(torch.float32) * 2.0 ** -3,
            (v & 255).to(torch.float32) * 2.0 ** -11)


def k16_blocks(L):
    """K1-h's k16 steps as lists of bases: in chunk kc, step q holds
    base 32*kc + 16*(q//4) + q%4 + 4t of thread t = 0..3."""
    blocks = []
    for l0 in range(0, L, CHUNK):
        for q in range(8):
            b = [l0 + 16 * (q >> 2) + (q & 3) + 4 * t for t in range(4)]
            blocks.append([l for l in b if l < L])
    return blocks


def round_f32(x, toward_zero):
    """f64 tensor to f32, to nearest or toward zero."""
    r = x.to(torch.float32)
    if toward_zero:
        over = r.to(torch.float64).abs() > x.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def tc_onesum_model(codes, delta, lnmis, win_t, toward_zero=False,
                    n_tile=N_TILE):
    """The kernel's (best, off) and its accumulator [B,R,W] (before +
    lnmis): two bf16 pieces a base, one f32 addition per k16 block and
    piece, + lnmis, per-tile first max."""
    c = torch.as_tensor(codes).to(torch.int64)
    w = torch.as_tensor(win_t).to(torch.int64)
    Bn, Rn, L = c.shape
    W = w.shape[2]
    match = ((c[..., None] == w[:, None]) & (c[..., None] >= 0)
             & (c[..., None] < 4)).to(torch.float64)       # [B,R,L,W]
    pieces = [p.to(torch.bfloat16).to(torch.float64)
              for p in onesum_pieces(delta)]
    acc = torch.zeros((Bn, Rn, W), dtype=torch.float32)
    for block in k16_blocks(L):
        for p in pieces:
            part = torch.einsum("brl,brlw->brw", p[:, :, block],
                                match[:, :, block])        # exact: < 5 terms
            acc = round_f32(acc.to(torch.float64) + part, toward_zero)
    s = acc + torch.as_tensor(lnmis)[..., None]
    assert s.dtype == torch.float32
    best = torch.full((Bn, Rn), -torch.inf)
    off = torch.full((Bn, Rn), torch.iinfo(torch.int32).max,
                     dtype=torch.int32)
    for w0 in range(0, W, n_tile):
        tb, to = torch.max(s[..., w0:w0 + n_tile], dim=-1)   # first max
        take = tb > best                                      # strict
        best = torch.where(take, tb, best)
        off = torch.where(take, (to + w0).to(torch.int32), off)
    return (best.numpy(), off.numpy()), acc


def lut_inputs(rng, L, W, Bn=B, Rn=R):
    """The LUT's deltas under every code, codes 0..4 (4 under non-zero
    deltas), windows 0..4, lnmis of the matching bases."""
    dl, ml = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (Bn, Rn, L))
    codes = rng.integers(0, 5, (Bn, Rn, L)).astype(np.int8)
    lnmis = np.where(codes < 4, ml[q], 0.0).sum(axis=2).astype(np.float32)
    win = rng.integers(0, 5, (Bn, L, W)).astype(np.int8)
    return codes, dl[q].astype(np.float32), lnmis, win


def jax_call(fn, *arrs):
    return [np.asarray(x) for x in fn(*(jnp.asarray(a) for a in arrs))]


def port_plain(*arrs):
    return [x.numpy() for x in sv.onesum_best_offsets(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs))]


def assert_bits(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def assert_all_agree(inp, got, body=True):
    """The model against the plain versions (and the limb2k body)."""
    if body:
        Bn, Rn, L = inp[0].shape
        fn = xk.build("limb2k", Bn, Rn, L, inp[3].shape[2], G)
        assert_bits(got, jax_call(fn, *inp))
    assert_bits(got, port_plain(*inp))
    assert_bits(got, jax_call(pk.exact_best_offsets, *inp))


def test_pieces_are_exact_for_every_lut_delta_and_uniform_draws():
    dl, _ = rl.quantized_qscore_luts()
    rng = np.random.default_rng(0)
    draws = rng.uniform(-40, 40, 100_000).astype(np.float32)
    quantized = rng.integers(-2 ** 16, 2 ** 16, 100_000) / 2048
    for d in (dl, -dl, draws, quantized.astype(np.float32)):
        v = onesum_v(d).numpy().astype(np.float64)
        p1, p0 = onesum_pieces(d)
        for p in (p1, p0):   # each piece a bf16 value
            np.testing.assert_array_equal(
                p.to(torch.bfloat16).to(torch.float32).numpy(), p.numpy())
        total = p1.numpy().astype(np.float64) + p0.numpy()
        np.testing.assert_array_equal(total, v * 2.0 ** -11)
        # v: the low 16 bits of the truncated d_int, K1's limbs together
        d_int = np.trunc(d.astype(np.float64) * 2048).astype(np.int64)
        np.testing.assert_array_equal(v, d_int & 0xFFFF)


@pytest.mark.parametrize("L", [32, 99, 128, 160, 256])
def test_k_order_covers_every_base_once(L):
    bases = [l for block in k16_blocks(L) for l in block]
    assert sorted(bases) == list(range(L))


@pytest.mark.parametrize("toward_zero", [False, True])
@pytest.mark.parametrize("L,W", [(32, 128), (128, 64), (160, 96),
                                 (256, 70)])
def test_two_piece_model_bit_identical_to_body_and_references(
        interpret, L, W, toward_zero):
    inp = lut_inputs(np.random.default_rng(L + W), L, W)
    got, _ = tc_onesum_model(*inp, toward_zero=toward_zero)
    assert_all_agree(inp, got)


@pytest.mark.parametrize("toward_zero", [False, True])
def test_largest_sum_at_L256_every_v_ffff(interpret, toward_zero):
    """L = 256, every base of every read matching at offset 0 with v =
    0xFFFF (65535 * 2^-11 in even pairs, -2^-11 in odd ones): S =
    16,776,960 < 2^24, held exactly, and equal to the references."""
    L, W = 256, 96
    rng = np.random.default_rng(256)
    codes = np.zeros((B, R, L), np.int8)
    delta = np.where(np.arange(B)[:, None, None] % 2 == 0,
                     np.float32(65535 / 2048), np.float32(-1 / 2048))
    delta = np.broadcast_to(delta, (B, R, L)).astype(np.float32)
    lnmis = rng.normal(-100, 10, (B, R)).astype(np.float32)
    win = np.zeros((B, L, W), np.int8)
    win[:, :, 1::2] = rng.integers(0, 5, (B, L, W // 2))
    win[:, 0, 1::2] = 1                    # no odd offset matches whole
    inp = (codes, delta, lnmis, win)
    (best, off), acc = tc_onesum_model(*inp, toward_zero=toward_zero)
    S = 65535 * L
    assert S == 16_776_960 < 2 ** 24
    assert float(acc.max()) == S * 2.0 ** -11
    np.testing.assert_array_equal(acc[..., 0].numpy(),
                                  np.float32(S * 2.0 ** -11))
    np.testing.assert_array_equal(off, 0)
    np.testing.assert_array_equal(
        best, np.float32(S * 2.0 ** -11) + lnmis)
    assert_all_agree(inp, (best, off))


def test_negative_and_unquantized_deltas(interpret):
    """Negative deltas (the LUT's, negated) and uniform ones that are not
    multiples of 2^-11: d_int truncates toward zero and & 0xFFFF keeps
    its low bits, in the model as in the references."""
    L, W = 128, 64
    rng = np.random.default_rng(11)
    codes, delta, lnmis, win = lut_inputs(rng, L, W)
    sign = np.where(rng.random(delta.shape) < 0.5, -1, 1)
    delta = (delta * sign).astype(np.float32)
    delta[0] = rng.uniform(-20, 20, delta[0].shape).astype(np.float32)
    assert (delta < 0).any() and (delta[0] * 2048 % 1 != 0).any()
    inp = (codes, delta, lnmis, win)
    for toward_zero in (False, True):
        got, _ = tc_onesum_model(*inp, toward_zero=toward_zero)
        assert_all_agree(inp, got)


def test_code4_and_negative_codes_match_nothing(interpret):
    """A read code of 4 or below 0 matches nothing, a window code of 4
    or below 0 included: such reads score exactly lnmis, at offset 0."""
    L, W = 96, 128
    codes, delta, lnmis, win = lut_inputs(np.random.default_rng(4), L, W)
    codes[0] = 4
    codes[1] = -1
    codes[2, :, ::3] = -128
    win[0, :, :9] = 4
    win[2, :, 5:20] = -1
    inp = (codes, delta, lnmis, win)
    got, _ = tc_onesum_model(*inp)
    assert_all_agree(inp, got)
    for b in (0, 1):
        np.testing.assert_array_equal(got[0][b], lnmis[b])
        np.testing.assert_array_equal(got[1][b], 0)


def test_tile_merge_equals_flat_first_max_with_ties():
    """Every read of a pair carries one sequence, found exactly at two
    offsets across, beside and a tile apart from an N-tile boundary:
    the per-tile merge gives the flat first max, the first of the two."""
    L, W = 128, 320
    rng = np.random.default_rng(64)
    cols = [(63, 64), (62, 63), (64, 65), (127, 191)]
    codes, delta, lnmis, win = lut_inputs(rng, L, W, Bn=len(cols), Rn=8)
    win[win == 4] = 0
    for b, pair in enumerate(cols):
        read = rng.integers(0, 4, L)
        codes[b] = read
        for w in pair:
            win[b, :, w] = read
    inp = (codes, delta, lnmis, win)
    got, _ = tc_onesum_model(*inp)
    flat, _ = tc_onesum_model(*inp, n_tile=W)
    assert_bits(got, flat)
    np.testing.assert_array_equal(got[1], np.array(
        [p[0] for p in cols])[:, None].repeat(8, axis=1))
    assert_all_agree(inp, got, body=False)
