"""KX-P on K1's tensor-core pipeline (strelka_tpu_torch/csrc/
score_best_offsets_tc.cu, instantiated on the packed operand) against
the JAX package's harness, on the CPU.

KX-P takes one int32 per base, p = (d_int << 3) | code. Its expansion
reads the code as p & 7 (4..7 match nothing) and d_int as p >> 3, with
no f32 multiply, and lnmis from [B,R] or, folded, as raw f32 bits in
ceil(R/L) extra rows (read r at row R + r // L, column r % L). The
kernel cannot run here, so this file models that unpack feeding K1's
tensor-core arithmetic (u8 limbs of d_int times the window's one-hot,
summed exactly; S = S1*256 + S0 in int32; one f32 conversion; * 2^-11 +
lnmis; the first max per N tile merged in ascending tiles), and holds
the model bit for bit to the interpret-mode Pallas bodies of
benchmarks/exp_exact_kernel.py's fusedin and fusedlm (build_packedin,
through fn.packed, the entry the harness times) and to the port's plain
packed_best_offsets. Codes 5-7 in the low bits and folded rows with R
not a multiple of L are included.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from benchmarks import exp_exact_kernel as xk
from strelka_tpu.ops import readlik as rl
from strelka_tpu_torch.ops import score_kernel as sk
from strelka_tpu_torch.ops import score_variants as sv

N_TILE = sk.TC_N_TILE
B, G = 4, 2


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call of the harness runs in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def unpack(packed, R):
    """The kernel's reading of the packed operand: (code, d_int) of the
    reads' rows and lnmis of the folded rows (if any)."""
    p = packed[:, :R]
    lnmis = np.ascontiguousarray(packed[:, R:]).reshape(
        packed.shape[0], -1)[:, :R].view(np.float32)
    return p & 7, p >> 3, lnmis


def tc_model(codes, d_int, lnmis, win_t, n_tile=N_TILE):
    """K1's tensor-core arithmetic on (code, d_int): exact u8 limb
    products, int32 combine, one f32 conversion, per-tile first max."""
    Bn, R, L = codes.shape
    W = win_t.shape[2]
    oh_r = codes[..., None].astype(np.int64) == np.arange(4)   # 4..7: none
    oh_w = win_t.astype(np.int64)[..., None] == np.arange(4)
    bw = oh_w.transpose(0, 1, 3, 2).reshape(Bn, 4 * L, W).astype(np.int64)
    S = np.zeros((Bn, R, W), np.int64)
    for shift, weight in ((8, 256), (0, 1)):
        limb = (d_int >> shift) & 255
        a = np.where(oh_r, limb[..., None].astype(np.int64), 0)
        assert a.min() >= 0 and a.max() <= 255          # u8 operands
        S += weight * np.matmul(a.reshape(Bn, R, 4 * L), bw)
    assert S.max() < 2 ** 31
    s = S.astype(np.int32).astype(np.float32) * np.float32(1 / 2048)
    s = s + lnmis[..., None]
    assert s.dtype == np.float32
    best = np.full((Bn, R), -np.inf, np.float32)
    off = np.full((Bn, R), np.iinfo(np.int32).max, np.int32)
    for w0 in range(0, W, n_tile):
        tile = s[..., w0:w0 + n_tile]
        tb, to = tile.max(axis=-1), tile.argmax(axis=-1) + w0   # first max
        take = tb > best                                     # strict
        best = np.where(take, tb, best)
        off = np.where(take, to, off).astype(np.int32)
    return best, off


def packed_inputs(rng, R, L, W, fold, wide_codes=True):
    """Codes 0..4 under the LUT's non-zero deltas (lnmis sums the bases
    of code < 4), host packed as exp_exact_kernel.py:799-806 packs; with
    `wide_codes` the code-4 bases carry 4..7 in their low bits (none of
    them matches)."""
    dl, ml = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    delta = dl[q].astype(np.float32)
    lnmis = np.where(codes < 4, ml[q], 0).sum(2).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    d_int = (delta * xk.Q2_SCALE).astype(np.int32)
    c = codes.astype(np.int32)
    if wide_codes:
        c = np.where(c == 4, rng.integers(4, 8, c.shape), c).astype(np.int32)
    packed = (d_int << 3) | c
    if fold:
        rows = -(-R // L)
        lm = np.pad(lnmis.view(np.int32), ((0, 0), (0, rows * L - R)))
        packed = np.concatenate([packed, lm.reshape(B, rows, L)], axis=1)
    return packed, lnmis, win


def harness(fold, R, L, W, packed, lnmis, win):
    fn = xk.build("fusedlm" if fold else "fusedin", B, R, L, W, G)
    b, o = fn.packed(jnp.asarray(packed), jnp.asarray(lnmis),
                     jnp.asarray(win))
    return np.asarray(b), np.asarray(o)


def port_plain(fold, R, packed, lnmis, win):
    out = sv.packed_best_offsets(torch.from_numpy(packed),
                                 None if fold else torch.from_numpy(lnmis),
                                 torch.from_numpy(win), n_reads=R)
    return [x.numpy() for x in sv.unpack_best_offsets(out)]


def assert_bits(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("R,L,W", [(40, 32, 128), (16, 64, 192),
                                   (24, 160, 64)])
def test_packed_tc_model_bit_identical_to_interpret_body(interpret, fold,
                                                         R, L, W):
    packed, lnmis, win = packed_inputs(np.random.default_rng(R + L + W),
                                       R, L, W, fold)
    assert ((packed[:, :R] & 7) > 4).any()
    if fold:
        assert packed.shape[1] == R + -(-R // L) and R % L
    codes, d_int, folded = unpack(packed, R)
    got = tc_model(codes, d_int, folded if fold else lnmis, win)
    if fold:
        np.testing.assert_array_equal(folded.view(np.int32),
                                      lnmis.view(np.int32))
    assert_bits(got, harness(fold, R, L, W, packed, lnmis, win))
    assert_bits(got, port_plain(fold, R, packed, lnmis, win))


@pytest.mark.parametrize("fold", [False, True])
def test_packed_tc_model_ties_across_tile_boundaries(interpret, fold):
    """Every read of a pair carries the same bases and two window
    offsets carry them exactly, across an N-tile boundary and a tile
    apart: the first of the two wins, as in the harness's body."""
    rng = np.random.default_rng(7)
    R, L, W = 40, 32, 192
    packed, lnmis, win = packed_inputs(rng, R, L, W, fold)
    dl, ml = rl.quantized_qscore_luts()
    cols = [(63, 64), (62, 63), (64, 65), (127, 191)]
    for b in range(B):
        read = rng.integers(0, 4, L)
        q = rng.integers(2, 42, (R, L))
        d_int = (dl[q] * xk.Q2_SCALE).astype(np.int32)
        packed[b, :R] = (d_int << 3) | read
        lm = ml[q].sum(1).astype(np.float32)
        lnmis[b] = lm
        if fold:
            packed[b, R:].reshape(-1)[:R] = lm.view(np.int32)
        for w in cols[b]:
            win[b, :, w] = read
    codes, d_int, folded = unpack(packed, R)
    got = tc_model(codes, d_int, folded if fold else lnmis, win)
    np.testing.assert_array_equal(got[1], np.array(
        [c[0] for c in cols])[:, None].repeat(R, axis=1))
    assert_bits(got, harness(fold, R, L, W, packed, lnmis, win))
    assert_bits(got, port_plain(fold, R, packed, lnmis, win))
