"""KX-H on K1's u8 tensor-core pipeline (strelka_tpu_torch/csrc/
score_best_offsets_tc.cu, score_best_offsets_tc_kernel<kStandard,
kHapOut>) against the JAX package, on the CPU.

KX-H scores one locus's reads [B,R,L] against H windows side by side,
win [B,L,H*W], and returns K1's best and first-max offset against each
window, [B,R,H], the offset within the window (benchmarks/
exp_exact_kernel.py build_hap2, whose body indexes three limbs of the
two-limb LUT and raises, so the function it computes is held instead:
pallas_readlik.exact_best_offsets on each window's slice). The kernel
cannot run here, so this file models its tile walk in torch: K1's exact
u8 limb sums against the whole [L, H*W] window, N tiles of TC_N_TILE
offsets walking window 0's ceil(W/TC_N_TILE) tiles, then window 1's, a
tile's columns h*W + w0 + j masked past W, the first max merged over
ascending tiles with a strict > and stored and reset at each window's
last tile.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strelka_tpu.ops import pallas_readlik as pk
from strelka_tpu.ops import readlik as rl
from strelka_tpu_torch.ops import score_kernel as sk
from strelka_tpu_torch.ops import score_variants as sv

N_TILE = sk.TC_N_TILE
B, R = 3, 40            # R not a multiple of 32 (K1's reads a warpgroup)


def tile_walk(H, W, n_tile=N_TILE):
    """The kernel's N tiles in order: (window h, w0 within it, the
    window's last tile?) for nt = 0 .. H*ceil(W/n_tile) - 1."""
    n_tw = -(-W // n_tile)
    return [(nt // n_tw, (nt % n_tw) * n_tile,
             (nt % n_tw) * n_tile + n_tile >= W) for nt in range(H * n_tw)]


def exact_scores(codes, delta, lnmis, win_t):
    """K1's s [B,R,W'] on the whole window: u8 limb products summed
    exactly, S = S1*256 + S0 in int32, one f32 conversion, * 2^-11 +
    lnmis."""
    c = torch.as_tensor(codes).to(torch.int64)
    w = torch.as_tensor(win_t).to(torch.int64)
    Bn, Rn, L = c.shape
    oh_r = (c[..., None] == torch.arange(4)).to(torch.int64)   # 4: none
    oh_w = (w[..., None] == torch.arange(4)).to(torch.int64)
    bw = oh_w.permute(0, 1, 3, 2).reshape(Bn, 4 * L, -1)
    d_int = sv._d_int(torch.as_tensor(delta)).to(torch.int64)
    S = 0
    for shift, weight in ((8, 256), (0, 1)):
        limb = (d_int >> shift) & 255
        a = (oh_r * limb[..., None]).reshape(Bn, Rn, 4 * L)
        S = S + weight * torch.bmm(a, bw)
    assert int(S.max()) < 2 ** 31
    s = S.to(torch.int32).to(torch.float32) * np.float32(1 / 2048)
    return s + torch.as_tensor(lnmis)[..., None]


def tc_hap_model(codes, delta, lnmis, win_t, H, n_tile=N_TILE):
    """The kernel's (best, off) [B,R,H] by its tile walk."""
    W = win_t.shape[2] // H
    s = exact_scores(codes, delta, lnmis, win_t)
    Bn, Rn = s.shape[:2]
    best = torch.full((Bn, Rn, H), torch.nan)
    off = torch.full((Bn, Rn, H), -1, dtype=torch.int32)
    run_s = torch.full((Bn, Rn), -torch.inf)
    run_w = torch.full((Bn, Rn), torch.iinfo(torch.int32).max,
                       dtype=torch.int32)
    for h, w0, last in tile_walk(H, W, n_tile):
        cols = [h * W + w0 + j for j in range(n_tile) if w0 + j < W]
        tb, to = torch.max(s[..., cols], dim=-1)       # first max
        take = tb > run_s                              # strict
        run_s = torch.where(take, tb, run_s)
        run_w = torch.where(take, (to + w0).to(torch.int32), run_w)
        if last:
            best[..., h], off[..., h] = run_s, run_w
            run_s = torch.full_like(run_s, -torch.inf)
            run_w = torch.full_like(run_w, torch.iinfo(torch.int32).max)
    return best.numpy(), off.numpy()


def lut_inputs(rng, L, Wt, Bn=B, Rn=R):
    """The LUT's deltas under every code, codes 0..4, windows 0..4."""
    dl, ml = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (Bn, Rn, L))
    codes = rng.integers(0, 5, (Bn, Rn, L)).astype(np.int8)
    lnmis = np.where(codes < 4, ml[q], 0.0).sum(axis=2).astype(np.float32)
    win = rng.integers(0, 5, (Bn, L, Wt)).astype(np.int8)
    return codes, dl[q].astype(np.float32), lnmis, win


def per_window_reference(codes, delta, lnmis, win, H):
    """pallas_readlik.exact_best_offsets on each window's slice,
    stacked to [B,R,H]."""
    W = win.shape[2] // H
    outs = [pk.exact_best_offsets(
        *(jnp.asarray(np.ascontiguousarray(a)) for a in
          (codes, delta, lnmis, win[:, :, h * W:(h + 1) * W])))
        for h in range(H)]
    return (np.stack([np.asarray(o[0]) for o in outs], -1),
            np.stack([np.asarray(o[1]) for o in outs], -1))


def port_plain(codes, delta, lnmis, win, H):
    return [x.numpy() for x in sv.hap_best_offsets(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (codes, delta, lnmis, win)), H)]


def assert_bits(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def assert_all_agree(inp, H, got):
    assert_bits(got, per_window_reference(*inp, H))
    assert_bits(got, port_plain(*inp, H))


@pytest.mark.parametrize("H", [1, 2, 3])
@pytest.mark.parametrize("W", [64, 96, 128, 160, 256])
def test_tile_walk_covers_every_window_offset_once(H, W):
    """No tile holds offsets of two windows, every offset of every
    window is in exactly one tile, and each window ends on a last
    tile."""
    seen = []
    for h, w0, last in tile_walk(H, W):
        cols = [(h, w0 + j) for j in range(N_TILE) if w0 + j < W]
        assert cols and {c[0] for c in cols} == {h}
        seen += cols
        assert last == (w0 + N_TILE >= W)
    assert sorted(seen) == [(h, w) for h in range(H) for w in range(W)]
    assert sum(last for _, _, last in tile_walk(H, W)) == H


@pytest.mark.parametrize("H", [1, 2, 3])
@pytest.mark.parametrize("W", [64, 96, 128, 160, 256])
def test_tile_walk_bit_identical_to_each_window(H, W):
    L = 99 if W in (96, 160) else 128
    inp = lut_inputs(np.random.default_rng(H * 1000 + W), L, H * W)
    got = tc_hap_model(*inp, H)
    assert_all_agree(inp, H, got)


def window_tie_inputs(rng, L, W, H):
    """Every read of a pair carries one sequence, found exactly at the
    last offset of window h and at the first of window h+1, and in odd
    pairs also at both sides of window 0's first N-tile boundary."""
    codes, delta, lnmis, win = lut_inputs(rng, L, H * W, Bn=4, Rn=8)
    win[win == 4] = 0
    for b in range(4):
        read = rng.integers(0, 4, L)
        codes[b] = read
        cols = [c for h in range(1, H) for c in (h * W - 1, h * W)]
        if b % 2 and W > N_TILE:
            cols += [N_TILE - 1, N_TILE]
        for w in cols:
            win[b, :, w] = read
    return codes, delta, lnmis, win


@pytest.mark.parametrize("H", [2, 3])
@pytest.mark.parametrize("W", [96, 128, 160])
def test_ties_at_window_and_tile_boundaries_stay_in_their_window(H, W):
    inp = window_tie_inputs(np.random.default_rng(W + H), 64, W, H)
    best, off = got = tc_hap_model(*inp, H)
    assert_all_agree(inp, H, got)
    # window 0 ends on the read at W-1 (or N_TILE-1 first in odd pairs),
    # every later window starts on it at offset 0
    want0 = np.array([N_TILE - 1 if b % 2 and W > N_TILE else W - 1
                      for b in range(4)])
    np.testing.assert_array_equal(off[..., 0], want0[:, None].repeat(8, 1))
    np.testing.assert_array_equal(off[..., 1:], 0)
    # each window's best is the exact match, the same score
    np.testing.assert_array_equal(best[..., 1:], best[..., :1].repeat(
        H - 1, -1))


def test_code4_scores_lnmis_at_offset_0_in_every_window():
    """Reads all code 4 (or below 0) under non-zero deltas match
    nothing, a window of code 4 included: lnmis at offset 0, in every
    window."""
    H, W = 3, 96
    codes, delta, lnmis, win = lut_inputs(np.random.default_rng(4), 64,
                                          H * W)
    codes[0] = 4
    codes[1] = -1
    win[0, :, W:W + 9] = 4
    inp = (codes, delta, lnmis, win)
    got = tc_hap_model(*inp, H)
    assert_all_agree(inp, H, got)
    for b in (0, 1):
        np.testing.assert_array_equal(got[0][b], lnmis[b][:, None].repeat(
            H, 1))
        np.testing.assert_array_equal(got[1][b], 0)


def test_one_window_walk_is_k1s_walk():
    """With H = 1 the walk is K1's: the per-tile merge equals the flat
    first max over the whole window."""
    inp = lut_inputs(np.random.default_rng(1), 128, 320)
    got = tc_hap_model(*inp, 1)
    flat = tc_hap_model(*inp, 1, n_tile=320)
    assert_bits(got, flat)
    want = sk.exact_best_offsets(*(torch.from_numpy(a) for a in inp))
    assert_bits([x[..., 0] for x in got], [x.numpy() for x in want])
