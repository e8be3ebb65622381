"""KX-A nomax and noW on K1's u8 tensor-core pipeline (strelka_tpu_torch/
csrc/score_best_offsets_tc.cu: score_best_offsets_tc_kernel<kStandard,
kBestOnly> and <kStandard, kBestOff, kProduct, kGroupSlab> (plan S) or
<..., kGroupRing> (plan R)) against the JAX package's interpret-mode
Pallas bodies, on the CPU.

nomax (benchmarks/exp_exact_kernel.py _kernel_limb2_nomax) is K1's best
with offset 0. The kernel keeps K1's tile sums and replaces the first-max
bookkeeping by a max alone: each lane runs a strict > over its offsets
in ascending order across the N tiles, then the 4 lanes of a read merge
by max with the same strict >. This file models that epilogue lane by
lane.

noW (_kernel_limb2_noW) scores pair b against the window of pair
b//G*G, the first of its group of G. Plan S fills a slab with every
step's expanded Bw tile on the group's first pair's walk and runs the
later pairs' products over it; plan R is K1's ring, each step's tile
expanded anew from the group's window. This file models both walks step
by step over the u8 operands (A words and one-hot Bw tiles, in integers)
and counts each slab slot's writes and reads.

The kernels cannot run here; tests/test_torch_cuda.py and chip_smoke.py
phase 2c hold them against the plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import exp_exact_kernel as xk
from strelka_tpu_torch.ops import score_variants as sv
from tests.test_torch_score_tc_ablation import (  # noqa: F401 (fixture)
    CHUNK, N_TILE, assert_bits, bw_operand, d_int, interpret, lut_inputs,
    word_bytes)

G = sv.DEFAULT_G        # the runner's tiles per grid step


def interpret_body(variant, inp):
    B, R, L = inp[0].shape
    fn = xk.build(variant, B, R, L, inp[3].shape[2], G)
    return [np.asarray(x) for x in fn(*(jnp.asarray(a) for a in inp))]


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def port_plain(which, inp, g=G):
    return [x.numpy() for x in sv.ablation_best_offsets(
        which, *(tt(a) for a in inp), G=g)]


def k1_plain(inp):
    return [x.numpy() for x in sv.exact_best_offsets(*(tt(a) for a in inp))]


# --- K1's operands and steps ------------------------------------------------

def a_operand(codes, delta):
    """K1's A bytes [B, 2, R, 4Lp] (limb 1, limb 0): limb_j << 8c for a
    code c in 0..3, else 0; bases past L (to Lp, L rounded up to CHUNK)
    zero."""
    c = tt(codes).to(torch.int64)
    ok = (c >= 0) & (c < 4)
    di = d_int(delta)
    L = c.shape[2]
    Lp = -(-L // CHUNK) * CHUNK
    limbs = [word_bytes(torch.where(ok, ((di >> sh) & 255) << (8 * (c & 3)),
                                    0)) for sh in (8, 0)]
    return torch.nn.functional.pad(torch.stack(limbs, 1), (0, 4 * (Lp - L)))


def bw_tile(win, l0, w0):
    """A step's one-hot Bw tile [B, 4*CHUNK, N_TILE] (k = 4l + c) of
    window win [B,L,W] at bases l0.., offsets w0..; bases past L and
    offsets past W zero."""
    B, L, W = win.shape
    full = bw_operand(win)                                    # [B,4L,W]
    tile = torch.zeros((B, 4 * CHUNK, N_TILE), dtype=torch.int64)
    nl, nw = min(CHUNK, L - l0), min(N_TILE, W - w0)
    tile[:, :4 * nl, :nw] = full[:, 4 * l0:4 * (l0 + nl), w0:w0 + nw]
    return tile


def steps(L, W):
    """K1's steps (N tile, K chunk), K fastest."""
    n_k, n_t = -(-L // CHUNK), -(-W // N_TILE)
    return [(nt, kc) for nt in range(n_t) for kc in range(n_k)]


def step_sums(a, tile, kc):
    """One step's limb sums [B, 2, R, N_TILE]: chunk kc's 128 bytes of K
    of A against the step's Bw tile."""
    return torch.einsum("bjrk,bkw->bjrw",
                        a[..., 4 * CHUNK * kc:4 * CHUNK * (kc + 1)], tile)


def tile_scores(acc, lnmis):
    """K1's tile epilogue before the max: S = S_1*256 + S_0 (exact in
    int32), one f32 conversion, * 2^-11 + lnmis; [B,R,N_TILE] f32."""
    S = acc[:, 0] * 256 + acc[:, 1]
    assert int(S.max()) < 2 ** 31
    s = S.to(torch.int32).to(torch.float32) * np.float32(1 / 2048)
    return s + tt(lnmis)[..., None]


def lane_walk(tiles, W, offsets):
    """The kernel's epilogue over tiles [B,R,N_TILE] f32 in order: lane
    t4 of read r visits offsets w0 + 8j + 2*t4 + e (j, then e) of each
    tile in turn, a strict > keeping the first max (past W skipped), then
    the 4 lanes merge (xor 1, then 2): by better() (K1, `offsets`) or by
    max alone (nomax). Returns (best, off) [B,R]."""
    B, R, _ = tiles[0].shape
    run_s = torch.full((B, R, 4), -torch.inf)
    run_w = torch.full((B, R, 4), torch.iinfo(torch.int32).max,
                       dtype=torch.int64)
    for nt, s in enumerate(tiles):
        lanes = s.reshape(B, R, 8, 4, 2)                     # [.., j, t4, e]
        for j in range(8):
            for e in range(2):
                w = nt * N_TILE + 8 * j + 2 * torch.arange(4) + e   # per t4
                v = lanes[:, :, j, :, e]
                take = (w < W) & (v > run_s)
                run_s = torch.where(take, v, run_s)
                if offsets:
                    run_w = torch.where(take, w, run_w)
    for o in (1, 2):
        perm = torch.arange(4) ^ o
        os_, ow = run_s[..., perm], run_w[..., perm]
        take = os_ > run_s
        if offsets:
            take = take | ((os_ == run_s) & (ow < run_w))
        run_s = torch.where(take, os_, run_s)
        run_w = torch.where(take, ow, run_w)
    off = run_w[..., 0] if offsets else torch.zeros((B, R), dtype=torch.int64)
    return run_s[..., 0].numpy(), off.to(torch.int32).numpy()


def k1_walk(codes, delta, lnmis, win, offsets=True):
    """K1's steps on each pair's own window (the ring), then the lane
    epilogue: with offsets, K1; without, nomax."""
    a = a_operand(codes, delta)
    L, W = codes.shape[2], win.shape[2]
    tiles, acc = [], 0
    for nt, kc in steps(L, W):
        acc = (0 if kc == 0 else acc) + step_sums(
            a, bw_tile(win, kc * CHUNK, nt * N_TILE), kc)
        if kc == -(-L // CHUNK) - 1:
            tiles.append(tile_scores(acc, lnmis))
    return lane_walk(tiles, W, offsets)


# --- noW's two plans --------------------------------------------------------

def now_walk(codes, delta, lnmis, win, g, slab):
    """noW's kernel walk for groups of g pairs: plan S (`slab`) writes
    each step's Bw tile of the group's first window into slab slot it on
    the first pair's walk and reads it for every pair; plan R expands it
    anew from the group's first window into ring slot it % 3 for each
    pair. Returns (best, off) [B,R] and, per group, each slot's writes
    [n_slots] and reads [n_slots, g]."""
    B, R, L = codes.shape
    W = win.shape[2]
    a = a_operand(codes, delta)
    walk = steps(L, W)
    n_groups = -(-B // g)
    n_slots = len(walk) if slab else 3
    writes = np.zeros((n_groups, n_slots), np.int64)
    reads = np.zeros((n_groups, n_slots, g), np.int64)
    best = np.zeros((B, R), np.float32)
    off = np.zeros((B, R), np.int32)
    for grp in range(n_groups):
        first = grp * g
        wfirst = win[first:first + 1]
        slots = [None] * n_slots
        for p in range(first, min(first + g, B)):
            tiles, acc = [], 0
            for it, (nt, kc) in enumerate(walk):
                slot = it if slab else it % 3
                if not slab or p == first:    # the group's first pair
                    slots[slot] = bw_tile(wfirst, kc * CHUNK, nt * N_TILE)
                    writes[grp, slot] += 1
                reads[grp, slot, p - first] += 1
                acc = (0 if kc == 0 else acc) + step_sums(
                    a[p:p + 1], slots[slot], kc)
                if kc == -(-L // CHUNK) - 1:
                    tiles.append(tile_scores(acc, lnmis[p:p + 1]))
            bp, op = lane_walk(tiles, W, offsets=True)
            best[p], off[p] = bp[0], op[0]
    return (best, off), writes, reads


# --- nomax ------------------------------------------------------------------

SHAPES = [(4, 40, 50, 70),      # R, L, W not multiples of 32/32/64
          (4, 64, 64, 192), (4, 33, 99, 129), (4, 32, 160, 256)]


@pytest.mark.parametrize("B,R,L,W", SHAPES)
def test_nomax_max_only_epilogue_bit_identical_to_interpret_body(
        interpret, B, R, L, W):
    """nomax's max-only epilogue over K1's tile sums equals the Pallas
    body and the port's plain version bit for bit: best is K1's, off 0."""
    inp = lut_inputs(np.random.default_rng(B * R + L + W), B, R, L, W)
    got = k1_walk(*inp, offsets=False)
    assert_bits(got, interpret_body("limb2-nomax", inp))
    assert_bits(got, port_plain("nomax", inp))
    k1 = k1_walk(*inp)
    assert_bits(k1, k1_plain(inp))
    assert_bits([got[0]], [k1[0]])
    np.testing.assert_array_equal(got[1], 0)


def tile_tie_inputs(rng, B, R, L, W):
    """Each pair's reads carry one sequence, found exactly at two offsets
    of its window: on both sides of, left of, right of and a tile across
    an N-tile boundary, the pairs taking the placements in turn."""
    cols = [(t + a, t + b) for t in range(N_TILE, W, N_TILE)
            for a, b in ((-1, 0), (-2, -1), (0, 1), (-1, N_TILE))
            if t + b < W]
    codes, delta, lnmis, win = lut_inputs(rng, B, R, L, W)
    reads = rng.integers(0, 4, (B, L))
    codes[:] = reads[:, None]
    win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b in range(B):
        for w in cols[b % len(cols)]:
            win[b, :, w] = reads[b]
    return (codes, delta, lnmis, win), cols


@pytest.mark.parametrize("W", [128, 192, 256])
def test_nomax_ties_across_n_tiles(interpret, W):
    """Exact ties at the top across N-tile boundaries: nomax's best
    equals K1's bits (K1 takes the first offset), its offsets all 0."""
    B, R, L = 8, 40, 64
    inp, cols = tile_tie_inputs(np.random.default_rng(W), B, R, L, W)
    k1 = k1_walk(*inp)
    want = np.array([cols[b % len(cols)][0] for b in range(B)])
    np.testing.assert_array_equal(k1[1], np.broadcast_to(want[:, None],
                                                         (B, R)))
    got = k1_walk(*inp, offsets=False)
    assert_bits(got, interpret_body("limb2-nomax", inp))
    assert_bits([got[0]], [k1[0]])
    np.testing.assert_array_equal(got[1], 0)


# --- noW --------------------------------------------------------------------

@pytest.mark.parametrize("slab", [True, False], ids=["plan_S", "plan_R"])
@pytest.mark.parametrize("B,R,L,W", SHAPES + [(8, 32, 32, 64)])
def test_now_plans_bit_identical_to_interpret_body(interpret, B, R, L, W,
                                                   slab):
    """Both plans' walks (the slab read by the group, or K1's ring on
    the group's window) equal the Pallas body at G = 4 and the port's
    plain version bit for bit."""
    inp = lut_inputs(np.random.default_rng(B * R + L + W + 3), B, R, L, W)
    got, _, _ = now_walk(*inp, G, slab)
    assert_bits(got, interpret_body("limb2-noW", inp))
    assert_bits(got, port_plain("noW", inp))


@pytest.mark.parametrize("B,R,L,W", [(6, 40, 50, 70), (9, 33, 99, 129),
                                     (4, 32, 160, 256)])
def test_now_slab_slots_written_once_and_read_by_every_pair(B, R, L, W):
    """Plan S: the group's first pair writes each slab slot once; every
    pair of the group (the last group's too, partial or not) reads each
    slot once, and no pair past B reads any."""
    inp = lut_inputs(np.random.default_rng(B + R + L + W), B, R, L, W)
    _, writes, reads = now_walk(*inp, G, slab=True)
    assert writes.shape[1] == len(steps(L, W))
    assert (writes == 1).all()
    for grp in range(-(-B // G)):
        n = min(G, B - grp * G)
        assert (reads[grp, :, :n] == 1).all()
        assert (reads[grp, :, n:] == 0).all()
    # plan R expands every step anew for every pair
    _, writes, reads = now_walk(*inp, G, slab=False)
    assert writes.sum() == B * len(steps(L, W)) == reads.sum()


@pytest.mark.parametrize("g", [1, 3, 4, 6, 8])
@pytest.mark.parametrize("slab", [True, False], ids=["plan_S", "plan_R"])
def test_now_ragged_groups_against_plain_version(g, slab):
    """B = 6 in groups of g: a partial last group (g = 4), g = 1 (each
    pair its own window, K1), g = 3, and g >= B (one group): both plans
    equal now_best_offsets bit for bit; g = 1 equals K1."""
    B, R, L, W = 6, 40, 64, 128
    inp = lut_inputs(np.random.default_rng(g), B, R, L, W)
    got, _, _ = now_walk(*inp, g, slab)
    assert_bits(got, port_plain("noW", inp, g))
    if g == 1:
        assert_bits(got, k1_plain(inp))
    if g >= B:     # every pair faces pair 0's window
        wide = (*inp[:3], np.broadcast_to(inp[3][:1], inp[3].shape))
        assert_bits(got, k1_plain(wide))


# --- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("shape,nbytes,plan", [
    ((512, 128, 128, 128), 202_880, "S"),   # the harness's
    ((256, 32, 160, 192), 170_112, "S"),    # the main path's top shape
    ((256, 128, 160, 256), 333_952, "R"),   # the main path's
    ((256, 128, 128, 192), 235_648, "R")])
def test_now_plan_of_the_shapes(shape, nbytes, plan):
    """Plan S where the barriers, the raw ring, the slab and K1's
    resident A fit in 232,448 bytes, else R; the same rule whatever B
    and G."""
    B, R, L, W = shape
    assert sv.now_slab_bytes(R, L, W) == nbytes
    for g in (1, 4, B, 2 * B):
        assert sv.now_plan(B, R, L, W, g) == plan
    with pytest.raises(ValueError, match="no plan"):
        sv.now_plan(B, R, L, W, 0)


def test_now_and_nomax_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors both wrappers and their SIMT before-numbers run
    the plain versions and count no launch."""
    inp = lut_inputs(np.random.default_rng(9), 6, 16, 32, 64)
    counters = [sv.KERNELS[k].counter for k in ("noW", "nomax", "noW_simt",
                                                "nomax_simt")]
    before = [getattr(sv, c) for c in counters]
    for which in ("noW", "nomax"):
        want = port_plain(which, inp, 3)
        for fn in (sv.score_ablation, sv.score_ablation_simt):
            assert_bits([x.numpy() for x in fn(which, *(tt(a) for a in inp),
                                               G=3)], want)
    assert [getattr(sv, c) for c in counters] == before
