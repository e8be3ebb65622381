"""KX-I on K1's u8 tensor-core pipeline (strelka_tpu_torch/csrc/
score_best_offsets_tc.cu: score_best_offsets_tc_kernel<kClamped,
kBestOff>) against the JAX package, on the CPU.

KX-I (benchmarks/exp_exact_kernel.py _kernel_int8) is K1's function on
limbs clamped to 0..127. Its Pallas body indexes three limbs of the
two-limb LUT and raises, so its reference is the function:
strelka_tpu.ops.pallas_readlik.exact_best_offsets on deltas rebuilt from
the clamped limbs. The kernel keeps K1's Bw, ring and epilogue and
changes only the A words: limb_j clamped to 127 after the & 255, placed
in byte `code` of its word, a zero word for a code outside 0..3. This
file models those words in integers and K1's steps and lane epilogue
over them, and holds the model bit for bit against the port's plain
version (int8_best_offsets) and that against the JAX oracle.

The kernel cannot run here; tests/test_torch_cuda.py and chip_smoke.py
phase 2c hold it against the plain version on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strelka_tpu.ops import pallas_readlik as pk
from strelka_tpu.ops import readlik as rl
from strelka_tpu_torch.ops import score_variants as sv
from tests.test_torch_score_tc_ablation import (
    CHUNK, N_TILE, assert_bits, d_int, lut_inputs, word_bytes)
from tests.test_torch_score_tc_now_nomax import (
    bw_tile, lane_walk, step_sums, steps, tile_scores, tile_tie_inputs, tt)


def clamped_words(codes, delta):
    """KX-I's A words [B, 2, R, L] (limb 1, limb 0) in int64:
    min(limb_j, 127) << 8c for a code c in 0..3, else 0."""
    c = tt(codes).to(torch.int64)
    ok = (c >= 0) & (c < 4)
    di = d_int(delta)
    return torch.stack([torch.where(
        ok, ((di >> sh) & 255).clamp(max=127) << (8 * (c & 3)), 0)
        for sh in (8, 0)], 1)


def a_operand(codes, delta):
    """The A bytes [B, 2, R, 4Lp] of the clamped words; bases past L (to
    Lp, L rounded up to CHUNK) zero."""
    L = codes.shape[2]
    Lp = -(-L // CHUNK) * CHUNK
    return torch.nn.functional.pad(word_bytes(clamped_words(codes, delta)),
                                   (0, 4 * (Lp - L)))


def int8_walk(codes, delta, lnmis, win):
    """The kernel: K1's steps over the clamped A bytes and each step's
    one-hot Bw tile (u8 products summed exactly), then K1's lane
    epilogue (first max)."""
    a = a_operand(codes, delta)
    L, W = codes.shape[2], win.shape[2]
    tiles, acc = [], 0
    for nt, kc in steps(L, W):
        acc = (0 if kc == 0 else acc) + step_sums(
            a, bw_tile(win, kc * CHUNK, nt * N_TILE), kc)
        if kc == -(-L // CHUNK) - 1:
            tiles.append(tile_scores(acc, lnmis))
    return lane_walk(tiles, W, offsets=True)


def clamped_delta(delta):
    """numpy: delta rebuilt from its limbs clamped to 0..127."""
    d = (delta * rl.QUANT_SCALE).astype(np.int32)
    hi = np.minimum((d >> 8) & 255, 127)
    lo = np.minimum(d & 255, 127)
    return ((hi << 8) | lo).astype(np.float32) * rl.QUANT_INV


def jax_oracle(codes, delta, lnmis, win):
    """pallas_readlik.exact_best_offsets on the clamped deltas."""
    out = pk.exact_best_offsets(jnp.asarray(codes),
                                jnp.asarray(clamped_delta(delta)),
                                jnp.asarray(lnmis), jnp.asarray(win))
    return [np.asarray(x) for x in out]


def port_plain(inp):
    return [x.numpy() for x in sv.int8_best_offsets(*(tt(a) for a in inp))]


def limb_edge_inputs(rng, B, R, L, W):
    """Deltas whose limbs sit at 126, 127, 128 and 255 (each limb drawn
    from those four, so both limbs cross the clamp), a quarter of them
    negative (a negative d_int clamps its two's complement bytes), codes
    -1..4 and windows of codes -1..4."""
    edge = np.array([126, 127, 128, 255])
    hi = edge[rng.integers(0, 4, (B, R, L))]
    lo = edge[rng.integers(0, 4, (B, R, L))]
    d = (hi * 256 + lo).astype(np.int64)
    d = np.where(rng.random((B, R, L)) < 0.25, -d, d)
    delta = (d / rl.QUANT_SCALE).astype(np.float32)
    codes = rng.integers(-1, 5, (B, R, L)).astype(np.int8)
    lnmis = rng.normal(-80, 10, (B, R)).astype(np.float32)
    win = rng.integers(-1, 5, (B, L, W)).astype(np.int8)
    return codes, delta, lnmis, win


SHAPES = [(4, 40, 50, 70),      # R, L, W not multiples of 32/32/64
          (4, 64, 64, 192), (4, 33, 99, 129), (4, 32, 160, 256)]


@pytest.mark.parametrize("B,R,L,W", SHAPES)
def test_int8_model_bit_identical_to_plain_and_oracle(B, R, L, W):
    """The kernel's clamped A words through K1's steps and epilogue
    equal int8_best_offsets, and that equals the JAX oracle on the
    clamped deltas, bit for bit (LUT deltas, codes -1..4)."""
    inp = lut_inputs(np.random.default_rng(B * R + L + W + 8), B, R, L, W)
    assert (clamped_delta(inp[1]) != inp[1]).any()   # the clamp bites
    got = int8_walk(*inp)
    assert_bits(got, port_plain(inp))
    assert_bits(port_plain(inp), jax_oracle(*inp))


@pytest.mark.parametrize("B,R,L,W", [(4, 40, 64, 128), (3, 33, 99, 129)])
def test_int8_limbs_at_the_clamp(B, R, L, W):
    """Limbs at 126, 127, 128 and 255, negative deltas and codes 4 and
    -1: each word holds min(limb, 127) in byte `code`, a zero word
    outside codes 0..3, and the walk equals the plain version and the
    oracle bit for bit."""
    inp = limb_edge_inputs(np.random.default_rng(L + W), B, R, L, W)
    words = clamped_words(inp[0], inp[1])
    c = tt(inp[0]).to(torch.int64)
    di = d_int(inp[1])
    ok = (c >= 0) & (c < 4)
    for j, sh in enumerate((8, 0)):
        limb = (di >> sh) & 255
        assert set(limb[di >= 0].unique().tolist()) == {126, 127, 128, 255}
        want = torch.minimum(limb, torch.tensor(127))
        byte = (words[:, j] >> (8 * (c & 3))) & 255
        assert torch.equal(torch.where(ok, byte, 0), torch.where(ok, want, 0))
        assert bool((words[:, j][~ok] == 0).all())
        assert bool((words[:, j] < (1 << 32)).all())
    got = int8_walk(*inp)
    assert_bits(got, port_plain(inp))
    assert_bits(got, jax_oracle(*inp))


def test_int8_code4_pair_scores_lnmis():
    """A pair whose reads are all code 4 under non-zero deltas against a
    window of code 4 at its first offsets scores exactly lnmis at offset
    0, in the model, the plain version and the oracle."""
    inp = limb_edge_inputs(np.random.default_rng(4), 2, 32, 64, 64)
    inp[0][0] = 4
    inp[3][0, :, :7] = 4
    got = int8_walk(*inp)
    assert_bits(got, port_plain(inp))
    assert_bits(got, jax_oracle(*inp))
    assert_bits([got[0][0]], [inp[2][0]])
    np.testing.assert_array_equal(got[1][0], 0)


@pytest.mark.parametrize("W", [128, 192, 256])
def test_int8_ties_across_n_tiles(W):
    """Exact ties at the top across N-tile boundaries: the first of the
    two offsets wins, in the model, the plain version and the oracle."""
    B, R, L = 8, 40, 64
    inp, cols = tile_tie_inputs(np.random.default_rng(W + 1), B, R, L, W)
    got = int8_walk(*inp)
    want = np.array([cols[b % len(cols)][0] for b in range(B)])
    np.testing.assert_array_equal(got[1], np.broadcast_to(want[:, None],
                                                          (B, R)))
    assert_bits(got, port_plain(inp))
    assert_bits(got, jax_oracle(*inp))


def test_int8_wrappers_on_cpu_run_the_plain_version():
    """On CPU tensors KX-I and its mma.sync before-number run the plain
    version and count no launch; the table pairs the two."""
    inp = lut_inputs(np.random.default_rng(5), 3, 16, 32, 64)
    counters = [sv.KERNELS[k].counter for k in ("int8", "int8_mma")]
    before = [getattr(sv, c) for c in counters]
    want = port_plain(inp)
    for fn in (sv.score_int8, sv.score_int8_mma):
        assert_bits([x.numpy() for x in fn(*(tt(a) for a in inp))], want)
    assert [getattr(sv, c) for c in counters] == before
    k, mma = sv.KERNELS["int8"], sv.KERNELS["int8_mma"]
    assert k.kernel == "score_best_offsets_tc_kernel<kClamped, kBestOff>"
    assert k.source == sv.TC_SOURCE and mma.before_of == k.label
    assert sv.VARIANTS["int8"] == "int8"
