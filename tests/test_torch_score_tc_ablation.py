"""KX-A noA and nodot on K1's u8 tensor-core pipeline (strelka_tpu_torch/
csrc/score_best_offsets_tc.cu: score_best_offsets_tc_kernel<kUnmasked,
kBestOff> and <kStandard, kBestOff, kSlabSlice>) against the JAX
package's interpret-mode Pallas bodies, on the CPU.

noA (benchmarks/exp_exact_kernel.py _kernel_limb2_noA) counts each
base's limbs against every window code 0..3 whatever the read's code.
The kernel's A words hold the limb in all four code bytes (limb *
0x01010101) on K1's contraction axis k = 4l + c, against K1's one-hot
Bw; this file models that product exactly, in integers.

nodot (_kernel_limb2_nodot) scores s[r,w] = (A[r,w] + Wo[r,w]) * 2^-11 +
lnmis[r] from slices of its two slabs, for R, W <= 4L. The kernel keeps
K1's slab build and replaces the wgmma by reads of the slabs' terms: in
step (N tile nt, K chunk kc) the thread that holds (read r, offset w)
adds byte w div L of read r's limb-1 A word at base w mod L where that
base lies in chunk kc, and the Bw byte at k = 4 (r mod L) + r div L of
offset w where base r mod L lies in chunk kc. This file models that
step walk over the resident A (the whole read length) and over the A
ring (one chunk a step), and K1's epilogue: the first max merged over
ascending N tiles with a strict >.

The kernels cannot run here; tests/test_torch_cuda.py and chip_smoke.py
phase 2c hold them against the plain versions on the card.
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
CHUNK = 32              # bases per K chunk of the kernel
G = 2


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call of the harness runs in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def lut_inputs(rng, B, R, L, W):
    """The LUT's deltas under every code (code 4 and negative codes
    included), windows of codes -1..4."""
    dl, ml = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    codes = rng.integers(-1, 5, (B, R, L)).astype(np.int8)
    lnmis = np.where((codes >= 0) & (codes < 4), ml[q], 0.0).sum(
        axis=2).astype(np.float32)
    win = rng.integers(-1, 5, (B, L, W)).astype(np.int8)
    return codes, dl[q].astype(np.float32), lnmis, win


def d_int(delta):
    return sv._d_int(torch.as_tensor(np.ascontiguousarray(delta))).to(
        torch.int64)


def word_bytes(words):
    """u32 words (in int64) [..., L] -> their bytes [..., 4L], byte c of
    base l at k = 4l + c (little-endian, as the kernel stores them)."""
    b = torch.stack([(words >> (8 * c)) & 255 for c in range(4)], dim=-1)
    return b.reshape(*words.shape[:-1], -1)


def bw_operand(win):
    """K1's Bw [B,4L,W]: [win[l,w] == c] at k = 4l + c, a window code
    read as an unsigned byte (so -1 and 4 match nothing)."""
    w = torch.as_tensor(np.ascontiguousarray(win)).to(torch.int64) & 255
    oh = torch.stack([w == c for c in range(4)], dim=2)       # [B,L,4,W]
    return oh.reshape(w.shape[0], -1, w.shape[2]).to(torch.int64)


def first_max_by_tiles(s):
    """K1's epilogue on s [B,R,W]: the first max of each N tile, merged
    over ascending tiles with a strict >."""
    W = s.shape[-1]
    run_s = torch.full(s.shape[:2], -torch.inf)
    run_w = torch.full(s.shape[:2], torch.iinfo(torch.int32).max,
                       dtype=torch.int32)
    for w0 in range(0, W, N_TILE):
        tb, to = torch.max(s[..., w0:min(W, w0 + N_TILE)], dim=-1)
        take = tb > run_s
        run_s = torch.where(take, tb, run_s)
        run_w = torch.where(take, (to + w0).to(torch.int32), run_w)
    return run_s.numpy(), run_w.numpy()


def epilogue(S, lnmis):
    """S (int) -> one f32 conversion, * 2^-11 + lnmis, first max."""
    assert int(S.max()) < 2 ** 31
    s = S.to(torch.int32).to(torch.float32) * np.float32(1 / 2048)
    return first_max_by_tiles(s + torch.as_tensor(lnmis)[..., None])


# --- noA: the replicated-word product ---------------------------------------

def noa_model(codes, delta, lnmis, win):
    """The kernel's noA: u8 A words limb_j * 0x01010101 (no code read)
    times K1's Bw over k = 4l + c, S = S_1*256 + S_0 exactly."""
    di = d_int(delta)
    bw = bw_operand(win)
    S = 0
    for shift, weight in ((8, 256), (0, 1)):
        a = word_bytes(((di >> shift) & 255) * 0x01010101)   # [B,R,4L]
        assert int(a.max()) <= 255
        S = S + weight * torch.bmm(a, bw)
    return epilogue(S, lnmis)


# --- nodot: the step walk ---------------------------------------------------

def limb1_a_words(codes, delta):
    """K1's limb-1 A bytes [B,R,4Lp]: limb_1 << 8c for a code c in 0..3,
    else 0; bases past L (to Lp, L rounded up to CHUNK) zero."""
    c = torch.as_tensor(np.ascontiguousarray(codes)).to(torch.int64)
    ok = (c >= 0) & (c < 4)
    words = torch.where(ok, ((d_int(delta) >> 8) & 255) << (8 * (c & 3)), 0)
    L = c.shape[2]
    Lp = -(-L // CHUNK) * CHUNK
    return torch.nn.functional.pad(word_bytes(words), (0, 4 * (Lp - L)))


def a_image(a_bytes):
    """The A words [B,R,4n] of n bases (n/4 quads) as shared memory
    holds them: each group of 8 reads one row of core matrices, quad kq
    at kq * 128 bytes, read i8 of the group at 16 * i8 in it. Returns
    [B, R/8 (rounded up), 128 * n/4]; reads past R zero."""
    B, R, K = a_bytes.shape
    Rp = -(-R // 8) * 8
    a = torch.nn.functional.pad(a_bytes, (0, 0, 0, Rp - R))
    a = a.reshape(B, Rp // 8, 8, K // 16, 16).permute(0, 1, 3, 2, 4)
    return a.reshape(B, Rp // 8, -1)


def bw_image(win, l0, w0):
    """Step (nt, kc)'s Bw tile as shared memory holds it: offset w (of
    the tile's N_TILE) and quad kq of the chunk's CHUNK bases at
    (w >> 3) * 1024 + kq * 128 + 16 * (w & 7), byte 4k + c of base 4kq + k
    = [win[l0 + 4kq + k, w0 + w] == c]; rows past L, columns past W 0."""
    B, L, W = win.shape
    bw = torch.zeros((B, CHUNK, 4, N_TILE), dtype=torch.int64)
    full = bw_operand(win).reshape(B, L, 4, W)
    nl, nw = min(CHUNK, L - l0), min(N_TILE, W - w0)
    bw[:, :nl, :, :nw] = full[:, l0:l0 + nl, :, w0:w0 + nw]
    # [B, l, c, w] -> [B, w>>3, kq, w&7, k, c]
    img = bw.reshape(B, CHUNK // 4, 4, 4, N_TILE // 8, 8).permute(
        0, 4, 1, 5, 2, 3)
    return img.reshape(B, -1)


NO_KEY = 0xFFFF


def slab_keys(L, W, w0):
    """The kernel's 16-bit keys of N tile w0's offsets (slab_keys): (the
    chunk of base w mod L << 10) | its byte in the chunk's A row (k = 4l
    + c, K-major by quads); NO_KEY past W. The kernel packs the keys of
    offsets 2i and 2i+1 into one 32-bit register; the fields fit."""
    keys = []
    for w in range(w0, w0 + N_TILE):
        c, l = divmod(w, L)
        byte = ((l % CHUNK) >> 2) * 128 + 4 * (l & 3) + c
        assert byte < 1024 and l // CHUNK < NO_KEY >> 10
        keys.append((l // CHUNK) << 10 | byte if w < W else NO_KEY)
    return keys


def nodot_walk(codes, delta, win, resident):
    """nodot's sums S [B,R,W] by the kernel's step walk over its shared
    memory images (slab_slice), and how often each (read, offset) was
    given an A term and a Wo term. `resident`: the A words of the whole
    read length; else each step's chunk alone, as K1's A ring holds it."""
    B, R, L = codes.shape
    W = win.shape[2]
    assert R <= 4 * L and W <= 4 * L
    a_all = limb1_a_words(codes, delta)
    S = torch.zeros((B, R, W), dtype=torch.int64)
    a_count = np.zeros((R, W), np.int64)
    wo_count = np.zeros((R, W), np.int64)
    r = torch.arange(R)
    rc, rl = r // L, r % L
    n_k = -(-L // CHUNK)
    img_all = a_image(a_all)
    for w0 in range(0, W, N_TILE):
        keys = slab_keys(L, W, w0)
        acc = torch.zeros((B, R, N_TILE), dtype=torch.int64)
        for kc in range(n_k):
            # a_rows: chunk kc's quads of the resident image, or the slot
            # holding chunk kc alone
            img = (img_all[..., kc * 1024:(kc + 1) * 1024] if resident else
                   a_image(a_all[:, :, 4 * kc * CHUNK:4 * (kc + 1) * CHUNK]))
            a_rows = img[:, r // 8]                          # [B,R,1024]
            bw = bw_image(win, kc * CHUNK, w0)
            lr = rl - kc * CHUNK
            here = (lr >= 0) & (lr < CHUNK)
            wo_base = (lr >> 2) * 128 + 4 * (lr & 3) + rc
            for wl in range(N_TILE):
                j, t4, e = wl // 8, (wl % 8) // 2, wl % 2
                k = keys[wl]
                if k >> 10 == kc:
                    acc[:, :, wl] += a_rows.gather(
                        2, (16 * (r % 8) + (k & 1023)).expand(B, R)[..., None]
                    )[..., 0]
                    a_count[:, w0 + wl] += 1
                idx = wo_base + 32 * t4 + j * 1024 + 16 * e
                add = bw[:, idx.clamp(0, bw.shape[1] - 1)]
                acc[:, :, wl] += torch.where(here, add, 0)
                if w0 + wl < W:
                    wo_count[here.numpy(), w0 + wl] += 1
        S[:, :, w0:w0 + N_TILE] = acc[:, :, :min(N_TILE, W - w0)]
    return S, a_count, wo_count


def nodot_model(codes, delta, lnmis, win, resident=True):
    S, _, _ = nodot_walk(codes, delta, win, resident)
    assert int(S.max()) <= 256
    return epilogue(S, lnmis)


# --- references -------------------------------------------------------------

def interpret_body(variant, inp):
    B, R, L = inp[0].shape
    fn = xk.build(variant, B, R, L, inp[3].shape[2], G)
    return [np.asarray(x) for x in fn(*(jnp.asarray(a) for a in inp))]


def port_plain(which, inp):
    return [x.numpy() for x in sv.ablation_best_offsets(
        which, *(torch.from_numpy(np.ascontiguousarray(a)) for a in inp))]


def assert_bits(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def tie_inputs(rng, B, R, L, W):
    """Exact ties across N tiles for both ablations. noA: window codes
    0..3 everywhere but code 4 at one offset of one base per pair, so
    every other offset ties (the first wins). nodot: deltas below 2^-3
    (limb 1 = 0, an A slab of 0) and window row r of codes 1..4 but for
    code 0 at two offsets on both sides of, left of, right of or a tile
    across an N-tile boundary (read r's Wo row, code r div L = 0, is 1
    there alone; needs R <= L)."""
    cols = [(t + a, t + b) for t in range(N_TILE, W, N_TILE)
            for a, b in ((-1, 0), (-2, -1), (0, 1), (-1, N_TILE))
            if t + b < W]
    codes = rng.integers(-1, 5, (B, R, L)).astype(np.int8)
    delta = (rng.integers(0, 256, (B, R, L)) / 2048).astype(np.float32)
    lnmis = rng.normal(-100, 10, (B, R)).astype(np.float32)
    win = rng.integers(1, 5, (B, L, W)).astype(np.int8)
    for r in range(R):
        for w in cols[r % len(cols)]:
            win[:, r, w] = 0
    noa_win = rng.integers(0, 4, (B, L, W)).astype(np.int8)
    for b in range(B):
        noa_win[b, int(rng.integers(0, L)), N_TILE + b] = 4
    return (codes, delta, lnmis, win), (codes, delta, lnmis, noa_win), cols


# --- noA --------------------------------------------------------------------

NOA_SHAPES = [(4, 40, 50, 70),      # R, L, W not multiples of 32/32/64
              (2, 64, 64, 192), (2, 33, 99, 129), (2, 32, 160, 256)]


@pytest.mark.parametrize("B,R,L,W", NOA_SHAPES)
def test_noa_replicated_words_bit_identical_to_interpret_body(
        interpret, B, R, L, W):
    inp = lut_inputs(np.random.default_rng(B * R + L + W), B, R, L, W)
    got = noa_model(*inp)
    assert_bits(got, interpret_body("limb2-noA", inp))
    assert_bits(got, port_plain("noA", inp))


def test_noa_reads_no_codes_and_counts_code4_under_deltas():
    """The replicated words ignore the read's code: any codes (4 and
    negative under non-zero deltas) give the same result, each base
    scoring against every window code 0..3."""
    inp = lut_inputs(np.random.default_rng(11), 2, 40, 64, 128)
    other = (np.full_like(inp[0], 4), *inp[1:])
    assert_bits(noa_model(*inp), noa_model(*other))
    # a word is the limb in every code byte
    di = d_int(inp[1])
    a = word_bytes(((di >> 8) & 255) * 0x01010101).reshape(*di.shape, 4)
    assert torch.equal(a, ((di >> 8) & 255)[..., None].expand(*di.shape, 4))


# --- nodot ------------------------------------------------------------------

NODOT_SHAPES = [(4, 40, 50, 70),     # R, L, W not multiples of 32/32/64
                (2, 64, 16, 64),     # R = 4L and W = 4L
                (2, 128, 32, 128),   # R = W = 4L, one chunk
                (2, 33, 99, 129), (2, 64, 160, 256)]


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("B,R,L,W", NODOT_SHAPES)
def test_nodot_step_walk_bit_identical_to_interpret_body(
        interpret, B, R, L, W, resident):
    inp = lut_inputs(np.random.default_rng(B * R + L + W + 7), B, R, L, W)
    got = nodot_model(*inp, resident=resident)
    assert_bits(got, interpret_body("limb2-nodot", inp))
    assert_bits(got, port_plain("nodot", inp))


@pytest.mark.parametrize("B,R,L,W", NODOT_SHAPES + [(1, 200, 50, 200)])
def test_nodot_adds_each_term_exactly_once(B, R, L, W):
    """Over a tile's steps each (read, offset) gets its A term once and
    its Wo term once, from the resident A and the ring alike, and the
    sums are the slabs' A[r,w] + Wo[r,w]."""
    inp = lut_inputs(np.random.default_rng(R + W), B, R, L, W)
    want = None
    for resident in (True, False):
        S, a_count, wo_count = nodot_walk(inp[0], inp[1], inp[3], resident)
        assert (a_count == 1).all() and (wo_count == 1).all()
        want = S if want is None else want
        assert torch.equal(S, want)
    c = torch.from_numpy(inp[0]).to(torch.int64)
    hi = (d_int(inp[1]) >> 8) & 255
    a = torch.cat([torch.where(c == k, hi, 0) for k in range(4)], 2)
    wo = torch.cat([torch.from_numpy(inp[3]).to(torch.int64) == k
                    for k in range(4)], 1).to(torch.int64)
    assert torch.equal(want, a[:, :, :W] + wo[:, :R])


# --- ties and code 4 --------------------------------------------------------

@pytest.mark.parametrize("W", [128, 192, 256])
def test_ties_across_n_tiles(interpret, W):
    """Exact ties across N-tile boundaries resolve to the first offset
    in both models, as in the bodies."""
    B, R, L = 2, 40, 64
    nodot_inp, noa_inp, cols = tie_inputs(np.random.default_rng(W), B, R, L,
                                          W)
    got = nodot_model(*nodot_inp)
    assert_bits(got, interpret_body("limb2-nodot", nodot_inp))
    assert_bits(nodot_model(*nodot_inp, resident=False), got)
    want_off = np.array([cols[r % len(cols)][0] for r in range(R)])
    np.testing.assert_array_equal(got[1], np.broadcast_to(want_off, (B, R)))
    got = noa_model(*noa_inp)
    assert_bits(got, interpret_body("limb2-noA", noa_inp))
    np.testing.assert_array_equal(got[1], 0)


def test_code4_and_negative_codes(interpret):
    """A read code of 4 or below 0 puts no term in nodot's A slab, a
    window code of 4 or below 0 none in its Wo slab or noA's sums; a
    pair of such codes scores lnmis (nodot) or lnmis at the first
    window column of valid codes (noA)."""
    B, R, L, W = 2, 40, 32, 96
    codes, delta, lnmis, win = lut_inputs(np.random.default_rng(5), B, R, L,
                                          W)
    codes[0] = 4
    codes[1] = -1
    win[0] = 4
    win[1] = -1
    win[1, :, 70] = 2
    inp = (codes, delta, lnmis, win)
    got = nodot_model(*inp)
    assert_bits(got, interpret_body("limb2-nodot", inp))
    np.testing.assert_array_equal(got[0][0], lnmis[0])
    np.testing.assert_array_equal(got[1][0], 0)
    got = noa_model(*inp)
    assert_bits(got, interpret_body("limb2-noA", inp))
    np.testing.assert_array_equal(got[0][0], lnmis[0])
    np.testing.assert_array_equal(got[1], np.broadcast_to(
        np.array([[0], [70]]), (B, R)))


# --- the wrappers and the table on the CPU ----------------------------------

def test_wrappers_and_kernel_table():
    """The four ablations name their tensor-core instantiations; their
    SIMT kernels are before-numbers with their own counters; on CPU
    tensors every wrapper runs the plain version and counts nothing."""
    K = sv.KERNELS
    assert sv.TC_ABLATIONS == ("noA", "noW", "nomax", "nodot")
    assert K["noA"].kernel == ("score_best_offsets_tc_kernel<kUnmasked, "
                               "kBestOff>")
    assert K["nodot"].kernel == ("score_best_offsets_tc_kernel<kStandard, "
                                 "kBestOff, kSlabSlice>")
    for which in sv.TC_ABLATIONS:
        tc, simt = K[which], K[f"{which}_simt"]
        assert tc.source == sv.TC_SOURCE and simt.source == sv.SOURCE
        assert simt.before_of == tc.label and not tc.before_of
        assert tc.counter != simt.counter
        assert tc.function == simt.function == which
        assert sv.variant_kernel(f"limb2-{which}")[1] is tc
    for which, variant in (("noW", "kNoW"), ("nomax", "kNoMax")):
        assert K[f"{which}_simt"].kernel == (
            f"score_ablation_kernel<{variant}>")
    inp = [torch.from_numpy(a) for a in lut_inputs(
        np.random.default_rng(3), 2, 16, 32, 64)]
    counters = [getattr(sv, K[k].counter) for k in K]
    for which in sv.TC_ABLATIONS:
        want = port_plain(which, [a.numpy() for a in inp])
        for fn in (sv.score_ablation, sv.score_ablation_simt):
            assert_bits([x.numpy() for x in fn(which, *inp)], want)
    assert [getattr(sv, K[k].counter) for k in K] == counters


def test_runner_names_the_tensor_core_ablations(capsys):
    assert sv.main(["limb2-noA", "limb2-nodot", "--device", "cpu", "--B",
                    "4", "--R", "16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert all("body_exact=True" in l for l in lines)
    assert "kernel=score_best_offsets_tc_kernel<kUnmasked, kBestOff>" in (
        lines[0])
    assert ("kernel=score_best_offsets_tc_kernel<kStandard, kBestOff, "
            "kSlabSlice>") in lines[1]


def test_nodot_keys_fit_sixteen_bits_at_the_longest_reads():
    """At K1's longest reads (1816 bases, 57 chunks) and W = 4L every
    key's chunk and byte fit its 16 bits, below NO_KEY, and the keys of
    a tile name each base of the read once per code."""
    L = 1816
    seen = set()
    for w0 in range(0, 4 * L, N_TILE):
        for i, k in enumerate(slab_keys(L, 4 * L, w0)):
            assert (k < NO_KEY) == (w0 + i < 4 * L)
            seen.add(k)
    assert len(seen - {NO_KEY}) == 4 * L
