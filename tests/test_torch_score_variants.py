"""The port's K1-x variants (strelka_tpu_torch/ops/score_variants.py)
against the JAX package's A/B harness benchmarks/exp_exact_kernel.py, on
the CPU.

Each plain version must equal the harness bit for bit (tolerance zero):
the interpret-mode Pallas kernels where they run (fused, fusedwhole,
fusedin and its packed entry, fusedlm, limb2k, and the timing ablations
limb2-noA/-noW/-nomax/-nodot), and, where the Pallas body was written
for the 3-limb LUT and cannot run, pallas_readlik.exact_best_offsets
on the function the body computes (hap2 per window segment, int8 on
deltas rebuilt from the body's clamped limbs). The CUDA kernels are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 2c).
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
from strelka_tpu_torch.ops import readlik as trl
from strelka_tpu_torch.ops import score_kernel as sk
from strelka_tpu_torch.ops import score_variants as sv

B, R, W, G = 4, 16, 64, 2
LENGTHS = (32, 64, 160)


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call of the harness runs in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def harness_inputs(rng, L, W=W):
    """The harness's distribution (exp_exact_kernel.py:757-762): delta
    and lnmis are 0 under code 4."""
    dl, ml = rl.quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    delta = np.where(codes < 4, dl[q], 0).astype(np.float32)
    lnmis = np.where(codes < 4, ml[q], 0).sum(2).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    return codes, delta, lnmis, win


def tie_inputs(rng, L, W=W):
    """Exact ties (the read tiled, so offsets w and w+L tie), a near-tie
    a single q=2 base away, a code-4 stretch under non-zero deltas
    against window code 4, and an all-4 pair that scores exactly lnmis."""
    dl, ml = rl.quantized_qscore_luts()
    read = rng.integers(0, 4, (L,))
    codes = np.broadcast_to(read, (B, R, L)).astype(np.int8).copy()
    hp = np.tile(read, (W + L) // L + 1)
    win = np.stack([hp[l:l + W] for l in range(L)], axis=0)
    win = np.broadcast_to(win, (B, L, W)).astype(np.int8).copy()
    win[0, int(rng.integers(0, L)), min(37, W - 1)] ^= 1
    q = rng.integers(2, 42, (B, R, L))
    q[1] = 2
    codes[2, :, :5] = 4
    win[2, :5, :] = 4
    codes[3] = 4
    delta = dl[q]
    lnmis = ml[q].sum(axis=2).astype(np.float32)
    return codes, delta, lnmis, win


def t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def assert_bits(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def jax_call(fn, *arrs):
    return [np.asarray(x) for x in fn(*(jnp.asarray(a) for a in arrs))]


def port_packed(codes, delta, lnmis, win, fold):
    c, d, m, w = t(codes, delta, lnmis, win)
    packed = sv.pack_operands(c, d, m, fold_lnmis=fold)
    out = sv.score_packed(packed, None if fold else m, w, n_reads=R)
    return [x.numpy() for x in sv.unpack_best_offsets(out)]


def host_pack(codes, delta, lnmis, L, fold):
    """The harness's host packing (exp_exact_kernel.py:799-806)."""
    d_int = (delta * xk.Q2_SCALE).astype(np.int32)
    packed = (d_int << 3) | codes.astype(np.int32)
    if fold:
        rows = -(-R // L)
        lm = np.pad(lnmis.view(np.int32), ((0, 0), (0, rows * L - R)))
        packed = np.concatenate([packed, lm.reshape(B, rows, L)], axis=1)
    return packed


# --- KX-P: fused, fusedwhole, fusedin, fusedlm ------------------------------

@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("variant", ["fused", "fusedwhole", "fusedin",
                                     "fusedlm"])
def test_packed_bit_identical_to_interpret_kernel(interpret, variant, L):
    inp = harness_inputs(np.random.default_rng(L), L)
    want = jax_call(xk.build(variant, B, R, L, W, G), *inp)
    assert_bits(port_packed(*inp, fold=variant == "fusedlm"), want)
    assert_bits(want, jax_call(pk.exact_best_offsets, *inp))


@pytest.mark.parametrize("fold", [False, True])
def test_pack_and_packed_entry_match_the_harness(interpret, fold):
    """The port's pack equals the harness's host pack bit for bit, and
    KX-P's plain version on it equals the packed entry point that the
    harness times (fusedin's / fusedlm's fn.packed)."""
    L = 32
    codes, delta, lnmis, win = harness_inputs(np.random.default_rng(9), L)
    want_packed = host_pack(codes, delta, lnmis, L, fold)
    packed = sv.pack_operands(*t(codes, delta, lnmis), fold_lnmis=fold)
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    fn = xk.build("fusedlm" if fold else "fusedin", B, R, L, W, G)
    assert fn.lm_rows == packed.shape[1] - R
    want = jax_call(fn.packed, want_packed, lnmis, win)
    m, w = t(lnmis, win)
    out = sv.score_packed(packed, None if fold else m, w, n_reads=R)
    assert_bits([x.numpy() for x in sv.unpack_best_offsets(out)], want)


def test_packed_reads_checks_the_folded_rows():
    packed = torch.zeros((2, 17, 16), dtype=torch.int32)
    assert sv.packed_reads(packed, None, n_reads=16) == 16
    assert sv.packed_reads(packed, torch.zeros(2, 17)) == 17
    for n in (None, 15, 17):
        with pytest.raises(ValueError):
            sv.packed_reads(packed, None, n_reads=n)


# --- KX-K: limb2k -----------------------------------------------------------

@pytest.mark.parametrize("L", LENGTHS)
def test_onesum_bit_identical_to_interpret_limb2k(interpret, L):
    inp = harness_inputs(np.random.default_rng(100 + L), L)
    want = jax_call(xk.build("limb2k", B, R, L, W, G), *inp)
    got = [x.numpy() for x in sv.score_onesum(*t(*inp))]
    assert_bits(got, want)
    assert_bits(got, jax_call(pk.exact_best_offsets, *inp))


def test_onesum_equals_exact_best_offsets_and_stops_at_256():
    """At L = 256 with every base matching at the largest quantized
    delta the one sum is still exact and equals K1; above 256 the plain
    version raises."""
    rng = np.random.default_rng(5)
    dl, ml = trl.quantized_qscore_luts()
    L = 256
    codes = np.zeros((2, 8, L), np.int8)
    win = np.zeros((2, L, 16), np.int8)
    win[1] = rng.integers(0, 5, (L, 16))
    delta = np.full((2, 8, L), dl[127], np.float32)
    lnmis = np.full((2, 8), ml[127] * L, np.float32)
    inp = t(codes, delta, lnmis, win)
    assert_bits([x.numpy() for x in sv.onesum_best_offsets(*inp)],
                [x.numpy() for x in sk.exact_best_offsets(*inp)])
    long = t(np.zeros((1, 2, 257), np.int8), np.zeros((1, 2, 257), np.float32),
             np.zeros((1, 2), np.float32), np.zeros((1, 257, 8), np.int8))
    with pytest.raises(ValueError, match="L <= 256"):
        sv.onesum_best_offsets(*long)
    with pytest.raises(ValueError, match="L <= 256"):
        sv.score_onesum(*long)


# --- KX-H: hap2, held to the harness's oracle (main_hap2 :933-943) ---------

@pytest.mark.parametrize("L", LENGTHS)
def test_hap_matches_the_oracle_per_window(L):
    H = 2
    codes, delta, lnmis, win = harness_inputs(np.random.default_rng(200 + L),
                                              L, W=H * W)
    best, off = sv.score_hap(*t(codes, delta, lnmis, win), H)
    assert best.shape == (B, R, H) and off.dtype == torch.int32
    for h in range(H):
        want = jax_call(pk.exact_best_offsets, codes, delta, lnmis,
                        win[:, :, h * W:(h + 1) * W])
        assert_bits([best[..., h].numpy(), off[..., h].numpy()], want)
    with pytest.raises(ValueError):
        sv.hap_best_offsets(*t(codes, delta, lnmis, win), 3)


# --- KX-I: int8 on clamped limbs --------------------------------------------

def clamped_delta(delta):
    """numpy: delta rebuilt from its limbs clamped to 0..127."""
    d = (delta * rl.QUANT_SCALE).astype(np.int32)
    hi = np.minimum((d >> 8) & 255, 127)
    lo = np.minimum(d & 255, 127)
    return ((hi << 8) | lo).astype(np.float32) * rl.QUANT_INV


@pytest.mark.parametrize("L", LENGTHS)
def test_int8_matches_the_oracle_on_clamped_limbs(L):
    codes, delta, lnmis, win = harness_inputs(np.random.default_rng(300 + L),
                                              L)
    dc = clamped_delta(delta)
    assert (dc != delta).any()    # the clamp bites at these qscores
    np.testing.assert_array_equal(sv.clamp_limbs(torch.from_numpy(delta)),
                                  dc)
    got = [x.numpy() for x in sv.score_int8(*t(codes, delta, lnmis, win))]
    assert_bits(got, jax_call(pk.exact_best_offsets, codes, dc, lnmis, win))


# --- KX-A: the timing ablations, held to their interpret-mode bodies --------

ABLATIONS = {"limb2-noA": "noA", "limb2-noW": "noW",
             "limb2-nomax": "nomax", "limb2-nodot": "nodot"}


@pytest.mark.parametrize("L,make", [(32, harness_inputs),
                                    (64, harness_inputs),
                                    (160, harness_inputs),
                                    (32, tie_inputs), (64, tie_inputs)])
@pytest.mark.parametrize("variant", sorted(ABLATIONS))
def test_ablation_bit_identical_to_interpret_body(interpret, variant, L,
                                                  make):
    """Each ablation's plain version (and its wrapper on the CPU) equals
    its Pallas body's result, which on the harness's inputs differs from
    K1's by design."""
    inp = make(np.random.default_rng(500 + L), L)
    want = jax_call(xk.build(variant, B, R, L, W, G), *inp)
    which = ABLATIONS[variant]
    assert_bits([x.numpy() for x in sv.score_ablation(which, *t(*inp), G)],
                want)
    assert_bits([x.numpy() for x in sv.KERNELS[which].plain(*t(*inp), G)],
                want)
    if make is harness_inputs:
        k1 = jax_call(pk.exact_best_offsets, *inp)
        assert any(not np.array_equal(a, b) for a, b in zip(want, k1))


def test_ablation_domains():
    """noW scores each pair against the window of the first pair of its
    grid step of G (any B: the last step may be short); nodot reads its
    slabs only within R, W <= 4L; an unknown ablation or G < 1 raises."""
    c, d, m, w = t(*harness_inputs(np.random.default_rng(8), 16))
    got = sv.score_ablation("noW", c, d, m, w, G=3)
    want = sk.exact_best_offsets(c, d, m, w[[0, 0, 0, 3]])
    assert_bits([x.numpy() for x in got], [x.numpy() for x in want])
    wide = torch.zeros((B, 16, 4 * 16 + 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="4L"):
        sv.score_ablation("nodot", c, d, m, wide)
    with pytest.raises(ValueError, match="unknown ablation"):
        sv.score_ablation("noX", c, d, m, w)
    with pytest.raises(ValueError, match="G must be"):
        sv.score_ablation("noW", c, d, m, w, G=0)


# --- ties and code 4, on every variant --------------------------------------

@pytest.mark.parametrize("L", (32, 64))
def test_ties_and_code4_on_every_variant(interpret, L):
    """Exact ties resolve to the first offset, a code of 4 on either
    side matches nothing and an all-4 pair scores exactly lnmis, on
    every plain version as on its reference."""
    inp = tie_inputs(np.random.default_rng(400 + L), L)
    codes, delta, lnmis, win = inp
    want = jax_call(pk.exact_best_offsets, *inp)
    for variant in ("fused", "fusedwhole", "fusedin", "fusedlm"):
        assert_bits(jax_call(xk.build(variant, B, R, L, W, G), *inp), want)
        assert_bits(port_packed(*inp, fold=variant == "fusedlm"), want)
    assert_bits(jax_call(xk.build("limb2k", B, R, L, W, G), *inp), want)
    assert_bits([x.numpy() for x in sv.score_onesum(*t(*inp))], want)
    best, off = sv.score_hap(*t(codes, delta, lnmis,
                                np.concatenate([win, win[..., ::-1]], 2)), 2)
    assert_bits([best[..., 0].numpy(), off[..., 0].numpy()], want)
    assert_bits([best[..., 1].numpy(), off[..., 1].numpy()],
                jax_call(pk.exact_best_offsets, codes, delta, lnmis,
                         np.ascontiguousarray(win[..., ::-1])))
    got = [x.numpy() for x in sv.score_int8(*t(*inp))]
    assert_bits(got, jax_call(pk.exact_best_offsets, codes,
                              clamped_delta(delta), lnmis, win))
    assert int(want[1][1].max()) == 0             # ties: the first offset
    np.testing.assert_array_equal(want[0][3], lnmis[3])
    np.testing.assert_array_equal(want[1][3], 0)


# --- the harness's constants, and the wrappers on the CPU -------------------

def test_quant2_luts_and_limbs_are_the_ports():
    for a, b in zip(xk._quant2_luts(), trl.quantized_qscore_luts()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert xk.LIMBS2 == trl.LIMBS
    assert xk.Q2_SCALE == trl.QUANT_SCALE and xk.Q2_INV == trl.QUANT_INV


def test_wrappers_on_cpu_launch_nothing():
    """Every kernel of the table runs its plain version on CPU tensors
    and counts no launch."""
    inp = t(*harness_inputs(np.random.default_rng(6), 32, W=2 * W))
    counters = [k.counter for k in sv.KERNELS.values()]
    assert len(set(counters)) == len(sv.KERNELS) == 19
    before = [getattr(sv, c) for c in counters] + [sk.LAUNCHES]
    for k in sv.KERNELS.values():
        best, off = k.call(*k.prepare(inp, G))
        assert best.dtype == torch.float32 and off.dtype == torch.int32
    assert [getattr(sv, c) for c in counters] + [sk.LAUNCHES] == before


# --- the runner -------------------------------------------------------------

def test_runner_on_cpu(capsys):
    """K1's function and hap2 are exact against the harness's oracle;
    int8 and the ablations compute another function by design, so only
    their body check holds."""
    names = ["fusedlm@2", "limb2k", "hap2", "int8", "limb2-noW@2"]
    assert sv.main([*names, "--device", "cpu", "--B", "4", "--R", "16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [l.split(":")[0] for l in lines] == names
    assert all("body_exact=True" in l for l in lines)
    assert all(" exact=True" in l for l in lines[:3])
    assert all(" exact=False" in l for l in lines[3:])
    assert ("kernel=score_best_offsets_tc_kernel<kPackedFold, kPairOut>"
            in lines[0])
    assert "kernel=score_highest_tc_kernel<kOneSum>" in lines[1]
    assert "kernel=score_best_offsets_tc_kernel<kStandard, kHapOut>" in lines[2]
    assert ("kernel=score_best_offsets_tc_kernel<kStandard, kBestOff, "
            "kProduct, kGroupSlab | kGroupRing> plan=S") in lines[4]


def test_runner_raises_on_ablations_and_unknown_names():
    """The ablations run (test_runner_on_cpu); the runner raises on one
    outside its body's domain (nodot reads its slabs within R <= 4L)
    and, before any work, on an unknown name."""
    with pytest.raises(ValueError, match="4L"):
        sv.main(["limb2-nodot", "--device", "cpu", "--B", "2", "--R",
                 "513"])
    with pytest.raises(ValueError, match="unknown variant"):
        sv.main(["base", "limb3", "--device", "cpu"])
    assert sv.variant_kernel("limb2r@8") == ("limb2r", sv.K1, 8)
    assert sv.variant_kernel("limb2-noW")[1:] == (sv.KERNELS["noW"], 4)


def test_runner_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sv.main(["base", "--B", "2", "--R", "2"])


def test_runner_inputs_are_the_harness_draws():
    """harness_inputs draws what the harness's main draws from seed 0
    (q, codes, then the window), so hap2's windows are main_hap2's."""
    rng = np.random.default_rng(0)
    q = rng.integers(2, 42, (2, 3, 8))
    codes = rng.integers(0, 5, (2, 3, 8)).astype(np.int8)
    win = rng.integers(0, 5, (2, 8, 6)).astype(np.int8)
    c, d, m, w = sv.harness_inputs(2, 3, 8, 6)
    dl, ml = rl.quantized_qscore_luts()
    np.testing.assert_array_equal(c, codes)
    np.testing.assert_array_equal(w, win)
    np.testing.assert_array_equal(d, np.where(codes < 4, dl[q], 0))
    np.testing.assert_array_equal(
        m, np.where(codes < 4, ml[q], 0).sum(2).astype(np.float32))
