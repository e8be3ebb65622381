"""KG-SB and KG-R (csrc/snv_strand_bias.cu, csrc/snv_rna_tile.cu), the
strand-bias tile and RNA mode's genotype tile, on the CPU.

- The plain versions (snv_strand_bias_tile_plain,
  call_snv_rna_tile_plain) against the JAX package's XLA tiles: lhood,
  strand_bias and the integer fields bit for bit, ln_ref_pprob within
  LN_REF_RTOL (tests/test_torch_rna.py).
- A torch model of the kernels' schedule (csrc/snv_xla_math.cuh): each
  lane's sum over a row's calls, a window of 32 at a time folded into
  XLA's upper levels, or LLVM's vectorized order at D <= 32, held bit for
  bit to xla_sum_minor, xla_sum_major and the strand-bias tile's free
  sums at the depths where XLA's orders change; then the kernels' whole
  row (KG-SB's items, T12 chains of the target genotype alone and
  logsumexp; KG-R's four dot chains over a row's own live slots, delta
  sums and logsumexp) held to the plain versions.

Their dispatch and wrappers are tests/test_torch_snv_kernels.py's; the
kernels themselves run in tests/test_torch_cuda.py, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu_torch import convert
from strelka_tpu_torch.models import digt
from strelka_tpu_torch.models import snv_digt as tsd
from strelka_tpu_torch.ops import snv_kernels as sk
from tests.test_torch_rna import (EXT, INC, INT_FIELDS, LN_REF_RTOL, bits,
                                  rna_tile, t)

# the depths where XLA's orders change (csrc/snv_xla_math.cuh)
SCHEDULE_DEPTHS = [1, 15, 16, 20, 23, 24, 31, 32, 33, 64, 300, 1024, 1025]
SEQ, VEC8X3, VEC4X4E4, VEC8X4E8 = range(4)


# --- the kernels' schedule, as csrc/snv_xla_math.cuh runs it ---------------

def minor_variant(n):
    return SEQ if n < 16 else (VEC4X4E4 if 20 <= n < 24 else VEC8X4E8)


def sb_free_variant(n):
    return VEC8X3 if n == 32 else SEQ


def halves(a, n):
    """_halves over a[0..n), n 4 or 8."""
    for h in (4, 2, 1):
        if h < n:
            for k in range(h):
                a[k] = a[k] + a[k + h]
    return a[0]


class SmallSum:
    """SmallSum: _vector_sum's order of n <= 32 terms taken one at a time:
    a term of the block to its lane's accumulator (the first term of a
    lane sets it), the block reduced by halves at its last term; the
    epilogue's lanes likewise, lane 0 starting from the running sum; the
    rest added one at a time."""

    def __init__(self, variant, n, rows):
        uf = 3 if variant == VEC8X3 else 4
        self.vf = 4 if variant == VEC4X4E4 else 8
        self.epi = {VEC8X4E8: 8, VEC4X4E4: 4}.get(variant, 0)
        self.nv = 0 if variant == SEQ else n // (self.vf * uf) * (
            self.vf * uf)
        self.ne = ((n - self.nv) // self.epi * self.epi
                   if self.epi and n - self.nv >= self.epi else 0)
        self.a = [torch.zeros(rows) for _ in range(8)]
        self.s = torch.zeros(rows)

    def add(self, d, x):
        if d < self.nv:
            i = d % self.vf
            self.a[i] = x if d < self.vf else self.a[i] + x
            if d == self.nv - 1:
                self.s = halves(self.a, self.vf)
        elif d < self.nv + self.ne:
            j = d - self.nv
            first = j < self.epi
            self.a[j % self.epi] = ((self.s + x if j == 0 else x) if first
                                    else self.a[j % self.epi] + x)
            if d == self.nv + self.ne - 1:
                self.s = halves(self.a, self.epi)
        else:
            self.s = self.s + x


def windows(D):
    """Windows: items n[k] of each level and padding lo[k] before level
    k's first window, up to the top level of at most 32 items."""
    n, lo = [D], []
    while len(lo) < 3 and n[-1] > 32:
        n.append(-(-n[-1] // 32))
        lo.append((n[-1] * 32 - n[-2]) // 2)
    return n, lo


def sched_sum(x, variant):
    """row_sums of one item over x [L, D] f32, its terms one at a time:
    SmallSum at D <= 32; past it each window summed in order from +0 and
    pushed up the levels (push), every running sum from +0."""
    L, D = x.shape
    n, lo = windows(D)
    if not lo:
        small = SmallSum(variant, D, L)
        for i in range(D):
            small.add(i, x[:, i])
        return small.s
    z = torch.zeros(L, dtype=torch.float32)
    a1, a2, top = z, z, z

    def closes(k, j):
        return (j + lo[k]) % 32 == 31 or j == n[k] - 1
    for j in range(n[1]):
        first = 32 * j - lo[0]
        v = z
        for i in range(max(first, 0), min(first + 32, D)):
            v = v + x[:, i]
        if len(lo) == 1:
            top = top + v
            continue
        a1 = a1 + v
        if not closes(1, j):
            continue
        v, a1, j2 = a1, z, (j + lo[1]) // 32
        if len(lo) == 2:
            top = top + v
            continue
        a2 = a2 + v
        if closes(2, j2):
            top, a2 = top + a2, z
    return top


def signed_terms(seed, L, D):
    """f32 terms of mixed sign and magnitude, a third of them +0 or -0 (a
    sum of zeros keeps its sign only in some orders)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (L, D)) * 10.0 ** rng.integers(-3, 4, (L, D)))
    zero = rng.random((L, D)) < 0.33
    x = np.where(zero, np.where(rng.random((L, D)) < 0.5, 0.0, -0.0), x)
    x[: L // 4] = np.where(rng.random((L // 4, D)) < 0.5, 0.0, -0.0)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("D", SCHEDULE_DEPTHS)
def test_kernel_sum_schedule_matches_xla_orders(D):
    """Each kind of the kernels' sums, in their schedule, equals the plain
    version's order bit for bit (signed zeros included): the het-VF and
    forced sums (xla_sum_minor), the delta sums (xla_sum_major) and the
    strand-bias free sums (_sb_free_small in XLA's windows)."""
    x = signed_terms(D, 48, D)
    for variant, want in ((minor_variant(D), tsd.xla_sum_minor(x)),
                          (SEQ, tsd.xla_sum_major(x)),
                          (sb_free_variant(D),
                           tsd._xla_windows(x, tsd._sb_free_small))):
        assert (bits(sched_sum(x, variant)) == bits(want)).all()


def test_window_levels_past_1024_calls():
    """Windows of windows from 1,025 calls: 33 window sums go in windows
    of 32 with the padding split (lo = 15), one level more past 32,768."""
    assert windows(1024) == ([1024, 32], [0])
    assert windows(1025) == ([1025, 33, 2], [15, 15])
    assert windows(32769) == ([32769, 1025, 33, 2], [15, 15, 15])
    assert windows(sk.MAX_DEPTH) == ([1 << 20, 32768, 1024, 32], [0, 0, 0])


# --- the kernels' whole rows ------------------------------------------------

EXPECT2 = torch.as_tensor(digt.EXPECT2, dtype=torch.int64)
BIAS = torch.as_tensor(digt.EXPECT2_BIAS, dtype=torch.int64)
LOW = torch.as_tensor(tsd._LOW_REMAP, dtype=torch.int64)


def het_combine(x0, ext):
    """het_combine: NaN-first max of the terms, 0 where not finite, the
    exps summed in order, its log plus the max, minus ln(1 + len(ext))."""
    mx = x0
    for e in ext:
        mx = torch.where(torch.isnan(mx), mx, torch.where(
            torch.isnan(e), e, torch.where(e > mx, e, mx)))
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    tot = tsd._xla_exp_f32(x0 - mx)
    for e in ext:
        tot = tot + tsd._xla_exp_f32(e - mx)
    lse = tsd._xla_log_f32(tot) + mx
    return lse - tsd._xla_log_f32(torch.tensor(float(len(ext) + 1)))


def het_sums(tab, key_of, q, mask, dd):
    """The 2 n_steps het-VF sums of one het genotype's keys [L, D]: a
    masked call's value of its key (the low ratio's through the remap),
    the delta on v0."""
    out = []
    for s in range(tab.shape[0]):
        for key in (key_of, LOW[key_of]):
            v = tab[s][key, q]
            if dd is not None:
                v = torch.where(key == 0, v + dd, v)
            out.append(sched_sum(torch.where(mask, v, 0.0),
                                 minor_variant(q.shape[1])))
    return out


def sb_model(base, qual, fwd, mask, ref, tgt, lt, dd, ext):
    """KG-SB's row as the kernel runs it: each strand's 12 free sums and
    forced sum, the T12 chains of tgt's column alone plus the forced sum,
    the logsumexp with tgt's het-VF sums where ext > 0 and tgt is a het,
    the NaN-first max of the strands minus lt."""
    D = base.shape[1]
    b = base.long()
    q = qual.long().clamp(0, 255)
    cv = torch.from_numpy(tsd._call_vals_table())[q]          # [L, D, 3]
    v0 = cv[..., 0] if dd is None else cv[..., 0] + dd
    vals = [v0, cv[..., 1], cv[..., 2]]
    refc = ref.long().clamp(0, 3)
    g = tgt.long().clamp(0, 9)
    bi = tsd._bias_index(b)
    tab = (torch.from_numpy(tsd._het_vf_table(ext, INC)[0]) if ext > 0
           else None)
    lhs = []
    for force in (~fwd, fwd):
        free = ((~force) & mask).float()
        ws = [sched_sum((b == m // 3).float() * vals[m % 3] * free,
                        sb_free_variant(D)) for m in range(12)]
        kf = EXPECT2[refc[:, None], bi]
        vf = torch.where(kf == 0, v0, torch.where(kf == 1, vals[1], vals[2]))
        fs = sched_sum(vf * (force & mask).float(), minor_variant(D))
        t12 = [(EXPECT2[g, m // 3] == m % 3).float() for m in range(12)]
        a = []
        for j in range(4):
            c = ws[j] * t12[j]
            c = c + ws[j + 4] * t12[j + 4]
            a.append(c + ws[j + 8] * t12[j + 8])
        lh = ((a[0] + a[1]) + (a[2] + a[3])) + fs
        if tab is not None:
            key = torch.where(force, BIAS[refc[:, None], bi],
                              BIAS[g[:, None], bi])
            lh = torch.where(g >= 4, het_combine(
                lh, het_sums(tab, key, q, mask, dd)), lh)
        lhs.append(lh)
    f, r = lhs
    mx = torch.where(torch.isnan(f), f, torch.where(
        torch.isnan(r), r, torch.maximum(f, r)))
    return mx - lt


def rna_model(base, qual, mask, dd, tabs):
    """KG-R's lhood [L, 10] as the kernel runs it: the four dot chains
    over each row's own live slots (fma, k mod 4), the delta sums and
    their term, the logsumexp of each het genotype."""
    L, D = base.shape
    b = base.long()
    q = qual.long().clamp(0, 255)
    hist = tsd._tile_hist(base, qual, mask)
    qtab, e0 = tabs["snv_qtab"], tabs["e0_tab"]
    acc = [torch.zeros((L, 10)) for _ in range(4)]
    for k in range(512):
        cnt = hist[:, k].float()[:, None]
        a = acc[k % 4]
        acc[k % 4] = torch.where(cnt > 0, tsd._fma_f32(cnt, qtab[k], a), a)
    lh = (acc[0] + acc[1]) + (acc[2] + acc[3])
    if dd is not None:
        sm = [sched_sum(torch.where((b == x) & mask, dd, 0.0), SEQ)
              for x in range(4)]
        tb = [sm[x][:, None] * e0[x] for x in range(4)]
        lh = lh + ((tb[0] + tb[1]) + (tb[2] + tb[3]))
    tab = torch.from_numpy(tsd._het_vf_table(EXT, INC)[0])
    bi = tsd._bias_index(b)
    cols = [lh[:, x] for x in range(4)]
    for h in range(6):
        cols.append(het_combine(lh[:, 4 + h], het_sums(
            tab, BIAS[4 + h][bi], q, mask, dd)))
    return torch.stack(cols, dim=1)


def sb_inputs(seed, L, D, dep=True):
    base, qual, mask, fwd, ref, dd = rna_tile(seed, L, D, dep)
    rng = np.random.default_rng(seed + 1)
    tgt = rng.integers(0, 10, L).astype(np.int32)
    lt = rng.normal(-50, 10, L).astype(np.float32)
    return base, qual, mask, fwd, ref, dd, tgt, lt


def sb_tile(base, qual, mask, fwd, ref):
    return tsd.SnvPileupTile(t(base), t(qual), t(fwd), t(mask), t(ref))


@pytest.mark.parametrize("D,ext,dep", [(20, EXT, True), (32, EXT, True),
                                       (32, 0.0, False), (64, EXT, True),
                                       (70, 0.0, True)])
def test_kgsb_model_matches_plain(D, ext, dep):
    """KG-SB's row model (the kernel's items, tgt's column alone) equals
    snv_strand_bias_tile_plain bit for bit."""
    base, qual, mask, fwd, ref, dd, tgt, lt = sb_inputs(D + 7, 96, D, dep)
    want = tsd.snv_strand_bias_tile_plain(
        sb_tile(base, qual, mask, fwd, ref), t(tgt), t(lt),
        None if dd is None else t(dd), ext, INC)
    got = sb_model(t(base), t(qual), t(fwd), t(mask), t(ref), t(tgt),
                   t(lt), None if dd is None else t(dd), ext)
    assert (bits(got) == bits(want)).all()


@pytest.mark.parametrize("D,dep", [(13, True), (32, False), (45, True)])
def test_kgr_model_matches_plain(D, dep):
    """KG-R's lhood model (each row's own live slots, the delta sums, the
    logsumexp) equals call_snv_rna_tile_plain's lhood bit for bit."""
    base, qual, mask, fwd, ref, dd = rna_tile(D + 3, 96, D, dep)
    tile = sb_tile(base, qual, mask, fwd, ref)
    want = tsd.call_snv_rna_tile_plain(tile, 0.001, None, EXT, INC,
                                       None if dd is None else t(dd))
    got = rna_model(t(base), t(qual), t(mask), None if dd is None else t(dd),
                    convert.device_tables(0.001, torch.device("cpu")))
    assert (bits(got) == bits(want.lhood)).all()


# --- the plain versions against the JAX package ----------------------------

@pytest.mark.parametrize("D,ext", [(32, EXT), (64, 0.0)])
def test_strand_bias_plain_matches_jax(D, ext):
    base, qual, mask, fwd, ref, dd, tgt, lt = sb_inputs(300 + D, 256, D)
    jt = jsd.SnvPileupTile(jnp.asarray(base), jnp.asarray(qual),
                           jnp.asarray(fwd), jnp.asarray(mask),
                           jnp.asarray(ref))
    want = jsd.snv_strand_bias_tile(jt, jnp.asarray(tgt), jnp.asarray(lt),
                                    jnp.asarray(dd), ext, INC)
    got = tsd.snv_strand_bias_tile_plain(
        sb_tile(base, qual, mask, fwd, ref), t(tgt), t(lt), t(dd), ext, INC)
    assert torch.isfinite(got).all()
    assert (bits(got) == bits(want)).all()


@pytest.mark.parametrize("D,dep", [(33, True), (64, False)])
def test_rna_tile_plain_matches_jax(D, dep):
    base, qual, mask, fwd, ref, dd = rna_tile(400 + D, 256, D, dep)
    hap = np.random.default_rng(D).random(256) < 0.2
    jt = jsd.SnvPileupTile(jnp.asarray(base), jnp.asarray(qual),
                           jnp.asarray(fwd), jnp.asarray(mask),
                           jnp.asarray(ref))
    want = jsd.call_snv_tile(jt, 0.001, jnp.asarray(hap), EXT, INC, False,
                             None if dd is None else jnp.asarray(dd))
    got = tsd.call_snv_rna_tile_plain(
        sb_tile(base, qual, mask, fwd, ref), 0.001, t(hap), EXT, INC,
        None if dd is None else t(dd))
    assert (bits(got.lhood) == bits(want.lhood)).all()
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.ln_ref_pprob.numpy(),
                               np.asarray(want.ln_ref_pprob),
                               rtol=LN_REF_RTOL, atol=0)
