"""KG-SB and KG-R (csrc/snv_strand_bias.cu, csrc/snv_rna_tile.cu), the
strand-bias tile and RNA mode's genotype tile, on the CPU.

- The plain versions (snv_strand_bias_tile_plain,
  call_snv_rna_tile_plain) against the JAX package's XLA tiles: lhood,
  strand_bias and the integer fields bit for bit, ln_ref_pprob within
  LN_REF_RTOL (tests/test_torch_rna.py).
- A torch model of the kernels' sum orders (csrc/snv_xla_math.cuh): each
  sum over a row's calls, a window of 32 at a time folded into XLA's
  upper levels, or LLVM's vectorized order at D <= 32, held bit for bit
  to xla_sum_minor, xla_sum_major and the strand-bias tile's free sums at
  the depths where XLA's orders change; then whole rows in two
  schedules, each held to the plain versions: one sum a lane (the
  kernels' first design), and the walk as the kernels run it since their
  redesign: the items of a pass (four a lane in KG-R, two in KG-SB)
  over one row of values a call, each term the call's column that the
  item's map gives for the call's class (masked calls on zero columns),
  and the logsumexps' exps spread over the lanes, each group's summed in
  order.

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


# --- the walk of the redesigned kernels ------------------------------------
#
# A row's sums are items; a pass takes 32 x kPer of them (KG-R 4 a lane,
# KG-SB 2), each call of the row decoded once into a row of values (its
# columns), and an item's term of a call is the column that its map gives
# for the call's class, so that a masked call reads a +0 column.

STEPS = {1: (0.03, INC), 9: (EXT, INC), 40: (0.394, 0.0101)}
RNA_PER, SB_PER = 4, 2
# KG-R's pairs of columns: (+0, +0), (v0 + d, v0 + d), (d, +0), (+0, d),
# then each step's (k1, k2), (k2, k1)
R_ZERO, R_V0, R_DLO, R_DHI, R_STEP0 = range(5)
S_Z, S_H0, S_H3, S_HSTEP = 3, 6, 7, 8              # KG-SB's columns


def rna_het_pair(h, st, bi):
    """het_pair / 8: het genotype 4 + h's pair at the pass's step st."""
    key = int(BIAS[4 + h, bi])
    return R_V0 if key == 0 else R_STEP0 + 2 * st + key - 1


def rna_pass_steps(it0, n_het):
    s0 = it0 // 12
    s1 = (min(it0 + 32 * RNA_PER, n_het) - 1) // 12 + 1 if it0 < n_het \
        else s0
    return s0, s1


def rna_pair_map(it, n_het, n_items, s0):
    """The pair of the even item `it` and its neighbour, for each bias
    index: het items st * 12 + 2 h + r (the high and the low ratio), then
    the delta sums of bases x, x + 1, then dead items (+0, +0)."""
    if it < n_het:
        return [rna_het_pair(it % 12 >> 1, it // 12 - s0, bi)
                for bi in range(4)]
    if it < n_items:
        x = it - n_het
        return [R_DLO if bi == x else R_DHI if bi == x + 1 else R_ZERO
                for bi in range(4)]
    return [R_ZERO] * 4


def rna_item_map(it, n_het, n_items, s0):
    """The item's column (a float of its pair) for each bias index."""
    return [2 * p + it % 2
            for p in rna_pair_map(it - it % 2, n_het, n_items, s0)]


def rna_call_rows(tab, b, q, mask, dd, s0, s1):
    """A row of values a call [..., columns] (the kernel's commit), in
    pairs: (+0, +0), the mismatch value plus its delta twice, the delta
    of a used call of base 0-3 beside +0 and after it, each step's (key
    1, key 2, key 2, key 1); all +0 for a masked call."""
    z = torch.zeros(q.shape)
    v0 = tab[0, 0][q] if dd is None else tab[0, 0][q] + dd
    v0 = torch.where(mask, v0, 0.0)
    exact = (b >= 0) & (b < 4)
    d = torch.where(mask & exact, z if dd is None else dd, 0.0)
    cols = [z, z, v0, v0, d, z, z, d]
    for st in range(s0, s1):
        k1, k2 = (torch.where(mask, tab[st, k][q], 0.0) for k in (1, 2))
        cols += [k1, k2, k2, k1]
    return torch.stack(cols, dim=-1)


def walk_sums(rows, cols, variants):
    """The pass's sums: item j's term of call i is rows[l, i, cols[l, j,
    i]], summed in XLA's order for its variant (sched_sum), [L, items]."""
    L, P, D = cols.shape
    x = torch.gather(rows, 2, cols.permute(0, 2, 1)).permute(0, 2, 1)
    out = torch.zeros(L, P)
    for v in set(variants):
        sel = [j for j in range(P) if variants[j] == v]
        out[:, sel] = sched_sum(x[:, sel].reshape(-1, D), v).reshape(L, -1)
    return out


def lse_spread(x0, ext):
    """lse_spread over groups: x0 [L, G], ext [L, G, m]: the NaN-first
    max a group, every exp at once (as the lanes take them), each group's
    exps added in order, log plus max minus ln(1 + m)."""
    mx = x0
    for k in range(ext.shape[-1]):
        e = ext[..., k]
        mx = torch.where(torch.isnan(mx), mx, torch.where(
            torch.isnan(e), e, torch.where(e > mx, e, mx)))
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = tsd._xla_exp_f32(ext - mx[..., None])
    tot = tsd._xla_exp_f32(x0 - mx)
    for k in range(ext.shape[-1]):
        tot = tot + ex[..., k]
    return (tsd._xla_log_f32(tot) + mx
            - tsd._xla_log_f32(torch.tensor(float(ext.shape[-1] + 1))))


def rna_walk_model(base, qual, mask, dd, tabs, ext, inc):
    """KG-R's lhood [L, 10] as the redesigned kernel runs it: passes of
    128 items (four neighbours a lane, two pairs) over call rows, four
    dot chains over a row's own live slots, the delta term, the spread
    logsumexps."""
    L, D = base.shape
    b = base.long()
    q = qual.long().clamp(0, 255)
    bi = tsd._bias_index(b)
    tab = torch.from_numpy(tsd._het_vf_table(ext, inc)[0])
    n = tab.shape[0]
    n_het = 12 * n
    n_items = n_het + (4 if dd is not None else 0)
    res = torch.zeros(L, n_items)
    for it0 in range(0, n_items, 32 * RNA_PER):
        s0, s1 = rna_pass_steps(it0, n_het)
        rows = rna_call_rows(tab, b, q, mask, dd, s0, s1)
        items = range(it0, min(it0 + 32 * RNA_PER, n_items))
        maps = torch.tensor([rna_item_map(it, n_het, n_items, s0)
                             for it in items])                   # [P, 4]
        cols = maps[:, bi].permute(1, 0, 2)                      # [L, P, D]
        res[:, it0:it0 + len(items)] = walk_sums(
            rows, cols, [minor_variant(D) if it < n_het else SEQ
                         for it in items])
    hist = tsd._tile_hist(base, qual, mask)
    qtab, e0 = tabs["snv_qtab"], tabs["e0_tab"]
    acc = [torch.zeros((L, 10)) for _ in range(4)]
    for k in torch.nonzero(hist.any(dim=0))[:, 0].tolist():
        cnt = hist[:, k].float()[:, None]
        a = acc[k % 4]
        acc[k % 4] = torch.where(cnt > 0, tsd._fma_f32(cnt, qtab[k], a), a)
    lh = (acc[0] + acc[1]) + (acc[2] + acc[3])
    if dd is not None:
        sm = res[:, n_het:]
        tb = [sm[:, x:x + 1] * e0[x] for x in range(4)]
        lh = lh + ((tb[0] + tb[1]) + (tb[2] + tb[3]))
    ext_t = res[:, :n_het].reshape(L, n, 6, 2).permute(0, 2, 1, 3)
    het = lse_spread(lh[:, 4:], ext_t.reshape(L, 6, 2 * n))
    return torch.cat([lh[:, :4], het], dim=1)


def sb_class(mask, fwd, b):
    """A call's class: 0 unused, 1 + is_fwd used; plus 3 x (its base
    where 0 to 3, else 4)."""
    return (torch.where(mask, 1 + fwd.long(), 0)
            + 3 * torch.where((b >= 0) & (b < 4), b, 4))


def sb_item(strand, role, refc, g):
    """make_item: (columns where the call counts, where not, the classes
    that count) of a strand's item."""
    fs = 1 if strand == 0 else 0          # the strand of its free calls
    if role < 12:
        obs, k = divmod(role, 3)
        return [k] * 4, [S_Z + k] * 4, {1 + fs + 3 * obs}
    used = {1 + (1 - fs) + 3 * bc for bc in range(5)}
    if role == 12:
        kf = [int(EXPECT2[refc, bi]) for bi in range(4)]
        return kf, [S_Z + k for k in kf], used
    st, r = divmod(role - 13, 2)

    def col(key):
        key = int(LOW[key]) if r else key
        return S_H0 if key == 0 else (S_H3 if key == 3
                                      else S_HSTEP + 2 * st + key - 1)
    return ([col(int(BIAS[refc, bi])) for bi in range(4)],
            [col(int(BIAS[g, bi])) for bi in range(4)], used)


def sb_call_rows(q, mask, dd, tab):
    """KG-SB's row of values a call: vals[0..2] (the delta on vals[0]),
    each times 0, then the het-VF mismatch value plus the delta, v3, each
    step's key 1 and 2 values (those +0 for a masked call)."""
    cv = torch.from_numpy(tsd._call_vals_table())[q]
    v = [cv[..., 0] if dd is None else cv[..., 0] + dd, cv[..., 1],
         cv[..., 2]]
    cols = v + [x * 0.0 for x in v]
    if tab is not None:
        h0 = tab[0, 0][q] if dd is None else tab[0, 0][q] + dd
        cols += [torch.where(mask, h0, 0.0),
                 torch.where(mask, tab[0, 3][q], 0.0)]
        for st in range(tab.shape[0]):
            cols += [torch.where(mask, tab[st, k][q], 0.0) for k in (1, 2)]
    return torch.stack(cols, dim=-1)


def sb_walk_model(base, qual, fwd, mask, ref, tgt, lt, dd, ext, inc):
    """KG-SB's strand bias as the redesigned kernel runs it: each row's
    2 x per items (strand-major) in passes of 64 over call rows, a term
    the column of the item's map for the call's class, lanes 0 and 1's
    T12 chains, the spread logsumexp, the NaN-first max minus lt."""
    L, D = base.shape
    b = base.long()
    q = qual.long().clamp(0, 255)
    bi = tsd._bias_index(b)
    cls = sb_class(mask, fwd, b)
    tab = (torch.from_numpy(tsd._het_vf_table(ext, inc)[0]) if ext > 0
           else None)
    n = 0 if tab is None else tab.shape[0]
    rows = sb_call_rows(q, mask, dd, tab)
    refc = ref.long().clamp(0, 3)
    g = tgt.long().clamp(0, 9)
    pers = torch.where(g >= 4, 13 + 2 * n, 13)
    out = torch.empty(L)
    for per in sorted(set(pers.tolist())):    # rows of one item count
        ls = torch.nonzero(pers == per)[:, 0].tolist()
        res = torch.zeros(len(ls), 2 * per)
        for it0 in range(0, 2 * per, 32 * SB_PER):
            items = range(it0, min(it0 + 32 * SB_PER, 2 * per))
            cols = []
            for l in ls:
                spec = [sb_item(it // per, it % per, int(refc[l]), int(g[l]))
                        for it in items]
                cols.append(torch.stack([torch.where(
                    torch.tensor([c in cnt for c in range(15)])[cls[l]],
                    torch.tensor(tc)[bi[l]], torch.tensor(fc)[bi[l]])
                    for tc, fc, cnt in spec]))                   # [P, D]
            res[:, it0:it0 + len(items)] = walk_sums(
                rows[ls], torch.stack(cols),
                [sb_free_variant(D) if it % per < 12 else minor_variant(D)
                 for it in items])
        gl = g[ls]
        t12 = [(EXPECT2[gl, m // 3] == m % 3).float() for m in range(12)]
        lhs = []
        for s in range(2):
            ws = res[:, s * per:(s + 1) * per]
            a = []
            for j in range(4):
                c = ws[:, j] * t12[j]
                c = c + ws[:, j + 4] * t12[j + 4]
                a.append(c + ws[:, j + 8] * t12[j + 8])
            lhs.append(((a[0] + a[1]) + (a[2] + a[3])) + ws[:, 12])
        lh = torch.stack(lhs, dim=1)                             # [Lg, 2]
        if per > 13:
            lh = lse_spread(lh, torch.stack(
                [res[:, s * per + 13:(s + 1) * per] for s in range(2)], 1))
        f, r = lh[:, 0], lh[:, 1]
        mx = torch.where(torch.isnan(f), f, torch.where(
            torch.isnan(r), r, torch.maximum(f, r)))
        out[ls] = mx - lt[ls]
    return out


def walk_inputs(seed, L, D, dep):
    """sb_inputs with some deltas -0 and every row's last call at q = 0
    (the forced-ref keys' eprob floor)."""
    base, qual, mask, fwd, ref, dd, tgt, lt = sb_inputs(seed, L, D, dep)
    if dd is not None:
        dd[np.random.default_rng(seed).random(dd.shape) < 0.05] = -0.0
    return base, qual, mask, fwd, ref, dd, tgt, lt


# each depth where XLA's orders change once, the steps and the deltas
# taking turns (1, 9, 40; on, off)
WALK_CASES = [(D, (1, 9, 40)[i % 3], i % 2 == 0)
              for i, D in enumerate(SCHEDULE_DEPTHS)]


@pytest.mark.parametrize("D,n_steps,dep", WALK_CASES)
def test_kgr_walk_model_matches_plain(D, n_steps, dep):
    """KG-R's redesigned walk (four items a lane a pass, call rows and
    item maps, masked calls on +0 columns, the spread logsumexp) equals
    call_snv_rna_tile_plain's lhood bit for bit."""
    ext, inc = STEPS[n_steps]
    base, qual, mask, fwd, ref, dd, _, _ = walk_inputs(D + 31, 6, D, dep)
    want = tsd.call_snv_rna_tile_plain(
        sb_tile(base, qual, mask, fwd, ref), 0.001, None, ext, inc,
        None if dd is None else t(dd))
    got = rna_walk_model(t(base), t(qual), t(mask),
                         None if dd is None else t(dd),
                         convert.device_tables(0.001, torch.device("cpu")),
                         ext, inc)
    assert (bits(got) == bits(want.lhood)).all()


@pytest.mark.parametrize("D,n_steps,dep", WALK_CASES)
def test_kgsb_walk_model_matches_plain(D, n_steps, dep):
    """KG-SB's redesigned walk (two items a lane a pass, strand-major,
    each item's column maps and counting classes over call rows, the
    spread logsumexp) equals snv_strand_bias_tile_plain bit for bit, with
    the extension and (at 9 steps) without."""
    base, qual, mask, fwd, ref, dd, tgt, lt = walk_inputs(D + 57, 8, D, dep)
    for ext, inc in (STEPS[n_steps], (0.0, INC))[:1 + (n_steps == 9)]:
        want = tsd.snv_strand_bias_tile_plain(
            sb_tile(base, qual, mask, fwd, ref), t(tgt), t(lt),
            None if dd is None else t(dd), ext, inc)
        got = sb_walk_model(t(base), t(qual), t(fwd), t(mask), t(ref),
                            t(tgt), t(lt), None if dd is None else t(dd),
                            ext, inc)
        assert (bits(got) == bits(want)).all()


# the base ids that give every bias index, as a base and as none of 0-3
BASE_IDS = (-5, -3, -2, -1, 0, 1, 2, 3, 4)


def test_walk_column_maps_equal_the_tables():
    """Exhaustively, at 9 and 40 steps, both kernels' item maps against
    the plain versions' tables. KG-R: for every het genotype, ratio, step
    and bias index, the column of the map is the one that holds the value
    of key EXPECT2_BIAS[g, bi] (through _LOW_REMAP at the low ratio), and
    a delta item's is the delta's where the bias index is its base, else
    +0. KG-SB: for every strand, role, reference and target genotype,
    call class (used, strand, base) and bias index, the column is the
    plain product's or gather's (free: vals[k] where the call is free and
    of base obs, else vals[k] * 0; forced: vals[EXPECT2[ref, bi]], times
    0 where not forced; het-VF: the key of the reference where forced,
    of the target where not). Then each column's values against the
    tables for every base id, mask, strand and qscore (+0 where masked
    in the het-VF columns)."""
    def rna_holds(col, s0):
        """What column `col` of a call row holds (rna_call_rows)."""
        if col < 8:
            return ("zero", "zero", "v0", "v0", "delta", "zero", "zero",
                    "delta")[col]
        j, e = divmod(col - 8, 4)
        return ("key", s0 + j, (1, 2, 2, 1)[e])
    for n_steps in (9, 40):
        n_het, n_items = 12 * n_steps, 12 * n_steps + 4
        for it0 in range(0, n_items, 32 * RNA_PER):
            s0, s1 = rna_pass_steps(it0, n_het)
            for it in range(it0, min(it0 + 32 * RNA_PER, n_items)):
                mp = rna_item_map(it, n_het, n_items, s0)
                for bi in range(4):
                    got = rna_holds(mp[bi], s0)
                    if it >= n_het:
                        want = "delta" if bi == it - n_het else "zero"
                    else:
                        st, hr = divmod(it, 12)
                        assert s0 <= st < s1
                        key = int(BIAS[4 + hr // 2, bi])
                        key = int(LOW[key]) if hr % 2 else key
                        want = "v0" if key == 0 else ("key", st, key)
                    assert got == want, (it, bi, got, want)

    def sb_col(key, st):
        return (S_H0 if key == 0 else S_H3 if key == 3
                else S_HSTEP + 2 * st + key - 1)
    for refc in range(4):
        for g in range(10):
            for strand in range(2):
                for role in (*range(15), 16, 17, 90, 91, 92):
                    tc, fc, cnt = sb_item(strand, role, refc, g)
                    for c in range(15):
                        used, fwd = c % 3 > 0, c % 3 == 2
                        base = c // 3         # 4: none of 0-3
                        force = used and fwd == (strand == 1)
                        free = used and not force
                        for bi in range(4):
                            col = (tc if c in cnt else fc)[bi]
                            if role < 12:
                                obs, k = divmod(role, 3)
                                want = k if free and base == obs else S_Z + k
                            elif role == 12:
                                k = int(EXPECT2[refc, bi])
                                want = k if force else S_Z + k
                            else:
                                st, r = divmod(role - 13, 2)
                                if not used:      # a +0 column
                                    assert col >= S_H0
                                    continue
                                key = int(BIAS[refc if force else g, bi])
                                key = int(LOW[key]) if r else key
                                want = sb_col(key, st)
                            assert col == want, (refc, g, strand, role, c, bi)
    # the columns' values
    q = torch.arange(256)
    dd = torch.full((256,), -0.37)
    for n_steps in (9, 40):
        tab = torch.from_numpy(tsd._het_vf_table(*STEPS[n_steps])[0])
        # the kernels read key 0 and 3 at step 0 for every step
        assert (tab[:, 0] == tab[0, 0]).all()
        assert (tab[:, 3] == tab[0, 3]).all()
        cv = torch.from_numpy(tsd._call_vals_table())
        vals = [cv[:, 0] + dd, cv[:, 1], cv[:, 2]]
        for b in BASE_IDS:
            for m in (False, True):
                mk = torch.full((256,), m)
                bt = torch.full((256,), b)
                rows = rna_call_rows(tab, bt, q, mk, dd, 0, n_steps)
                zero = torch.zeros(256)
                d = dd if 0 <= b < 4 else zero
                want = [zero, zero, tab[0, 0][q] + dd, tab[0, 0][q] + dd,
                        d, zero, zero, d]
                for st in range(n_steps):
                    want += [tab[st, 1][q], tab[st, 2][q], tab[st, 2][q],
                             tab[st, 1][q]]
                want = torch.where(mk[:, None], torch.stack(want, 1), 0.0)
                assert (bits(rows) == bits(want)).all(), (b, m)
                rows = sb_call_rows(q, mk, dd, tab)
                het = [tab[0, 0][q] + dd, tab[0, 3][q]]
                for st in range(n_steps):
                    het += [tab[st, 1][q], tab[st, 2][q]]
                want = torch.cat([
                    torch.stack([v for v in vals]
                                + [(0.0 * v) * 0.0 for v in vals], 1),
                    torch.where(mk[:, None], torch.stack(het, 1), 0.0)], 1)
                assert (bits(rows) == bits(want)).all(), (b, m)
                # the plain products: ([b == obs] v) [free] is v or v * 0
                for k in range(3):
                    for eq in (0.0, 1.0):
                        for fr in (0.0, 1.0):
                            prod = (eq * vals[k]) * fr
                            assert (bits(prod) == bits(
                                rows[:, k] if eq and fr
                                else rows[:, S_Z + k])).all()
