"""The schedules of the somatic SNV kernels KS-G (csrc/somatic_grid.cu) and
KS-P (csrc/somatic_posterior.cu), modelled in numpy and torch on the CPU
and held bit for bit against the plain versions (freq_grid_lhoods_plain,
somatic_snv_call_plain) and the JAX package's programs.

- KS-G: the per-row walk over live qscore slots only (one residue
  j = k mod 4 after the other, slots ascending), the 114 (state, dot)
  chains laid four to a lane, and the combine that gathers a strand
  state's dots from their lanes in the plain version's order. Tiles at
  one base quality (the CLI's reads), at binned qualities and with all
  128 slots live, with q = 0 calls and all-masked rows, at D = 1, 31,
  32, 33, 127 and 200. Tolerance: bit for bit against the plain version;
  against the JAX package the 21 grid states bit for bit and the 9
  strand states within STRAND_MAX_ULP f32 ulps of 1 or of the value,
  whichever is larger (the JAX package takes their logaddexp in f32, the
  port in float64, tests/test_torch_somatic_snv.py; the ln 0.5 added
  after it cancels most of a value near ln 2, so near 0 the plain
  version itself differs from the JAX package by up to 32 ulps of the
  value, about one of 1).
- KS-P: the lists of terms whose prior is not -inf (the only terms whose
  exp is not +0 on a row of lhoods below +inf), the halving tree laid
  over 32 lanes of 14 slots, the trees' last five halvings for all
  eight logsumexps at once (lane 4 g + q), one log for the eight, and
  the tail spread over the lanes, its maxima by reductions of
  order-preserving keys. The tiles' lhoods, all -inf normal or tumour
  rows, tied states, and rows with a NaN or a +inf lhood (which take
  every term). Tolerance: bit for bit
  against the plain version on every field; against the JAX package
  every integer field and the strand bias equal, as
  tests/test_torch_somatic_snv.py holds them (NaN and +inf rows: the
  plain version only).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import strelka_tpu  # noqa: F401  (enables x64, as the JAX caller runs)
from strelka_tpu.models import somatic_snv as jss
from strelka_tpu_torch.convert import somatic_grid_tables
from strelka_tpu_torch.models import snv_digt as tsd
from strelka_tpu_torch.models import somatic_snv as tss
from test_torch_cuda import SPARSE_KINDS, sparse_tile
from test_torch_somatic_snv import INT_FIELDS, STRAND_MAX_ULP

CPU = torch.device("cpu")
PRIOR = (0.15, 5e-10, 1e-4, 0.001, 0.0)   # somatic_snv_call's defaults
NINF = float("-inf")
F, S, N = tss.PRESTRAND_SIZE, tss.STRAND_STATE_SIZE, tss.PRESTRAND_SIZE ** 2

# --- KS-G ------------------------------------------------------------------

def ksg_layout():
    """[4][32] (table, column, count) of lane l's chain slot i, as
    somatic_grid.cu's lane_chains lays them (None: no chain)."""
    lay = [[None] * 32 for _ in range(4)]
    for f in range(F):
        lay[0][f] = ("grid_ref", f, "ref")
        lay[1][f] = ("grid_alt", f, "alt")
    for s in range(S):
        lay[0][21 + s] = ("grid_on_ref", s, "rf")
        lay[1][21 + s] = ("grid_on_alt", s, "af")
        lay[2][s] = ("grid_off_ref", s, "rr")
        lay[2][9 + s] = ("grid_off_alt", s, "ar")
        lay[2][18 + s] = ("grid_on_ref", s, "rr")
        slot, lane = (2, 27 + s) if s < 5 else (3, s - 5)
        lay[slot][lane] = ("grid_on_alt", s, "ar")
        lay[3][4 + s] = ("grid_off_ref", s, "rf")
        lay[3][13 + s] = ("grid_off_alt", s, "af")
    return lay


def strand_sources(s):
    """The (slot, lane) of strand state s's fwd and rev dots, in the order
    lane 21 + s adds them (its own slots 0-1, then its shuffles)."""
    fwd = [(0, 21 + s), (1, 21 + s), (2, s), (2, 9 + s)]
    rev = [(2, 18 + s), (2, 27 + s) if s < 5 else (3, s - 5), (3, 4 + s),
           (3, 13 + s)]
    return fwd, rev


def ksg_model(base, qual, mask, fwd, ref):
    """KS-G's arithmetic, row by row: [L, 30] f32."""
    L, D = base.shape
    q = np.clip(qual.astype(np.int64), 0, 127)
    cls = ((base.astype(np.int64) != ref[:, None]) << 1) | fwd
    # the counts (shared atomics, exact in any order) and the live slots
    # (a ballot over the histogram: a slot with any of its four counts)
    h = np.zeros((L, 512), np.int64)
    r, d = np.nonzero(mask)
    np.add.at(h, (r, (q * 4 + cls)[r, d]), 1)
    h = h.reshape(L, 128, 4)                  # (rr, rf, ar, af)
    live = h.any(axis=2)
    rr, rf, ar, af = (h[..., i] for i in range(4))
    cnt = dict(ref=rr + rf, alt=ar + af, rr=rr, rf=rf, ar=ar, af=af)
    tabs = somatic_grid_tables(CPU)
    T = torch.zeros((128, 4, 32), dtype=torch.float32)
    C = torch.zeros((L, 128, 4, 32), dtype=torch.float32)
    for i, lanes in enumerate(ksg_layout()):
        for lane, chain in enumerate(lanes):
            if chain is not None:
                tab, col, name = chain
                T[:, i, lane] = tabs[tab][:, col]
                C[:, :, i, lane] = torch.from_numpy(
                    cnt[name].astype(np.float32))
    # the walk: residue j's live slots ascending into accumulator j
    a = torch.zeros((L, 4, 32, 4), dtype=torch.float32)
    for j in range(4):
        for k in range(j, 128, 4):
            rows = torch.from_numpy(np.nonzero(live[:, k])[0])
            if len(rows):
                a[rows, :, :, j] = tsd._fma_f32(C[rows, k], T[k],
                                                a[rows, :, :, j])
    dot = (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])   # [L, 4, 32]
    lh = dot[:, 0, :F] + dot[:, 1, :F]
    lf = torch.empty((L, S), dtype=torch.float32)
    lr = torch.empty((L, S), dtype=torch.float32)
    for s in range(S):
        for out, src in zip((lf, lr), strand_sources(s)):
            acc = dot[:, src[0][0], src[0][1]]
            for i, lane in src[1:]:
                acc = acc + dot[:, i, lane]
            out[:, s] = acc
    h0 = torch.from_numpy(h[:, 0])
    lh[:, 0].masked_fill_((h0[:, 0] > 0) | (h0[:, 1] > 0), NINF)
    lh[:, 1].masked_fill_(h0[:, 2] + h0[:, 3] > 0, NINF)
    lf.masked_fill_((h0[:, 0] > 0)[:, None], NINF)
    lr.masked_fill_((h0[:, 1] > 0)[:, None], NINF)
    strand = (tss._logaddexp64(lf.double(), lr.double()).float()
              + tss._LN_HALF_F32)
    return torch.cat([lh, strand], dim=1)


def test_ksg_layout_holds_each_chain_once_in_the_plain_order():
    """114 chains, each of the plain version's dots once; lane f reads
    grid state f's two dots, lane 21 + s strand state s's eight in the
    plain version's order."""
    lay = ksg_layout()
    chains = [c for lanes in lay for c in lanes if c is not None]
    assert len(chains) == len(set(chains)) == 2 * F + 8 * S == 114
    for f in range(F):
        assert [lay[0][f], lay[1][f]] == [("grid_ref", f, "ref"),
                                          ("grid_alt", f, "alt")]
    for s in range(S):
        fwd, rev = strand_sources(s)
        assert [lay[i][lane] for i, lane in fwd] == [
            ("grid_on_ref", s, "rf"), ("grid_on_alt", s, "af"),
            ("grid_off_ref", s, "rr"), ("grid_off_alt", s, "ar")]
        assert [lay[i][lane] for i, lane in rev] == [
            ("grid_on_ref", s, "rr"), ("grid_on_alt", s, "ar"),
            ("grid_off_ref", s, "rf"), ("grid_off_alt", s, "af")]


@pytest.mark.parametrize("D", [1, 31, 32, 33, 127, 200])
@pytest.mark.parametrize("kind", SPARSE_KINDS)
def test_ksg_schedule_matches_plain_and_jax(kind, D):
    tile = sparse_tile(np.random.default_rng(D), 160, D, kind)
    got = ksg_model(*tile).numpy()
    plain = tss.freq_grid_lhoods_plain(
        *(torch.from_numpy(a) for a in tile)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    want = np.asarray(jss.freq_grid_lhoods(*(jnp.asarray(a) for a in tile)))
    np.testing.assert_array_equal(got[:, :F].view(np.int32),
                                  want[:, :F].view(np.int32))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want[:, F:])
    err = np.abs(got[:, F:][fin] - want[:, F:][fin])
    scale = np.maximum(1.0, np.abs(want[:, F:][fin]))
    assert (err <= STRAND_MAX_ULP * 2.0 ** -23 * scale).all()
    live = {"single": 2, "binned": 5, "dense": 128}[kind]
    assert (got[3:6, :F] == 0).all()           # the all-masked rows
    if D >= 128:
        q = np.clip(tile[1], 0, 127)
        slots = [len(np.unique(q[r][tile[2][r]])) for r in range(6, 160)]
        assert max(slots) == live


# --- KS-P ------------------------------------------------------------------

def posterior_tables():
    pf, gp, eq, off, eye = tss._posterior_tables(CPU, *PRIOR)
    return pf.reshape(6, N), gp.reshape(6), eq, off.reshape(N), \
        eye.reshape(N)


def listed_terms():
    """The seven lists of somatic_posterior.cu: per group the terms whose
    prior is not -inf, then the off-diagonal terms whose prior is not."""
    pf, _, _, off, eye = posterior_tables()
    return [pf[g] != NINF for g in range(6)] + [~eye & (off != NINF)]


def lane_slots(e):
    """[L, 14, 32] of [L, 441]: lane l's tree slots s[l + 32 m], m = 0..13
    (14 and 15 are padding, never added)."""
    x = torch.zeros((e.shape[0], 14, 32), dtype=e.dtype)
    for m in range(14):
        n = min(32, N - 32 * m)
        x[:, m, :n] = e[:, 32 * m:32 * m + n]
    return x


def lane_partials(e):
    """Each lane's sum after the tree's halvings h = 256 .. 32 over its
    slots (m with m + 8, 4, 2, 1), [L, 32]."""
    x = lane_slots(e)
    for m in range(6):
        x[:, m] = x[:, m] + x[:, m + 8]
    for h in (4, 2, 1):
        for m in range(h):
            x[:, m] = x[:, m] + x[:, m + h]
    return x[:, 0]


def eight_trees(part):
    """The tree's last five halvings (h = 16 .. 1) over [L, T, 32] lane
    partials, as somatic_posterior.cu's eight_trees runs them: lane 4 g +
    q adds tree g's lane sums q + 4 i (h = 16, 8, 4), then two shuffles
    down (h = 2, 1). [L, T]."""
    def x(q, i):
        return part[..., q + 4 * i]
    s3 = [(((x(q, 0) + x(q, 4)) + (x(q, 2) + x(q, 6)))
           + ((x(q, 1) + x(q, 5)) + (x(q, 3) + x(q, 7)))) for q in range(4)]
    return (s3[0] + s3[2]) + (s3[1] + s3[3])


def kernel_tree(e):
    """The kernel's whole tree over [L, 441] float64: [L]."""
    return eight_trees(lane_partials(e)[:, None])[:, 0]


def order_key(v):
    """somatic_posterior.cu's order_key of f32 [.., 32]: int order of the
    values, -0 and +0 one key, a NaN above all."""
    b = v.view(torch.int32).long()
    k = torch.where(b >= 0, b, (b ^ 0x7fffffff) + 1)
    return torch.where(torch.isnan(v), 2 ** 31 - 1, k)


def first_max_lane(v, inside):
    """The kernel's first_max_lane over [L, 32] f32 lanes where `inside`:
    the top key's lowest lane (the first NaN, else the first of the
    largest); returns (its value, its lane)."""
    k = torch.where(inside, order_key(v), -2 ** 31)
    top = k.amax(dim=1, keepdim=True)
    lane = torch.where(inside & (k == top), torch.arange(32), 32).amin(1)
    return v.gather(1, lane[:, None])[:, 0], lane


def lanes_of(x, lo, hi, fill):
    """[L, 32] with x[:, l] in lanes lo <= l < hi, fill elsewhere."""
    out = torch.full((x.shape[0], 32), fill, dtype=x.dtype)
    out[:, lo:hi] = x[:, lo:hi]
    return out


def ksp_model(normal, tumor):
    """KS-P's arithmetic on [L, 30] f32 lhoods: the six result fields."""
    pf, gp, eq, off, eye = posterior_tables()
    nl, tl = normal[:, :F], tumor[:, :F]
    L = nl.shape[0]
    fn, ft = torch.arange(N) // F, torch.arange(N) % F
    full = ~((nl < float("inf")).all(1) & (tl < float("inf")).all(1))
    terms = [((pf[g][None] + nl[:, fn]) + tl[:, ft]).double()
             for g in range(6)]
    terms.append(torch.where(eye[None], NINF,
                             (nl[:, fn] + tl[:, ft]).double() + off[None]))
    parts, shifts = [], []
    for v, keep in zip(terms, listed_terms()):
        inl = keep[None] | full[:, None]
        mx = torch.where(inl, v, NINF).amax(dim=1)
        t = torch.where(torch.isfinite(mx), mx, 0.0)
        e = torch.where(inl, torch.exp(v - t[:, None]), 0.0)
        parts.append(lane_partials(e))
        shifts.append(t)
    dv = lanes_of(((nl + tl) + eq[None]).double(), 0, F, NINF)
    dmx = dv.amax(dim=1)
    dt = torch.where(torch.isfinite(dmx), dmx, 0.0)
    parts.append(torch.where(torch.arange(32) < F,
                             torch.exp(dv - dt[:, None]), 0.0))
    shifts.append(dt)
    sums = eight_trees(torch.stack(parts, dim=1))          # [L, 8]
    lg = torch.log(torch.abs(sums))                         # lane 4 g
    sh = torch.stack(shifts, dim=1)
    lse = (lg[:, :6] + sh[:, :6]).float()
    lse_off = lg[:, 6] + sh[:, 6]
    lse_diag = (lg[:, 7] + sh[:, 7]).float().double()

    # the tail: lane g < 6 holds group g
    lp = lse + gp[None]
    best, max_gt = first_max_lane(lanes_of(lp, 0, 6, NINF),
                                  torch.arange(32) < 6)
    ex = torch.exp(lp.double() - best.double()[:, None])
    dd = lse_diag - lse_off
    e6 = torch.exp(-torch.abs(dd))
    s = ex[:, 0]
    for g in range(1, 6):
        s = s + ex[:, g]
    p = ex / s[:, None]
    nonsom = (p[:, 0] + p[:, 2]) + p[:, 4]
    total_som = (p[:, 1] + p[:, 3]) + p[:, 5]
    err = [nonsom + (total_som - p[:, 2 * n + 1]) for n in range(3)]
    min_err, ntype = err[0], torch.zeros(L, dtype=torch.int64)
    for n in (1, 2):     # snv::nan_min and snv::arg_min, in order
        first_nan = torch.isnan(min_err)
        take = ~first_nan & (torch.isnan(err[n]) | (err[n] < min_err))
        ntype = torch.where(take, n, ntype)
        min_err = torch.where(take, err[n], min_err)
    denom = torch.where(torch.isnan(dd), lse_diag + lse_off,
                        torch.maximum(lse_diag, lse_off) + torch.log1p(e6))
    frac = torch.exp(lse_diag - denom)
    lanes = torch.arange(32)
    symm, _ = first_max_lane(lanes_of(tumor, 3, F, NINF),
                             (lanes >= 3) & (lanes < F))
    strand, _ = first_max_lane(lanes_of(tumor, F, 30, NINF),
                               (lanes >= F) & (lanes < 30))
    i32 = torch.int32
    return tss.SomaticSnvResult(
        qphred=tss._phred64(nonsom), from_ntype_qphred=tss._phred64(min_err),
        ntype=ntype.to(i32), max_gt=max_gt.to(i32),
        strand_bias=torch.clamp_min(strand - symm, 0.0),
        nonsomatic_qphred=tss._phred64(1.0 - frac))


def test_ksp_lists_of_the_default_prior():
    """The terms a row of finite lhoods takes exps of: 21-34 a group,
    36 off the diagonal, 173 of the 3,087 that the yardstick counts."""
    n = [int(k.sum()) for k in listed_terms()]
    assert n == [21, 34, 21, 20, 21, 20, 36]


def test_kernel_tree_is_the_plain_tree_sum():
    """The lanes' halvings and the eight-tree finish give _tree_sum's
    bits."""
    rng = np.random.default_rng(4)
    e = torch.from_numpy(rng.random((50, N)) ** 8)
    e[:, rng.random(N) < 0.7] = 0.0
    want = tss._tree_sum(e)
    got = kernel_tree(e)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def tile_lhoods(kinds, L=400):
    rng = np.random.default_rng(len(kinds[0]) + 7 * len(kinds[1]))
    return [tss.freq_grid_lhoods_plain(
        *(torch.from_numpy(a) for a in sparse_tile(rng, L, D, k))).numpy()
        for k, D in zip(kinds, (64, 128))]


def posterior_case(case):
    n, t = tile_lhoods(("binned", "dense") if case == "binned_dense"
                       else ("single", "binned"))
    rows = slice(0, 100)
    if case == "normal_all_ninf":
        n[rows] = -np.inf
    elif case == "tumor_all_ninf":
        t[rows] = -np.inf
    elif case == "normal_prestrand_ninf":
        n[rows, :F] = -np.inf
    elif case == "ties":      # every state equal: ties in every arg
        n[rows] = -3.0
        t[rows] = -3.0
        t[100:200] = t[100:200, :1]
    elif case == "nan_inf":
        n[0:20, 5] = np.nan
        t[20:40, 9] = np.nan
        n[40:60, 2] = np.inf
        t[60:80, 0] = np.inf
        t[80:100, 25] = np.nan
    return n, t


@pytest.mark.parametrize("case", ["single_binned", "binned_dense",
                                  "normal_all_ninf", "tumor_all_ninf",
                                  "normal_prestrand_ninf", "ties", "nan_inf"])
def test_ksp_schedule_matches_plain_and_jax(case):
    n, t = posterior_case(case)
    got = ksp_model(torch.from_numpy(n), torch.from_numpy(t))
    plain = tss.somatic_snv_call_plain(torch.from_numpy(n),
                                       torch.from_numpy(t))
    for f in tss.SomaticSnvResult._fields:
        a, b = getattr(got, f), getattr(plain, f)
        assert a.dtype == b.dtype, f
        nan = torch.isnan(b) if b.is_floating_point() else None
        if nan is not None:
            assert torch.equal(torch.isnan(a), nan), f
            a, b = a[~nan], b[~nan]
        assert torch.equal(a, b), f
        if f == "strand_bias":
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if case == "nan_inf":
        return
    want = jss.somatic_snv_call(jnp.asarray(n), jnp.asarray(t))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.strand_bias.numpy(),
                                  np.asarray(want.strand_bias))
