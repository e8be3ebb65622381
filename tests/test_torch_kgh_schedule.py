"""The schedule of KG-H (csrc/snv_hist_tile.cu), both entries, modelled in
torch on the CPU and held bit for bit against the plain versions
(call_snv_hist_tile_plain, call_snv_lanes_tile_plain) and against the
JAX package's native CPU path.

- The live list of the dense entry: lane l's 16 slots (16 l .. 16 l +
  15), the mask of its nonzero counts, an exclusive warp prefix of the
  masks' popcounts as each lane's first place in the list; of the lanes
  entry: the histogram counted from the calls (shared atomics: integer
  counts, exact in any order), a ballot a 32-slot word, the words' bits
  walked lowest first (__ffs). Both lists hold the row's live slots in
  ascending order.
- The walk: lhood[g] = fma(count, qtab[k, g], lhood[g]) over the live
  list only (a zero count adds exactly nothing: the table holds no -0
  and no non-finite entry, checked here at the CLIs' thetas), then the
  s_mis term.
- The tail, three rows of a warp at once, row r on lanes 10 r + g: the
  genomic and the polymorphic result sets, then the PLs, a group's max
  and first argmax by order-preserving keys (64-bit for the float64
  posteriors; -0 as +0, a NaN above all; the lowest lane wins a tie),
  the 10-wide sums taken in ascending g; then the three rows' nine
  phreds on lanes 0-8 and their ln of the ref posterior on lanes 9-11.

Cases: rows with 0, 1, 4, 32 and 512 live slots; int8 and int32 counts;
haploid rows; rows that s_mis makes -inf or NaN; int16 and uint8 quals
at D = 32, 64, 127, 160 and 300 for the lanes entry. Tolerance: every
field bit for bit against the plain versions; against the native path
(D <= 127, which it takes) lhood bit for bit, the integer fields equal
and ln_ref_pprob within rtol 1e-12, as tests/test_torch_snv_digt.py
holds the plain version.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import strelka_tpu  # noqa: F401  (enables x64, as the JAX caller runs)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu_torch import convert
from strelka_tpu_torch.models import snv_digt as tsd
from test_torch_cuda import lane_tile

CPU = torch.device("cpu")
THETA = 0.001
INT_FIELDS = ("genome_max_gt", "poly_max_gt", "snv_qphred",
              "genome_max_gt_qphred", "poly_max_gt_qphred", "phred_loghood")
LANES = torch.arange(32)
G, GROUP = LANES % 10, LANES // 10    # genotype, group of each lane
BASE = GROUP * 10
BATCH = 3                             # rows a warp's tail takes at once


def tabs():
    return convert.device_tables(THETA, CPU)


# --- the live lists -------------------------------------------------------

def dense_live_list(hist):
    """The dense entry's live list of each row: [L, 512] slots (-1 past
    the row's live count) and the live counts [L]."""
    L = hist.shape[0]
    nz = (hist != 0).view(L, 32, 16)              # lane l's mask bits
    n = nz.sum(2)                                  # __popc
    excl = torch.cumsum(n, 1) - n                  # exclusive warp prefix
    pos = excl[:, :, None] + torch.cumsum(nz, 2) - nz.long()
    out = torch.full((L, 513), -1, dtype=torch.long)
    slots = torch.arange(512).view(32, 16).expand(L, 32, 16)
    out.scatter_(1, torch.where(nz, pos, 512).reshape(L, -1),
                 slots.reshape(L, -1))
    return out[:, :512], n.sum(1)


def lanes_live_list(hist):
    """The lanes entry's walk order: a ballot a 32-slot word (bit l of word
    x for slot 32 x + l), each word's bits taken lowest first."""
    L = hist.shape[0]
    out = torch.full((L, 512), -1, dtype=torch.long)
    live = torch.zeros(L, dtype=torch.long)
    for r in range(L):
        i = 0
        for x in range(16):
            bits = sum(1 << b for b in range(32) if hist[r, 32 * x + b] != 0)
            while bits:
                low = (bits & -bits).bit_length() - 1      # __ffs - 1
                bits &= bits - 1
                out[r, i] = 32 * x + low
                i += 1
        live[r] = i
    return out, live


def lanes_hist(base, qual, mask):
    """The histogram the lanes entry counts (any order: integer adds)."""
    b = base.long()
    q = qual.long().clamp(0, 127)
    ok = mask & (b >= 0) & (b < 4)
    r, d = torch.nonzero(ok, as_tuple=True)
    h = torch.zeros((base.shape[0], 512), dtype=torch.int64)
    h.index_put_((r, q[r, d] * 4 + b[r, d]), torch.ones_like(r),
                 accumulate=True)
    return h


# --- the walk and the tail ------------------------------------------------

def walk(hist, order, live, s_mis):
    """[L, 10] f32: each lane's FMA chain over its row's live list, then
    the s_mis term (b ascending, then one add)."""
    t = tabs()
    qtab, e0 = t["snv_qtab"], t["e0_tab"]
    L = hist.shape[0]
    lh = torch.zeros((L, 10), dtype=torch.float32)
    for i in range(int(live.max()) if L else 0):
        rows = torch.nonzero(live > i)[:, 0]
        k = order[rows, i]
        c = hist[rows, k].to(torch.float32)[:, None]
        lh[rows] = tsd._fma_f32(c, qtab[k], lh[rows])
    if s_mis is not None:
        m = torch.zeros_like(lh)
        for b in range(4):
            m = m + s_mis[:, b:b + 1] * e0[b]
        lh = lh + m
    return lh


def key64(v):
    """The kernel's key64 as a Python-int-exact int64 order: NaN above
    all, -0 as +0, else the value's order (torch has no uint64 max, so
    the signed order of the flipped bits stands for it)."""
    v = torch.where(v == 0, 0.0, v)
    b = v.view(torch.int64)
    k = torch.where(b >= 0, b, b ^ 0x7fffffffffffffff)
    return torch.where(torch.isnan(v), torch.iinfo(torch.int64).max, k)


def key32(v):
    v = torch.where(v == 0, 0.0, v)
    b = v.view(torch.int32).long()
    k = torch.where(b >= 0, b, b ^ 0x7fffffff)
    return torch.where(torch.isnan(v), 2 ** 31, k)


def group_gather(x, base, g):
    """[L, 32]: each lane's x of lane base + g of its row."""
    return x.gather(1, (base + g).remainder(32).expand(x.shape[0], 32))


def seq_sum10(x):
    s = group_gather(x, BASE, 0)
    for g in range(1, 10):
        s = s + group_gather(x, BASE, g)
    return s


def group_max_lane(key, inside):
    """first_max_lane over each lane's group [nb, 32]: the lowest lane of
    the group's top key where `inside`, else the group's first lane."""
    key = torch.where(inside, key, torch.iinfo(torch.int64).min)
    top = torch.stack([torch.where(GROUP == r, key, torch.iinfo(
        torch.int64).min).amax(1) for r in range(4)], 1)[:, GROUP]
    win = torch.where(inside & (key == top), LANES, 32)
    lane = torch.stack([torch.where(GROUP == r, win, 32).amin(1)
                        for r in range(4)], 1)[:, GROUP]
    return torch.where(lane == 32, BASE, lane)


def tail(lh, ref_gt, hap):
    """The batched tail: rows in batches of BATCH, row r of a batch on
    lanes 10 r + g (lanes 30-31 and the groups past a short batch repeat
    its last row); the genomic and the polymorphic result sets, then the
    PLs, on each group; lane 3 i + j the phreds of row i (j = 0: snv,
    1: genome max, 2: poly max), lane 9 + i its ln of the ref posterior.
    Returns the _PULL fields. (The kernel batches a warp's rows, row +
    i * step; rows are independent, so the model takes them in order.)"""
    t = tabs()
    L = lh.shape[0]
    nb = -(-L // BATCH)
    n = torch.clamp(L - BATCH * torch.arange(nb), max=BATCH)     # [nb]
    r = torch.minimum(GROUP[None], (n - 1)[:, None])             # [nb, 32]
    rows = BATCH * torch.arange(nb)[:, None] + r
    live = GROUP[None] < n[:, None]
    ref = ref_gt.long().clamp(0, 4)[rows]
    refc = ref.clamp_max(3)
    hp = (torch.zeros(L, dtype=torch.bool) if hap is None else hap)[rows]
    lhl = lh[rows, G[None]]                                   # [nb, 32] f32
    priors = torch.stack([t[f"prior_{k}"] for k in (
        "genome", "poly", "genome_haploid", "poly_haploid")])
    pref, comp, am = None, [], []
    for k in range(2):
        pp = lhl.double() + priors[hp.long() * 2 + k, ref, G[None]]
        win = group_max_lane(key64(pp), torch.ones_like(live))
        e = torch.exp(pp - pp.gather(1, win))
        p = e / seq_sum10(e)
        total = seq_sum10(p)
        if k == 0:
            pref = p.gather(1, (BASE[None] + refc).remainder(32))
        comp.append(torch.clamp_min(total - p.gather(1, win), 0.0))
        am.append(win - BASE)
    win = group_max_lane(key32(lhl), ~hp | (G[None] < 4))
    d = (lhl - lhl.gather(1, win)) * -10.0
    v = torch.floor(d.double() / torch.tensor(math.log(10.0),
                                              dtype=torch.float64) + 0.5)
    pl = tsd._i32(torch.where(torch.isnan(v), v, v.clamp(0.0, 999.0)))
    # the phred lanes: row i's values from its group's first lane
    i = torch.where(LANES < 3 * BATCH, LANES // 3,
                    (LANES - 3 * BATCH).clamp(max=BATCH - 1))
    j = LANES % 3
    src = (i * 10).expand(nb, 32)
    x = torch.where(j == 0, pref.gather(1, src), torch.where(
        j == 1, comp[0].gather(1, src), comp[1].gather(1, src)))
    q = tsd._i32(torch.clamp_max(torch.floor(
        -10.0 * torch.log10(torch.clamp_min(x, tsd._F64_TINY)) + 0.5), 999))
    ln = torch.log(torch.clamp_min(pref.gather(1, src), tsd._F64_TINY))

    # each row's fields from the lanes that store them
    out = {"lhood": lh}
    first = live & (G[None] == 0)
    out["genome_max_gt"] = am[0][first].to(torch.int32)
    out["poly_max_gt"] = am[1][first].to(torch.int32)
    out["phred_loghood"] = pl[live].view(L, 10)
    qlive = (LANES[None] < 3 * n[:, None])
    qv = q[qlive].view(L, 3)
    out.update(snv_qphred=qv[:, 0], genome_max_gt_qphred=qv[:, 1],
               poly_max_gt_qphred=qv[:, 2])
    llive = (LANES[None] >= 3 * BATCH) & (LANES[None] < 3 * BATCH
                                          + n[:, None])
    out["ln_ref_pprob"] = ln[llive]
    return out


def dense_model(hist, ref_gt, hap, s_mis):
    order, live = dense_live_list(hist)
    return tail(walk(hist, order, live, s_mis), ref_gt, hap), order, live


def lanes_model(base, qual, mask, ref_gt, hap, s_mis):
    h = lanes_hist(base, qual, mask)
    order, live = lanes_live_list(h)
    return tail(walk(h, order, live, s_mis), ref_gt, hap), order, live


# --- the cases ------------------------------------------------------------

def assert_bits(got: dict, want, label):
    """Every field bit for bit, a NaN as a NaN (its sign is the
    platform's)."""
    for f, a in got.items():
        b = getattr(want, f)
        assert a.dtype == b.dtype, (label, f)
        if a.is_floating_point():
            nan = torch.isnan(a)
            assert torch.equal(nan, torch.isnan(b)), (label, f)
            w = torch.int64 if a.dtype == torch.float64 else torch.int32
            a, b = a[~nan].view(w), b[~nan].view(w)
        assert torch.equal(a, b), (label, f)


def assert_native(got: dict, base, qual, mask, ref, hap, smis,
                  rows=slice(None)):
    """Against the JAX package's native CPU path (D <= 127) on `rows`."""
    want = jsd._call_snv_tile_native(base, qual.astype(np.int16), mask, ref,
                                     THETA, hap, smis)
    assert want is not None, "native library unavailable"
    np.testing.assert_array_equal(got["lhood"][rows].numpy().view(np.int32),
                                  want.lhood[rows].view(np.int32))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f][rows].numpy(),
                                      getattr(want, f)[rows], err_msg=f)
    np.testing.assert_allclose(got["ln_ref_pprob"][rows].numpy(),
                               want.ln_ref_pprob[rows], rtol=1e-12, atol=0)


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("theta", [0.001, 0.0001, 0.01])
def test_qtab_has_no_negative_zero_and_no_nonfinite_entry(theta):
    """The premise of the skip: fma(0, q, lh) == lh for every entry q,
    and lh never -0."""
    q = convert.device_tables(theta, CPU)["snv_qtab"]
    assert bool(torch.isfinite(q).all())
    assert not bool(((q == 0) & torch.signbit(q)).any())
    lh = torch.zeros((1, 10))
    assert torch.equal(tsd._fma_f32(torch.zeros(512, 1), q, lh.expand(512,
                                                                      10)),
                       lh.expand(512, 10))


@pytest.mark.parametrize("kind,D", [(0, 40), (1, 64), (4, 64), (32, 64),
                                    (512, 512), ("random", 96)])
@pytest.mark.parametrize("hist_dtype", [np.int8, np.int32])
def test_dense_schedule_matches_plain_and_native(kind, D, hist_dtype):
    rng = np.random.default_rng(D + 3 * (kind if kind != "random" else 7))
    base, qual, mask, ref, hap, smis = lane_tile(rng, 96, D, kind)
    h = tsd._tile_hist(t(base), t(qual), t(mask)).numpy()
    if hist_dtype == np.int32:
        h[:10] *= 300                     # counts past int8's range
    hist = t(h.astype(hist_dtype))
    got, order, live = dense_model(hist, t(ref), t(hap), t(smis))
    # the list: the row's live slots, ascending
    for r in range(hist.shape[0]):
        want = torch.nonzero(hist[r])[:, 0]
        assert torch.equal(order[r, :live[r]], want)
    if kind != "random":
        assert int(live.max()) == kind
    assert_bits(got, tsd.call_snv_hist_tile_plain(hist, t(ref), t(hap),
                                                  THETA, s_mis=t(smis)),
                f"dense {kind}")
    if D <= 127 and hist_dtype == np.int8:
        assert_native(got, base, qual, mask, ref, hap, smis)


@pytest.mark.parametrize("D", [32, 64, 127, 160, 300])
@pytest.mark.parametrize("qual_dtype", [np.int16, np.uint8])
def test_lanes_schedule_matches_plain_and_native(D, qual_dtype):
    rng = np.random.default_rng(D)
    base, qual, mask, ref, hap, smis = lane_tile(rng, 64, D, "random",
                                                 qual_dtype)
    args = [t(a) for a in (base, qual, mask, ref, hap, smis)]
    got, order, live = lanes_model(*args)
    h = tsd._tile_hist(*args[:3])
    for r in range(h.shape[0]):
        assert torch.equal(order[r, :live[r]], torch.nonzero(h[r])[:, 0])
    assert_bits(got, tsd.call_snv_lanes_tile_plain(
        *args[:5], THETA, s_mis=args[5]), f"lanes D={D}")
    if D <= 127:
        assert_native(got, base, qual, mask, ref, hap, smis)


@pytest.mark.parametrize("kind", [1, 4, 512])
def test_lanes_schedule_on_sparse_and_full_rows(kind):
    D = 512 if kind == 512 else 64
    base, qual, mask, ref, hap, smis = lane_tile(
        np.random.default_rng(kind), 24, D, kind)
    args = [t(a) for a in (base, qual, mask, ref, hap, smis)]
    got, _, live = lanes_model(*args)
    assert bool((live == kind).all())
    assert_bits(got, tsd.call_snv_lanes_tile_plain(
        *args[:5], THETA, s_mis=args[5]), f"lanes {kind}")


@pytest.mark.parametrize("fill", ["ninf", "nan"])
@pytest.mark.parametrize("haploid", [False, True])
def test_tail_on_ninf_and_nan_rows_matches_plain_and_jax(fill, haploid):
    """Rows whose lhoods s_mis makes -inf or NaN: the keys' NaN rule, the
    first NaN as the argmax, phreds and PLs 0 as the JAX package's tail
    gives them (its native path gives INT_MIN there, so it is held on
    the other rows only)."""
    rng = np.random.default_rng(17)
    base, qual, mask, ref, hap, smis = lane_tile(rng, 80, 48, "random")
    smis[:30] = -np.inf if fill == "ninf" else np.nan
    smis[10:20, :2] = 0.0                 # some genotypes only
    hap = hap if haploid else None
    args = [t(a) for a in (base, qual, mask, ref, hap, smis)]
    got, _, _ = lanes_model(*args)
    assert_bits(got, tsd.call_snv_lanes_tile_plain(
        *args[:5], THETA, s_mis=args[5]), fill)
    assert_native(got, base, qual, mask, ref, hap, smis, slice(30, None))
    want = jsd._tile_tail(jnp.asarray(got["lhood"].numpy()),
                          jnp.asarray(ref),
                          None if hap is None else jnp.asarray(hap),
                          jsd.make_ln_priors(THETA))
    for i, f in enumerate(INT_FIELDS):
        np.testing.assert_array_equal(
            got[f].numpy(), np.asarray(want[(2, 3, 4, 5, 6, 7)[i]]),
            err_msg=f)
    assert bool((got["snv_qphred"][:10] == 0).all())
    assert bool((got["phred_loghood"][:10] == 0).all())


def test_keys_order_values_as_torch_does():
    """The keys' max and lowest lane give torch.amax and torch.argmax:
    ties, -0 beside +0, -inf, +inf and NaN."""
    v = torch.tensor([[-3.0, -1.0, -1.0, -5.0],
                      [-0.0, 0.0, -1.0, -0.0],
                      [float("-inf")] * 4,
                      [1.0, float("inf"), float("nan"), float("nan")],
                      [-2.5, float("-inf"), -2.5, 3.0]], dtype=torch.float64)
    for key, x in ((key64, v), (key32, v.float())):
        k = key(x)
        top = k.amax(1, keepdim=True)
        lane = torch.where(k == top, torch.arange(4), 4).amin(1)
        assert torch.equal(lane, torch.argmax(x, dim=1))
        got = x.gather(1, lane[:, None])[:, 0]
        want = torch.amax(x, dim=1)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        fin = ~torch.isnan(want)
        assert torch.equal(got[fin], want[fin])
