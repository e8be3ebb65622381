"""The SNV models' kernels (ops/snv_kernels: KG-H's dense and lanes
entries, KG-SB, KG-R, KS-G, KS-P) and their plain versions, on the CPU.

- Rows whose lhoods are all -inf or NaN: the port's somatic_snv_call and
  the germline tile tail give the JAX package's integer fields (XLA's
  convert takes a NaN phred to 0; torch's cast gave INT_MIN), on
  all -inf normal and tumour rows, -inf normal pre-strand states and
  finite rows, and on ten -inf, ten NaN and finite lhoods, haploid and
  diploid.
- Dispatch: CPU tensors reach the plain versions and no kernel, and the
  counters stay 0; on another device the lanes reach the kernels in the
  widths they take.
- The wrappers reject a wrong dtype, shape, device or a non-contiguous
  input before they load anything.
- No fallback: where the library cannot be built or loaded, the wrapper
  and the public functions on a non-CPU tensor raise (meta tensors stand
  in for a card: the load comes before the launch).

The kernels themselves run in tests/test_torch_cuda.py, on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import strelka_tpu  # noqa: F401  (enables x64, as the JAX caller runs)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu.models import somatic_snv as jss
from strelka_tpu_torch import _build, convert
from strelka_tpu_torch.models import snv_digt as tsd
from strelka_tpu_torch.models import somatic_snv as tss
from strelka_tpu_torch.ops import snv_kernels as sk

SOMATIC_INT = ("qphred", "from_ntype_qphred", "ntype", "max_gt",
               "nonsomatic_qphred")
# _tile_tail's outputs: (genome pprob, poly pprob, genome max_gt, poly
# max_gt, snv_qphred, genome max_gt phred, poly max_gt phred, PLs, ln ref)
TAIL_INT = {2: "genome_max_gt", 3: "poly_max_gt", 4: "snv_qphred",
            5: "genome_max_gt_qphred", 6: "poly_max_gt_qphred",
            7: "phred_loghood"}
CPU = torch.device("cpu")


def lhood_rows(rng, L):
    """[L, 30] f32 grid lhoods of a plausible spread."""
    return (-rng.gamma(2.0, 20.0, (L, 30))).astype(np.float32)


@pytest.mark.parametrize("case", ["normal_all_ninf", "tumor_all_ninf",
                                  "normal_prestrand_ninf", "finite"])
def test_somatic_call_on_ninf_rows_matches_jax(case):
    rng = np.random.default_rng(len(case))
    n, t = lhood_rows(rng, 12), lhood_rows(rng, 12)
    rows = slice(0, 6)         # the case's rows; the rest stay finite
    if case == "normal_all_ninf":
        n[rows] = -np.inf
    elif case == "tumor_all_ninf":
        t[rows] = -np.inf
    elif case == "normal_prestrand_ninf":
        n[rows, :tss.PRESTRAND_SIZE] = -np.inf
    want = jss.somatic_snv_call(jnp.asarray(n), jnp.asarray(t))
    got = tss.somatic_snv_call(torch.from_numpy(n), torch.from_numpy(t))
    for f in SOMATIC_INT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(got.strand_bias.numpy(),
                                  np.asarray(want.strand_bias))
    if case != "finite":
        for f in ("qphred", "from_ntype_qphred", "nonsomatic_qphred"):
            assert (getattr(got, f)[rows] == 0).all(), f


@pytest.mark.parametrize("haploid", [False, True])
@pytest.mark.parametrize("case", ["ninf", "nan", "finite"])
def test_tile_tail_on_ninf_and_nan_rows_matches_jax(case, haploid):
    rng = np.random.default_rng(3)
    L = 10
    lh = (-rng.gamma(2.0, 15.0, (L, 10))).astype(np.float32)
    if case != "finite":
        lh[:5] = -np.inf if case == "ninf" else np.nan
    ref = rng.integers(0, 5, L).astype(np.int32)
    hap = (rng.random(L) < 0.5) if haploid else None
    want = jsd._tile_tail(jnp.asarray(lh), jnp.asarray(ref),
                          None if hap is None else jnp.asarray(hap),
                          jsd.make_ln_priors(0.001))
    got = tsd._tile_tail(torch.from_numpy(lh), torch.from_numpy(ref),
                         None if hap is None else torch.from_numpy(hap),
                         convert.device_tables(0.001, CPU))
    for i, f in TAIL_INT.items():
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=f)
    if case != "finite":
        for i in (4, 5, 6, 7):
            assert (got[i][:5] == 0).all(), TAIL_INT[i]


def hist_inputs(rng, L, dtype=np.int8):
    hist = rng.integers(0, 6, (L, 512)).astype(dtype)
    hist[:, rng.random(512) < 0.6] = 0
    ref = rng.integers(0, 5, L).astype(np.int32)
    hap = rng.random(L) < 0.2
    smis = np.where(rng.random((L, 4)) < 0.1,
                    rng.random((L, 4)) * 0.5, 0.0).astype(np.float32)
    return [torch.from_numpy(a) for a in (hist, ref, hap, smis)]


def lane_inputs(rng, L, D, qual_dtype=np.int16):
    """KG-H's lanes entry's operands: (base, qual, mask, ref, hap, smis)."""
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.8, np.minimum(ref, 3)[:, None],
                    rng.integers(-1, 5, (L, D))).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(qual_dtype)
    mask = rng.random((L, D)) < 0.85
    hap = rng.random(L) < 0.2
    smis = np.where(rng.random((L, 4)) < 0.1,
                    rng.random((L, 4)) * 0.5, 0.0).astype(np.float32)
    return [torch.from_numpy(a) for a in (base, qual, mask, ref, hap, smis)]


def grid_inputs(rng, L, D):
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.8, np.minimum(ref, 3)[:, None],
                    rng.integers(-1, 4, (L, D))).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(np.int16)
    mask = rng.random((L, D)) < 0.85
    fwd = rng.random((L, D)) < 0.5
    return [torch.from_numpy(a) for a in (base, qual, mask, fwd, ref)]


def xla_inputs(rng, L, D):
    """KG-SB's and KG-R's operands as the CLI makes them: (base int8,
    qual int16, fwd, mask, ref int32, tgt int32, lt f32, dep_delta f32,
    hap)."""
    ref = rng.integers(0, 5, L).astype(np.int32)
    base = np.where(rng.random((L, D)) < 0.7, np.minimum(ref, 3)[:, None],
                    rng.integers(-1, 5, (L, D))).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(np.int16)
    fwd = rng.random((L, D)) < 0.5
    mask = rng.random((L, D)) < 0.85
    tgt = rng.integers(0, 10, L).astype(np.int32)
    lt = rng.normal(-50, 10, L).astype(np.float32)
    dd = np.where(rng.random((L, D)) < 0.1, -rng.random((L, D)),
                  0.0).astype(np.float32)
    hap = rng.random(L) < 0.2
    return [torch.from_numpy(a) for a in (base, qual, fwd, mask, ref, tgt,
                                          lt, dd, hap)]


RNA_EXT, RNA_INC = 0.45, 0.0501


@pytest.fixture
def no_kernel(monkeypatch):
    """Binding any kernel fails the test; the counters start at 0."""
    def refuse(name):
        raise AssertionError(f"kernel {name} bound on the CPU path")
    monkeypatch.setattr(sk, "function", refuse)
    sk.reset()
    yield
    assert not any(sk.LAUNCHES.values())
    assert not any(sk.PLAIN_ON_CUDA.values())


def test_cpu_tensors_reach_the_plain_versions(no_kernel):
    rng = np.random.default_rng(5)
    hist, ref, hap, smis = hist_inputs(rng, 40)
    got = tsd.call_snv_hist_tile(hist, ref, hap, 0.001, s_mis=smis)
    want = tsd.call_snv_hist_tile_plain(hist, ref, hap, 0.001, s_mis=smis)
    for f in tsd._PULL:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    base, qual, mask, ref, hap, smis = lane_inputs(rng, 40, 24)
    got = tsd.call_snv_lanes_tile(base, qual, mask, ref, hap, s_mis=smis)
    want = tsd.call_snv_lanes_tile_plain(base, qual, mask, ref, hap,
                                         s_mis=smis)
    for f in tsd._PULL:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    tiles = [grid_inputs(rng, 30, 24) for _ in range(2)]
    g = [tss.freq_grid_lhoods(*x) for x in tiles]
    for lh, x in zip(g, tiles):
        assert torch.equal(lh, tss.freq_grid_lhoods_plain(*x))
    got = tss.somatic_snv_call(*g)
    want = tss.somatic_snv_call_plain(*g)
    for f in tss.SomaticSnvResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    base, qual, fwd, mask, ref, tgt, lt, dd, hap = xla_inputs(rng, 30, 32)
    tile = tsd.SnvPileupTile(base, qual, fwd, mask, ref)
    for ext in (0.0, RNA_EXT):
        assert torch.equal(
            tsd.snv_strand_bias_tile(tile, tgt, lt, dd, ext, RNA_INC),
            tsd.snv_strand_bias_tile_plain(tile, tgt, lt, dd, ext, RNA_INC))
    got = tsd.call_snv_tile(tile, 0.001, hap, het_vf_extension=RNA_EXT,
                            het_vf_increment=RNA_INC, dep_delta=dd)
    want = tsd.call_snv_rna_tile_plain(tile, 0.001, hap, RNA_EXT, RNA_INC,
                                       dd)
    for f in tsd._PULL:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def hist_call(hist, ref, hap, smis):
    return sk.snv_hist_tile(hist, ref, hap, smis,
                            convert.device_tables(0.001, CPU))


def lanes_call(base, qual, mask, ref, hap, smis):
    return sk.snv_lanes_tile(base, qual, mask, ref, hap, smis,
                             convert.device_tables(0.001, CPU))


def grid_call(base, qual, mask, fwd, ref):
    from strelka_tpu_torch.convert import somatic_grid_tables
    return sk.somatic_grid(base, qual, mask, fwd, ref,
                           somatic_grid_tables(CPU), tss._LN_HALF_F32)


def post_call(n, t):
    pf, gp, eq, off, _ = tss._posterior_tables(CPU, 0.15, 5e-10, 1e-4,
                                               0.001, 0.0)
    return sk.somatic_posterior(n, t, pf, gp, eq, off)


def sb_call(base, qual, fwd, mask, ref, tgt, lt, dd, ext=RNA_EXT):
    return sk.snv_strand_bias_tile(base, qual, fwd, mask, ref, tgt, lt, dd,
                                   tsd._xla_tables(ext, RNA_INC, CPU))


def rna_call(base, qual, mask, ref, hap, dd, het="table"):
    if het == "table":
        het = tsd._xla_tables(RNA_EXT, RNA_INC, CPU)["het_vf"]
    return sk.snv_rna_tile(base, qual, mask, ref, hap, dd,
                           convert.device_tables(0.001, CPU), het)


def _bad_inputs():
    """(label, call) pairs that each wrapper must reject."""
    rng = np.random.default_rng(7)
    hist, ref, hap, smis = hist_inputs(rng, 16)
    lb, lq, lm, lref, lhap, lsmis = lane_inputs(rng, 16, 24)
    base, qual, mask, fwd, gref = grid_inputs(rng, 16, 24)
    n = torch.from_numpy(lhood_rows(rng, 16))
    t = torch.from_numpy(lhood_rows(rng, 16))
    meta = torch.device("meta")
    xb, xq, xf, xm, xr, xg, xl, xd, xh = xla_inputs(rng, 16, 24)
    return [
        ("sb_base_int32", lambda: sb_call(xb.int(), xq, xf, xm, xr, xg, xl,
                                          xd)),
        ("sb_qual_int32", lambda: sb_call(xb, xq.int(), xf, xm, xr, xg, xl,
                                          xd)),
        ("sb_fwd_dtype", lambda: sb_call(xb, xq, xf.to(torch.uint8), xm, xr,
                                         xg, xl, xd)),
        ("sb_tgt_int64", lambda: sb_call(xb, xq, xf, xm, xr, xg.long(), xl,
                                         xd)),
        ("sb_lt_f64", lambda: sb_call(xb, xq, xf, xm, xr, xg, xl.double(),
                                      xd)),
        ("sb_dep_shape", lambda: sb_call(xb, xq, xf, xm, xr, xg, xl,
                                         xd[:, :8].contiguous())),
        ("sb_strided", lambda: sb_call(xb[:, ::2], xq[:, ::2], xf[:, ::2],
                                       xm[:, ::2], xr, xg, xl, xd[:, ::2])),
        ("sb_rank", lambda: sb_call(xb[0], xq[0], xf[0], xm[0], xr, xg, xl,
                                    xd)),
        ("sb_device", lambda: sb_call(xb, xq, xf, xm.to(meta), xr, xg, xl,
                                      xd)),
        ("rna_mask_dtype", lambda: rna_call(xb, xq, xm.to(torch.uint8), xr,
                                            xh, xd)),
        ("rna_ref_rows", lambda: rna_call(xb, xq, xm, xr[:8], xh, xd)),
        ("rna_hap_dtype", lambda: rna_call(xb, xq, xm, xr, xh.int(), xd)),
        ("rna_dep_f64", lambda: rna_call(xb, xq, xm, xr, xh, xd.double())),
        ("rna_no_table", lambda: rna_call(xb, xq, xm, xr, xh, xd, het=None)),
        ("rna_steps", lambda: rna_call(xb, xq, xm, xr, xh, xd, het=torch.zeros(
            (sk.MAX_STEPS + 1, 4, 256)))),
        ("rna_table_shape", lambda: rna_call(xb, xq, xm, xr, xh, xd,
                                             het=torch.zeros((9, 3, 256)))),
        ("hist_dtype", lambda: hist_call(hist.to(torch.int16), ref, hap,
                                         smis)),
        ("hist_shape", lambda: hist_call(hist[:, :256].contiguous(), ref,
                                         hap, smis)),
        ("hist_strided", lambda: hist_call(hist.t().contiguous().t(), ref,
                                           hap, smis)),
        ("ref_dtype", lambda: hist_call(hist, ref.long(), hap, smis)),
        ("ref_rows", lambda: hist_call(hist, ref[:8], hap, smis)),
        ("hap_dtype", lambda: hist_call(hist, ref, hap.to(torch.uint8),
                                        smis)),
        ("smis_device", lambda: hist_call(hist, ref, hap, smis.to(meta))),
        ("smis_dtype", lambda: hist_call(hist, ref, hap, smis.double())),
        ("lanes_base_int32", lambda: lanes_call(lb.int(), lq, lm, lref,
                                                lhap, lsmis)),
        ("lanes_qual_int32", lambda: lanes_call(lb, lq.int(), lm, lref,
                                                lhap, lsmis)),
        ("lanes_qual_float", lambda: lanes_call(lb, lq.float(), lm, lref,
                                                lhap, lsmis)),
        ("lanes_mask_dtype", lambda: lanes_call(lb, lq, lm.to(torch.uint8),
                                                lref, lhap, lsmis)),
        ("lanes_shape", lambda: lanes_call(lb, lq[:, :12].contiguous(), lm,
                                           lref, lhap, lsmis)),
        ("lanes_rank", lambda: lanes_call(lb[0], lq[0], lm[0], lref[:1],
                                          lhap[:1], lsmis[:1])),
        ("lanes_strided", lambda: lanes_call(lb[:, ::2], lq[:, ::2],
                                             lm[:, ::2], lref, lhap, lsmis)),
        ("lanes_ref_rows", lambda: lanes_call(lb, lq, lm, lref[:8], lhap,
                                              lsmis)),
        ("lanes_smis_device", lambda: lanes_call(lb, lq, lm, lref, lhap,
                                                 lsmis.to(meta))),
        ("grid_mask_dtype", lambda: grid_call(base, qual, mask.to(torch.int8),
                                              fwd, gref)),
        ("grid_qual_float", lambda: grid_call(base, qual.float(), mask, fwd,
                                              gref)),
        ("grid_base_int32", lambda: grid_call(base.int(), qual, mask, fwd,
                                              gref)),
        ("grid_qual_int32", lambda: grid_call(base, qual.int(), mask, fwd,
                                              gref)),
        ("grid_ref_int64", lambda: grid_call(base, qual, mask, fwd,
                                             gref.long())),
        ("grid_strided", lambda: grid_call(base[:, ::2], qual[:, ::2],
                                           mask[:, ::2], fwd[:, ::2], gref)),
        ("grid_shape", lambda: grid_call(base, qual[:, :12].contiguous(),
                                         mask, fwd, gref)),
        ("grid_rank", lambda: grid_call(base[0], qual[0], mask[0], fwd[0],
                                        gref[:1])),
        ("grid_device", lambda: grid_call(base, qual, mask.to(meta), fwd,
                                          gref)),
        ("post_dtype", lambda: post_call(n.double(), t)),
        ("post_shape", lambda: post_call(n[:, :21].contiguous(),
                                         t[:, :21].contiguous())),
        ("post_rows", lambda: post_call(n, t[:8])),
        ("post_strided", lambda: post_call(n, t.t().contiguous().t())),
        ("post_device", lambda: post_call(n, t.to(meta))),
    ]


@pytest.mark.parametrize("case", [c for c, _ in _bad_inputs()])
def test_wrappers_reject_what_the_kernels_do_not_take(case, no_kernel):
    call = dict(_bad_inputs())[case]
    with pytest.raises(ValueError):
        call()


def xla_sb(base, qual, fwd, mask, ref, tgt, lt, dd, hap):
    return sb_call(base, qual, fwd, mask, ref, tgt, lt, dd)


def xla_rna(base, qual, fwd, mask, ref, tgt, lt, dd, hap):
    return rna_call(base, qual, mask, ref, hap, dd)


@pytest.mark.parametrize("which", ["hist", "lanes", "grid", "post", "sb",
                                   "rna"])
def test_wrappers_refuse_cpu_tensors(which, monkeypatch):
    """A wrapper given CPU tensors (which the public functions never
    hand it) binds its kernel and then refuses the device."""
    monkeypatch.setattr(sk, "function", lambda name: None)
    rng = np.random.default_rng(8)
    call = {"hist": lambda: hist_call(*hist_inputs(rng, 4)),
            "lanes": lambda: lanes_call(*lane_inputs(rng, 4, 8)),
            "grid": lambda: grid_call(*grid_inputs(rng, 4, 8)),
            "post": lambda: post_call(
                torch.from_numpy(lhood_rows(rng, 4)),
                torch.from_numpy(lhood_rows(rng, 4))),
            "sb": lambda: xla_sb(*xla_inputs(rng, 4, 8)),
            "rna": lambda: xla_rna(*xla_inputs(rng, 4, 8))}[which]
    sk.reset()
    with pytest.raises(ValueError, match="unsupported device"):
        call()
    assert not any(sk.LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32,
                                   torch.int64])
def test_snv_lanes_reach_the_kernel_in_the_pileups_widths(dtype,
                                                         monkeypatch):
    """call_snv_lanes_tile takes integer lanes of any width; on a card
    KG-H's lanes entry gets int8 base, int16 or uint8 qual and bool mask
    (meta tensors stand in for the card), cast as _tile_hist counts
    them: a base id clamped to int8's range keeps its match with 0..3, a
    qual cast to int16 is clamped to 0..255 first (the kernel clamps it
    to 0..127)."""
    seen = {}

    def kernel(base, qual, mask, ref, hap, smis, tabs):
        seen.update(base=base.dtype, qual=qual.dtype, mask=mask.dtype)
        L = base.shape[0]
        f = dict(device=base.device)
        return (torch.empty((L, 10), **f),
                *[torch.empty(L, dtype=torch.int32, **f)] * 5,
                torch.empty((L, 10), dtype=torch.int32, **f),
                torch.empty(L, dtype=torch.float64, **f))
    monkeypatch.setattr(sk, "snv_lanes_tile", kernel)
    meta = torch.device("meta")
    base, qual, mask, ref, _, _ = lane_inputs(np.random.default_rng(13), 8,
                                              16)
    out = tsd.call_snv_lanes_tile(base.to(dtype).to(meta),
                                  qual.to(dtype).to(meta),
                                  mask.to(torch.uint8).to(meta), ref.to(meta))
    assert out.lhood.shape == (8, 10)
    assert seen == dict(base=torch.int8, qual=torch.uint8 if dtype ==
                        torch.uint8 else torch.int16, mask=torch.bool)
    base = torch.tensor([[0, 3, 4, -1, 260, 2]])
    qual = torch.tensor([[0, 30, 127, 128, 300, -5]])
    mask = torch.tensor([[1, 1, 1, 0, 1, 1]], dtype=torch.uint8)
    b, q, m = tsd._kernel_lanes(base.to(dtype), qual.to(dtype), mask)
    assert b.dtype == torch.int8
    for x in range(4):
        assert torch.equal(b.long() == x, base.to(dtype).long() == x)
    want = qual.to(dtype)
    if dtype not in (torch.uint8, torch.int16):
        want = want.clamp(0, 255)
    assert q.dtype == seen["qual"] and q.tolist() == want.tolist()
    assert m.tolist() == [[True, True, True, False, True, True]]
    assert torch.equal(tsd._tile_hist(b, q, m),
                       tsd._tile_hist(base.to(dtype), qual.to(dtype),
                                      mask.bool()))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32,
                                   torch.int64])
def test_grid_lanes_reach_the_kernel_in_the_pileups_widths(dtype,
                                                          monkeypatch):
    """freq_grid_lhoods takes integer lanes of any width, as the plain
    version does; on a card KS-G gets the native pileup's widths (int8
    base, int16 qual, int32 ref_gt; meta tensors stand in for the
    card)."""
    seen = {}

    def kernel(base, qual, mask, fwd, ref, tabs, ln_half):
        seen.update(base=base.dtype, qual=qual.dtype, ref=ref.dtype)
        return torch.empty((base.shape[0], 30), device=base.device)
    monkeypatch.setattr(sk, "somatic_grid", kernel)
    meta = torch.device("meta")
    base, qual, mask, fwd, ref = grid_inputs(np.random.default_rng(12), 8, 16)
    out = tss.freq_grid_lhoods(base.to(dtype).to(meta),
                               qual.to(dtype).to(meta), mask.to(meta),
                               fwd.to(meta), ref.to(dtype).to(meta))
    assert out.shape == (8, 30)
    assert seen == dict(base=torch.int8, qual=torch.int16, ref=torch.int32)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32,
                                   torch.int64])
def test_sb_and_rna_lanes_reach_the_kernels_in_the_pileups_widths(
        dtype, monkeypatch):
    """snv_strand_bias_tile and call_snv_tile's RNA pass take integer
    lanes of any width; on a card (meta tensors stand in for it) KG-SB
    and KG-R get int8 base, int16 or uint8 qual, bool strand and mask and
    int32 ids, cast with the plain versions' rules kept: a base id
    clamped to int8's range keeps its bias index, its match with 0..3 and
    its count; a qual cast to int16 is clamped to 0..255 first."""
    seen = {}

    def sb_kernel(base, qual, fwd, mask, ref, tgt, lt, dd, xtabs):
        seen["sb"] = (base.dtype, qual.dtype, fwd.dtype, mask.dtype,
                      ref.dtype, tgt.dtype)
        return torch.empty(base.shape[0], device=base.device)

    def rna_kernel(base, qual, mask, ref, hap, dd, tabs, het_vf):
        seen["rna"] = (base.dtype, qual.dtype, mask.dtype, ref.dtype,
                       hap.dtype, het_vf.shape[0])
        L = base.shape[0]
        f = dict(device=base.device)
        return (torch.empty((L, 10), **f),
                *[torch.empty(L, dtype=torch.int32, **f)] * 5,
                torch.empty((L, 10), dtype=torch.int32, **f),
                torch.empty(L, dtype=torch.float64, **f))
    monkeypatch.setattr(sk, "snv_strand_bias_tile", sb_kernel)
    monkeypatch.setattr(sk, "snv_rna_tile", rna_kernel)
    meta = torch.device("meta")
    b, q, f, m, r, g, lt, dd, hap = xla_inputs(np.random.default_rng(13), 8,
                                                16)
    tile = tsd.SnvPileupTile(b.to(dtype).to(meta), q.to(dtype).to(meta),
                             f.to(torch.uint8).to(meta),
                             m.to(torch.uint8).to(meta), r.long().to(meta))
    assert tsd.snv_strand_bias_tile(tile, g.long().to(meta), lt.to(meta),
                                    dd.to(meta), RNA_EXT,
                                    RNA_INC).shape == (8,)
    out = tsd.call_snv_tile(tile, 0.001, hap.to(torch.uint8).to(meta),
                            het_vf_extension=RNA_EXT,
                            het_vf_increment=RNA_INC, dep_delta=dd.to(meta))
    assert out.lhood.shape == (8, 10)
    qd = torch.uint8 if dtype == torch.uint8 else torch.int16
    assert seen["sb"] == (torch.int8, qd, torch.bool, torch.bool,
                          torch.int32, torch.int32)
    assert seen["rna"] == (torch.int8, qd, torch.bool, torch.int32,
                           torch.bool, 9)
    base = torch.tensor([[0, 3, 4, -1, -3, 200, -200, 2]])
    qual = torch.tensor([[0, 30, 127, 128, 255, 300, -5, 45]])
    xb, xq, xm = tsd._kernel_lanes(base.to(dtype), qual.to(dtype),
                                   torch.ones_like(base, dtype=torch.uint8))
    assert xm.dtype == torch.bool and bool(xm.all())
    src = base.to(dtype).long()
    assert torch.equal(tsd._bias_index(xb.long()), tsd._bias_index(src))
    for x in range(4):
        assert torch.equal(xb.long() == x, src == x)
    want = qual.to(dtype).long()
    if dtype not in (torch.uint8, torch.int16):
        want = want.clamp(0, 255)
    assert xq.dtype == qd and xq.long().tolist() == want.tolist()


@pytest.fixture
def broken_loader(monkeypatch):
    def fail(name):
        raise RuntimeError(f"cannot build lib{name}.so")
    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(sk, "_BOUND", {})
    sk.reset()


@pytest.mark.parametrize("name", sorted(sk.REPLACES))
def test_load_step_raises_without_the_library(name, broken_loader):
    with pytest.raises(RuntimeError, match=f"lib{sk.source(name)}.so"):
        sk.function(name)


@pytest.mark.parametrize("which", ["hist", "lanes", "grid", "post", "sb",
                                   "rna"])
def test_no_fallback_to_the_plain_version(which, broken_loader):
    """The public functions on a non-CPU tensor go to the kernel alone:
    where it cannot be loaded they raise, and never return the plain
    version's result."""
    meta = torch.device("meta")
    rng = np.random.default_rng(9)
    if which == "hist":
        hist, ref, hap, smis = (x.to(meta) for x in hist_inputs(rng, 8))
        args, fn = (hist, ref, hap, 0.001, smis), tsd.call_snv_hist_tile
    elif which == "lanes":
        base, qual, mask, ref, hap, smis = (x.to(meta)
                                            for x in lane_inputs(rng, 8, 16))
        args, fn = ((base, qual, mask, ref, hap, 0.001, smis),
                    tsd.call_snv_lanes_tile)
    elif which == "grid":
        args = [a.to(meta) for a in grid_inputs(rng, 8, 16)]
        fn = tss.freq_grid_lhoods
    elif which in ("sb", "rna"):
        b, q, f, m, r, g, lt, dd, hap = (x.to(meta)
                                         for x in xla_inputs(rng, 8, 16))
        tile = tsd.SnvPileupTile(b, q, f, m, r)
        args = ((tile, g, lt, dd, RNA_EXT, RNA_INC) if which == "sb" else
                (tile, 0.001, hap, None, RNA_EXT, RNA_INC, dd))
        fn = (tsd.snv_strand_bias_tile if which == "sb" else
              tsd.call_snv_tile)
    else:
        args = [torch.from_numpy(lhood_rows(rng, 8)).to(meta)
                for _ in range(2)]
        fn = tss.somatic_snv_call
    with pytest.raises(RuntimeError, match="cannot build"):
        fn(*args)
    assert not any(sk.LAUNCHES.values())
    assert not any(sk.PLAIN_ON_CUDA.values())


def test_empty_tiles_launch_nothing(monkeypatch):
    """L = 0 on the kernel route: empty outputs of the right shapes and
    no launch (the wrappers check and bind nothing further)."""
    monkeypatch.setattr(sk, "function", lambda name: None)
    sk.reset()
    rng = np.random.default_rng(10)
    for out in (hist_call(*hist_inputs(rng, 0)),
                lanes_call(*lane_inputs(rng, 0, 8)),
                xla_rna(*xla_inputs(rng, 0, 8))):
        assert [tuple(t.shape) for t in out] == [(0, 10)] + [(0,)] * 5 + \
            [(0, 10), (0,)]
    assert xla_sb(*xla_inputs(rng, 0, 8)).shape == (0,)
    assert grid_call(*grid_inputs(rng, 0, 8)).shape == (0, 30)
    e = torch.zeros((0, 30))
    assert all(t.shape == (0,) for t in post_call(e, e))
    assert not any(sk.LAUNCHES.values())


def test_kernel_row_bytes_on_a_card_are_inputs_and_outputs():
    """The card's chunks are sized by the kernels' bytes a row; the CPU
    keeps the plain versions' working set."""
    assert tss.call_row_bytes("cpu") == tss.CALL_ROW_BYTES
    assert tss.call_row_bytes("cuda") == 2 * 30 * 4 + 6 * 4
    assert tss.tile_row_bytes("cpu", 64) == (
        tss.CALL_ROW_BYTES + tss.GRID_ROW_BYTES + tss.GRID_LANE_BYTES * 64)
    assert tss.tile_row_bytes("cuda", 64) == (
        tss.KERNEL_CALL_ROW_BYTES + tss.KERNEL_GRID_ROW_BYTES
        + tss.KERNEL_GRID_LANE_BYTES * 64)


def test_plain_versions_take_zero_rows():
    """The plain versions on an empty tile give empty fields (the posterior
    names its 441 terms: a -1 reshape of zero rows is refused)."""
    rng = np.random.default_rng(11)
    e = torch.zeros((0, 30))
    r = tss.somatic_snv_call_plain(e, e)
    assert all(getattr(r, f).shape == (0,) for f in r._fields)
    assert tss.freq_grid_lhoods_plain(*grid_inputs(rng, 0, 8)).shape == (0, 30)
    hist, ref, hap, smis = hist_inputs(rng, 0)
    g = tsd.call_snv_hist_tile_plain(hist, ref, hap, s_mis=smis)
    assert g.lhood.shape == (0, 10) and g.phred_loghood.shape == (0, 10)
    base, qual, mask, ref, hap, smis = lane_inputs(rng, 0, 8)
    g = tsd.call_snv_lanes_tile_plain(base, qual, mask, ref, hap,
                                      s_mis=smis)
    assert g.lhood.shape == (0, 10) and g.phred_loghood.shape == (0, 10)
    base, qual, fwd, mask, ref, tgt, lt, dd, hap = xla_inputs(rng, 0, 32)
    tile = tsd.SnvPileupTile(base, qual, fwd, mask, ref)
    g = tsd.call_snv_rna_tile_plain(tile, 0.001, hap, RNA_EXT, RNA_INC, dd)
    assert g.lhood.shape == (0, 10) and g.phred_loghood.shape == (0, 10)
    assert tsd.snv_strand_bias_tile_plain(tile, tgt, lt, dd, RNA_EXT,
                                          RNA_INC).shape == (0,)
