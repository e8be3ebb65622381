"""Batched diploid SNV genotyping model.

TPU-native re-design of the reference's per-position SNP caller
(reference: blt_common/position_snp_call_pprob_digt.cpp
get_diploid_gt_lhood / calculate_result_set /
position_snp_call_pprob_digt). The per-basecall loops become one
einsum over padded [loci, depth] pileup tiles:

    lhood[l,g] = sum_d  val[l,d, expect2(obs[l,d], g)]

with val[0]=ln(e/3), val[1]=ln(ce + (1-ce)/3) - ln 2, val[2]=ln(1-e),
expressed as W[l,d,(obs,k)] @ T[(obs,k),g] so the genotype reduction
rides the MXU. Strand-bias recomputation and the polymorphic/genomic
prior products are all batched over loci.

Port of strelka_tpu/models/snv_digt.py. The host parts (priors, the
(qscore, base) contribution table, dependent-eprob deltas, the native
CPU path) are copies. The device tiles are torch ops:
call_snv_hist_tile, call_snv_tile and snv_strand_bias_tile. The
histogram product and the posterior tail follow the canonical order
that native/snvcall.cpp defines — ascending (q, base) slot, one f32
fused multiply-add per slot as the compiled library runs it,
sequential 10-genotype sums — as loops of torch ops over columns, so a
CUDA run gives the CPU path's bits for the lhood. RNA mode (the het-VF
extension), where the JAX package runs its XLA tile on the CPU, and the
strand-bias tile follow XLA's CPU arithmetic instead: per-call values
from host tables, XLA's log and exp polynomials and its reduction
orders, as elementwise torch ops (the same bits on the CPU and the
card).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import digt

LN_ONE_THIRD = float(np.log(1.0 / 3.0))
LN_ONE_HALF = float(np.log(0.5))


# ---------------------------------------------------------------------------
# priors (pprob_digt_caller ctor: get_genomic_prior / get_poly_prior /
# haploid variants + finish_prior averaging for ref=N)
# ---------------------------------------------------------------------------

def _genomic_prior(ref_gt: int, theta: float) -> np.ndarray:
    prior = np.zeros(digt.SIZE)
    s = 0.0
    for gt in range(digt.SIZE):
        if gt == ref_gt:
            continue
        p = theta / 3.0
        if digt.IS_HET[gt]:
            if digt.EXPECT[gt, ref_gt] <= 0.0:
                p *= theta
        else:
            p *= 0.5
        prior[gt] = p
        s += p
    prior[ref_gt] = 1.0 - s
    return prior


def _haploid_genomic_prior(ref_gt: int, theta: float) -> np.ndarray:
    prior = np.zeros(digt.SIZE)
    s = 0.0
    for gt in range(digt.SIZE):
        if gt == ref_gt:
            continue
        prior[gt] = 0.0 if digt.IS_HET[gt] else theta / 3.0
        s += prior[gt]
    prior[ref_gt] = 1.0 - s
    return prior


def _poly_prior(ref_gt: int, theta: float) -> np.ndarray:
    prior = np.zeros(digt.SIZE)
    ctheta = 1.0 - theta
    for gt in range(digt.SIZE):
        if gt == ref_gt:
            prior[gt] = 0.25 * ctheta
        elif digt.IS_HET[gt]:
            if digt.EXPECT[gt, ref_gt] <= 0.0:
                prior[gt] = theta / 3.0
            else:
                prior[gt] = 0.5 / 3.0 * ctheta
        else:
            prior[gt] = 0.25 / 3.0 * ctheta
    return prior


def _haploid_poly_prior(ref_gt: int, theta: float) -> np.ndarray:
    prior = np.zeros(digt.SIZE)
    for gt in range(digt.SIZE):
        if gt == ref_gt:
            prior[gt] = 0.5
        elif digt.IS_HET[gt]:
            prior[gt] = 0.0
        else:
            prior[gt] = 0.5 / 3.0
    return prior


@functools.lru_cache(maxsize=8)
def make_ln_priors(theta: float):
    """[5, 10] ln prior tables indexed by ref base id (4 = N = average).

    Returns dict with 'genome', 'poly', 'genome_haploid', 'poly_haploid'.
    """
    out = {}
    for key, fn in (
        ("genome", _genomic_prior), ("poly", _poly_prior),
        ("genome_haploid", _haploid_genomic_prior),
        ("poly_haploid", _haploid_poly_prior),
    ):
        table = np.stack([fn(r, theta) for r in range(digt.N_BASE)])
        navg = table.mean(axis=0)
        navg /= navg.sum()
        table = np.vstack([table, navg[None, :]])
        with np.errstate(divide="ignore"):
            out[key] = np.log(table)
    return out


class SnvPileupTile(NamedTuple):
    """Padded pileup tile: [L, D] arrays (numpy or torch tensors)."""
    base_id: object   # int8/int32 in 0..3 (invalid lanes masked)
    qual: object      # int32 phred
    is_fwd: object    # bool
    mask: object      # bool — lane holds a used basecall
    ref_gt: object    # [L] int32, 0..4 (4 = N)


class SnvCallResult(NamedTuple):
    lhood: object           # [L, 10] genotype log likelihoods
    genome_pprob: object    # [L, 10] genomic posterior (linear)
    poly_pprob: object      # [L, 10] polymorphic posterior (linear)
    genome_max_gt: object   # [L]
    poly_max_gt: object     # [L]
    snv_qphred: object      # [L] Q(snp) from genomic ref pprob
    genome_max_gt_qphred: object  # [L]
    poly_max_gt_qphred: object    # [L]
    phred_loghood: object   # [L, 10] PL values
    strand_bias: object     # [L]
    # [L] ln of the genomic ref-genotype posterior; summed over samples
    # it becomes site QUAL (starling_pos_processor.cpp:688-691
    # homRefLogProb += std::log(dgt.genome.ref_pprob)). Floored at the
    # f64 smallest-normal (the reference's double underflows to -inf a
    # few decades later; unreachable at realistic depths).
    ln_ref_pprob: object = None


_SNV_QTAB_SIZE = 128


@functools.lru_cache(maxsize=1)
def _snv_qtab():
    """[(Q*4), 10] per-(qscore, obs-base) genotype log-lhood
    contribution table: tab[q*4+b, g] = val(q)[expect2(g, b)]
    (get_diploid_gt_lhood; numpy, cached outside any trace)."""
    q = np.arange(_SNV_QTAB_SIZE, dtype=np.float32)
    e = np.power(np.float32(10.0), -q / np.float32(10.0), dtype=np.float32)
    ce = (np.float32(1.0) - e).astype(np.float32)
    floor = np.float32(1e-35)
    v = np.stack([
        np.log(np.maximum(e, floor)) + np.float32(LN_ONE_THIRD),
        np.log(ce + (1.0 - ce) / np.float32(3.0)) + np.float32(LN_ONE_HALF),
        np.log(np.maximum(ce, floor)),
    ], axis=-1).astype(np.float32)                                  # [Q,3]
    exp2 = np.asarray(digt.EXPECT2, np.int64)                       # [10,4]
    tab = np.empty((_SNV_QTAB_SIZE * digt.N_BASE, digt.SIZE),
                   np.float32)
    for b in range(digt.N_BASE):
        tab[b::digt.N_BASE, :] = v[:, exp2[:, b]]
    return tab


@functools.lru_cache(maxsize=1)
def _e0_tab():
    """[4, 10] f32 indicator: expect2(g, b) == 0 (the mismatch cell).
    s_mis[l, b] @ _e0_tab() adds the dependent-eprob mismatch-term
    delta to every genotype that mismatches base b."""
    exp2 = np.asarray(digt.EXPECT2)                    # [10, 4] by (g, b)
    return (exp2 == 0).T.astype(np.float32)            # [4, 10]


def dependent_eprob_deltas(base_id, qual, used, fwd, neighbor_mm,
                           ssd_no: float, ssd_one: float):
    """Dependent basecall-error adjustment deltas
    (blt_common/adjust_joint_eprob.cpp; enabled by default in the
    germline caller, starling_shared.hh:34-35). Returns
    (s_delta f32 [L, 4], plane_fn) where s_delta[l, b] sums
    ln(de)-ln(e) over used calls of base b at site l, and
    plane_fn(rows) gathers the per-call [len(rows), D] delta plane for
    a row subset (rows=None -> all rows). Most sites have no
    multi-call (strand, base) group, so s_delta is overwhelmingly zero
    and the unadjusted likelihoods stay bit-identical."""
    L, D = base_id.shape
    nb = neighbor_mm
    if nb is None:
        # reference default when not measured
        # (starling_pos_processor_base.cpp:1242-1243)
        nb = np.zeros((L, D), dtype=bool)

    from ..io.native import dependent_eprob_delta_native

    def compute(b, q, u, f, n, want_plane):
        res = dependent_eprob_delta_native(b, q, u, f, n, ssd_no,
                                           ssd_one,
                                           want_plane=want_plane)
        if res is not None:
            return res
        return _dependent_eprob_python(b, q, u, f, n, ssd_no, ssd_one)

    # the [L, 4] sums are all the production hist path needs; the
    # [*, D] per-call plane (strand-bias SNP subsets, RNA full tiles)
    # is computed lazily per row subset — a fresh whole-region [L, D]
    # f32 plane page-faults for ~1s/Mb on this VM class
    s_delta, _ = compute(base_id, qual, used, fwd, nb, False)

    def plane_fn(rows=None):
        if rows is None:
            return compute(base_id, qual, used, fwd, nb, True)[1]
        return compute(
            np.ascontiguousarray(base_id[rows]),
            np.ascontiguousarray(qual[rows]),
            np.ascontiguousarray(used[rows]),
            np.ascontiguousarray(fwd[rows]),
            np.ascontiguousarray(nb[rows]), True)[1]

    return s_delta, plane_fn


def _dependent_eprob_python(base_id, qual, used, fwd, nbmm,
                            ssd_no, ssd_one):
    """Pure-python fallback (slow; the semantic twin of
    native/depeprob.cpp)."""
    import math
    L, D = base_id.shape
    s_delta = np.zeros((L, 4), np.float32)
    plane = np.zeros((L, D), np.float32)
    ln_ran = math.log(0.75)
    elig = used & (base_id >= 0) & (base_id < 4) & (qual >= 3)
    gid = np.where(elig, fwd.astype(np.int64) + 2 * base_id, -1)
    counts = np.zeros((L, 8), np.int32)
    li, di = np.nonzero(elig)
    np.add.at(counts, (li, gid[li, di]), 1)
    for l in np.nonzero((counts >= 2).any(axis=1))[0]:
        for g in range(8):
            if counts[l, g] < 2:
                continue
            mem = [d for d in range(D) if gid[l, d] == g]
            num = den = 0.0
            for d in mem:
                e = 10.0 ** (-qual[l, d] / 10.0)
                w = ln_ran - math.log(e)
                den += w
                if nbmm[l, d]:
                    num += w
            mfrac = num / den if den > 0 else 0.0
            vexp_frac = (1 - mfrac) * ssd_no + mfrac * ssd_one
            mem.sort(key=lambda d: -qual[l, d])
            vexp = 1.0
            for d in mem:
                e = 10.0 ** (-qual[l, d] / 10.0)
                val = e ** vexp
                frac = (1 - val) / (1 - e)
                de = max(e, frac * val + (1 - frac) * 0.75)
                delta = np.float32(math.log(de) - math.log(e))
                s_delta[l, g >> 1] += delta
                plane[l, d] = delta
                vexp *= 1 - vexp_frac
    return s_delta, plane


# ---------------------------------------------------------------------------
# device tiles (torch)
# ---------------------------------------------------------------------------

_LN10 = math.log(10.0)
_F64_TINY = float(np.finfo(np.float64).tiny)


def _tables(theta: float, device):
    from ..convert import device_tables
    return device_tables(theta, torch.device(device))


def _div(x, c: float):
    """x / c, correctly rounded on every device: CUDA torch turns a
    division by a host scalar into a multiplication by its reciprocal,
    so the divisor goes in as a tensor on x's device."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _seq_sum(x):
    """Sum over the last axis in ascending order, one add at a time
    (the canonical order of native/snvcall.cpp; torch.sum reduces as a
    tree)."""
    s = x[..., 0]
    for g in range(1, x.shape[-1]):
        s = s + x[..., g]
    return s


def _fma_f32(a, b, c):
    """a * b + c rounded once to f32 (a fused multiply-add), from f32
    tensors: the product is exact in f64, the sum's f64 rounding error
    is recovered exactly (TwoSum), and the one case where rounding the
    f64 sum to f32 rounds twice — a sum exactly halfway between two
    f32 values — is resolved by that error's sign."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    rd = r.to(torch.float64)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    nb = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    tie = (s == (rd + nb.to(torch.float64)) * 0.5) & (err != 0)
    return torch.where(tie & ((err > 0) == (nb > r)), nb, r)


def _hist_lhood(hist, qtab, cols=None):
    """lhood[l, g] = sum_k hist[l, k] * qtab[k, g] in the canonical
    order of native/snvcall.cpp: ascending slot k, each step
    lh = fma(count, qtab[k], lh) in f32 (g++ contracts the C++
    `lh[g] += fc * t[g]` into a fused multiply-add under its default
    -ffp-contract=fast with -march=native). hist [L, K] integer
    counts; cols lists the slots to visit (host ints, ascending) — a
    slot whose column is all zero adds nothing and may be skipped."""
    L, K = hist.shape
    lh = torch.zeros((L, digt.SIZE), dtype=torch.float32,
                     device=hist.device)
    if cols is None:
        cols = range(K)
    hist_t = hist.t().contiguous()          # [K, L]: a slot is one row
    for k in cols:
        lh = _fma_f32(hist_t[k].to(torch.float32)[:, None], qtab[k], lh)
    return lh


def _add_smis(lhood, s_mis, e0):
    """lhood + s_mis @ e0 with the 4-term dot summed first, b ascending,
    then added once (native/snvcall.cpp)."""
    m = torch.zeros_like(lhood)
    for b in range(digt.N_BASE):
        m = m + s_mis[:, b:b + 1] * e0[b]
    return lhood + m


def _result_set(lhood, ln_prior, ref_gt):
    """posterior + Q from lhood and prior (calculate_result_set).

    Posterior math in float64 like the reference (pprob is double);
    the 10-genotype sums are sequential (native/snvcall.cpp).
    """
    pp = lhood.to(torch.float64) + ln_prior
    mx = torch.amax(pp, dim=-1, keepdim=True)
    p = torch.exp(pp - mx)
    p = p / _seq_sum(p)[:, None]
    max_gt = torch.argmax(pp, dim=-1)
    ref_pprob = torch.gather(p, 1, ref_gt[:, None])[:, 0]
    # prob_comp: 1 - p[max] as sum of complement
    total = _seq_sum(p)
    pmax = torch.gather(p, 1, max_gt[:, None])[:, 0]
    comp = torch.clamp_min(total - pmax, 0.0)
    # round-half-up (reference error_prob_to_qphred uses floor(x+0.5))
    q_ref = torch.clamp_max(torch.floor(
        -10.0 * torch.log10(torch.clamp_min(ref_pprob, _F64_TINY)) + 0.5),
        999)
    q_max = torch.clamp_max(torch.floor(
        -10.0 * torch.log10(torch.clamp_min(comp, _F64_TINY)) + 0.5), 999)
    ln_ref = torch.log(torch.clamp_min(ref_pprob, _F64_TINY))
    return (p, max_gt.to(torch.int32), q_ref.to(torch.int32),
            q_max.to(torch.int32), ln_ref)


def _tile_tail(lhood, ref_gt, is_haploid, tabs):
    """Posterior tail shared by call_snv_tile and call_snv_hist_tile:
    priors, genomic/polymorphic result sets, and PLs from the [L, 10]
    genotype log-likelihoods."""
    ref = ref_gt.to(torch.int64)
    gen_prior = tabs["prior_genome"][ref]
    poly_prior = tabs["prior_poly"][ref]
    if is_haploid is not None:
        hap = is_haploid[:, None]
        gen_prior = torch.where(hap, tabs["prior_genome_haploid"][ref],
                                gen_prior)
        poly_prior = torch.where(hap, tabs["prior_poly_haploid"][ref],
                                 poly_prior)

    ref_clamped = torch.clamp_max(ref, digt.N_BASE - 1)
    g_p, g_max, g_qref, g_qmax, g_lnref = _result_set(lhood, gen_prior,
                                                      ref_clamped)
    p_p, p_max, _p_qref, p_qmax, _p_lnref = _result_set(lhood, poly_prior,
                                                        ref_clamped)

    # PLs (position_snp_call_pprob_digt.cpp:498-511); haploid loci
    # normalize against the hom-only max (gtcount=N_BASE, :501). The
    # scaled difference is f32, the division by ln 10 f64.
    lmax = torch.amax(lhood, dim=-1, keepdim=True)
    if is_haploid is not None:
        hom_max = torch.amax(lhood[:, :digt.N_BASE], dim=-1, keepdim=True)
        lmax = torch.where(is_haploid[:, None], hom_max, lmax)
    t = (lhood - lmax) * -10.0
    pl = torch.clamp(torch.floor(_div(t.to(torch.float64), _LN10) + 0.5),
                     0, 999).to(torch.int32)
    return g_p, p_p, g_max, p_max, g_qref, g_qmax, p_qmax, pl, g_lnref


def _result(lhood, tail):
    (g_p, p_p, g_max, p_max, g_qref, g_qmax, p_qmax, pl, g_lnref) = tail
    return SnvCallResult(
        lhood=lhood, genome_pprob=g_p, poly_pprob=p_p,
        genome_max_gt=g_max, poly_max_gt=p_max,
        snv_qphred=g_qref, genome_max_gt_qphred=g_qmax,
        poly_max_gt_qphred=p_qmax, phred_loghood=pl,
        strand_bias=torch.zeros(lhood.shape[0], dtype=torch.float64,
                                device=lhood.device),
        ln_ref_pprob=g_lnref,
    )


def call_snv_hist_tile(hist, ref_gt, is_haploid=None,
                       theta: float = 0.001, s_mis=None,
                       cols=None) -> SnvCallResult:
    """call_snv_tile's main pass from a precomputed (qscore, base)
    histogram (hist int8/int32 [L, _SNV_QTAB_SIZE*4] on the tile's
    device, host-counted by native/snvhist.cpp). The lhood is the
    canonical-order product of native/snvcall.cpp (bit-identical to
    the CPU path on any device); cols optionally lists the nonzero
    slots (host ints, ascending). strand_bias is zeros:
    call_snv_tile_chunked runs snv_strand_bias_tile on the SNP subset."""
    tabs = _tables(theta, hist.device)
    lhood = _hist_lhood(hist, tabs["snv_qtab"], cols)
    if s_mis is not None:
        # dependent-eprob mismatch-term deltas (adjust_joint_eprob):
        # s_mis[l, b] is zero at unadjusted sites, so those stay
        # bit-identical
        lhood = _add_smis(lhood, s_mis, tabs["e0_tab"])
    return _result(lhood, _tile_tail(lhood, ref_gt, is_haploid, tabs))


def _tile_hist(base_id, qual, mask):
    """[L, Q*4] int32 (qscore, base) counts of the used calls of a
    tile (integer scatter-add: exact in any order)."""
    L, D = base_id.shape
    K = _SNV_QTAB_SIZE * digt.N_BASE
    b = base_id.to(torch.int64)
    q = torch.clamp(qual.to(torch.int64), 0, _SNV_QTAB_SIZE - 1)
    valid = mask & (b >= 0) & (b < digt.N_BASE)
    idx = torch.where(valid, q * digt.N_BASE + b, K)
    hist = torch.zeros((L, K + 1), dtype=torch.int32, device=b.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return hist[:, :K]


def call_snv_tile(tile: SnvPileupTile, theta: float = 0.001,
                  is_haploid=None, dep_smis=None,
                  het_vf_extension: float = 0.0,
                  het_vf_increment: float = 0.0501,
                  dep_delta=None) -> SnvCallResult:
    """Batched equivalent of position_snp_call_pprob_digt over a tile
    of torch tensors (any depth D; the counts are int32).

    is_haploid: optional [L] bool selecting haploid priors per locus
    (ploidy regions, ploidy_util.hh). dep_smis: optional [L, 4]
    dependent-eprob mismatch-term sums. Strand bias is left at zero
    (the reference computes it only at is_snp() rows;
    call_snv_tile_chunked runs snv_strand_bias_tile on that subset).

    het_vf_extension > 0 (RNA mode): the het genotypes' lhood takes the
    het-VF extension terms (_het_vf_extension_lhoods), logsumexp'd with
    the base lhood, as the JAX package's XLA tile does; the base product
    and the mismatch-term deltas then follow XLA's CPU dot order
    (_xla_hist_lhood), and dep_delta ([L, D] per-call deltas) replaces
    dep_smis.
    """
    hist = _tile_hist(tile.base_id, tile.qual, tile.mask)
    cols = torch.nonzero(hist.any(dim=0))[:, 0].tolist()
    if het_vf_extension <= 0:
        return call_snv_hist_tile(hist, tile.ref_gt, is_haploid, theta,
                                  s_mis=dep_smis, cols=cols)
    tabs = _tables(theta, hist.device)
    lhood = _xla_hist_lhood(hist, tabs["snv_qtab"], cols)
    if dep_delta is not None:
        lhood = _xla_add_smis(lhood, _dep_smis(tile.base_id, tile.mask,
                                               dep_delta), tabs["e0_tab"])
    ext = _het_vf_extension_lhoods(tile.base_id, tile.qual, tile.mask,
                                   het_vf_extension, het_vf_increment,
                                   dep_delta=dep_delta)
    lhood = _het_vf_combine(lhood, ext)
    return _result(lhood, _tile_tail(lhood, tile.ref_gt, is_haploid, tabs))


_VALS_Q = 256     # qscores of the per-call value tables (uint8 quals)


@functools.lru_cache(maxsize=1)
def _call_vals_table():
    """[_VALS_Q, 3] f32 numpy: get_diploid_gt_lhood's val[0..2] for each
    qscore, as the JAX package's _call_vals computes them on XLA's CPU
    backend (e = 10^(q * -0.1), correctly rounded; ce = 1 - e; v0 = ln
    max(e, 1e-35) + ln 1/3; v1 = ln(ce + (1-ce) * f32(1/3)) + ln 1/2, the
    sum fused; v2 = ln max(ce, 1e-35), with XLA's log)."""
    f = np.float32
    q = np.arange(_VALS_Q, dtype=f)
    e = np.power(10.0, (q * f(-0.1)).astype(np.float64)).astype(f)
    ce = f(1.0) - e
    floor = f(1e-35)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=f))
    v0 = _xla_log_f32(t(np.maximum(e, floor))) + _f32(LN_ONE_THIRD)
    v1 = _xla_log_f32(_fma_f32(t(f(1.0) - ce), _f32(1.0 / 3.0), t(ce))
                      ) + _f32(LN_ONE_HALF)
    v2 = _xla_log_f32(t(np.maximum(ce, floor)))
    return torch.stack([v0, v1, v2], dim=-1).numpy()


def _call_vals(qual):
    """Per-call val[·,·,3] (get_diploid_gt_lhood val[0..2]) in f32,
    gathered from _call_vals_table: the JAX package's bits on every
    device."""
    tab = torch.from_numpy(_call_vals_table()).to(qual.device)
    return tab[torch.clamp(qual.to(torch.int64), 0, _VALS_Q - 1)]


@functools.lru_cache(maxsize=1)
def _t12():
    """T[(obs*3 + k), g] = 1 iff expect2(obs, g) == k (f32 numpy)."""
    t = np.zeros((digt.N_BASE * 3, digt.SIZE), dtype=np.float32)
    for obs in range(digt.N_BASE):
        for g in range(digt.SIZE):
            t[obs * 3 + digt.EXPECT2[g, obs], g] = 1.0
    return t


def _masked_lhood(base_id, vals, mask, force_ref, ref_clamped):
    """lhood[l, g] with the calls in force_ref ([L, D] bool) scored
    against the genotype fixed to ref_clamped (strand-bias
    recomputation semantics, position_snp_call_pprob_digt.cpp:356-361).
    Free calls contribute val[expect2(g, obs)], forced calls
    val[expect2(ref, obs)], constant over g.

    In the JAX package's order on XLA's CPU backend (_masked_lhood's
    einsum "ldm,mg->lg"): the free calls' values [L, D, 12] (obs*3 + k)
    summed over D first (_sb_free_small, in XLA's windows of 32), then
    the 12-term product with T12 as four chains over m mod 4 ((a0 + a1)
    + (a2 + a3); every term is exact, T12 being 0 or 1), plus the forced
    calls' sum over D (xla_sum_minor). The JAX package pads the
    strand-bias tile's D to a multiple of 32 (call_snv_tile_chunked does
    the same), which decides these orders."""
    dev = base_id.device
    b = base_id.to(torch.int64)
    free = ((~force_ref) & mask).to(vals.dtype)
    w = torch.stack([(b == obs).to(vals.dtype) * vals[..., k] * free
                     for obs in range(digt.N_BASE) for k in range(3)],
                    dim=1)                                      # [L, 12, D]
    ws = _xla_windows(w, _sb_free_small)                        # [L, 12]
    t12 = torch.from_numpy(_t12()).to(dev)
    acc = [None] * 4
    for m in range(t12.shape[0]):
        term = ws[:, m:m + 1] * t12[m]
        acc[m % 4] = term if acc[m % 4] is None else acc[m % 4] + term
    lhood_f = (acc[0] + acc[1]) + (acc[2] + acc[3])
    exp2 = torch.as_tensor(digt.EXPECT2, dtype=torch.int64,
                           device=dev)                          # [10, 4]
    k_forced = exp2[ref_clamped[:, None], _bias_index(b)]       # [L, D]
    v_forced = torch.gather(vals, 2, k_forced[..., None])[..., 0]
    forced_sum = xla_sum_minor(v_forced * (force_ref & mask).to(vals.dtype))
    return lhood_f + forced_sum[:, None]


def _sb_free_small(x):
    """The strand-bias tile's sum of the free calls over D <= 32 calls:
    at 32, LLVM's 3 accumulators of 8 lanes and the last 8 calls one at
    a time; shorter sums (reached only by a caller that does not pad D)
    one at a time."""
    return _vector_sum(x, 8, 3, None) if x.shape[-1] == 32 else \
        _seq_terms(x)


def snv_strand_bias_tile(tile: SnvPileupTile, tgt, lt,
                         dep_delta=None, het_vf_extension: float = 0.0,
                         het_vf_increment: float = 0.0501):
    """Strand bias for a gathered subset of SNP rows (torch tensors):
    max(lhood_fwd[tgt], lhood_rev[tgt]) - lhood[tgt] per row
    (position_snp_call_pprob_digt.cpp:520-534).

    tgt: [L] genome max genotype per row; lt: [L] base lhood at tgt;
    dep_delta: optional [L, D] per-call dependent-eprob deltas, folded
    into the mismatch term. het_vf_extension > 0 (RNA mode): each
    strand's het lhood takes the het-VF extension terms too, the forced
    calls keyed against the reference genotype (:525-527).
    """
    vals = _call_vals(tile.qual)
    if dep_delta is not None:
        vals = torch.cat([vals[..., :1] + dep_delta[..., None],
                          vals[..., 1:]], dim=-1)
    ref_clamped = torch.clamp_max(tile.ref_gt.to(torch.int64),
                                  digt.N_BASE - 1)
    tgt = tgt.to(torch.int64)[:, None]

    def strand_lhood(force_ref):
        lh = _masked_lhood(tile.base_id, vals, tile.mask, force_ref,
                           ref_clamped)
        if het_vf_extension > 0:
            ext = _het_vf_extension_lhoods(
                tile.base_id, tile.qual, tile.mask, het_vf_extension,
                het_vf_increment, force_ref=force_ref,
                ref_clamped=ref_clamped, dep_delta=dep_delta)
            lh = _het_vf_combine(lh, ext)
        return torch.gather(lh, 1, tgt)
    return torch.maximum(strand_lhood(~tile.is_fwd),
                         strand_lhood(tile.is_fwd))[:, 0] - lt


# ---------------------------------------------------------------------------
# RNA mode: the het-VF extension (increment_het_ratio_lhood)
# ---------------------------------------------------------------------------

_LOW_REMAP = (0, 2, 1, 3)  # a het's low-ratio value for each bias key


def _f32(v: float):
    return torch.tensor(v, dtype=torch.float32)


# Cephes' log polynomial as XLA's CPU backend emits it
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)


# Cephes' exp polynomial, as XLA's CPU backend emits it
_EXP_P = tuple(_f32(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def _xla_exp_f32(x):
    """e^x for f32 tensors as XLA's CPU backend computes jnp.exp:
    n = floor(x log2 e + 1/2), x - n ln 2 in two parts, Cephes'
    polynomial, times 2^n, each mul+add pair that LLVM contracts run as
    a fused multiply-add (_fma_f32). Bit-identical to jnp.exp for x in
    [-87.3, 88.7] (tests/test_torch_rna.py); below, where XLA returns
    subnormals or 0, this returns values under 2^-125, which the
    logsumexp's sum (at least 1) absorbs either way."""
    dev = x.device
    c = {k: v.to(dev) for k, v in (("lo", _f32(-87.8)), ("hi", _f32(88.8)),
                                   ("log2e", _f32(1.44269504088896341)),
                                   ("half", _f32(0.5)),
                                   ("c1", _f32(-0.693359375)),
                                   ("c2", _f32(2.12194440e-4)),
                                   ("one", _f32(1.0)))}
    p = [v.to(dev) for v in _EXP_P]
    x = torch.clamp(x, c["lo"], c["hi"])
    n = torch.floor(_fma_f32(x, c["log2e"], c["half"]))
    n = torch.clamp(n, -127.0, 127.0)
    x = _fma_f32(c["c1"], n, x)
    x = _fma_f32(c["c2"], n, x)
    z = _fma_f32(x, p[0], p[1])
    for k in p[2:]:
        z = _fma_f32(z, x, k)
    z = _fma_f32(z, x * x, x)
    z = c["one"] + z
    # 2^n from its exponent bits, 0 for n = -127, as XLA builds it
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z * scale


def _xla_log_f32(x):
    """ln x for normal positive f32 tensors, as XLA's CPU backend
    computes jnp.log: Cephes' polynomial (the mantissa folded below
    sqrt(1/2), p0..p8 in three Horner chains, the exponent added back
    as q1*e + q2*e), each mul+add pair that LLVM contracts run as a
    fused multiply-add (_fma_f32). Bit-identical to jnp.log on these
    inputs (tests/test_torch_rna.py)."""
    dev = x.device
    one = _f32(1.0).to(dev)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + one
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    fold = t < _f32(0.707106781186547524).to(dev)
    zero = _f32(0.0).to(dev)
    tmp = torch.where(fold, t, zero)
    t = t - one
    e = e - torch.where(fold, one, zero)
    t = t + tmp
    x2 = t * t
    x3 = x2 * t
    p = [v.to(dev) for v in _LOG_P]
    q1, q2 = _LOG_Q1.to(dev), _LOG_Q2.to(dev)
    y = _fma_f32(t, p[0], p[1])
    y1 = _fma_f32(t, p[3], p[4])
    y2 = _fma_f32(t, p[6], p[7])
    y = _fma_f32(y, t, p[2])
    y1 = _fma_f32(y1, t, p[5])
    y2 = _fma_f32(y2, t, p[8])
    y = _fma_f32(y, x3, y1)
    y = _fma_f32(y, x3, y2)
    y = _fma_f32(y, x3, q1 * e)
    t = _fma_f32(_f32(-0.5).to(dev), x2, t)
    t = t + y
    return _fma_f32(q2, e, t)


@functools.lru_cache(maxsize=4)
def _het_vf_table(extension: float, increment: float):
    """The het-VF extension's per-call log-lhood values: f32 numpy
    [n_steps, 4, _VALS_Q] (v0..v3 of each het-ratio step r for each
    qscore) and the subgenotype count 1 + 2*n_steps
    (increment_het_ratio_lhood, position_snp_call_pprob_digt.cpp:262-385).

    The JAX package computes them per call in f32
    (strelka_tpu/models/snv_digt.py:392-415); they depend on the qscore
    alone, so the host builds them once in XLA's CPU arithmetic and the
    device gathers: e = 10^(q * -0.1) (XLA multiplies by the reciprocal
    of 10; the power itself is correctly rounded), floored at 1e-35;
    v0 = ln e + ln 1/3; v1 = ln(ce*r + (1-ce)/3*cr) with (1-ce)/3*cr
    computed as (1-ce) * f32(f32(1/3) * cr) (XLA folds the constants)
    and the sum fused; v2 the same with r and cr swapped; v3 = ln
    max(ce, 1e-35), the floor that keeps q=0 padding under forced-ref
    keys from ln(0) (:412-415)."""
    n_steps = 1 + int(extension / increment)
    ratio_inc = extension / n_steps
    f = np.float32
    q = np.arange(_VALS_Q, dtype=f)
    e = np.power(10.0, (q * f(-0.1)).astype(np.float64)).astype(f)
    e = np.maximum(e, f(1e-35))
    ce = f(1.0) - e
    omc = f(1.0) - ce

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=f))

    def mix(a, b):   # ce*a + (1-ce)/3*b, as XLA runs it
        return _fma_f32(t(ce), _f32(float(f(a))),
                        t(omc * (f(1.0 / 3.0) * f(b))))

    v0 = _xla_log_f32(t(e)) + _f32(LN_ONE_THIRD)
    v3 = _xla_log_f32(t(np.maximum(ce, f(1e-35))))
    steps = []
    for i in range(n_steps):
        r = 0.5 + (i + 1) * ratio_inc
        cr = 1.0 - r
        steps.append(torch.stack([v0, _xla_log_f32(mix(r, cr)),
                                  _xla_log_f32(mix(cr, r)), v3]))
    return torch.stack(steps).numpy(), 1 + 2 * n_steps


# XLA's CPU reductions of an f32 axis of n terms (the JAX package's
# jnp.sum in the RNA tile): past 32 terms its tree-reduction rewrite sums
# windows of 32, the axis padded to a multiple of 32 with half the
# padding before it, each window one term at a time, then reduces the
# window sums; up to 32 terms a reduction over the minor axis runs as
# LLVM vectorizes it, over another axis one term at a time.

def _seq_terms(x):
    """0 + x[..., 0] + x[..., 1] + ..., one add at a time."""
    x = x.movedim(-1, 0).contiguous()
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for term in x:
        acc = acc + term
    return acc


def _halves(a):
    """The lanes of a [..., 2^k] vector summed as LLVM reduces a vector:
    the upper half onto the lower, until one lane is left."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def _vector_sum(x, vf, uf, epi):
    """The loop-vectorized sum of x's last axis: uf accumulators of vf
    lanes take blocks of vf*uf terms, are added in order and reduced by
    halves; an epilogue of epi lanes (the running sum in its lane 0)
    takes what whole epi-blocks remain, then the rest one at a time."""
    n = x.shape[-1]
    w = vf * uf
    nv = n // w * w
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    if nv:
        parts = [x[..., u * vf:(u + 1) * vf] for u in range(uf)]
        for b in range(w, nv, w):
            parts = [p + x[..., b + u * vf:b + (u + 1) * vf]
                     for u, p in enumerate(parts)]
        a = parts[0]
        for p in parts[1:]:
            a = a + p
        s = _halves(a)
    r = nv
    if epi and n - r >= epi:
        ne = (n - r) // epi * epi
        a = torch.cat([(s + x[..., r])[..., None], x[..., r + 1:r + epi]],
                      dim=-1)
        for b in range(r + epi, r + ne, epi):
            a = a + x[..., b:b + epi]
        s = _halves(a)
        r += ne
    for d in range(r, n):
        s = s + x[..., d]
    return s


def _xla_windows(x, small):
    """The tree-reduction rewrite of a sum over x's last axis: `small`
    sums at most 32 terms; more go in windows of 32, each summed in
    order, and the window sums are reduced again by the same rule, with
    the last level's at most 32 window sums added one at a time in
    order (XLA's reduce of a reduce-window's output)."""
    n = x.shape[-1]
    if n <= 32:
        return small(x)
    nb = -(-n // 32)
    lo = (nb * 32 - n) // 2
    xp = torch.nn.functional.pad(x, (lo, nb * 32 - n - lo))
    blocks = _seq_terms(xp.reshape(*x.shape[:-1], nb, 32))
    return _xla_windows(blocks, _seq_terms)


def _xla_minor_small(x):
    """XLA's CPU sum over a minor axis of at most 32 terms (as LLVM's
    loop vectorizer lays it out for each length)."""
    n = x.shape[-1]
    if n < 16:
        return _seq_terms(x)
    if 20 <= n < 24:
        return _vector_sum(x, 4, 4, 4)
    return _vector_sum(x, 8, 4, 8)


def xla_sum_minor(x):
    """jnp.sum(x, axis=-1) of f32 x as XLA's CPU backend runs it in the
    JAX package's RNA tile: bit-identical to it up to 300 terms
    (tests/test_torch_rna.py) and at 512, 1024 and 2048
    (tests/test_torch_rna_deep.py). Past 32 terms the window sums are
    added in order; LLVM's vectorized order holds only for a sum of at
    most 32 terms straight from the tile (16-32 window sums, 481-1024
    terms, are not vectorized)."""
    return _xla_windows(x, _xla_minor_small)


def xla_sum_major(x):
    """The same for a reduced axis that is not the minor one (moved
    last here): XLA sums its terms one at a time within each window."""
    return _xla_windows(x, _seq_terms)


def _bias_index(b):
    """A base id as the JAX package's gather takes it: negative ids
    wrap once (-1 is 3), then every id is clamped to 0..3."""
    return torch.clamp(torch.where(b < 0, b + digt.N_BASE, b), 0,
                       digt.N_BASE - 1)


def _het_vf_extension_lhoods(base_id, qual, mask, extension: float,
                             increment: float, force_ref=None,
                             ref_clamped=None, dep_delta=None):
    """Het-ratio extension terms for RNA mode: [2*n_steps, L, 6] f32,
    for each het-ratio step the biased-het log-lhoods lhood_high and
    lhood_low of the 6 het genotypes (digt's 4..9), to be logsumexp'd
    with their base lhood (_het_vf_combine; increment_het_ratio_lhood,
    position_snp_call_pprob_digt.cpp:262-385). The JAX package computes
    the hom genotypes' columns too and discards them.

    Each call contributes the value of its bias key (EXPECT2_BIAS of
    the genotype and its base; forced calls key against the reference
    genotype, :305-311) from _het_vf_table, the low-ratio term through
    the key remap 0,2,1,3; dep_delta ([L, D]) adds to the mismatch
    value v0 (:297). The per-genotype sums over D follow XLA's CPU order
    (xla_sum_minor), as elementwise torch ops: the JAX package's bits on
    the CPU and on the card alike.
    """
    tab, _ = _het_vf_table(float(extension), float(increment))
    dev = base_id.device
    vals = torch.from_numpy(tab).to(dev)                     # [S, 4, Q]
    q = torch.clamp(qual.to(torch.int64), 0, _VALS_Q - 1)
    bi = _bias_index(base_id.to(torch.int64))
    bias = torch.as_tensor(digt.EXPECT2_BIAS, dtype=torch.int64,
                           device=dev)                       # [10, 4]
    key = bias[digt.N_BASE:, bi]                             # [6, L, D]
    if force_ref is not None:
        key = torch.where(force_ref[None],
                          bias[ref_clamped[:, None], bi][None],
                          key)
    low = torch.as_tensor(_LOW_REMAP, dtype=torch.int64, device=dev)[key]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    terms = []
    for i in range(vals.shape[0]):
        v = vals[i][:, q]                                    # [4, L, D]
        if dep_delta is not None:
            v = torch.cat([(v[0] + dep_delta)[None], v[1:]])
        for k in (key, low):
            x = torch.where(mask[None], torch.gather(v, 0, k), zero)
            terms.append(xla_sum_minor(x).t())
    return torch.stack(terms)


def _het_vf_combine(lhood, ext):
    """lhood [L, 10] with its het genotypes (4..9) replaced by
    logsumexp([lhood, ext...]) - ln(1 + 2*n_steps) over ext's [S-1, L, 6]
    het terms, the others kept: the
    JAX package's jax.scipy.special.logsumexp in f32, with XLA's CPU exp
    and log (_xla_exp_f32, _xla_log_f32) and its terms summed in order,
    so that the CPU and the card give XLA's bits for the same terms."""
    x = torch.cat([lhood[None, :, digt.N_BASE:], ext])       # [S, L, 6]
    mx = torch.amax(x, dim=0)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    p = _xla_exp_f32(x - mx)
    tot = p[0]
    for s in range(1, p.shape[0]):
        tot = tot + p[s]
    lse = _xla_log_f32(tot) + mx
    het = lse - _xla_log_f32(_f32(float(ext.shape[0] + 1))).to(lse.device)
    return torch.cat([lhood[:, :digt.N_BASE], het], dim=1)


def _xla_hist_lhood(hist, qtab, cols):
    """hist [L, K] @ qtab [K, 10] in XLA's CPU dot order (the JAX
    package's RNA tile, _masked_lhood_hist): four f32 FMA chains over the
    slots k mod 4, combined as (a0 + a1) + (a2 + a3)
    (somatic_snv._grid_dot)."""
    from .somatic_snv import _grid_dot
    return _grid_dot(hist[None], qtab[None], cols)[0]


def _dep_smis(base_id, mask, dep_delta):
    """[L, 4] f32 sums of the per-call deltas of each base's used calls
    (the JAX package's sum over D of [L, D, 4], in XLA's order:
    xla_sum_major)."""
    base = torch.arange(digt.N_BASE, device=base_id.device)
    on = (base_id.to(torch.int64)[:, None, :] == base[:, None]) & mask[:, None]
    return xla_sum_major(torch.where(on, dep_delta[:, None, :], 0.0))


def _xla_add_smis(lhood, s_mis, e0):
    """lhood + s_mis @ e0 with XLA's CPU dot order over the 4 bases:
    (s0*e0[0] + s1*e0[1]) + (s2*e0[2] + s3*e0[3])."""
    t = [s_mis[:, b:b + 1] * e0[b] for b in range(digt.N_BASE)]
    return lhood + ((t[0] + t[1]) + (t[2] + t[3]))


def _np_snv_hist(base, qual, mask, out):
    """numpy fallback for native snv_hist: identical integer counts
    (out int8 [L, Q*4], zeroed; guarded by D <= 127 so cells cannot
    overflow)."""
    b = base.astype(np.int32)
    q = np.clip(qual.astype(np.int32), 0, _SNV_QTAB_SIZE - 1)
    valid = mask & (b >= 0) & (b < digt.N_BASE)
    rows, cols = np.nonzero(valid)
    np.add.at(out, (rows, q[rows, cols] * digt.N_BASE + b[rows, cols]),
              np.int8(1))



# chunk shapes: rows are independent, so the chunk height never changes
# results; it bounds the device working set
SNV_TILE_L = 32768
SNV_TILE_D_PAD = 32
# strand-bias subset tile (SNP rows per launch)
SNV_SB_TILE = 512

# tile launches by the torch tile functions: {(kind, device type,
# rows, depth): count}, kind "tile" (genotype pass) or "sb" (strand
# bias). Always on; a caller resets it with LAUNCH_STATS.clear().
LAUNCH_STATS: dict = {}


def _tally(kind, dev, Lt, Dt):
    k = (kind, dev.type, int(Lt), int(Dt))
    LAUNCH_STATS[k] = LAUNCH_STATS.get(k, 0) + 1


# fields the gVCF pipeline consumes from a genotype pass
_PULL = ("genome_max_gt", "poly_max_gt", "snv_qphred",
         "genome_max_gt_qphred", "poly_max_gt_qphred",
         "phred_loghood", "ln_ref_pprob", "lhood")


def _call_snv_tile_native(base, qual, mask, ref_gt, theta, haploid,
                          s_delta):
    """Native whole-region SNV call (histogram + posterior tail) —
    see native/snvcall.cpp for the canonical accumulation-order
    definition. Returns an SnvCallResult of host arrays (strand_bias
    zeros; the SNP-subset SB pass runs afterward as usual) or None
    when the native library is unavailable."""
    from ..io.native import snv_call_native, snv_hist_native
    L, D = base.shape
    hist = np.zeros((L, _SNV_QTAB_SIZE * digt.N_BASE), np.int8)
    if not snv_hist_native(base, qual, mask, _SNV_QTAB_SIZE, hist):
        _np_snv_hist(base, qual, mask, hist)
    pr = make_ln_priors(theta)
    res = snv_call_native(
        hist, ref_gt, s_delta, haploid, _snv_qtab(),
        np.asarray(_e0_tab()), pr["genome"], pr["poly"],
        pr["genome_haploid"], pr["poly_haploid"])
    if res is None:
        return None
    lhood, g_max, p_max, snv_q, g_qmax, p_qmax, pl, ln_ref = res
    return SnvCallResult(
        lhood=lhood, genome_pprob=None, poly_pprob=None,
        genome_max_gt=g_max, poly_max_gt=p_max,
        snv_qphred=snv_q, genome_max_gt_qphred=g_qmax,
        poly_max_gt_qphred=p_qmax, phred_loghood=pl,
        strand_bias=np.zeros(L, np.float64), ln_ref_pprob=ln_ref)


def call_snv_tile_chunked(tile: SnvPileupTile, theta: float = 0.001,
                          is_haploid=None,
                          het_vf_extension: float = 0.0,
                          het_vf_increment: float = 0.0501,
                          dep=None, device=None) -> SnvCallResult:
    """SNV genotyping of a whole [L, D] pileup tile, in row chunks.

    Inputs are numpy [L, D] arrays of any extent; the result is a
    SnvCallResult of host numpy arrays (lhood f32 [L,10], int32 genotype
    and phred fields, int32 PLs, f64 ln_ref_pprob and strand_bias).

    device: where the tiles run (default: the current device of
    strelka_tpu_torch.device). On the CPU with D <= 127 the native
    histogram + posterior tail (native/snvcall.cpp) runs, as in the JAX
    package; on CUDA the torch tile functions run on the card, in the
    same canonical order. het_vf_extension > 0 (RNA mode) skips the
    native path on the CPU too, as the JAX package does: the torch tiles
    add the het-VF extension (call_snv_tile) on either device. With an
    engine mesh (parallel/mesh.py, --mesh) the torch tiles run on the
    CPU as well, each chunk's rows split over the mesh's devices; rows
    are independent, so the results are the unsharded ones.

    dep: optional (s_delta [L, 4] f32, plane_fn(rows) -> [n, D] f32)
    dependent-eprob deltas from dependent_eprob_deltas; None disables
    the adjustment.
    """
    from .. import device as devmod
    dev = devmod.current() if device is None else devmod.resolve(device)
    base = np.asarray(tile.base_id)
    L, D = base.shape
    qual = np.asarray(tile.qual)
    fwd = np.asarray(tile.is_fwd)
    mask = np.asarray(tile.mask)
    ref_gt = np.asarray(tile.ref_gt)
    hap = None if is_haploid is None else np.asarray(is_haploid, bool)
    s_delta = dep[0] if dep is not None else None
    plane_fn = dep[1] if dep is not None else None

    from ..parallel import mesh as pmesh
    rna = (het_vf_extension, het_vf_increment, plane_fn)
    out = None
    if het_vf_extension > 0:
        out = _genotype_chunks(dev, base, qual, mask, ref_gt, hap, None,
                               theta, rna)
    elif dev.type == "cpu" and D <= 127 and pmesh.engine_mesh() is None:
        # with an engine mesh (--mesh) the torch tiles run sharded on
        # the CPU too, as the JAX package runs its XLA tiles there
        out = _call_snv_tile_native(base, qual, mask, ref_gt, theta,
                                    hap, s_delta)
    if out is None:
        out = _genotype_chunks(dev, base, qual, mask, ref_gt, hap,
                               s_delta, theta)

    # strand bias on the SNP subset only (is_snp gate, reference :524)
    snp_rows = np.nonzero(np.asarray(out.snv_qphred) != 0)[0]
    sb = np.zeros(L, dtype=np.float64)
    if len(snp_rows):
        lt = np.take_along_axis(
            np.asarray(out.lhood)[snp_rows],
            np.asarray(out.genome_max_gt)[snp_rows][:, None].astype(
                np.int64), axis=-1)[:, 0]
        # the JAX package pads the strand-bias tile's D to a multiple of
        # 32 with masked calls, which decides XLA's order of its sums
        Dsb = -(-D // SNV_TILE_D_PAD) * SNV_TILE_D_PAD
        gmax = np.asarray(out.genome_max_gt)
        shards = pmesh.chunk_sharder(dev)
        for c0 in range(0, len(snp_rows), SNV_SB_TILE):
            launched = []
            for sdev, t0, t1 in shards(c0, min(c0 + SNV_SB_TILE,
                                                len(snp_rows))):
                rows = snp_rows[t0:t1]

                def put(a, fill=0, rows=rows, sdev=sdev):
                    # a fresh host array: the copy to the device cannot
                    # race a later rewrite
                    if a.ndim == 2:
                        o = np.full((len(rows), Dsb), fill, dtype=a.dtype)
                        o[:, :D] = a
                        a = o
                    return torch.from_numpy(np.ascontiguousarray(a)).to(sdev)
                sub = SnvPileupTile(
                    base_id=put(base[rows]), qual=put(qual[rows]),
                    is_fwd=put(fwd[rows], False),
                    mask=put(mask[rows], False), ref_gt=put(ref_gt[rows]))
                dd = None
                if plane_fn is not None:
                    dd = put(np.asarray(plane_fn(rows), np.float32))
                _tally("sb", sdev, len(rows), Dsb)
                launched.append((rows, snv_strand_bias_tile(
                    sub, put(gmax[rows]), put(lt[t0:t1]), dd,
                    het_vf_extension, het_vf_increment)))
            for rows, vals in launched:
                sb[rows] = vals.cpu().numpy()
    return out._replace(strand_bias=sb)


def _rna_tile(rna, put, base, qual, mask, rg, h, theta, t0, t1, pad_d):
    """call_snv_tile with the het-VF extension on rows t0:t1, with the
    rows' per-call dependent-eprob deltas. The JAX package runs a
    region of up to SNV_TILE_L rows at its own D and a longer one in
    chunks whose D it pads to a multiple of 32 with masked calls
    (`pad_d`); the D of a tile decides XLA's order of its sums, so the
    port pads as it does. The chunk's height changes nothing."""
    ext, inc, plane_fn = rna
    D = base.shape[1]
    Dt = -(-D // SNV_TILE_D_PAD) * SNV_TILE_D_PAD if pad_d else D

    def cols(a, fill=0):     # a: the chunk's rows
        o = np.full((t1 - t0, Dt), fill, dtype=a.dtype)
        o[:, :D] = a
        return put(o)
    dd = None
    if plane_fn is not None:
        dd = cols(np.asarray(plane_fn(np.arange(t0, t1)), np.float32))
    sub = SnvPileupTile(base_id=cols(base[t0:t1]), qual=cols(qual[t0:t1]),
                        is_fwd=None, mask=cols(mask[t0:t1], False), ref_gt=rg)
    return call_snv_tile(sub, theta, h, het_vf_extension=ext,
                         het_vf_increment=inc, dep_delta=dd)


def _genotype_rows(dev, put, base, qual, mask, ref_gt, hap, s_delta, theta,
                   rna, hist_ok, t0, t1, pad_d):
    """The genotype pass of rows t0:t1 on `dev` (`put` copies a host
    array there); _genotype_chunks' body for one chunk or shard."""
    rg = put(ref_gt[t0:t1].astype(np.int32))
    h = None
    if hap is not None:
        h = put(hap[t0:t1])
    sm = None
    if s_delta is not None:
        sm = put(np.asarray(s_delta[t0:t1], np.float32))
    _tally("tile", dev, t1 - t0, base.shape[1])
    if hist_ok:
        hist = np.zeros((t1 - t0, _SNV_QTAB_SIZE * digt.N_BASE), np.int8)
        from ..io.native import snv_hist_native
        if not snv_hist_native(np.ascontiguousarray(base[t0:t1]),
                               np.ascontiguousarray(qual[t0:t1]),
                               np.ascontiguousarray(mask[t0:t1]),
                               _SNV_QTAB_SIZE, hist):
            hist[:] = 0
            _np_snv_hist(base[t0:t1], qual[t0:t1], mask[t0:t1], hist)
        cols = np.nonzero(hist.any(axis=0))[0].tolist()
        return call_snv_hist_tile(put(hist), rg, h, theta, s_mis=sm,
                                  cols=cols)
    if rna is not None:
        return _rna_tile(rna, put, base, qual, mask, rg, h, theta, t0, t1,
                         pad_d)
    sub = SnvPileupTile(
        base_id=put(base[t0:t1]), qual=put(qual[t0:t1]),
        is_fwd=None, mask=put(mask[t0:t1]), ref_gt=rg)
    return call_snv_tile(sub, theta, h, dep_smis=sm)


def _genotype_chunks(dev, base, qual, mask, ref_gt, hap, s_delta, theta,
                     rna=None):
    """Genotype pass of the torch tile functions over row chunks.

    D <= 127: the (qscore, base) histogram is counted on the host
    (native/snvhist.cpp, int8 cells cannot overflow) and only the
    histogram goes to the device (call_snv_hist_tile); deeper tiles go
    up whole and are counted there (call_snv_tile). rna =
    (het_vf_extension, het_vf_increment, plane_fn): the tiles go up
    whole with the chunk's per-call dependent-eprob deltas (plane_fn,
    or None) and call_snv_tile adds the het-VF extension.
    """
    from ..parallel import mesh as pmesh
    L, D = base.shape
    TL = SNV_TILE_L * 4 if dev.type == "cuda" else SNV_TILE_L
    hist_ok = D <= 127 and rna is None
    outs: dict[str, list] = {f: [] for f in _PULL}
    # with an engine mesh (--mesh) each chunk's rows are split over the
    # mesh's devices (chunk_sharder): every shard runs on its own device
    # and its rows come back in order after all shards have launched
    shards = pmesh.chunk_sharder(dev)
    for c0 in range(0, max(L, 1), TL):  # one empty chunk when L == 0
        launched = []
        for sdev, t0, t1 in shards(c0, min(c0 + TL, L)):
            def put(a, sdev=sdev):
                # blocking copy of a fresh host array: no staging buffer
                # is reused while a launch may still read it
                return torch.from_numpy(np.ascontiguousarray(a)).to(sdev)
            launched.append(_genotype_rows(
                sdev, put, base, qual, mask, ref_gt, hap, s_delta, theta,
                rna, hist_ok, t0, t1, L > SNV_TILE_L))
        for res in launched:
            for f in _PULL:
                outs[f].append(getattr(res, f).cpu().numpy())
    cat = {f: np.concatenate(v) for f, v in outs.items()}
    return SnvCallResult(genome_pprob=None, poly_pprob=None,
                         strand_bias=None, **cat)
