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
CUDA run gives the CPU path's bits for the lhood.
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
                  is_haploid=None, dep_smis=None) -> SnvCallResult:
    """Batched equivalent of position_snp_call_pprob_digt over a tile
    of torch tensors (any depth D; the counts are int32).

    is_haploid: optional [L] bool selecting haploid priors per locus
    (ploidy regions, ploidy_util.hh). dep_smis: optional [L, 4]
    dependent-eprob mismatch-term sums. Strand bias is left at zero
    (the reference computes it only at is_snp() rows;
    call_snv_tile_chunked runs snv_strand_bias_tile on that subset). The RNA het-VF
    extension is not ported.
    """
    hist = _tile_hist(tile.base_id, tile.qual, tile.mask)
    cols = torch.nonzero(hist.any(dim=0))[:, 0].tolist()
    return call_snv_hist_tile(hist, tile.ref_gt, is_haploid, theta,
                              s_mis=dep_smis, cols=cols)


def _call_vals(qual, eprob_floor: float = 1e-35):
    """Per-call val[·,·,3] table (get_diploid_gt_lhood val[0..2]).

    float32 to match the reference's blt_float_t accumulation.
    """
    e = torch.pow(10.0, _div(-qual.to(torch.float32), 10.0))
    ce = 1.0 - e
    v0 = torch.log(torch.clamp_min(e, eprob_floor)) + LN_ONE_THIRD
    v1 = torch.log(ce + _div(1.0 - ce, 3.0)) + LN_ONE_HALF
    v2 = torch.log(torch.clamp_min(ce, eprob_floor))
    return torch.stack([v0, v1, v2], dim=-1)


def _masked_lhood(base_id, vals, mask, force_ref, ref_clamped):
    """lhood[l, g] with the calls in force_ref ([L, D] bool) scored
    against the genotype fixed to ref_clamped (strand-bias
    recomputation semantics, position_snp_call_pprob_digt.cpp:356-361).
    Free calls contribute val[expect2(g, obs)], forced calls
    val[expect2(ref, obs)], constant over g."""
    dev = base_id.device
    exp2 = torch.as_tensor(digt.EXPECT2, dtype=torch.int64,
                           device=dev)                          # [10, 4]
    b = base_id.to(torch.int64)
    valid = (b >= 0) & (b < digt.N_BASE)
    bc = torch.clamp(b, 0, digt.N_BASE - 1)
    use_free = (~force_ref) & mask & valid
    k_free = exp2[:, bc]                                        # [10, L, D]
    v_free = torch.gather(vals[None].expand(digt.SIZE, -1, -1, -1), 3,
                          k_free[..., None])[..., 0]            # [10, L, D]
    lhood_f = torch.where(use_free[None], v_free, 0.0).sum(dim=-1).t()
    k_forced = exp2[ref_clamped[:, None], bc]                   # [L, D]
    v_forced = torch.gather(vals, 2, k_forced[..., None])[..., 0]
    use_forced = force_ref & mask
    forced_sum = torch.where(use_forced, v_forced, 0.0).sum(dim=1)
    return lhood_f + forced_sum[:, None]


def snv_strand_bias_tile(tile: SnvPileupTile, tgt, lt,
                         dep_delta=None):
    """Strand bias for a gathered subset of SNP rows (torch tensors):
    max(lhood_fwd[tgt], lhood_rev[tgt]) - lhood[tgt] per row
    (position_snp_call_pprob_digt.cpp:520-534).

    tgt: [L] genome max genotype per row; lt: [L] base lhood at tgt;
    dep_delta: optional [L, D] per-call dependent-eprob deltas, folded
    into the mismatch term.
    """
    vals = _call_vals(tile.qual)
    if dep_delta is not None:
        vals = torch.cat([vals[..., :1] + dep_delta[..., None],
                          vals[..., 1:]], dim=-1)
    ref_clamped = torch.clamp_max(tile.ref_gt.to(torch.int64),
                                  digt.N_BASE - 1)
    tgt = tgt.to(torch.int64)[:, None]
    lf = torch.gather(_masked_lhood(tile.base_id, vals, tile.mask,
                                    ~tile.is_fwd, ref_clamped), 1, tgt)
    lr = torch.gather(_masked_lhood(tile.base_id, vals, tile.mask,
                                    tile.is_fwd, ref_clamped), 1, tgt)
    return torch.maximum(lf, lr)[:, 0] - lt


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
    same canonical order.

    dep: optional (s_delta [L, 4] f32, plane_fn(rows) -> [n, D] f32)
    dependent-eprob deltas from dependent_eprob_deltas; None disables
    the adjustment.
    """
    if het_vf_extension > 0:
        from .. import NotPortedError
        raise NotPortedError("the RNA het-VF extension "
                             "(het_vf_extension > 0)")
    del het_vf_increment
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

    out = None
    if dev.type == "cpu" and D <= 127:
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
        for t0 in range(0, len(snp_rows), SNV_SB_TILE):
            rows = snp_rows[t0:t0 + SNV_SB_TILE]

            def put(a):
                # fancy indexing makes a fresh host array: the copy to
                # the device cannot race a later rewrite
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            sub = SnvPileupTile(
                base_id=put(base[rows]), qual=put(qual[rows]),
                is_fwd=put(fwd[rows]), mask=put(mask[rows]),
                ref_gt=put(ref_gt[rows]))
            dd = None
            if plane_fn is not None:
                dd = put(np.asarray(plane_fn(rows), np.float32))
            _tally("sb", dev, len(rows), D)
            vals = snv_strand_bias_tile(
                sub, put(np.asarray(out.genome_max_gt)[rows]),
                put(lt[t0:t0 + len(rows)]), dd)
            sb[rows] = vals.cpu().numpy()
    return out._replace(strand_bias=sb)


def _genotype_chunks(dev, base, qual, mask, ref_gt, hap, s_delta, theta):
    """Genotype pass of the torch tile functions over row chunks.

    D <= 127: the (qscore, base) histogram is counted on the host
    (native/snvhist.cpp, int8 cells cannot overflow) and only the
    histogram goes to the device (call_snv_hist_tile); deeper tiles go
    up whole and are counted there (call_snv_tile).
    """
    L, D = base.shape
    TL = SNV_TILE_L * 4 if dev.type == "cuda" else SNV_TILE_L
    hist_ok = D <= 127
    outs: dict[str, list] = {f: [] for f in _PULL}
    for t0 in range(0, max(L, 1), TL):  # one empty chunk when L == 0
        t1 = min(t0 + TL, L)

        def put(a):
            # blocking copy of a fresh host array: no staging buffer
            # is reused while a launch may still read it
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        rg = put(ref_gt[t0:t1].astype(np.int32))
        h = None
        if hap is not None:
            h = put(hap[t0:t1])
        sm = None
        if s_delta is not None:
            sm = put(np.asarray(s_delta[t0:t1], np.float32))
        _tally("tile", dev, t1 - t0, D)
        if hist_ok:
            hist = np.zeros((t1 - t0, _SNV_QTAB_SIZE * digt.N_BASE),
                            np.int8)
            from ..io.native import snv_hist_native
            if not snv_hist_native(np.ascontiguousarray(base[t0:t1]),
                                   np.ascontiguousarray(qual[t0:t1]),
                                   np.ascontiguousarray(mask[t0:t1]),
                                   _SNV_QTAB_SIZE, hist):
                hist[:] = 0
                _np_snv_hist(base[t0:t1], qual[t0:t1], mask[t0:t1], hist)
            cols = np.nonzero(hist.any(axis=0))[0].tolist()
            res = call_snv_hist_tile(put(hist), rg, h, theta, s_mis=sm,
                                     cols=cols)
        else:
            sub = SnvPileupTile(
                base_id=put(base[t0:t1]), qual=put(qual[t0:t1]),
                is_fwd=None, mask=put(mask[t0:t1]), ref_gt=rg)
            res = call_snv_tile(sub, theta, h, dep_smis=sm)
        for f in _PULL:
            outs[f].append(getattr(res, f).cpu().numpy())
    cat = {f: np.concatenate(v) for f, v in outs.items()}
    return SnvCallResult(genome_pprob=None, poly_pprob=None,
                         strand_bias=None, **cat)
