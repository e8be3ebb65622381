"""Indel (allele-group) genotype likelihoods and priors.

Reference: starling_common/AlleleGroupGenotype.cpp
(updateGenotypeLogLhoodFromAlleleLogLhood :35-115,
getVariantAlleleGroupGenotypeLhoodsForSample :184-260,
GenotypePriorSet/ContextGenotypePriors theta tables :262-343 +
AlleleGroupGenotype.hh:46-128), starling_indel_call_pprob_digt.cpp
get_het_observed_allele_ratio :40-70, and
readMappingAdjustmentUtil.hh integrateOutMappingStatus.

Vectorized: per locus, the reads x alleles log-likelihood matrix from
the scoring op is reduced to genotype log-likelihoods with one masked
logsumexp — no per-read loops.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

LOG_HALF = float(np.log(0.5))
CORRECT_MAPPING_LOG_PRIOR = float(np.log(1.7e-10))  # starling_base_shared.cpp:64
LN_RANDOM_BASE_MATCH = float(np.log(0.25))          # randomBaseMatchProb


# --- genotype enumeration (VcfGenotypeUtil) -------------------------------
def genotype_count(ploidy: int, n_alleles: int) -> int:
    if ploidy == 1:
        return n_alleles
    return n_alleles * (n_alleles + 1) // 2


def genotype_alleles(ploidy: int, n_alleles: int) -> np.ndarray:
    """[G, 2] allele index pairs ((a, a) for haploid) in triangular
    index order: index(a0<=a1) = a1(a1+1)/2 + a0."""
    if ploidy == 1:
        return np.stack([np.arange(n_alleles)] * 2, axis=1)
    out = []
    for a1 in range(n_alleles):
        for a0 in range(a1 + 1):
            out.append((a0, a1))
    return np.array(out, dtype=np.int32)


# --- theta tables (GenotypePriorSet::initializeThetas) --------------------
HPOL_THETA = np.array([
    0.000120268, 5.97777e-05, 0.000124648, 0.000260759, 0.000589544,
    0.002394583, 0.007417864, 0.022660355, 0.04670561, 0.082031233,
    0.124548518, 0.149765438, 0.168051826, 0.187346626, 0.207339703,
    0.225843098, 0.248849306, 0.27106361, 0.334718891, 0.348811678,
])
DINUC_THETA = np.array([
    0.000120268, 8.73757e-05, 0.000479319, 0.002678401, 0.012194565,
    0.03162284, 0.060846617, 0.108263861, 0.163510548, 0.204456064,
    0.23462438, 0.267919304, 0.290588942, 0.355588567, 0.369478351,
    0.378290471, 0.38555006, 0.393439865, 0.395844077, 0.4,
])
THETA_TABLES = {1: HPOL_THETA, 2: DINUC_THETA}
# the tables above equal src/config/indelErrorModel/models/theta.json
# (verified by tests); load_theta_json supports user-supplied tables


def load_theta_json(path: str) -> dict[int, np.ndarray]:
    """GenotypePriorSet theta tables from JSON (--theta-file;
    calibration/ThetaJson)."""
    import json

    with open(path) as f:
        doc = json.load(f)
    out = {}
    for entry in doc["thetas"]:
        out[int(entry["repeatPatternSize"])] = np.asarray(entry["theta"],
                                                          dtype=np.float64)
    return out


def set_theta_tables(tables: dict[int, np.ndarray]) -> None:
    """Install custom theta tables (clears the priors cache)."""
    THETA_TABLES.update(tables)
    make_context_priors.cache_clear()


class ContextGenotypePriors(NamedTuple):
    """log priors in AG_GENOTYPE order:
    [HOMREF, HOM0, HET0, HOM1, HET1, HET01]
    (AlleleGroupGenotype.hh ContextGenotypePriors::initialize)."""
    diploid: np.ndarray
    diploid_poly: np.ndarray
    haploid: np.ndarray
    haploid_poly: np.ndarray


@functools.lru_cache(maxsize=None)
def make_context_priors(theta: float) -> ContextGenotypePriors:
    log0 = -np.inf
    skip = theta  # allele0SkipPenalty
    with np.errstate(divide="ignore"):
        diploid = np.log(np.array([
            1.0 - theta * 3.0 / 2.0, theta / 2.0, theta,
            theta * skip / 2.0, theta * skip, theta * theta,
        ]))
        diploid_poly = np.log(np.array([
            0.25, 0.25, 0.5, 0.25 * skip, 0.5 * skip, 0.5 * theta,
        ]))
        haploid = np.array([
            np.log(1.0 - theta), np.log(theta), log0,
            np.log(theta * skip), log0, log0,
        ])
        haploid_poly = np.array([
            np.log(0.5), np.log(0.5), log0,
            np.log(0.5 * skip), log0, log0,
        ])
    return ContextGenotypePriors(diploid, diploid_poly, haploid, haploid_poly)


def get_theta(pattern_size: int, repeat_count: int) -> float:
    """Theta by STR context with repeat count clamped to table size."""
    table = THETA_TABLES[1] if pattern_size <= 1 else THETA_TABLES[2]
    idx = int(np.clip(repeat_count, 1, len(table))) - 1
    return float(table[idx])


def context_priors_for(pattern_size: int, repeat_count: int) -> ContextGenotypePriors:
    return make_context_priors(get_theta(pattern_size, repeat_count))


@functools.lru_cache(maxsize=4096)
def context_tri_priors(pattern_size: int, repeat_count: int,
                       n_alleles: int, ploidy: int, top: int):
    """(tri_genome, tri_poly) ln-prior vectors for one STR context +
    genotype shape — the full per-locus prior construction cached by
    its five integer keys (context_priors_for +
    ag_genotype_priors_to_triangular x2 allocate ~6 small arrays per
    sample-locus otherwise). numpy outputs only (lru-cached jnp arrays
    leak tracers if first built inside a jit trace)."""
    priors = context_priors_for(pattern_size, repeat_count)
    g6 = priors.diploid if ploidy == 2 else priors.haploid
    p6 = priors.diploid_poly if ploidy == 2 else priors.haploid_poly
    return (ag_genotype_priors_to_triangular(g6, n_alleles, ploidy, top),
            ag_genotype_priors_to_triangular(p6, n_alleles, ploidy, top))


def ag_genotype_priors_to_triangular(priors6: np.ndarray, n_alleles: int,
                                     ploidy: int,
                                     top: int = 0) -> np.ndarray:
    """Map [HOMREF,HOM0,HET0,HOM1,HET1,HET01] onto triangular genotype
    indices for n_alleles in {1,2,3} (ref + up to 2 alts).

    `top` is the sample's top-ranked ALT index (0-based among alts):
    the HOM0/HET0 priors attach to the top allele and HOM1/HET1 to the
    other (getPriorIndex, starling_pos_processor.cpp:1250-1320, keyed
    off topAlleleIndexInSample)."""
    ga = genotype_alleles(ploidy, n_alleles)
    top_allele = top + 1
    out = np.zeros(len(ga))
    for g, (a0, a1) in enumerate(ga):
        if a0 == 0 and a1 == 0:
            out[g] = priors6[0]                      # HOMREF
        elif a0 == a1:
            out[g] = priors6[1 if a0 == top_allele else 3]  # HOM0/HOM1
        elif a0 == 0:
            out[g] = priors6[2 if a1 == top_allele else 4]  # HET0/HET1
        else:  # het-alt
            out[g] = priors6[5]                      # HET01
    return out


# --- het observed-allele-ratio correction ---------------------------------
def het_allele_ratio_log_priors(read_len, min_overlap: int,
                                insert_len: int, delete_len: int,
                                het_ratio: float = 0.5):
    """(log_ref_prob, log_indel_prob) per read
    (starling_indel_call_pprob_digt.cpp:40-70)."""
    read_len = np.asarray(read_len, dtype=np.float64)
    base_expect = np.maximum(read_len + 1 - 2 * min_overlap, 0.0)
    ref_expect = base_expect + np.minimum(delete_len, base_expect)
    indel_expect = base_expect + np.minimum(insert_len, base_expect)
    ref_term = (1 - het_ratio) * ref_expect
    indel_term = het_ratio * indel_expect
    total = ref_term + indel_term
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(total > 0, indel_term / np.maximum(total, 1e-300), het_ratio)
        return np.log1p(-p), np.log(p)


class AlleleInfo(NamedTuple):
    """Static per-allele data for a locus (alt alleles only)."""
    insert_len: np.ndarray  # [A-1]
    delete_len: np.ndarray  # [A-1]


def integrate_out_mapping(raw_lnp, n_nonambig):
    """logsum(raw + correctMappingLogPrior, n·ln 0.25)
    (readMappingAdjustmentUtil.hh)."""
    a = raw_lnp + CORRECT_MAPPING_LOG_PRIOR
    b = n_nonambig * LN_RANDOM_BASE_MATCH
    hi = np.maximum(a, b)
    lo = np.minimum(a, b)
    return hi + np.log1p(np.exp(lo - hi))


def genotype_log_lhoods(
    allele_lhoods: np.ndarray,   # [R, A] per-read log lhood, col 0 = ref
    read_mask: np.ndarray,       # [R] bool: read participates
    read_len: np.ndarray,        # [R]
    n_nonambig: np.ndarray,      # [R]
    allele_info: AlleleInfo,      # alt allele indel shapes
    ploidy: int,
    min_read_bp_flank: int,
) -> np.ndarray:
    """[G] genotype log likelihoods, triangular genotype order.

    Exact vectorization of updateGenotypeLogLhoodFromAlleleLogLhood
    summed over supporting reads.
    """
    # pure numpy: per-locus shapes vary (R reads x G genotypes) and the
    # arrays are tiny — eager jnp here triggered one XLA compile per
    # distinct shape at WGS scale
    allele_lhoods = np.asarray(allele_lhoods, dtype=np.float64)
    R, A = allele_lhoods.shape
    ga = genotype_alleles(ploidy, A)  # [G, 2]
    G = len(ga)

    # per-read per-alt-allele het log priors vs ref  [R, A-1] each
    log_ref_p = np.zeros((R, A - 1))
    log_alt_p = np.zeros((R, A - 1))
    rl = np.asarray(read_len)
    for j in range(A - 1):
        lr, la = het_allele_ratio_log_priors(
            rl, min_read_bp_flank,
            int(allele_info.insert_len[j]), int(allele_info.delete_len[j]))
        log_ref_p[:, j] = lr
        log_alt_p[:, j] = la

    raws = []
    for a0, a1 in ga:
        a0, a1 = int(a0), int(a1)
        if a0 == a1:
            raw = allele_lhoods[:, a0]
        elif a0 == 0:
            # ref/alt het: ratio-corrected priors from the alt allele
            p0 = log_ref_p[:, a1 - 1]
            p1 = log_alt_p[:, a1 - 1]
            raw = np.logaddexp(allele_lhoods[:, 0] + p0,
                               allele_lhoods[:, a1] + p1)
        else:
            # het-alt: allele1 prior from its own ratio call, allele0
            # prior from its call's indel side, renormalized (:83-97)
            p1 = log_alt_p[:, a1 - 1]
            p0 = log_alt_p[:, a0 - 1]
            norm = np.logaddexp(p0, p1)
            raw = np.logaddexp(allele_lhoods[:, a0] + (p0 - norm),
                               allele_lhoods[:, a1] + (p1 - norm))
        raws.append(raw)
    raw_g = np.stack(raws, axis=1)  # [R, G]

    integ = integrate_out_mapping(raw_g, np.asarray(n_nonambig)[:, None])
    integ = np.where(np.asarray(read_mask)[:, None], integ, 0.0)
    del G
    return integ.sum(axis=0)


def genotype_posteriors(genotype_lhood: np.ndarray, ln_priors: np.ndarray):
    """(posterior probs, max_gt, qphred ref, qphred max) like the SNV
    result-set (normalizeLogDistro + error_prob_to_qphred)."""
    pp = np.asarray(genotype_lhood, dtype=np.float64) + ln_priors
    mx = pp.max()
    p = np.exp(pp - mx)
    p /= p.sum()
    max_gt = int(np.argmax(pp))
    tiny = np.finfo(np.float64).tiny
    q_ref = int(min(999, np.floor(-10 * np.log10(max(p[0], tiny)) + 0.5)))
    comp = max(p.sum() - p[max_gt], 0.0)
    q_max = int(min(999, np.floor(-10 * np.log10(max(comp, tiny)) + 0.5)))
    return p, max_gt, q_ref, q_max


def batch_genotype_lhoods(entries, ploidy: int, A: int, min_flank: int):
    """Batched per-locus genotype math for loci sharing (caller
    ploidy, allele count): genotype log-lhoods, confident-read flags
    (updateSupportingReadStats), and summed naive allele posteriors
    (the per-sample top-allele support). One vectorized pass replaces
    thousands of small per-locus ufunc dispatches.

    entries: list of (allele_lhoods [R, A] f64 — gated read set, col 0
    = ref; read_len [R]; n_nonambig [R]; ins_len [A-1]; del_len [A-1]).

    Returns [(lh [G] f64, conf [R, A] bool, sup [A] f64)] — BITWISE
    identical to the per-locus formulations (genotype_log_lhoods, the
    caller's confident-count block, and the top-allele support sums):
    padded rows contribute exact +0.0 to every row-sum, numpy's axis-1
    reduction of a C-contiguous [B, R, G] accumulates rows sequentially
    exactly like the per-locus axis-0 sum, and every other op is
    elementwise (tests/test_indel_batch_gt.py pins this bit-for-bit).
    """
    B = len(entries)
    Rs = [len(e[0]) for e in entries]
    Rpad = max(Rs) if Rs else 1
    al = np.zeros((B, Rpad, A))
    rl = np.zeros((B, Rpad))
    nna = np.zeros((B, Rpad))
    mask = np.zeros((B, Rpad), bool)
    ins = np.zeros((B, A - 1), np.int64)
    dels = np.zeros((B, A - 1), np.int64)
    for i, (a, r, n, ii, dd) in enumerate(entries):
        R = len(a)
        al[i, :R] = np.asarray(a, np.float64)
        rl[i, :R] = r
        nna[i, :R] = n
        mask[i, :R] = True
        ins[i] = ii
        dels[i] = dd

    ga = genotype_alleles(ploidy, A)
    log_ref_p = np.zeros((B, Rpad, A - 1))
    log_alt_p = np.zeros((B, Rpad, A - 1))
    for j in range(A - 1):
        lr, la = het_allele_ratio_log_priors(
            rl, min_flank, ins[:, j:j + 1], dels[:, j:j + 1])
        log_ref_p[:, :, j] = lr
        log_alt_p[:, :, j] = la

    raws = []
    for a0, a1 in ga:
        a0, a1 = int(a0), int(a1)
        if a0 == a1:
            raw = al[:, :, a0]
        elif a0 == 0:
            raw = np.logaddexp(al[:, :, 0] + log_ref_p[:, :, a1 - 1],
                               al[:, :, a1] + log_alt_p[:, :, a1 - 1])
        else:
            p1 = log_alt_p[:, :, a1 - 1]
            p0 = log_alt_p[:, :, a0 - 1]
            norm = np.logaddexp(p0, p1)
            raw = np.logaddexp(al[:, :, a0] + (p0 - norm),
                               al[:, :, a1] + (p1 - norm))
        raws.append(raw)
    raw_g = np.stack(raws, axis=2)                       # [B, Rpad, G]
    integ = integrate_out_mapping(raw_g, nna[:, :, None])
    integ = np.where(mask[:, :, None], integ, 0.0)
    lh = integ.sum(axis=1)                               # [B, G]

    # confident supporting reads (posterior >= 0.51 after mapping
    # integration — same ops as the per-locus block)
    i2 = al + CORRECT_MAPPING_LOG_PRIOR
    rb = nna[:, :, None] * LN_RANDOM_BASE_MATCH
    a2 = np.logaddexp(i2, rb)
    a2 = a2 - a2.max(axis=2, keepdims=True)
    p2 = np.exp(a2)
    p2 /= p2.sum(axis=2, keepdims=True)
    conf = (p2 >= 0.51) & mask[:, :, None]

    # summed naive allele posteriors (rankOrthogonalAllelesInSample)
    b3 = al - al.max(axis=2, keepdims=True)
    q = np.exp(b3)
    q /= q.sum(axis=2, keepdims=True)
    q *= mask[:, :, None]
    sup = q.sum(axis=1)                                  # [B, A]

    return [(lh[i], conf[i, :Rs[i]], sup[i]) for i in range(B)]
