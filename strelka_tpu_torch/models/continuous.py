"""Continuous variant-frequency caller (mito / targeted / tumor-only).

Reference: applications/starling/starling_continuous_variant_caller.cpp
(Poisson error-model allele Q :38-85, binomial strand bias :88-130) and
starling_pos_processor.cpp process_pos_snp_continuous:926.
Vectorized over whole pileup tiles with scipy special functions.
"""
from __future__ import annotations

import numpy as np
from scipy import special as sps
from scipy import stats as spstats

DEFAULT_EXPECTED_OBS_QSCORE = 17  # continuousFrequencyCallerExpectedObservationQuality
DEFAULT_MAX_QSCORE = 40           # continuousFrequencyCallerMaxQscore
MIN_HET_VF = 0.01                 # min_het_vf


def allele_error_qscore(allele_count, total_count,
                        expected_qscore: int = DEFAULT_EXPECTED_OBS_QSCORE,
                        max_qscore: int = DEFAULT_MAX_QSCORE):
    """Phred score that the allele counts are sequencing error
    (vectorized gamma_p Poisson tail, getAlleleSequencingErrorQscore)."""
    allele_count = np.asarray(allele_count, dtype=np.float64)
    total_count = np.asarray(total_count, dtype=np.float64)
    err_rate = 10.0 ** (-expected_qscore / 10.0)
    lam = total_count * err_rate
    p = np.where(allele_count > 0, sps.gammainc(np.maximum(allele_count, 1), lam), 1.0)
    tiny = np.finfo(np.float64).tiny
    q = np.where(p <= 0, max_qscore,
                 np.minimum(max_qscore,
                            np.floor(-10 * np.log10(np.maximum(p, tiny)) + 0.5)))
    return q.astype(np.int32)


def _binom_logpdf(trials, successes, p):
    trials = np.asarray(trials, dtype=np.float64)
    out = np.where(trials == 0, 0.0,
                   spstats.binom.logpmf(np.minimum(successes, trials),
                                        np.maximum(trials, 1),
                                        np.clip(p, 0.0, 1.0)))
    return out


def strand_bias(fwd_alt, rev_alt, fwd_other, rev_other):
    """Continuous-caller strand bias LR (strandBias :88-130)."""
    fwd_alt = np.asarray(fwd_alt, dtype=np.float64)
    rev_alt = np.asarray(rev_alt, dtype=np.float64)
    fwd_tot = fwd_alt + np.asarray(fwd_other, dtype=np.float64)
    rev_tot = rev_alt + np.asarray(rev_other, dtype=np.float64)
    total = fwd_tot + rev_tot
    with np.errstate(divide="ignore", invalid="ignore"):
        fwd_freq = np.where(fwd_tot > 0, fwd_alt / np.maximum(fwd_tot, 1), 0.0)
        rev_freq = np.where(rev_tot > 0, rev_alt / np.maximum(rev_tot, 1), 0.0)
        alt_freq = np.where(total > 0, (fwd_alt + rev_alt) / np.maximum(total, 1), 0.0)
    e = 0.005
    fwd_lnp = _binom_logpdf(fwd_tot, fwd_alt, fwd_freq) + _binom_logpdf(rev_tot, rev_alt, e)
    rev_lnp = _binom_logpdf(fwd_tot, fwd_alt, e) + _binom_logpdf(rev_tot, rev_alt, rev_freq)
    lnp = _binom_logpdf(fwd_tot, fwd_alt, alt_freq) + _binom_logpdf(rev_tot, rev_alt, alt_freq)
    out = np.maximum(np.maximum(fwd_lnp, rev_lnp) - lnp, 0.0)
    return np.where(total == 0, 0.0, out)


def call_continuous_sites(used_counts, used_fwd_counts, ref_gt,
                          min_vf: float = MIN_HET_VF,
                          expected_qscore: int = DEFAULT_EXPECTED_OBS_QSCORE,
                          max_qscore: int = DEFAULT_MAX_QSCORE):
    """Batched continuous-VF SNV calling.

    used_counts/[L,4], ref_gt [L]. Returns per-locus dict-of-arrays:
    for each of up to 3 alt alleles: vf, qscore, strand bias; variant
    mask where vf >= min_vf and q > 0.
    """
    L = used_counts.shape[0]
    total = used_counts.sum(axis=1)
    results = []
    for alt in range(4):
        is_ref = alt == ref_gt
        count = used_counts[:, alt]
        vf = np.where(total > 0, count / np.maximum(total, 1), 0.0)
        q = allele_error_qscore(count, total, expected_qscore, max_qscore)
        fwd_alt = used_fwd_counts[:, alt]
        rev_alt = count - fwd_alt
        fwd_other = used_fwd_counts.sum(axis=1) - fwd_alt
        rev_other = (total - count) - fwd_other
        sb = strand_bias(fwd_alt, rev_alt, fwd_other, rev_other)
        # reportability: strictly above min VF, no quality gate
        # (starling_pos_processor.cpp:968)
        variant = (~is_ref) & (vf > min_vf) & (count > 0)
        results.append({"vf": vf, "q": q, "sb": sb, "variant": variant})
    del L
    return results
