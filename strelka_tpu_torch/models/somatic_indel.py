"""Somatic indel model: frequency-grid likelihoods from per-read
allele scores + the shared joint posterior.

Reference: applications/strelka/somatic_indel_grid.cpp
(get_indel_het_grid_lhood :67-90, get_somatic_indel :180-330) and
starling_common/starling_indel_call_pprob_digt.cpp
(get_indel_digt_lhood :240-310, get_high_low_het_ratio_lhood :75-182).

Vectorized: per locus, per sample, the [R] (ref_lnp, indel_lnp) pairs
from the scoring op expand against the 21-point frequency grid in one
[R, F] logaddexp; the reference's per-read loops disappear.

Port of strelka_tpu/models/somatic_indel.py: host numpy, copied as it
is (per-locus math on a few hundred reads; no device program).
"""
from __future__ import annotations

import numpy as np

from . import indel_genotype as ig
from . import somatic_snv as ss


def indel_freq_grid_lhoods(
    ref_lnp: np.ndarray,     # [R] log P(read | no indel) (already maxed
                             #     with alt-indel paths, is_use_alt_indel)
    indel_lnp: np.ndarray,   # [R] log P(read | indel)
    read_len: np.ndarray,    # [R]
    n_nonambig: np.ndarray,  # [R]
    mask: np.ndarray,        # [R] read participates (tier gating)
    insert_len: int,
    delete_len: int,
    min_read_bp_flank: int,
    ln_random_base_match: float = ig.LN_RANDOM_BASE_MATCH,
) -> np.ndarray:
    """[PRESTRAND_SIZE] log likelihoods over the somatic freq grid.

    Each frequency f gets the per-read mixture
    logsum(ref + ln(1-f'), indel + ln f') with f' ratio-corrected for
    the indel's read-span asymmetry (get_het_observed_allele_ratio),
    then mapping-status integration, summed over reads.
    """
    R = len(ref_lnp)
    fr = ss.FRACTIONS  # [F]
    # ratio correction per read per target fraction, computed once for
    # the unique read lengths x the whole grid (the per-fraction
    # helper-call loop cost ~20 numpy dispatches per locus per tier);
    # every element sees the same f64 arithmetic as
    # ig.het_allele_ratio_log_priors, so values are bit-identical
    uniq, inv = np.unique(np.asarray(read_len, dtype=np.float64),
                          return_inverse=True)
    base_expect = np.maximum(uniq + 1 - 2 * min_read_bp_flank, 0.0)
    ref_expect = base_expect + np.minimum(delete_len, base_expect)
    indel_expect = base_expect + np.minimum(insert_len, base_expect)
    interior = (fr > 0.0) & (fr < 1.0)
    fi = np.where(interior, fr, 0.5)  # placeholder at the endpoints
    ref_term = (1.0 - fi)[None, :] * ref_expect[:, None]    # [U, F]
    indel_term = fi[None, :] * indel_expect[:, None]
    total = ref_term + indel_term
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(total > 0,
                     indel_term / np.maximum(total, 1e-300),
                     fi[None, :])
        lr_u = np.log1p(-p)
        la_u = np.log(p)
    lr_u[:, ~interior] = np.where(fr[~interior] <= 0.0, 0.0, -np.inf)
    la_u[:, ~interior] = np.where(fr[~interior] <= 0.0, -np.inf, 0.0)
    log_ref_p = lr_u[inv]   # [R, F]
    log_ind_p = la_u[inv]

    raw = np.logaddexp(ref_lnp[:, None] + log_ref_p,
                       indel_lnp[:, None] + log_ind_p)       # [R, F]
    integ = np.logaddexp(raw + ig.CORRECT_MAPPING_LOG_PRIOR,
                         (n_nonambig * ln_random_base_match)[:, None])
    integ = np.where(mask[:, None], integ, 0.0)
    return integ.sum(axis=0)


def somatic_indel_call(
    normal_lhood: np.ndarray,   # [PRESTRAND_SIZE]
    tumor_lhood: np.ndarray,    # [PRESTRAND_SIZE]
    tumor_indel_to_ref_rate: float,
    contam_tolerance: float = 0.15,
    somatic_indel_rate: float = 1e-6,
    bindel_theta: float = 1e-4,
    shared_indel_error_factor: float = 1.4,
):
    """Joint somatic-indel posterior (get_somatic_indel rate plumbing:
    sharedErrorRate = tumorIndelToRef^shared_indel_error_factor,
    somatic_indel_grid.cpp:272-276). Returns a SomaticSnvResult-shaped
    tuple of scalars (qphred, from_ntype_qphred, ntype, max_gt)."""
    shared = float(tumor_indel_to_ref_rate) ** shared_indel_error_factor
    pf, gp = ss.build_joint_prior(contam_tolerance, shared,
                                  somatic_indel_rate, bindel_theta,
                                  sse_strand_fraction=0.0)
    # posterior math in float64 (reference post_prob is double,
    # qscore_calculator.cpp:183-207; f32 cannot hold 1-1e-12 complements)
    pf = np.asarray(pf, dtype=np.float64)
    gp = np.asarray(gp, dtype=np.float64)
    nl = np.asarray(normal_lhood, dtype=np.float64)
    tl = np.asarray(tumor_lhood, dtype=np.float64)
    s = pf + nl[None, None, :, None] + tl[None, None, None, :]
    flat = s.reshape(3, 2, -1)
    mxs = flat.max(axis=-1, keepdims=True)
    lse = mxs[..., 0] + np.log(np.exp(flat - mxs).sum(axis=-1))
    log_post = lse + gp                                        # [3, 2]
    mx = log_post.max()
    p = np.exp(log_post - mx)
    p /= p.sum()
    nonsom = p[:, ss.NON_SOMATIC].sum()
    som_given_n = p[:, ss.SOMATIC]
    # complement-sum for precision
    err = nonsom + (som_given_n.sum() - som_given_n)
    ntype = int(np.argmin(err))
    tiny = np.finfo(np.float64).tiny
    q = int(min(999, np.floor(-10 * np.log10(max(nonsom, tiny)) + 0.5)))
    qn = int(min(999, np.floor(-10 * np.log10(max(err[ntype], tiny)) + 0.5)))
    max_gt = int(np.argmax(log_post))
    return q, qn, ntype, max_gt
