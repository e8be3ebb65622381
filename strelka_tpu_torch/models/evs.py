"""Empirical variant scoring (EVS): feature assembly + RF scoring.

Reference: applications/strelka/position_somatic_snv_strand_grid_vcf.cpp
get_scoring_features :80-225 (somatic SNV feature definitions),
somatic_indel_scoring_features.cpp, somaticAlleleUtil.cpp (phred
transform, 60 cap), germlineVariantEmpiricalScoringFeatures.hh.

Port of strelka_tpu/models/evs.py (the somatic feature rows and
score_sites), host numpy on the port's ops/rf.py.
"""
from __future__ import annotations

import os

import numpy as np

from ..ops.rf import Forest, load_scoring_model

MAX_EVS = 60.0  # somaticAlleleUtil.cpp:36


def load_somatic_snv_model(path: str | None = None) -> Forest | None:
    """The somatic SNV forest at `path`, or None when no model file is
    given or it does not exist. The port ships no default model: with
    no file the rule-based filters apply, as in the JAX package when
    its default model directory is absent."""
    if not path or not os.path.exists(path):
        return None
    return load_scoring_model(path, "SNV", "Somatic")


def load_somatic_indel_model(path: str | None = None) -> Forest | None:
    """The somatic indel forest at `path` (None as for SNVs)."""
    if not path or not os.path.exists(path):
        return None
    return load_scoring_model(path, "INDEL", "Somatic")


def safe_frac(a, b):
    return a / b if b > 0 else 0.0


def somatic_snv_features(site, norm_chrom_depth: float | None) -> np.ndarray:
    """The 10-feature vector in model order (get_scoring_features).

    site: pipeline.somatic_caller.SomaticSnvSite
    """
    ref_gt = site.ref_gt
    n_c1 = site.acgt_tier1[0]
    t_c1 = site.acgt_tier1[1]
    t_ref = int(t_c1[ref_gt])
    t_alt = int(t_c1.sum() - t_ref)
    n_ref = int(n_c1[ref_gt])
    n_alt = int(n_c1.sum() - n_ref)

    from_ref_q = site.qss_nt if site.ntype == 0 else 0
    normal_depth_rate = 1.0
    if norm_chrom_depth and norm_chrom_depth > 0:
        normal_depth_rate = safe_frac(site.dp[0], norm_chrom_depth)
    alt_frac = min(0.5, safe_frac(t_alt, t_ref + t_alt))
    pc = 0.5
    log_odds = np.log(((t_ref + pc) * (n_alt + pc)) /
                      ((t_alt + pc) * (n_ref + pc)))
    return np.array([
        from_ref_q,
        normal_depth_rate,
        alt_frac,
        site.mq,
        safe_frac(site.mq0, max(site.mapq_n, 1)),
        site.snv_sb,
        site.read_pos_ranksum,
        log_odds,
        safe_frac(site.fdp[0], site.dp[0]),
        safe_frac(site.fdp[1], site.dp[1]),
    ], dtype=np.float64)


def somatic_indel_features(call, ihp: int,
                           norm_chrom_depth: float | None) -> np.ndarray:
    """Somatic indel feature vector (somatic_indel_scoring_features.cpp
    calculateScoringFeatures). Rank-sum/odds features computed from the
    batched per-read scores where available."""
    min_freq = 1e-4  # somatic_indel_scoring_features.cpp:38
    pc = 0.5
    t_tar = call.tar[1][0]
    t_tir = call.tir[1][0]
    t_tor = call.tor[1][0]
    n_tar = call.tar[0][0]
    n_tir = call.tir[0][0]
    n_tor = call.tor[0][0]
    from_ref_q = call.qsi_nt if call.ntype == 0 else 0

    def indel_freq(tir, tar):
        tot = tir + tar
        return tir / tot if tot > 0 else 0.0

    def other_freq(tor, tir, tar):
        tot = tor + tir + tar
        return tor / tot if tot > 0 else 0.0

    t_if = indel_freq(t_tir, t_tar)
    n_if = indel_freq(n_tir, n_tar)
    # TumorSampleIndelNoiseLogOdds: ln(indelFreq / otherFreq), floored
    noise_odds = np.log(max(t_if, min_freq)
                        / max(other_freq(t_tor, t_tir, t_tar), min_freq))
    # TumorNormalIndelAlleleLogOdds: ln(tumorFreq / normalFreq), floored
    tn_odds = np.log(max(t_if, min_freq) / max(n_if, min_freq))
    log_odds = np.log(((t_tar + pc) * (n_tir + pc)) /
                      ((t_tir + pc) * (n_tar + pc)))
    return np.array([
        from_ref_q,
        call.read_pos_ranksum,
        call.strand_odds,
        call.rec.indel_repeat_count,
        ihp,
        call.rec.ref_repeat_count,
        call.rec.repeat_unit_length,
        noise_odds,
        tn_odds,
        log_odds,
    ], dtype=np.float64)


def score_sites(forest: Forest, feature_rows: list[np.ndarray]) -> np.ndarray:
    """[B] phred EVS values."""
    if not feature_rows:
        return np.zeros(0)
    x = np.stack(feature_rows)
    return forest.score_phred(x, MAX_EVS)
