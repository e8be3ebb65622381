"""Diploid genotype (DIGT) tables as numpy constants.

Reference: blt_util/digt.hh — the 10-state diploid genotype space over
{A,C,G,T}: 4 hom + 6 het, and its expect/expect2 lookup tables. Here
they are dense arrays consumed by vectorized likelihood code.
"""
from __future__ import annotations

import numpy as np

N_BASE = 4
SIZE = 10
HET_SIZE = SIZE - N_BASE

LABELS = ["AA", "CC", "GG", "TT", "AC", "AG", "AT", "CG", "CT", "GT"]

# allele pair per genotype (digt.hh get_allele)
ALLELES = np.array([
    [0, 0], [1, 1], [2, 2], [3, 3],
    [0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3],
], dtype=np.int8)

# expected allele frequency of base b under genotype g (digt.hh expect)
EXPECT = np.zeros((SIZE, N_BASE), dtype=np.float64)
for _g in range(SIZE):
    for _c in range(2):
        EXPECT[_g, ALLELES[_g, _c]] += 0.5

# coded expect: 0 -> freq 0, 1 -> freq 0.5, 2 -> freq 1 (digt.hh expect2)
EXPECT2 = np.zeros((SIZE, N_BASE), dtype=np.int8)
EXPECT2[EXPECT == 0.5] = 1
EXPECT2[EXPECT == 1.0] = 2

# biased-het coding (digt.hh expect2_bias):
# 0 -> 0, 1 -> het_ratio (lower allele), 2 -> 1-het_ratio (higher), 3 -> 1
EXPECT2_BIAS = np.zeros((SIZE, N_BASE), dtype=np.int8)
EXPECT2_BIAS[EXPECT == 1.0] = 3
for _g in range(N_BASE, SIZE):
    lo, hi = ALLELES[_g]
    EXPECT2_BIAS[_g, lo] = 1
    EXPECT2_BIAS[_g, hi] = 2

IS_HET = np.arange(SIZE) >= N_BASE


def het_gt_of(b1: int, b2: int) -> int:
    """Genotype index for an unordered base pair."""
    if b1 == b2:
        return b1
    lo, hi = min(b1, b2), max(b1, b2)
    for g in range(N_BASE, SIZE):
        if ALLELES[g, 0] == lo and ALLELES[g, 1] == hi:
            return g
    raise ValueError((b1, b2))


def vcf_gt_string(gt: int, ref_gt: int) -> str:
    """VCF GT text for genotype vs ref base (digt.hh get_vcf_gt)."""
    a, b = ALLELES[gt]
    if a == ref_gt and b == ref_gt:
        return "0/0"
    if a == ref_gt:
        return "0/1"
    if b == ref_gt:
        return "0/1"
    if a == b:
        return "1/1"
    return "1/2"
