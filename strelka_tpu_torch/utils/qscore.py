"""Phred quality-score conversion tables.

TPU-native equivalent of the reference's qscore cache
(reference: blt_util/qscore.hh, blt_util/qscore_cache.hh|cpp): on TPU the
phred->prob conversions become precomputed numpy/jnp lookup tables that
vectorize over whole pileup/read tensors instead of per-call function calls.
"""
from __future__ import annotations

import numpy as np

MAX_QSCORE = 70  # reference caches up to MAX_QSCORE (qscore_cache.hh)

_q = np.arange(MAX_QSCORE + 1, dtype=np.float64)

# P(error) for phred q
ERROR_PROB = np.power(10.0, -_q / 10.0)
# qscore 0 is treated as completely uninformative (error prob capped below 1)
# reference: qscore_cache.cpp qphred_to_error_prob clamps to q>=2 semantics via
# basecall filtering; we keep the raw table and let callers filter q<min_qscore.
COMP_ERROR_PROB = 1.0 - ERROR_PROB

LN_ERROR_PROB = np.log(ERROR_PROB)
with np.errstate(divide="ignore"):
    LN_COMP_ERROR_PROB = np.log1p(-ERROR_PROB)  # ln(1 - 10^(-q/10))
# q=0 -> error prob 1 -> ln(comp) = -inf; clamp like the reference's cache
LN_COMP_ERROR_PROB[0] = np.log(np.finfo(np.float64).tiny)

LN_ONE_THIRD = float(np.log(1.0 / 3.0))
LN_ONE_HALF = float(np.log(0.5))


def qphred_to_error_prob(q):
    """Vectorized phred->P(error). Accepts numpy arrays of int."""
    q = np.clip(q, 0, MAX_QSCORE)
    return ERROR_PROB[q]


def qphred_to_ln_error_prob(q):
    q = np.clip(q, 0, MAX_QSCORE)
    return LN_ERROR_PROB[q]


def qphred_to_ln_comp_error_prob(q):
    q = np.clip(q, 0, MAX_QSCORE)
    return LN_COMP_ERROR_PROB[q]


def error_prob_to_qphred(p, max_q: int = 999) -> np.ndarray:
    """P(error) -> phred, rounded like the reference.

    reference: blt_util/qscore.hh error_prob_to_qphred uses
    std::min(999, int(round(-10 log10(p)))) with p clamped away from 0.
    """
    p = np.asarray(p, dtype=np.float64)
    tiny = np.finfo(np.float64).tiny
    q = -10.0 * np.log10(np.maximum(p, tiny))
    return np.minimum(np.round(q), max_q).astype(np.int32)


def ln_error_prob_to_qphred(lnp, max_q: int = 999) -> np.ndarray:
    """ln P(error) -> phred (reference: qscore.hh ln_error_prob_to_qphred)."""
    lnp = np.asarray(lnp, dtype=np.float64)
    q = -10.0 * lnp / np.log(10.0)
    q = np.where(np.isfinite(q), q, max_q)
    return np.clip(np.round(q), 0, max_q).astype(np.int32)
