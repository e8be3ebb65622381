"""Statistical tests used by candidacy and filtering logic.

Reference: blt_util/binomial_test.hh|cpp (one-sided exact binomial via
boost), blt_util/fisher_exact_test.*, blt_util/fastRanksum.hh. Here we
use scipy on host; candidacy min-count thresholds are precomputed into
lookup tables (mirroring min_count_binom_gte_cache.hh) so the device
pipeline only does integer compares.
"""
from __future__ import annotations

import numpy as np
from scipy import stats as _sps


def binomial_exact_pval_gte(error_rate: float, n_success: int, n_trials: int) -> float:
    """P(X >= n_success) one-sided exact binomial (binomial_test.hh).

    get_binomial_gte_n_success_exact_pvalue in the reference.
    """
    if n_success <= 0:
        return 1.0
    return float(_sps.binom.sf(n_success - 1, n_trials, error_rate))


def is_reject_binomial_gte(alpha: float, error_rate: float, n_success: int, n_trials: int) -> bool:
    """Reject null (observations are noise) when pval < alpha."""
    return binomial_exact_pval_gte(error_rate, n_success, n_trials) < alpha


class MinCountBinomGteCache:
    """min n_success to reject at alpha, cached by n_trials.

    Reference: blt_util/min_count_binom_gte_cache.hh|cpp — used by indel
    candidacy so the hot path is one integer comparison.
    """

    def __init__(self, alpha: float):
        self._alpha = alpha
        self._cache: dict[tuple[float, int], int] = {}

    def get_min_count_approx(self, error_rate: float, n_trials: int) -> int:
        key = (error_rate, n_trials)
        v = self._cache.get(key)
        if v is None:
            # smallest k with sf(k-1, n, p) < alpha
            k = int(_sps.binom.isf(self._alpha, n_trials, error_rate)) + 1
            while k > 1 and _sps.binom.sf(k - 2, n_trials, error_rate) < self._alpha:
                k -= 1
            while _sps.binom.sf(k - 1, n_trials, error_rate) >= self._alpha:
                k += 1
            self._cache[key] = v = k
        return v

    def is_reject_null(self, error_rate: float, n_success: int, n_trials: int) -> bool:
        return n_success >= self.get_min_count_approx(error_rate, n_trials)


def fisher_exact_twosided(a: int, b: int, c: int, d: int) -> float:
    """2x2 Fisher exact test p-value (fisher_exact_test.hh)."""
    return float(_sps.fisher_exact([[a, b], [c, d]])[1])


def mann_whitney_u_from_groups(x: np.ndarray, y: np.ndarray) -> float:
    """Exact port of blt_util/fastRanksum.cpp get_z_stat.

    Observations are bucketed by integer value (ranks of ties share
    the bucket's average rank), and the z-score is computed for
    whichever group holds the smaller rank sum, with the reference's
    variance form sqrt(n2*mean/6) — so results are symmetric in the
    argument order and non-positive by construction."""
    x = np.asarray(x)
    y = np.asarray(y)
    if len(x) == 0 or len(y) == 0:
        return 0.0
    v = np.round(np.concatenate([x, y])).astype(np.int64)
    lo = int(v.min())
    c1 = np.bincount(np.round(x).astype(np.int64) - lo)
    c2 = np.bincount(np.round(y).astype(np.int64) - lo)
    n = max(len(c1), len(c2))
    c1 = np.pad(c1, (0, n - len(c1)))
    c2 = np.pad(c2, (0, n - len(c2)))
    tot = c1 + c2
    before = np.concatenate([[0], np.cumsum(tot)[:-1]])
    rank_weight = (2 * (before + 1) + tot - 1) / 2.0
    R1 = float((rank_weight * c1).sum())
    R2 = float((rank_weight * c2).sum())
    N1, N2 = int(c1.sum()), int(c2.sum())
    if R1 > R2:
        n1, n2, w1 = N2, N1, R2
    else:
        n1, n2, w1 = N1, N2, R1
    mean = n1 * (n1 + n2 + 1) / 2.0
    var = np.sqrt(n2 * mean / 6.0)
    if abs(var) < 1e-4:
        return 0.0
    return float((w1 - mean) / var)
