"""Log-space probability math (numpy, host).

Reference: blt_util/logSumUtil.hh getLogSum; blt_util/prob_util.hh
normalizeLogDistro / prob_comp. On TPU these become vectorized
logsumexp/softmax over genotype axes.
"""
from __future__ import annotations

import numpy as np


def log_sum(x1, x2):
    """numpy pairwise stable log(exp(x1)+exp(x2))."""
    hi = np.maximum(x1, x2)
    lo = np.minimum(x1, x2)
    return hi + np.log1p(np.exp(lo - hi))


def normalize_ln_distro(lnp, axis=-1):
    """Normalize a log-space distro to linear probabilities (numpy).

    Matches reference normalizeLogDistro (prob_util.hh): subtract max,
    exponentiate, normalize. Returns (probs, argmax_index).
    """
    lnp = np.asarray(lnp, dtype=np.float64)
    mx = np.max(lnp, axis=axis, keepdims=True)
    p = np.exp(lnp - mx)
    p /= np.sum(p, axis=axis, keepdims=True)
    return p, np.argmax(lnp, axis=axis)


def prob_comp(p, index, axis=-1):
    """1 - p[index], computed as a sum over the complement for precision.

    Reference: prob_util.hh prob_comp sums all elements except `index`
    rather than computing 1-p[i] (better float behavior near 1).
    """
    p = np.asarray(p)
    total = np.sum(p, axis=axis)
    picked = np.take_along_axis(p, np.expand_dims(np.asarray(index), axis), axis).squeeze(axis)
    return total - picked
