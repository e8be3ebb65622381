"""Affine-gap global alignment (haplotype -> reference decomposition).

Reference: alignment/GlobalAligner.hh|GlobalAlignerImpl.hh (DP over
match/delete/insert states with AlignmentScores{match, mismatch, open,
extend, offEdge}) used by the active-region processor with bwa-like
scores (ActiveRegionDetector.hh:59-63).

numpy DP with vectorized inner rows; haplotypes are <=250bp
(MaxRefSpanToBypassAssembly) so host cost is negligible — device tiles
are reserved for the read-likelihood hot loop.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import cigar as cg

MATCH_STATE, DEL_STATE, INS_STATE = 0, 1, 2


@dataclass(frozen=True)
class AlignmentScores:
    """bwa-like defaults from ActiveRegionDetector.hh:59-63."""
    match: int = 1
    mismatch: int = -4
    open: int = -5
    extend: int = -1
    off_edge: int = -100


def align_global(query: np.ndarray, ref: np.ndarray,
                 scores: AlignmentScores = AlignmentScores(),
                 use_native: bool = True):
    """Global affine-gap alignment of query onto ref.

    Returns (score, ops, lens) with CIGAR in query-vs-ref convention
    (MATCH/INSERT=query-only/DELETE=ref-only). The native path
    (native/activeregion.cpp align_affine) is an exact port including
    all tie-breaks; this numpy version remains the test oracle.
    """
    if use_native:
        from ..io.native import align_affine_native
        res = align_affine_native(query, ref, scores.match,
                                  scores.mismatch, scores.open,
                                  scores.extend)
        if res is not None:
            return res
    n, m = len(query), len(ref)
    NEG = -(10 ** 9)
    # DP matrices: score[state][i][j], i over query 0..n, j over ref 0..m
    M = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    D = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # gap in query (ref consumed)
    I = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # gap in ref (query consumed)
    ptrM = np.zeros((n + 1, m + 1), dtype=np.int8)
    ptrD = np.zeros((n + 1, m + 1), dtype=np.int8)
    ptrI = np.zeros((n + 1, m + 1), dtype=np.int8)

    M[0, 0] = 0
    # leading gaps
    for j in range(1, m + 1):
        D[0, j] = scores.open + scores.extend * j
        ptrD[0, j] = DEL_STATE
    for i in range(1, n + 1):
        I[i, 0] = scores.open + scores.extend * i
        ptrI[i, 0] = INS_STATE

    for i in range(1, n + 1):
        qb = query[i - 1]
        # vectorized row update for M and D; I needs sequential scan? No:
        # I[i][j] depends on (M|I)[i-1][j] only -> vectorizable.
        sub = np.where(ref == qb, scores.match, scores.mismatch)
        prevM = M[i - 1, :-1]
        prevD = D[i - 1, :-1]
        prevI = I[i - 1, :-1]
        best_prev = np.maximum(np.maximum(prevM, prevD), prevI)
        from_state = np.where(prevM >= np.maximum(prevD, prevI), MATCH_STATE,
                              np.where(prevD >= prevI, DEL_STATE, INS_STATE))
        M[i, 1:] = best_prev + sub
        ptrM[i, 1:] = from_state

        io = np.maximum(M[i - 1, :] + scores.open + scores.extend,
                        I[i - 1, :] + scores.extend)
        I[i, :] = np.maximum(I[i, :], io)
        ptrI[i, :] = np.where(
            M[i - 1, :] + scores.open + scores.extend >= I[i - 1, :] + scores.extend,
            MATCH_STATE, INS_STATE)

        # D along the row: sequential recurrence -> do with running max trick
        # D[i][j] = max(M[i][j-1]+open+extend, D[i][j-1]+extend)
        row = np.full(m + 1, NEG, dtype=np.int64)
        for j in range(1, m + 1):
            a = M[i, j - 1] + scores.open + scores.extend
            b = row[j - 1] + scores.extend
            if a >= b:
                row[j] = a
                ptrD[i, j] = MATCH_STATE
            else:
                row[j] = b
                ptrD[i, j] = DEL_STATE
        D[i, :] = row

    finals = (M[n, m], D[n, m], I[n, m])
    state = int(np.argmax(finals))
    score = int(finals[state])

    # traceback
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if state == MATCH_STATE:
            if i == 0 or j == 0:
                break
            prev = ptrM[i, j]
            ops.append(cg.MATCH)
            i -= 1
            j -= 1
            state = int(prev)
        elif state == DEL_STATE:
            prev = ptrD[i, j]
            ops.append(cg.DELETE)
            j -= 1
            state = int(prev)
        else:
            prev = ptrI[i, j]
            ops.append(cg.INSERT)
            i -= 1
            state = int(prev)
    ops.reverse()
    out_ops, out_lens = [], []
    for o in ops:
        if out_ops and out_ops[-1] == o:
            out_lens[-1] += 1
        else:
            out_ops.append(o)
            out_lens.append(1)
    return score, np.array(out_ops, dtype=np.int8), np.array(out_lens, dtype=np.int32)
