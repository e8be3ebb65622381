"""CIGAR algebra on vectorized (op, length) arrays.

TPU-native re-design of the reference's align_path utilities
(reference: blt_util/align_path.hh|cpp). Alignments are kept as numpy
(ops:int8, lens:int32) array pairs per read, concatenated into ragged
batch arrays with offsets, so whole read batches can be expanded into
per-base reference/read coordinates with vectorized numpy — there is no
per-segment virtual dispatch like the reference's path_t loops.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# BAM standard op codes
MATCH = 0      # M
INSERT = 1     # I
DELETE = 2     # D
SKIP = 3       # N
SOFT_CLIP = 4  # S
HARD_CLIP = 5  # H
PAD = 6        # P
SEQ_MATCH = 7  # =
SEQ_MISMATCH = 8  # X

OP_CHARS = "MIDNSHP=X"
_OP_FROM_CHAR = {c: i for i, c in enumerate(OP_CHARS)}

# per-op coordinate advancement
ADVANCES_READ = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int32)
ADVANCES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int32)


def cigar_from_string(s: str) -> tuple[np.ndarray, np.ndarray]:
    """'35M1I40M' -> (ops, lens)."""
    ops, lens = [], []
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            ops.append(_OP_FROM_CHAR[ch])
            lens.append(n)
            n = 0
    return np.array(ops, dtype=np.int8), np.array(lens, dtype=np.int32)


def cigar_to_string(ops: np.ndarray, lens: np.ndarray) -> str:
    return "".join(f"{l}{OP_CHARS[o]}" for o, l in zip(ops, lens))


def ref_span(ops: np.ndarray, lens: np.ndarray) -> int:
    """Reference bases consumed (reference: align_path ref_length)."""
    return int(np.sum(lens * ADVANCES_REF[ops]))


def read_span(ops: np.ndarray, lens: np.ndarray) -> int:
    """Read bases consumed incl. soft clip (align_path read_length)."""
    return int(np.sum(lens * ADVANCES_READ[ops]))


def expand_to_per_base(ops: np.ndarray, lens: np.ndarray, pos: int):
    """Expand a CIGAR into per-read-base (ref_pos, op) arrays.

    Returns (read_idx -> ref_pos int32, read_idx -> op int8) for every
    read base (including soft-clipped and inserted bases; for those,
    ref_pos is the position of the *next* aligned reference base).
    Deletions consume no read bases so do not appear.
    """
    n_read = int(np.sum(lens * ADVANCES_READ[ops]))
    ref_pos_out = np.empty(n_read, dtype=np.int64)
    op_out = np.empty(n_read, dtype=np.int8)
    r = 0
    g = pos
    for o, l in zip(ops, lens):
        if ADVANCES_READ[o]:
            op_out[r:r + l] = o
            if ADVANCES_REF[o]:
                ref_pos_out[r:r + l] = np.arange(g, g + l)
            else:
                ref_pos_out[r:r + l] = g
            r += l
        if ADVANCES_REF[o]:
            g += int(l)
    return ref_pos_out, op_out


@dataclass
class AlignSeg:
    """One (op,len) segment — convenience for tests."""
    op: int
    length: int


def apply_offset_to_cigar(ops, lens):
    """Normalize: merge adjacent same-type segments, drop zero-length."""
    keep = lens > 0
    ops, lens = ops[keep], lens[keep]
    if len(ops) == 0:
        return ops, lens
    out_ops, out_lens = [ops[0]], [int(lens[0])]
    for o, l in zip(ops[1:], lens[1:]):
        if o == out_ops[-1]:
            out_lens[-1] += int(l)
        else:
            out_ops.append(o)
            out_lens.append(int(l))
    return np.array(out_ops, dtype=np.int8), np.array(out_lens, dtype=np.int32)
