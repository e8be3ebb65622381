"""Reference-sequence context metrics used by EVS features.

Reference: blt_common/ref_context.cpp (get_interrupted_hpol_size
:236-272, shortestUnencountered/computeContextCompressability
:275-331).
"""
from __future__ import annotations

import numpy as np


class _IhpolData:
    """Two-allele run tracker (ref_context.cpp ihpol_data :183-232):
    admits patterns X^a Y X^b / X Y^k, i.e. a homopolymer with at most
    a single-base interruption on one side."""
    __slots__ = ("r1", "r2", "nr1", "nr2")

    def __init__(self):
        self.r1 = 4
        self.r2 = 4
        self.nr1 = 0
        self.nr2 = 0

    def add_base(self, b: int) -> bool:
        if self.nr1 == 0:
            self.r1 = b
            self.nr1 = 1
        elif self.r1 == b:
            if self.nr2 > 1 or self.r1 >= 4:
                return False
            self.nr1 += 1
        elif self.nr2 == 0:
            self.r2 = b
            self.nr2 = 1
        elif self.r2 == b:
            if self.nr1 > 1 or self.r2 >= 4:
                return False
            self.nr2 += 1
        else:
            return False
        return True

    def max_allele_size(self) -> int:
        return max(self.nr1, self.nr2)


def interrupted_hpol_size(ref_codes: np.ndarray, pos: int) -> int:
    """getInterruptedHomopolymerLength at one position
    (ref_context.cpp :236-272)."""
    n = len(ref_codes)
    if not (0 <= pos < n):
        return 0
    up = _IhpolData()
    for i in range(pos, -1, -1):
        if not up.add_base(int(ref_codes[i])):
            break
    for i in range(pos + 1, n):
        if not up.add_base(int(ref_codes[i])):
            break
    dn = _IhpolData()
    for i in range(pos, n):
        if not dn.add_base(int(ref_codes[i])):
            break
    for i in range(pos - 1, -1, -1):
        if not dn.add_base(int(ref_codes[i])):
            break
    return max(up.max_allele_size(), dn.max_allele_size())


def indel_interrupted_hpol(ref_codes: np.ndarray, begin_pos: int,
                           end_pos: int) -> int:
    """Indel InterruptedHomopolymerLength: max over the positions
    flanking the indel span (AlleleReportInfoUtil.cpp :206-215)."""
    best = max(interrupted_hpol_size(ref_codes, begin_pos - 1),
               interrupted_hpol_size(ref_codes, begin_pos))
    if begin_pos != end_pos:
        best = max(best,
                   interrupted_hpol_size(ref_codes, end_pos - 1),
                   interrupted_hpol_size(ref_codes, end_pos))
    return best


def _shortest_unencountered(ref_codes: np.ndarray, pos: int,
                            num_encoded: int, left: bool) -> int:
    """Length of the shortest new substring adjacent to the encoded
    span (ref_context.cpp shortestUnencountered). Out-of-range bases
    read as 'N' (reference_contig_segment default)."""
    n = len(ref_codes)

    def sub(start: int, length: int) -> bytes:
        out = bytearray()
        for i in range(start, start + length):
            out.append(int(ref_codes[i]) if 0 <= i < n else 4)
        return bytes(out)

    if left:
        encoded = sub(pos - num_encoded + 1, num_encoded)
    else:
        encoded = sub(pos, num_encoded)
    ln = 0
    while True:
        ln += 1
        if left:
            new = sub(pos - num_encoded - ln + 1, ln)
        else:
            new = sub(pos + num_encoded, ln)
        if encoded.find(new) < 0:
            return ln


def context_compressability(ref_codes: np.ndarray, left_pos: int,
                            right_pos: int, num_keys: int = 5) -> int:
    """Max adjacent sequence length encodable by `num_keys` LZ77
    keywords (computeContextCompressability)."""
    num_left = 1
    num_right = 1
    for _ in range(num_keys - 1):
        num_left += _shortest_unencountered(ref_codes, left_pos - 1,
                                            num_left, True)
        num_right += _shortest_unencountered(ref_codes, right_pos,
                                             num_right, False)
    return max(num_left, num_right)
