"""Indexed FASTA access returning numpy int8 base codes.

Reference analog: htsapi/samtools_fasta_util.hh + blt_util/
reference_contig_segment.hh. The reference sequence is held as a numpy
uint8 code array (A,C,G,T,N -> 0..4) so it can be sliced straight into
device tiles.
"""
from __future__ import annotations

import os

import numpy as np

# base encoding used across the engine (matches reference base_to_id:
# seq_util.hh A=0 C=1 G=2 T=3, N=4)
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4

_CODE_LUT = np.full(256, BASE_N, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _CODE_LUT[ord(c)] = i
    _CODE_LUT[ord(c.lower())] = i

_CHAR_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_bases(s: bytes | str) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return _CODE_LUT[np.frombuffer(s, dtype=np.uint8)]


def decode_bases(codes: np.ndarray) -> str:
    return _CHAR_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


class FastaReference:
    """.fai-indexed FASTA; loads requested contigs lazily as code arrays."""

    def __init__(self, path: str):
        self.path = path
        self._index: dict[str, tuple[int, int, int, int]] = {}
        self._order: list[str] = []
        fai = path + ".fai"
        if os.path.exists(fai):
            with open(fai) as f:
                for line in f:
                    name, length, offset, linebases, linewidth = line.split()[:5]
                    self._index[name] = (int(length), int(offset), int(linebases), int(linewidth))
                    self._order.append(name)
        else:
            self._build_index()
        self._cache: dict[str, np.ndarray] = {}

    def _build_index(self):
        with open(self.path, "rb") as f:
            name = None
            length = 0
            offset = 0
            linebases = linewidth = 0
            pos = 0
            for raw in f:
                if raw.startswith(b">"):
                    if name is not None:
                        self._index[name] = (length, offset, linebases, linewidth)
                        self._order.append(name)
                    name = raw[1:].split()[0].decode()
                    length = 0
                    offset = pos + len(raw)
                    linebases = linewidth = 0
                else:
                    stripped = raw.rstrip(b"\r\n")
                    if linebases == 0:
                        linebases = len(stripped)
                        linewidth = len(raw)
                    length += len(stripped)
                pos += len(raw)
            if name is not None:
                self._index[name] = (length, offset, linebases, linewidth)
                self._order.append(name)

    @property
    def contig_names(self) -> list[str]:
        return list(self._order)

    def contig_length(self, name: str) -> int:
        return self._index[name][0]

    def load_contig(self, name: str) -> np.ndarray:
        """Whole contig as uint8 codes."""
        seq = self._cache.get(name)
        if seq is None:
            length, offset, linebases, linewidth = self._index[name]
            nlines = (length + linebases - 1) // linebases if linebases else 0
            nbytes = (nlines - 1) * linewidth + (length - (nlines - 1) * linebases) if nlines else 0
            with open(self.path, "rb") as f:
                f.seek(offset)
                raw = f.read(nbytes)
            arr = np.frombuffer(raw, dtype=np.uint8)
            if linebases and linewidth > linebases:
                arr = arr.reshape(-1) if nlines <= 1 else arr
                # strip newline columns by masking
                keep = np.ones(len(arr), dtype=bool)
                # positions of newline bytes: every linewidth-th chunk tail
                idx = np.arange(len(arr))
                col = idx % linewidth
                keep = col < linebases
                arr = arr[keep]
            seq = _CODE_LUT[arr[:length]]
            self._cache[name] = seq
        return seq

    def fetch(self, name: str, begin: int, end: int) -> np.ndarray:
        """Codes for [begin, end); out-of-bounds positions filled with N."""
        contig = self.load_contig(name)
        n = len(contig)
        out = np.full(end - begin, BASE_N, dtype=np.uint8)
        lo, hi = max(begin, 0), min(end, n)
        if hi > lo:
            out[lo - begin:hi - begin] = contig[lo:hi]
        return out
