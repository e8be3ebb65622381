"""BGZF block-gzip reader/writer (pure Python + zlib).

Replaces the reference's htslib BGZF dependency (htsapi/ wraps
htslib-1.7). BGZF is gzip with an extra 'BC' subfield carrying the
compressed block size, enabling random access; VCF/BED outputs are
written BGZF so downstream tabix/htslib tools accept them.
"""
from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2BH")  # magic(2) method flags mtime xfl os xlen


def decompress_file(path: str) -> bytes:
    """Decompress an entire BGZF (or plain gzip) file to bytes."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\x1f\x8b":
        raise ValueError(f"{path}: not a gzip/BGZF file (bad magic)")
    try:
        return decompress_stream(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def decompress_stream(data: bytes) -> bytes:
    """Decompress a concatenation of gzip/BGZF members from bytes."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        d = zlib.decompressobj(wbits=31)
        try:
            out.append(d.decompress(data[pos:]))
        except zlib.error as e:
            raise ValueError(f"corrupt gzip stream at offset {pos}: {e}") from e
        consumed = n - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return b"".join(out)


class BgzfWriter:
    """Writes BGZF blocks (<=64KB uncompressed each) + EOF marker.

    virtual_offset() exposes the current (coffset << 16 | uoffset)
    virtual file offset used by tabix/BAI indexing.
    """

    MAX_BLOCK = 0xFF00

    def __init__(self, path: str, level: int = 6):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._coffset = 0  # compressed bytes written so far

    def virtual_offset(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(self.MAX_BLOCK)

    def _flush_block(self, size: int) -> None:
        chunk = bytes(self._buf[:size])
        del self._buf[:size]
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12)+XLEN fields(6)+crc/isize(8) = 26? compute exact below
        # layout: 12-byte gzip hdr, 6-byte BC subfield, comp, 4 crc, 4 isize
        block_len = 12 + 6 + len(comp) + 8
        header = struct.pack(
            "<4BI2B", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF
        ) + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, block_len - 1)
        crc = zlib.crc32(chunk) & 0xFFFFFFFF
        self._f.write(header + comp + struct.pack("<II", crc, len(chunk)))
        self._coffset += block_len
        del bsize

    def close(self) -> None:
        while self._buf:
            self._flush_block(min(len(self._buf), self.MAX_BLOCK))
        self._f.write(BGZF_EOF)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
