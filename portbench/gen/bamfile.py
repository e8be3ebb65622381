"""BAM, BGZF and FASTA writing for the generated inputs, in NumPy.

A frozen copy of the record layout of ``strelka_tpu_torch/io/bam_writer.py``
and of the block layout of ``strelka_tpu_torch/io/bgzf.py``: the same
header (``@HD`` line, one reference), records sorted by position, the
UCSC bin of each alignment span, nibble-packed bases, and BGZF blocks of
at most 0xFF00 bytes ending in the EOF block. The records are laid out
all at once with array indexing instead of one record at a time, and
the blocks are deflated on a few threads (zlib releases the GIL).
"""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
MAX_BLOCK = 0xFF00
_NIBBLE = np.array([1, 2, 4, 8, 15], np.uint8)      # A C G T N
_CIGAR_CODE = {"M": 0, "I": 1, "D": 2}
# fixed part of a record after block_size: refID, pos, l_read_name,
# mapq, bin, n_cigar_op, flag, l_seq, next_refID, next_pos, tlen
_FIXED = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                   ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                   ("next_ref", "<i4"), ("next_pos", "<i4"),
                   ("tlen", "<i4")])


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """UCSC bins of [beg, end) spans (the tabix and BAM scheme)."""
    end = end - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = first + (beg[hit] >> shift)
        done |= hit
    return out


def encode_records(pos, flag, mapq, seq, qual, cig_ops, cig_lens, cig_off,
                   ref_span) -> bytes:
    """The records of reads already in position order: seq and qual are
    [n, read_len] uint8 (codes 0..4, phred), cig_ops / cig_lens the
    flattened CIGARs (op codes M=0, I=1, D=2) with offsets cig_off
    [n + 1]; ref_span [n] is each alignment's reference length."""
    n, rl = seq.shape
    n_cig = np.diff(cig_off)
    name_len = 10                                   # "r" + 8 digits + NUL
    seq_bytes = (rl + 1) // 2
    size = 36 + name_len + 4 * n_cig + seq_bytes + rl
    off = np.zeros(n + 1, np.int64)
    np.cumsum(size, out=off[1:])
    buf = np.zeros(int(off[-1]), np.uint8)

    fixed = np.zeros(n, _FIXED)
    fixed["block_size"] = size - 4
    fixed["pos"] = pos
    fixed["l_name"] = name_len
    fixed["mapq"] = mapq
    fixed["bin"] = reg2bin(pos.astype(np.int64),
                           pos.astype(np.int64) + np.maximum(ref_span, 1))
    fixed["n_cigar"] = n_cig
    fixed["flag"] = flag
    fixed["l_seq"] = rl
    fixed["next_ref"] = -1
    fixed["next_pos"] = -1
    starts = off[:-1]
    buf[starts[:, None] + np.arange(36)] = fixed.view(np.uint8).reshape(n, 36)

    digits = np.arange(n, dtype=np.int64)[:, None] // (
        10 ** np.arange(7, -1, -1, dtype=np.int64)) % 10
    names = np.zeros((n, name_len), np.uint8)
    names[:, 0] = ord("r")
    names[:, 1:9] = ord("0") + digits
    buf[starts[:, None] + 36 + np.arange(name_len)] = names

    words = ((cig_lens.astype(np.uint32) << 4)
             | cig_ops.astype(np.uint32)).astype("<u4").view(np.uint8)
    rec_of = np.repeat(np.arange(n), n_cig)
    k = np.arange(len(cig_ops)) - np.repeat(cig_off[:-1], n_cig)
    dst = (starts[rec_of] + 36 + name_len + 4 * k)[:, None] + np.arange(4)
    buf[dst] = words.reshape(-1, 4)

    nib = _NIBBLE[np.minimum(seq, 4)]
    if rl % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    s0 = starts + 36 + name_len + 4 * n_cig
    buf[s0[:, None] + np.arange(seq_bytes)] = packed
    buf[(s0 + seq_bytes)[:, None] + np.arange(rl)] = qual
    return buf.tobytes()


def _block(chunk: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(chunk) + co.flush()
    header = (struct.pack("<4BI2B", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF)
              + struct.pack("<H", 6) + b"BC"
              + struct.pack("<HH", 2, 12 + 6 + len(comp) + 8 - 1))
    crc = zlib.crc32(chunk) & 0xFFFFFFFF
    return header + comp + struct.pack("<II", crc, len(chunk))


def write_bgzf(path: str, data: bytes, level: int = 6,
               threads: int = 4) -> None:
    """`data` as BGZF blocks of at most MAX_BLOCK bytes, then the EOF
    block."""
    chunks = [data[i:i + MAX_BLOCK] for i in range(0, len(data), MAX_BLOCK)]
    with ThreadPoolExecutor(threads) as ex:
        blocks = list(ex.map(lambda c: _block(c, level), chunks))
    with open(path, "wb") as f:
        for b in blocks:
            f.write(b)
        f.write(BGZF_EOF)


def bam_header(contig: str, length: int) -> bytes:
    text = b"@HD\tVN:1.6\tSO:coordinate\n"
    name = contig.encode() + b"\x00"
    return (b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<i", 1) + struct.pack("<i", len(name)) + name
            + struct.pack("<i", length))


def write_bam(path: str, contig: str, length: int, reads: dict,
              threads: int = 4) -> None:
    """A coordinate-sorted single-contig BAM of `reads` (the arrays of
    gen.genome.ReadSet, already in position order)."""
    body = encode_records(reads["pos"], reads["flag"], reads["mapq"],
                          reads["seq"], reads["qual"], reads["cig_ops"],
                          reads["cig_lens"], reads["cig_off"],
                          reads["ref_span"])
    write_bgzf(path, bam_header(contig, length) + body, threads=threads)


def write_fasta(path: str, contig: str, codes: np.ndarray) -> None:
    """FASTA at 60 bases a line, with its .fai."""
    seq = np.frombuffer(b"ACGTN", np.uint8)[codes]
    n = len(seq)
    lines = -(-n // 60)
    pad = np.full(lines * 61, ord("\n"), np.uint8)
    body = pad.reshape(lines, 61)
    flat = np.zeros(lines * 60, np.uint8)
    flat[:n] = seq
    body[:, :60] = flat.reshape(lines, 60)
    text = body.reshape(-1).tobytes()
    last = n - (lines - 1) * 60
    text = text[:(lines - 1) * 61 + last] + b"\n"
    header = f">{contig}\n".encode()
    with open(path, "wb") as f:
        f.write(header + text)
    with open(path + ".fai", "w") as f:
        f.write(f"{contig}\t{n}\t{len(header)}\t60\t61\n")
