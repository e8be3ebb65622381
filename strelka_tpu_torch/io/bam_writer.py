"""BAM writing (realigned-BAM output).

Reference: htsapi/bam_dumper.hh — writes the realigned reads back out
as BAM for inspection (--realigned-bam workflow option). Serializes a
ReadBatch (optionally with updated positions/CIGARs) into a
BGZF-compressed BAM with proper header and EOF.
"""
from __future__ import annotations

import struct

import numpy as np

from .bam import BamHeader, ReadBatch
from .bgzf import BgzfWriter

_CODE_TO_NIB = np.array([1, 2, 4, 8, 15], dtype=np.uint8)  # A C G T N


def write_bam(path: str, header: BamHeader, batch: ReadBatch,
              sort_by_pos: bool = True) -> None:
    order = (np.lexsort((batch.pos, batch.tid)) if sort_by_pos
             else np.arange(batch.n))
    with BgzfWriter(path) as w:
        text = header.text or ""
        if "@HD" not in text:
            text = "@HD\tVN:1.6\tSO:coordinate\n" + text
        tb = text.encode()
        w.write(b"BAM\x01" + struct.pack("<i", len(tb)) + tb)
        w.write(struct.pack("<i", len(header.ref_names)))
        for name, length in zip(header.ref_names, header.ref_lengths):
            nb = name.encode() + b"\x00"
            w.write(struct.pack("<i", len(nb)) + nb +
                    struct.pack("<i", length))
        blob = _encode_records_native(batch, order)
        if blob is not None:
            w.write(blob)
        else:
            for i in order:
                w.write(_record_bytes(batch, int(i)))


def _encode_records_native(batch: ReadBatch, order: np.ndarray):
    """Serialize all records via native/bamencoder.cpp; None when the
    library is unavailable (Python per-record path is the oracle,
    tests/test_bam_writer.py asserts byte equality)."""
    import ctypes

    from .native import get_lib
    lib = get_lib()
    if lib is None or batch.n == 0:
        return None
    if not hasattr(lib, "_bamenc_bound"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        cp = ctypes.c_char_p
        lib.bam_encode_size.restype = ctypes.c_int64
        lib.bam_encode_size.argtypes = [i64p, i64p, i64p, i64p,
                                        ctypes.c_int64]
        lib.bam_encode_fill.restype = None
        lib.bam_encode_fill.argtypes = [
            i32p, i64p, u8p, u16p, i32p, i64p, i64p,
            u8p, u8p, i64p, i8p, i32p, i64p,
            cp, i64p, i64p, ctypes.c_int64, u8p]
        lib._bamenc_bound = True

    def _p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    names_b = "".join(batch.names).encode()
    name_off = np.zeros(batch.n + 1, np.int64)
    np.cumsum([len(s) for s in batch.names], out=name_off[1:])
    c = np.ascontiguousarray
    seq_off = c(batch.seq_off, dtype=np.int64)
    cig_off = c(batch.cig_off, dtype=np.int64)
    order64 = c(order, dtype=np.int64)
    total = lib.bam_encode_size(
        _p(seq_off, ctypes.c_int64), _p(cig_off, ctypes.c_int64),
        _p(name_off, ctypes.c_int64), _p(order64, ctypes.c_int64),
        batch.n)
    out = np.empty(int(total), np.uint8)
    lib.bam_encode_fill(
        _p(c(batch.tid, dtype=np.int32), ctypes.c_int32),
        _p(c(batch.pos, dtype=np.int64), ctypes.c_int64),
        _p(c(batch.mapq, dtype=np.uint8), ctypes.c_uint8),
        _p(c(batch.flag, dtype=np.uint16), ctypes.c_uint16),
        _p(c(batch.mate_tid, dtype=np.int32), ctypes.c_int32),
        _p(c(batch.mate_pos, dtype=np.int64), ctypes.c_int64),
        _p(c(batch.tlen, dtype=np.int64), ctypes.c_int64),
        _p(c(batch.seq, dtype=np.uint8), ctypes.c_uint8),
        _p(c(batch.qual, dtype=np.uint8), ctypes.c_uint8),
        _p(seq_off, ctypes.c_int64),
        _p(c(batch.cig_ops, dtype=np.int8), ctypes.c_int8),
        _p(c(batch.cig_lens, dtype=np.int32), ctypes.c_int32),
        _p(cig_off, ctypes.c_int64),
        names_b, _p(name_off, ctypes.c_int64),
        _p(order64, ctypes.c_int64), batch.n,
        _p(out, ctypes.c_uint8))
    return out.tobytes()


def _record_bytes(b: ReadBatch, i: int) -> bytes:
    name = b.names[i].encode() + b"\x00"
    ops, lens = b.get_cigar(i)
    seq = b.get_seq(i)
    qual = b.get_qual(i)
    l_seq = len(seq)
    cig = (lens.astype(np.uint32) << 4) | ops.astype(np.uint32)
    nib = _CODE_TO_NIB[np.minimum(seq, 4)]
    packed = np.zeros((l_seq + 1) // 2, dtype=np.uint8)
    packed |= nib[0::2] << 4
    if l_seq > 1:
        packed[:len(nib[1::2])] |= nib[1::2]
    # bin: use reg2bin over the alignment span
    from .tabix import reg2bin
    from ..utils import cigar as cg
    span = cg.ref_span(ops, lens) if len(ops) else 1
    pos = int(b.pos[i])
    bin_ = reg2bin(max(pos, 0), max(pos + max(span, 1), 1))
    body = struct.pack(
        "<iiBBHHHiiii",
        int(b.tid[i]), pos, len(name), int(b.mapq[i]), bin_,
        len(ops), int(b.flag[i]), l_seq,
        int(b.mate_tid[i]), int(b.mate_pos[i]), int(b.tlen[i]))
    payload = (body + name + cig.astype("<u4").tobytes()
               + packed.tobytes() + qual.tobytes())
    return struct.pack("<i", len(payload)) + payload
