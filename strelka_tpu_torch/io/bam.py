"""BAM reader producing struct-of-arrays read batches.

Replaces the reference's htslib-backed `bam_streamer`/`bam_record`
(htsapi/bam_streamer.hh, bam_record.hh). Reads are decoded straight into
numpy struct-of-arrays (codes, quals, cigars as ragged arrays with
offsets) — the layout downstream tiling code pads into device tensors —
rather than per-record C structs walked one at a time.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import decompress_file
from .fasta import BASE_N

# BAM 4-bit seq nibble -> engine base code (A=0 C=1 G=2 T=3 N=4)
# nibble index string is "=ACMGRSVTWYHKDBN" (SAM spec)
_NIB_TO_CODE = np.full(16, BASE_N, dtype=np.uint8)
_NIB_TO_CODE[1] = 0  # A
_NIB_TO_CODE[2] = 1  # C
_NIB_TO_CODE[4] = 2  # G
_NIB_TO_CODE[8] = 3  # T

# sam flags (sam.h)
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QC_FAIL = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]

    def tid_of(self, name: str) -> int:
        return self.ref_names.index(name)


@dataclass
class ReadBatch:
    """Struct-of-arrays batch of alignment records.

    Ragged per-read data (seq, qual, cigar) is stored concatenated with
    [n+1] offset arrays, ready for padded-tile gather onto device.
    """
    n: int = 0
    names: list[str] = field(default_factory=list)
    tid: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    pos: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    mapq: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    flag: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint16))
    mate_tid: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    mate_pos: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    tlen: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    seq: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    qual: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    seq_off: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    cig_ops: np.ndarray = field(default_factory=lambda: np.empty(0, np.int8))
    cig_lens: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    cig_off: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))

    def read_len(self, i: int) -> int:
        return int(self.seq_off[i + 1] - self.seq_off[i])

    def get_seq(self, i: int) -> np.ndarray:
        return self.seq[self.seq_off[i]:self.seq_off[i + 1]]

    def get_qual(self, i: int) -> np.ndarray:
        return self.qual[self.seq_off[i]:self.seq_off[i + 1]]

    def get_cigar(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.cig_off[i], self.cig_off[i + 1]
        return self.cig_ops[s:e], self.cig_lens[s:e]

    def ref_end_positions(self) -> np.ndarray:
        """[n] exclusive reference end of each alignment (pos + CIGAR
        reference span), vectorized over the whole batch. Used to slice
        a chromosome batch down to the reads that can overlap one
        halo'd genome segment."""
        from ..utils.cigar import ADVANCES_REF
        if self.n == 0:
            return np.zeros(0, np.int64)
        adv = ADVANCES_REF[np.clip(self.cig_ops, 0, 8)].astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(adv * self.cig_lens)])
        spans = csum[self.cig_off[1:]] - csum[self.cig_off[:-1]]
        return self.pos + spans

    def select(self, mask_or_idx) -> "ReadBatch":
        idx = np.asarray(mask_or_idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        out = ReadBatch()
        out.n = len(idx)
        out.names = [self.names[i] for i in idx]
        for fld in ("tid", "pos", "mapq", "flag", "mate_tid", "mate_pos", "tlen"):
            setattr(out, fld, getattr(self, fld)[idx])

        contiguous = (len(idx) > 0 and
                      int(idx[-1]) - int(idx[0]) + 1 == len(idx))

        def ragged_gather(data, off):
            lens = (off[idx + 1] - off[idx]).astype(np.int64)
            new_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
            total = int(new_off[-1])
            if total == 0:
                return data[:0].copy(), new_off
            if contiguous:
                # per-chromosome selects etc.: one block copy
                return data[off[idx[0]]:off[idx[-1] + 1]].copy(), new_off
            # flat gather indices: start_i + within-row offset
            # (int32 halves the temporary traffic; ragged payloads
            # stay < 2^31 per batch)
            lens32 = lens.astype(np.int32)
            gi = np.repeat(off[idx].astype(np.int64), lens32)
            gi += np.arange(total, dtype=np.int64)
            gi -= np.repeat(new_off[:-1], lens32)
            return data[gi], new_off

        out.seq, out.seq_off = ragged_gather(self.seq, self.seq_off)
        out.qual, _ = ragged_gather(self.qual, self.seq_off)
        out.cig_ops, out.cig_off = ragged_gather(self.cig_ops, self.cig_off)
        out.cig_lens, _ = ragged_gather(self.cig_lens, self.cig_off)
        return out


def concat_batches(batches: list["ReadBatch"]) -> "ReadBatch":
    """Concatenate record batches (fragment merge for BAM output)."""
    batches = [b for b in batches if b is not None and b.n > 0]
    if not batches:
        return ReadBatch()
    out = ReadBatch()
    out.n = sum(b.n for b in batches)
    out.names = [n for b in batches for n in b.names]
    for fld in ("tid", "pos", "mapq", "flag", "mate_tid", "mate_pos",
                "tlen", "seq", "qual", "cig_ops", "cig_lens"):
        out.__setattr__(fld, np.concatenate([getattr(b, fld)
                                             for b in batches]))

    def offs(name):
        parts = [np.zeros(1, np.int64)]
        base = 0
        for b in batches:
            o = getattr(b, name)
            parts.append(o[1:] + base)
            base += int(o[-1])
        return np.concatenate(parts)

    out.seq_off = offs("seq_off")
    out.cig_off = offs("cig_off")
    return out


def scatter_rewrites(raw: "ReadBatch", keep_idx: np.ndarray,
                     kept: "ReadBatch") -> "ReadBatch":
    """Copy of `raw` with row keep_idx[i]'s (pos, cigar) replaced by
    kept row i's — projects realignment rewrites of the filtered
    subset back onto the full record set for realigned-BAM output."""
    assert kept.n == len(keep_idx)
    pos = raw.pos.copy()
    pos[keep_idx] = kept.pos
    new_nseg = np.diff(raw.cig_off).copy()
    new_nseg[keep_idx] = np.diff(kept.cig_off)
    cig_off = np.concatenate([[0], np.cumsum(new_nseg)]).astype(np.int64)
    cig_ops = np.empty(int(cig_off[-1]), np.int8)
    cig_lens = np.empty(int(cig_off[-1]), np.int32)
    kept_of = {int(r): i for i, r in enumerate(keep_idx)}
    for r in range(raw.n):
        i = kept_of.get(r)
        if i is None:
            o, l = raw.get_cigar(r)
        else:
            o, l = kept.get_cigar(i)
        cig_ops[cig_off[r]:cig_off[r + 1]] = o
        cig_lens[cig_off[r]:cig_off[r + 1]] = l
    out = ReadBatch(
        n=raw.n, names=raw.names, tid=raw.tid, pos=pos, mapq=raw.mapq,
        flag=raw.flag, mate_tid=raw.mate_tid, mate_pos=raw.mate_pos,
        tlen=raw.tlen, seq=raw.seq, qual=raw.qual, seq_off=raw.seq_off,
        cig_ops=cig_ops, cig_lens=cig_lens, cig_off=cig_off)
    return out


def read_alignments(path: str, reference=None,
                    use_native: bool = True) -> tuple[BamHeader, ReadBatch]:
    """Decode a BAM or CRAM alignment file by magic bytes.

    Reference analog: htsapi/bam_streamer.cpp opens either format
    through htslib. `reference` (path or FastaReference) is required
    for reference-compressed CRAM.
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"CRAM":
        from .cram import read_cram
        return read_cram(path, reference)
    return read_bam(path, use_native=use_native)


def read_alignments_regions(path: str, regions, reference=None,
                            ) -> tuple[BamHeader, ReadBatch]:
    """Index-driven region read of a BAM (.bai) or CRAM (.crai) file:
    decodes only the compressed spans/slices the regions touch.
    Raises FileNotFoundError when the file has no usable index."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"CRAM":
        from .cram import read_cram_regions
        return read_cram_regions(path, regions, reference)
    from .bai import read_bam_regions
    return read_bam_regions(path, regions)


def read_bam(path: str, use_native: bool = True) -> tuple[BamHeader, ReadBatch]:
    """Decode a whole BAM file.

    Prefers the native C++ decoder (parallel BGZF inflate + record
    parse, native/bamdecoder.cpp) and falls back to the pure-Python
    path when the shared library is unavailable.
    """
    if use_native:
        try:
            from .native import read_bam_native
            res = read_bam_native(path)
            if res is not None:
                return res
        except (ValueError, OSError):
            pass  # fall through to Python decoder
    data = decompress_file(path)
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    header, off = _parse_header_uncompressed(data)
    return header, parse_bam_body(memoryview(data)[off:], header)


def _parse_header_uncompressed(data) -> tuple[BamHeader, int]:
    """Parse the BAM header section; returns (header, body offset)."""
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4
    text = bytes(data[off:off + l_text]).rstrip(b"\x00").decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names, ref_lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(bytes(data[off:off + l_name - 1]).decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_lengths.append(l_ref)
    return BamHeader(text, ref_names, ref_lengths), off


def read_bam_header_bytes(compressed: bytes) -> tuple[BamHeader, int]:
    """Parse the BAM header from BGZF-compressed bytes, inflating only
    as many leading blocks (one gzip member each) as the header section
    needs. Returns (header, uncompressed header byte count)."""
    import zlib
    out = bytearray()
    pos = 0
    while True:
        try:
            return _parse_header_uncompressed(out)
        except (struct.error, IndexError, UnicodeDecodeError):
            pass
        if len(out) >= 4 and bytes(out[:4]) != b"BAM\x01":
            raise ValueError("not a BAM stream")
        if pos >= len(compressed):
            raise ValueError("truncated BAM header")
        d = zlib.decompressobj(wbits=31)
        out += d.decompress(compressed[pos:])
        consumed = len(compressed) - pos - len(d.unused_data)
        if consumed <= 0:
            raise ValueError("truncated BAM header")
        pos += consumed


def parse_bam_body(data, header: BamHeader) -> ReadBatch:
    """Parse a concatenated BAM alignment-record section (no header)."""
    off = 0

    names: list[str] = []
    tids: list[int] = []
    poss: list[int] = []
    mapqs: list[int] = []
    flags: list[int] = []
    mtids: list[int] = []
    mposs: list[int] = []
    tlens: list[int] = []
    seq_parts: list[np.ndarray] = []
    qual_parts: list[np.ndarray] = []
    op_parts: list[np.ndarray] = []
    len_parts: list[np.ndarray] = []
    seq_off = [0]
    cig_off = [0]

    total = len(data)
    rec = struct.Struct("<iiiBBHHHiiii")
    while off < total:
        try:
            (block_size,) = struct.unpack_from("<i", data, off)
            end = off + 4 + block_size
            if block_size < 32 or end > total:
                raise ValueError(
                    f"truncated/corrupt BAM record at offset {off}: "
                    f"block_size={block_size}, {total - off - 4} bytes "
                    "remain")
            off += 4
            (refID, pos, l_rn_packed, mapq, _bin, n_cigar, flag, l_seq,
             next_refID, next_pos,
             tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
            if (off + 32 + l_rn_packed + 4 * n_cigar
                    + (l_seq + 1) // 2 + l_seq) > end:
                raise ValueError(
                    f"corrupt BAM record at offset {off - 4}: section "
                    f"lengths (name={l_rn_packed} cigar={n_cigar} "
                    f"seq={l_seq}) overrun the record body")
        except struct.error as e:
            raise ValueError(
                f"truncated BAM record section at offset {off} "
                f"({total} bytes total)") from e
        p = off + 32
        name = bytes(data[p:p + l_rn_packed - 1]).decode()
        p += l_rn_packed
        cig = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=p)
        p += 4 * n_cigar
        nyb = np.frombuffer(data, dtype=np.uint8, count=(l_seq + 1) // 2, offset=p)
        p += (l_seq + 1) // 2
        q = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=p)
        p += l_seq
        # tags in data[p:end] — skipped for now
        off = end

        hi = _NIB_TO_CODE[nyb >> 4]
        lo = _NIB_TO_CODE[nyb & 0xF]
        seq = np.empty(2 * len(nyb), dtype=np.uint8)
        seq[0::2] = hi
        seq[1::2] = lo
        seq = seq[:l_seq]

        names.append(name)
        tids.append(refID)
        poss.append(pos)
        mapqs.append(mapq)
        flags.append(flag)
        mtids.append(next_refID)
        mposs.append(next_pos)
        tlens.append(tlen)
        seq_parts.append(seq)
        qual_parts.append(q.copy())
        op_parts.append((cig & 0xF).astype(np.int8))
        len_parts.append((cig >> 4).astype(np.int32))
        seq_off.append(seq_off[-1] + l_seq)
        cig_off.append(cig_off[-1] + n_cigar)
    del rec

    batch = ReadBatch(
        n=len(names),
        names=names,
        tid=np.array(tids, np.int32),
        pos=np.array(poss, np.int64),
        mapq=np.array(mapqs, np.uint8),
        flag=np.array(flags, np.uint16),
        mate_tid=np.array(mtids, np.int32),
        mate_pos=np.array(mposs, np.int64),
        tlen=np.array(tlens, np.int64),
        seq=np.concatenate(seq_parts) if seq_parts else np.empty(0, np.uint8),
        qual=np.concatenate(qual_parts) if qual_parts else np.empty(0, np.uint8),
        seq_off=np.array(seq_off, np.int64),
        cig_ops=np.concatenate(op_parts) if op_parts else np.empty(0, np.int8),
        cig_lens=np.concatenate(len_parts) if len_parts else np.empty(0, np.int32),
        cig_off=np.array(cig_off, np.int64),
    )
    return batch
