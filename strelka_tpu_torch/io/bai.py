"""BAI-indexed region reads: decode only the BGZF blocks a region needs.

Reference analog: htslib's bam index (hts.c/index.c) as used by
htsapi/bam_streamer::resetRegion — the reference opens one 12Mb segment
per process via the index instead of streaming the whole file. Here the
index drives which compressed spans are inflated (natively, in
parallel) before the struct-of-arrays record parse; the result is the
same ReadBatch the whole-file path produces, restricted to reads
overlapping the requested spans.

BAI format (SAM spec §5.2): per reference a UCSC R-tree binning index
(bin -> chunks as virtual-offset pairs) plus a 16kb linear index used
to prune chunks that end before the first read overlapping the region.
"""
from __future__ import annotations

import struct

import numpy as np

_BAI_MAGIC = b"BAI\x01"
_MAX_BIN = 37450  # ((1<<18)-1)/7 + 1: metadata pseudo-bin id


def _reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) (SAM spec reg2bins)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BaiIndex:
    """Parsed .bai file: per-ref {bin: [(vbeg, vend)]} + linear index."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != _BAI_MAGIC:
            raise ValueError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.bins: list[dict[int, np.ndarray]] = []
        self.linear: list[np.ndarray] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bmap: dict[int, np.ndarray] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = np.frombuffer(data, dtype="<u8", count=2 * n_chunk,
                                       offset=off).reshape(n_chunk, 2)
                off += 16 * n_chunk
                if bin_id != _MAX_BIN:  # skip metadata pseudo-bin
                    bmap[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioff = np.frombuffer(data, dtype="<u8", count=n_intv, offset=off)
            off += 8 * n_intv
            self.bins.append(bmap)
            self.linear.append(ioff)

    def chunks_for(self, tid: int, beg: int, end: int) -> list[tuple[int, int]]:
        """Merged (vbeg, vend) virtual-offset chunks for one region."""
        if tid < 0 or tid >= len(self.bins):
            return []
        bmap = self.bins[tid]
        lin = self.linear[tid]
        min_off = 0
        li = beg >> 14
        if li < len(lin):
            min_off = int(lin[li])
        elif len(lin):
            min_off = int(lin[-1])
        chunks = []
        for b in _reg2bins(beg, end):
            c = bmap.get(b)
            if c is None:
                continue
            for vbeg, vend in c:
                if int(vend) > min_off:
                    chunks.append((int(vbeg), int(vend)))
        chunks.sort()
        return _merge_voffset_ranges(chunks)


def _merge_voffset_ranges(chunks: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for vbeg, vend in chunks:
        # also merge chunks whose compressed blocks touch/overlap, so a
        # block is never inflated twice
        if merged and vbeg >> 16 <= merged[-1][1] >> 16:
            merged[-1][1] = max(merged[-1][1], vend)
        else:
            merged.append([vbeg, vend])
    return [(a, b) for a, b in merged]


def _inflate_span(data: bytes, vbeg: int, vend: int) -> bytes:
    """Inflate the BGZF blocks covering virtual offsets [vbeg, vend)
    and trim to the in-block byte offsets."""
    from .bgzf import decompress_stream  # python fallback
    from .native import decompress_bgzf_native

    cbeg, ubeg = vbeg >> 16, vbeg & 0xFFFF
    cend, uend = vend >> 16, vend & 0xFFFF
    if uend == 0:
        # vend points at the start of block cend: nothing of that block
        span = data[cbeg:cend]
        out = decompress_bgzf_native(span)
        if out is None:
            out = decompress_stream(span)
        return out[ubeg:]
    # need block at cend inclusive: find its compressed length
    (xlen,) = struct.unpack_from("<H", data, cend + 10)
    # BSIZE extra field: scan subfields
    p = cend + 12
    endx = p + xlen
    bsize = None
    while p < endx:
        si1, si2, slen = data[p], data[p + 1], struct.unpack_from("<H", data, p + 2)[0]
        if si1 == 66 and si2 == 67:
            bsize = struct.unpack_from("<H", data, p + 4)[0] + 1
            break
        p += 4 + slen
    if bsize is None:
        raise ValueError("BGZF block without BSIZE field")
    span = data[cbeg:cend + bsize]
    out = decompress_bgzf_native(span)
    if out is None:
        out = decompress_stream(span)
    # trim: drop ubeg bytes of first block, keep through uend of last
    last_block_isize = struct.unpack_from("<I", data,
                                          cend + bsize - 4)[0]
    return out[ubeg:len(out) - (last_block_isize - uend)]


def read_bam_regions(path: str, regions, header=None):
    """Decode only the reads overlapping `regions` using the .bai index.

    regions: list of (chrom, beg, end) half-open 0-based spans.
    Returns (BamHeader, ReadBatch) with each overlapping read exactly
    once (records whose alignment span intersects any region).
    Raises FileNotFoundError when no .bai exists.
    """
    import os

    from .bam import read_bam_header_bytes
    from .native import parse_bam_body_native

    bai_path = path + ".bai"
    if not os.path.exists(bai_path):
        base, ext = os.path.splitext(path)
        alt = base + ".bai"
        if os.path.exists(alt):
            bai_path = alt
        else:
            raise FileNotFoundError(f"no index for {path}")
    idx = BaiIndex(bai_path)

    with open(path, "rb") as f:
        data = f.read()
    header, _body_voffset = read_bam_header_bytes(data)

    # per-tid span lists
    spans: dict[int, list[tuple[int, int]]] = {}
    for chrom, beg, end in regions:
        if chrom not in header.ref_names:
            continue
        spans.setdefault(header.ref_names.index(chrom), []).append((beg, end))

    all_chunks: list[tuple[int, int]] = []
    for tid, sp in spans.items():
        for beg, end in sp:
            all_chunks.extend(idx.chunks_for(tid, beg, end))
    all_chunks.sort()
    all_chunks = _merge_voffset_ranges(all_chunks)

    parts = [_inflate_span(data, vb, ve) for vb, ve in all_chunks]
    body = b"".join(parts)
    res = parse_bam_body_native(body, header)
    if res is None:
        from .bam import parse_bam_body
        res = parse_bam_body(body, header)
    batch = res

    # keep reads whose [pos, ref_end) intersects a requested span
    keep = np.zeros(batch.n, dtype=bool)
    ends = batch.ref_end_positions()
    for tid, sp in spans.items():
        on_tid = batch.tid == tid
        for beg, end in sp:
            keep |= on_tid & (batch.pos < end) & (ends > beg)
    # unmapped-with-coordinate mates placed inside a span also count
    # (they carry pos but no cigar -> ends == pos; treat as 1bp)
    if not keep.all():
        batch = batch.select(keep)
    return header, batch
