"""Tabix (.tbi) index generation for BGZF-compressed VCF output.

Replaces the reference's external `tabix -p vcf` merge step
(strelkaSharedWorkflow.py concatIndexVcf). Implements the TBI format
(htslib tabix spec): UCSC binning scheme over virtual file offsets plus
a 16kb linear index, written as a BGZF-compressed payload.
"""
from __future__ import annotations

import struct

from .bgzf import BgzfWriter

TBI_MAGIC = b"TBI\x01"
FMT_VCF = 2
LINEAR_SHIFT = 14  # 16kb windows


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (tabix spec)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class TabixIndexer:
    """Accumulates (ref_id, beg, end, voff_start, voff_end) per record
    and serializes the .tbi file."""

    def __init__(self, ref_names: list[str]):
        self.ref_names = ref_names
        self._bins: list[dict[int, list[tuple[int, int]]]] = [
            {} for _ in ref_names]
        self._linear: list[dict[int, int]] = [{} for _ in ref_names]

    def add(self, ref_id: int, beg: int, end: int,
            voff_start: int, voff_end: int) -> None:
        b = reg2bin(beg, end)
        chunks = self._bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)  # merge adjacent
        else:
            chunks.append((voff_start, voff_end))
        for w in range(beg >> LINEAR_SHIFT, ((end - 1) >> LINEAR_SHIFT) + 1):
            lin = self._linear[ref_id]
            if w not in lin or voff_start < lin[w]:
                lin[w] = voff_start

    def write(self, path: str) -> None:
        payload = bytearray()
        names_blob = b"".join(n.encode() + b"\x00" for n in self.ref_names)
        payload += struct.pack("<6iI", FMT_VCF, 1, 2, 0, ord("#"), 0,
                               len(names_blob))
        payload += names_blob
        body = bytearray()
        for rid in range(len(self.ref_names)):
            bins = self._bins[rid]
            body += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                body += struct.pack("<Ii", b, len(chunks))
                for cb, ce in chunks:
                    body += struct.pack("<QQ", cb, ce)
            lin = self._linear[rid]
            n_intv = (max(lin) + 1) if lin else 0
            body += struct.pack("<i", n_intv)
            last = 0
            for w in range(n_intv):
                if w in lin:
                    last = lin[w]
                body += struct.pack("<Q", last)
        head = TBI_MAGIC + struct.pack("<i", len(self.ref_names))
        with BgzfWriter(path) as w:
            w.write(bytes(head) + bytes(payload) + bytes(body))


class IndexedVcfWriter:
    """BGZF VCF writer that records tabix index entries per line."""

    def __init__(self, path: str, ref_names: list[str]):
        self._w = BgzfWriter(path)
        self._path = path
        self._idx = TabixIndexer(ref_names)
        self._rid_of = {n: i for i, n in enumerate(ref_names)}

    def write_header(self, text: str) -> None:
        self._w.write(text.encode() if isinstance(text, str) else text)

    def write_record_line(self, line: str) -> None:
        """line: one VCF record (no trailing newline needed)."""
        if not line.endswith("\n"):
            line += "\n"
        fields = line.split("\t", 8)
        chrom = fields[0]
        pos0 = int(fields[1]) - 1
        end = pos0 + max(len(fields[3]), 1)
        # honor END= info for block records
        if len(fields) > 7 and "END=" in fields[7]:
            for kv in fields[7].split(";"):
                if kv.startswith("END="):
                    end = int(kv[4:])
                    break
        v0 = self._w.virtual_offset()
        self._w.write(line.encode())
        v1 = self._w.virtual_offset()
        rid = self._rid_of.get(chrom)
        if rid is not None:
            self._idx.add(rid, pos0, max(end, pos0 + 1), v0, v1)

    def close(self) -> None:
        self._w.close()
        self._idx.write(self._path + ".tbi")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_tbi(path: str):
    """Parse a .tbi file (for tests / region queries)."""
    from .bgzf import decompress_file
    data = decompress_file(path)
    assert data[:4] == TBI_MAGIC
    (n_ref,) = struct.unpack_from("<i", data, 4)
    fmt, col_seq, col_beg, col_end, meta, skip, l_nm = struct.unpack_from(
        "<6iI", data, 8)
    off = 8 + 28
    names = data[off:off + l_nm].rstrip(b"\x00").split(b"\x00")
    off += l_nm
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((cb, ce))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        refs.append((bins, lin))
    return [n.decode() for n in names], refs
