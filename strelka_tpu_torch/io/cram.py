"""CRAM 3.0 reader producing the same ReadBatch batches as the BAM path.

Reference analog: htsapi/bam_streamer reads CRAM transparently through
htslib-1.7 (redist/htslib; cram/cram_decode.c). This is an independent
decoder of the public CRAM 3.0 container format: ITF8/LTF8 varints,
block codecs (raw/gzip/bzip2/lzma/rANS-4x8), the CRAM record model
(data-series encodings, feature-based sequence reconstruction against
the reference, substitution matrix, in-slice mate resolution), emitted
straight into the engine's struct-of-arrays ReadBatch.

Copy of strelka_tpu/io/cram.py: numpy plus the native rANS and slice
decoders (native/cramdecoder.cpp) through the port's own loader
(io/native.py), with a pure-Python fallback per slice.
"""
from __future__ import annotations

import bz2
import lzma
import struct
import zlib

import numpy as np

from .bam import BamHeader, ReadBatch
from .fasta import FastaReference, decode_bases

# ---------------------------------------------------------------- varints


class ByteReader:
    """Sequential reader over one byte buffer (external blocks, headers)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def itf8(self) -> int:
        d = self.data
        p = self.pos
        b = d[p]
        if b < 0x80:
            v, n = b, 1
        elif b < 0xC0:
            v, n = ((b & 0x3F) << 8) | d[p + 1], 2
        elif b < 0xE0:
            v, n = ((b & 0x1F) << 16) | (d[p + 1] << 8) | d[p + 2], 3
        elif b < 0xF0:
            v, n = (((b & 0x0F) << 24) | (d[p + 1] << 16) | (d[p + 2] << 8)
                    | d[p + 3]), 4
        else:
            v, n = (((b & 0x0F) << 28) | (d[p + 1] << 20) | (d[p + 2] << 12)
                    | (d[p + 3] << 4) | (d[p + 4] & 0x0F)), 5
        self.pos = p + n
        if v >= 1 << 31:
            v -= 1 << 32
        return v

    def ltf8(self) -> int:
        d = self.data
        p = self.pos
        b = d[p]
        # number of leading 1 bits selects 0..8 continuation bytes
        k = 0
        m = 0x80
        while k < 8 and (b & m):
            k += 1
            m >>= 1
        v = b & (0xFF >> k) if k < 8 else 0
        for i in range(k):
            v = (v << 8) | d[p + 1 + i]
        self.pos = p + 1 + k
        if v >= 1 << 63:
            v -= 1 << 64
        return v

    def uint32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def int32(self) -> int:
        (v,) = struct.unpack_from("<i", self.data, self.pos)
        self.pos += 4
        return v


class BitReader:
    """MSB-first bit reader over the slice core block."""

    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 7

    def read_bit(self) -> int:
        v = (self.data[self.pos] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.pos += 1
        else:
            self.bit -= 1
        return v

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


# ---------------------------------------------------------------- rANS 4x8

_RANS_BYTE_L = 1 << 23


def _rans_read_freqs(br: ByteReader):
    """Run-length encoded (symbol, freq) table; 12-bit normalized."""
    freqs = {}
    sym = br.byte()
    rle = 0
    while True:
        f = br.byte()
        if f >= 0x80:
            f = ((f & 0x7F) << 8) | br.byte()
        freqs[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = br.byte()
            if nxt == sym + 1:
                rle = br.byte()
                sym = nxt
            elif nxt == 0:
                break
            else:
                sym = nxt
    return freqs


def _rans_table(freqs):
    syms = np.zeros(4096, dtype=np.uint8)
    fr = np.zeros(256, dtype=np.int64)
    cum = np.zeros(256, dtype=np.int64)
    c = 0
    for s in sorted(freqs):
        f = freqs[s]
        fr[s] = f
        cum[s] = c
        syms[c:c + f] = s
        c += f
    return syms, fr, cum


def rans_decode(data: bytes) -> bytes:
    """rANS 4x8 static decoder (CRAM 3.0 codec 4), order 0 and 1.
    Prefers the native decoder (native/cramdecoder.cpp)."""
    out = _rans_decode_native(data)
    if out is not None:
        return out
    return _rans_decode_py(data)


def _rans_decode_native(data: bytes) -> bytes | None:
    import ctypes

    from .native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "rans_decode_4x8"):
        return None
    if len(data) < 9:
        return None
    import struct as _s
    (n_out,) = _s.unpack_from("<I", data, 5)
    out = np.empty(n_out, np.uint8)
    buf = np.frombuffer(data, np.uint8)
    rc = lib.rans_decode_4x8(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n_out))
    if rc != 0:
        return None
    return out.tobytes()


def _rans_decode_py(data: bytes) -> bytes:
    br = ByteReader(data)
    order = br.byte()
    br.uint32()  # compressed size (remaining)
    n_out = br.uint32()
    out = bytearray(n_out)
    if n_out == 0:
        return bytes(out)
    if order == 0:
        syms, fr, cum = _rans_table(_rans_read_freqs(br))
        d = br.data
        p = br.pos
        R = list(struct.unpack_from("<4I", d, p))
        p += 16
        for i in range(n_out):
            j = i & 3
            r = R[j]
            m = r & 0xFFF
            s = syms[m]
            out[i] = s
            r = int(fr[s]) * (r >> 12) + m - int(cum[s])
            while r < _RANS_BYTE_L and p < len(d):
                r = (r << 8) | d[p]
                p += 1
            R[j] = r
        return bytes(out)
    if order != 1:
        raise ValueError(f"rANS order {order} unsupported")
    # order-1: context tables keyed by previous symbol
    tables = {}
    sym = br.byte()
    rle = 0
    while True:
        tables[sym] = _rans_table(_rans_read_freqs(br))
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = br.byte()
            if nxt == sym + 1:
                rle = br.byte()
                sym = nxt
            elif nxt == 0:
                break
            else:
                sym = nxt
    d = br.data
    p = br.pos
    R = list(struct.unpack_from("<4I", d, p))
    p += 16
    isz4 = n_out >> 2
    i4 = [0, isz4, 2 * isz4, 3 * isz4]
    last = [0, 0, 0, 0]
    empty = None
    for _ in range(isz4):
        for j in range(4):
            r = R[j]
            m = r & 0xFFF
            tab = tables.get(last[j])
            if tab is None:
                if empty is None:
                    empty = _rans_table({0: 4096})
                tab = empty
            syms, fr, cum = tab
            s = syms[m]
            out[i4[j]] = s
            r = int(fr[s]) * (r >> 12) + m - int(cum[s])
            while r < _RANS_BYTE_L and p < len(d):
                r = (r << 8) | d[p]
                p += 1
            R[j] = r
            last[j] = s
            i4[j] += 1
    # remainder handled by lane 3
    while i4[3] < n_out:
        r = R[3]
        m = r & 0xFFF
        syms, fr, cum = tables.get(last[3], tables[0])
        s = syms[m]
        out[i4[3]] = s
        r = int(fr[s]) * (r >> 12) + m - int(cum[s])
        while r < _RANS_BYTE_L and p < len(d):
            r = (r << 8) | d[p]
            p += 1
        R[3] = r
        last[3] = s
        i4[3] += 1
    return bytes(out)


# ---------------------------------------------------------------- blocks


def _decompress_block(method: int, data: bytes, raw_size: int) -> bytes:
    if method == 0:
        return data
    if method == 1:
        return zlib.decompress(data, wbits=47)  # gzip or zlib wrapper
    if method == 2:
        return bz2.decompress(data)
    if method == 3:
        return lzma.decompress(data)
    if method == 4:
        return rans_decode(data)
    raise ValueError(f"CRAM block compression method {method} unsupported")


class Block:
    __slots__ = ("content_type", "content_id", "data")

    def __init__(self, content_type, content_id, data):
        self.content_type = content_type
        self.content_id = content_id
        self.data = data


def _read_block(br: ByteReader) -> Block:
    method = br.byte()
    ctype = br.byte()
    cid = br.itf8()
    csize = br.itf8()
    rsize = br.itf8()
    payload = br.bytes(csize)
    br.uint32()  # crc32
    data = _decompress_block(method, payload, rsize)
    if len(data) != rsize:
        raise ValueError(f"CRAM block: raw size {len(data)} != declared {rsize}")
    return Block(ctype, cid, data)


# ---------------------------------------------------------------- encodings


class Encoding:
    """One CRAM data-series encoding, decoding ints/bytes/arrays.

    The same encoding id is interpreted per use: EXTERNAL yields ITF8
    ints for integer series but raw bytes for byte series (spec 13).
    """

    def __init__(self, codec: int, params: bytes):
        self.codec = codec
        br = ByteReader(params)
        if codec == 0:  # NULL
            pass
        elif codec == 1:  # EXTERNAL
            self.cid = br.itf8()
        elif codec == 3:  # HUFFMAN (canonical)
            n = br.itf8()
            self.alphabet = [br.itf8() for _ in range(n)]
            n2 = br.itf8()
            self.lengths = [br.itf8() for _ in range(n2)]
            self._build_huffman()
        elif codec == 4:  # BYTE_ARRAY_LEN
            lc = br.itf8()
            lp = br.bytes(br.itf8())
            vc = br.itf8()
            vp = br.bytes(br.itf8())
            self.len_enc = Encoding(lc, lp)
            self.val_enc = Encoding(vc, vp)
        elif codec == 5:  # BYTE_ARRAY_STOP
            self.stop = br.byte()
            self.cid = br.itf8()
        elif codec == 6:  # BETA
            self.offset = br.itf8()
            self.nbits = br.itf8()
        elif codec == 9:  # GAMMA
            self.offset = br.itf8()
        else:
            raise ValueError(f"CRAM encoding codec {codec} unsupported")

    def serialize(self) -> list[int]:
        """Flat int32 list consumed by the native slice decoder
        (native/cramdecoder.cpp parse_encoding)."""
        c = self.codec
        if c == 0:
            return [0]
        if c == 1:
            return [1, self.cid]
        if c == 3:
            return ([3, len(self.alphabet)] + list(self.alphabet)
                    + [len(self.lengths)] + list(self.lengths))
        if c == 4:
            return [4] + self.len_enc.serialize() + self.val_enc.serialize()
        if c == 5:
            return [5, self.stop, self.cid]
        if c == 6:
            return [6, self.offset, self.nbits]
        if c == 9:
            return [9, self.offset]
        raise ValueError(f"cannot serialize codec {c}")

    def _build_huffman(self):
        # canonical codes: stable-sort symbols by bit length, assign
        # increasing code values (htsjdk/htslib canonical convention)
        pairs = sorted(zip(self.lengths, range(len(self.alphabet))),
                       key=lambda t: t[0])
        self.const = None
        if len(pairs) == 1 and pairs[0][0] == 0:
            self.const = self.alphabet[pairs[0][1]]
            return
        codes = {}
        code = 0
        prev_len = pairs[0][0]
        for ln, idx in pairs:
            code <<= (ln - prev_len)
            prev_len = ln
            codes[(ln, code)] = self.alphabet[idx]
            code += 1
        self.codes = codes
        self.max_len = pairs[-1][0]

    # --- integer series
    def get_int(self, core: BitReader, ext: dict) -> int:
        c = self.codec
        if c == 1:
            return ext[self.cid].itf8()
        if c == 3:
            if self.const is not None:
                return self.const
            ln = 0
            code = 0
            while ln < self.max_len:
                code = (code << 1) | core.read_bit()
                ln += 1
                v = self.codes.get((ln, code))
                if v is not None:
                    return v
            raise ValueError("bad huffman code")
        if c == 6:
            return core.read_bits(self.nbits) - self.offset
        if c == 9:
            n = 0
            while core.read_bit() == 0:
                n += 1
            v = 1
            for _ in range(n):
                v = (v << 1) | core.read_bit()
            return v - self.offset
        raise ValueError(f"codec {self.codec} cannot decode ints")

    # --- single-byte series (FC, BS, BA, QS, MQ-as-byte)
    def get_byte(self, core: BitReader, ext: dict) -> int:
        if self.codec == 1:
            return ext[self.cid].byte()
        return self.get_int(core, ext)

    # --- byte-array series (RN, IN, SC, BB, QQ, tag values)
    def get_bytes(self, core: BitReader, ext: dict, length: int | None = None) -> bytes:
        c = self.codec
        if c == 5:
            r = ext[self.cid]
            d = r.data
            i = d.index(self.stop, r.pos)
            out = d[r.pos:i]
            r.pos = i + 1
            return out
        if c == 4:
            n = self.len_enc.get_int(core, ext)
            return self.val_enc.get_bytes(core, ext, n)
        if c == 1:
            return ext[self.cid].bytes(length)
        # bit-packed byte stream
        return bytes(self.get_byte(core, ext) for _ in range(length))


# ------------------------------------------------------- compression header

_DS_INT = {"BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
           "NF", "TL", "FN", "FP", "DL", "RS", "PD", "HC", "MQ"}
_DS_BYTE = {"FC", "BS", "BA", "QS"}
_DS_ARR = {"RN", "IN", "SC", "BB", "QQ"}


class CompressionHeader:
    def __init__(self, data: bytes):
        br = ByteReader(data)
        # preservation map
        br.itf8()
        n = br.itf8()
        self.read_names = True
        self.ap_delta = True
        self.ref_required = True
        self.sub_matrix = bytes(5)
        self.tag_dict: list[list[tuple[str, str]]] = [[]]
        for _ in range(n):
            key = br.bytes(2).decode()
            if key == "RN":
                self.read_names = bool(br.byte())
            elif key == "AP":
                self.ap_delta = bool(br.byte())
            elif key == "RR":
                self.ref_required = bool(br.byte())
            elif key == "SM":
                self.sub_matrix = br.bytes(5)
            elif key == "TD":
                blob = br.bytes(br.itf8())
                self.tag_dict = []
                for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") \
                        else blob.split(b"\x00"):
                    tags = []
                    for i in range(0, len(line), 3):
                        tags.append((line[i:i + 2].decode(),
                                     chr(line[i + 2])))
                    self.tag_dict.append(tags)
                if not self.tag_dict:
                    self.tag_dict = [[]]
            else:
                raise ValueError(f"unknown preservation key {key}")
        # data series encodings
        br.itf8()
        n = br.itf8()
        self.series: dict[str, Encoding] = {}
        for _ in range(n):
            key = br.bytes(2).decode()
            codec = br.itf8()
            params = br.bytes(br.itf8())
            self.series[key] = Encoding(codec, params)
        # tag encodings
        br.itf8()
        n = br.itf8()
        self.tag_enc: dict[int, Encoding] = {}
        for _ in range(n):
            key = br.itf8()
            codec = br.itf8()
            params = br.bytes(br.itf8())
            self.tag_enc[key] = Encoding(codec, params)
        # substitution decode table: row per ref base ACGTN; 2-bit code
        # -> substituted base, alt order = ACGTN minus ref base
        bases = "ACGTN"
        self.sub_table = {}
        for r, refb in enumerate(bases):
            alts = [b for b in bases if b != refb]
            byte = self.sub_matrix[r]
            row = {}
            for i, alt in enumerate(alts):
                code = (byte >> (6 - 2 * i)) & 3
                row[code] = alt
            self.sub_table[refb] = row


# ---------------------------------------------------------------- records


class _Rec:
    __slots__ = ("bf", "cf", "tid", "pos", "rlen", "rg", "name", "mf",
                 "mate_tid", "mate_pos", "tlen", "nf", "mapq", "seq",
                 "qual", "cig_ops", "cig_lens", "mate")

    def __init__(self):
        self.mate = -1
        self.mate_tid = -1
        self.mate_pos = -1
        self.tlen = 0


_B2C = {c: i for i, c in enumerate("ACGTN")}

# BAM flag bits relevant to mate resolution
_FPAIRED = 0x1
_FUNMAP = 0x4
_FMUNMAP = 0x8
_FREV = 0x10
_FMREV = 0x20


class _SliceHdr:
    __slots__ = ("ref_id", "start", "span", "n_rec", "n_blocks",
                 "embed_ref_cid")


def _parse_slice_header(br: ByteReader) -> _SliceHdr:
    h = _SliceHdr()
    h.ref_id = br.itf8()
    h.start = br.itf8()
    h.span = br.itf8()
    h.n_rec = br.itf8()
    br.ltf8()  # record counter
    h.n_blocks = br.itf8()
    n_ids = br.itf8()
    for _ in range(n_ids):
        br.itf8()
    h.embed_ref_cid = br.itf8()
    br.bytes(16)  # md5
    return h


def _decode_slice(ch: CompressionHeader, hdr: _SliceHdr,
                  blocks: list[Block], ref_getter, counter_base: int):
    """Decode one mapped/unmapped slice into a list of _Rec."""
    ref_id = hdr.ref_id
    start = hdr.start
    n_rec = hdr.n_rec
    embed_ref_cid = hdr.embed_ref_cid

    core = None
    ext: dict[int, ByteReader] = {}
    for b in blocks:
        if b.content_type == 5:
            core = BitReader(b.data)
        elif b.content_type == 4:
            ext[b.content_id] = ByteReader(b.data)

    embedded_ref = None
    if embed_ref_cid >= 0 and embed_ref_cid in ext:
        embedded_ref = ext[embed_ref_cid].data

    S = ch.series
    subs = ch.sub_table

    def refbase(tid: int, p: int) -> str:
        # 1-based CRAM position p
        if embedded_ref is not None:
            i = p - start
            if 0 <= i < len(embedded_ref):
                return chr(embedded_ref[i]).upper()
            return "N"
        return ref_getter(tid, p - 1)

    recs = []
    last_pos = start
    for ri in range(n_rec):
        r = _Rec()
        r.bf = S["BF"].get_int(core, ext)
        cf = S["CF"].get_int(core, ext)
        r.cf = cf
        if ref_id == -2:
            r.tid = S["RI"].get_int(core, ext)
        else:
            r.tid = ref_id
        r.rlen = S["RL"].get_int(core, ext)
        ap = S["AP"].get_int(core, ext)
        if ch.ap_delta:
            r.pos = last_pos + ap
            last_pos = r.pos
        else:
            r.pos = ap
        r.rg = S["RG"].get_int(core, ext)
        if ch.read_names:
            r.name = S["RN"].get_bytes(core, ext).decode()
        else:
            r.name = f"cram.{counter_base + ri}"
        if cf & 0x2:  # detached mate
            r.mf = S["MF"].get_int(core, ext)
            if not ch.read_names:
                r.name = S["RN"].get_bytes(core, ext).decode()
            r.mate_tid = S["NS"].get_int(core, ext)
            r.mate_pos = S["NP"].get_int(core, ext)
            r.tlen = S["TS"].get_int(core, ext)
            # MF carries the mate flags when the encoder stripped them
            # from BF (OR is a no-op when BF kept them)
            if r.mf & 1:
                r.bf |= _FMREV
            if r.mf & 2:
                r.bf |= _FMUNMAP
        elif cf & 0x4:  # mate downstream in this slice
            r.nf = S["NF"].get_int(core, ext)
            r.mate = ri + 1 + r.nf
        # tags
        tl = S["TL"].get_int(core, ext)
        for tag, typ in ch.tag_dict[tl]:
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
            ch.tag_enc[key].get_bytes(core, ext)  # consume, discard
        mapped = not (r.bf & _FUNMAP)
        if mapped:
            _decode_mapped(r, ch, S, core, ext, subs, refbase, cf)
        else:
            seq = bytearray(r.rlen)
            if cf & 0x8:
                seq[:] = b"N" * r.rlen
            else:
                for i in range(r.rlen):
                    seq[i] = S["BA"].get_byte(core, ext)
            r.seq = seq.decode()
            r.mapq = 0
            r.cig_ops = np.zeros(0, np.int8)
            r.cig_lens = np.zeros(0, np.int32)
            if cf & 0x1:
                r.qual = bytes(S["QS"].get_byte(core, ext)
                               for _ in range(r.rlen))
            else:
                r.qual = b"\xff" * r.rlen
        recs.append(r)

    _resolve_mates(recs)
    return recs


def _decode_mapped(r, ch, S, core, ext, subs, refbase, cf):
    nfeat = S["FN"].get_int(core, ext)
    # collect features as (read_pos 1-based, code, payload)
    feats = []
    fpos = 0
    for _ in range(nfeat):
        code = chr(S["FC"].get_byte(core, ext))
        fpos += S["FP"].get_int(core, ext)
        if code == "B":
            b = S["BA"].get_byte(core, ext)
            q = S["QS"].get_byte(core, ext)
            feats.append((fpos, code, (b, q)))
        elif code == "X":
            feats.append((fpos, code, S["BS"].get_byte(core, ext)))
        elif code == "I":
            feats.append((fpos, code, S["IN"].get_bytes(core, ext)))
        elif code == "S":
            feats.append((fpos, code, S["SC"].get_bytes(core, ext)))
        elif code == "D":
            feats.append((fpos, code, S["DL"].get_int(core, ext)))
        elif code == "N":
            feats.append((fpos, code, S["RS"].get_int(core, ext)))
        elif code == "P":
            feats.append((fpos, code, S["PD"].get_int(core, ext)))
        elif code == "H":
            feats.append((fpos, code, S["HC"].get_int(core, ext)))
        elif code == "i":
            feats.append((fpos, code, S["BA"].get_byte(core, ext)))
        elif code == "b":
            feats.append((fpos, code, S["BB"].get_bytes(core, ext)))
        elif code == "q":
            feats.append((fpos, code, S["QQ"].get_bytes(core, ext)))
        elif code == "Q":
            feats.append((fpos, code, S["QS"].get_byte(core, ext)))
        else:
            raise ValueError(f"unknown CRAM feature code {code!r}")
    r.mapq = S["MQ"].get_int(core, ext)

    # reconstruct sequence + cigar
    seq = bytearray(r.rlen)
    quals = bytearray(r.rlen)
    ops: list[int] = []
    lens: list[int] = []

    def add_op(op: int, ln: int):
        if ln <= 0:
            return
        if ops and ops[-1] == op:
            lens[-1] += ln
        else:
            ops.append(op)
            lens.append(ln)

    rp = 0          # 0-based read cursor
    gp = r.pos      # 1-based ref cursor
    for fpos, code, val in feats:
        # gap of matches before this feature
        gap = (fpos - 1) - rp
        if gap > 0:
            for k in range(gap):
                seq[rp + k] = ord(refbase(r.tid, gp + k))
            add_op(0, gap)
            rp += gap
            gp += gap
        if code == "B":
            seq[rp] = val[0]
            quals[rp] = val[1]
            add_op(0, 1)
            rp += 1
            gp += 1
        elif code == "X":
            rb = refbase(r.tid, gp)
            row = subs.get(rb if rb in "ACGTN" else "N", {})
            seq[rp] = ord(row.get(val, "N"))
            add_op(0, 1)
            rp += 1
            gp += 1
        elif code == "I":
            seq[rp:rp + len(val)] = val
            add_op(1, len(val))
            rp += len(val)
        elif code == "i":
            seq[rp] = val
            add_op(1, 1)
            rp += 1
        elif code == "S":
            seq[rp:rp + len(val)] = val
            add_op(4, len(val))
            rp += len(val)
        elif code == "D":
            add_op(2, val)
            gp += val
        elif code == "N":
            add_op(3, val)
            gp += val
        elif code == "P":
            add_op(6, val)
        elif code == "H":
            add_op(5, val)
        elif code == "b":
            seq[rp:rp + len(val)] = val
            add_op(0, len(val))
            rp += len(val)
            gp += len(val)
        elif code == "q":
            quals[rp:rp + len(val)] = val
        elif code == "Q":
            quals[rp] = val
    tail = r.rlen - rp
    if tail > 0:
        for k in range(tail):
            seq[rp + k] = ord(refbase(r.tid, gp + k))
        add_op(0, tail)
    if not ops:
        add_op(0, r.rlen)

    r.seq = seq.decode()
    r.cig_ops = np.asarray(ops, np.int8)
    r.cig_lens = np.asarray(lens, np.int32)
    if cf & 0x1:
        r.qual = bytes(S["QS"].get_byte(core, ext) for _ in range(r.rlen))
    else:
        r.qual = bytes(quals)


def _ref_span(r) -> int:
    span = 0
    for op, ln in zip(r.cig_ops, r.cig_lens):
        if op in (0, 2, 3, 7, 8):
            span += int(ln)
    return span


def _resolve_mates(recs):
    """In-slice mate chains (CF mate-downstream): fill mate coords,
    flags and template size the way htslib cram_decode does."""
    for i, r in enumerate(recs):
        if r.mate < 0 or r.mate >= len(recs):
            continue
        m = recs[r.mate]
        # propagate pair flags both ways along the chain
        r.mate_tid = m.tid
        r.mate_pos = m.pos - 1  # convert to 0-based later uniformly
        if m.bf & _FREV:
            r.bf |= _FMREV
        if m.bf & _FUNMAP:
            r.bf |= _FMUNMAP
        # the chain's last record links back to the first implicitly
        if m.mate < 0:
            m.mate_tid = r.tid if _chain_head(recs, i) is r else m.mate_tid
    # close chains: walk each chain once
    seen = [False] * len(recs)
    for i, r in enumerate(recs):
        if seen[i] or r.mate < 0:
            continue
        chain = [i]
        j = r.mate
        while 0 <= j < len(recs) and recs[j].mate >= 0 and j not in chain:
            chain.append(j)
            j = recs[j].mate
        if 0 <= j < len(recs):
            chain.append(j)
        for k in chain:
            seen[k] = True
        # last record's mate is the first
        last = recs[chain[-1]]
        first = recs[chain[0]]
        if last.mate < 0:
            last.mate_tid = first.tid
            last.mate_pos = first.pos - 1
            if first.bf & _FREV:
                last.bf |= _FMREV
            if first.bf & _FUNMAP:
                last.bf |= _FMUNMAP
        # template size: leftmost..rightmost, sign +/- per position
        if all(recs[k].tid == first.tid for k in chain):
            starts = [recs[k].pos for k in chain]
            ends = [recs[k].pos + max(_ref_span(recs[k]), 1) - 1
                    for k in chain]
            lo = min(starts)
            hi = max(ends)
            tlen = hi - lo + 1
            lo_k = min(chain, key=lambda k: (recs[k].pos, k))
            for k in chain:
                recs[k].tlen = tlen if k == lo_k else -tlen
            if len(chain) == 1:
                recs[chain[0]].tlen = 0


def _chain_head(recs, i):
    return recs[i]


# ----------------------------------------------------- slice -> arrays


class _Chunk:
    """Struct-of-arrays for one decoded slice (0-based positions)."""
    __slots__ = ("n", "names", "tid", "pos", "mapq", "flag", "mate_tid",
                 "mate_pos", "tlen", "seq", "qual", "seq_off",
                 "cig_ops", "cig_lens", "cig_off")


def _recs_to_chunk(recs: list[_Rec]) -> _Chunk:
    from .fasta import encode_bases
    c = _Chunk()
    c.n = len(recs)
    c.names = [r.name for r in recs]
    c.tid = np.array([r.tid for r in recs], np.int32)
    c.pos = np.array([r.pos - 1 for r in recs], np.int64)
    c.mapq = np.array([r.mapq & 0xFF for r in recs], np.uint8)
    c.flag = np.array([r.bf & 0xFFFF for r in recs], np.uint16)
    c.mate_tid = np.array([r.mate_tid for r in recs], np.int32)
    mp = []
    for r in recs:
        if r.mate >= 0 or r.mate_tid >= 0:
            # in-slice resolved mate_pos is already 0-based; detached NP
            # is 1-based per spec
            mp.append(r.mate_pos if r.mate >= 0 else r.mate_pos - 1
                      if (r.cf & 0x2) else r.mate_pos)
        else:
            mp.append(-1)
    c.mate_pos = np.array(mp, np.int64)
    c.tlen = np.array([r.tlen for r in recs], np.int64)
    seqs = [encode_bases(r.seq) for r in recs]
    c.seq = (np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
             ).astype(np.uint8)
    c.qual = (np.concatenate([np.frombuffer(r.qual, np.uint8)
                              for r in recs])
              if recs else np.zeros(0, np.uint8))
    c.seq_off = np.concatenate(
        [[0], np.cumsum([len(r.seq) for r in recs])]).astype(np.int64)
    c.cig_ops = (np.concatenate([r.cig_ops for r in recs])
                 if recs else np.zeros(0, np.int8)).astype(np.int8)
    c.cig_lens = (np.concatenate([r.cig_lens for r in recs])
                  if recs else np.zeros(0, np.int32)).astype(np.int32)
    c.cig_off = np.concatenate(
        [[0], np.cumsum([len(r.cig_ops) for r in recs])]).astype(np.int64)
    return c


# native decoder series order (native/cramdecoder.cpp enum Series)
_NATIVE_SERIES = ("BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS",
                  "NP", "TS", "NF", "TL", "FN", "FC", "FP", "DL", "BB",
                  "QQ", "BS", "IN", "RS", "PD", "HC", "SC", "MQ", "BA",
                  "QS")


def _native_slice_chunk(ch: CompressionHeader, hdr: _SliceHdr,
                        blocks: list[Block], contig_bytes,
                        counter_base: int) -> _Chunk | None:
    """Decode one slice with the native C++ decoder; None on any
    unsupported structure (caller falls back to the Python path)."""
    import ctypes

    from .native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "cram_slice_decode"):
        return None
    if hdr.ref_id == -2:
        return None  # multi-ref slice: per-record reference contigs

    # serialized encodings
    try:
        enc: list[int] = []
        for key in _NATIVE_SERIES:
            e = ch.series.get(key)
            enc.extend([0] if e is None else e.serialize())
        enc.append(len(ch.tag_dict))
        for line in ch.tag_dict:
            enc.append(len(line))
            for tag, typ in line:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                te = ch.tag_enc.get(key)
                if te is None:
                    return None
                enc.extend(te.serialize())
    except ValueError:
        return None
    enc_blob = np.asarray(enc, dtype=np.int32).tobytes()

    core_data = b""
    ext_parts: list[bytes] = []
    ext_ids: list[int] = []
    for blk in blocks:
        if blk.content_type == 5:
            core_data = blk.data
        elif blk.content_type == 4:
            ext_ids.append(blk.content_id)
            ext_parts.append(blk.data)
    ext_buf = b"".join(ext_parts)
    ext_offs = np.zeros(len(ext_parts), np.int64)
    ext_lens = np.array([len(p) for p in ext_parts], np.int64)
    if len(ext_parts):
        np.cumsum(ext_lens[:-1], out=ext_offs[1:])
    ext_ids_arr = np.asarray(ext_ids, np.int32)

    # reference segment: embedded block, or the whole cached contig
    if hdr.embed_ref_cid >= 0 and hdr.embed_ref_cid in ext_ids:
        ref_seg = ext_parts[ext_ids.index(hdr.embed_ref_cid)]
        ref_start = hdr.start
    else:
        ref_seg = contig_bytes(hdr.ref_id)
        ref_start = 1

    # substitution decode table as 5x4 chars
    sub_tab = bytearray(20)
    for r, refb in enumerate("ACGTN"):
        row = ch.sub_table[refb]
        for code in range(4):
            sub_tab[r * 4 + code] = ord(row.get(code, "N"))

    u8p = ctypes.POINTER(ctypes.c_uint8)

    def p8(b):
        return ctypes.cast(ctypes.c_char_p(bytes(b) if not isinstance(b, bytes)
                                           else b), u8p)

    lib.cram_slice_decode.restype = ctypes.c_void_p
    handle = lib.cram_slice_decode(
        p8(core_data), ctypes.c_int64(len(core_data)),
        p8(ext_buf),
        ext_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ext_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ext_ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(ext_ids)),
        p8(enc_blob), ctypes.c_int64(len(enc_blob)),
        p8(ref_seg), ctypes.c_int64(len(ref_seg)),
        ctypes.c_int64(ref_start),
        p8(bytes(sub_tab)),
        ctypes.c_int32(hdr.n_rec), ctypes.c_int32(hdr.ref_id),
        ctypes.c_int64(hdr.start),
        ctypes.c_int32(1 if ch.ap_delta else 0),
        ctypes.c_int32(1 if ch.read_names else 0),
        ctypes.c_int64(counter_base))
    if not handle:
        return None
    try:
        sizes = np.zeros(3, np.int64)
        lib.cram_slice_sizes.restype = ctypes.c_int64
        n = int(lib.cram_slice_sizes(
            ctypes.c_void_p(handle),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))))
        seq_total, cig_total, name_total = (int(x) for x in sizes)
        c = _Chunk()
        c.n = n
        c.tid = np.empty(n, np.int32)
        c.pos = np.empty(n, np.int64)
        c.mapq = np.empty(n, np.uint8)
        c.flag = np.empty(n, np.uint16)
        c.mate_tid = np.empty(n, np.int32)
        c.mate_pos = np.empty(n, np.int64)
        c.tlen = np.empty(n, np.int64)
        c.seq = np.empty(seq_total, np.uint8)
        c.qual = np.empty(seq_total, np.uint8)
        c.seq_off = np.empty(n + 1, np.int64)
        c.cig_ops = np.empty(cig_total, np.int8)
        c.cig_lens = np.empty(cig_total, np.int32)
        c.cig_off = np.empty(n + 1, np.int64)
        names_buf = np.empty(name_total, np.uint8)
        name_off = np.empty(n + 1, np.int64)

        def ap(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        rc = lib.cram_slice_export(
            ctypes.c_void_p(handle),
            ap(c.tid, ctypes.c_int32), ap(c.pos, ctypes.c_int64),
            ap(c.mapq, ctypes.c_uint8), ap(c.flag, ctypes.c_uint16),
            ap(c.mate_tid, ctypes.c_int32), ap(c.mate_pos, ctypes.c_int64),
            ap(c.tlen, ctypes.c_int64),
            ap(c.seq, ctypes.c_uint8), ap(c.qual, ctypes.c_uint8),
            ap(c.seq_off, ctypes.c_int64),
            ap(c.cig_ops, ctypes.c_int8), ap(c.cig_lens, ctypes.c_int32),
            ap(c.cig_off, ctypes.c_int64),
            ap(names_buf, ctypes.c_uint8), ap(name_off, ctypes.c_int64))
        if rc != 0:
            return None
        nb = names_buf.tobytes()
        c.names = [nb[name_off[i]:name_off[i + 1] - 1].decode()
                   for i in range(n)]
        return c
    finally:
        lib.cram_slice_free(ctypes.c_void_p(handle))


# ---------------------------------------------------------------- driver


def read_crai(path: str):
    """Parse a .crai index: list of (seq_id, start0, span, container_off,
    slice_off, slice_len) per slice (CRAM spec appendix; gzip text)."""
    import gzip
    entries = []
    with gzip.open(path, "rt") as f:
        for line in f:
            parts = line.split()
            if len(parts) != 6:
                continue
            seq_id, start, span, coff, soff, slen = (int(x) for x in parts)
            entries.append((seq_id, start - 1 if start > 0 else 0, span,
                            coff, soff, slen))
    return entries


def read_cram_regions(path: str, regions,
                      reference: str | FastaReference | None = None,
                      ) -> tuple[BamHeader, ReadBatch]:
    """Decode only the slices overlapping `regions` using the .crai
    index, then filter records to span overlap — the CRAM analog of
    bai.read_bam_regions. Raises FileNotFoundError when no index."""
    import os
    crai = path + ".crai"
    if not os.path.exists(crai):
        base, _ = os.path.splitext(path)
        if os.path.exists(base + ".crai"):
            crai = base + ".crai"
        else:
            raise FileNotFoundError(f"no index for {path}")
    header, batch = read_cram(path, reference, _crai_entries=read_crai(crai),
                              _regions=regions)
    ends = batch.ref_end_positions()
    keep = np.zeros(batch.n, dtype=bool)
    for chrom, beg, end in regions:
        if chrom not in header.ref_names:
            continue
        tid = header.ref_names.index(chrom)
        keep |= (batch.tid == tid) & (batch.pos < end) & (ends > beg)
    if not keep.all():
        batch = batch.select(keep)
    return header, batch


def read_cram(path: str, reference: str | FastaReference | None = None,
              _crai_entries=None, _regions=None,
              ) -> tuple[BamHeader, ReadBatch]:
    """Decode a whole CRAM 3.0 file into (BamHeader, ReadBatch).

    `reference` is required unless every slice embeds its reference or
    the file was written reference-less (RR=false with verbatim bases).
    When _crai_entries/_regions are given (via read_cram_regions), data
    containers holding no overlapping slice are skipped wholesale.

    Truncated/corrupt input raises ValueError (low-level parse and
    codec errors never leak).
    """
    import lzma
    import zlib
    try:
        return _read_cram_impl(path, reference, _crai_entries, _regions)
    except (struct.error, zlib.error, lzma.LZMAError, IndexError,
            KeyError, AssertionError, UnicodeDecodeError,
            OverflowError) as e:
        # (MemoryError deliberately not converted: a large valid CRAM
        # on a constrained host is not "corrupt input")
        raise ValueError(f"{path}: truncated or corrupt CRAM "
                         f"({type(e).__name__}: {e})") from e


def _read_cram_impl(path, reference, _crai_entries, _regions):
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"CRAM":
        raise ValueError(f"{path}: not a CRAM file")
    major, minor = data[4], data[5]
    if major != 3:
        raise ValueError(f"{path}: CRAM {major}.{minor} unsupported (need 3.x)")
    br = ByteReader(data)
    br.pos = 26  # magic + version + 20-byte file id

    fasta = None
    if isinstance(reference, FastaReference):
        fasta = reference
    elif isinstance(reference, str):
        fasta = FastaReference(reference)

    header: BamHeader | None = None
    contig_cache: dict[int, bytes] = {}

    def contig_bytes(tid: int) -> bytes:
        if fasta is None or tid < 0:
            return b""
        if tid not in contig_cache:
            name = header.ref_names[tid]
            contig_cache[tid] = decode_bases(fasta.load_contig(name)).encode()
        return contig_cache[tid]

    def ref_getter(tid: int, pos0: int) -> str:
        s = contig_bytes(tid)
        if 0 <= pos0 < len(s):
            return chr(s[pos0])
        return "N"

    wanted_offsets = None
    if _crai_entries is not None and _regions is not None:
        # filled once the header names are known (crai uses seq ids)
        wanted_offsets = set()
        reg_spans = _regions

    chunks: list[_Chunk] = []
    counter = 0
    while br.pos < len(data):
        container_offset = br.pos
        # container header
        length = br.int32()
        ref_seq_id = br.itf8()
        br.itf8()   # start pos
        br.itf8()   # span
        n_records = br.itf8()
        br.ltf8()   # record counter
        br.ltf8()   # n bases
        n_blocks = br.itf8()
        n_land = br.itf8()
        for _ in range(n_land):
            br.itf8()
        br.uint32()  # crc
        body_end = br.pos + length
        if ref_seq_id == -1 and n_records == 0 and n_blocks == 1 \
                and length == 15:
            break  # EOF container
        if header is not None and wanted_offsets is not None \
                and container_offset not in wanted_offsets:
            br.pos = body_end
            continue
        blocks = [_read_block(br) for _ in range(n_blocks)]
        assert br.pos == body_end, (br.pos, body_end)
        if header is None:
            # first container: SAM header block (int32 len + text)
            hd = blocks[0].data
            (tlen,) = struct.unpack_from("<i", hd, 0)
            text = hd[4:4 + tlen].decode()
            names, lengths = [], []
            for line in text.splitlines():
                if line.startswith("@SQ"):
                    d = dict(fld.split(":", 1) for fld in line.split("\t")[1:]
                             if ":" in fld)
                    names.append(d["SN"])
                    lengths.append(int(d["LN"]))
            header = BamHeader(text.rstrip("\x00"), names, lengths)
            if wanted_offsets is not None:
                for chrom, beg, end in reg_spans:
                    if chrom not in names:
                        continue
                    tid = names.index(chrom)
                    for (sid, s0, span, coff, _soff, _slen) in _crai_entries:
                        if sid == tid and s0 < end and s0 + span > beg:
                            wanted_offsets.add(coff)
            continue
        # data container: compression header + slices
        ch = CompressionHeader(blocks[0].data)
        bi = 1
        while bi < len(blocks):
            sh = blocks[bi]
            if sh.content_type not in (2, 3):
                raise ValueError(f"expected slice header, got type "
                                 f"{sh.content_type}")
            hdr = _parse_slice_header(ByteReader(sh.data))
            sblocks = blocks[bi + 1: bi + 1 + hdr.n_blocks]
            chunk = _native_slice_chunk(ch, hdr, sblocks, contig_bytes,
                                        counter)
            if chunk is None:
                recs = _decode_slice(ch, hdr, sblocks, ref_getter, counter)
                chunk = _recs_to_chunk(recs)
            counter += chunk.n
            chunks.append(chunk)
            bi += 1 + hdr.n_blocks

    if header is None:
        raise ValueError(f"{path}: no SAM header container found")

    return header, _chunks_to_batch(chunks)


def _chunks_to_batch(chunks: list["_Chunk"]) -> ReadBatch:
    b = ReadBatch()
    b.n = sum(c.n for c in chunks)
    b.names = [nm for c in chunks for nm in c.names]

    def cat(field, dtype):
        arrs = [getattr(c, field) for c in chunks]
        if not arrs:
            return np.zeros(0, dtype)
        return np.concatenate(arrs).astype(dtype, copy=False)

    b.tid = cat("tid", np.int32)
    b.pos = cat("pos", np.int64)
    b.mapq = cat("mapq", np.uint8)
    b.flag = cat("flag", np.uint16)
    b.mate_tid = cat("mate_tid", np.int32)
    b.mate_pos = cat("mate_pos", np.int64)
    b.tlen = cat("tlen", np.int64)
    b.seq = cat("seq", np.uint8)
    b.qual = cat("qual", np.uint8)
    b.cig_ops = cat("cig_ops", np.int8)
    b.cig_lens = cat("cig_lens", np.int32)

    def cat_off(field):
        out = [np.zeros(1, np.int64)]
        base = 0
        for c in chunks:
            off = getattr(c, field)
            out.append(off[1:] + base)
            base += int(off[-1])
        return np.concatenate(out)

    b.seq_off = cat_off("seq_off")
    b.cig_off = cat_off("cig_off")
    return b
