"""ctypes bindings for the host library built from native/*.cpp.

The port loads the same host C++ library as the JAX package (the
library is host code, not device code), through this loader of its
own. The C++ library (native/bamdecoder.cpp) inflates independent BGZF
blocks across a thread pool and parses BAM records into preallocated
struct-of-arrays numpy buffers. Falls back to the pure-Python path
when the shared library is absent.
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

_LIB = None
_LIB_CHECKED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIB_PATHS = [
    os.path.join(_REPO_ROOT, "native", "libstrelka_tpu_native.so"),
    os.path.join(os.path.dirname(__file__), "libstrelka_tpu_native.so"),
]


def _build_library() -> str | None:
    """Best-effort build of the native library if a toolchain exists."""
    import subprocess
    makedir = os.path.join(_REPO_ROOT, "native")
    if not os.path.exists(os.path.join(makedir, "Makefile")):
        return None
    try:
        subprocess.run(["make", "-C", makedir], check=True,
                       capture_output=True, timeout=120)
    except Exception:  # noqa: BLE001
        return None
    p = LIB_PATHS[0]
    return p if os.path.exists(p) else None


def get_lib():
    global _LIB, _LIB_CHECKED
    if _LIB_CHECKED:
        return _LIB
    _LIB_CHECKED = True
    path = next((p for p in LIB_PATHS if os.path.exists(p)), None)
    if path is None:
        path = _build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bgzf_scan.restype = ctypes.c_int64
    lib.bgzf_scan.argtypes = [u8p, ctypes.c_int64, i64p, i64p, i64p,
                              ctypes.c_int64]
    lib.bgzf_inflate_blocks.restype = ctypes.c_int32
    lib.bgzf_inflate_blocks.argtypes = [u8p, i64p, i64p, i64p, i64p,
                                        ctypes.c_int64, u8p, ctypes.c_int32]
    lib.bam_count_records.restype = ctypes.c_int64
    lib.bam_count_records.argtypes = [u8p, ctypes.c_int64, i64p, i64p, i64p]
    lib.bam_parse_records.restype = ctypes.c_int32
    lib.bam_parse_records.argtypes = [
        u8p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), i64p, u8p,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
        i64p, i64p,
        u8p, u8p, i64p,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32), i64p,
        u8p, i64p,
    ]
    _LIB = lib
    return _LIB


class _ArenaPool:
    """Reusable page-resident scratch arenas for the big pileup tiles.

    Large fresh allocations on this VM page-fault in at ~50MB/s, so
    re-zeroing an already-resident arena is ~100x cheaper than
    np.zeros per region. An arena is free again once no carved view
    keeps it alive (refcount check), which stays safe when callers
    hold PileupRegions from several samples at once: each live region
    pins its own arena.
    """

    # acquires an arena may sit idle before it is dropped: large enough
    # that the per-region working set (pileup tile / staging / output
    # arenas, a handful of acquires per region) always survives, small
    # enough that a one-off depth-spike arena is returned to the OS
    # within a few regions instead of pinning peak memory for the
    # process lifetime
    MAX_IDLE = 32

    def __init__(self, max_arenas: int = 8):
        self._arenas: list[np.ndarray] = []
        self._idle: dict[int, int] = {}
        self._max = max_arenas

    def _free(self, a, sys) -> bool:
        # refs when free: list entry + caller's loop binding + this
        # method's `a` parameter + getrefcount's argument == 4
        # (the old inline check used 3; moving it into a method adds
        # the parameter binding — miscounting this silently disables
        # all reuse, see test_arena_pool_reuse)
        return sys.getrefcount(a) == 4

    def acquire(self, nbytes: int) -> np.ndarray:
        import sys
        best = None
        for a in self._arenas:
            if a.nbytes >= nbytes and self._free(a, sys):
                if best is None or a.nbytes < best.nbytes:
                    best = a
        if best is None:
            best = np.empty(nbytes, np.uint8)
            self._arenas.append(best)
        self._idle[id(best)] = 0
        # age every other free arena; drop the stale and the over-cap
        stale = []
        frees = []
        for a in self._arenas:
            if a is best or not self._free(a, sys):
                continue
            n = self._idle.get(id(a), 0) + 1
            self._idle[id(a)] = n
            (stale if n > self.MAX_IDLE else frees).append(a)
        n_over = len(self._arenas) - len(stale) - self._max
        if n_over > 0:
            stale.extend(sorted(frees, key=lambda x: x.nbytes)[:n_over])
        if stale:
            # identity-based removal (list.remove would broadcast ==)
            drop = {id(a) for a in stale}
            self._arenas = [x for x in self._arenas if id(x) not in drop]
            for i in drop:
                self._idle.pop(i, None)
        return best


_TILE_POOL = _ArenaPool()
# staging arenas for chunked device launches (models/snv_digt.py):
# sized for the launch pipeline depth, where each in-flight chunk pins
# one arena via its zero-copied views
_STAGE_POOL = _ArenaPool(max_arenas=12)


def _carve(arena: np.ndarray, specs):
    """Carve 64-byte-aligned views of (shape, dtype) out of an arena
    (contents left as-is); returns the list of views."""
    out = []
    off = 0
    for shape, dt in specs:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        v = arena[off:off + n].view(dt).reshape(shape)
        out.append(v)
        off += (n + 63) & ~63
    return out


def _carve_zeroed(arena: np.ndarray, specs):
    """Carve 64-byte-aligned zeroed views of (shape, dtype) out of an
    arena; returns the list of views."""
    out = _carve(arena, specs)
    off = 0
    for shape, dt in specs:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        off += (n + 63) & ~63
    arena[:off].fill(0)
    return out


def _carve_size(specs) -> int:
    off = 0
    for shape, dt in specs:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        off += (n + 63) & ~63
    return off


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def decompress_bgzf_native(data: bytes, n_threads: int = 8) -> bytes | None:
    """Parallel BGZF inflate; None if library unavailable or not BGZF."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    max_blocks = max(len(data) // 64, 16)
    offs = np.zeros(max_blocks, np.int64)
    csizes = np.zeros(max_blocks, np.int64)
    isizes = np.zeros(max_blocks, np.int64)
    n = lib.bgzf_scan(_p(buf, ctypes.c_uint8), len(data),
                      _p(offs, ctypes.c_int64), _p(csizes, ctypes.c_int64),
                      _p(isizes, ctypes.c_int64), max_blocks)
    if n <= 0:
        return None
    out_offs = np.zeros(n, np.int64)
    np.cumsum(isizes[:n - 1], out=out_offs[1:])
    total = int(out_offs[-1] + isizes[n - 1])
    out = np.empty(total, np.uint8)
    rc = lib.bgzf_inflate_blocks(
        _p(buf, ctypes.c_uint8), _p(offs, ctypes.c_int64),
        _p(csizes, ctypes.c_int64), _p(out_offs, ctypes.c_int64),
        _p(isizes, ctypes.c_int64), n, _p(out, ctypes.c_uint8),
        n_threads)
    if rc != 0:
        return None
    return out.tobytes()


def parse_bam_native(data: bytes):
    """Parse a decompressed BAM byte string with the native parser.

    Returns the same (header, ReadBatch) as io.bam.read_bam, or None
    when the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    from .bam import BamHeader, ReadBatch

    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4
    text = data[off:off + l_text].rstrip(b"\x00").decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names, ref_lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(data[off:off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_lengths.append(l_ref)
    header = BamHeader(text, ref_names, ref_lengths)
    batch = parse_bam_body_native(np.frombuffer(data, dtype=np.uint8,
                                                offset=off))
    if batch is None:
        return None
    return header, batch


def parse_bam_body_native(body_bytes, header=None):
    """Parse a concatenated BAM record section (no header) natively.

    Returns a ReadBatch, or None when the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    from .bam import ReadBatch

    body = np.frombuffer(body_bytes, dtype=np.uint8)
    total_seq = np.zeros(1, np.int64)
    total_cig = np.zeros(1, np.int64)
    total_name = np.zeros(1, np.int64)
    n = lib.bam_count_records(_p(body, ctypes.c_uint8), len(body),
                              _p(total_seq, ctypes.c_int64),
                              _p(total_cig, ctypes.c_int64),
                              _p(total_name, ctypes.c_int64))
    if n < 0:
        raise ValueError("truncated BAM alignment section")
    ts, tc, tn = int(total_seq[0]), int(total_cig[0]), int(total_name[0])

    tid = np.empty(n, np.int32)
    pos = np.empty(n, np.int64)
    mapq = np.empty(n, np.uint8)
    flag = np.empty(n, np.uint16)
    mate_tid = np.empty(n, np.int32)
    mate_pos = np.empty(n, np.int64)
    tlen = np.empty(n, np.int64)
    seq = np.empty(ts, np.uint8)
    qual = np.empty(ts, np.uint8)
    seq_off = np.empty(n + 1, np.int64)
    cig_ops = np.empty(tc, np.int8)
    cig_lens = np.empty(tc, np.int32)
    cig_off = np.empty(n + 1, np.int64)
    names_buf = np.empty(tn, np.uint8)
    name_off = np.empty(n + 1, np.int64)

    rc = lib.bam_parse_records(
        _p(body, ctypes.c_uint8), len(body),
        _p(tid, ctypes.c_int32), _p(pos, ctypes.c_int64),
        _p(mapq, ctypes.c_uint8), _p(flag, ctypes.c_uint16),
        _p(mate_tid, ctypes.c_int32), _p(mate_pos, ctypes.c_int64),
        _p(tlen, ctypes.c_int64),
        _p(seq, ctypes.c_uint8), _p(qual, ctypes.c_uint8),
        _p(seq_off, ctypes.c_int64),
        _p(cig_ops, ctypes.c_int8), _p(cig_lens, ctypes.c_int32),
        _p(cig_off, ctypes.c_int64),
        _p(names_buf, ctypes.c_uint8), _p(name_off, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError("BAM record parse error")

    names_bytes = names_buf.tobytes()
    names = [names_bytes[name_off[i]:name_off[i + 1] - 1].decode()
             for i in range(n)]
    batch = ReadBatch(
        n=int(n), names=names, tid=tid, pos=pos, mapq=mapq, flag=flag,
        mate_tid=mate_tid, mate_pos=mate_pos, tlen=tlen,
        seq=seq, qual=qual, seq_off=seq_off,
        cig_ops=cig_ops, cig_lens=cig_lens, cig_off=cig_off,
    )
    return batch


def read_bam_native(path: str, n_threads: int = 8):
    """Native end-to-end BAM read; None if library unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        raw = f.read()
    data = decompress_bgzf_native(raw, n_threads)
    if data is None:
        return None
    return parse_bam_native(data)


def pileup_native(batch, level, ref_codes, ref_offset,
                  region_begin, region_end, min_qscore,
                  mapq_adjust=True, mm_flank=20, mm_max=2, t2_mm_max=None,
                  exempt_keys=None, depth_pad=8):
    """Native single-pass pileup build (native/pileup.cpp).

    Returns a pipeline.pileup.PileupRegion or None when the library is
    unavailable. Matches the Python expand+MMDF+scatter pipeline.
    """
    lib = get_lib()
    if lib is None or batch.n == 0:
        return None
    from ..pipeline.pileup import PileupRegion

    if not hasattr(lib, "_pileup_bound"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.pileup_scan.restype = ctypes.c_int64
        lib.pileup_scan.argtypes = [
            i64p, u8p, u16p, i8p, i64p, u8p, u8p, i64p, i8p, i32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.pileup_fill.restype = ctypes.c_int32
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.pileup_fill.argtypes = [
            i64p, u8p, u16p, i8p, i64p, u8p, u8p, i64p, i8p, i32p,
            ctypes.c_int64,
            u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i64p, ctypes.c_int64,
            ctypes.c_int32, i32p,
            i8p, i16p, i16p, u8p, i32p, i32p, u8p, u8p, u8p, u8p,
            i32p, i32p, i32p, f64p, i32p, i32p, i32p, i64p]
        lib._pileup_bound = True

    L = region_end - region_begin
    level = np.ascontiguousarray(level, dtype=np.int8)
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    pos = np.ascontiguousarray(batch.pos, dtype=np.int64)
    mapq = np.ascontiguousarray(batch.mapq, dtype=np.uint8)
    flag = np.ascontiguousarray(batch.flag, dtype=np.uint16)
    seq_off = np.ascontiguousarray(batch.seq_off, dtype=np.int64)
    cig_off = np.ascontiguousarray(batch.cig_off, dtype=np.int64)
    cig_ops = np.ascontiguousarray(batch.cig_ops, dtype=np.int8)
    cig_lens = np.ascontiguousarray(batch.cig_lens, dtype=np.int32)
    seq = np.ascontiguousarray(batch.seq, dtype=np.uint8)
    qual = np.ascontiguousarray(batch.qual, dtype=np.uint8)

    depth = np.zeros(L, np.int32)
    args1 = (
        _p(pos, ctypes.c_int64), _p(mapq, ctypes.c_uint8),
        _p(flag, ctypes.c_uint16), _p(level, ctypes.c_int8),
        _p(seq_off, ctypes.c_int64), _p(seq, ctypes.c_uint8),
        _p(qual, ctypes.c_uint8), _p(cig_off, ctypes.c_int64),
        _p(cig_ops, ctypes.c_int8), _p(cig_lens, ctypes.c_int32),
        batch.n, region_begin, region_end, _p(depth, ctypes.c_int32))
    max_d = lib.pileup_scan(*args1)
    D = max(int(max_d), 1)
    D = ((D + depth_pad - 1) // depth_pad) * depth_pad

    if exempt_keys is None or len(exempt_keys) == 0:
        ek = np.zeros(1, np.int64)
        n_ek = 0
    else:
        ek = np.ascontiguousarray(np.sort(np.asarray(exempt_keys, np.int64)))
        n_ek = len(ek)

    tile_specs = [((L, D), dt) for dt in
                  (np.int8, np.int16, np.int16, np.uint8, np.int32,
                   np.int32, np.uint8, np.uint8, np.uint8, np.uint8)]
    # tiles are handed to pileup_fill UNINITIALIZED: the native fill
    # writes every lane below each row's depth and zeroes the tails
    # per stripe (threaded, pages warm) — a Python-side whole-arena
    # fill was the top cost of indel-dense regions on this VM
    arena = _TILE_POOL.acquire(_carve_size(tile_specs))
    (t_base, t_qual, t_rawq, t_fwd, t_ridx, t_roff, t_valid, t_used,
     t_t2used, t_nbmm) = _carve(arena, tile_specs)
    spandel = np.zeros(L, np.int32)
    submapped = np.zeros(L, np.int32)
    mapq_n = np.zeros(L, np.int32)
    mapq_sumsq = np.zeros(L, np.float64)
    mapq_zero = np.zeros(L, np.int32)
    used_counts = np.zeros((L, 4), np.int32)
    used_fwd = np.zeros((L, 4), np.int32)
    edge_sum = np.zeros(L, np.int64)
    slot = np.zeros(L, np.int32)

    rc = lib.pileup_fill(
        *args1[:11],
        _p(ref_codes, ctypes.c_uint8), ref_offset, len(ref_codes),
        region_begin, region_end,
        min_qscore, 1 if mapq_adjust else 0,
        mm_flank, mm_max, -1 if t2_mm_max is None else t2_mm_max,
        _p(ek, ctypes.c_int64), n_ek,
        D, _p(slot, ctypes.c_int32),
        _p(t_base, ctypes.c_int8), _p(t_qual, ctypes.c_int16),
        _p(t_rawq, ctypes.c_int16), _p(t_fwd, ctypes.c_uint8),
        _p(t_ridx, ctypes.c_int32), _p(t_roff, ctypes.c_int32),
        _p(t_valid, ctypes.c_uint8), _p(t_used, ctypes.c_uint8),
        _p(t_t2used, ctypes.c_uint8), _p(t_nbmm, ctypes.c_uint8),
        _p(spandel, ctypes.c_int32), _p(submapped, ctypes.c_int32),
        _p(mapq_n, ctypes.c_int32), _p(mapq_sumsq, ctypes.c_double),
        _p(mapq_zero, ctypes.c_int32),
        _p(used_counts, ctypes.c_int32), _p(used_fwd, ctypes.c_int32),
        _p(edge_sum, ctypes.c_int64))
    if rc != 0:
        return None
    return PileupRegion(
        begin=region_begin, end=region_end, depth=depth,
        base_id=t_base, qual=t_qual, raw_qual=t_rawq,
        is_fwd=t_fwd.view(bool), read_idx=t_ridx, read_off=t_roff,
        valid=t_valid.view(bool), used=t_used.view(bool),
        tier2_used=t_t2used.view(bool),
        neighbor_mm=t_nbmm.view(bool), spandel=spandel,
        submapped=submapped, mapq_n=mapq_n, mapq_sumsq=mapq_sumsq,
        mapq_zero=mapq_zero, _used_counts=used_counts,
        edge_dist_sum=edge_sum,
    ), used_fwd


def expand_native(batch):
    """Native CIGAR expansion into flat tables (native/expand.cpp).

    Returns the ExpandedAlignments field tuple or None when the
    library is unavailable. Matches reads.expand_alignments exactly.
    """
    lib = get_lib()
    if lib is None or batch.n == 0:
        return None
    if not hasattr(lib, "_expand_bound"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.expand_count.restype = None
        lib.expand_count.argtypes = [i64p, i8p, i32p, ctypes.c_int64, i64p]
        lib.expand_fill.restype = None
        lib.expand_fill.argtypes = (
            [i64p, u16p, i64p, u8p, i64p, i8p, i32p, ctypes.c_int64]
            + [i32p] * 3 + [i32p, i32p, u8p]
            + [i32p] * 4 + [u8p]
            + [i32p] * 4 + [u8p]
            + [i64p] * 4)
        if hasattr(lib, "expand_fill_mt"):
            lib.expand_fill_mt.restype = None
            lib.expand_fill_mt.argtypes = (list(lib.expand_fill.argtypes)
                                           + [ctypes.c_int32])
        lib._expand_bound = True

    pos = np.ascontiguousarray(batch.pos, dtype=np.int64)
    flag = np.ascontiguousarray(batch.flag, dtype=np.uint16)
    seq_off = np.ascontiguousarray(batch.seq_off, dtype=np.int64)
    seq = np.ascontiguousarray(batch.seq, dtype=np.uint8)
    cig_off = np.ascontiguousarray(batch.cig_off, dtype=np.int64)
    cig_ops = np.ascontiguousarray(batch.cig_ops, dtype=np.int8)
    cig_lens = np.ascontiguousarray(batch.cig_lens, dtype=np.int32)

    counts = np.zeros(4, np.int64)
    lib.expand_count(_p(cig_off, ctypes.c_int64), _p(cig_ops, ctypes.c_int8),
                     _p(cig_lens, ctypes.c_int32), batch.n,
                     _p(counts, ctypes.c_int64))
    nm, nd, ni, nde = (int(x) for x in counts)

    def a(n, dtype=np.int64):
        return np.empty(n, dtype)

    m_read, m_refpos, m_readoff = \
        a(nm, np.int32), a(nm, np.int32), a(nm, np.int32)
    d_read, d_refpos, d_edge = \
        a(nd, np.int32), a(nd, np.int32), a(nd, np.uint8)
    i_read, i_refpos, i_readoff, i_len, i_edge = \
        a(ni, np.int32), a(ni, np.int32), a(ni, np.int32), \
        a(ni, np.int32), a(ni, np.uint8)
    de_read, de_refpos, de_readoff, de_len, de_edge = \
        a(nde, np.int32), a(nde, np.int32), a(nde, np.int32), \
        a(nde, np.int32), a(nde, np.uint8)
    ref_begin, ref_end = a(batch.n), a(batch.n)
    read_begin, read_end = a(batch.n), a(batch.n)

    fill = lib.expand_fill
    extra = ()
    if hasattr(lib, "expand_fill_mt"):
        fill = lib.expand_fill_mt
        extra = (ctypes.c_int32(8),)
    fill(
        _p(pos, ctypes.c_int64), _p(flag, ctypes.c_uint16),
        _p(seq_off, ctypes.c_int64), _p(seq, ctypes.c_uint8),
        _p(cig_off, ctypes.c_int64), _p(cig_ops, ctypes.c_int8),
        _p(cig_lens, ctypes.c_int32), batch.n,
        _p(m_read, ctypes.c_int32), _p(m_refpos, ctypes.c_int32),
        _p(m_readoff, ctypes.c_int32),
        _p(d_read, ctypes.c_int32), _p(d_refpos, ctypes.c_int32),
        _p(d_edge, ctypes.c_uint8),
        _p(i_read, ctypes.c_int32), _p(i_refpos, ctypes.c_int32),
        _p(i_readoff, ctypes.c_int32), _p(i_len, ctypes.c_int32),
        _p(i_edge, ctypes.c_uint8),
        _p(de_read, ctypes.c_int32), _p(de_refpos, ctypes.c_int32),
        _p(de_readoff, ctypes.c_int32), _p(de_len, ctypes.c_int32),
        _p(de_edge, ctypes.c_uint8),
        _p(ref_begin, ctypes.c_int64), _p(ref_end, ctypes.c_int64),
        _p(read_begin, ctypes.c_int64), _p(read_end, ctypes.c_int64),
        *extra)

    return (m_read, m_refpos, m_readoff,
            d_read, d_refpos, d_edge.view(bool),
            i_read, i_refpos, i_readoff, i_len, i_edge.view(bool),
            de_read, de_refpos, de_readoff, de_len, de_edge.view(bool),
            ref_begin, ref_end, read_begin, read_end)


def ar_evidence_native(batch, map_level, ref_codes, region_begin,
                       region_end):
    """Native active-region evidence/depth tracks (native/expand.cpp
    ar_evidence); None when the library is unavailable."""
    lib = get_lib()
    if lib is None or batch.n == 0:
        return None
    if not hasattr(lib, "_ar_bound"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ar_evidence.restype = None
        lib.ar_evidence.argtypes = [
            i64p, i8p, i64p, u8p, i64p, i8p, i32p, ctypes.c_int64,
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p]
        lib._ar_bound = True
    pos = np.ascontiguousarray(batch.pos, dtype=np.int64)
    level = np.ascontiguousarray(map_level, dtype=np.int8)
    seq_off = np.ascontiguousarray(batch.seq_off, dtype=np.int64)
    seq = np.ascontiguousarray(batch.seq, dtype=np.uint8)
    cig_off = np.ascontiguousarray(batch.cig_off, dtype=np.int64)
    cig_ops = np.ascontiguousarray(batch.cig_ops, dtype=np.int8)
    cig_lens = np.ascontiguousarray(batch.cig_lens, dtype=np.int32)
    ref = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    L = region_end - region_begin
    counts = np.zeros(L, np.int64)
    depth = np.zeros(L, np.int64)
    lib.ar_evidence(
        _p(pos, ctypes.c_int64), _p(level, ctypes.c_int8),
        _p(seq_off, ctypes.c_int64), _p(seq, ctypes.c_uint8),
        _p(cig_off, ctypes.c_int64), _p(cig_ops, ctypes.c_int8),
        _p(cig_lens, ctypes.c_int32), batch.n,
        _p(ref, ctypes.c_uint8), len(ref),
        region_begin, region_end,
        _p(counts, ctypes.c_int64), _p(depth, ctypes.c_int64))
    return counts, depth


def anchor_mask_native(ref_codes) -> np.ndarray | None:
    """Native STR-anchor mask (native/activeregion.cpp anchor_spans);
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_anchor_bound"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.anchor_spans.restype = None
        lib.anchor_spans.argtypes = [u8p, ctypes.c_int64, u8p]
        lib._anchor_bound = True
    ref = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    out = np.empty(len(ref), np.uint8)
    lib.anchor_spans(_p(ref, ctypes.c_uint8), len(ref),
                     _p(out, ctypes.c_uint8))
    return out.view(bool)


def find_active_regions_native(counts, depth, anchors, ref_codes,
                               region_begin: int):
    """Native active-region state machine (native/activeregion.cpp
    active_regions). Returns (begin[], end[]) absolute half-open
    spans, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_arsm_bound"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.active_regions.restype = ctypes.c_int64
        lib.active_regions.argtypes = [
            i64p, i64p, u8p, u8p, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p]
        lib._arsm_bound = True
    L = len(counts)
    c = np.ascontiguousarray(counts, dtype=np.int64)
    d = np.ascontiguousarray(depth, dtype=np.int64)
    a = np.ascontiguousarray(anchors[:L], dtype=np.uint8)
    ref = np.ascontiguousarray(ref_codes[:L], dtype=np.uint8)
    cap = L // 2 + 1
    ob = np.empty(cap, np.int64)
    oe = np.empty(cap, np.int64)
    n = lib.active_regions(
        _p(c, ctypes.c_int64), _p(d, ctypes.c_int64),
        _p(a, ctypes.c_uint8), _p(ref, ctypes.c_uint8),
        L, region_begin, _p(ob, ctypes.c_int64), _p(oe, ctypes.c_int64))
    return ob[:n], oe[:n]


def base_cache_native(seq, qual, seq_off, lut_delta, lut_lmis):
    """Whole-batch per-base scoring cache (native/activeregion.cpp
    base_cache): (delta_all f32[nbases], lnmis_read f32[n],
    nvalid_read i32[n]), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_bcache_bound"):
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.base_cache.restype = None
        lib.base_cache.argtypes = [u8p, u8p, i64p, ctypes.c_int64,
                                   f32p, f32p, f32p, f32p, i32p]
        lib._bcache_bound = True
    s = np.ascontiguousarray(seq, dtype=np.uint8)
    q = np.ascontiguousarray(qual, dtype=np.uint8)
    o = np.ascontiguousarray(seq_off, dtype=np.int64)
    ld = np.ascontiguousarray(lut_delta, dtype=np.float32)
    ll = np.ascontiguousarray(lut_lmis, dtype=np.float32)
    n = len(o) - 1
    delta = np.empty(len(s), np.float32)
    lnmis = np.empty(n, np.float32)
    nvalid = np.empty(n, np.int32)
    lib.base_cache(_p(s, ctypes.c_uint8), _p(q, ctypes.c_uint8),
                   _p(o, ctypes.c_int64), n,
                   _p(ld, ctypes.c_float), _p(ll, ctypes.c_float),
                   _p(delta, ctypes.c_float), _p(lnmis, ctypes.c_float),
                   _p(nvalid, ctypes.c_int32))
    return delta, lnmis, nvalid


def dependent_eprob_delta_native(base_id, qual, used, fwd, nbmm,
                                 ssd_no, ssd_one, want_plane=False):
    """Dependent basecall-error adjustment deltas
    (native/depeprob.cpp = blt_common/adjust_joint_eprob.cpp).
    Returns (s_delta f32 [L,4], de_delta f32 [L,D] or None) or None
    when the library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "dependent_eprob_delta"):
        return None
    if not getattr(lib, "_depe_ready", False):
        lib.dependent_eprob_delta.restype = ctypes.c_int32
        lib.dependent_eprob_delta.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p]
        lib._depe_ready = True
    L, D = base_id.shape
    b = np.ascontiguousarray(base_id, dtype=np.int8)
    q = np.ascontiguousarray(qual, dtype=np.int16)
    u = np.ascontiguousarray(used).view(np.uint8)
    f = np.ascontiguousarray(fwd).view(np.uint8)
    n = np.ascontiguousarray(nbmm).view(np.uint8)
    s_delta = np.empty((L, 4), np.float32)
    de_delta = np.empty((L, D), np.float32) if want_plane else None
    rc = lib.dependent_eprob_delta(
        b.ctypes.data, q.ctypes.data, u.ctypes.data, f.ctypes.data,
        n.ctypes.data, L, D, float(ssd_no), float(ssd_one),
        s_delta.ctypes.data,
        de_delta.ctypes.data if de_delta is not None else None)
    if rc != 0:
        return None
    return s_delta, de_delta


def block_format_lines_native(rows, n_rows, begin, ref_codes, chrom_b,
                              label_b, fstr_blob, fstr_off, out):
    """Serialize compressed block rows into newline-terminated gVCF
    lines (native/blocks.cpp block_format_lines, byte-identical to
    gvcf._block_line). rows int64 [>=n_rows, 7]; ref_codes uint8;
    chrom_b/label_b/fstr_blob bytes; fstr_off int32[257]; out uint8.
    Returns bytes written, -1 when out is too small, or None when the
    library lacks the symbol."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "block_format_lines"):
        return None
    if not getattr(lib, "_bfmt_ready", False):
        lib.block_format_lines.restype = ctypes.c_int64
        lib.block_format_lines.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib._bfmt_ready = True
    return int(lib.block_format_lines(
        rows.ctypes.data, n_rows, begin, ref_codes.ctypes.data,
        chrom_b, label_b, fstr_blob, fstr_off.ctypes.data,
        out.ctypes.data, len(out)))


def snv_hist_native(base_id, qual, mask, qtab_size, out):
    """(qscore, base) histogram over an SNV pileup tile slice
    (native/snvhist.cpp) — replaces the XLA:CPU scatter in the germline
    digt histogram-matmul path. base_id int8 [L, D], qual int16,
    mask bool; out int8 [L, qtab_size*4] must arrive ZEROED (counts are
    added). Returns False when the library is unavailable or D > 127
    (int8 cell-overflow guard); callers fall back to a numpy scatter
    that produces identical integer counts."""
    lib = get_lib()
    L, D = base_id.shape
    if lib is None or D > 127:
        return False
    if not hasattr(lib, "_snvhist_bound"):
        lib.snv_hist.restype = ctypes.c_int32
        lib.snv_hist.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int8)]
        lib._snvhist_bound = True
    b = np.ascontiguousarray(base_id, dtype=np.int8)
    q = np.ascontiguousarray(qual, dtype=np.int16)
    m = np.ascontiguousarray(mask).view(np.uint8)
    rc = lib.snv_hist(_p(b, ctypes.c_int8), _p(q, ctypes.c_int16),
                      _p(m, ctypes.c_uint8), L, D, qtab_size,
                      _p(out, ctypes.c_int8))
    return rc == 0


def align_affine_native(query, ref, s_match, s_mismatch, s_open,
                        s_extend):
    """Native affine-gap global aligner (native/activeregion.cpp
    align_affine, an exact port of ops/aligner.py align_global).
    Returns (score, ops int8[], lens int32[]) or None when the library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_aln_bound"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.align_affine.restype = ctypes.c_int64
        lib.align_affine.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i8p, i32p, i64p]
        lib._aln_bound = True
    q = np.ascontiguousarray(query, dtype=np.uint8)
    r = np.ascontiguousarray(ref, dtype=np.uint8)
    cap = len(q) + len(r) + 1
    ops = np.empty(cap, np.int8)
    lens = np.empty(cap, np.int32)
    n_ops = np.zeros(1, np.int64)
    score = lib.align_affine(
        _p(q, ctypes.c_uint8), len(q), _p(r, ctypes.c_uint8), len(r),
        int(s_match), int(s_mismatch), int(s_open), int(s_extend),
        _p(ops, ctypes.c_int8), _p(lens, ctypes.c_int32),
        _p(n_ops, ctypes.c_int64))
    n = int(n_ops[0])
    return int(score), ops[:n], lens[:n]


def region_segments_native(match_refpos, match_readoff, row_lo, row_hi,
                           read_idx, seq, seq_off, begin, end):
    """Native spanning-read segment windows (native/activeregion.cpp
    region_segments). Returns (o0, o1, valid) int64/int64/bool arrays
    per spanning read, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_rseg_bound"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.region_segments.restype = None
        # void* argtypes: raw .ctypes.data ints skip pointer-object
        # construction (this binding fires once per active region)
        lib.region_segments.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib._rseg_bound = True
    n = len(read_idx)
    rl = np.ascontiguousarray(row_lo, dtype=np.int64)
    rh = np.ascontiguousarray(row_hi, dtype=np.int64)
    ri = np.ascontiguousarray(read_idx, dtype=np.int64)
    o0 = np.empty(n, np.int64)
    o1 = np.empty(n, np.int64)
    valid = np.zeros(n, np.uint8)
    lib.region_segments(
        match_refpos.ctypes.data, match_readoff.ctypes.data,
        rl.ctypes.data, rh.ctypes.data, n,
        ri.ctypes.data, seq.ctypes.data,
        seq_off.ctypes.data, begin, end,
        o0.ctypes.data, o1.ctypes.data, valid.ctypes.data)
    return o0, o1, valid.view(bool)


def block_compress_run2(key, gqx, dp, dpf, i0: int, i1: int,
                        abs_tol: int, frac_tol: float, out):
    """Native gVCF hom-ref block compression over run [i0, i1).

    Arrays: key int64[L] (packed join-state key, pipeline/gvcf.py
    _pack_key), gqx/dp/dpf int32[L]; out is an int64[(i1-i0), 7] row
    buffer. Returns the row count, or None when the native library is
    unavailable (callers fall back to the Python _DiploidBlock loop).
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "block_compress_run2"):
        return None  # stale .so without the symbol -> Python fallback
    if not getattr(lib, "_blocks2_ready", False):
        # void* argtypes: raw .ctypes.data ints skip the data_as/cast
        # pointer-object construction (~12us/arg — this binding runs
        # once per hom-ref run, thousands of times per region)
        lib.block_compress_run2.restype = ctypes.c_int64
        lib.block_compress_run2.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_double, ctypes.c_void_p]
        lib._blocks2_ready = True

    return int(lib.block_compress_run2(
        key.ctypes.data, gqx.ctypes.data, dp.ctypes.data,
        dpf.ctypes.data, i0, i1, abs_tol, frac_tol, out.ctypes.data))


def snv_call_native(hist, ref_gt, s_mis, haploid, qtab, e0,
                    gen_prior, poly_prior, gen_hap, poly_hap):
    """Native germline SNV call tail (native/snvcall.cpp): genotype
    log-lhoods from the (qscore, base) histogram + the full posterior
    tail. Returns (lhood f32 [L,10], g_max, p_max, snv_q, g_qmax,
    p_qmax i32 [L], pl i32 [L,10], ln_ref f64 [L]) or None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_snvcall_bound"):
        lib.snv_call_tail.restype = ctypes.c_int32
        lib.snv_call_tail.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
        lib._snvcall_bound = True
    L, K = hist.shape
    hist = np.ascontiguousarray(hist, dtype=np.int8)
    rg = np.ascontiguousarray(ref_gt, dtype=np.int8)
    sm = (np.ascontiguousarray(s_mis, dtype=np.float32)
          if s_mis is not None else None)
    hp = (np.ascontiguousarray(haploid).view(np.uint8)
          if haploid is not None else None)
    qt = np.ascontiguousarray(qtab, dtype=np.float32)
    e0c = np.ascontiguousarray(e0, dtype=np.float32)
    gp = np.ascontiguousarray(gen_prior, dtype=np.float64)
    pp = np.ascontiguousarray(poly_prior, dtype=np.float64)
    gh = np.ascontiguousarray(gen_hap, dtype=np.float64)
    ph = np.ascontiguousarray(poly_hap, dtype=np.float64)
    lhood = np.empty((L, 10), np.float32)
    g_max = np.empty(L, np.int32)
    p_max = np.empty(L, np.int32)
    snv_q = np.empty(L, np.int32)
    g_qmax = np.empty(L, np.int32)
    p_qmax = np.empty(L, np.int32)
    pl = np.empty((L, 10), np.int32)
    ln_ref = np.empty(L, np.float64)
    rc = lib.snv_call_tail(
        _p(hist, ctypes.c_int8), _p(rg, ctypes.c_int8),
        sm.ctypes.data if sm is not None else None,
        hp.ctypes.data if hp is not None else None,
        _p(qt, ctypes.c_float), _p(e0c, ctypes.c_float),
        _p(gp, ctypes.c_double), _p(pp, ctypes.c_double),
        _p(gh, ctypes.c_double), _p(ph, ctypes.c_double),
        L, K,
        _p(lhood, ctypes.c_float),
        _p(g_max, ctypes.c_int32), _p(p_max, ctypes.c_int32),
        _p(snv_q, ctypes.c_int32), _p(g_qmax, ctypes.c_int32),
        _p(p_qmax, ctypes.c_int32),
        _p(pl, ctypes.c_int32), _p(ln_ref, ctypes.c_double))
    if rc != 0:
        return None
    return lhood, g_max, p_max, snv_q, g_qmax, p_qmax, pl, ln_ref
