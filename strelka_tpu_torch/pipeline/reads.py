"""Vectorized read filtering, alignment expansion and mismatch density.

TPU-native re-design of the reference's per-record read input path
(reference: starling_common/starling_pos_processor_util.cpp
processInputReadAlignment/get_map_level, starling_read_util.cpp
create_mismatch_filter_map, htsapi/bam_seq_read_util.cpp
getReadAmbiguousEndLength). All per-read/per-base loops are replaced by
whole-batch numpy array programs (repeat/cumsum/scatter), producing the
flat per-base tables that pileup and realignment tile from.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import bam as bamio
from ..utils import cigar as cg


class MapLevel:
    TIER1 = 0
    TIER2 = 1
    SUB_MAPPED = 2
    UNMAPPED = 3


def unclipped_read_starts(batch: bamio.ReadBatch) -> np.ndarray:
    """[n] reference position of each read's first SEQ base when its
    soft clips are unrolled (candidate alignments realign the whole
    read, so breakpoint-overlap tests run in unclipped coordinates:
    starling_read_align_score_indels.cpp
    get_alignment_indel_bp_overlap :136-145)."""
    lead = np.zeros(batch.n, dtype=np.int64)
    first = batch.cig_off[:-1]
    has = np.diff(batch.cig_off) > 0
    fi = first[has]
    is_clip = batch.cig_ops[fi] == cg.SOFT_CLIP
    lead[np.nonzero(has)[0][is_clip]] = batch.cig_lens[fi[is_clip]]
    return batch.pos - lead


def filter_and_classify_reads(batch: bamio.ReadBatch, min_mapq: int,
                              tier2_min_mapq: int | None = None,
                              include_singleton: bool = False,
                              include_anomalous: bool = False,
                              tier2_include_singleton: bool = True,
                              tier2_include_anomalous: bool = True):
    """Hard filters + mapping tier per read.

    reference: starling_read_filter_shared.hh (skip secondary,
    supplementary, QC-fail n/a, duplicate, unmapped) and
    get_map_level / is_usable_read_mapping
    (starling_pos_processor_util.cpp:244-308): paired reads whose mate
    is unmapped (singletons) or that are not proper pairs (anomalous)
    are excluded from tier1 by default; tier2 re-admits them when its
    include flags are set (Tier2Options defaults true).

    Returns (keep_mask, map_level array) over the input batch.
    """
    f = batch.flag.astype(np.int64)
    hard_filtered = (
        (f & bamio.FLAG_SECONDARY != 0)
        | (f & bamio.FLAG_SUPPLEMENTARY != 0)
        | (f & bamio.FLAG_DUPLICATE != 0)
        | (f & bamio.FLAG_UNMAPPED != 0)
    )
    paired = (f & 0x1) != 0
    singleton = paired & ((f & 0x8) != 0)
    anomalous = paired & ~singleton & ((f & 0x2) == 0)

    level = np.full(batch.n, MapLevel.SUB_MAPPED, dtype=np.int8)
    t1_ok = batch.mapq >= min_mapq
    if not include_singleton:
        t1_ok = t1_ok & ~singleton
    if not include_anomalous:
        t1_ok = t1_ok & ~anomalous
    level[t1_ok] = MapLevel.TIER1
    if tier2_min_mapq is not None:
        t2_ok = (batch.mapq >= tier2_min_mapq) & ~t1_ok
        if not (include_singleton or tier2_include_singleton):
            t2_ok = t2_ok & ~singleton
        if not (include_anomalous or tier2_include_anomalous):
            t2_ok = t2_ok & ~anomalous
        level[t2_ok] = MapLevel.TIER2
    return ~hard_filtered, level


@dataclass
class ExpandedAlignments:
    """Flat per-base tables over a whole read batch.

    `match_*` rows cover aligned (M/=/X) read bases; `del_*` rows cover
    deleted reference bases; `ins_*`/`clip_*` are per-event rows.
    """
    # aligned read bases
    match_read: np.ndarray     # read index
    match_refpos: np.ndarray   # reference position
    match_readoff: np.ndarray  # offset within read
    # spanning deletions (per deleted ref base)
    del_read: np.ndarray
    del_refpos: np.ndarray
    del_is_edge: np.ndarray    # bool: edge (unanchored) deletion
    # indel events (per segment)
    ins_read: np.ndarray       # insertions: read idx
    ins_refpos: np.ndarray     # ref pos of insertion point
    ins_readoff: np.ndarray    # read offset of first inserted base
    ins_len: np.ndarray
    ins_is_edge: np.ndarray
    devent_read: np.ndarray    # deletions as events
    devent_refpos: np.ndarray  # ref pos of first deleted base
    devent_readoff: np.ndarray # read offset following the deletion
    devent_len: np.ndarray
    devent_is_edge: np.ndarray
    # per-read summary
    ref_begin: np.ndarray      # first aligned ref pos per read
    ref_end: np.ndarray        # one past last aligned ref pos
    read_begin: np.ndarray     # usable read range (after N-trim)
    read_end: np.ndarray


def _segment_table(batch: bamio.ReadBatch):
    """Per-cigar-segment arrays with read/ref start coordinates."""
    n_seg_per_read = np.diff(batch.cig_off)
    seg_read = np.repeat(np.arange(batch.n), n_seg_per_read)
    ops = batch.cig_ops.astype(np.int64)
    lens = batch.cig_lens.astype(np.int64)
    read_adv = lens * cg.ADVANCES_READ[ops]
    ref_adv = lens * cg.ADVANCES_REF[ops]
    # exclusive cumsum within each read
    cs_read = np.cumsum(read_adv) - read_adv
    cs_ref = np.cumsum(ref_adv) - ref_adv
    # subtract the running total at each read's first segment
    first_seg = batch.cig_off[:-1]
    base_read = np.repeat(cs_read[np.minimum(first_seg, len(ops) - 1)] if len(ops) else np.zeros(0),
                          n_seg_per_read)
    base_ref = np.repeat(cs_ref[np.minimum(first_seg, len(ops) - 1)] if len(ops) else np.zeros(0),
                         n_seg_per_read)
    read_start = cs_read - base_read
    ref_start = cs_ref - base_ref + np.repeat(batch.pos, n_seg_per_read)
    return seg_read, ops, lens, read_start.astype(np.int64), ref_start.astype(np.int64)


def _edge_segment_flags(batch: bamio.ReadBatch, ops: np.ndarray):
    """For each segment: is it outside the [first,last] aligned-match
    segments (reference: align_path get_match_edge_segments)."""
    n_seg_per_read = np.diff(batch.cig_off)
    seg_idx_in_read = np.arange(len(ops)) - np.repeat(batch.cig_off[:-1], n_seg_per_read)
    is_match = np.isin(ops, (cg.MATCH, cg.SEQ_MATCH, cg.SEQ_MISMATCH))
    # first/last match segment index per read
    first = np.full(batch.n, np.iinfo(np.int64).max, dtype=np.int64)
    last = np.full(batch.n, -1, dtype=np.int64)
    seg_read = np.repeat(np.arange(batch.n), n_seg_per_read)
    m_reads = seg_read[is_match]
    m_idx = seg_idx_in_read[is_match]
    np.minimum.at(first, m_reads, m_idx)
    np.maximum.at(last, m_reads, m_idx)
    f_rep = np.repeat(first, n_seg_per_read)
    l_rep = np.repeat(last, n_seg_per_read)
    return (seg_idx_in_read < f_rep) | (seg_idx_in_read > l_rep)


def _ambiguous_end_trim(batch: bamio.ReadBatch):
    """N-run trimming at the read's sequencing tail
    (bam_seq_read_util.cpp getReadAmbiguousEndLength)."""
    read_begin = np.zeros(batch.n, dtype=np.int64)
    read_end = np.diff(batch.seq_off).astype(np.int64)
    is_rev = (batch.flag & bamio.FLAG_REVERSE) != 0
    # vectorized trailing/leading N-run length
    for i in range(batch.n):  # reads with no Ns skip instantly
        seq = batch.get_seq(i)
        if len(seq) == 0 or (seq[0] != 4 and seq[-1] != 4):
            continue
        if is_rev[i]:
            j = 0
            while j < len(seq) and seq[j] == 4:
                j += 1
            read_begin[i] = j
        else:
            j = len(seq)
            while j > 0 and seq[j - 1] == 4:
                j -= 1
            read_end[i] = j
    return read_begin, read_end


def expand_alignments(batch: bamio.ReadBatch,
                      use_native: bool = True) -> ExpandedAlignments:
    """Expand every read's CIGAR into flat per-base/per-event tables.

    Prefers the native single-pass builder (native/expand.cpp); the
    vectorized numpy path below is the fallback and the semantic
    oracle (tests/test_native.py asserts bit-exact equivalence)."""
    if use_native and batch.n:
        from ..io.native import expand_native
        fields = expand_native(batch)
        if fields is not None:
            return ExpandedAlignments(*fields)
    if batch.n == 0:
        z = np.zeros(0, dtype=np.int64)
        zb = np.zeros(0, dtype=bool)
        return ExpandedAlignments(*( [z, z, z] + [z, z, zb] + [z]*4 + [zb] + [z]*4 + [zb] + [z]*4 ))

    seg_read, ops, lens, read_start, ref_start = _segment_table(batch)
    is_edge = _edge_segment_flags(batch, ops)

    # --- aligned match bases ---
    mm = np.isin(ops, (cg.MATCH, cg.SEQ_MATCH, cg.SEQ_MISMATCH))
    m_lens = lens[mm]
    m_total = int(m_lens.sum())
    rep = np.repeat(np.arange(mm.sum()), m_lens)
    off_in_seg = np.arange(m_total) - np.repeat(np.cumsum(m_lens) - m_lens, m_lens)
    match_read = np.repeat(seg_read[mm], m_lens)
    match_refpos = np.repeat(ref_start[mm], m_lens) + off_in_seg
    match_readoff = np.repeat(read_start[mm], m_lens) + off_in_seg
    del rep

    # --- deletions (per ref base + per event) ---
    dd = ops == cg.DELETE
    d_lens = lens[dd]
    d_total = int(d_lens.sum())
    off_d = np.arange(d_total) - np.repeat(np.cumsum(d_lens) - d_lens, d_lens)
    del_read = np.repeat(seg_read[dd], d_lens)
    del_refpos = np.repeat(ref_start[dd], d_lens) + off_d
    del_is_edge = np.repeat(is_edge[dd], d_lens)

    devent_read = seg_read[dd]
    devent_refpos = ref_start[dd]
    devent_readoff = read_start[dd]
    devent_len = lens[dd]
    devent_is_edge = is_edge[dd]

    # --- insertions (per event) ---
    ii = ops == cg.INSERT
    ins_read = seg_read[ii]
    ins_refpos = ref_start[ii]
    ins_readoff = read_start[ii]
    ins_len = lens[ii]
    ins_is_edge = is_edge[ii]

    # --- per-read aligned span ---
    ref_begin = np.full(batch.n, np.iinfo(np.int64).max, dtype=np.int64)
    ref_end = np.full(batch.n, -1, dtype=np.int64)
    if len(match_read):
        np.minimum.at(ref_begin, match_read, match_refpos)
        np.maximum.at(ref_end, match_read, match_refpos)
    ref_end += 1

    read_begin, read_end = _ambiguous_end_trim(batch)

    # per-base/per-event tables are int32 like the native builder
    # (read index and contig positions both fit; halves the footprint)
    i32 = lambda a: a.astype(np.int32)
    return ExpandedAlignments(
        match_read=i32(match_read), match_refpos=i32(match_refpos),
        match_readoff=i32(match_readoff),
        del_read=i32(del_read), del_refpos=i32(del_refpos),
        del_is_edge=del_is_edge,
        ins_read=i32(ins_read), ins_refpos=i32(ins_refpos),
        ins_readoff=i32(ins_readoff), ins_len=i32(ins_len),
        ins_is_edge=ins_is_edge,
        devent_read=i32(devent_read), devent_refpos=i32(devent_refpos),
        devent_readoff=i32(devent_readoff), devent_len=i32(devent_len),
        devent_is_edge=devent_is_edge,
        ref_begin=ref_begin, ref_end=ref_end,
        read_begin=read_begin, read_end=read_end,
    )


def mismatch_density_filter(
    batch: bamio.ReadBatch,
    ea: ExpandedAlignments,
    ref_codes: np.ndarray,
    ref_offset: int,
    flank_size: int,
    max_mismatch: int,
    tier2_max_mismatch: int | None = None,
    candidate_snv_mask=None,
    with_neighbor: bool = False,
):
    """Per-read-base mismatch-density filter flags.

    Exact vectorized transcription of create_mismatch_filter_map's
    delta-list algorithm (starling_read_util.cpp:121-210 + ddata
    helper): events (mismatches weight 1, non-edge insertions length
    ins_len, non-edge deletions length 0) are scattered into per-read
    delta arrays, prefix-summed, and sampled at min(DL-1, max(F,p)-F).

    candidate_snv_mask: optional callable(ref_pos array, base array) ->
    bool array of mismatches to exempt (active-region candidate SNVs).

    Returns (mismatch_filter[read_total_bases] bool aligned with read
    base offsets via batch.seq_off, tier2_filter or None); with
    with_neighbor=True appends neighbor_mm[read_total_bases] — the
    windowed count excluding the base's own mismatch is > 0
    (mismatch_count_ns, starling_read_util.cpp:211).
    """
    if batch.n == 0:
        z = np.zeros(0, dtype=bool)
        out = (z, (z if tier2_max_mismatch is not None else None))
        return out + (z,) if with_neighbor else out
    F = flank_size
    F2 = 2 * F
    read_sizes = np.diff(batch.seq_off).astype(np.int64)
    dl_sizes = np.maximum(1 + F2, read_sizes) - F2
    dl_off = np.concatenate([[0], np.cumsum(dl_sizes)])
    delta = np.zeros(int(dl_off[-1]), dtype=np.int32)

    # mismatch events at aligned bases (within usable read range)
    base = batch.seq[batch.seq_off[ea.match_read] + ea.match_readoff]
    ref_idx = ea.match_refpos - ref_offset
    in_bounds = (ref_idx >= 0) & (ref_idx < len(ref_codes))
    refb = np.where(in_bounds, ref_codes[np.clip(ref_idx, 0, len(ref_codes) - 1)], 4)
    usable = (ea.match_readoff >= ea.read_begin[ea.match_read]) & \
             (ea.match_readoff < ea.read_end[ea.match_read])
    is_mm = (base != refb) & usable & (refb != 4)
    if candidate_snv_mask is not None:
        is_mm &= ~candidate_snv_mask(ea.match_refpos, base)

    ev_read = [ea.match_read[is_mm]]
    ev_start = [ea.match_readoff[is_mm]]
    ev_len = [np.ones(int(is_mm.sum()), dtype=np.int64)]
    # non-edge insertion events: inc(read_head_pos, length)
    ni = ~ea.ins_is_edge
    ev_read.append(ea.ins_read[ni])
    ev_start.append(ea.ins_readoff[ni])
    ev_len.append(ea.ins_len[ni].astype(np.int64))
    # non-edge deletion events: inc(read_head_pos, 0)
    nd = ~ea.devent_is_edge
    ev_read.append(ea.devent_read[nd])
    ev_start.append(ea.devent_readoff[nd])
    ev_len.append(np.zeros(int(nd.sum()), dtype=np.int64))

    ev_read = np.concatenate(ev_read)
    ev_start = np.concatenate(ev_start)
    ev_len = np.concatenate(ev_len)

    inc_idx = dl_off[ev_read] + np.maximum(F2, ev_start) - F2
    np.add.at(delta, inc_idx, 1)
    dec_pos = ev_start + ev_len
    in_range = dec_pos < dl_sizes[ev_read]
    dec_idx = dl_off[ev_read[in_range]] + dec_pos[in_range]
    np.add.at(delta, dec_idx, -1)

    # segmented prefix sum: global cumsum minus the running total at
    # each read block's start
    cs = np.cumsum(delta)
    prev_total = np.concatenate([[0], cs[dl_off[1:-1] - 1]]) if batch.n > 1 else np.zeros(1)
    counts = cs - np.repeat(prev_total, dl_sizes)

    # sample window counts at each read base
    total_bases = int(batch.seq_off[-1])
    base_read = np.repeat(np.arange(batch.n), read_sizes)
    base_off = np.arange(total_bases) - np.repeat(batch.seq_off[:-1], read_sizes)
    samp = np.minimum(dl_sizes[base_read] - 1, np.maximum(F, base_off) - F)
    mcount = counts[dl_off[base_read] + samp]

    mm_filter = mcount > max_mismatch
    tier2 = mcount > tier2_max_mismatch if tier2_max_mismatch is not None else None
    if not with_neighbor:
        return mm_filter, tier2
    selfmm = np.zeros(total_bases, dtype=np.int32)
    selfmm[batch.seq_off[ea.match_read[is_mm]]
           + ea.match_readoff[is_mm]] = 1
    return mm_filter, tier2, (mcount - selfmm) > 0


def split_spliced_reads(batch: bamio.ReadBatch, level: np.ndarray):
    """Split N-CIGAR (spliced RNA) reads into per-exon segment records.

    Reference: starling_read_segment.{hh,cpp} + starling_read.cpp —
    spliced reads are decomposed into exon segments that buffer,
    discover candidates, realign and pile up INDEPENDENTLY; the
    full-read alignment is only reassembled for realigned output
    (see reassemble_spliced).

    Each segment inherits the parent's name/flags/mapq/tier; its pos is
    the exon's reference start and its seq/qual are the read slice the
    exon consumes (soft clips stay with the first/last segment). Empty
    segments (adjacent N ops, N at an alignment edge) are dropped.

    Returns (seg_batch, seg_level, parent_row, seg_no) with seg_batch
    sorted by pos (downstream windows binary-search batch.pos);
    parent_row maps each output row to its input row, seg_no is the
    segment ordinal within the parent (0 for unspliced reads).
    """
    nseg = np.diff(batch.cig_off)
    seg_read = np.repeat(np.arange(batch.n), nseg)
    has_n = np.zeros(batch.n, dtype=bool)
    np.logical_or.at(has_n, seg_read[batch.cig_ops == cg.SKIP], True)
    if not has_n.any():
        return batch, level, np.arange(batch.n), np.zeros(batch.n, np.int32)

    rows: list[tuple[int, int, int, int, int, np.ndarray, np.ndarray]] = []
    # (parent_row, seg_no, pos, q0, q1, ops, lens)
    for r in range(batch.n):
        if not has_n[r]:
            o, l = batch.get_cigar(r)
            rows.append((r, 0, int(batch.pos[r]), 0, batch.read_len(r),
                         o, l))
            continue
        o, l = batch.get_cigar(r)
        ref = int(batch.pos[r])
        q = 0
        seg_ops: list[int] = []
        seg_lens: list[int] = []
        seg_pos = ref
        seg_q0 = q
        seg_no = 0
        for op, ln in zip(o, l):
            op = int(op)
            ln = int(ln)
            if op == cg.SKIP:
                if seg_ops:
                    rows.append((r, seg_no, seg_pos, seg_q0, q,
                                 np.array(seg_ops, np.int8),
                                 np.array(seg_lens, np.int32)))
                    seg_no += 1
                    seg_ops, seg_lens = [], []
                ref += ln
                seg_pos = ref
                seg_q0 = q
                continue
            seg_ops.append(op)
            seg_lens.append(ln)
            if cg.ADVANCES_READ[op]:
                q += ln
            if cg.ADVANCES_REF[op]:
                ref += ln
        if seg_ops:
            rows.append((r, seg_no, seg_pos, seg_q0, q,
                         np.array(seg_ops, np.int8),
                         np.array(seg_lens, np.int32)))

    order = sorted(range(len(rows)), key=lambda i: rows[i][2])
    out = bamio.ReadBatch()
    out.n = len(rows)
    parent_row = np.empty(out.n, np.int64)
    seg_no_arr = np.empty(out.n, np.int32)
    pos = np.empty(out.n, np.int64)
    seq_parts, qual_parts, op_parts, len_parts = [], [], [], []
    seq_off = [0]
    cig_off = [0]
    names = []
    for oi, i in enumerate(order):
        r, sno, p, q0, q1, o, l = rows[i]
        parent_row[oi] = r
        seg_no_arr[oi] = sno
        pos[oi] = p
        seq_parts.append(batch.get_seq(r)[q0:q1])
        qual_parts.append(batch.get_qual(r)[q0:q1])
        op_parts.append(o)
        len_parts.append(l)
        seq_off.append(seq_off[-1] + (q1 - q0))
        cig_off.append(cig_off[-1] + len(o))
        names.append(batch.names[r] if batch.names else "")
    out.names = names
    out.pos = pos
    out.seq = np.concatenate(seq_parts) if seq_parts else np.empty(0, np.uint8)
    out.qual = np.concatenate(qual_parts) if qual_parts else np.empty(0, np.uint8)
    out.seq_off = np.asarray(seq_off, np.int64)
    out.cig_ops = np.concatenate(op_parts).astype(np.int8) if op_parts \
        else np.empty(0, np.int8)
    out.cig_lens = np.concatenate(len_parts).astype(np.int32) if len_parts \
        else np.empty(0, np.int32)
    out.cig_off = np.asarray(cig_off, np.int64)
    pr = parent_row
    for fld in ("tid", "mapq", "flag", "mate_tid", "mate_pos", "tlen"):
        setattr(out, fld, getattr(batch, fld)[pr])
    return out, level[pr], pr, seg_no_arr


def reassemble_spliced(seg_batch: bamio.ReadBatch, parent_row: np.ndarray,
                       seg_no: np.ndarray, orig: bamio.ReadBatch):
    """Rejoin realigned exon segments into whole-read (pos, cigar)
    records over the pre-split batch `orig`, for realigned-BAM output.

    N gap lengths are recomputed from the realigned segment positions
    (a segment that moved shrinks/grows its adjacent intron). A parent
    whose segments realigned out of order (next segment starts at or
    before the previous segment's end) keeps its original alignment.
    Returns a ReadBatch with orig's row order carrying the new
    pos/cigar (other fields shared with orig).
    """
    by_parent: dict[int, list[int]] = {}
    for i, r in enumerate(parent_row):
        by_parent.setdefault(int(r), []).append(i)

    pos = orig.pos.copy()
    ops_out: list[np.ndarray] = []
    lens_out: list[np.ndarray] = []
    for r in range(orig.n):
        segs = by_parent.get(r)
        if not segs:
            o, l = orig.get_cigar(r)
            ops_out.append(np.asarray(o))
            lens_out.append(np.asarray(l))
            continue
        segs = sorted(segs, key=lambda i: int(seg_no[i]))
        if len(segs) == 1:
            i = segs[0]
            pos[r] = seg_batch.pos[i]
            o, l = seg_batch.get_cigar(i)
            ops_out.append(np.asarray(o))
            lens_out.append(np.asarray(l))
            continue
        joined_ops: list[np.ndarray] = []
        joined_lens: list[np.ndarray] = []
        ok = True
        prev_end = None
        for i in segs:
            o, l = seg_batch.get_cigar(i)
            p = int(seg_batch.pos[i])
            if prev_end is not None:
                gap = p - prev_end
                if gap <= 0:
                    ok = False
                    break
                joined_ops.append(np.array([cg.SKIP], np.int8))
                joined_lens.append(np.array([gap], np.int32))
            joined_ops.append(np.asarray(o))
            joined_lens.append(np.asarray(l))
            prev_end = p + cg.ref_span(o, l)
        if not ok:
            o, l = orig.get_cigar(r)
            ops_out.append(np.asarray(o))
            lens_out.append(np.asarray(l))
            continue
        pos[r] = seg_batch.pos[segs[0]]
        ops_out.append(np.concatenate(joined_ops))
        lens_out.append(np.concatenate(joined_lens))

    out = bamio.ReadBatch(
        n=orig.n, names=orig.names, tid=orig.tid, pos=pos, mapq=orig.mapq,
        flag=orig.flag, mate_tid=orig.mate_tid, mate_pos=orig.mate_pos,
        tlen=orig.tlen, seq=orig.seq, qual=orig.qual,
        seq_off=orig.seq_off,
        cig_ops=np.concatenate(ops_out).astype(np.int8),
        cig_lens=np.concatenate(lens_out).astype(np.int32),
        cig_off=np.concatenate(
            [[0], np.cumsum([len(o) for o in ops_out])]).astype(np.int64))
    return out
