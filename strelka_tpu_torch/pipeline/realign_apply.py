"""Application of realignment results to read alignments.

Reference: starling_read_align.cpp finishRealignment:1411 + the
realigned pileup semantics (pileup_read_segment uses rseg.realignment
when set). After locus scoring, reads whose indel haplotype beats ref
by more than the smoothing range get the indel embedded at the scored
best placement; the remaining soft-clipped reads at the locus get
their clips unrolled into aligned bases (clips are retained only in
RNA mode). The pileup is then rebuilt from the realigned batch, so
bases downstream of insertions/deletions contribute at their corrected
reference positions. A read overlapping several loci keeps its first
rewrite (the reference realigns each read once over all indels
jointly).
"""
from __future__ import annotations

import numpy as np

from ..io.bam import ReadBatch
from ..utils import cigar as cg
from .candidates import IndelKey


def aligned_span_table(batch: ReadBatch):
    """Vectorized _aligned_span over the whole batch:
    (clip_left [n], clip_right [n], has_complex [n]). One pass over the
    flat CIGAR tables instead of a per-read Python parse."""
    n = batch.n
    ops = batch.cig_ops
    lens = batch.cig_lens
    off = batch.cig_off
    nseg = np.diff(off)
    seg_read = np.repeat(np.arange(n), nseg)
    seg_idx = np.arange(len(ops)) - np.repeat(off[:-1], nseg)
    # _aligned_span trims ONLY clip ops from the edges, so any I/D/N op
    # anywhere marks the read complex (an indel can never sit inside
    # the clip prefix/suffix)
    is_complex_op = ((ops == cg.INSERT) | (ops == cg.DELETE)
                     | (ops == cg.SKIP))
    has_complex = np.zeros(n, bool)
    np.logical_or.at(has_complex, seg_read[is_complex_op], True)
    # leading/trailing soft clips: clip runs at the alignment edges
    is_clip = (ops == cg.SOFT_CLIP) | (ops == cg.HARD_CLIP)
    big = np.iinfo(np.int64).max
    first_nc = np.full(n, big, np.int64)
    np.minimum.at(first_nc, seg_read,
                  np.where(is_clip, big, seg_idx))
    last_nc = np.full(n, -1, np.int64)
    np.maximum.at(last_nc, seg_read,
                  np.where(is_clip, -1, seg_idx))
    is_sc = ops == cg.SOFT_CLIP
    lead_sc = is_sc & (seg_idx < first_nc[seg_read])
    trail_sc = is_sc & (seg_idx > last_nc[seg_read])
    clip_l = np.zeros(n, np.int64)
    clip_r = np.zeros(n, np.int64)
    np.add.at(clip_l, seg_read[lead_sc], lens[lead_sc])
    np.add.at(clip_r, seg_read[trail_sc], lens[trail_sc])
    return clip_l, clip_r, has_complex


def _aligned_span(batch: ReadBatch, r: int):
    """(clip_left, clip_right, has_complex_interior) for read r.

    has_complex_interior is True when the interior of the alignment
    already contains indels or splice skips — such reads are left
    unchanged (their input alignment already encodes structure the
    simple rewrite below would destroy)."""
    ops, lens = batch.get_cigar(r)
    clip_left = clip_right = 0
    i = 0
    while i < len(ops) and ops[i] in (cg.SOFT_CLIP, cg.HARD_CLIP):
        if ops[i] == cg.SOFT_CLIP:
            clip_left += int(lens[i])
        i += 1
    j = len(ops) - 1
    while j >= 0 and ops[j] in (cg.SOFT_CLIP, cg.HARD_CLIP):
        if ops[j] == cg.SOFT_CLIP:
            clip_right += int(lens[j])
        j -= 1
    interior = ops[i:j + 1]
    has_complex = any(o in (cg.INSERT, cg.DELETE, cg.SKIP) for o in interior)
    return clip_left, clip_right, has_complex


def realign_read_to_indel(batch: ReadBatch, r: int, key: IndelKey,
                          span=None):
    """New (pos, ops, lens) embedding `key` into read r's alignment.

    Soft clips are unrolled into aligned bases: candidate alignments
    realign the whole read, and isRetainOptimalSoftClipping is false
    outside RNA mode (starling_read_align.cpp :1711-2122). The read's
    unclipped start stays anchored; only primitive insertions and
    deletions are handled. Returns None if the indel doesn't fall
    inside the unclipped read, the key is a complex (swap) allele, or
    the input alignment already carries structure.
    """
    if not key.is_primitive:
        return None  # swaps (del+ins) are not rewritten
    clip_left, clip_right, has_complex = (
        span if span is not None else _aligned_span(batch, r))
    if has_complex:
        return None
    read_len = batch.read_len(r)
    new_pos = int(batch.pos[r]) - clip_left
    if new_pos < 0:
        return None

    left_flank = key.pos - new_pos
    if left_flank <= 0 or left_flank >= read_len:
        return None
    right_flank = read_len - left_flank

    if key.is_insertion:
        ins = key.insert_length
        if right_flank <= ins:
            return None
        ops_out = [cg.MATCH, cg.INSERT, cg.MATCH]
        lens_out = [left_flank, ins, right_flank - ins]
    else:
        ops_out = [cg.MATCH, cg.DELETE, cg.MATCH]
        lens_out = [left_flank, key.delete_length, right_flank]
    return (new_pos, np.array(ops_out, dtype=np.int8),
            np.array(lens_out, dtype=np.int32))


def plan_indel_alignment(batch: ReadBatch, r: int, key: IndelKey,
                         hap_offset: int, win_begin: int, span=None):
    """(pos, ops, lens) placing read r on the with-indel haplotype at
    the scored window offset (the max-likelihood candidate alignment;
    finishRealignment). Soft clips unroll; partial-insertion read ends
    become soft clips (edge inserts)."""
    if not key.is_primitive:
        return None
    _cl, _cr, has_complex = (
        span if span is not None else _aligned_span(batch, r))
    if has_complex:
        return None
    read_len = batch.read_len(r)
    o = int(hap_offset)
    p = key.pos - win_begin
    ins = key.insert_length
    dl = key.delete_length

    def plain(pos):
        if pos < 0:
            return None
        return (pos, np.array([cg.MATCH], dtype=np.int8),
                np.array([read_len], dtype=np.int32))

    if key.is_insertion:
        if o >= p + ins:
            return plain(win_begin + o - ins)
        if o + read_len <= p:
            return plain(win_begin + o)
        if o >= p:
            # read starts inside the insertion: leading insert bases
            # have no reference anchor -> soft clip
            lead = p + ins - o
            if lead >= read_len:
                return None
            return (win_begin + p,
                    np.array([cg.SOFT_CLIP, cg.MATCH], dtype=np.int8),
                    np.array([lead, read_len - lead], dtype=np.int32))
        lf = p - o
        if lf + ins >= read_len:
            # insertion truncated at the read end -> trailing soft clip
            tail = read_len - lf
            if tail <= 0:
                return plain(win_begin + o)
            return (win_begin + o,
                    np.array([cg.MATCH, cg.SOFT_CLIP], dtype=np.int8),
                    np.array([lf, tail], dtype=np.int32))
        return (win_begin + o,
                np.array([cg.MATCH, cg.INSERT, cg.MATCH], dtype=np.int8),
                np.array([lf, ins, read_len - lf - ins], dtype=np.int32))

    # deletion
    if o >= p:
        return plain(win_begin + o + dl)
    if o + read_len <= p:
        return plain(win_begin + o)
    lf = p - o
    return (win_begin + o,
            np.array([cg.MATCH, cg.DELETE, cg.MATCH], dtype=np.int8),
            np.array([lf, dl, read_len - lf], dtype=np.int32))


def unroll_read(batch: ReadBatch, r: int, span=None):
    """Gapless full-read plan with soft clips unrolled to aligned
    bases (the no-indel candidate alignment). None when the read has
    no soft clips, carries interior structure, or would start before
    the contig."""
    clip_left, clip_right, has_complex = (
        span if span is not None else _aligned_span(batch, r))
    if has_complex or (clip_left == 0 and clip_right == 0):
        return None
    new_pos = int(batch.pos[r]) - clip_left
    if new_pos < 0:
        return None
    read_len = batch.read_len(r)
    return (new_pos, np.array([cg.MATCH], dtype=np.int8),
            np.array([read_len], dtype=np.int32))


LN10 = float(np.log(10.0))  # smoothed_lnp_range, starling_base_shared.hh:171


def clip_ambiguous_edges(batch: ReadBatch, r: int, scores, i: int,
                         keys, alt_in_pool: np.ndarray,
                         has_complex=None):
    """Gapless plan with ambiguous edges soft-clipped.

    When a read's smooth pool holds both the gapless alignment (the
    preferred one: fewest indels, isFirstCandidateAlignmentPreferred)
    and one or more with-indel alignments within smoothed_lnp_range,
    the reference soft-clips every edge read position whose reference
    mapping conflicts between pool members
    (getClippedAlignmentFromTopAlignmentPool,
    starling_read_align_clipper.cpp:345-423). Returns (pos, ops, lens)
    or None (complex input alignment / fully-conflicted read).
    """
    if has_complex is None:
        _cl, _cr, has_complex = _aligned_span(batch, r)
    if has_complex:
        return None
    rl = int(scores.read_len[i])
    o_r = scores.win_begin + int(scores.best_offsets[i, 0])
    # each alt's non-conflicting read positions form ONE interval: a
    # prefix (same placement below the indel) and/or suffix (placement
    # shifted by exactly the indel length above it); the pool's
    # conflict-free set is the intersection — O(alts) scalar work
    lead, trail = 0, rl
    for a in np.nonzero(alt_in_pool)[0]:
        key = keys[a]
        if not key.is_primitive:
            return None
        o_a = scores.win_begin + int(scores.best_offsets[i, 1 + a])
        p = key.pos          # indel position (hap == ref coords below p)
        if key.is_insertion:
            shift = -key.insert_length   # ref_of = h - ins above p+ins
            suffix_from = p + key.insert_length - o_a
        else:
            shift = key.delete_length    # ref_of = h + dlen at/above p
            suffix_from = p - o_a
        a_lead, a_trail = rl, 0          # empty by default
        if o_a == o_r:
            a_lead, a_trail = 0, min(rl, max(p - o_a, 0))
        if o_a + shift == o_r:
            lo = min(max(suffix_from, 0), rl)
            if a_trail <= a_lead:        # no prefix interval
                a_lead, a_trail = lo, rl
            # prefix requires o_a==o_r and suffix o_a+shift==o_r: both
            # only when shift==0, impossible for a real indel
        lead = max(lead, a_lead)
        trail = min(trail, a_trail)
    if lead >= trail:
        return None
    if lead == 0 and trail == rl:
        return unroll_read(batch, r)
    new_pos = o_r + lead
    if new_pos < 0:
        return None
    ops, lens = [], []
    if lead:
        ops.append(cg.SOFT_CLIP)
        lens.append(lead)
    ops.append(cg.MATCH)
    lens.append(trail - lead)
    if trail < rl:
        ops.append(cg.SOFT_CLIP)
        lens.append(rl - trail)
    return (new_pos, np.array(ops, dtype=np.int8),
            np.array(lens, dtype=np.int32))


LN_QUARTER = float(np.log(0.25))


def score_softclipped_input(batch: ReadBatch, r: int,
                            ref_codes: np.ndarray, ref_offset: int,
                            span=None):
    """Log-likelihood of read r's soft-clipped INPUT alignment.

    Emission over aligned bases (ln(1-e) match / ln(e/3) mismatch, N
    skipped) plus ln(0.25) per soft-clipped base — the same scoring the
    reference applies to the input alignment when optimal soft clipping
    is retained (scoreCandidateAlignment SOFT_CLIP case
    starling_read_align_score.cpp:439-455 + scoreMatchSegment).
    Returns None for alignments with interior structure."""
    cl, cr, has_complex = (
        span if span is not None else _aligned_span(batch, r))
    if has_complex:
        return None
    seq = batch.get_seq(r)
    qual = batch.get_qual(r)
    rl = len(seq)
    a0, a1 = cl, rl - cr
    refpos0 = int(batch.pos[r]) - ref_offset
    ref_seg = ref_codes[refpos0:refpos0 + (a1 - a0)]
    if len(ref_seg) < (a1 - a0):
        return None
    s = seq[a0:a1]
    # same quantized per-base weights as the scoring kernels (this
    # score is compared against kernel scores of the same read, so the
    # two must share the canonical LUT): lnp = sum lmis + sum_match delta
    from ..ops.readlik import quantized_qscore_luts
    delta_lut, lmis_lut = quantized_qscore_luts()
    qi = np.clip(qual[a0:a1], 0, 127)
    valid = s < 4
    match = valid & (s == ref_seg)
    lnp = float(lmis_lut[qi][valid].astype(np.float64).sum()
                + delta_lut[qi][match].astype(np.float64).sum())
    return lnp + LN_QUARTER * (cl + cr)


def apply_breakpoint_clips(
    batch: ReadBatch,
    bp_loci: list,
    min_lhood_gain: float = LN10,
) -> tuple[ReadBatch, int]:
    """Soft-clip reads at candidate open-breakpoint junctions.

    bp_loci: [(pos, side, LocusReadScores)] from
    realign.score_breakpoint_locus. Reads whose breakpoint-haplotype
    likelihood beats the gapless reference alignment by more than the
    smoothing range get everything past (BP_LEFT) / before (BP_RIGHT)
    the junction soft-clipped — the pileup effect of the reference's
    winning BP candidate alignment, whose off-junction bases are
    insert segments that never enter the pileup
    (starling_read_align.cpp:561-575 + pileup_read_segment).
    """
    new_cigars: dict[int, tuple[int, np.ndarray, np.ndarray]] = {}
    for pos, side, scores in bp_loci:
        if scores is None:
            continue
        lh = scores.allele_lhoods
        win = (lh[:, 1] - lh[:, 0]) > min_lhood_gain
        for i in np.nonzero(win)[0]:
            r = int(scores.read_rows[i])
            if r in new_cigars:
                continue
            rl = int(scores.read_len[i])
            o = scores.win_begin + int(scores.best_offsets[i, 1])
            j_cut = pos - o
            if j_cut <= 0 or j_cut >= rl:
                continue
            if side == "L":
                ops = np.array([cg.MATCH, cg.SOFT_CLIP], dtype=np.int8)
                lens = np.array([j_cut, rl - j_cut], dtype=np.int32)
                new_cigars[r] = (o, ops, lens)
            else:
                ops = np.array([cg.SOFT_CLIP, cg.MATCH], dtype=np.int8)
                lens = np.array([j_cut, rl - j_cut], dtype=np.int32)
                new_cigars[r] = (pos, ops, lens)
    if not new_cigars:
        return batch, 0
    return _rebuild_cigars(batch, new_cigars), len(new_cigars)


def apply_realignments(
    batch: ReadBatch,
    locus_scores: dict,
    loci: list[list[IndelKey]],
    min_lhood_gain: float = LN10,
    unroll_clips: bool = True,
    ref_codes: np.ndarray | None = None,
    ref_offset: int = 0,
) -> tuple[ReadBatch, int]:
    """Rewrite alignments of reads at candidate-indel loci.

    Reads whose indel-haplotype likelihood beats ref by more than the
    smoothing range (smoothed_lnp_range = ln 10; within the range the
    fewer-indel alignment is preferred, isFirstCandidateAlignment-
    Preferred) get the indel embedded. Remaining soft-clipped reads at
    the locus get their clips unrolled into aligned bases — candidate
    alignments cover the whole read and optimal soft clipping is only
    retained in RNA mode (unroll_clips=False), where additionally the
    soft-clipped INPUT alignment is scored and kept whenever it matches
    or beats the chosen realignment (isRetainOptimalSoftClipping /
    isTestSoftClippedInputAligned, starling_read_align.cpp:1711-1745);
    pass ref_codes/ref_offset to enable that re-scoring.

    Returns (new batch, n_realigned). The batch is copied lazily.
    """
    new_cigars: dict[int, tuple[int, np.ndarray, np.ndarray]] = {}
    # batch-level clip/structure table: shared by every locus's reads
    # (the per-read CIGAR parse dominated indel-dense regions)
    clip_l, clip_r, has_complex = aligned_span_table(batch)
    clippable = ((clip_l > 0) | (clip_r > 0)) & ~has_complex
    for li, scores in locus_scores.items():
        keys = loci[li]
        lh = scores.allele_lhoods
        best_alt = np.argmax(lh[:, 1:], axis=1)
        gain = lh[np.arange(len(lh)), 1 + best_alt] - lh[:, 0]
        win = gain > min_lhood_gain
        for i in range(len(lh)):
            r = int(scores.read_rows[i])
            if r in new_cigars:
                continue
            span_r = (int(clip_l[r]), int(clip_r[r]), bool(has_complex[r]))
            if not unroll_clips and ref_codes is not None:
                # RNA mode: keep the soft-clipped input alignment when
                # it scores at least as well as the chosen realignment
                cl, cr = span_r[0], span_r[1]
                if cl or cr:
                    chosen = float(lh[i, 1 + int(best_alt[i])]) if win[i] \
                        else float(lh[i, 0])
                    sc_lnp = score_softclipped_input(batch, r, ref_codes,
                                                     ref_offset,
                                                     span=span_r)
                    if sc_lnp is not None and sc_lnp >= chosen:
                        continue
            if win[i]:
                key = keys[int(best_alt[i])]
                if scores.best_offsets is not None:
                    res = plan_indel_alignment(
                        batch, r, key,
                        scores.best_offsets[i, 1 + int(best_alt[i])],
                        scores.win_begin, span=span_r)
                else:
                    res = realign_read_to_indel(batch, r, key,
                                                span=span_r)
                if res is None and unroll_clips and clippable[r]:
                    res = unroll_read(batch, r, span=span_r)
            else:
                # gapless is the preferred pool member; when any
                # with-indel alignment also sits within the smooth
                # range, its conflicting edge positions get clipped
                res = None
                pool_max = max(float(lh[i, 0]), float(lh[i, 1:].max()))
                alt_in_pool = lh[i, 1:] >= pool_max - min_lhood_gain
                if alt_in_pool.any() and scores.best_offsets is not None:
                    res = clip_ambiguous_edges(
                        batch, r, scores, i, keys, alt_in_pool,
                        has_complex=span_r[2])
                if res is None and unroll_clips and clippable[r]:
                    res = unroll_read(batch, r, span=span_r)
            if res is not None:
                new_cigars[r] = res
    if not new_cigars:
        return batch, 0

    return _rebuild_cigars(batch, new_cigars), len(new_cigars)


def _rebuild_cigars(batch: ReadBatch, new_cigars: dict) -> ReadBatch:
    """Rebuild cigar arrays: untouched runs stay as bulk slices of the
    original arrays (O(k) segments for k realigned reads)."""
    pos = batch.pos.copy()
    touched = sorted(new_cigars)
    op_parts, len_parts = [], []
    new_nseg = np.diff(batch.cig_off).copy()
    prev = 0
    for r in touched:
        if r > prev:
            op_parts.append(batch.cig_ops[batch.cig_off[prev]:batch.cig_off[r]])
            len_parts.append(batch.cig_lens[batch.cig_off[prev]:batch.cig_off[r]])
        p, o, l = new_cigars[r]
        pos[r] = p
        op_parts.append(o)
        len_parts.append(l)
        new_nseg[r] = len(o)
        prev = r + 1
    if prev < batch.n:
        op_parts.append(batch.cig_ops[batch.cig_off[prev]:])
        len_parts.append(batch.cig_lens[batch.cig_off[prev]:])
    cig_off = np.concatenate([[0], np.cumsum(new_nseg)]).astype(np.int64)
    out = ReadBatch(
        n=batch.n, names=batch.names, tid=batch.tid, pos=pos,
        mapq=batch.mapq, flag=batch.flag, mate_tid=batch.mate_tid,
        mate_pos=batch.mate_pos, tlen=batch.tlen, seq=batch.seq,
        qual=batch.qual, seq_off=batch.seq_off,
        cig_ops=np.concatenate(op_parts),
        cig_lens=np.concatenate(len_parts),
        cig_off=cig_off,
    )
    # seq/qual/seq_off are shared with the input batch, so the
    # per-base scoring cache (realign_batch._batch_base_cache) carries
    # over — the somatic path rescoring post-realignment batches would
    # otherwise recompute it per sample per pass
    cache = getattr(batch, "_base_cache", None)
    if cache is not None:
        out._base_cache = cache
    return out
