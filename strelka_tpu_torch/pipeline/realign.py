"""Read realignment scoring: per-read allele likelihoods at indel loci.

TPU-native replacement for the reference's realignment machinery
(reference: starling_read_align.cpp realignAndScoreRead:2026,
candidate_alignment_search:859, scoreCandidateAlignments:1536,
starling_read_align_score_indels.cpp ReadPathScores extraction).

Instead of per-read recursive enumeration of indel on/off toggles,
each candidate-indel locus gets a haplotype set {ref, ref+indel...};
overlapping reads are padded into a tile and scored gaplessly against
every haplotype over an offset window with the batched correlation op
(ops/readlik.py). The per-read max over offsets reproduces the
reference's max-over-candidate-alignments semantics with a superset
path space.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.bam import FLAG_REVERSE, ReadBatch
from ..ops import readlik
from . import reads as rd
from .candidates import IndelKey


@dataclass
class LocusReadScores:
    """Per-read allele log-likelihoods at one locus (the batch analog
    of the reference's per-read ReadPathScores map, IndelData.hh:64)."""
    read_rows: np.ndarray      # [R] row index into source batch
    allele_lhoods: np.ndarray  # [R, A] col 0 = ref
    read_len: np.ndarray       # [R]
    n_nonambig: np.ndarray     # [R]
    is_fwd: np.ndarray         # [R]
    # reads with nonzero but insufficient breakpoint overlap (feeds
    # the reference's n_other_reads tally)
    n_suboverlap: int = 0
    # [R, H] best window offset per haplotype + the window's absolute
    # start (placement of read i on hap h starts at ref coordinate
    # win_begin + best_offsets[i, h] in hap coordinates)
    best_offsets: np.ndarray | None = None
    win_begin: int = 0
    # [R] reads passing the breakpoint-overlap gate for genotyping
    # (None = all); realignment still considers every scored read
    genotyping_mask: np.ndarray | None = None
    # [R] scored reads with nonzero-but-insufficient breakpoint
    # overlap (per-read detail behind n_suboverlap; lets a tier subset
    # recompute its own tally)
    suboverlap_mask: np.ndarray | None = None


def apply_genotyping_mask(scores: "LocusReadScores"):
    """Reduce a scored locus to its breakpoint-overlap-passing reads
    (None when nothing passes); n_suboverlap keeps its tally."""
    gm = scores.genotyping_mask
    if gm is None:
        return scores
    if not gm.any():
        return None
    if gm.all():
        return scores
    return LocusReadScores(
        read_rows=scores.read_rows[gm],
        allele_lhoods=scores.allele_lhoods[gm],
        read_len=scores.read_len[gm],
        n_nonambig=scores.n_nonambig[gm],
        is_fwd=scores.is_fwd[gm],
        n_suboverlap=scores.n_suboverlap,
        best_offsets=(scores.best_offsets[gm]
                      if scores.best_offsets is not None else None),
        win_begin=scores.win_begin,
        suboverlap_mask=(scores.suboverlap_mask[gm]
                         if scores.suboverlap_mask is not None
                         else None),
    )


def apply_indel_to_window(ref_window: np.ndarray, window_begin: int,
                          key: IndelKey, encode) -> np.ndarray:
    """Haplotype codes: window with one indel applied."""
    p = key.pos - window_begin
    left = ref_window[:p]
    right = ref_window[p + key.delete_length:]
    ins = encode(key.insert_seq) if key.insert_seq else np.empty(0, np.uint8)
    return np.concatenate([left, ins, right])


def select_overlapping_reads(ea: rd.ExpandedAlignments, map_level: np.ndarray,
                             key_pos: int, right_pos: int,
                             tiers=(rd.MapLevel.TIER1,),
                             min_bp_flank: int | None = None,
                             insert_len: int = 0,
                             unclipped_begin: np.ndarray | None = None,
                             read_len: np.ndarray | None = None):
    """Reads eligible for ReadPathScores at this indel.

    With min_bp_flank set, applies the reference's breakpoint-overlap
    rule (starling_read_align_score_indels.cpp
    get_alignment_indel_bp_overlap :136-230 + the bpo >=
    min_read_bp_flank gate :610-626): a read is scored when either
    indel breakpoint is straddled with at least `min_bp_flank` read
    bases on its thinner side, measured in unclipped coordinates
    (candidate alignments realign the full read, unrolling soft
    clips); reads with a nonzero-but-insufficient overlap are tallied
    separately (the reference's suboverlap / n_other_reads input).
    Returns (rows, n_suboverlap).

    With min_bp_flank None, keeps the stricter legacy rule (read span
    brackets the whole indel; used for realignment read collection)
    and returns the rows array only.
    """
    # per-(map_level, tiers) mask cache: this runs once per locus, and
    # an O(reads) isin per call dominates indel-dense regions
    cache = getattr(ea, "_tier_mask_cache", None)
    if cache is None or cache[0] is not map_level:
        cache = (map_level, {})
        ea._tier_mask_cache = cache
    in_tier = cache[1].get(tiers)
    if in_tier is None:
        in_tier = np.isin(map_level, tiers)
        cache[1][tiers] = in_tier
    if min_bp_flank is None:
        span = (ea.ref_begin < key_pos) & (ea.ref_end > right_pos)
        # insertions at pos: read must span the insertion point
        point = (ea.ref_begin < key_pos) & (ea.ref_end >= key_pos + 1)
        ok = np.where(right_pos > key_pos, span, point)
        ok &= in_tier
        return np.nonzero(ok)[0]

    assert unclipped_begin is not None and read_len is not None
    alen = read_len

    def bpo_for(begin):
        # read offset of the left breakpoint in the with-indel
        # candidate alignment (approximation: no other indel precedes
        # the breakpoint within the read)
        lrp = key_pos - begin
        rrp = lrp + insert_len
        left_ov = np.maximum(0, np.minimum(lrp, alen - lrp))
        right_ov = np.maximum(0, np.minimum(rrp, alen - rrp))
        return np.maximum(left_ov, right_ov)

    # candidate alignments may either keep the input placement or
    # unroll soft clips across the indel; admit a read when EITHER
    # placement clears the flank (the scored best offset re-tests the
    # overlap afterwards, score_locus)
    bpo = np.maximum(bpo_for(unclipped_begin), bpo_for(ea.ref_begin))
    rows = np.nonzero(in_tier & (bpo >= min_bp_flank))[0]
    n_suboverlap = int((in_tier & (bpo > 0) & (bpo < min_bp_flank)).sum())
    return rows, n_suboverlap


def score_breakpoint_locus(
    batch: ReadBatch,
    ea: rd.ExpandedAlignments,
    map_level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    pos: int,
    side: str,
    bp_seq: np.ndarray,
    window_flank: int = 70,
    max_reads: int = 512,
    tiers=(rd.MapLevel.TIER1, rd.MapLevel.TIER2),
) -> LocusReadScores | None:
    """Score reads near an open breakpoint against {ref, breakpoint}.

    The breakpoint haplotype is the reference up to the junction with
    the observed junction sequence spliced past it (BP_LEFT) or before
    it (BP_RIGHT) and nothing beyond — the gapless analog of the
    reference's BP candidate alignments, where bases past the junction
    become an insert segment scored against the breakpoint insertion
    sequence (starling_read_align.cpp:561-575,701-712 +
    starling_read_align_score.cpp scoreInsertSegment via getInsertSeq).
    """
    from ..io.fasta import encode_bases  # noqa: F401 (parallel to score_locus)

    in_tier = np.isin(map_level, tiers)
    ub = rd.unclipped_read_starts(batch)
    rl_full = np.diff(batch.seq_off)
    touch = (ub < pos + window_flank) & (ub + rl_full > pos - window_flank)
    rows = np.nonzero(in_tier & touch)[0]
    if len(rows) == 0:
        return None
    if len(rows) > max_reads:
        rows = rows[:max_reads]

    read_lens = np.diff(batch.seq_off)[rows].astype(np.int64)
    L = int(read_lens.max())
    R = len(rows)
    win_begin = max(pos - (L + window_flank), ref_offset)
    win_end = min(pos + (L + window_flank), ref_offset + len(ref_codes))
    ref_window = ref_codes[win_begin - ref_offset:win_end - ref_offset]
    p_rel = pos - win_begin

    bp_hap = np.full(len(ref_window), 4, dtype=np.uint8)
    if side == "L":
        bp_hap[:p_rel] = ref_window[:p_rel]
        n = min(len(bp_seq), len(bp_hap) - p_rel)
        bp_hap[p_rel:p_rel + n] = bp_seq[:n]
    else:
        bp_hap[p_rel:] = ref_window[p_rel:]
        n = min(len(bp_seq), p_rel)
        bp_hap[p_rel - n:p_rel] = bp_seq[len(bp_seq) - n:]

    hap_codes = np.stack([ref_window, bp_hap])
    seqs = np.full((R, L), 4, dtype=np.uint8)
    quals = np.zeros((R, L), dtype=np.int32)
    mask = np.zeros((R, L), dtype=bool)
    for i, r in enumerate(rows):
        s = batch.get_seq(r)
        q = batch.get_qual(r)
        seqs[i, :len(s)] = s
        quals[i, :len(q)] = q
        mask[i, :len(s)] = True
    tile = readlik.build_read_tile(seqs, quals, mask)
    hap_onehot = readlik.build_hap_onehot(hap_codes)
    lhoods, best_off = readlik.score_reads_vs_haps(tile, hap_onehot)
    return LocusReadScores(
        read_rows=rows,
        allele_lhoods=np.asarray(lhoods, dtype=np.float64),
        read_len=read_lens,
        n_nonambig=np.asarray(tile.n_valid),
        is_fwd=(batch.flag[rows] & FLAG_REVERSE) == 0,
        best_offsets=np.asarray(best_off),
        win_begin=win_begin,
    )


def score_locus(
    batch: ReadBatch,
    ea: rd.ExpandedAlignments,
    map_level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    alt_keys: list[IndelKey],
    window_flank: int = 70,
    max_reads: int = 512,
    tiers=(rd.MapLevel.TIER1,),
    min_bp_flank: int | None = None,
) -> LocusReadScores | None:
    """Score all eligible reads against {ref} + alt haplotypes."""
    from ..io.fasta import encode_bases

    key0 = alt_keys[0]
    locus_begin = min(k.pos for k in alt_keys)
    locus_end = max(k.right_pos for k in alt_keys)
    n_suboverlap = 0
    if min_bp_flank is None:
        rows = select_overlapping_reads(ea, map_level, key0.pos,
                                        key0.right_pos, tiers=tiers)
    else:
        # admit every read whose unclipped span touches the indel —
        # the breakpoint-overlap gate runs on the SCORED placement of
        # the with-indel haplotype below, exactly as the reference
        # tests the most likely candidate alignment
        ub = rd.unclipped_read_starts(batch)
        rl_full = np.diff(batch.seq_off)
        in_tier = np.isin(map_level, tiers)
        touch = (ub < key0.right_pos + 1) & (ub + rl_full > key0.pos - 1)
        rows = np.nonzero(in_tier & touch)[0]
    if len(rows) == 0:
        return None
    if len(rows) > max_reads:
        rows = rows[:max_reads]

    read_lens = np.diff(batch.seq_off)[rows].astype(np.int64)
    L = int(read_lens.max())
    R = len(rows)

    # window must cover any read placement: reads start at ref_begin -
    # (leading clip); give window_flank + max read len margin
    win_begin = locus_begin - (L + window_flank)
    win_end = locus_end + (L + window_flank)
    win_begin = max(win_begin, ref_offset)
    win_end = min(win_end, ref_offset + len(ref_codes))
    ref_window = ref_codes[win_begin - ref_offset:win_end - ref_offset]

    # haplotype set: ref + each alt
    haps = [ref_window]
    for k in alt_keys:
        haps.append(apply_indel_to_window(ref_window, win_begin, k, encode_bases))
    Lh = max(len(h) for h in haps)
    hap_codes = np.full((len(haps), Lh), 4, dtype=np.uint8)
    for i, h in enumerate(haps):
        hap_codes[i, :len(h)] = h

    # read tile
    seqs = np.full((R, L), 4, dtype=np.uint8)
    quals = np.zeros((R, L), dtype=np.int32)
    mask = np.zeros((R, L), dtype=bool)
    for i, r in enumerate(rows):
        s = batch.get_seq(r)
        q = batch.get_qual(r)
        seqs[i, :len(s)] = s
        quals[i, :len(q)] = q
        mask[i, :len(s)] = True
    tile = readlik.build_read_tile(seqs, quals, mask)
    hap_onehot = readlik.build_hap_onehot(hap_codes)

    lhoods, best_off = readlik.score_reads_vs_haps(tile, hap_onehot)
    lhoods = np.asarray(lhoods, dtype=np.float64)
    keep = np.ones(R, dtype=bool)
    if min_bp_flank is not None:
        # re-test breakpoint overlap on the scored placement of the
        # with-indel haplotype (the reference runs the bpo gate on the
        # most likely candidate alignment containing the indel,
        # starling_read_align_score_indels.cpp :577-626)
        alt_off = np.asarray(best_off)[:, 1].astype(np.int64)
        p = key0.pos - win_begin
        lrp = p - alt_off
        rrp = lrp + key0.insert_length
        lo = np.maximum(0, np.minimum(lrp, read_lens - lrp))
        ro = np.maximum(0, np.minimum(rrp, read_lens - rrp))
        bpo = np.maximum(lo, ro)
        keep = bpo >= min_bp_flank
        n_suboverlap += int((~keep & (bpo > 0)).sum())
        if not keep.all() and keep.sum() == 0:
            return None

    return LocusReadScores(
        read_rows=rows[keep],
        allele_lhoods=lhoods[keep],
        read_len=read_lens[keep],
        n_nonambig=np.asarray(tile.n_valid)[keep],
        is_fwd=(batch.flag[rows[keep]] & FLAG_REVERSE) == 0,
        n_suboverlap=n_suboverlap,
        best_offsets=np.asarray(best_off)[keep],
        win_begin=win_begin,
    )
