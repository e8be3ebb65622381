"""Active region detection and haplotype discovery.

Reference: starling_common/ActiveRegionDetector.{hh,cpp},
ActiveRegionReadBuffer.{hh,cpp} (evidence weights: mismatch +1 at pos,
indel +4 at flanking/deleted positions, soft-clip +4; candidate test
isCandidateVariant :258-269), ReferenceRepeatFinder.cpp (anchor = not
inside any STR with unit <=50 spanning >= max(2*unit, 3)),
SampleActiveRegionDetector::updateEndPosition (region state machine,
ActiveRegionDetector.cpp:337-410), ActiveRegionProcessor.{hh,cpp}
(haplotype generation by counting, min support 3, top-ploidy selection;
assembly fallback for low-spanning regions).

TPU-native redesign: evidence/depth/anchor tracks are computed for the
whole region in vectorized numpy passes; only the sparse
candidate-or-anchor positions go through the (exact) region state
machine; haplotype counting uses the expanded per-base tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.bam import ReadBatch
from ..io.fasta import decode_bases, encode_bases
from ..ops.aligner import align_global
from ..utils import cigar as cg
from . import reads as rd
from .candidates import IndelKey

MISMATCH_WEIGHT = 1
INDEL_WEIGHT = 4
MIN_NUM_VARIANTS_PER_POSITION = 9
MIN_ALT_FRACTION = 0.2
MIN_ALT_FRACTION_LOW_DEPTH = 0.35
MAX_DISTANCE_BETWEEN_TWO_VARIANTS = 13
MIN_NUM_VARIANTS_PER_REGION = 2
MAX_REPEAT_UNIT_LENGTH = 50
MIN_REPEAT_SPAN = 3
MIN_FRAC_READS_COVERING_REGION = 0.65  # ActiveRegionProcessor.hh:53
MIN_HAPLOTYPE_COUNT = 3
MAX_REF_SPAN_FOR_ASSEMBLY = 250        # MaxRefSpanToBypassAssembly
MAX_MISMATCHES_TO_BUFFER = 10  # MaxNumMismatchesToAddToIndelBuffer
MAX_ASSEMBLY_PADDING = 9       # ActiveRegionReadBuffer.hh:69
MAX_READS_FOR_ASSEMBLY = 1000  # MinNumReadsToBypassAssembly (hh:50)
MAX_ASSEMBLY_WORD_SIZE = 76    # ActiveRegionProcessor.hh:59
MIN_ASSEMBLY_COVERAGE = 3      # ActiveRegionProcessor.hh:60
MIN_PHASE_ERROR_HPOL_SIZE = 10  # ActiveRegionProcessor.cpp:330


def anchor_mask(ref_codes: np.ndarray, use_native: bool = True) -> np.ndarray:
    """[L] bool: position is a valid active-region anchor (not inside
    an STR). Vectorized ReferenceRepeatFinder.updateRepeatSpan; the
    native path (native/activeregion.cpp anchor_spans) is exact."""
    if use_native:
        from ..io.native import anchor_mask_native
        res = anchor_mask_native(ref_codes)
        if res is not None:
            return res
    L = len(ref_codes)
    anchor = np.ones(L, dtype=bool)
    for u in range(1, MAX_REPEAT_UNIT_LENGTH + 1):
        if u >= L:
            break
        match = np.zeros(L, dtype=bool)
        match[u:] = (ref_codes[u:] == ref_codes[:-u]) & (ref_codes[:-u] != 4)
        # repeat span ending at pos: u + run_length_of_match_ending_at_pos
        run = np.zeros(L, dtype=np.int64)
        idx = np.arange(L)
        # run-length via cumulative count reset at non-match
        cums = np.cumsum(match)
        last_false = np.maximum.accumulate(np.where(~match, idx, -1))
        run = np.where(match, idx - last_false, 0)
        span = u + run
        in_repeat = (span >= 2 * u) & (span >= MIN_REPEAT_SPAN) & (run > 0)
        if not in_repeat.any():
            continue
        # positions [pos-span+1, pos] are non-anchor for each repeat pos;
        # equivalently mark a run [start, end] for maximal repeats
        rep_idx = np.nonzero(in_repeat)[0]
        starts = rep_idx - span[rep_idx] + 1
        diff = (np.bincount(np.maximum(starts, 0), minlength=L + 1)
                - np.bincount(rep_idx + 1, minlength=L + 1))
        covered = np.cumsum(diff[:L]) > 0
        anchor &= ~covered
    return anchor


def variant_evidence(batch: ReadBatch, ea: rd.ExpandedAlignments,
                     map_level: np.ndarray, ref_codes: np.ndarray,
                     region_begin: int, region_end: int,
                     use_native: bool = True):
    """(variant_count, depth) per position
    (ActiveRegionReadBuffer insert* weights; every addVariantCount
    call also increments the position depth, hh:263-268).

    Evidence: mismatches +1 (char comparison — N read bases against a
    called reference base DO count); non-edge insertions +4 at pos-1
    and pos; non-edge deletions +4 at each deleted base and pos-1;
    soft clips +4 at the clip position (insertSoftClipSegment)."""
    if use_native and batch.n:
        from ..io.native import ar_evidence_native
        res = ar_evidence_native(batch, map_level, ref_codes,
                                 region_begin, region_end)
        if res is not None:
            return res
    L = region_end - region_begin
    counts = np.zeros(L, dtype=np.int64)
    depth = np.zeros(L, dtype=np.int64)
    usable = np.isin(map_level, (rd.MapLevel.TIER1, rd.MapLevel.TIER2))

    msel = usable[ea.match_read] & (ea.match_refpos >= region_begin) & \
        (ea.match_refpos < region_end)
    mp = ea.match_refpos[msel] - region_begin
    np.add.at(depth, mp, 1)
    base = np.minimum(
        batch.seq[batch.seq_off[ea.match_read[msel]] + ea.match_readoff[msel]],
        4)
    refb = np.minimum(ref_codes[mp], 4)
    mm = base != refb
    np.add.at(counts, mp[mm], MISMATCH_WEIGHT)

    # insertions: +4 (and +1 depth) at pos-1 and pos
    isel = usable[ea.ins_read] & ~ea.ins_is_edge
    for off in (-1, 0):
        p = ea.ins_refpos[isel] + off - region_begin
        ok = (p >= 0) & (p < L)
        np.add.at(counts, p[ok], INDEL_WEIGHT)
        np.add.at(depth, p[ok], 1)
    # deletions: +4 (and +1 depth) at each deleted base and pos-1
    dsel = usable[ea.del_read] & ~ea.del_is_edge
    p = ea.del_refpos[dsel] - region_begin
    ok = (p >= 0) & (p < L)
    np.add.at(counts, p[ok], INDEL_WEIGHT)
    np.add.at(depth, p[ok], 1)
    desel = usable[ea.devent_read] & ~ea.devent_is_edge
    p = ea.devent_refpos[desel] - 1 - region_begin
    ok = (p >= 0) & (p < L)
    np.add.at(counts, p[ok], INDEL_WEIGHT)
    np.add.at(depth, p[ok], 1)

    # soft clips: +4 (and +1 depth) at ref_head_pos-1 (leading) /
    # ref_head_pos (trailing)
    first = batch.cig_off[:-1]
    last = batch.cig_off[1:] - 1
    has = np.diff(batch.cig_off) > 0
    rows = np.nonzero(has & usable)[0]
    lead = rows[batch.cig_ops[first[rows]] == cg.SOFT_CLIP]
    trail = rows[batch.cig_ops[last[rows]] == cg.SOFT_CLIP]
    for sel, off_arr in ((lead, batch.pos[lead] - 1),
                        (trail, ea.ref_end[trail])):
        p = off_arr - region_begin
        ok = (p >= 0) & (p < L)
        np.add.at(counts, p[ok], INDEL_WEIGHT)
        np.add.at(depth, p[ok], 1)
    return counts, depth


@dataclass
class ActiveRegion:
    begin: int
    end: int  # half-open


def find_active_regions(counts, depth, anchors, ref_codes,
                        region_begin: int,
                        use_native: bool = True) -> list[ActiveRegion]:
    """The region state machine over sparse candidate/anchor positions
    (SampleActiveRegionDetector::updateEndPosition exact port; the
    native path in native/activeregion.cpp is the same machine)."""
    if use_native:
        from ..io.native import find_active_regions_native
        res = find_active_regions_native(counts, depth, anchors,
                                         ref_codes, region_begin)
        if res is not None:
            return [ActiveRegion(int(b), int(e))
                    for b, e in zip(res[0], res[1])]
    L = len(counts)
    is_cand = (ref_codes[:L] != 4) & (
        ((counts >= MIN_NUM_VARIANTS_PER_POSITION)
         & (counts >= MIN_ALT_FRACTION * depth))
        | (counts >= MIN_ALT_FRACTION_LOW_DEPTH * np.maximum(depth, 1)))
    # zero-depth positions can't open a region (handled in loop)
    is_anchor = anchors[:L] & ~is_cand

    regions: list[ActiveRegion] = []
    start_pos = region_begin
    prev_anchor = region_begin
    anchor_after_prev_variant = region_begin
    prev_variant_pos = region_begin - 10_000
    num_variants = 0

    interesting = np.nonzero(is_cand | is_anchor)[0]
    for i in interesting:
        pos = region_begin + int(i)
        cand = bool(is_cand[i])
        if cand and depth[i] == 0 and num_variants == 0:
            cand = False
            if not is_anchor[i]:
                continue
        anchor = bool(is_anchor[i]) and not cand
        dist = pos - prev_variant_pos
        if dist > MAX_DISTANCE_BETWEEN_TWO_VARIANTS and anchor_after_prev_variant is not None:
            if num_variants >= MIN_NUM_VARIANTS_PER_REGION:
                regions.append(ActiveRegion(start_pos, anchor_after_prev_variant + 1))
            num_variants = 0
        if anchor:
            if num_variants == 0:
                start_pos = pos
            if anchor_after_prev_variant is None:
                anchor_after_prev_variant = pos
            prev_anchor = pos
        if cand:
            if num_variants == 0:
                start_pos = prev_anchor
            num_variants += 1
            prev_variant_pos = pos
            anchor_after_prev_variant = None
    if num_variants >= MIN_NUM_VARIANTS_PER_REGION:
        end = anchor_after_prev_variant if anchor_after_prev_variant is not None \
            else region_begin + L - 1
        regions.append(ActiveRegion(start_pos, end + 1))
    return regions


@dataclass
class DiscoveredVariants:
    """Primitive variants discovered from selected haplotypes.

    hap ids accumulate like the reference's IndelSampleData.haplotypeId
    (ActiveRegionProcessor.cpp:751): 1 or 2 for a variant on one alt
    haplotype, 3 when both alt haplotypes carry it.

    bypassed=True means haplotyping failed (region too large, or both
    counting and assembly failed): the caller must mark every indel in
    the region as active-region-discovered so normal binomial candidacy
    applies (doNotUseHaplotyping, ActiveRegionProcessor.cpp:266-292)."""
    indels: list[tuple[IndelKey, int]] = field(default_factory=list)  # (key, hap_id)
    snvs: list[tuple[int, int, int]] = field(default_factory=list)    # (pos, base, hap_id)
    bypassed: bool = False
    # altHaplotypeCountRatio accumulation (ActiveRegionProcessor.cpp
    # :718-719 supporting-read count / reads used to generate
    # haplotypes, summed over the alt haplotypes carrying the variant:
    # CandidateSnvBuffer.cpp addCandidateSnv + IndelData
    # altAlleleHaplotypeCountRatio += at :755). Feeds the EVS
    # NormalizedAltHaplotypeCountRatio feature.
    snv_ratio: dict = field(default_factory=dict)     # pos -> ratio
    indel_ratio: dict = field(default_factory=dict)   # IndelKey -> ratio
    # supporting read rows per discovered indel: the reference adds an
    # indel-buffer OBSERVATION for every read backing the haplotype
    # (ActiveRegionProcessor.cpp:739-755 addIndelObservation per
    # alignId) — without this, a discovered key whose aligner placement
    # normalizes differently from the read-CIGAR key has no read
    # support and silently fails candidacy (round-5 insertion-FN class)
    indel_read_ids: dict = field(default_factory=dict)  # IndelKey -> set


def candidate_variant_mask(counts: np.ndarray, depth: np.ndarray,
                           ref_codes: np.ndarray) -> np.ndarray:
    """Exact ActiveRegionReadBuffer::isCandidateVariant (:257-269):
    note a zero-depth non-N position satisfies the low-depth fraction
    test (0 >= 0.35*0), so it stops assembly-anchor expansion."""
    L = len(counts)
    return (ref_codes[:L] != 4) & (
        ((counts >= MIN_NUM_VARIANTS_PER_POSITION)
         & (counts >= MIN_ALT_FRACTION * depth))
        | (counts >= MIN_ALT_FRACTION_LOW_DEPTH * depth))


def _is_sequencer_phasing_noise(hap_to_ids: dict, hap1, hap2,
                                is_fwd: np.ndarray | None) -> bool:
    """isFilterSecondHaplotypeAsSequencerPhasingNoise
    (ActiveRegionProcessor.cpp:317-411): hap2 is a phasing-error echo
    of hap1 when they differ by exactly one base, hap2's unique support
    is single-stranded, and the changed base extends a >=10bp
    homopolymer in the strand-consistent direction."""
    if is_fwd is None:
        return False
    # condition 1: same length, exactly one mismatch
    if len(hap1) != len(hap2) or hap1 == hap2:
        return False
    n = len(hap1)
    mis = next(i for i in range(n) if hap1[i] != hap2[i])
    if any(hap1[i] != hap2[i] for i in range(mis + 1, n)):
        return False
    # condition 2: hap2's non-duplicate support is exclusively stranded
    dups = set(hap_to_ids[hap1]) & set(hap_to_ids[hap2])
    unique2 = [r for r in hap_to_ids[hap2] if r not in dups]
    n2 = len(unique2)
    fwd2 = sum(1 for r in unique2 if is_fwd[r])
    if 0 < fwd2 < n2:
        return False
    # conditions 3+4: the mismatch base heads a long homopolymer in
    # hap2, running right for reverse-only support, left for fwd-only
    base = hap2[mis]
    if fwd2 == 0:
        j = mis
        while j < n and hap2[j] == base:
            j += 1
        return (j - mis) > MIN_PHASE_ERROR_HPOL_SIZE
    j = mis
    while hap2[j] == base and j > 0:
        j -= 1
    return (mis - j) > MIN_PHASE_ERROR_HPOL_SIZE


def select_haplotypes(hap_to_ids: dict, ref_hap, ploidy: int,
                      is_fwd: np.ndarray | None) -> list:
    """ActiveRegionProcessor::selectHaplotypes (:416-483) +
    selectOrDropHaplotypesWithSameCount (:485-514). Haplotypes below
    MinHaplotypeCount support are dropped; the rest are scanned in
    descending count order, whole same-count groups selected or dropped
    together, up to ploidy haplotypes (ploidy+1 when the reference
    haplotype is among them). Ties are ordered lexicographically (the
    reference's tie order is unordered_map/std::sort-unspecified)."""
    ranked = sorted(((len(ids), h) for h, ids in hap_to_ids.items()
                     if len(ids) >= MIN_HAPLOTYPE_COUNT),
                    key=lambda x: (-x[0], x[1]))
    if not ranked:
        return []
    top_hap = ranked[0][1]
    selected: list = []
    same_count: list = []
    is_ref_selected = False

    def flush():
        n_after = len(selected) + len(same_count)
        if same_count and (n_after <= ploidy
                           or (n_after == ploidy + 1 and is_ref_selected)):
            selected.extend(same_count)
            same_count.clear()

    prev_count = None
    for count, hap in ranked:
        if prev_count is None or count < prev_count:
            flush()
        if len(selected) >= ploidy:
            break
        if not _is_sequencer_phasing_noise(hap_to_ids, top_hap, hap,
                                           is_fwd):
            same_count.append(hap)
            if hap == ref_hap:
                is_ref_selected = True
        prev_count = count
    flush()
    return selected


def _region_scan_ctx(batch: ReadBatch, ea: rd.ExpandedAlignments,
                     map_level: np.ndarray):
    """Cached (usable mask, max aligned span): regions are processed in
    the hundreds per batch, so the O(reads) mask and span reduction must
    not be recomputed per region."""
    ctx = getattr(ea, "_region_scan_ctx", None)
    if ctx is None or ctx[0] is not map_level:
        usable = np.isin(map_level, (rd.MapLevel.TIER1, rd.MapLevel.TIER2))
        max_span = int((ea.ref_end - batch.pos).max()) if batch.n else 0
        ctx = (map_level, usable, max(max_span, 1))
        ea._region_scan_ctx = ctx
    return ctx[1], ctx[2]


def read_segments_for_region(batch: ReadBatch, ea: rd.ExpandedAlignments,
                             map_level: np.ndarray, begin: int, end: int):
    """Read segments fully covering [begin, end) in haplotype space,
    as raw base-code bytes (base-code byte order == ACGT lexicographic
    order, so downstream tie-breaks match string semantics).

    Uses the aligned per-base table: the segment runs from the read
    offset aligned at begin to the offset aligned at end-1 (inclusive),
    naturally including inserted bases between them.
    """
    usable, max_span = _region_scan_ctx(batch, ea, map_level)
    # batch.pos ascends and ref_begin >= pos, ref_end <= pos + max_span:
    # only reads with pos in (begin - max_span, begin] can span the
    # region, so the O(reads) comparisons run on that window only.
    lo = int(np.searchsorted(batch.pos, begin - max_span, side="left"))
    hi = int(np.searchsorted(batch.pos, begin, side="right"))
    w = slice(lo, hi)
    spanning = lo + np.nonzero(usable[w] & (ea.ref_begin[w] <= begin) &
                               (ea.ref_end[w] >= end))[0]
    # numReadsAlignedToActiveRegion: every usable read whose alignment
    # intersects [begin, end) (getReadSegments allAlignIds) — the
    # denominator of the counting give-up test
    hi2 = int(np.searchsorted(batch.pos, end, side="right"))
    w2 = slice(lo, hi2)
    n_aligned = int(np.count_nonzero(
        usable[w2] & (ea.ref_begin[w2] < end) & (ea.ref_end[w2] > begin)))
    # match rows are contiguous and ascending in read index (the
    # expansion emits reads in order), so each read's rows are a slice.
    # The probe array must match the table dtype exactly or numpy casts
    # the whole multi-million-row table per call.
    probe = spanning.astype(ea.match_read.dtype, copy=False)
    row_lo = np.searchsorted(ea.match_read, probe, side="left")
    row_hi = np.searchsorted(ea.match_read, probe, side="right")
    if (len(spanning) and ea.match_refpos.dtype == np.int32
            and ea.match_readoff.dtype == np.int32
            and ea.match_refpos.flags.c_contiguous
            and ea.match_readoff.flags.c_contiguous
            and batch.seq.flags.c_contiguous
            and batch.seq_off.dtype == np.int64):
        from ..io.native import region_segments_native
        res = region_segments_native(
            ea.match_refpos, ea.match_readoff, row_lo, row_hi, spanning,
            batch.seq, batch.seq_off, begin, end)
        if res is not None:
            o0s, o1s, valid = res
            segs = [(int(r),
                     batch.seq[batch.seq_off[r] + o0:
                               batch.seq_off[r] + o1 + 1].tobytes())
                    for r, o0, o1 in zip(spanning[valid], o0s[valid],
                                         o1s[valid])]
            return segs, n_aligned
    segs = []
    for r, lo, hi in zip(spanning, row_lo, row_hi):
        rp = ea.match_refpos[lo:hi]
        ro = ea.match_readoff[lo:hi]
        m0 = rp == begin
        m1 = rp == end - 1
        if not (m0.any() and m1.any()):
            continue  # deletion covers a boundary base
        o0 = int(ro[m0][0])
        o1 = int(ro[m1][-1])
        seq = batch.get_seq(r)[o0:o1 + 1]
        if (seq >= 4).any():
            continue
        segs.append((int(r), seq.tobytes()))
    return segs, n_aligned


def decompose_haplotype(hap: bytes, ref_seg: np.ndarray, region_begin: int,
                        hap_id: int, out: DiscoveredVariants) -> None:
    """Align one haplotype (base-code bytes) to the region's reference
    and emit primitive variants
    (ActiveRegionProcessor::processSelectedHaplotypes)."""
    q = np.frombuffer(hap, dtype=np.uint8)
    score, ops, lens = align_global(q, ref_seg)
    del score
    rpos = region_begin
    qpos = 0
    n_mismatch = 0
    for o, ln in zip(ops, lens):
        if o == cg.MATCH:
            for k in range(ln):
                if q[qpos + k] != ref_seg[rpos + k - region_begin]:
                    out.snvs.append((rpos + k, int(q[qpos + k]), hap_id))
                    n_mismatch += 1
            rpos += ln
            qpos += ln
        elif o == cg.INSERT:
            out.indels.append(
                (IndelKey(rpos, 0, decode_bases(q[qpos:qpos + ln])),
                 hap_id))
            qpos += ln
        elif o == cg.DELETE:
            out.indels.append((IndelKey(rpos, int(ln), ""), hap_id))
            rpos += ln
    del n_mismatch


def _partial_read_segments(batch: ReadBatch, ea: rd.ExpandedAlignments,
                           map_level: np.ndarray, begin: int, end: int,
                           min_len: int):
    """Read sub-segments overlapping [begin, end) for assembly input
    (getReadSegments with includePartialReads=true,
    ActiveRegionReadBuffer.cpp:191-255): the read bases aligned from
    the first to the last in-range matched position, inserted bases
    included, shorter-than-min_len segments dropped. N bases are kept
    (the assembler skips N k-mers). Returns (segments, n_aligned)."""
    usable, max_span = _region_scan_ctx(batch, ea, map_level)
    lo = int(np.searchsorted(batch.pos, begin - max_span, "left"))
    hi = int(np.searchsorted(batch.pos, end, "right"))
    w = slice(lo, hi)
    overl = lo + np.nonzero(usable[w] & (ea.ref_begin[w] < end) &
                            (ea.ref_end[w] > begin))[0]
    probe = overl.astype(ea.match_read.dtype, copy=False)
    row_lo = np.searchsorted(ea.match_read, probe, side="left")
    row_hi = np.searchsorted(ea.match_read, probe, side="right")
    segs: list[tuple[int, str]] = []
    for r, rl, rh in zip(overl, row_lo, row_hi):
        rp = ea.match_refpos[rl:rh]
        sel = (rp >= begin) & (rp < end)
        if not sel.any():
            continue
        ro = ea.match_readoff[rl:rh][sel]
        o0 = int(ro.min())
        o1 = int(ro.max())
        if o1 - o0 + 1 < min_len:
            continue
        segs.append((int(r), decode_bases(batch.get_seq(r)[o0:o1 + 1])))
    return segs, len(overl)


def _haplotypes_with_assembly(batch, ea, map_level, ref_codes, ref_offset,
                              region, cand_mask):
    """generateHaplotypesWithAssembly (ActiveRegionProcessor.cpp:117-263):
    expand the region with anchors that stop at candidate-variant
    positions, assemble partial read segments, and trim contigs back to
    the active-region span by anchor match. Returns hap->align-id map
    (str haplotypes) or None on failure."""
    from .assembly import AssemblerOptions, run_iterative_assembler
    buf_begin = ref_offset
    buf_end = ref_offset + len(ref_codes)

    def is_cand(pos: int) -> bool:
        if cand_mask is None:
            return False
        i = pos - ref_offset
        return bool(cand_mask[i]) if 0 <= i < len(cand_mask) else False

    # prefix anchor ends with the first base of the active region
    min_begin = max(buf_begin, region.begin - MAX_ASSEMBLY_PADDING)
    begin_pos = region.begin
    while begin_pos > min_begin and not is_cand(begin_pos - 1):
        begin_pos -= 1
    # suffix anchor starts with the last base of the active region
    max_end = min(buf_end, region.end + MAX_ASSEMBLY_PADDING)
    end_pos = region.end
    while end_pos < max_end and not is_cand(end_pos):
        end_pos += 1
    prefix = decode_bases(
        ref_codes[begin_pos - ref_offset:region.begin - ref_offset + 1])
    suffix = decode_bases(
        ref_codes[region.end - 1 - ref_offset:end_pos - ref_offset])
    min_word = len(prefix) + len(suffix)

    segs, n_aligned = _partial_read_segments(
        batch, ea, map_level, begin_pos, end_pos, min_word)
    # too many reads: assembly would be too slow (hh:50)
    if n_aligned > MAX_READS_FOR_ASSEMBLY:
        return None

    seg_read_ids = [r for r, _ in segs]
    contigs, read_info = run_iterative_assembler(
        [s for _, s in segs],
        AssemblerOptions(min_word_length=min_word,
                         max_word_length=max(min_word,
                                             MAX_ASSEMBLY_WORD_SIZE),
                         min_coverage=MIN_ASSEMBLY_COVERAGE))

    ref_str = decode_bases(
        ref_codes[region.begin - ref_offset:region.end - ref_offset])
    hap_to_ids: dict[str, list[int]] = {}
    nonref_found = False
    for contig in contigs:
        start = contig.seq.find(prefix)
        if start < 0:
            continue
        start += len(prefix) - 1
        end = contig.seq.rfind(suffix)
        if end < 0 or start > end:
            continue
        hap = contig.seq[start:end + 1]
        align_ids = []
        contains_unique = False
        for r in sorted(contig.support_reads):
            ri = read_info[r]
            if ri.is_pseudo:
                continue
            if not contains_unique and len(ri.contig_ids) == 1:
                contains_unique = True
            align_ids.append(seg_read_ids[r])
        # require a read supporting only this contig (:246-249)
        if not contains_unique:
            continue
        if hap != ref_str:
            nonref_found = True
        hap_to_ids[hap] = align_ids
    if not nonref_found:
        return None
    return hap_to_ids


def process_active_region(
    batch: ReadBatch,
    ea: rd.ExpandedAlignments,
    map_level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    region: ActiveRegion,
    ploidy: int = 2,
    cand_mask: np.ndarray | None = None,
) -> DiscoveredVariants:
    """Haplotype generation (counting, assembly fallback) + selection +
    haplotype->ref decomposition
    (ActiveRegionProcessor::processHaplotypes, :45-77). Oversized
    regions and regions where both generators fail return
    bypassed=True; the caller then exempts the region's indels from the
    haplotyping candidacy gate (doNotUseHaplotyping)."""
    out = DiscoveredVariants()
    if region.end - region.begin > MAX_REF_SPAN_FOR_ASSEMBLY:
        out.bypassed = True
        return out
    ref_seg = ref_codes[region.begin - ref_offset:region.end - ref_offset]
    ref_bytes = np.ascontiguousarray(ref_seg, dtype=np.uint8).tobytes()
    is_fwd = (batch.flag & 0x10) == 0 if batch.n else None

    segs, n_aligned = read_segments_for_region(
        batch, ea, map_level, region.begin, region.end)

    selected: list[bytes] = []
    hap_support: dict[bytes, int] = {}
    n_reads_used = 0
    if (n_aligned > 0
            and len(segs) >= MIN_FRAC_READS_COVERING_REGION * n_aligned):
        # generateHaplotypesWithCounting (:79-115)
        hap_to_ids: dict[bytes, list[int]] = {}
        for ridx, s in segs:
            hap_to_ids.setdefault(s, []).append(ridx)
        selected = select_haplotypes(hap_to_ids, ref_bytes, ploidy, is_fwd)
        hap_support = {h: len(ids) for h, ids in hap_to_ids.items()}
        hap_ids = hap_to_ids
        # _numReadsUsedToGenerateHaplotypes = reads aligned to the
        # region in the counting path (ActiveRegionProcessor.cpp:94)
        n_reads_used = n_aligned
    else:
        hap_map = _haplotypes_with_assembly(
            batch, ea, map_level, ref_codes, ref_offset, region, cand_mask)
        if hap_map is None:
            out.bypassed = True
            return out
        ref_str = decode_bases(ref_seg)
        selected = [encode_bases(h).tobytes()
                    for h in select_haplotypes(hap_map, ref_str, ploidy,
                                               is_fwd)]
        hap_support = {encode_bases(h).tobytes(): len(ids)
                       for h, ids in hap_map.items()}
        hap_ids = {encode_bases(h).tobytes(): ids
                   for h, ids in hap_map.items()}
        # assembly path (:205 totalNumReadsUsedInAssembly): distinct
        # reads contributing to any assembled haplotype
        n_reads_used = len({i for ids in hap_map.values() for i in ids})

    # processSelectedHaplotypes (:515-571): alt haplotypes get ids 1..;
    # a variant on both alt haplotypes accumulates id 3 (:751)
    hap_id = 0
    acc_indels: dict[IndelKey, int] = {}
    acc_snvs: dict[tuple[int, int], int] = {}
    for h in selected:
        if h == ref_bytes:
            continue
        hap_id += 1
        # supporting-read count ratio for this alt haplotype (:718-719)
        ratio = hap_support.get(h, 0) / max(n_reads_used, 1)
        tmp = DiscoveredVariants()
        decompose_haplotype(h, ref_seg, region.begin, hap_id, tmp)
        for key, hid in tmp.indels:
            acc_indels[key] = acc_indels.get(key, 0) + hid
            out.indel_ratio[key] = out.indel_ratio.get(key, 0.0) + ratio
            out.indel_read_ids.setdefault(key, set()).update(
                int(r) for r in hap_ids.get(h, ()))
        for pos, base, hid in tmp.snvs:
            acc_snvs[(pos, base)] = acc_snvs.get((pos, base), 0) + hid
            out.snv_ratio[pos] = out.snv_ratio.get(pos, 0.0) + ratio
    out.indels = list(acc_indels.items())
    out.snvs = [(pos, base, hid) for (pos, base), hid in acc_snvs.items()]
    return out
