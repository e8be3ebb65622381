"""Candidate indel discovery and candidacy testing.

Reference: starling_common/IndelBuffer.cpp|hh (observation store +
signal/noise candidacy test :139-242), IndelKey.hh,
AlleleReportInfoUtil.cpp set_repeat_info (STR context), and
normalizeAlignment.cpp (left-shifting of input indels).

The design is batch-first: all indel observations from a region's reads
are extracted in one pass from the expanded-alignment tables, grouped by
key with numpy, and candidacy is evaluated vectorized (binomial
min-count thresholds from a cache, matching
blt_util/min_count_binom_gte_cache).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.bam import ReadBatch
from ..models.error_model import IndelErrorModel
from ..utils.stats import MinCountBinomGteCache
from . import reads as rd

MIN_CANDIDATE_COV_FLOOR = 2  # IndelBuffer.cpp:162


@dataclass(frozen=True, order=True)
class IndelKey:
    """Normalized indel identity (reference: IndelKey.hh).

    pos: reference position of first deleted base / insertion point.
    delete_length, insert_seq (string over ACGT).
    """
    pos: int
    delete_length: int
    insert_seq: str

    @property
    def insert_length(self) -> int:
        return len(self.insert_seq)

    @property
    def right_pos(self) -> int:
        return self.pos + self.delete_length

    @property
    def is_insertion(self) -> bool:
        return self.insert_length > 0 and self.delete_length == 0

    @property
    def is_deletion(self) -> bool:
        return self.delete_length > 0 and self.insert_length == 0

    @property
    def is_primitive(self) -> bool:
        return self.is_insertion or self.is_deletion

    def __str__(self):
        return f"{self.pos}:{self.delete_length}:{self.insert_seq}"


@dataclass
class IndelSampleObs:
    """Per-sample observation tallies (IndelData.hh IndelSampleData)."""
    tier1_reads: set = field(default_factory=set)
    tier2_reads: set = field(default_factory=set)
    submapped_count: int = 0
    # noise vs hard-read-support distinction is handled by caller


@dataclass
class IndelRecord:
    key: IndelKey
    samples: list[IndelSampleObs]
    is_external: bool = False
    is_forced_output: bool = False
    discovered_in_active_region: bool = False
    # STR context (AlleleReportInfo)
    repeat_unit: str = ""
    ref_repeat_count: int = 1
    indel_repeat_count: int = 1

    @property
    def repeat_unit_length(self) -> int:
        return max(len(self.repeat_unit), 1)


def seq_repeat_unit(seq: str) -> tuple[str, int]:
    """Smallest repeating unit of seq and its count
    (blt_util/seq_util get_seq_repeat_unit)."""
    n = len(seq)
    for u in range(1, n + 1):
        if n % u == 0 and seq == seq[:u] * (n // u):
            return seq[:u], n // u
    return seq, 1


def set_repeat_info(rec: IndelRecord, ref_codes: np.ndarray, ref_offset: int,
                    decode) -> None:
    """STR context for an indel (AlleleReportInfoUtil.cpp:94-186)."""
    key = rec.key
    # indels outside the fetched reference window (reads that extend
    # past the region halo) have no usable context
    if key.pos < ref_offset or key.right_pos > ref_offset + len(ref_codes):
        return
    if key.is_insertion:
        unit, event_count = seq_repeat_unit(key.insert_seq)
        ins_count, del_count = event_count, 0
    elif key.is_deletion:
        deleted = decode(ref_codes[key.pos - ref_offset:key.right_pos - ref_offset])
        unit, event_count = seq_repeat_unit(deleted)
        ins_count, del_count = 0, event_count
    else:
        # swap: only when units match (set_repeat_info swap branch)
        ins_unit, ins_count = seq_repeat_unit(key.insert_seq)
        deleted = decode(ref_codes[key.pos - ref_offset:key.right_pos - ref_offset])
        del_unit, del_count = seq_repeat_unit(deleted)
        if ins_unit != del_unit or not ins_unit:
            return
        unit = ins_unit
    if not unit:
        return
    rec.repeat_unit = unit
    u = len(unit)
    # context repeats up/downstream in reference
    ctx = 0
    i = key.pos - u
    while i >= ref_offset:
        if decode(ref_codes[i - ref_offset:i - ref_offset + u]) != unit:
            break
        ctx += 1
        i -= u
    i = key.right_pos
    while i + u <= ref_offset + len(ref_codes):
        if decode(ref_codes[i - ref_offset:i - ref_offset + u]) != unit:
            break
        ctx += 1
        i += u
    rec.ref_repeat_count = ctx + del_count
    rec.indel_repeat_count = ctx + ins_count


def left_shift_indel(pos: int, del_len: int, ins_seq: np.ndarray,
                     ref_codes: np.ndarray, ref_offset: int):
    """Left-normalize one indel against the reference.

    reference: starling_common/normalizeAlignment.cpp — input alignment
    indels are left-shifted so equivalent observations share a key.
    For a deletion: while ref[pos-1] == ref[pos+len-1], shift left.
    For an insertion: while ref[pos-1] == ins_seq[-1], rotate right.
    """
    ins = list(ins_seq)
    # indels observed past the fetched reference window (reads whose
    # alignment extends beyond the segment halo) are left unshifted —
    # they lie outside the calling region and are dropped downstream
    if del_len > 0 and not ins:
        while (pos - 1 >= ref_offset
               and pos + del_len - 1 - ref_offset < len(ref_codes)
               and ref_codes[pos - 1 - ref_offset]
               == ref_codes[pos + del_len - 1 - ref_offset]):
            pos -= 1
    elif ins and del_len == 0:
        while (pos - 1 >= ref_offset
               and pos - 1 - ref_offset < len(ref_codes)
               and ref_codes[pos - 1 - ref_offset] == ins[-1]):
            ins = [ins[-1]] + ins[:-1]
            pos -= 1
    # swaps (del+ins) are not shifted
    return pos, del_len, np.array(ins, dtype=np.uint8)


@dataclass
class BreakpointRecord:
    """Open breakpoint allele (BP_LEFT / BP_RIGHT): per-sample tier1
    supporting reads + the longest observed junction sequence (the
    reference's breakpointInsertionSequence,
    starling_pos_processor_indel_util.cpp:200-288 + IndelData
    getBreakpointInsertSeq)."""
    tier1_reads: list
    seq: np.ndarray  # base codes crossing the junction (<= maxIndelSize)


class IndelObservationStore:
    """Multi-sample indel observation store (IndelBuffer equivalent)."""

    def __init__(self, n_samples: int):
        self.n_samples = n_samples
        self.records: dict[IndelKey, IndelRecord] = {}
        # open breakpoint observations from oversized read indels:
        # (pos, side) -> BreakpointRecord, where side is "L" (BP_LEFT)
        # or "R" (BP_RIGHT)
        # (starling_pos_processor_indel_util.cpp :200-288 converts
        # indels larger than max_indel_size into breakpoint pairs)
        self.breakpoints: dict[tuple[int, str], BreakpointRecord] = {}

    def add_breakpoint(self, pos: int, side: str, sample: int,
                       read_id: int | None = None,
                       map_level: int = rd.MapLevel.TIER1,
                       seq: np.ndarray | None = None) -> None:
        rec = self.breakpoints.setdefault(
            (pos, side),
            BreakpointRecord(tier1_reads=[set() for _ in
                                          range(self.n_samples)],
                             seq=np.empty(0, np.uint8)))
        if map_level == rd.MapLevel.TIER1 and read_id is not None:
            rec.tier1_reads[sample].add(read_id)
        if seq is not None and len(seq) > len(rec.seq):
            rec.seq = np.asarray(seq, dtype=np.uint8)

    def _get(self, key: IndelKey) -> IndelRecord:
        rec = self.records.get(key)
        if rec is None:
            rec = IndelRecord(key=key, samples=[IndelSampleObs() for _ in range(self.n_samples)])
            self.records[key] = rec
        return rec

    def add_read_observation(self, key: IndelKey, sample: int, read_id: int,
                             map_level: int) -> None:
        rec = self._get(key)
        if map_level == rd.MapLevel.TIER1:
            rec.samples[sample].tier1_reads.add(read_id)
        elif map_level == rd.MapLevel.TIER2:
            rec.samples[sample].tier2_reads.add(read_id)
        else:
            rec.samples[sample].submapped_count += 1

    def add_external(self, key: IndelKey, is_forced: bool = False) -> None:
        rec = self._get(key)
        rec.is_external = True
        rec.is_forced_output = rec.is_forced_output or is_forced


def extract_read_indels(
    batch: ReadBatch,
    ea: rd.ExpandedAlignments,
    map_level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    store: IndelObservationStore,
    sample_index: int,
    max_indel_size: int,
) -> None:
    """Pull indel observations from read alignments into the store.

    Edge (unanchored) indels are skipped, like the reference's edge
    handling in the alignment walkthrough; indels above max_indel_size
    are recorded as open breakpoint (BP_LEFT/BP_RIGHT) observations —
    they never genotype as primitive alleles but are tracked for
    diagnostics and realignment exclusion.
    """
    # identical raw observations recur across many reads (an indel at
    # 40x shows in ~all spanning reads); the left-shift + key build is
    # memoized per (refpos, dlen, ins-bytes)
    key_cache: dict = {}
    from ..io.fasta import decode_bases

    # insertions
    for i in range(len(ea.ins_read)):
        if ea.ins_is_edge[i]:
            continue
        length = int(ea.ins_len[i])
        if length > max_indel_size:
            # oversized indel -> breakpoint pair; the junction sequence
            # is the read's first/last <= max_indel_size bases at the
            # junction (process_simple_indel :272-296)
            p = int(ea.ins_refpos[i])
            r = int(ea.ins_read[i])
            s0, s1 = int(batch.seq_off[r]), int(batch.seq_off[r + 1])
            off = int(ea.ins_readoff[i])
            lvl = int(map_level[r])
            lseq = batch.seq[s0 + off:
                             min(s0 + off + max_indel_size, s1)]
            nro = off + length
            rseq = batch.seq[s0 + max(nro - max_indel_size, 0):s0 + nro]
            store.add_breakpoint(p, "L", sample_index, r, lvl, lseq)
            store.add_breakpoint(p, "R", sample_index, r, lvl, rseq)
            continue
        r = int(ea.ins_read[i])
        seq = batch.seq[batch.seq_off[r] + ea.ins_readoff[i]:
                        batch.seq_off[r] + ea.ins_readoff[i] + length]
        ck = (int(ea.ins_refpos[i]), 0, seq.tobytes())
        key = key_cache.get(ck)
        if key is None:
            pos, _dlen, ins = left_shift_indel(ck[0], 0, seq,
                                               ref_codes, ref_offset)
            key = key_cache[ck] = IndelKey(pos, 0, decode_bases(ins))
        store.add_read_observation(key, sample_index, r, int(map_level[r]))
    # deletions
    for i in range(len(ea.devent_read)):
        if ea.devent_is_edge[i]:
            continue
        length = int(ea.devent_len[i])
        if length > max_indel_size:
            p = int(ea.devent_refpos[i])
            r = int(ea.devent_read[i])
            s0, s1 = int(batch.seq_off[r]), int(batch.seq_off[r + 1])
            off = int(ea.devent_readoff[i])
            lvl = int(map_level[r])
            lseq = batch.seq[s0 + off:
                             min(s0 + off + max_indel_size, s1)]
            rseq = batch.seq[s0 + max(off - max_indel_size, 0):s0 + off]
            store.add_breakpoint(p, "L", sample_index, r, lvl, lseq)
            store.add_breakpoint(p + length, "R", sample_index, r, lvl,
                                 rseq)
            continue
        r = int(ea.devent_read[i])
        ck = (int(ea.devent_refpos[i]), length, b"")
        key = key_cache.get(ck)
        if key is None:
            pos, _dlen, _ins = left_shift_indel(ck[0], length,
                                                np.empty(0, np.uint8),
                                                ref_codes, ref_offset)
            key = key_cache[ck] = IndelKey(pos, length, "")
        store.add_read_observation(key, sample_index, r, int(map_level[r]))


def estimated_depth(batch: ReadBatch, ea: rd.ExpandedAlignments,
                    map_level: np.ndarray, region_begin: int,
                    region_end: int) -> np.ndarray:
    """Tier1 read-span depth buffer (the reference's ebuff: depth_buffer
    incremented over each read's reference span at buffer insert)."""
    L = region_end - region_begin
    diff = np.zeros(L + 1, dtype=np.int64)
    t1 = map_level == rd.MapLevel.TIER1
    b = np.clip(ea.ref_begin[t1], region_begin, region_end) - region_begin
    e = np.clip(ea.ref_end[t1], region_begin, region_end) - region_begin
    ok = e > b
    np.add.at(diff, b[ok], 1)
    np.add.at(diff, e[ok], -1)
    return np.cumsum(diff[:-1]).astype(np.int32)


def evaluate_breakpoint_candidacy(
    store: IndelObservationStore,
    est_depth: np.ndarray,
    region_begin: int,
    error_model: IndelErrorModel,
    alpha: float,
    min_open_length: int = 20,
) -> list[tuple[int, str, np.ndarray]]:
    """Candidate open breakpoints: same binomial signal test as indels
    (IndelBuffer.cpp:139-193) plus the minimum junction-sequence length
    (min_candidate_indel_open_length = 20,
    starling_base_shared.hh:157; IndelBuffer.cpp:237-242). Returns
    [(pos, side, junction_seq_codes)] sorted by position."""
    cache = MinCountBinomGteCache(alpha)
    # breakpoints take the non-STR default candidacy rate (unit length
    # 1, repeat count 1)
    ref_to_bp, _ = error_model.get_rates(0, 1, 1, 1, True,
                                         is_candidate=True)
    out = []
    for (pos, side), rec in sorted(store.breakpoints.items()):
        if len(rec.seq) < min_open_length:
            continue
        for s in range(store.n_samples):
            support = len(rec.tier1_reads[s])
            dpos = pos - 1 - region_begin
            total = int(est_depth[dpos]) if 0 <= dpos < len(est_depth) else 0
            total = max(total, support)
            if total < MIN_CANDIDATE_COV_FLOOR:
                continue
            if cache.is_reject_null(float(ref_to_bp), support, total):
                out.append((pos, side, rec.seq))
                break
    return out


def evaluate_candidacy(
    store: IndelObservationStore,
    est_depth: np.ndarray,
    region_begin: int,
    error_model: IndelErrorModel,
    ref_codes: np.ndarray,
    ref_offset: int,
    alpha: float,
    require_active_region_discovery: bool = False,
    max_candidate_depth: float = 0.0,
) -> dict[IndelKey, bool]:
    """Vectorized candidacy over all stored indels.

    reference: IndelBuffer.cpp isCandidateIndelImplTest* (:139-242).
    """
    from ..io.fasta import decode_bases
    cache = MinCountBinomGteCache(alpha)
    out: dict[IndelKey, bool] = {}
    for key, rec in store.records.items():
        if not key.is_primitive and not rec.is_external:
            out[key] = False
            continue
        if require_active_region_discovery and not (
                rec.discovered_in_active_region or rec.is_external):
            out[key] = False
            continue
        # STR context + candidacy error rate
        if not rec.repeat_unit:
            set_repeat_info(rec, ref_codes, ref_offset, decode_bases)
        ref_to_indel, _ = error_model.get_rates(
            0, rec.repeat_unit_length, rec.ref_repeat_count,
            rec.indel_repeat_count, key.is_insertion, is_candidate=True)
        is_cand = False
        for s in range(store.n_samples):
            support = len(rec.samples[s].tier1_reads)
            dpos = key.pos - 1 - region_begin
            total = int(est_depth[dpos]) if 0 <= dpos < len(est_depth) else 0
            total = max(total, support)
            if total < MIN_CANDIDATE_COV_FLOOR:
                continue
            if cache.is_reject_null(float(ref_to_indel), support, total):
                is_cand = True
                break
        if not is_cand and rec.is_external:
            is_cand = key.is_primitive
        if is_cand and max_candidate_depth > 0:
            dpos = key.pos - 1 - region_begin
            total = int(est_depth[dpos]) if 0 <= dpos < len(est_depth) else 0
            if total > max_candidate_depth:
                is_cand = False
        out[key] = is_cand
    return out
