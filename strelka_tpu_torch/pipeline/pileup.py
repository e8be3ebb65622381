"""Dense pileup tile construction from expanded alignments.

TPU-native replacement for the reference's per-position basecall
buffers (reference: blt_common/snp_pos_info.hh pos_basecall_buffer,
starling_pos_processor_base.cpp pileup_read_segment:1129-1424, and
PileupCleaner.hh). Instead of streaming per-base inserts into mutable
ring buffers, a whole region's basecalls are scattered into padded
[positions, depth] tensors in one vectorized pass; "pileup cleaning"
becomes a mask.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import bam as bamio
from ..utils.qscore import error_prob_to_qphred, qphred_to_error_prob
from . import reads as rd


def mapq_adjusted_qscore(qual: np.ndarray, mapq: np.ndarray) -> np.ndarray:
    """Basecall quality blended with mapping quality.

    reference: blt_util/qscore.hh phred_to_mapped_error_prob
    (e = (1-me)*be + me*0.75) applied when mapq<=80 with mapq floored
    at 5 (starling_pos_processor_base.cpp:1179-1182).
    """
    adj_mapq = np.maximum(mapq, 5)
    be = qphred_to_error_prob(qual)
    me = qphred_to_error_prob(adj_mapq)
    mapped = error_prob_to_qphred((1.0 - me) * be + me * 0.75)
    return np.where(adj_mapq <= 80, mapped, qual).astype(np.int32)


@dataclass
class PileupRegion:
    """Dense pileup over [begin, end) with per-call and per-pos data.

    Depth-axis layout is insertion-ordered per position; `used` marks
    tier1-unfiltered calls (the reference's "cleaned pileup").
    """
    begin: int
    end: int
    depth: np.ndarray        # [L] total inserted (tier1 mapped) calls
    base_id: np.ndarray      # [L, D]
    qual: np.ndarray         # [L, D] mapq-adjusted phred
    raw_qual: np.ndarray     # [L, D] original basecall phred
    is_fwd: np.ndarray       # [L, D]
    read_idx: np.ndarray     # [L, D] row in source batch
    read_off: np.ndarray     # [L, D] offset within read
    valid: np.ndarray        # [L, D] lane holds a call
    used: np.ndarray         # [L, D] passes tier1 filters
    tier2_used: np.ndarray   # [L, D] passes tier2 filters
    # per-position counters
    spandel: np.ndarray      # [L] spanning-deletion reads
    submapped: np.ndarray    # [L] submapped reads overlapping
    mapq_n: np.ndarray       # [L] count of mapq observations
    mapq_sumsq: np.ndarray   # [L] sum of squared mapq (for RMS)
    mapq_zero: np.ndarray    # [L] count of mapq==0
    _used_counts: np.ndarray | None = None  # cached [L, 4]
    # [L, D] call has a windowed mismatch besides its own position
    # (mismatch_count_ns > 0, starling_read_util.cpp:211; feeds the
    # dependent-eprob adjustment). None when MMDF was not computed.
    neighbor_mm: np.ndarray | None = None
    # [L] sum of min-distance-from-read-edge over used calls (filled
    # by the native pileup; None -> compute from tiles)
    edge_dist_sum: np.ndarray | None = None

    @property
    def max_depth(self) -> int:
        return self.base_id.shape[1]

    def used_counts(self):
        """[L, 4] used basecall counts per allele (snp_pos_info tallies)."""
        if self._used_counts is not None:
            return self._used_counts
        L, _ = self.base_id.shape
        counts = np.zeros((L, 4), dtype=np.int32)
        li, di = np.nonzero(self.used)
        np.add.at(counts, (li, self.base_id[li, di]), 1)
        self._used_counts = counts
        return counts


def build_pileup_counts(
    batch: bamio.ReadBatch,
    ea: rd.ExpandedAlignments,
    map_level: np.ndarray,
    region_begin: int,
    region_end: int,
    min_qscore: int,
    mm_filter: np.ndarray | None = None,
    mapq_adjust: bool = True,
):
    """Counts-only pileup (no depth axis) for arbitrarily deep data
    (the continuous-VF caller's input; avoids dense [L, D] tiles at
    several-thousand-fold coverage).

    Returns dict with used_counts [L,4], used_fwd_counts [L,4],
    dpf [L], depth [L].
    """
    L = region_end - region_begin
    in_region = (ea.match_refpos >= region_begin) & (ea.match_refpos < region_end)
    usable = (ea.match_readoff >= ea.read_begin[ea.match_read]) & \
             (ea.match_readoff < ea.read_end[ea.match_read])
    lvl = map_level[ea.match_read]
    mapped12 = (lvl == rd.MapLevel.TIER1) | (lvl == rd.MapLevel.TIER2)
    sel = in_region & usable & mapped12
    r = ea.match_read[sel]
    p = (ea.match_refpos[sel] - region_begin).astype(np.int64)
    gidx = batch.seq_off[r] + ea.match_readoff[sel]
    base = batch.seq[gidx].astype(np.int64)
    rawq = batch.qual[gidx].astype(np.int32)
    fwd = (batch.flag[r] & bamio.FLAG_REVERSE) == 0
    filt = (base == 4) | (rawq < min_qscore)
    if mm_filter is not None:
        filt |= mm_filter[gidx]
    used = ~filt & (map_level[r] == rd.MapLevel.TIER1)

    counts = np.zeros((L, 4), np.int64)
    fwd_counts = np.zeros((L, 4), np.int64)
    np.add.at(counts, (p[used], base[used]), 1)
    uf = used & fwd
    np.add.at(fwd_counts, (p[uf], base[uf]), 1)
    depth = np.zeros(L, np.int64)
    np.add.at(depth, p, 1)
    dpf = depth - counts.sum(axis=1)
    return {"used_counts": counts, "used_fwd_counts": fwd_counts,
            "dpf": dpf, "depth": depth}


def build_pileup(
    batch: bamio.ReadBatch,
    ea: rd.ExpandedAlignments,
    map_level: np.ndarray,
    ref_codes: np.ndarray,
    region_begin: int,
    region_end: int,
    min_qscore: int,
    mm_filter: np.ndarray | None = None,
    tier2_mm_filter: np.ndarray | None = None,
    mapq_adjust: bool = True,
    depth_pad: int = 8,
    neighbor_mm: np.ndarray | None = None,
) -> PileupRegion:
    """One vectorized pass: scatter all aligned basecalls into a dense
    [L, D] tile plus per-position counters."""
    L = region_end - region_begin

    in_region = (ea.match_refpos >= region_begin) & (ea.match_refpos < region_end)
    usable = (ea.match_readoff >= ea.read_begin[ea.match_read]) & \
             (ea.match_readoff < ea.read_end[ea.match_read])
    lvl = map_level[ea.match_read]
    mapped12 = (lvl == rd.MapLevel.TIER1) | (lvl == rd.MapLevel.TIER2)

    sel = in_region & usable & mapped12
    r = ea.match_read[sel]
    p = (ea.match_refpos[sel] - region_begin).astype(np.int64)
    o = ea.match_readoff[sel]
    gidx = batch.seq_off[r] + o
    base = batch.seq[gidx].astype(np.int32)
    rawq = batch.qual[gidx].astype(np.int32)
    mapq = batch.mapq[r].astype(np.int32)
    fwd = (batch.flag[r] & bamio.FLAG_REVERSE) == 0

    q = mapq_adjusted_qscore(rawq, mapq) if mapq_adjust else rawq

    # filters (pileup_read_segment:1317-1345)
    is_any = base == 4
    call_filter = is_any | (rawq < min_qscore)
    if mm_filter is not None:
        mmf = mm_filter[gidx]
        call_filter = call_filter | mmf
    # tier2 filter: with no tier2 MMDF configured it mirrors the full
    # tier1 filter incl. MMDF (pileup_read_segment:1325-1335)
    if tier2_mm_filter is not None:
        t2_filter = is_any | (rawq < min_qscore) | tier2_mm_filter[gidx]
    else:
        t2_filter = call_filter

    # depth slot per (position, insertion order): stable sort by pos
    order = np.argsort(p, kind="stable")
    p_s = p[order]
    slot = np.arange(len(p_s)) - np.searchsorted(p_s, p_s, side="left")
    depth = np.zeros(L, dtype=np.int32)
    if len(p_s):
        np.add.at(depth, p_s, 1)
    D = max(int(depth.max()) if L else 0, 1)
    D = ((D + depth_pad - 1) // depth_pad) * depth_pad

    def tile(dtype):
        return np.zeros((L, D), dtype=dtype)  # calloc: cheaper than full

    base_t = tile(np.int32)
    nbmm_t = tile(bool) if neighbor_mm is not None else None
    qual_t = tile(np.int32)
    rawq_t = tile(np.int32)
    fwd_t = tile(bool)
    ridx_t = tile(np.int64)
    roff_t = tile(np.int64)
    valid_t = tile(bool)
    used_t = tile(bool)
    t2used_t = tile(bool)
    ridx_t -= 1  # invalid-lane sentinel

    used_counts = np.zeros((L, 4), dtype=np.int32)
    if len(p_s):
        rows, cols = p_s, slot
        src = order
        base_t[rows, cols] = base[src]
        if nbmm_t is not None:
            nbmm_t[rows, cols] = neighbor_mm[gidx][src]
        qual_t[rows, cols] = q[src]
        rawq_t[rows, cols] = rawq[src]
        fwd_t[rows, cols] = fwd[src]
        ridx_t[rows, cols] = r[src]
        roff_t[rows, cols] = o[src]
        valid_t[rows, cols] = True
        is_t1 = map_level[r[src]] == rd.MapLevel.TIER1
        used_flags = is_t1 & ~call_filter[src]
        used_t[rows, cols] = used_flags
        t2used_t[rows, cols] = ~t2_filter[src]
        # tally used counts at scatter time (avoids a [L, D] nonzero)
        np.add.at(used_counts, (rows[used_flags], base[src][used_flags]), 1)

    # spanning deletions: non-edge deleted ref bases from tier1/2 reads
    spandel = np.zeros(L, dtype=np.int32)
    dsel = (ea.del_refpos >= region_begin) & (ea.del_refpos < region_end) & \
           (~ea.del_is_edge) & np.isin(map_level[ea.del_read],
                                       (rd.MapLevel.TIER1, rd.MapLevel.TIER2))
    np.add.at(spandel, ea.del_refpos[dsel] - region_begin, 1)

    # submapped reads' aligned bases
    submapped = np.zeros(L, dtype=np.int32)
    ssel = in_region & usable & (map_level[ea.match_read] == rd.MapLevel.SUB_MAPPED)
    np.add.at(submapped, ea.match_refpos[ssel] - region_begin, 1)

    # mapq stats over all (incl. submapped) aligned bases
    mapq_n = np.zeros(L, dtype=np.int32)
    mapq_sumsq = np.zeros(L, dtype=np.float64)
    mapq_zero = np.zeros(L, dtype=np.int32)
    asel = in_region & usable & (map_level[ea.match_read] != rd.MapLevel.UNMAPPED)
    ap = ea.match_refpos[asel] - region_begin
    amq = batch.mapq[ea.match_read[asel]].astype(np.float64)
    np.add.at(mapq_n, ap, 1)
    np.add.at(mapq_sumsq, ap, amq * amq)
    np.add.at(mapq_zero, ap, (amq == 0).astype(np.int32))

    return PileupRegion(
        begin=region_begin, end=region_end, depth=depth,
        base_id=base_t, qual=qual_t, raw_qual=rawq_t, is_fwd=fwd_t,
        read_idx=ridx_t, read_off=roff_t, valid=valid_t, used=used_t,
        tier2_used=t2used_t, neighbor_mm=nbmm_t,
        spandel=spandel, submapped=submapped,
        mapq_n=mapq_n, mapq_sumsq=mapq_sumsq, mapq_zero=mapq_zero,
        _used_counts=used_counts,
    )


def submapped_match_obs(batch, ea, map_level, region_begin, region_end):
    """(pos_idx, base_id, mapq) of every aligned match base from
    SUBMAPPED reads over [region_begin, region_end), sorted by
    position, with per-position offsets.

    Feeds the MQ rank-sum EVS metric, which — unlike the basecall
    pileup — includes submapped reads
    (pos_basecall_buffer.cpp updateGermlineScoringMetrics:44-70 runs
    before the is_submapped pileup skip,
    starling_pos_processor_base.cpp:1349-1368)."""
    L = region_end - region_begin
    offsets = np.zeros(L + 1, dtype=np.int64)
    empty = (offsets, np.zeros(0, np.int8), np.zeros(0, np.uint8))
    if not batch.n:
        return empty
    lvl = map_level[ea.match_read]
    sel = ((lvl == rd.MapLevel.SUB_MAPPED)
           & (ea.match_refpos >= region_begin)
           & (ea.match_refpos < region_end)
           & (ea.match_readoff >= ea.read_begin[ea.match_read])
           & (ea.match_readoff < ea.read_end[ea.match_read]))
    if not sel.any():
        return empty
    r = ea.match_read[sel]
    p = ea.match_refpos[sel] - region_begin
    order = np.argsort(p, kind="stable")
    p = p[order]
    r = r[order]
    off = ea.match_readoff[sel][order]
    base = batch.seq[batch.seq_off[r] + off].astype(np.int8)
    mapq = batch.mapq[r]
    np.add.at(offsets, p + 1, 1)
    np.cumsum(offsets, out=offsets)
    return offsets, base, mapq


class SiteScoringMetrics:
    """Per-site germline EVS rank-sum metrics, computed lazily at
    requested (variant) sites from the pileup tile.

    Port of the three fastRanksum accumulators
    (pos_basecall_buffer.cpp updateGermlineScoringMetrics:44-70 +
    snp_pos_info.cpp get_{read_pos,mq,baseq}_ranksum):

      MQRankSum      — (is_reference, mapq) over every aligned match
                       base INCLUDING submapped reads
      BaseQRankSum   — (is_reference, engine qscore) non-submapped
      ReadPosRankSum — (is_reference, align-strand read position)
                       non-submapped

    is_reference compares the basecall to the reference base; no
    basecall quality/MMDF filters apply (observations are recorded
    before any call filtering). Category values are bucketed integers,
    z computed by the exact fastRanksum transcription
    (utils/stats.mann_whitney_u_from_groups).
    """

    def __init__(self, pu: PileupRegion, batch, ref_codes_region,
                 ea=None, map_level=None):
        self._pu = pu
        self._batch = batch
        self._ref = ref_codes_region
        self._ea = ea
        self._level = map_level
        self._sub = None           # built lazily on first site query
        self._rlens = (np.diff(batch.seq_off).astype(np.int64)
                       if batch.n else np.zeros(0, np.int64))
        self._cache: dict[int, tuple[float, float, float]] = {}

    def at(self, i: int) -> tuple[float, float, float]:
        """(MQRankSum, ReadPosRankSum, BaseQRankSum) at region offset i."""
        hit = self._cache.get(i)
        if hit is not None:
            return hit
        if self._sub is None:
            self._sub = (submapped_match_obs(
                self._batch, self._ea, self._level,
                self._pu.begin, self._pu.end)
                if self._ea is not None else
                (np.zeros(self._pu.end - self._pu.begin + 1, np.int64),
                 np.zeros(0, np.int8), np.zeros(0, np.uint8)))
        from ..utils.stats import mann_whitney_u_from_groups as mw
        pu = self._pu
        lanes = pu.valid[i]
        bid = pu.base_id[i][lanes]
        ridx = pu.read_idx[i][lanes]
        roff = pu.read_off[i][lanes]
        q = pu.qual[i][lanes]
        fwd = pu.is_fwd[i][lanes]
        ref_id = int(self._ref[i])
        is_ref = bid == ref_id
        mapq = (self._batch.mapq[ridx] if self._batch.n
                else np.zeros(0, np.uint8))
        # MQ: tier calls + submapped observations at this position
        mq_ref = [mapq[is_ref]]
        mq_alt = [mapq[~is_ref]]
        if self._sub is not None:
            off, sbase, smapq = self._sub
            lo, hi = int(off[i]), int(off[i + 1])
            if hi > lo:
                sref = sbase[lo:hi] == ref_id
                mq_ref.append(smapq[lo:hi][sref])
                mq_alt.append(smapq[lo:hi][~sref])
        mq_rs = mw(np.concatenate(mq_ref), np.concatenate(mq_alt))
        # align-strand read position (cycle): read_pos on the forward
        # strand, read_size - (read_pos + 1) on the reverse
        # (starling_pos_processor_base.cpp:1310-1315)
        rl = self._rlens[ridx] if self._batch.n else np.zeros_like(roff)
        cyc = np.where(fwd, roff, rl - 1 - roff)
        pos_rs = mw(cyc[is_ref], cyc[~is_ref])
        bq_rs = mw(q[is_ref], q[~is_ref])
        out = (float(mq_rs), float(pos_rs), float(bq_rs))
        self._cache[i] = out
        return out
