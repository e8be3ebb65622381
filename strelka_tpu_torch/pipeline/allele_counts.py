"""Sequence allele counting for indel error estimation.

Reference: applications/GetSequenceAlleleCounts/
SequenceAlleleCountsPosProcessor.cpp + errorAnalysis/IndelCounts.hh —
streams the BAM like the caller but emits per-STR-context locus
observation counts (ref-supporting depth + indel observations by
signal type) instead of calls.

Batched redesign: STR context tracks and per-position ref/alt counts
are computed in vectorized passes over the expanded alignment tables.

Port of strelka_tpu/pipeline/allele_counts.py: host code on the port's
io.native, pipeline.reads and pipeline.candidates; the basecall
patterns come back as f64 tensors on the device they are asked for.
"""
from __future__ import annotations

import numpy as np

from ..io.bam import ReadBatch
from ..models.error_fit import ContextCounts, dedupe_counts, signal_index
from . import reads as rd


def str_context_tracks(ref_codes: np.ndarray, max_counts={1: 16, 2: 9}):
    """For pattern sizes 1 and 2: repeat count of the unit starting at
    each position (clamped), vectorized."""
    L = len(ref_codes)
    out = {}
    for ps, maxc in max_counts.items():
        count = np.ones(L, dtype=np.int32)
        # match[i] = unit at i equals unit at i+ps
        eq = np.zeros(L, dtype=bool)
        if L > 2 * ps:
            unit_eq = np.ones(L - ps, dtype=bool)
            for k in range(ps):
                idx = np.arange(L - ps - k)
                unit_eq[:len(idx)] &= (ref_codes[idx + k] == ref_codes[idx + ps + k]) & \
                                      (ref_codes[idx + k] != 4)
            eq[:L - ps] = unit_eq
        # count of consecutive repeats starting at i: 1 + run of eq
        run = np.zeros(L, dtype=np.int32)
        for i in range(L - ps - 1, -1, -1):
            if eq[i]:
                run[i] = run[i + ps] + 1 if i + ps < L else 1
        count = np.minimum(1 + run, maxc)
        out[ps] = count
    return out


def collect_context_counts(
    batch: ReadBatch,
    ea: rd.ExpandedAlignments,
    map_level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    begin: int,
    end: int,
    max_indel_size: int = 49,
) -> dict[tuple[int, int], ContextCounts]:
    """Per-context deduplicated locus observation patterns."""
    from .candidates import estimated_depth, left_shift_indel

    L = end - begin
    # counting-app pileup options: min_qscore 17 with a strict
    # mismatch density filter (max 1 mismatch in a +/-100bp window,
    # SequenceAlleleCountsOptions.hh:46-47); used-basecall depth
    # replaces the raw spanning-read estimate when available
    depth = None
    if batch.n:
        from ..io.native import pileup_native
        res = pileup_native(batch, map_level, ref_codes,
                            ref_offset, begin, end,
                            min_qscore=17, mm_flank=100, mm_max=1)
        if res is not None:
            depth = res[0].used.sum(axis=1).astype(np.int64)
    if depth is None:
        depth = estimated_depth(batch, ea, map_level, begin, end)
    tracks = str_context_tracks(ref_codes[begin - ref_offset:end - ref_offset])

    # indel observations per position x signal type
    alt = np.zeros((L, 6), dtype=np.int64)
    t1 = map_level == rd.MapLevel.TIER1
    isel = np.nonzero(t1[ea.ins_read] & ~ea.ins_is_edge &
                      (ea.ins_len <= max_indel_size))[0]
    for i in isel:
        r = int(ea.ins_read[i])
        seq = batch.seq[batch.seq_off[r] + ea.ins_readoff[i]:
                        batch.seq_off[r] + ea.ins_readoff[i] + int(ea.ins_len[i])]
        pos, _, ins = left_shift_indel(int(ea.ins_refpos[i]), 0, seq,
                                       ref_codes, ref_offset)
        p = pos - begin
        if 0 <= p < L:
            alt[p, signal_index(True, len(ins))] += 1
    dsel = np.nonzero(t1[ea.devent_read] & ~ea.devent_is_edge &
                      (ea.devent_len <= max_indel_size))[0]
    for i in dsel:
        pos, dlen, _ = left_shift_indel(int(ea.devent_refpos[i]),
                                        int(ea.devent_len[i]),
                                        np.empty(0, np.uint8),
                                        ref_codes, ref_offset)
        p = pos - begin
        if 0 <= p < L:
            alt[p, signal_index(False, dlen)] += 1

    alt_total = alt.sum(axis=1)
    ref_obs = np.maximum(depth.astype(np.int64) - alt_total, 0)
    covered = depth > 0

    out: dict[tuple[int, int], ContextCounts] = {}
    for ps, track in tracks.items():
        for rc_val in np.unique(track):
            sel = covered & (track == rc_val)
            if not sel.any():
                continue
            out[(ps, int(rc_val))] = dedupe_counts(ref_obs[sel], alt[sel])
    return out


def collect_basecall_counts(
    batch: ReadBatch,
    map_level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    begin: int,
    end: int,
    device=None,
):
    """Deduplicated per-position basecall observation patterns for the
    SNV error models (errorAnalysis BasecallCounts analog): per
    position, the used ref-supporting basecall count plus alt basecall
    counts binned by phred level. Returns an
    error_zoo.SnvPatterns (f64 tensors on `device`, default the current
    device) or None on empty input."""
    import torch

    from .. import device as devmod
    from ..models.error_zoo import SnvPatterns

    if not batch.n:
        return None
    from ..io.native import pileup_native
    res = pileup_native(batch, map_level, ref_codes, ref_offset,
                        begin, end, min_qscore=17, mm_flank=100, mm_max=1)
    if res is None:
        return None
    pu = res[0]
    L = end - begin
    rc = ref_codes[begin - ref_offset:end - ref_offset]
    used = pu.used & pu.valid & (rc[:, None] != 4)
    is_ref = used & (pu.base_id == rc[:, None])
    is_alt = used & ~is_ref

    quals = np.unique(pu.qual[is_alt]) if is_alt.any() else np.array([30])
    Q = len(quals)
    qidx = np.searchsorted(quals, pu.qual)

    ref_count = is_ref.sum(axis=1).astype(np.int64)
    alt_count = np.zeros((L, Q), dtype=np.int64)
    li, di = np.nonzero(is_alt)
    np.add.at(alt_count, (li, qidx[li, di]), 1)

    ref_qual_hist = np.zeros(Q, dtype=np.int64)
    li_r, di_r = np.nonzero(is_ref)
    np.add.at(ref_qual_hist, np.clip(qidx[li_r, di_r], 0, Q - 1), 1)

    covered = used.any(axis=1)
    rows = np.concatenate([ref_count[covered, None],
                           alt_count[covered]], axis=1)
    uniq, counts = np.unique(rows, axis=0, return_counts=True)
    dev = devmod.current() if device is None else devmod.resolve(device)

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64),
                               device=dev)
    return SnvPatterns(
        qual_levels=quals.astype(np.int64),
        ref_qual_hist=f64(ref_qual_hist),
        ref_count=f64(uniq[:, 0]),
        alt_count=f64(uniq[:, 1:]),
        inst=f64(counts))


def save_context_counts(path: str, counts: dict) -> None:
    """Serialize a context-counts dict to an .npz (the reference's
    binary counts file, SequenceAlleleCounts boost serialization)."""
    arrays = {}
    for (ps, rc), cc in counts.items():
        key = f"{ps}_{rc}"
        arrays[f"ref_{key}"] = cc.ref_obs
        arrays[f"alt_{key}"] = cc.alt_obs
        arrays[f"n_{key}"] = cc.instance_count
    np.savez_compressed(path, **arrays)


def load_context_counts(path: str) -> dict:
    """Inverse of save_context_counts."""
    from ..models.error_fit import ContextCounts
    data = np.load(path)
    out = {}
    for name in data.files:
        if not name.startswith("ref_"):
            continue
        key = name[4:]
        ps, rc = (int(x) for x in key.split("_"))
        out[(ps, rc)] = ContextCounts(
            ref_obs=data[f"ref_{key}"], alt_obs=data[f"alt_{key}"],
            instance_count=data[f"n_{key}"])
    return out


def merge_context_counts(all_counts: list[dict]) -> dict:
    """Merge per-segment count dicts (MergeSequenceAlleleCounts)."""
    merged: dict[tuple[int, int], list] = {}
    for counts in all_counts:
        for key, cc in counts.items():
            merged.setdefault(key, []).append(cc)
    out = {}
    for key, parts in merged.items():
        ref = np.concatenate([p.ref_obs for p in parts])
        altx = np.concatenate([p.alt_obs for p in parts])
        inst = np.concatenate([p.instance_count for p in parts])
        rows = np.concatenate([ref[:, None], altx], axis=1)
        uniq, inv = np.unique(rows, axis=0, return_inverse=True)
        counts_sum = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(counts_sum, inv, inst)
        out[key] = ContextCounts(ref_obs=uniq[:, 0], alt_obs=uniq[:, 1:],
                                 instance_count=counts_sum)
    return out
