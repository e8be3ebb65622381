"""Tumor/normal somatic calling over a region.

Reference: applications/strelka/strelka_pos_processor.cpp
(process_pos_snp_somatic :166-264, process_pos_indel_somatic :297-408),
strelka_run.cpp, SomaticCallableProcessor.hh.

Design: both samples' pileups are built once per region; tier1 and
tier2 frequency-grid likelihood tensors are computed batched over all
positions; the joint somatic posterior runs batched over positions;
indel loci reuse the germline realignment scoring to produce per-read
(ref, indel) log-probs for the somatic indel grid.

Port of strelka_tpu/pipeline/somatic_caller.py. The host code is a
copy; the SNV grid lhoods and the joint posterior run as torch ops on
the current device (strelka_tpu_torch.device), and the indel loci are
scored by the CUDA kernel through realign_batch on a card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import device as devmod
from ..io import bam as bamio
from ..io.fasta import FastaReference, decode_bases
from ..models import error_model, somatic_indel as si, somatic_snv as ss
from ..options import SomaticOptions
from ..utils import spans
from . import candidates as cand
from . import pileup as pl
from . import reads as rd
from . import realign

NTYPE_LABELS = ["ref", "hom", "het", "conflict"]


@dataclass
class SomaticSnvSite:
    pos: int
    ref_gt: int
    alt_id: int
    qss: int
    qss_nt: int
    ntype: int
    tier_qss: int
    tier_qss_nt: int
    sgt_normal: int   # SOMATIC_DIGT of normal in max state
    sgt_tumor_is_som: bool
    snv_sb: float
    # per-sample [normal, tumor] counters
    dp: list = field(default_factory=list)
    fdp: list = field(default_factory=list)
    sdp: list = field(default_factory=list)
    subdp: list = field(default_factory=list)
    acgt_tier1: list = field(default_factory=list)  # [4] each
    acgt_tier2: list = field(default_factory=list)
    read_pos_ranksum: float = 0.0
    mq: float = 0.0
    mq0: int = 0
    mapq_n: int = 0


@dataclass
class SomaticIndelCall:
    key: cand.IndelKey
    rec: cand.IndelRecord
    qsi: int
    qsi_nt: int
    ntype: int
    tier: int
    sgt_tumor_is_som: bool
    # per-sample counters [normal, tumor]
    dp: list = field(default_factory=list)
    tar: list = field(default_factory=list)   # tier1,2 ref-supporting
    tir: list = field(default_factory=list)   # tier1,2 indel-supporting
    tor: list = field(default_factory=list)   # other
    mq: float = 0.0
    mq0: int = 0
    read_pos_ranksum: float = 0.0
    strand_odds: float = 0.0
    # per-sample 50bp-window stats (DP50, FDP50, SUBDP50, BCN50):
    # means over the +/-indelRegionFlankSize window around the record
    # position (LocalRegionStats + SomaticIndelVcfWriter
    # write_vcf_isri_tiers :61-72)
    win: list = field(default_factory=list)


@dataclass
class SomaticRegionResult:
    chrom: str
    begin: int
    end: int
    ref_codes: np.ndarray
    snvs: list[SomaticSnvSite]
    indels: list[SomaticIndelCall]
    # somatic-callable track (SomaticCallableProcessor: QSS>=15 or
    # nonsomatic Q>=15), merged [begin,end) intervals
    callable_intervals: list[tuple[int, int]] = field(default_factory=list)
    # [(keep_indices, realigned_batch)] per sample when requested
    # (reference --realigned-read-file for normal+tumor)
    realigned: list | None = None


_TILE_D_PAD = 32


def _tile_rows(pus, dev) -> int:
    """Rows per chunk: as many as fit the memory budget of `dev` with
    both samples' grid lhoods and the joint posterior of a row
    (somatic_snv.rows_per_launch), so the posterior runs once per
    chunk. Rows are independent: the chunk height never changes a
    result."""
    depth = max(pu.base_id.shape[1] for pu in pus)
    return ss.rows_per_launch(dev, ss.tile_row_bytes(dev, depth))


def _grid_lhoods(pu: pl.PileupRegion, rows, rg, dev, tier2=False):
    """[n, GRID_SIZE] f32 frequency-grid lhoods on `dev` for the pileup
    rows `rows` (a slice or an index array) with ref_gt `rg` (on
    `dev`), from the tier1 use mask (tier2: the tier2 mask).

    Raw base/qual lanes pass through unmasked: freq_grid_lhoods gates
    every contribution on the mask (is_ref/is_alt are AND'd with it)."""
    use = pu.tier2_used if tier2 else pu.used

    def put(a):
        return devmod.put("ksg", a, dev)
    used = put(use[rows]) & put(pu.valid[rows])
    return ss.freq_grid_lhoods(put(pu.base_id[rows]), put(pu.qual[rows]),
                               used, put(pu.is_fwd[rows]), rg)


def _snv_tier1_fused(pus, ref_gt, run_fn, dev):
    """Tier1 somatic SNV call over position chunks with the whole chain
    device-resident: per chunk, both samples' frequency-grid lhoods AND
    the joint posterior run on `dev`, the result fields stay there, and
    only those come back to the host, at the end (the [L, GRID] lhood
    tensors never leave the device). With an engine mesh (--mesh) each
    chunk's rows are split over the mesh's devices (chunk_sharder), each
    shard on its own. Returns a SomaticSnvResult of host numpy arrays."""
    from ..parallel import mesh as pmesh
    L = pus[0].base_id.shape[0]
    tl = _tile_rows(pus, dev)
    shards = pmesh.chunk_sharder(dev)
    parts = []
    for c0 in range(0, max(L, 1), tl):  # one empty chunk when L == 0
        for sdev, t0, t1 in shards(c0, min(c0 + tl, L)):
            rows = slice(t0, t1)
            rg = devmod.put("ksg", ref_gt[rows].astype(np.int32), sdev)
            parts.append(run_fn(*(_grid_lhoods(pu, rows, rg, sdev)
                                  for pu in pus)))
    return _host_result(parts)


def _host_result(parts):
    """One SomaticSnvResult of host numpy arrays from the per-chunk (or
    per-shard) results `parts`, in order."""
    return ss.SomaticSnvResult(*(
        np.concatenate([devmod.pull("ksp", getattr(r, f)) for r in parts])
        for f in ss.SomaticSnvResult._fields))


def _snv_tier2_rows(pus, ref_gt, rows, run_fn, dev):
    """The tier2 call on the gathered pileup rows `rows` (host index
    array), in chunks, each split over the engine mesh's devices where
    one is set; a SomaticSnvResult of host numpy arrays."""
    from ..parallel import mesh as pmesh
    tl = _tile_rows(pus, dev)
    shards = pmesh.chunk_sharder(dev)
    parts = []
    for c0 in range(0, len(rows), tl):
        for sdev, t0, t1 in shards(c0, min(c0 + tl, len(rows))):
            sub = rows[t0:t1]
            rg = devmod.put("ksg", ref_gt[sub].astype(np.int32), sdev)
            parts.append(run_fn(*(_grid_lhoods(pu, sub, rg, sdev, tier2=True)
                                  for pu in pus)))
    return _host_result(parts)


def _classify_indel_reads(ref_lnp, ind_lnp, n_nonambig, ln_rbm):
    """(n_confident_ref, n_confident_indel, p_ref array): per-read
    posteriors over {incorrectly-mapped, ref, indel} with uniform
    allele prior (indel_lnp_to_pprob)."""
    from ..models.indel_genotype import CORRECT_MAPPING_LOG_PRIOR
    ln_half = float(np.log(0.5))
    a_ref = ref_lnp + CORRECT_MAPPING_LOG_PRIOR + ln_half
    a_ind = ind_lnp + CORRECT_MAPPING_LOG_PRIOR + ln_half
    a_im = np.asarray(n_nonambig, np.float64) * ln_rbm
    mx = np.maximum(np.maximum(a_ref, a_ind), a_im)
    e_ref = np.exp(a_ref - mx)
    e_ind = np.exp(a_ind - mx)
    tot = e_ref + e_ind + np.exp(a_im - mx)
    p_ref = e_ref / tot
    p_ind = e_ind / tot
    thresh = 0.51  # readConfidentSupportThreshold
    return (int((p_ref >= thresh).sum()), int((p_ind >= thresh).sum()),
            p_ref, p_ind)


@spans.span("region")
def call_somatic_region(
    opt: SomaticOptions,
    ref: FastaReference,
    chrom: str,
    begin: int,
    end: int,
    normal_batch: bamio.ReadBatch,
    tumor_batch: bamio.ReadBatch,
    external_indel_vcfs: list[str] | None = None,
    collect_realigned: bool = False,
) -> SomaticRegionResult:
    """Tumor/normal calling over one region, in the stages of its
    spans: region.prep, region.candidates, region.realign, region.pileup
    and region.genotype."""
    spans.stage("region.prep")
    halo = opt.max_indel_size + 250
    fetch_begin = max(0, begin - halo)
    fetch_end = min(ref.contig_length(chrom), end + halo)
    ref_all = ref.fetch(chrom, fetch_begin, fetch_end)
    rc = ref_all[begin - fetch_begin:end - fetch_begin]
    L = end - begin
    # the somatic app runs with the compiled-in default error model
    # "logLinear" (starling_base_shared.hh:233) — the workflow passes
    # no indel-error-models-file for tumor/normal calling
    em = error_model.IndelErrorModel(2, model_name="logLinear")

    pus, t2_pus, eas, levels, kept = [], [], [], [], []
    keep_indices = []
    store = cand.IndelObservationStore(2)
    for s, raw in enumerate([normal_batch, tumor_batch]):
        keep, level = rd.filter_and_classify_reads(
            raw, opt.min_mapping_quality,
            tier2_min_mapq=opt.tier2_min_single_align_score)
        keep_indices.append(np.nonzero(keep)[0])
        batch = raw.select(keep)
        level = level[keep]
        ea = rd.expand_alignments(batch)
        kept.append(batch)
        eas.append(ea)
        levels.append(level)
        cand.extract_read_indels(batch, ea, level, ref_all, fetch_begin,
                                 store, s, opt.max_indel_size)
    spans.count("reads.kept", sum(b.n for b in kept))

    spans.stage("region.candidates")
    if external_indel_vcfs:
        from ..io.vcf import read_vcf
        for path in external_indel_vcfs:
            for v in read_vcf(path, region=(chrom, fetch_begin, fetch_end)):
                for alt in v.alts:
                    if len(v.ref) >= 1 and len(alt) >= 1 and alt[0] == v.ref[0]:
                        dlen = len(v.ref) - 1
                        ins = alt[1:]
                        if dlen > 0 and ins:
                            continue
                        if max(dlen, len(ins)) <= opt.max_indel_size:
                            store.add_external(cand.IndelKey(v.pos + 1, dlen, ins))

    ref_gt = rc.astype(np.int32)

    # the somatic app disables active-region haplotyping
    # (strelka_shared.hh isHaplotypingEnabled=false), so the candidate
    # SNV buffer stays empty and no MMDF exemptions apply
    exempt_keys = None

    # --- candidate indel loci (needed before realignment) ---
    ests = [cand.estimated_depth(kept[s], eas[s], levels[s], fetch_begin,
                                 fetch_end) for s in range(2)]
    est_sum = np.maximum(ests[0], ests[1])
    candidacy = cand.evaluate_candidacy(
        store, est_sum, fetch_begin, em, ref_all, fetch_begin,
        alpha=opt.indel_candidate_signal_test_alpha)
    cand_keys = sorted(k for k, ok in candidacy.items()
                       if ok and begin <= k.pos - 1 < end)
    spans.count("indel.candidates", len(cand_keys))

    # apply realignments before pileup (reference stage order)
    spans.stage("region.realign")
    from . import realign_batch as rb
    from . import realign_apply as ra
    loci_single = [[k] for k in cand_keys]
    for s in range(2):
        if not loci_single:
            break
        sscores = rb.score_loci_batched(kept[s], eas[s], levels[s], ref_all,
                                        fetch_begin, loci_single,
                                        selection="overlap",
                                        tiers=(rd.MapLevel.TIER1,
                                               rd.MapLevel.TIER2))
        new_batch, n_re = ra.apply_realignments(kept[s], sscores, loci_single)
        if n_re:
            kept[s] = new_batch
            eas[s] = rd.expand_alignments(new_batch)

    # open breakpoint (BP_LEFT/BP_RIGHT) candidates: junction clipping
    # before the pileup (same machinery as the germline caller)
    bp_cands = cand.evaluate_breakpoint_candidacy(
        store, est_sum, fetch_begin, em,
        alpha=opt.indel_candidate_signal_test_alpha)
    if bp_cands:
        for s in range(2):
            bp_loci = [(bpos, side, realign.score_breakpoint_locus(
                kept[s], eas[s], levels[s], ref_all, fetch_begin,
                bpos, side, seq)) for bpos, side, seq in bp_cands]
            new_batch, n_bp = ra.apply_breakpoint_clips(kept[s], bp_loci)
            if n_bp:
                kept[s] = new_batch
                eas[s] = rd.expand_alignments(new_batch)

    # --- pileups (post-realignment) ---
    spans.stage("region.pileup")
    from ..io.native import pileup_native
    for s in range(2):
        # depth padded to a multiple of _TILE_D_PAD lanes, as the JAX
        # package pads it
        res = pileup_native(
            kept[s], levels[s], ref_all, fetch_begin, begin, end,
            min_qscore=opt.min_qscore,
            mm_flank=opt.max_win_mismatch_flank_size,
            mm_max=opt.max_win_mismatch,
            t2_mm_max=opt.tier2_mismatch_density_filter_count,
            exempt_keys=exempt_keys,
            depth_pad=_TILE_D_PAD)
        if res is not None:
            pus.append(res[0])
            continue
        def _snv_exempt(ref_pos, base):
            if exempt_keys is None:
                return np.zeros(len(ref_pos), dtype=bool)
            return np.isin(np.asarray(ref_pos, np.int64) * 4
                           + np.asarray(base, np.int64), exempt_keys)
        mmf, t2mmf = rd.mismatch_density_filter(
            kept[s], eas[s], ref_all, fetch_begin,
            opt.max_win_mismatch_flank_size, opt.max_win_mismatch,
            tier2_max_mismatch=opt.tier2_mismatch_density_filter_count,
            candidate_snv_mask=_snv_exempt)
        pus.append(pl.build_pileup(
            kept[s], eas[s], levels[s], rc, begin, end,
            min_qscore=opt.min_qscore, mm_filter=mmf,
            tier2_mm_filter=t2mmf, depth_pad=_TILE_D_PAD))

    # --- SNVs: tier1 grid lhoods + joint call, device-resident ---
    spans.stage("region.genotype")
    spans.count("snv.sites", L)
    spans.count("indel.loci", len(cand_keys))
    dev = devmod.current()
    shared_rate = opt.shared_site_error_rate
    def run_tier(nlh, tlh):
        return ss.somatic_snv_call_capped(
            nlh, tlh,
            contam_tolerance=opt.ssnv_contam_tolerance,
            shared_error_rate=shared_rate,
            somatic_rate=opt.somatic_snv_rate,
            theta=opt.bsnp_diploid_theta,
            sse_strand_fraction=opt.shared_site_error_strand_bias_fraction)

    r1 = _snv_tier1_fused(pus, ref_gt, run_tier, dev)

    q1 = np.asarray(r1.qphred)
    qn1 = np.asarray(r1.from_ntype_qphred)
    nt1 = np.asarray(r1.ntype)

    # tier2 evidence only where tier1 is nonzero (the reference copies
    # tier1 results when tier1 qphred == 0,
    # position_somatic_snv_strand_grid.cpp:269-276); the subset is tiny
    # so the relaxed-evidence grid pass runs on gathered rows
    q2 = q1.copy()
    qn2 = qn1.copy()
    nt2 = nt1.copy()
    t2_rows = np.nonzero(q1 != 0)[0]
    if len(t2_rows):
        rsub = _snv_tier2_rows(pus, ref_gt, t2_rows, run_tier, dev)
        q2[t2_rows] = rsub.qphred
        qn2[t2_rows] = rsub.from_ntype_qphred
        nt2[t2_rows] = rsub.ntype

    # tier merge (position_somatic_snv_strand_grid.cpp:309-365): take
    # min over tiers for each score; record which tier was used
    tier_qss = (q1 > q2).astype(np.int32)
    qss = np.minimum(q1, q2)
    tier_qss_nt = (qn1 > qn2).astype(np.int32)
    qss_nt = np.minimum(qn1, qn2)
    ntype = np.where(nt1 == nt2, nt1, 3)  # 3 = conflict
    qss_nt = np.where(nt1 == nt2, qss_nt, 0)

    # somatic-callable intervals from tier1 scores
    nsq = np.asarray(r1.nonsomatic_qphred)
    callable_mask = ((q1 >= 15) | (nsq >= 15)) & (ref_gt < 4)
    callable_intervals = []
    if callable_mask.any():
        idx = np.nonzero(callable_mask)[0]
        starts = idx[np.concatenate([[True], np.diff(idx) > 1])]
        ends = idx[np.concatenate([np.diff(idx) > 1, [True]])]
        callable_intervals = [(begin + int(s), begin + int(e) + 1)
                              for s, e in zip(starts, ends)]

    snvs: list[SomaticSnvSite] = []
    called = np.nonzero((qss > 0) & (ref_gt < 4))[0]
    max_gt1 = np.asarray(r1.max_gt)
    sb1 = np.asarray(r1.strand_bias)
    for i in called:
        pos = begin + int(i)
        # most frequent alt in tumor tier1
        counts_t = pus[1].used_counts()[i].copy()
        counts_t[ref_gt[i]] = 0
        alt_id = int(np.argmax(counts_t))
        if counts_t[alt_id] == 0:
            counts_n = pus[0].used_counts()[i].copy()
            counts_n[ref_gt[i]] = 0
            alt_id = int(np.argmax(counts_n))
            if counts_n[alt_id] == 0:
                continue
        site = SomaticSnvSite(
            pos=pos, ref_gt=int(ref_gt[i]), alt_id=alt_id,
            qss=int(qss[i]), qss_nt=int(qss_nt[i]), ntype=int(ntype[i]),
            tier_qss=int(tier_qss[i]), tier_qss_nt=int(tier_qss_nt[i]),
            sgt_normal=int(max_gt1[i]) // 2, sgt_tumor_is_som=bool(max_gt1[i] % 2),
            snv_sb=float(sb1[i]),
        )
        mqn = mqss = mq0 = 0
        for s, pu in enumerate(pus):
            used_ct = int((pu.used[i] & pu.valid[i]).sum())
            # tier1 depth/FDP count tier1-mapped lanes only (tier2
            # reads share the tile but only feed the tier2 tallies)
            lane_t1 = np.zeros(pu.max_depth, dtype=bool)
            v = pu.valid[i]
            lane_t1[v] = levels[s][pu.read_idx[i, v]] == rd.MapLevel.TIER1
            fdp = int((v & lane_t1 & ~pu.used[i]).sum())
            site.dp.append(used_ct + fdp)
            site.fdp.append(fdp)
            site.sdp.append(int(pu.spandel[i]))
            site.subdp.append(int(pu.submapped[i]))
            c1 = np.zeros(4, np.int32)
            c2 = np.zeros(4, np.int32)
            for d in range(pu.max_depth):
                if not pu.valid[i, d]:
                    continue
                b = pu.base_id[i, d]
                if pu.used[i, d]:
                    c1[b] += 1
                if pu.tier2_used[i, d]:
                    c2[b] += 1
            site.acgt_tier1.append(c1)
            site.acgt_tier2.append(c2)
            mqn += int(pu.mapq_n[i])
            mqss += float(pu.mapq_sumsq[i])
            mq0 += int(pu.mapq_zero[i])
        site.mq = float(np.sqrt(mqss / mqn)) if mqn else 0.0
        site.mq0 = mq0
        site.mapq_n = mqn
        # ReadPosRankSum: alt vs ref read positions in the tumor
        pu = pus[1]
        um = pu.used[i] & pu.valid[i]
        is_alt = pu.base_id[i] == alt_id
        alt_pos = pu.read_off[i][um & is_alt]
        ref_pos = pu.read_off[i][um & (pu.base_id[i] == ref_gt[i])]
        from ..utils.stats import mann_whitney_u_from_groups
        site.read_pos_ranksum = (mann_whitney_u_from_groups(
            alt_pos.astype(float), ref_pos.astype(float))
            if len(alt_pos) and len(ref_pos) else 0.0)
        snvs.append(site)

    # --- indels ---
    # batched read x haplotype scoring for all candidate loci, per
    # sample and evidence tier (one bucketed kernel launch per shape
    # instead of four small dispatches per indel — matters for device
    # round-trip latency at WGS scale)
    indel_loci = [[k] for k in cand_keys]
    batch_scores: dict = {}
    if indel_loci:
        # score the tier2 superset once per sample; tier1 results are
        # exact row subsets whenever the scoring geometry matches (the
        # locus window depends only on the max selected read length)
        # and the 512-read cap didn't truncate — otherwise those loci
        # are re-scored tier1-only
        for s in range(2):
            flank = (opt.normal_sample_min_read_bp_flank if s == 0
                     else opt.default_min_read_bp_flank)
            full = rb.score_loci_batched(
                kept[s], eas[s], levels[s], ref_all, fetch_begin,
                indel_loci, selection="overlap", min_bp_flank=flank,
                tiers=(rd.MapLevel.TIER1, rd.MapLevel.TIER2))
            batch_scores[(1, s)] = full
            t1_scores: dict = {}
            rescore = []
            for li, sc in full.items():
                t1 = levels[s][sc.read_rows] == rd.MapLevel.TIER1
                rl = sc.read_len
                geometry_ok = (len(sc.read_rows) < rb.MAX_READS_DEFAULT
                               and (not t1.any()
                                    or rl[t1].max() == rl.max()))
                if not geometry_ok:
                    rescore.append(li)
                    continue
                if not t1.any():
                    continue  # absent locus == no tier1 reads
                t1_scores[li] = realign.LocusReadScores(
                    read_rows=sc.read_rows[t1],
                    allele_lhoods=sc.allele_lhoods[t1],
                    read_len=sc.read_len[t1],
                    n_nonambig=sc.n_nonambig[t1],
                    is_fwd=sc.is_fwd[t1],
                    best_offsets=(sc.best_offsets[t1]
                                  if sc.best_offsets is not None
                                  else None),
                    win_begin=sc.win_begin,
                    genotyping_mask=(sc.genotyping_mask[t1]
                                     if sc.genotyping_mask is not None
                                     else None),
                    n_suboverlap=(int(sc.suboverlap_mask[t1].sum())
                                  if sc.suboverlap_mask is not None
                                  else 0),
                    suboverlap_mask=(sc.suboverlap_mask[t1]
                                     if sc.suboverlap_mask is not None
                                     else None),
                )
            if rescore:
                res = rb.score_loci_batched(
                    kept[s], eas[s], levels[s], ref_all, fetch_begin,
                    [indel_loci[li] for li in rescore],
                    selection="overlap", min_bp_flank=flank,
                    tiers=(rd.MapLevel.TIER1,))
                for j, li in enumerate(rescore):
                    if j in res:
                        t1_scores[li] = res[j]
            batch_scores[(0, s)] = t1_scores

    indels: list[SomaticIndelCall] = []
    for key_idx, key in enumerate(cand_keys):
        rec = store.records[key]
        if not rec.repeat_unit:
            cand.set_repeat_info(rec, ref_all, fetch_begin, decode_bases)
        # per-sample scores
        # two evidence tiers (somatic_indel_grid.cpp n_tier loop):
        # tier1 = tier1-mapped reads only; tier2 adds tier2 mappings
        tier_results = []
        grids_t1 = None
        sc_t1_tumor = None
        t1_ref = t1_ind = tor = None
        skip = False
        _, ind_to_ref = em.get_rates(
            1, rec.repeat_unit_length, rec.ref_repeat_count,
            rec.indel_repeat_count, key.is_insertion)
        for tier_i, tiers in enumerate([(rd.MapLevel.TIER1,),
                                        (rd.MapLevel.TIER1, rd.MapLevel.TIER2)]):
            # tier2 evidence passes use the tier2 random-base-match
            # probability (Tier2Options.hh:49, isRandomBaseMatchProb)
            rbm = (opt.random_base_match_prob if tier_i == 0
                   else opt.tier2_random_base_match_prob)
            ln_rbm = float(np.log(rbm))
            grid = []
            c_ref, c_ind, c_tor = [], [], []
            for s in range(2):
                flank = (opt.normal_sample_min_read_bp_flank if s == 0
                         else opt.default_min_read_bp_flank)
                sc = batch_scores[(tier_i, s)].get(key_idx)
                if sc is not None:
                    sc = realign.apply_genotyping_mask(sc)
                if sc is None:
                    skip = True
                    break
                ref_lnp = sc.allele_lhoods[:, 0]
                ind_lnp = sc.allele_lhoods[:, 1]
                grid.append(si.indel_freq_grid_lhoods(
                    ref_lnp, ind_lnp, sc.read_len, sc.n_nonambig,
                    np.ones(len(ref_lnp), bool), key.insert_length,
                    key.delete_length, flank,
                    ln_random_base_match=ln_rbm))
                # confident read counts (TAR/TIR/TOR): normalized read
                # posterior over {incorrect-mapping, ref, indel} with
                # threshold 0.51 (AlleleReportInfoUtil.cpp
                # indel_lnp_to_pprob :220-297 + readConfident-
                # SupportThreshold, starling_base_shared.hh:245);
                # reads with insufficient breakpoint overlap feed
                # n_other_reads (:400-415)
                nr, ni_, _, _ = _classify_indel_reads(
                    ref_lnp, ind_lnp, sc.n_nonambig, ln_rbm)
                c_ref.append(nr)
                c_ind.append(ni_)
                c_tor.append(len(ref_lnp) - nr - ni_ + sc.n_suboverlap)
            if skip:
                break
            if tier_i == 0:
                grids_t1 = grid
                t1_ref, t1_ind, tor = c_ref, c_ind, c_tor
                sc_t1_tumor = sc
            tier_results.append(
                (si.somatic_indel_call(
                    grid[0], grid[1], float(ind_to_ref),
                    contam_tolerance=opt.sindel_contam_tolerance,
                    somatic_indel_rate=opt.somatic_indel_rate,
                    bindel_theta=opt.bindel_diploid_theta,
                    shared_indel_error_factor=opt.shared_indel_error_factor),
                 (c_ref, c_ind, c_tor)))
            if tier_i == 0 and tier_results[0][0][0] == 0:
                break  # tier1 Q==0: skip tier2 (reference early-out)
        if skip or not tier_results:
            continue
        (q1, qn1, nt1, mg1), _ = tier_results[0]
        if len(tier_results) > 1:
            (q2, qn2, nt2, mg2), t2counts = tier_results[1]
        else:
            q2, qn2, nt2, mg2 = q1, qn1, nt1, mg1
            t2counts = (t1_ref, t1_ind, tor)
        tier = 1 if q1 > q2 else 0
        tier_nt = 1 if qn1 > qn2 else 0
        q = min(q1, q2)
        if nt1 != nt2:
            ntype_i = 3  # conflict
            qn = 0
        else:
            ntype_i = nt1
            qn = min(qn1, qn2)
        max_gt = mg1 if tier_nt == 0 else mg2
        del grids_t1
        if q == 0:
            continue
        callrec = SomaticIndelCall(
            key=key, rec=rec, qsi=q, qsi_nt=qn, ntype=ntype_i, tier=tier,
            sgt_tumor_is_som=bool(max_gt % 2))
        t2_ref, t2_ind, t2_tor = t2counts
        # tumor-sample EVS feature inputs from tier1 per-read scores:
        # read-position ranksum of the indel site (ref vs indel reads)
        # and symmetric strand odds ratio (somatic_indel_scoring_
        # features.cpp getSampleStrandOddsRatio, pseudocount 0.5)
        sc_t = sc_t1_tumor
        if sc_t is not None and len(sc_t.read_rows):
            ln_rbm1 = float(np.log(opt.random_base_match_prob))
            _, _, p_ref_t, p_ind_t = _classify_indel_reads(
                sc_t.allele_lhoods[:, 0], sc_t.allele_lhoods[:, 1],
                sc_t.n_nonambig, ln_rbm1)
            conf_ref_m = p_ref_t >= 0.51
            conf_ind_m = p_ind_t >= 0.51
            rpos = (key.pos - kept[1].pos[sc_t.read_rows]).astype(np.float64)
            from ..utils.stats import mann_whitney_u_from_groups
            callrec.read_pos_ranksum = mann_whitney_u_from_groups(
                rpos[conf_ind_m], rpos[conf_ref_m]) \
                if conf_ind_m.any() and conf_ref_m.any() else 0.0
            fwd = sc_t.is_fwd
            pc = 0.5
            fwd_alt = float((conf_ind_m & fwd).sum())
            rev_alt = float((conf_ind_m & ~fwd).sum())
            fwd_other = float((~conf_ind_m & fwd).sum())
            rev_other = float((~conf_ind_m & ~fwd).sum())
            sor = ((fwd_other + pc) * (rev_alt + pc)) / \
                  ((rev_other + pc) * (fwd_alt + pc))
            callrec.strand_odds = float(np.log(max(sor, 1.0 / sor)))
        mqn = mqss = mq0 = 0
        for s, pu in enumerate(pus):
            dpos = key.pos - 1 - begin
            dp = int(pu.depth[dpos]) if 0 <= dpos < L else 0
            callrec.dp.append(dp)
            callrec.tar.append((t1_ref[s], t2_ref[s]))
            callrec.tir.append((t1_ind[s], t2_ind[s]))
            callrec.tor.append((tor[s], t2_tor[s]))
            if 0 <= dpos < L:
                mqn += int(pu.mapq_n[dpos])
                mqss += float(pu.mapq_sumsq[dpos])
                mq0 += int(pu.mapq_zero[dpos])
        callrec.mq = float(np.sqrt(mqss / mqn)) if mqn else 0.0
        callrec.mq0 = mq0
        # 50bp window stats around the VCF record position: the
        # reference's window_average FIFO (size 2*flank,
        # strelka_pos_processor.cpp:75-77) holds positions
        # [p-flank+1, p+flank] around record pos p (empirically pinned
        # against the golden demo outputs). Positions with ref N are
        # insert_null (excluded from the mean,
        # starling_pos_processor_base.cpp:1486-1493).
        flank50 = opt.indel_region_flank_size
        c0 = key.pos - 1 - begin
        wb = min(L, c0 + flank50 + 1)
        wa = max(0, wb - 2 * flank50)
        not_n = rc[wa:wb] != 4
        n_eff = int(not_n.sum())
        for s, pu in enumerate(pus):
            used_pp = pu.used[wa:wb].sum(axis=1)
            # filtered = tier1-mapped lanes only (tier2 reads share
            # the tile but feed only tier2 tallies)
            v = pu.valid[wa:wb]
            lane_t1 = np.zeros_like(v)
            lane_t1[v] = levels[s][pu.read_idx[wa:wb][v]] == rd.MapLevel.TIER1
            filt_pp = (v & lane_t1 & ~pu.used[wa:wb]).sum(axis=1)
            sub_pp = pu.submapped[wa:wb]
            u = float(used_pp[not_n].sum() / n_eff) if n_eff else 0.0
            f = float(filt_pp[not_n].sum() / n_eff) if n_eff else 0.0
            sb_ = float(sub_pp[not_n].sum() / n_eff) if n_eff else 0.0
            denom = int(f) + int(u)
            bcn = (int(f) / denom) if denom > 0 else 0.0
            callrec.win.append((u + f, f, sb_, bcn))
        indels.append(callrec)

    return SomaticRegionResult(
        chrom=chrom, begin=begin, end=end, ref_codes=rc, snvs=snvs,
        indels=indels, callable_intervals=callable_intervals,
        realigned=([(keep_indices[s], kept[s]) for s in range(2)]
                   if collect_realigned else None))
