"""End-to-end germline calling over a region.

TPU-native replacement for the reference's per-position streaming
germline pipeline (reference: applications/starling/
starling_pos_processor.cpp process_pos_snp_digt:620,
process_pos_indel_digt:1610 and starling_run.cpp region loop).

Execution model: the whole region is processed as a few batched array
programs —
  1. read ingestion -> expanded alignment tables  (host numpy)
  2. pileup scatter -> [pos, depth] tiles          (host numpy)
  3. SNV genotyping over all positions             (torch, device)
  4. candidate indel loci -> read x haplotype scoring (CUDA kernel)
  5. indel genotyping                              (host numpy)
  6. record assembly                               (host)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io import bam as bamio
from ..io.fasta import FastaReference, decode_bases
from ..models import digt, error_model, indel_genotype as ig, snv_digt
from ..options import GermlineOptions
from ..utils import spans
from . import candidates as cand
from . import pileup as pl
from . import reads as rd
from . import realign


@dataclass
class SampleSiteData:
    """Per-sample site-level call results over [begin, end)."""
    pileup: pl.PileupRegion
    snv: snv_digt.SnvCallResult
    used_counts: np.ndarray       # [L, 4]
    used_fwd_counts: np.ndarray   # [L, 4]
    dpf: np.ndarray               # [L] filtered basecalls
    mean_edge_dist: np.ndarray | None = None  # [L] mean min-dist from read edge
    # per-position ploidy state (starling_pos_processor.cpp:644-651):
    # group_ploidy = max(0, region ploidy + spanning-deletion
    # adjustment); caller_ploidy = 2 where group_ploidy == 0 else
    # group_ploidy (genotyping ploidy); homalt_del marks sites inside
    # hom-alt genotyped deletions (GT "." / GQX undefined);
    # ploidy_conflict marks covered sites in no-ploid regions
    group_ploidy: np.ndarray | None = None    # [L] int8
    caller_ploidy: np.ndarray | None = None   # [L] int8, 1 or 2
    homalt_del: np.ndarray | None = None      # [L] bool
    ploidy_conflict: np.ndarray | None = None  # [L] bool
    # lazy per-site EVS rank-sum metrics (pileup.SiteScoringMetrics)
    scoring_metrics: object = None


@dataclass
class IndelCall:
    """One genotyped indel locus (single- or multi-allele)."""
    pos: int                      # leftmost indel pos
    keys: list[cand.IndelKey]
    records: list[cand.IndelRecord]
    # per-sample results
    sample_gt: list[int]          # triangular genotype index
    sample_gq: list[int]
    sample_gqx: list[int]
    sample_pl: list[np.ndarray]
    sample_ad: list[np.ndarray]   # [A] confident allele depths
    sample_adf: list[np.ndarray]
    sample_adr: list[np.ndarray]
    sample_dpi: list[int]
    sample_ploidy: list = None
    # per-sample mean distance-from-closest-read-edge over confident
    # primary-alt-supporting reads, capped at 20 per read
    # (AlleleReportInfoUtil.cpp:354-359; RNA EVS feature)
    sample_edge_dist: list = None
    qual: int = 0
    # this variant locus overlaps-or-touches another variant indel
    # locus in the emission stream: the overlap resolver buffers them
    # together and a multi-locus flush marks every member IndelConflict
    # (VariantOverlapResolver.cpp:84-116,446-459)
    is_conflict: bool = False
    # forced-GT allele that cannot be genotyped (complex/swap allele,
    # IndelBuffer.cpp:115-129 doNotGenotype): the record is emitted
    # with the NotGenotyped filter, 'MQ=.' and all-dot sample columns
    # (variant_prefilter_stage.cpp:83-91, gvcf_writer.cpp:907-922,
    # :1025-1054) and never genotyped
    not_genotyped: bool = False


@dataclass
class RegionCallResult:
    chrom: str
    begin: int
    end: int
    ref_codes: np.ndarray
    samples: list[SampleSiteData]
    indels: list[IndelCall]
    stats: dict = field(default_factory=dict)
    # read-backed phasing: (sample, pos, base) -> hap_id for SNVs,
    # (sample, IndelKey) -> hap_id for indels; pos -> phase-set id
    snv_hap_ids: dict = field(default_factory=dict)
    indel_hap_ids: dict = field(default_factory=dict)
    # (sample, pos) / (sample, key) -> accumulated
    # altHaplotypeCountRatio from haplotype discovery (EVS feature)
    snv_hap_ratio: dict = field(default_factory=dict)
    indel_hap_ratio: dict = field(default_factory=dict)
    phase_set_of_pos: dict = field(default_factory=dict)
    # per-sample per-position ploidy (0/1/2) over the report range
    ploidy: np.ndarray | None = None
    # (keep_indices, realigned kept batch) per sample when the caller
    # was asked to collect them (realigned-BAM output)
    realigned: list | None = None
    # halo'd reference window + report-range offset within it, for
    # context metrics (hpol/STR) that must see across segment edges
    ref_halo: np.ndarray | None = None
    halo_off: int = 0


def snv_hpol(ref_codes: np.ndarray, pos: int) -> int:
    """Contextual homopolymer length at a site (SNVHPOL info field;
    exact port of blt_common/ref_context.cpp get_snp_hpol_size: 1 +
    the adjacent up/downstream runs, summed when both flanks repeat
    the same base — the site's own base is ignored)."""
    n = len(ref_codes)
    up_repeat = 4
    up = 0
    i = pos - 1
    if i >= 0:
        up_repeat = int(ref_codes[i])
        if up_repeat != 4:
            while i >= 0 and ref_codes[i] == up_repeat:
                up += 1
                i -= 1
    dn_repeat = 4
    dn = 0
    i = pos + 1
    if i < n:
        dn_repeat = int(ref_codes[i])
        if dn_repeat != 4:
            while i < n and ref_codes[i] == dn_repeat:
                dn += 1
                i += 1
    return 1 + (up + dn if up_repeat == dn_repeat else max(up, dn))


def build_sample_pileup(
    opt: GermlineOptions,
    batch: bamio.ReadBatch,
    ea: rd.ExpandedAlignments,
    level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    begin: int,
    end: int,
    candidate_snv_mask=None,
    exempt_snv_keys: np.ndarray | None = None,
):
    """Pileup + per-position counts (no genotyping).

    ref_codes covers the halo'd fetch window starting at ref_offset;
    the pileup/report range is [begin, end). Returns a SampleSiteData
    with snv=None; genotype_sample_snvs fills it in (the split lets
    indel genotyping run first, whose genotyped deletions modify the
    site-genotyping ploidy — starling_pos_processor.hh:70-74 indel
    before snp order + pos_basecall_buffer decrementSpanningIndelPloidy)."""
    pu = None
    native_fwd = None
    if batch.n:
        # native single-pass pileup (exact match to the Python path)
        from ..io.native import pileup_native
        # depth padded to the SNV chunk bucket so full 32k chunks are
        # zero-copy row slices of the tile (no staging copies)
        res = pileup_native(
            batch, level, ref_codes, ref_offset, begin, end,
            min_qscore=opt.min_qscore,
            mm_flank=opt.max_win_mismatch_flank_size,
            mm_max=opt.max_win_mismatch,
            exempt_keys=exempt_snv_keys,
            depth_pad=snv_digt.SNV_TILE_D_PAD)
        if res is not None:
            pu, native_fwd = res
    if pu is None:
        mmf = nbm = None
        if batch.n:
            mmf, _t2, nbm = rd.mismatch_density_filter(
                batch, ea, ref_codes, ref_offset,
                opt.max_win_mismatch_flank_size, opt.max_win_mismatch,
                candidate_snv_mask=candidate_snv_mask,
                with_neighbor=True)
        pu = pl.build_pileup(batch, ea, level, ref_codes, begin, end,
                             min_qscore=opt.min_qscore, mm_filter=mmf,
                             depth_pad=snv_digt.SNV_TILE_D_PAD,
                             neighbor_mm=nbm)
    rc = ref_codes[begin - ref_offset:end - ref_offset]
    # unused lanes keep their raw base/qual values: every consumer in
    # the SNV model masks on tile.mask, and one_hot of out-of-range
    # codes is a zero row — skipping the two [L, D] np.where copies
    # saves the dominant allocation of this function
    tile = snv_digt.SnvPileupTile(
        base_id=pu.base_id,
        qual=pu.qual,
        is_fwd=pu.is_fwd,
        mask=pu.used,
        ref_gt=rc.astype(np.int32),
    )

    counts = pu.used_counts()
    if native_fwd is not None:
        fwd_counts = native_fwd
    else:
        fwd_counts = np.zeros_like(counts)
        li, di = np.nonzero(pu.used & pu.is_fwd)
        np.add.at(fwd_counts, (li, pu.base_id[li, di]), 1)
    dpf = (pu.valid & ~pu.used).sum(axis=1).astype(np.int32)
    # mean min-distance from read edge over used calls (EVS feature
    # SampleMeanDistanceFromReadEdge); the native pileup accumulates
    # the sum in its fill pass
    used_n = counts.sum(axis=1)
    if pu.edge_dist_sum is not None:
        mean_dist = np.where(used_n > 0,
                             pu.edge_dist_sum / np.maximum(used_n, 1), 0.0)
    else:
        rlens = np.diff(batch.seq_off) if batch.n else np.zeros(0, np.int64)
        ridx = np.maximum(pu.read_idx, 0)
        rl_t = rlens[ridx] if batch.n else np.zeros_like(ridx)
        dist_t = np.minimum(pu.read_off,
                            np.maximum(rl_t - 1 - pu.read_off, 0))
        with np.errstate(invalid="ignore"):
            mean_dist = np.where(
                used_n > 0,
                (dist_t * pu.used).sum(axis=1) / np.maximum(used_n, 1), 0.0)
    sd = SampleSiteData(pileup=pu, snv=None, used_counts=counts,
                        used_fwd_counts=fwd_counts, dpf=dpf,
                        mean_edge_dist=mean_dist)
    sd._tile = tile  # carried to genotype_sample_snvs
    # lazy per-site rank-sum metrics (MQ/ReadPos/BaseQ) for germline
    # SNV EVS models; costs nothing unless a model requests them
    sd.scoring_metrics = pl.SiteScoringMetrics(pu, batch, rc, ea, level)
    return sd


def genotype_sample_snvs(opt: GermlineOptions, sd: SampleSiteData,
                         haploid_mask: np.ndarray | None = None) -> None:
    """SNV genotyping over a built pileup; fills sd.snv in place."""
    dep = None
    if opt.bsnp_ssd_no_mismatch > 0 or opt.bsnp_ssd_one_mismatch > 0:
        # dependent basecall-error adjustment (adjust_joint_eprob,
        # default-on in the reference germline caller)
        pu = sd.pileup
        dep = snv_digt.dependent_eprob_deltas(
            np.asarray(pu.base_id, dtype=np.int8)
            if pu.base_id.dtype != np.int8 else pu.base_id,
            pu.qual, pu.used, pu.is_fwd, pu.neighbor_mm,
            opt.bsnp_ssd_no_mismatch, opt.bsnp_ssd_one_mismatch)
    snv = snv_digt.call_snv_tile_chunked(
        sd._tile, theta=opt.bsnp_diploid_theta,
        is_haploid=(haploid_mask
                    if haploid_mask is not None and haploid_mask.any()
                    else None),
        het_vf_extension=opt.het_variant_frequency_extension,
        het_vf_increment=opt.max_het_variant_frequency_increment,
        dep=dep)
    sd.snv = snv
    del sd._tile


def call_sample_sites(
    opt: GermlineOptions,
    batch: bamio.ReadBatch,
    ea: rd.ExpandedAlignments,
    level: np.ndarray,
    ref_codes: np.ndarray,
    ref_offset: int,
    begin: int,
    end: int,
    candidate_snv_mask=None,
    haploid_mask: np.ndarray | None = None,
    exempt_snv_keys: np.ndarray | None = None,
) -> SampleSiteData:
    """Pileup + SNV genotyping in one step (no indel interaction)."""
    sd = build_sample_pileup(opt, batch, ea, level, ref_codes, ref_offset,
                             begin, end, candidate_snv_mask=candidate_snv_mask,
                             exempt_snv_keys=exempt_snv_keys)
    genotype_sample_snvs(opt, sd, haploid_mask=haploid_mask)
    return sd


@spans.span("region")
def call_region(
    opt: GermlineOptions,
    ref: FastaReference,
    chrom: str,
    begin: int,
    end: int,
    batches: list[bamio.ReadBatch],
    external_indel_vcfs: list[str] | None = None,
    forced_gt_vcfs: list[str] | None = None,
    ploidy_vcf: str | None = None,
    collect_realigned: bool = False,
    indel_error_model_files: list[str] | None = None,
) -> RegionCallResult:
    """Joint germline calling for N samples over one region, in the
    stages of its spans: region.prep, region.discover,
    region.candidates, region.realign, region.pileup and
    region.genotype."""
    spans.stage("region.prep")
    n_samples = len(batches)
    halo = opt.max_indel_size + 250  # supplementalRegionBorderSize semantics
    fetch_begin = max(0, begin - halo)
    fetch_end = min(ref.contig_length(chrom), end + halo)
    ref_codes = ref.fetch(chrom, fetch_begin, fetch_end)

    em = error_model.IndelErrorModel(
        n_samples, model_files=indel_error_model_files)

    samples = []
    eas, levels, kept, keep_indices = [], [], [], []
    split_maps = []  # (parent_row, seg_no, pre-split kept batch) or None
    store = cand.IndelObservationStore(n_samples)
    for s, raw in enumerate(batches):
        keep, level = rd.filter_and_classify_reads(raw, opt.min_mapping_quality)
        keep_indices.append(np.nonzero(keep)[0])
        batch = raw.select(keep)
        level = level[keep]
        # spliced (N-CIGAR) reads decompose into exon segments that
        # buffer/realign/pile up independently (starling_read_segment)
        sbatch, slevel, parent_row, seg_no = rd.split_spliced_reads(
            batch, level)
        if sbatch is not batch:
            split_maps.append((parent_row, seg_no, batch))
            batch, level = sbatch, slevel
        else:
            split_maps.append(None)
        ea = rd.expand_alignments(batch)
        kept.append(batch)
        eas.append(ea)
        levels.append(level)
        cand.extract_read_indels(batch, ea, level, ref_codes, fetch_begin,
                                 store, s, opt.max_indel_size)
    spans.count("reads.kept", sum(b.n for b in kept))

    # active-region haplotype discovery: indels/SNVs confirmed by
    # haplotyping gate candidacy (IndelBuffer isHaplotypingEnabled path)
    spans.stage("region.discover")
    from . import active_region as arp
    candidate_snvs: set[tuple[int, int]] = set()  # (pos, base)
    snv_hap_ids: dict[tuple[int, int, int], int] = {}  # (sample,pos,base)->hap
    indel_hap_ids: dict[tuple[int, cand.IndelKey], int] = {}
    # accumulated altHaplotypeCountRatio per (sample, pos) / (sample,
    # key) — the EVS NormalizedAltHaplotypeCountRatio numerator
    snv_hap_ratio: dict[tuple[int, int], float] = {}
    indel_hap_ratio: dict[tuple[int, cand.IndelKey], float] = {}
    anchors = arp.anchor_mask(ref_codes)
    region_sets = []
    cand_masks = []
    for s in range(n_samples):
        counts_ev, depth_ev = arp.variant_evidence(
            kept[s], eas[s], levels[s], ref_codes, fetch_begin, fetch_end)
        region_sets.append(arp.find_active_regions(
            counts_ev, depth_ev, anchors, ref_codes, fetch_begin))
        cand_masks.append(arp.candidate_variant_mask(
            counts_ev, depth_ev, ref_codes))
    # synchronize regions across samples (union of overlapping spans)
    from ..utils.ranges import RegionTracker
    tracker = RegionTracker()
    for regions in region_sets:
        for r in regions:
            tracker.add(r.begin, r.end)
    sync_regions = [arp.ActiveRegion(b, e) for b, e in tracker.intervals()]
    phase_set_of_pos: dict[int, int] = {}
    for region in sync_regions:
        for s in range(n_samples):
            dv = arp.process_active_region(
                kept[s], eas[s], levels[s], ref_codes, fetch_begin, region,
                cand_mask=cand_masks[s])
            if dv.bypassed:
                # doNotUseHaplotyping (ActiveRegionProcessor.cpp:266-292):
                # indels in a failed region skip the haplotyping gate and
                # go through normal binomial candidacy
                for key, rec in store.records.items():
                    if region.begin <= key.pos < region.end:
                        rec.discovered_in_active_region = True
                continue
            for key, hap in dv.indels:
                rec = store._get(key)
                rec.discovered_in_active_region = True
                indel_hap_ids[(s, key)] = hap
                # every read supporting the haplotype observes the
                # discovered key (addIndelObservation per alignId,
                # ActiveRegionProcessor.cpp:739-755) — a discovered
                # placement that normalizes differently from the
                # read-CIGAR key still gets its read support
                for rid in dv.indel_read_ids.get(key, ()):
                    store.add_read_observation(key, s, rid,
                                               int(levels[s][rid]))
            for pos, base, hap in dv.snvs:
                candidate_snvs.add((pos, base))
                snv_hap_ids[(s, pos, base)] = hap
            for pos, ratio in dv.snv_ratio.items():
                snv_hap_ratio[(s, pos)] = \
                    snv_hap_ratio.get((s, pos), 0.0) + ratio
            for key, ratio in dv.indel_ratio.items():
                indel_hap_ratio[(s, key)] = \
                    indel_hap_ratio.get((s, key), 0.0) + ratio
        for p in range(region.begin, region.end):
            phase_set_of_pos[p] = region.begin + 1  # PS = 1-based start

    # external candidate indels (e.g. Manta VCF) + forced-GT alleles
    spans.stage("region.candidates")
    ng_forced: list[cand.IndelKey] = []

    def _add_vcf_indels(paths, is_forced):
        from ..io.vcf import read_vcf
        for path in paths:
            for recvcf in read_vcf(path, region=(chrom, fetch_begin, fetch_end)):
                for alt in recvcf.alts:
                    if len(recvcf.ref) >= 1 and len(alt) >= 1 and alt[0] == recvcf.ref[0]:
                        dlen = len(recvcf.ref) - 1
                        ins = alt[1:] if len(alt) > 1 else ""
                        if dlen > 0 and ins:
                            # complex (swap) allele: never genotyped
                            # (IndelBuffer.cpp:115-129 doNotGenotype);
                            # forced ones still produce a NotGenotyped
                            # record
                            if is_forced:
                                ng_forced.append(
                                    cand.IndelKey(recvcf.pos + 1, dlen, ins))
                            continue
                        if max(dlen, len(ins)) <= opt.max_indel_size and (dlen or ins):
                            store.add_external(
                                cand.IndelKey(recvcf.pos + 1, dlen, ins),
                                is_forced=is_forced)

    if external_indel_vcfs:
        _add_vcf_indels(external_indel_vcfs, False)
    if forced_gt_vcfs:
        _add_vcf_indels(forced_gt_vcfs, True)

    # ploidy regions (reference: ploidy_util.hh — VCF records with END
    # + per-sample CN; CN=1 -> haploid priors, CN=0 -> no-call)
    L_report = end - begin
    ploidy_arr = np.full((n_samples, L_report), 2, dtype=np.int8)
    if ploidy_vcf:
        from ..io.vcf import read_vcf
        for v in read_vcf(ploidy_vcf):
            if v.chrom != chrom:
                continue
            vend = v.pos + len(v.ref)
            for kv in v.info.split(";"):
                if kv.startswith("END="):
                    vend = int(kv[4:])
            fmt = v.format.split(":") if v.format else []
            cn_idx = fmt.index("CN") if "CN" in fmt else -1
            for s in range(min(n_samples, len(v.samples))):
                cn = 2
                if cn_idx >= 0:
                    try:
                        cn = int(v.samples[s].split(":")[cn_idx])
                    except (ValueError, IndexError):
                        continue
                b = max(v.pos - begin, 0)
                e = min(vend - begin, L_report)
                if e > b and cn in (0, 1):
                    ploidy_arr[s, b:e] = cn

    # MMDF exemption for haplotype-confirmed SNVs
    # (create_mismatch_filter_map's candidateSnvBuffer check)
    exempt_keys = np.array([p * 4 + b for p, b in candidate_snvs],
                           dtype=np.int64) if candidate_snvs else None

    def snv_exempt_mask(ref_pos, base):
        if exempt_keys is None:
            return np.zeros(len(ref_pos), dtype=bool)
        return np.isin(np.asarray(ref_pos, dtype=np.int64) * 4
                       + np.asarray(base, dtype=np.int64), exempt_keys)

    # candidacy over pooled observations
    ests = [cand.estimated_depth(kept[s], eas[s], levels[s], fetch_begin, fetch_end)
            for s in range(n_samples)]
    est_sum = ests[0]
    for e in ests[1:]:
        est_sum = np.maximum(est_sum, e)
    # germline caller gates indel candidacy on active-region discovery
    # (IndelBuffer.cpp:222 isHaplotypingEnabled path)
    candidacy = cand.evaluate_candidacy(
        store, est_sum, fetch_begin, em, ref_codes, fetch_begin,
        alpha=opt.indel_candidate_signal_test_alpha,
        require_active_region_discovery=True)

    # segment assignment by the VCF anchor position (k.pos - 1): the
    # record, its DPI lookup (depth at the site preceding the indel),
    # and its emission slot all live in the anchor's segment — keying
    # by k.pos instead silently dropped indels whose first changed
    # base equals a segment begin and read out-of-tile DPI
    cand_keys = sorted(k for k, ok in candidacy.items() if ok
                       and begin <= k.pos - 1 < end)

    # === reference per-position locus formation ===
    # (process_pos_indel_digt, starling_pos_processor.cpp:1609-1798 +
    # OrthogonalVariantAlleleCandidateGroupUtil.cpp; ranking/selection
    # helpers in pipeline/allele_select.py). Positions over the whole
    # fetch window are processed so _variantLocusAlreadyOutputToPos
    # stays in sync across segment boundaries (the reference runs the
    # position loop ahead of the report range for the same reason,
    # :1800-1810); only loci whose VCF anchor lands in [begin, end)
    # are emitted.
    from . import allele_select as asel
    from . import realign_batch as rb
    import dataclasses

    all_cand = sorted(k for k, ok in candidacy.items() if ok)
    spans.count("indel.candidates", len(all_cand))
    pos_alleles: dict[int, list[cand.IndelKey]] = {}
    for k in all_cand:
        pos_alleles.setdefault(k.pos, []).append(k)
    positions = sorted(pos_alleles)
    ng_at: dict[int, list[cand.IndelKey]] = {}
    for k in ng_forced:
        ng_at.setdefault(k.pos, []).append(k)

    def _pl(s, p):
        return int(ploidy_arr[s, min(max(p - begin, 0), L_report - 1)])

    # groupLocusPloidy = max ploidy over the position group's reference
    # range (doNotGenotype alleles included, :1675-1690); callerPloidy
    # maps the ploidy-0 special case to 2 (:1692-1700)
    group_pl: dict[int, tuple[list[int], list[int]]] = {}
    for p in positions:
        ks = pos_alleles[p] + ng_at.get(p, [])
        re_ = max(k.right_pos for k in ks)
        gp = [max(_pl(s, p), _pl(s, re_)) for s in range(n_samples)]
        group_pl[p] = (gp, [2 if x == 0 else x for x in gp])

    # --- round A scoring: positions whose selection needs in-sample
    # ranking (more than one alt, or a non-diploid callerPloidy — a
    # single alt under callerPloidy 2 always survives since the ref
    # consumes one of the two slots, topSize = 2 - 1 = 1)
    need_rank = [p for p in positions
                 if len(pos_alleles[p]) > 1
                 or any(c != 2 for c in group_pl[p][1])]
    rankA_idx = {p: i for i, p in enumerate(need_rank)}
    rankA_groups = [pos_alleles[p] for p in need_rank]
    scoresA = [
        rb.score_loci_batched(kept[s], eas[s], levels[s], ref_codes,
                              fetch_begin, rankA_groups,
                              selection="overlap",
                              min_bp_flank=opt.default_min_read_bp_flank)
        if rankA_groups else {}
        for s in range(n_samples)]

    # per-position ploidy-aware selection over the position clique
    # (selectTopOrthogonalAllelesInAllSamples)
    selected: dict[int, list[cand.IndelKey]] = {}
    sel_tops: dict[int, list[int]] = {}
    for p in positions:
        alts = pos_alleles[p]
        gi = rankA_idx.get(p)
        if gi is None:
            selected[p] = list(alts)
            sel_tops[p] = [0] * n_samples
            continue
        lh = []
        for s in range(n_samples):
            sc = scoresA[s].get(gi)
            lh.append(None if sc is None else sc.allele_lhoods)
        kept_idx, tops = asel.select_top_in_all_samples(
            lh, group_pl[p][1], len(alts))
        selected[p] = [alts[i] for i in kept_idx]
        sel_tops[p] = tops

    # --- round B scoring: merged groups for cross-position extension
    # (addAllelesAtOtherPositions) + plain groups round A didn't score
    ext_news: dict[int, list[cand.IndelKey]] = {}
    for p in positions:
        top = selected[p]
        if not top:
            continue
        news, _ = asel.extension_candidates(top, all_cand, p)
        if news:
            ext_news[p] = news
    B_groups: list[list[cand.IndelKey]] = []
    B_idx: dict[int, int] = {}
    for p in positions:
        top = selected[p]
        if not top:
            continue
        if p in ext_news:
            B_idx[p] = len(B_groups)
            B_groups.append(top + ext_news[p])
        elif p not in rankA_idx:
            B_idx[p] = len(B_groups)
            B_groups.append(top)
    scoresB = [
        rb.score_loci_batched(kept[s], eas[s], levels[s], ref_codes,
                              fetch_begin, B_groups,
                              selection="overlap",
                              min_bp_flank=opt.default_min_read_bp_flank)
        if B_groups else {}
        for s in range(n_samples)]

    # --- per-position resolution: extension rank + greedy clique +
    # final re-selection; final score matrices are column subsets of
    # the round A/B matrices with the breakpoint gate rekeyed to the
    # final first allele
    final_group: dict[int, list[cand.IndelKey]] = {}
    top_of: dict[int, list[int]] = {}
    final_scores: list[dict[int, object]] = [dict() for _ in range(n_samples)]
    for p in positions:
        top = selected[p]
        if not top:
            final_group[p] = []
            top_of[p] = [0] * n_samples
            continue
        if p in B_idx:
            src_gi, src_keys, src_scores = B_idx[p], B_groups[B_idx[p]], scoresB
        else:
            src_gi, src_keys, src_scores = (rankA_idx[p], pos_alleles[p],
                                            scoresA)
        colmap = {k: i for i, k in enumerate(src_keys)}

        def _sub_lh(cols, _src_scores=src_scores, _gi=src_gi):
            out = []
            perm = [0] + [1 + c for c in cols]
            for s in range(n_samples):
                sc = _src_scores[s].get(_gi)
                out.append(None if sc is None
                           else sc.allele_lhoods[:, perm])
            return out

        group = top
        tops = sel_tops[p]
        if p in ext_news:
            news = ext_news[p]
            n_top = len(top)
            if len(news) > 1:
                # rank new alts wrt the new-alt set alone
                # (addAllelesAtOtherPositions:554-612), then keep the
                # top-ranked subset that preserves the conflict clique
                order = asel.rank_new_alt_alleles(
                    _sub_lh(list(range(n_top, n_top + len(news)))),
                    len(news))
                clique = asel.greedy_orthogonal_clique(
                    [news[j] for j in order])
            else:
                clique = news
            extended = top + clique
            ext_cols = [colmap[k] for k in extended]
            kept_idx, tops = asel.select_top_in_all_samples(
                _sub_lh(ext_cols), group_pl[p][1], len(extended))
            group = [extended[i] for i in kept_idx]
            # repeat-ALT filtration (two alleles resolving to the same
            # REF/ALT string, :659-681): drop repeats and re-select
            if len(group) > 1:
                reps = asel.allele_group_alt_repeats(
                    group, ref_codes, fetch_begin, decode_bases)
                if any(reps):
                    filtered = [k for k, r in zip(group, reps) if not r]
                    f_cols = [colmap[k] for k in filtered]
                    kept_idx, tops = asel.select_top_in_all_samples(
                        _sub_lh(f_cols), group_pl[p][1], len(filtered))
                    group = [filtered[i] for i in kept_idx]
        final_group[p] = group
        top_of[p] = tops
        cols = [colmap[k] for k in group]
        identity = cols == list(range(len(src_keys)))
        perm = np.array([0] + [1 + c for c in cols])
        for s in range(n_samples):
            sc = src_scores[s].get(src_gi)
            if sc is None:
                continue
            if not identity:
                sc = dataclasses.replace(
                    sc, allele_lhoods=sc.allele_lhoods[:, perm],
                    best_offsets=(sc.best_offsets[:, perm]
                                  if sc.best_offsets is not None else None))
                sc = rb.recompute_bp_gate(sc, group[0],
                                          opt.default_min_read_bp_flank)
            final_scores[s][p] = sc

    # ordered locus list for realignment / the genotype pre-pass
    loci_positions = [p for p in positions if final_group[p]]
    groups_trimmed = [final_group[p] for p in loci_positions]
    scored_groups = groups_trimmed
    sample_scores = [
        {li: final_scores[s][p] for li, p in enumerate(loci_positions)
         if p in final_scores[s]}
        for s in range(n_samples)]

    spans.stage("region.realign")
    # pre-realignment read batches: the forced-output pathway scores
    # displaced forced alleles against their governing locus AFTER
    # genotyping (the contrast group depends on which loci are variant),
    # and those scores must come from the same pre-realignment
    # alignments every other score came from
    pre_realign_kept = list(kept)
    pre_realign_eas = list(eas)

    # apply realignments (finishRealignment semantics): reads that
    # confidently support an indel haplotype get the indel embedded in
    # their alignment; site calling then runs on the realigned pileup
    from . import realign_apply as ra
    n_realigned_total = 0
    for s in range(n_samples):
        new_batch, n_re = ra.apply_realignments(
            kept[s], sample_scores[s], scored_groups,
            unroll_clips=not opt.retain_optimal_soft_clipping,
            ref_codes=ref_codes, ref_offset=fetch_begin)
        if n_re:
            kept[s] = new_batch
            eas[s] = rd.expand_alignments(new_batch)
            n_realigned_total += n_re

    # open breakpoint (BP_LEFT/BP_RIGHT) candidates from oversized read
    # indels: reads whose breakpoint haplotype wins get soft-clipped at
    # the junction before the pileup
    bp_cands = cand.evaluate_breakpoint_candidacy(
        store, est_sum, fetch_begin, em,
        alpha=opt.indel_candidate_signal_test_alpha)
    if bp_cands:
        for s in range(n_samples):
            bp_loci = [(pos, side, realign.score_breakpoint_locus(
                kept[s], eas[s], levels[s], ref_codes, fetch_begin,
                pos, side, seq)) for pos, side, seq in bp_cands]
            new_batch, n_bp = ra.apply_breakpoint_clips(kept[s], bp_loci)
            if n_bp:
                kept[s] = new_batch
                eas[s] = rd.expand_alignments(new_batch)
                n_realigned_total += n_bp

    # per-sample pileups over the report range (post-realignment,
    # matching the reference's align -> pileup stage order)
    spans.stage("region.pileup")
    for s in range(n_samples):
        samples.append(build_sample_pileup(
            opt, kept[s], eas[s], levels[s], ref_codes, fetch_begin,
            begin, end, candidate_snv_mask=snv_exempt_mask,
            exempt_snv_keys=exempt_keys))

    spans.stage("region.genotype")
    # indel genotyping runs BEFORE site genotyping (the reference
    # processes indels first at each position,
    # starling_pos_processor.hh:70-74) because genotyped deletion
    # alleles reduce the site-genotyping ploidy over their span
    # (updateDiploidIndelLocusWithSampleInfo ->
    # pos_basecall_buffer::decrementSpanningIndelPloidy)
    # batched genotype pre-pass: apply the breakpoint gate, then run
    # the per-locus lhood/confidence/support math for ALL (sample,
    # locus) pairs sharing (ploidy, allele count) in one vectorized
    # call (ig.batch_genotype_lhoods — bitwise identical to the
    # in-loop formulation, tests/test_indel_batch_gt.py)
    pre_gt_map: dict[tuple[int, int], object] = {}
    _buckets: dict[tuple[int, int], list] = {}
    for gi, group in enumerate(groups_trimmed):
        A_loc = len(group) + 1
        for s in range(n_samples):
            sc = sample_scores[s].get(gi)
            if sc is None:
                continue
            gated = realign.apply_genotyping_mask(sc)
            if gated is None:
                pre_gt_map[(s, gi)] = "EMPTY"
                continue
            cp = max(group_pl[loci_positions[gi]][0][s], 1)
            # power-of-two read-count sub-buckets bound padding waste
            # (one deep locus must not inflate Rpad for every locus)
            rb_key = 1 << max(int(len(gated.allele_lhoods)) - 1, 0)                 .bit_length()
            _buckets.setdefault((cp, A_loc, rb_key), []).append(
                (s, gi, gated))
    for (cp, A_loc, _rb), items in _buckets.items():
        entries = [(np.asarray(sc.allele_lhoods, np.float64),
                    sc.read_len, sc.n_nonambig,
                    [k.insert_length for k in groups_trimmed[gi]],
                    [k.delete_length for k in groups_trimmed[gi]])
                   for s, gi, sc in items]
        res = ig.batch_genotype_lhoods(entries, cp, A_loc,
                                       opt.default_min_read_bp_flank)
        for (s, gi, sc), (lh_b, conf_b, sup_b) in zip(items, res):
            pre_gt_map[(s, gi)] = (sc, lh_b, conf_b, sup_b)

    # --- position-ordered genotyping with downstream-locus suppression
    # (_variantLocusAlreadyOutputToPos, :1610-1618,1788-1798): once a
    # variant locus is reported, every position through its range end
    # is skipped; forced alleles inside the skipped range ride the
    # forced-output pathway against the reporting locus's allele group
    indel_calls: list[IndelCall] = []
    all_calls: list[IndelCall] = []   # emitted or not: ploidy adjustment
    already_out = None
    # (key, contrast keys, groupPloidy, callerPloidy): displaced forced
    # alleles scored after the variant pass (their contrast group
    # depends on which loci are variant)
    forced_jobs: list[tuple[cand.IndelKey, list[cand.IndelKey],
                            list[int], list[int]]] = []
    pos_of_locus = {p: gi for gi, p in enumerate(loci_positions)}
    for p in positions:
        if already_out is not None and p <= already_out:
            continue
        group = final_group[p]
        gp, cp_l = group_pl[p]
        variant = False
        call = None
        if group:
            gi = pos_of_locus[p]
            call = genotype_indel_locus(
                opt, group, [store.records[k] for k in group], kept, eas,
                levels, ref_codes, fetch_begin, samples, begin, n_samples,
                sample_ploidy=list(gp),
                precomputed_scores=[sample_scores[s].get(gi)
                                    for s in range(n_samples)],
                pre_gt=[pre_gt_map.get((s, gi)) for s in range(n_samples)],
                top_per_sample=top_of[p])
            variant = call is not None and any(g > 0 for g in call.sample_gt)
        if variant:
            all_calls.append(call)
            if begin <= call.pos - 1 < end:
                indel_calls.append(call)
            range_end = max(k.right_pos for k in group)
            if already_out is None or range_end > already_out:
                already_out = range_end
            # forced alleles at positions covered by this locus's range
            # that are not locus members (:1891-1916)
            members = set(group)
            for q in positions:
                if q <= p or q > range_end:
                    continue
                for k in pos_alleles[q]:
                    if store.records[k].is_forced_output \
                            and k not in members:
                        forced_jobs.append((k, list(group), gp, cp_l))
        # forced alleles at this position outside the emitted group
        # (the whole group when the locus is not a variant locus —
        # forcedAllelesAlreadyOutput only fills on report, :1838-1854)
        members = set(group) if variant else set()
        for k in pos_alleles[p]:
            if store.records[k].is_forced_output and k not in members:
                forced_jobs.append((k, list(final_group[p]), gp, cp_l))

    # --- forced-output pathway (:1825-1966): one single-allele locus
    # per displaced forced allele, scored against its governing variant
    # allele group as a CONTRAST whose read scores are maxed down into
    # ref (AlleleGroupGenotype.cpp:236-247); scores come from the
    # pre-realignment alignments like every other score matrix
    if forced_jobs:
        fgroups = [[k] + contrast for k, contrast, _, _ in forced_jobs]
        fscores = [
            rb.score_loci_batched(pre_realign_kept[s], pre_realign_eas[s],
                                  levels[s], ref_codes, fetch_begin,
                                  fgroups, selection="overlap",
                                  min_bp_flank=opt.default_min_read_bp_flank)
            for s in range(n_samples)]
        for fi, (fkey, contrast, gp, cp_l) in enumerate(forced_jobs):
            call = genotype_indel_locus(
                opt, [fkey], [store.records[fkey]], pre_realign_kept,
                pre_realign_eas, levels, ref_codes, fetch_begin, samples,
                begin, n_samples, sample_ploidy=list(gp),
                precomputed_scores=[fscores[s].get(fi)
                                    for s in range(n_samples)],
                n_contrast=len(contrast))
            if call is not None:
                all_calls.append(call)
                if begin <= call.pos - 1 < end:
                    indel_calls.append(call)

    # forced complex (swap) alleles: NotGenotyped records with all-dot
    # sample columns; zero GTs keep them out of the site-modification
    # and spanning-deletion ploidy machinery below
    for key in ng_forced:
        if not (begin <= key.pos <= end):
            continue
        zero = np.zeros(2, dtype=np.int32)  # A = 1 alt + ref
        indel_calls.append(IndelCall(
            pos=key.pos, keys=[key],
            records=[cand.IndelRecord(key=key, samples=[],
                                      is_external=True,
                                      is_forced_output=True)],
            sample_gt=[0] * n_samples, sample_gq=[0] * n_samples,
            sample_gqx=[0] * n_samples,
            sample_pl=[np.zeros(3, np.int64)] * n_samples,
            sample_ad=[zero] * n_samples, sample_adf=[zero] * n_samples,
            sample_adr=[zero] * n_samples, sample_dpi=[0] * n_samples,
            sample_ploidy=[2] * n_samples,
            sample_edge_dist=[0.0] * n_samples,
            not_genotyped=True))
    indel_calls.sort(key=lambda c: c.pos)
    spans.count("indel.loci", len(loci_positions) + len(forced_jobs))

    # IndelConflict: variant indel loci whose ranges overlap or touch
    # buffer together in the overlap resolver, and a flush with more
    # than one buffered variant locus marks them ALL IndelConflict
    # (VariantOverlapResolver.cpp:84-116 pos > end flushes, :446-459
    # annotateVariantIndelRecordsAsConflicting). With the reference's
    # downstream-locus suppression this arises when a forced allele
    # inside a reported locus's range itself genotypes non-ref.
    chain: list[IndelCall] = []
    chain_end = None
    for call in sorted((c for c in indel_calls
                        if any(g > 0 for g in c.sample_gt)),
                       key=lambda c: c.pos):
        if chain and call.pos > chain_end:
            if len(chain) > 1:
                for c in chain:
                    c.is_conflict = True
            chain = []
        chain.append(call)
        cend = max(k.right_pos for k in call.keys)
        chain_end = cend if chain_end is None or len(chain) == 1 \
            else max(chain_end, cend)
    if len(chain) > 1:
        for c in chain:
            c.is_conflict = True

    # spanning-deletion ploidy modification: each deletion allele
    # occurrence in a sample's max GT decrements ploidy over
    # [key.pos, key.right_pos) (starling_pos_processor.cpp:1213-1243).
    # Every genotyped locus contributes, including loci anchored just
    # outside the segment whose deletion span reaches in (all_calls).
    from ..models.indel_genotype import genotype_alleles as _galleles
    ploidy_adj = np.zeros((n_samples, L_report), dtype=np.int16)
    for call in all_calls:
        A = len(call.keys) + 1
        for s in range(n_samples):
            pl_s = max(call.sample_ploidy[s], 1) if call.sample_ploidy else 2
            ga = _galleles(pl_s, A)
            for ai in ga[call.sample_gt[s]][:pl_s]:
                ai = int(ai)
                if ai == 0:
                    continue
                k = call.keys[ai - 1]
                if k.delete_length == 0:
                    continue
                b = max(k.pos - begin, 0)
                e = min(k.right_pos - begin, L_report)
                if e > b:
                    ploidy_adj[s, b:e] -= 1

    group_ploidy = np.maximum(
        ploidy_arr.astype(np.int16) + ploidy_adj, 0).astype(np.int8)
    caller_ploidy = np.where(group_ploidy == 0, 2, group_ploidy).astype(np.int8)
    homalt_del = (group_ploidy == 0) & (ploidy_adj < 0)

    # site genotyping with the deletion-adjusted ploidy
    spans.count("snv.sites", n_samples * L_report)
    for s in range(n_samples):
        sd = samples[s]
        genotype_sample_snvs(opt, sd, haploid_mask=(caller_ploidy[s] == 1))
        dp_v = sd.used_counts.sum(axis=1)
        sd.group_ploidy = group_ploidy[s]
        sd.caller_ploidy = caller_ploidy[s]
        sd.homalt_del = homalt_del[s]
        # covered sites in a no-ploid region that is NOT a hom-alt
        # deletion span conflict with the declared ploidy
        # (updateSnvLocusWithSampleInfo:366-373)
        sd.ploidy_conflict = ((dp_v > 0) & (group_ploidy[s] == 0)
                              & ~homalt_del[s])

    return RegionCallResult(
        chrom=chrom, begin=begin, end=end,
        ref_codes=ref_codes[begin - fetch_begin:end - fetch_begin],
        ref_halo=ref_codes, halo_off=begin - fetch_begin,
        samples=samples, indels=indel_calls,
        stats={"n_candidate_indels": len(cand_keys),
               "n_indel_records": len(store.records),
               "n_breakpoint_obs": len(store.breakpoints),
               "n_realigned_reads": n_realigned_total},
        snv_hap_ids=snv_hap_ids, indel_hap_ids=indel_hap_ids,
        snv_hap_ratio=snv_hap_ratio, indel_hap_ratio=indel_hap_ratio,
        phase_set_of_pos=phase_set_of_pos,
        ploidy=ploidy_arr,
        realigned=([(keep_indices[s],
                     kept[s] if split_maps[s] is None else
                     rd.reassemble_spliced(kept[s], split_maps[s][0],
                                           split_maps[s][1],
                                           split_maps[s][2]))
                    for s in range(n_samples)]
                   if collect_realigned else None),
    )


def indel_edge_distances(lrp, rrp, rl):
    """Per-read distance of an indel from the closest read edge at its
    scored with-indel placement, capped at 20.

    lrp: read offset of the first base at/after the indel; rrp: same
    plus the insertion length; rl: read lengths. Mirrors
    starling_read_align_score_indels.cpp:977-1018 (readPos = lowest
    read offset covering [pos-1, right_pos+1), revReadPos its
    reverse-strand twin, distance defaults to the full read length
    when neither side is in range) + the cap at
    AlleleReportInfoUtil.cpp:356."""
    d1 = lrp - 1
    d2 = rl - 1 - rrp
    dist = np.asarray(rl, np.int64).copy()
    dist = np.where(d1 >= 0, np.minimum(dist, d1), dist)
    dist = np.where(d2 >= 0, np.minimum(dist, d2), dist)
    return np.minimum(dist, 20)


def genotype_indel_locus(opt, keys, recs, kept, eas, levels, ref_codes,
                         ref_offset, samples, region_begin, n_samples,
                         sample_ploidy=None, precomputed_scores=None,
                         n_contrast: int = 0, pre_gt=None,
                         top_per_sample=None):
    """Genotype one multi-sample indel locus from read x hap scores.

    n_contrast > 0: the score matrices carry that many trailing
    contrast-allele columns beyond the locus alleles; their per-read
    scores are maxed down into the ref column before genotyping
    (AlleleGroupGenotype.cpp:236-247, the <*> reduction used by the
    forced-output pathway).

    pre_gt: optional per-sample list from the batched pre-pass
    (ig.batch_genotype_lhoods via call_region): each entry is None
    (compute here), the sentinel "EMPTY" (reads gated to nothing), or
    (gated_scores, lh, conf, sup) — bitwise identical to the in-here
    computation (tests/test_indel_batch_gt.py), just hoisted out of
    the per-locus loop."""
    A = len(keys) + 1
    info = ig.AlleleInfo(
        insert_len=np.array([k.insert_length for k in keys]),
        delete_len=np.array([k.delete_length for k in keys]),
    )
    # STR context of the PER-SAMPLE top-ranked allele drives that
    # sample's prior (repeatingPatternSize/patternRepeatCount from
    # alleleGroup.data(topAlleleIndexInSample),
    # starling_pos_processor.cpp:1408-1416); repeat info is computed
    # up front for every allele so any of them can key the theta table
    for rec in recs:
        if not rec.repeat_unit:
            cand.set_repeat_info(rec, ref_codes, ref_offset, decode_bases)
    default_ploidy = 1 if opt.is_haploid else 2
    if sample_ploidy is None:
        sample_ploidy = [default_ploidy] * n_samples

    call = IndelCall(pos=min(k.pos for k in keys), keys=keys, records=recs,
                     sample_gt=[], sample_gq=[], sample_gqx=[], sample_pl=[],
                     sample_ad=[], sample_adf=[], sample_adr=[],
                     sample_dpi=[], sample_ploidy=list(sample_ploidy),
                     sample_edge_dist=[])
    any_variant = False
    homref_lnp = 0.0  # sum over samples of ln P(hom-ref | genome prior)
    for s in range(n_samples):
        ploidy = max(sample_ploidy[s], 1)  # ploidy-0: emit as haploid no-call
        pre = pre_gt[s] if pre_gt is not None else None
        lh_pre = conf_pre = sup_pre = None
        if pre == "EMPTY":
            scores = None
        elif pre is not None:
            scores, lh_pre, conf_pre, sup_pre = pre
        elif precomputed_scores is not None:
            scores = precomputed_scores[s]
        else:
            scores = realign.score_locus(kept[s], eas[s], levels[s],
                                         ref_codes, ref_offset, list(keys))
        if pre is None and scores is not None:
            # breakpoint-overlap gate: only sufficiently-overlapping
            # reads receive ReadPathScores for genotyping
            scores = realign.apply_genotyping_mask(scores)
        if n_contrast and scores is not None and len(scores.allele_lhoods):
            import dataclasses
            al = scores.allele_lhoods
            keep = al.shape[1] - n_contrast
            red = al[:, :keep].copy()
            red[:, 0] = np.maximum(red[:, 0], al[:, keep:].max(axis=1))
            scores = dataclasses.replace(scores, allele_lhoods=red)
        # per-sample top variant allele: summed naive per-read allele
        # posteriors over the gated read set, top alt by support
        # (rankOrthogonalAllelesInSample,
        # OrthogonalVariantAlleleCandidateGroupUtil.cpp:210-258 — raw
        # lhoods, no mapping-status integration; the reference's
        # read_path_lnp maps hold only reads that passed the same
        # overlap gate). Samples with no scored reads default to
        # allele 0 (selectTopOrthogonalAllelesInAllSamples:380-390)
        top_s = 0
        if top_per_sample is not None:
            # topVariantAlleleIndexPerSample from the selection phase
            # (selectTopOrthogonalAllelesInAllSamples:371-391) — the
            # sample's top-ranked allele mapped into the final group
            top_s = min(int(top_per_sample[s]), A - 2)
        elif A > 2 and scores is not None and len(scores.allele_lhoods):
            if sup_pre is not None:
                sup = sup_pre
            else:
                al = scores.allele_lhoods - scores.allele_lhoods.max(
                    axis=1, keepdims=True)
                p = np.exp(al)
                sup = (p / p.sum(axis=1, keepdims=True)).sum(axis=0)
            top_s = int(np.argmax(sup[1:]))
        prior_rec = recs[top_s]
        tri_g, tri_p = ig.context_tri_priors(
            int(prior_rec.repeat_unit_length),
            int(prior_rec.ref_repeat_count), A, ploidy, top_s)
        edge_mean = 0.0
        if scores is None:
            lh = np.zeros(ig.genotype_count(ploidy, A))
            ad = np.zeros(A, np.int32)
            adf = np.zeros(A, np.int32)
            adr = np.zeros(A, np.int32)
        elif lh_pre is not None:
            lh = lh_pre
            conf = conf_pre
            ad = conf.sum(axis=0).astype(np.int32)
            adf = (conf & scores.is_fwd[:, None]).sum(axis=0) \
                .astype(np.int32)
            adr = ad - adf
        else:
            glh = ig.genotype_log_lhoods(
                scores.allele_lhoods,
                np.ones(len(scores.read_rows), bool),
                scores.read_len, scores.n_nonambig, info,
                ploidy, opt.default_min_read_bp_flank)
            lh = np.asarray(glh)
            # confident supporting read counts (updateSupportingReadStats)
            integ = scores.allele_lhoods + ig.CORRECT_MAPPING_LOG_PRIOR
            rb = scores.n_nonambig[:, None] * ig.LN_RANDOM_BASE_MATCH
            al = np.logaddexp(integ, rb)
            al = al - al.max(axis=1, keepdims=True)
            p = np.exp(al)
            p /= p.sum(axis=1, keepdims=True)
            conf = p >= 0.51  # readConfidentSupportThreshold
            ad = conf.sum(axis=0).astype(np.int32)
            adf = (conf & scores.is_fwd[:, None]).sum(axis=0) \
                .astype(np.int32)
            adr = ad - adf

        pg, max_g, q_ref_g, q_max_g = ig.genotype_posteriors(lh, tri_g)
        pp, max_p, q_ref_p, q_max_p = ig.genotype_posteriors(lh, tri_p)
        if scores is not None and scores.best_offsets is not None:
            # mean distance of the genotype's primary alt indel from
            # the closest read edge over its confident supporting
            # reads, capped at 20 per read: readPos = lowest read
            # offset covering [pos-1, right_pos+1) on the max
            # with-indel placement, revReadPos its reverse-strand twin
            # (AlleleReportInfoUtil.cpp:354-359 +
            # starling_read_align_score_indels.cpp:977-1018)
            ga0 = ig.genotype_alleles(ploidy, A)
            ia0, ia1 = (int(x) for x in ga0[max_p])
            primary = ia0 if ia0 > 0 else (ia1 if ia1 > 0 else 1)
            keyp = keys[primary - 1]
            sel = conf[:, primary]
            if sel.any():
                lrp = (keyp.pos - scores.win_begin
                       - scores.best_offsets[sel, primary])
                edge_mean = float(indel_edge_distances(
                    lrp, lrp + keyp.insert_length,
                    scores.read_len[sel]).mean())
        gq = q_max_p
        gqx = min(q_max_g, q_max_p) if max_g == max_p else 0
        pl_arr = np.minimum(np.round(-10 * (lh - lh.max()) / np.log(10)), 999)
        call.sample_gt.append(max_p)
        call.sample_gq.append(int(gq))
        call.sample_gqx.append(int(gqx))
        call.sample_pl.append(pl_arr.astype(np.int32))
        call.sample_ad.append(ad)
        call.sample_adf.append(adf)
        call.sample_adr.append(adr)
        dpi_pos = call.pos - 1 - region_begin
        dpi = int(samples[s].pileup.depth[dpi_pos]) if 0 <= dpi_pos < len(samples[s].pileup.depth) else 0
        call.sample_dpi.append(dpi + int(samples[s].dpf[dpi_pos]) if 0 <= dpi_pos < len(samples[s].dpf) else dpi)
        call.sample_edge_dist.append(edge_mean)
        ga = ig.genotype_alleles(ploidy, A)
        if (ga[max_p] > 0).any():
            any_variant = True
        # QUAL accumulates ln of the genome-prior hom-ref posterior
        # over samples (starling_pos_processor.cpp:1500-1501 + :1774
        # ln_error_prob_to_qphred(homRefLogProb))
        homref_lnp += float(np.log(max(pg[0], np.finfo(np.float64).tiny)))
    import math
    call.qual = int(math.floor(-10.0 * homref_lnp / math.log(10.0) + 0.5))
    if not any_variant and not any(r.is_forced_output for r in recs):
        return None
    return call
