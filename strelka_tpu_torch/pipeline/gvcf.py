"""gVCF / variants-VCF record assembly and serialization.

Reference: applications/starling/gvcf_writer.cpp (site record
:560-740, block record :750-815, indel record :816+), gvcf_header.cpp,
gvcf_block_site_record.hh (hom-ref block compression criteria), and
gvcf_compressor.hh. Host-side ordered text emission by design —
SURVEY.md §5 'keep emission on hosts'.
"""
from __future__ import annotations

import numpy as np

from ..io.fasta import decode_bases
from ..io.vcf import identity_header_lines
from ..models import digt
from ..options import GermlineOptions
from ..utils import spans
from .germline_caller import IndelCall, RegionCallResult, snv_hpol


FORCE_PYTHON_BLOCKS = False  # test hook: disable native/blocks.cpp


def _round_half(x: float) -> int:
    """std::round / compat_round semantics: half away from zero (the
    values here are non-negative means/RMS; Python round() is banker's
    and differs on every .5)."""
    import math
    return int(math.floor(x + 0.5))


def _blockable(lo: int, hi: int, v: int, abs_tol: int,
               frac_tol: float) -> bool:
    """Exact port of gvcf_block_site_record.cpp check_block_tolerance
    over the running [lo, hi] extended by v: (min + tol) >= max/2
    with the abs/frac two-stage rule."""
    m = v if v < lo else lo
    h = v if v > hi else hi
    if (m + abs_tol) >= h / 2.0:
        return True
    ftol = int(m * frac_tol)  # floor for non-negative values
    if ftol <= abs_tol:
        return False
    return (m + ftol) >= h / 2.0


# reference FILTER enum order (gvcf_locus_info.hh
# GERMLINE_VARIANT_VCF_FILTERS::index_t; HighBaseFilt prints as
# HighDPFRatio)
_FILTER_ORDER = ("IndelConflict", "SiteConflict", "PloidyConflict",
                 "LowGQX", "PhasingConflict", "HighDPFRatio",
                 "HighDepth", "HighSNVSB", "HighSNVHPOL", "HighRefRep",
                 "LowDepth", "NoPassedVariantGTs", "NotGenotyped")


def _filter_str(fset) -> str:
    """FILTER/FT column string in the reference's enum order."""
    ordered = [f for f in _FILTER_ORDER if f in fset]
    ordered += [f for f in sorted(fset) if f not in _FILTER_ORDER]
    return ";".join(ordered) if ordered else "PASS"


class BlockState:
    """Hom-ref block accumulator (gvcf_block_site_record.hh).

    Sites join while every tracked value stays in the band
    [lo, max(lo+abs_tol, lo*(1+frac_tol))] of the block's running
    min/max — O(1) running accumulators instead of per-site lists."""

    __slots__ = ("start", "count", "ref_base", "gt", "filters",
                 "gqx_min", "gqx_max", "dp_min", "dp_max", "dp_sum",
                 "dpf_min", "dpf_max", "dpf_sum", "pl", "used_cov")

    def __init__(self):
        self.start = -1
        self.count = 0
        self.ref_base = "N"
        self.gt = "0/0"
        self.filters = "PASS"
        self.gqx_min = self.gqx_max = 0
        self.dp_min = self.dp_max = self.dp_sum = 0
        self.dpf_min = self.dpf_max = self.dpf_sum = 0
        self.pl = 2
        self.used_cov = False

    def can_join(self, gqx, dp, dpf, filters, abs_tol, frac_tol,
                 gt=None, pl=2, used_cov=None):
        """gvcf_block_site_record.cpp testCanSiteJoinSampleBlock:
        filters, genotype, ploidy, and coverage states must match; gqx,
        dpu, dpf must stay within check_block_tolerance."""
        if self.count == 0:
            return True
        if filters != self.filters:
            return False
        if gt is not None and gt != self.gt:
            return False
        if pl != self.pl:
            return False
        if used_cov is not None and used_cov != self.used_cov:
            return False
        return (_blockable(self.gqx_min, self.gqx_max, gqx,
                           abs_tol, frac_tol)
                and _blockable(self.dp_min, self.dp_max, dp,
                               abs_tol, frac_tol)
                and _blockable(self.dpf_min, self.dpf_max, dpf,
                               abs_tol, frac_tol))

    def add(self, pos, ref_base, gt, gqx, dp, dpf, filters, pl=2):
        if self.count == 0:
            self.start = pos
            self.ref_base = ref_base
            self.gt = gt
            self.filters = filters
            self.pl = pl
            self.used_cov = dp > 0
            self.gqx_min = self.gqx_max = gqx
            self.dp_min = self.dp_max = dp
            self.dpf_min = self.dpf_max = dpf
            self.dp_sum = self.dpf_sum = 0
        else:
            if gqx < self.gqx_min:
                self.gqx_min = gqx
            elif gqx > self.gqx_max:
                self.gqx_max = gqx
            if dp < self.dp_min:
                self.dp_min = dp
            elif dp > self.dp_max:
                self.dp_max = dp
            if dpf < self.dpf_min:
                self.dpf_min = dpf
            elif dpf > self.dpf_max:
                self.dpf_max = dpf
        self.count += 1
        self.dp_sum += dp
        self.dpf_sum += dpf

    @property
    def dp(self):  # minimal compat for continuous-mode flush
        return [self.dp_min] if self.count else []

    @property
    def gqx(self):
        return [self.gqx_min] if self.count else []

    @property
    def dpf(self):
        return [self.dpf_min] if self.count else []

    def flush(self, chrom, out, block_label):
        if self.count == 0:
            return
        info = "."
        if self.count > 1:
            info = f"END={self.start + self.count};{block_label}"
        line = (f"{chrom}\t{self.start + 1}\t.\t{self.ref_base}\t.\t.\t"
                f"{self.filters}\t{info}\tGT:GQX:DP:DPF:MIN_DP\t"
                f"{self.gt}:{self.gqx_min}:"
                f"{_round_half(self.dp_sum / self.count)}:"
                f"{_round_half(self.dpf_sum / self.count)}:{self.dp_min}")
        out.append(line)
        self.__init__()


def gvcf_header(opt: GermlineOptions, chrom: str, chrom_len: int,
                sample_names: list[str]) -> str:
    lines = [
        "##fileformat=VCFv4.1",
        *identity_header_lines(opt.cmdline, opt.reference_path),
        "##content=strelka_tpu_torch germline small-variant calls",
        f"##contig=<ID={chrom},length={chrom_len}>",
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the region described in this record">',
        f'##INFO=<ID={opt.block_label},Number=0,Type=Flag,Description="Non-variant multi-site block">',
        '##INFO=<ID=SNVHPOL,Number=1,Type=Integer,Description="SNV contextual homopolymer length">',
        *(['##INFO=<ID=EVSF,Number=.,Type=Float,Description="Empirical variant scoring features.">']
          if opt.is_report_evs_features else []),
        '##INFO=<ID=CIGAR,Number=A,Type=String,Description="CIGAR alignment for each alternate indel allele">',
        '##INFO=<ID=RU,Number=A,Type=String,Description="Smallest repeating sequence unit extended or contracted in the indel allele relative to the reference">',
        '##INFO=<ID=REFREP,Number=A,Type=Integer,Description="Number of times RU is repeated in reference">',
        '##INFO=<ID=IDREP,Number=A,Type=Integer,Description="Number of times RU is repeated in indel allele">',
        '##INFO=<ID=MQ,Number=1,Type=Integer,Description="RMS of mapping quality">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">',
        '##FORMAT=<ID=GQX,Number=1,Type=Integer,Description="Empirically calibrated genotype quality score">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Filtered basecall depth used for site genotyping">',
        '##FORMAT=<ID=DPF,Number=1,Type=Integer,Description="Basecalls filtered from input prior to site genotyping">',
        '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum filtered basecall depth within a non-variant block">',
        '##FORMAT=<ID=DPI,Number=1,Type=Integer,Description="Read depth associated with indel, taken from the site preceding the indel">',
        '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Allelic depths for the ref and alt alleles in the order listed">',
        '##FORMAT=<ID=ADF,Number=.,Type=Integer,Description="Allelic depths on the forward strand">',
        '##FORMAT=<ID=ADR,Number=.,Type=Integer,Description="Allelic depths on the reverse strand">',
        '##FORMAT=<ID=FT,Number=1,Type=String,Description="Sample filter">',
        '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Normalized, Phred-scaled likelihoods for genotypes">',
        '##FORMAT=<ID=SB,Number=1,Type=Float,Description="Sample site strand bias">',
        '##FILTER=<ID=LowGQX,Description="Locus GQX is below threshold or not present">',
        '##FILTER=<ID=HighSNVSB,Description="Sample SNV strand bias value (SB) exceeds threshold">',
        '##FILTER=<ID=HighDPFRatio,Description="The fraction of basecalls filtered out at a site is greater than 0.4">',
        '##FILTER=<ID=NoPassedVariantGTs,Description="No samples at this locus pass all sample filters and have a variant genotype">',
        '##FILTER=<ID=IndelConflict,Description="Indel genotypes from two or more loci conflict in at least one sample">',
        '##FILTER=<ID=HighDepth,Description="Locus depth is greater than 3x the mean chromosome depth">',
        f'##FILTER=<ID=LowDepth,Description="Locus depth is below {opt.gvcf_min_passed_call_depth}">',
        '##FILTER=<ID=NotGenotyped,Description="Locus contains forcedGT input alleles which could not be genotyped">',
        '##FILTER=<ID=PloidyConflict,Description="Genotype call from variant caller not consistent with chromosome ploidy">',
        '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set identifier">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(sample_names),
    ]
    return "\n".join(lines) + "\n"


def _site_sample_filters(opt: GermlineOptions, gqx, sb, dp, dpf, is_variant,
                         chrom_depth: float | None = None,
                         ad_sum: int | None = None,
                         pooled_depth: int | None = None,
                         hpol: int | None = None):
    """Per-sample hard filters for one site
    (ScoringModelManager::default_classify_site +
    applyDepthFilter). HighDepth tests the POOLED all-sample
    mapq-tracker read depth (locus.getTotalReadDepth(),
    ScoringModelManager.cpp:293-299), not this sample's dp+dpf."""
    f = []
    if gqx < (opt.gvcf_min_gqx if is_variant else opt.gvcf_min_homref_gqx):
        f.append("LowGQX")
    if is_variant and sb > opt.gvcf_max_snv_strand_bias:
        f.append("HighSNVSB")
    if (is_variant and opt.gvcf_max_snv_hpol is not None
            and hpol is not None and hpol > opt.gvcf_max_snv_hpol):
        f.append("HighSNVHPOL")
    total = dp + dpf
    if total > 0 and dpf / total > 0.4:
        f.append("HighDPFRatio")
    if chrom_depth:
        pd = pooled_depth if pooled_depth is not None else total
        if pd > opt.max_depth_factor * chrom_depth:
            f.append("HighDepth")
    # LowDepth: DP or confident AD sum below minPassedCallDepth
    # (ScoringModelManager::applyDepthFilter :234-249, applied to every
    # locus by variant_prefilter_stage)
    min_dp = opt.gvcf_min_passed_call_depth
    if dp < min_dp or (ad_sum if ad_sum is not None else dp) < min_dp:
        f.append("LowDepth")
    return f


# ---------------------------------------------------------------------------
# Diploid germline block machinery (gvcf_block_site_record.{hh,cpp})
# ---------------------------------------------------------------------------
# A site's block-join state is packed into one integer key: sample
# filter bits, locus filter bits, GT code, caller ploidy, coverage
# states, and GQX definedness — testCanSiteJoinSampleBlockShared
# requires equality of all of them; gqx/dp/dpf must additionally stay
# within check_block_tolerance (gqx only while defined).

# sample-level filter bits (subset appearing on hom-ref sites), in
# GERMLINE_VARIANT_VCF_FILTERS enum order
_SF_NAMES = ("LowGQX", "HighDPFRatio", "HighDepth", "LowDepth",
             "PloidyConflict", "SiteConflict")
_SF_LOWGQX, _SF_HDPF, _SF_HDEP, _SF_LOWDEP, _SF_PLOIDY, _SF_SITECONF = (
    1, 2, 4, 8, 16, 32)
# locus-level filter bits
_LF_NAMES = ("IndelConflict", "SiteConflict")
_LF_INDELCONF, _LF_SITECONF = 1, 2

_GT_OF_CODE = ("0/0", "0", ".")
# key bit layout: scode[0:6] | lcode[6:8] | gtc[8:10] | cp[10:12]
#                 | used_cov[12] | any_cov[13] | gqx_defined[14]
_KEY_GQXDEF_BIT = 1 << 14


def _pack_key(lcode, scode, gtc, cp, used, anyc, gqxdef):
    return (int(scode) | (int(lcode) << 6) | (gtc << 8) | (cp << 10)
            | (used << 12) | (anyc << 13) | (gqxdef << 14))


import functools


@functools.lru_cache(maxsize=None)
def _key_fsets(key: int):
    """(locus filter set, sample filter set) decoded from a key."""
    scode = key & 63
    lcode = (key >> 6) & 3
    sfs = {n for b, n in enumerate(_SF_NAMES) if scode & (1 << b)}
    lfs = {n for b, n in enumerate(_LF_NAMES) if lcode & (1 << b)}
    return frozenset(lfs), frozenset(sfs)


@functools.lru_cache(maxsize=None)
def _key_fstr(key: int) -> str:
    """Extended FILTER string for a single-sample record with this key
    (getExtendedLocusFilters: locus filters + the sample's filters)."""
    lfs, sfs = _key_fsets(key & ((1 << 8) - 1))
    return _filter_str(set(lfs) | set(sfs))


class _DiploidBlock:
    """Per-sample hom-ref block accumulator. Exact semantics of
    gvcf_block_site_record::testCanSiteJoinSampleBlock /
    joinSiteToSampleBlock; the native compressor
    (native/blocks.cpp block_compress_run2) is the production path,
    this class is the fallback and semantic oracle."""
    __slots__ = ("start", "count", "key", "gq_lo", "gq_hi", "dp_lo",
                 "dp_hi", "df_lo", "df_hi", "dp_sum", "dpf_sum")

    def __init__(self):
        self.count = 0

    def can_join(self, key, gqx, dp, dpf, abs_tol, frac_tol):
        if self.count == 0:
            return True
        if key != self.key:
            return False
        if (key & _KEY_GQXDEF_BIT) and not _blockable(
                self.gq_lo, self.gq_hi, gqx, abs_tol, frac_tol):
            return False
        return (_blockable(self.dp_lo, self.dp_hi, dp, abs_tol, frac_tol)
                and _blockable(self.df_lo, self.df_hi, dpf,
                               abs_tol, frac_tol))

    def add(self, i, key, gqx, dp, dpf):
        if self.count == 0:
            self.start = i
            self.key = key
            self.gq_lo = self.gq_hi = gqx
            self.dp_lo = self.dp_hi = dp
            self.df_lo = self.df_hi = dpf
            self.dp_sum = self.dpf_sum = 0
        else:
            if gqx < self.gq_lo:
                self.gq_lo = gqx
            elif gqx > self.gq_hi:
                self.gq_hi = gqx
            if dp < self.dp_lo:
                self.dp_lo = dp
            elif dp > self.dp_hi:
                self.dp_hi = dp
            if dpf < self.df_lo:
                self.df_lo = dpf
            elif dpf > self.df_hi:
                self.df_hi = dpf
        self.count += 1
        self.dp_sum += dp
        self.dpf_sum += dpf

    def flush_row(self):
        """(start, count, key, gqx_min, dp_sum, dpf_sum, dp_min) or
        None when empty; resets the accumulator."""
        if self.count == 0:
            return None
        row = (self.start, self.count, self.key, self.gq_lo,
               self.dp_sum, self.dpf_sum, self.dp_lo)
        self.count = 0
        return row


def _block_line(chrom, begin, ref_chars, ref_list, block_label, row):
    """Serialize one block row (gvcf_writer write_site_record(block)).

    GT comes from the block's first site; GQX prints '.' while no site
    in the block had a defined GQX (isBlockGqxDefined); DP/DPF are the
    rounded means of used/unused basecall counts; MIN_DP the DP min."""
    st, cnt, key, gqx_min, dp_sum, dpf_sum, dp_min = row
    p1 = begin + st + 1
    rb = ref_chars[ref_list[st]]
    info = "." if cnt == 1 else f"END={begin + st + cnt};{block_label}"
    gt = _GT_OF_CODE[(key >> 8) & 3]
    gqx_str = str(gqx_min) if key & _KEY_GQXDEF_BIT else "."
    return (f"{chrom}\t{p1}\t.\t{rb}\t.\t.\t{_key_fstr(key)}\t{info}\t"
            f"GT:GQX:DP:DPF:MIN_DP\t{gt}:{gqx_str}:"
            f"{_round_half(dp_sum / cnt)}:{_round_half(dpf_sum / cnt)}:"
            f"{dp_min}")


@functools.lru_cache(maxsize=1)
def _fstr_table():
    """256-entry FILTER-string table indexed by key & 0xFF, passed to
    the native block-line formatter (blob bytes + int32[257] offsets)
    so the filter-name order/merge logic stays in _key_fstr."""
    parts = [_key_fstr(k).encode() for k in range(256)]
    off = np.zeros(257, np.int32)
    off[1:] = np.cumsum([len(p) for p in parts])
    return b"".join(parts), off


_FMT_BUF = None


def _fmt_buf(nbytes):
    """Persistent line-format buffer (fresh allocations page-fault
    slowly on this VM class; see CLAUDE.md)."""
    global _FMT_BUF
    if _FMT_BUF is None or len(_FMT_BUF) < nbytes:
        _FMT_BUF = np.empty(max(nbytes, 1 << 20), np.uint8)
    return _FMT_BUF


def compute_alt_ranks(counts_list, dp_list, cp_list):
    """Vectorized first phase of getSiteAltAlleles
    (starling_pos_processor.cpp:516-556): per sample, the top-ploidy
    basecall-count bases with count >= max(1, trunc(0.1 * depth)) earn
    rank 2 (top) / 1 (second, diploid callers only); ranks aggregate
    over samples. Ties resolve to the lowest base index (the C++ scans
    bases in order), which stable argsort of -counts reproduces.

    counts_list: per-sample [L, 4] used basecall counts;
    dp_list: per-sample [L] used depth; cp_list: per-sample [L]
    caller ploidy (1 or 2). Returns [L, 4] aggregated ranks.
    """
    L = counts_list[0].shape[0]
    ar = np.arange(L)
    rank_v = np.zeros((L, 4), dtype=np.int64)
    for counts, dp, cp in zip(counts_list, dp_list, cp_list):
        counts = counts.astype(np.int64)
        # unsigned truncation of (unsigned)(count * 0.1), floored at 1
        minc = np.maximum(
            1, (dp.astype(np.float64) * 0.1).astype(np.int64))
        order = np.argsort(-counts, axis=1, kind="stable")
        t1 = order[:, 0]
        rank_v[ar, t1] += np.where(counts[ar, t1] >= minc, 2, 0)
        t2 = order[:, 1]
        rank_v[ar, t2] += np.where(
            (np.asarray(cp) == 2) & (counts[ar, t2] >= minc), 1, 0)
    return rank_v


def nominate_site_alts(rank_row, ref_gt, gt_entries):
    """Ordered alt-allele list for one site from aggregated ranks plus
    every sample's max-GT alleles (getSiteAltAlleles second phase,
    starling_pos_processor.cpp:558-616): ranked bases descending
    (lowest base index on ties, ref excluded), then poly/genome max-GT
    alleles appended in sample order.

    gt_entries: per-sample (poly_max_gt digt index, genome_max_gt digt
    index, n_chromosomes from the caller ploidy).
    """
    r = list(rank_row)
    added = [False, False, False, False]
    added[ref_gt] = True
    alts = []
    while True:
        mb = 0
        for b in range(1, 4):
            if r[b] > r[mb]:
                mb = b
        if r[mb] == 0:
            break
        r[mb] = 0
        if mb == ref_gt:
            continue
        alts.append(mb)
        added[mb] = True
    for pgt, ggt, n_chrom in gt_entries:
        for gt in (pgt, ggt):
            pair = digt.ALLELES[gt]
            for c in range(n_chrom):
                b = int(pair[c])
                if not added[b]:
                    alts.append(b)
                    added[b] = True
    return alts


def vcf_indel_strings(result: RegionCallResult, call: IndelCall):
    """(vcf_pos0, ref_str, alt_strs, cigars) for an indel locus
    (AlleleReportInfoUtil.cpp getSingleIndelAlleleVcfSummaryStrings +
    multi-allele common-ref extension). Reference bases come from the
    halo'd fetch window when available: an indel anchored at the
    segment begin or a deletion running past the segment end reaches
    outside [begin, end), and slicing the segment-only array would
    wrap (pos == begin) or silently truncate REF against the CIGAR."""
    if result.ref_halo is not None:
        ref = result.ref_halo
        begin = result.begin - result.halo_off
    else:
        ref = result.ref_codes
        begin = result.begin
    left = min(k.pos for k in call.keys) - 1
    right = max(k.right_pos for k in call.keys)
    ref_str = decode_bases(ref[max(left - begin, 0):right - begin])
    alts = []
    cigars = []
    for k in call.keys:
        pre = decode_bases(ref[max(left - begin, 0):k.pos - begin])
        post = decode_bases(ref[k.right_pos - begin:right - begin])
        alts.append(pre + k.insert_seq + post)
        # D before I (setIndelAlleleCigar, gvcfAlleleInfo.cpp:77-95);
        # only swap (NotGenotyped forced) alleles carry both
        parts = [f"{len(pre)}M"]
        if k.delete_length:
            parts.append(f"{k.delete_length}D")
        if k.insert_length:
            parts.append(f"{k.insert_length}I")
        if post:
            parts.append(f"{len(post)}M")
        cigars.append("".join(parts))
    return left, ref_str, alts, cigars


def _gt_string_indel(gt_index: int, ploidy: int, n_alleles: int) -> str:
    from ..models.indel_genotype import genotype_alleles
    ga = genotype_alleles(ploidy, n_alleles)
    a0, a1 = ga[gt_index]
    if ploidy == 1:
        return str(int(a0))
    return f"{int(a0)}/{int(a1)}"


# EVSF reporting (--report-evs-features): feature-vector emission for
# offline EVS training (gvcf_writer.cpp:515-527 ";EVSF=" with
# setprecision(5)). When no scoring model is loaded, features are
# reported in these default orders (the reference's development
# features are not tracked and are omitted from the list).
DEFAULT_GERMLINE_SNV_EVSF = (
    "SiteHomopolymerLength", "SampleStrandBias",
    "SamplePrimaryAltAlleleDepth", "VariantAlleleQuality",
    "SampleMeanDistanceFromReadEdge", "SamplePrimaryAltAlleleDepthFraction",
    "SampleRMSMappingQuality", "SampleUsedDepthFraction")
DEFAULT_GERMLINE_INDEL_EVSF = (
    "GenotypeCategory", "SampleIndelRepeatCount", "SampleIndelRepeatUnitSize",
    "SampleIndelAlleleBiasLower", "SampleIndelAlleleBias",
    "SampleProxyRMSMappingQuality", "RelativeTotalLocusDepth",
    "SamplePrimaryAltAlleleDepthFraction", "ConservativeGenotypeQuality",
    "InterruptedHomopolymerLength", "ContextCompressability",
    "IndelCategory", "SampleAlleleCountStrandBias")


class _FeatureList:
    """Stand-in for a Forest when only its feature-name order is needed."""

    def __init__(self, names):
        self.features = list(names)


_EVSF_SNV_DEFAULT = _FeatureList(DEFAULT_GERMLINE_SNV_EVSF)
_EVSF_INDEL_DEFAULT = _FeatureList(DEFAULT_GERMLINE_INDEL_EVSF)


def format_evsf(values) -> str:
    """%.5g matches the reference's default-float setprecision(5)."""
    return ",".join(f"{float(v):.5g}" for v in values)


def germline_snv_features(forest, sd, i, hpol, qual, alt_id, sb,
                          gt_indices=None, ploidy=2, gqx=0,
                          rel_depth=1.0, hap_ratio=None):
    """Feature vector by name for a germline/RNA SNV scoring model
    (germlineVariantEmpiricalScoringFeatures.hh /
    rnaVariantEmpiricalScoringFeatures.hh;
    gvcf_locus_info.cpp:300-440).

    gt_indices: the called genotype's VCF allele indices (0 = ref);
    hap_ratio: accumulated altHaplotypeCountRatio at the site, or None
    when the site is outside every active region (feature -1,
    :392-399)."""
    counts = sd.used_counts[i]
    dp = int(counts.sum())
    alt_depth = int(counts[alt_id])
    vals = {
        "SiteHomopolymerLength": hpol,
        "SampleStrandBias": sb,
        "SamplePrimaryAltAlleleDepth": alt_depth,
        "VariantAlleleQuality": qual,
        "SampleMeanDistanceFromReadEdge": (
            float(sd.mean_edge_dist[i]) if sd.mean_edge_dist is not None else 0.0),
        "SamplePrimaryAltAlleleDepthFraction": alt_depth / max(dp, 1),
        "SampleRMSMappingQuality": float(
            np.sqrt(sd.pileup.mapq_sumsq[i] / max(sd.pileup.mapq_n[i], 1))),
        "SampleUsedDepthFraction": dp / max(dp + int(sd.dpf[i]), 1),
        "RelativeTotalLocusDepth": float(rel_depth),
        "ConservativeGenotypeQuality": float(gqx),
    }
    # rank-sum features computed lazily only when the model wants them
    names = set(forest.features)
    if names & {"SampleRMSMappingQualityRankSum", "SampleReadPosRankSum",
                "I_BaseQRankSum"} and getattr(sd, "scoring_metrics",
                                              None) is not None:
        mq_rs, pos_rs, bq_rs = sd.scoring_metrics.at(i)
        vals["SampleRMSMappingQualityRankSum"] = mq_rs
        vals["SampleReadPosRankSum"] = pos_rs
        vals["I_BaseQRankSum"] = bq_rs
    het_with_ref = False
    if gt_indices is not None:
        a0 = int(gt_indices[0])
        a1 = int(gt_indices[-1])
        # getEVSGenotypeCode (HET=0, HOM=1, HETALT=2; haploid -> HOM)
        if ploidy == 2 and a0 != a1:
            vals["GenotypeCategory"] = 2.0 if (a0 > 0 and a1 > 0) else 0.0
            het_with_ref = a0 == 0 or a1 == 0
        else:
            vals["GenotypeCategory"] = 1.0
    if hap_ratio is None:
        vals["NormalizedAltHaplotypeCountRatio"] = -1.0
    else:
        # ratio capped at 1 (vcf_util.hh:273-279), doubled for haploid
        # and ref-het genotypes (gvcf_locus_info.cpp:392-398)
        r = min(float(hap_ratio), 1.0)
        vals["NormalizedAltHaplotypeCountRatio"] = (
            r * 2.0 if (ploidy == 1 or het_with_ref) else r)
    return np.array([vals.get(name, 0.0) for name in forest.features])

def _indel_filters(opt, result, call, n_samples, chrom_depth=None,
                   indel_forest=None, pooled_indel_depth=0):
    """Locus + per-sample filter sets and output GQX for one indel
    locus (variant_prefilter_stage::process(indel) semantics:
    applyDepthFilter -> classify_indel).

    classify_indel (ScoringModelManager.cpp:172-238): EVS-scored
    variant samples get the EVS LowGQX threshold only; non-variant
    samples (and every sample when no EVS model is loaded) fall back
    to default_classify_indel — LowGQX on min_gqx, HighDepth on the
    POOLED all-sample read depth at the position preceding the locus
    (getTotalReadDepth -> indel mapqTracker, ScoringModelManager.cpp
    :365-371), and HighREFREP when configured. LowDepth applies to
    all samples (applyDepthFilter :252-265: AD sum or DPI below
    minPassedCallDepth).

    Returns dict(locus_fset, sample_fsets, gqx_out, is_var_gt).
    """
    A = len(call.keys) + 1
    if getattr(call, "not_genotyped", False):
        # NotGenotyped loci take ONLY that filter — no depth filters,
        # no classification (variant_prefilter_stage.cpp:83-91)
        return {"locus_fset": set(),
                "sample_fsets": [{"NotGenotyped"}] * n_samples,
                "gqx_out": [0] * n_samples,
                "is_var_gt": [False] * n_samples}
    locus_fset = {"IndelConflict"} if call.is_conflict else set()
    sample_fsets = []
    gqx_out = []
    is_var = []
    for s in range(n_samples):
        ploidy = (call.sample_ploidy[s] if call.sample_ploidy is not None
                  else 2)
        if ploidy == 0:
            gt = "."
        else:
            gt = _gt_string_indel(call.sample_gt[s], max(ploidy, 1), A)
        is_var_gt = any(a not in (".", "0") for a in
                        gt.replace("|", "/").split("/"))
        is_var.append(is_var_gt)
        gqx = call.sample_gqx[s]
        filters = []
        if indel_forest is not None and is_var_gt:
            # EVS replaces GQX and drives the LowGQX filter
            feats = germline_indel_features(indel_forest, result, call, s,
                                            chrom_depth)
            evs = float(indel_forest.score_phred(feats[None])[0])
            gqx = int(round(evs))
            if evs < indel_forest.filter_cutoff:
                filters.append("LowGQX")
        else:
            # default_classify_indel
            if call.sample_gqx[s] < opt.gvcf_min_gqx:
                filters.append("LowGQX")
            if chrom_depth and pooled_indel_depth > \
                    opt.max_depth_factor * chrom_depth:
                filters.append("HighDepth")
            if opt.gvcf_max_ref_rep is not None:
                for rec in call.records:
                    ru = rec.repeat_unit or ""
                    if ru and len(ru) <= 2 and \
                            rec.ref_repeat_count > opt.gvcf_max_ref_rep:
                        filters.append("HighRefRep")
                        break
        # applyDepthFilter: DPI or AD sum below minPassedCallDepth
        if call.sample_dpi[s] < opt.gvcf_min_passed_call_depth or \
                sum(call.sample_ad[s]) < opt.gvcf_min_passed_call_depth:
            filters.append("LowDepth")
        sample_fsets.append(set(filters))
        gqx_out.append(gqx)
    return {"locus_fset": locus_fset, "sample_fsets": sample_fsets,
            "gqx_out": gqx_out, "is_var_gt": is_var}


def _build_region_phase_plan(result, pre, pgt_a, cp_a, ALL_L, ref_list,
                             site_alt_order, any_variant_v,
                             locus_exists_v, indels_at, begin, L,
                             n_samples):
    """Assemble the region's locus stream in emission order and run the
    VariantPhaser port over it (pipeline/phaser.py).

    Stream contents: every genotyped variant locus inside an active
    region (sites keyed ("site", i), indels keyed ("indel", id(call))),
    plus buffer-flush markers for gaps between active regions that
    contain at least one emitted locus (any covered position emits a
    site locus with ar_id -1, which flushes the reference phaser's
    buffer, VariantPhaser.cpp:36-48; a zero-coverage gap emits nothing
    and leaves the buffer open across adjacent regions)."""
    from ..models.indel_genotype import genotype_alleles
    from .phaser import PhaseLocus, SampleGt, build_phase_plan

    psmap = result.phase_set_of_pos
    events: list[tuple[int, int, PhaseLocus]] = []

    for p, calls in indels_at.items():
        ar = psmap.get(p, -1)
        if ar < 0:
            continue
        for call in calls:
            if getattr(call, "not_genotyped", False):
                continue
            A = len(call.keys) + 1
            samples = []
            anyv = False
            for s in range(n_samples):
                ploidy = (call.sample_ploidy[s]
                          if call.sample_ploidy is not None else 2)
                if ploidy == 0:
                    samples.append(None)
                    continue
                cp = max(int(ploidy), 1)
                ga = genotype_alleles(cp, A)
                a0, a1 = (int(x) for x in ga[call.sample_gt[s]])
                if a0 == 0 and a1 == 0:
                    samples.append(None)
                    continue

                def ihap(ai):
                    if ai == 0:
                        return 0
                    return result.indel_hap_ids.get(
                        (s, call.keys[ai - 1]), 0)
                samples.append(SampleGt(cp, a0, a1, ihap(a0), ihap(a1),
                                        True))
                anyv = True
            if anyv:
                # indel loci are emitted before the site at the same
                # stream position; PS source = printed VCF POS = pos
                events.append((p, 0, PhaseLocus(
                    ("indel", id(call)), p, ar, samples)))

    for i in np.nonzero(any_variant_v)[0].tolist():
        p = begin + i
        ar = psmap.get(p, -1)
        if ar < 0:
            continue
        alts = site_alt_order(i)
        amap = {ref_list[i]: 0}
        for j, a in enumerate(alts):
            amap[a] = j + 1
        samples = []
        anyv = False
        for s in range(n_samples):
            pr = pre[s]
            if not pr["variant"][i] or pr["unknown"][i]:
                samples.append(None)
                continue
            cp = 1 if int(cp_a[s][i]) == 1 else 2
            pair = ALL_L[int(pgt_a[s][i])]
            if cp == 1:
                a0 = a1 = amap[pair[0]]
            else:
                a0, a1 = sorted(amap[a] for a in pair)

            def shap(ai):
                if ai == 0:
                    return 0
                return result.snv_hap_ids.get((s, p, alts[ai - 1]), 0)
            samples.append(SampleGt(cp, a0, a1, shap(a0), shap(a1),
                                    True))
            anyv = True
        if anyv:
            events.append((p, 1, PhaseLocus(("site", i), p + 1, ar,
                                            samples)))

    # flush markers between active regions with an emitted locus in
    # the gap (coverage at any gap position)
    ar_positions = sorted(psmap)
    intervals: list[tuple[int, int]] = []
    for p in ar_positions:
        if intervals and p == intervals[-1][1] \
                and psmap[p] == psmap[intervals[-1][0]]:
            intervals[-1] = (intervals[-1][0], p + 1)
        else:
            intervals.append((p, p + 1))
    none_samples = [None] * n_samples
    for (a_beg, a_end), (b_beg, _) in zip(intervals, intervals[1:]):
        lo = max(a_end - begin, 0)
        hi = min(b_beg - begin, L)
        if lo < hi and bool(locus_exists_v[lo:hi].any()):
            events.append((a_end, 2, PhaseLocus(
                ("flush", a_end), 0, -1, none_samples)))

    events.sort(key=lambda e: (e[0], e[1]))
    return build_phase_plan([e[2] for e in events], n_samples)


@spans.span("emit")
def emit_region(
    opt: GermlineOptions,
    result: RegionCallResult,
    sample_names: list[str],
    chrom_depth: float | None = None,
    snv_forest=None,
    indel_forest=None,
    nocompress_mask=None,
):
    """Returns (per-sample gvcf line lists, variants vcf line list).

    Record routing follows gvcf_writer::queue_site_record: a site that
    fails the locus-level blockability test (variant locus, confident
    nonref fraction >= block_max_nonref in any sample, nocompress-bed
    position — gvcf_compressor::is_site_compressible) flushes every
    sample's block and is written as a FULL site record to the
    variants VCF and every per-sample gVCF (write_site_record_instance)
    — including hom-ref sites, which print real ploidy/coverage GT,
    SNVHPOL/MQ INFO and ':.' GQ/GQX when undefined. All other sites
    join per-sample hom-ref blocks.
    """
    n_samples = len(result.samples)
    L = result.end - result.begin
    begin = result.begin
    chrom = result.chrom
    gvcf_lines: list[list[str]] = [[] for _ in range(n_samples)]
    var_lines: list[str] = []

    ref = result.ref_codes
    hpol_ref = result.ref_halo if result.ref_halo is not None else ref
    hpol_off = result.halo_off if result.ref_halo is not None else 0
    ref_list = ref.tolist()
    ref_chars = "ACGTN"
    ref_ok = ref < 4
    refc = np.minimum(ref, 3).astype(np.int64)
    ar = np.arange(L)

    # ---- vectorized per-position, per-sample precompute ----
    ALL = np.asarray(digt.ALLELES, dtype=np.int64)  # [10, 2]
    sv = []
    pre = []
    any_variant_v = np.zeros(L, dtype=bool)
    pooled_depth_v = np.zeros(L, dtype=np.int64)
    ln_ref_sum_v = np.zeros(L, dtype=np.float64)
    for s in range(n_samples):
        sd = result.samples[s]
        r = sd.snv
        d = {
            "ggt": np.asarray(r.genome_max_gt).astype(np.int64),
            "pgt": np.asarray(r.poly_max_gt).astype(np.int64),
            "gq": np.asarray(r.poly_max_gt_qphred).astype(np.int64),
            "gqg": np.asarray(r.genome_max_gt_qphred).astype(np.int64),
            "pl": np.asarray(r.phred_loghood),
            "sb": np.asarray(r.strand_bias),
        }
        sv.append(d)
        dp_v = sd.used_counts.sum(axis=1).astype(np.int64)
        dpf_v = sd.dpf.astype(np.int64)
        raw_v = dp_v + dpf_v
        cp_v = (sd.caller_ploidy.astype(np.int64)
                if sd.caller_ploidy is not None else np.full(L, 2, np.int64))
        if sd.group_ploidy is not None:
            gp_v = sd.group_ploidy.astype(np.int64)
        elif result.ploidy is not None:
            gp_v = result.ploidy[s].astype(np.int64)
        else:
            gp_v = np.full(L, 2, np.int64)
        homalt_v = (sd.homalt_del if sd.homalt_del is not None
                    else np.zeros(L, bool))
        conflict_v = (sd.ploidy_conflict if sd.ploidy_conflict is not None
                      else np.zeros(L, bool))
        # GT/GQ/GQX are unknown for uncovered samples and for sites
        # inside hom-alt genotyped deletions
        # (updateSnvLocusWithSampleInfo:375-383)
        unknown_v = (dp_v == 0) | homalt_v
        gqxdef_v = ~unknown_v  # is_gqx (gvcf_locus_info.hh:991-999)
        gq_v = np.where(unknown_v, 0, d["gq"])
        gqx0_v = np.where(unknown_v | (d["ggt"] != d["pgt"]), 0,
                          np.minimum(d["gqg"], d["gq"]))
        variant_v = ~unknown_v & ref_ok & (d["pgt"] != refc)
        any_variant_v |= variant_v
        pooled_depth_v += sd.pileup.mapq_n.astype(np.int64)
        if r.ln_ref_pprob is not None:
            ln_ref_sum_v += np.asarray(r.ln_ref_pprob, dtype=np.float64)
        pre.append({
            "dp": dp_v, "dpf": dpf_v, "raw": raw_v, "cp": cp_v,
            "gp": gp_v, "homalt": homalt_v, "conflict": conflict_v,
            "unknown": unknown_v, "gqxdef": gqxdef_v, "gq": gq_v,
            "gqx0": gqx0_v, "variant": variant_v,
        })
    locus_exists_v = np.zeros(L, dtype=bool)
    for s in range(n_samples):
        locus_exists_v |= pre[s]["raw"] > 0

    # QUAL: sum over samples of ln P(hom-ref genotype | genome prior)
    # -> phred (starling_pos_processor.cpp:688-691)
    qual_v = np.floor(-10.0 * ln_ref_sum_v / np.log(10.0) + 0.5
                      ).astype(np.int64)

    # ---- site alt-allele nomination (getSiteAltAlleles,
    # starling_pos_processor.cpp:508-616): per sample the top-ploidy
    # basecall-count bases above max(1, 10% depth) earn rank 2/1;
    # aggregated rank nominates alt alleles; max-GT alleles of every
    # sample are appended ----
    rank_v = compute_alt_ranks(
        [result.samples[s].used_counts for s in range(n_samples)],
        [pre[s]["dp"] for s in range(n_samples)],
        [pre[s]["cp"] for s in range(n_samples)])
    amask = rank_v > 0
    for s in range(n_samples):
        cp2 = pre[s]["cp"] == 2
        for gt_v in (sv[s]["pgt"], sv[s]["ggt"]):
            amask[ar, ALL[gt_v, 0]] = True
            sel = np.nonzero(cp2)[0]
            amask[sel, ALL[gt_v[sel], 1]] = True
    amask[ar, refc] = False
    amask[~ref_ok] = False

    # confident support counts (supportCounts over ref + nominated
    # alts) per sample: LowDepth AD-sum test + compressibility fraction
    csum_m = np.zeros((n_samples, L), dtype=np.int64)
    cref_m = np.zeros((n_samples, L), dtype=np.int64)
    sup_mask = amask.copy()
    sup_mask[ar, refc] |= ref_ok
    for s in range(n_samples):
        counts = result.samples[s].used_counts.astype(np.int64)
        csum_m[s] = (counts * sup_mask).sum(axis=1)
        cref_m[s] = np.where(ref_ok, counts[ar, refc], 0)

    # locus-level blockability (gvcf_compressor::is_site_compressible):
    # any sample whose confident nonref fraction crosses
    # block_max_nonref makes the whole site a full record
    nonblock_v = np.zeros(L, dtype=bool)
    for s in range(n_samples):
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = cref_m[s] / np.maximum(csum_m[s], 1)
        nonblock_v |= (ref_ok & (csum_m[s] > 0)
                       & (frac + opt.gvcf_block_max_nonref <= 1.0))
    nocomp_v = (np.asarray(nocompress_mask, bool)
                if nocompress_mask is not None else np.zeros(L, bool))
    stop_site_v = any_variant_v | nonblock_v | nocomp_v

    # ---- written-variant-indel site modification
    # (VariantOverlapResolver::modifySiteOverlappingVariantIndel via
    # gvcf_writer::modifySiteForConsistencyWithUpstreamIndels): sites
    # within the range of the most recently written variant indel get
    # qual/gqx caps + SiteConflict from indel filters, or IndelConflict
    # when the indel locus is in conflict ----
    indels_at: dict[int, list] = {}
    for call in result.indels:
        indels_at.setdefault(call.pos, []).append(call)

    # indel filter sets are needed both for the site modification and
    # for indel record emission; compute once
    indel_meta: dict[int, dict] = {}
    for call in result.indels:
        dpi_idx = call.pos - 1 - begin
        pooled_ind = 0
        if 0 <= dpi_idx < L:
            pooled_ind = int(pooled_depth_v[dpi_idx])
        indel_meta[id(call)] = _indel_filters(
            opt, result, call, n_samples, chrom_depth=chrom_depth,
            indel_forest=indel_forest, pooled_indel_depth=pooled_ind)

    site_qual_cap = np.full(L, np.iinfo(np.int64).max, dtype=np.int64)
    gqx_cap = [np.full(L, np.iinfo(np.int32).max, dtype=np.int64)
               for _ in range(n_samples)]
    lbits_v = np.zeros(L, dtype=np.int8)
    sbits_m = [np.zeros(L, dtype=np.int8) for _ in range(n_samples)]
    variant_calls = sorted(
        (c for c in result.indels
         if any(g > 0 for g in c.sample_gt)), key=lambda c: c.pos)
    for idx, call in enumerate(variant_calls):
        end_pos = max(k.right_pos for k in call.keys)
        # the modifier is replaced as soon as the NEXT variant indel is
        # written (_lastVariantIndelWritten), so each call governs
        # [its pos, min(its end, next call pos))
        w_end = end_pos
        if idx + 1 < len(variant_calls):
            w_end = min(w_end, variant_calls[idx + 1].pos)
        w0 = max(call.pos - begin, 0)
        w1 = min(w_end - begin, L)
        if w1 <= w0:
            continue
        meta = indel_meta[id(call)]
        if call.is_conflict:
            lbits_v[w0:w1] |= _LF_INDELCONF
            continue
        site_qual_cap[w0:w1] = np.minimum(site_qual_cap[w0:w1], call.qual)
        for s in range(n_samples):
            # gqx cap uses the indel's RAW sample gqx (sampleInfo.gqx),
            # not the EVS-replaced output value
            gqx_cap[s][w0:w1] = np.minimum(gqx_cap[s][w0:w1],
                                           call.sample_gqx[s])
            if meta["sample_fsets"][s]:
                sbits_m[s][w0:w1] |= _SF_SITECONF

    # ---- per-sample filter codes + block keys ----
    maxdep = (opt.max_depth_factor * chrom_depth) if chrom_depth else None
    hdep_v = (locus_exists_v & (pooled_depth_v > maxdep)
              if maxdep is not None else np.zeros(L, bool))
    min_dp = opt.gvcf_min_passed_call_depth
    # python-fallback block lists are only materialized when the
    # native compressor is unavailable (whole-region tolist costs
    # ~0.1s/Mb)
    from ..io import native as natio
    _py_blocks = (FORCE_PYTHON_BLOCKS or natio.get_lib() is None
                  or not hasattr(natio.get_lib(), "block_compress_run2"))
    key_l, gqx_l, dp_l, dpf_l = [], [], [], []
    key_arrs, gqx_arrs, dp_arrs, dpf_arrs = [], [], [], []
    for s in range(n_samples):
        p = pre[s]
        gqx_v = np.minimum(p["gqx0"], gqx_cap[s])
        p["gqx"] = gqx_v
        low_v = gqx_v < opt.gvcf_min_homref_gqx
        hdpf_v = (p["raw"] > 0) & (p["dpf"] > 0.4 * p["raw"])
        lowdep_v = locus_exists_v & ((p["dp"] < min_dp)
                                     | (csum_m[s] < min_dp))
        pconf_v = p["conflict"] & locus_exists_v
        fcode_v = (low_v * _SF_LOWGQX + hdpf_v * _SF_HDPF
                   + hdep_v * _SF_HDEP + lowdep_v * _SF_LOWDEP
                   + pconf_v * _SF_PLOIDY).astype(np.int64) | sbits_m[s]
        p["fcode"] = fcode_v
        gtc_v = np.where(p["unknown"], 2, np.where(p["cp"] == 1, 1, 0))
        key_v = (fcode_v | (lbits_v.astype(np.int64) << 6) | (gtc_v << 8)
                 | (p["cp"] << 10) | ((p["dp"] > 0) << 12)
                 | ((p["raw"] > 0) << 13) | (p["gqxdef"] << 14))
        key_arrs.append(key_v)
        gqx_arrs.append(gqx_v.astype(np.int32))
        dp_arrs.append(p["dp"].astype(np.int32))
        dpf_arrs.append(p["dpf"].astype(np.int32))
        if _py_blocks:
            key_l.append(key_v.tolist())
            gqx_l.append(gqx_v.tolist())
            dp_l.append(p["dp"].tolist())
            dpf_l.append(p["dpf"].tolist())

    abs_tol = opt.block_abs_tol
    frac_tol = opt.block_frac_tol
    block_label = opt.block_label

    from ..io import native as natio
    use_native = (not FORCE_PYTHON_BLOCKS and L > 0
                  and hasattr(natio.get_lib() or object(),
                              "block_compress_run2"))
    if use_native:
        nb_out = np.empty((L, 7), np.int64)
        fmt_native = hasattr(natio.get_lib(), "block_format_lines")
        if fmt_native:
            fblob, foff = _fstr_table()
            chrom_b = chrom.encode()
            label_b = block_label.encode()
            ref_u8 = np.ascontiguousarray(ref, dtype=np.uint8)
            line_cap = 128 + len(chrom_b) + len(label_b)
    pyblocks = [_DiploidBlock() for _ in range(n_samples)]

    def compress_run(i, j):
        """Emit hom-ref block records covering [i, j) for all samples
        (the run ends at a full-flush event, so blocks never straddle
        runs)."""
        for s in range(n_samples):
            gl = gvcf_lines[s]
            if use_native:
                n_rows = natio.block_compress_run2(
                    key_arrs[s], gqx_arrs[s], dp_arrs[s], dpf_arrs[s],
                    i, j, abs_tol, frac_tol, nb_out)
                if fmt_native and n_rows:
                    buf = _fmt_buf(n_rows * line_cap)
                    m = natio.block_format_lines_native(
                        nb_out, n_rows, begin, ref_u8, chrom_b, label_b,
                        fblob, foff, buf)
                    if m is not None and m >= 0:
                        gl.extend(
                            buf[:m].tobytes().decode("ascii").splitlines())
                        continue
                for row in nb_out[:n_rows].tolist():
                    gl.append(_block_line(chrom, begin, ref_chars,
                                          ref_list, block_label, row))
            else:
                b = pyblocks[s]
                ks, gs, ds, fs = key_l[s], gqx_l[s], dp_l[s], dpf_l[s]
                for t in range(i, j):
                    if not b.can_join(ks[t], gs[t], ds[t], fs[t],
                                      abs_tol, frac_tol):
                        gl.append(_block_line(chrom, begin, ref_chars,
                                              ref_list, block_label,
                                              b.flush_row()))
                    b.add(t, ks[t], gs[t], ds[t], fs[t])
                row = b.flush_row()
                if row is not None:
                    gl.append(_block_line(chrom, begin, ref_chars,
                                          ref_list, block_label, row))

    # ---- scalar helpers for full site records ----
    # indexed lazily: only ~variant-density many sites print full
    # records, so whole-region tolist conversions were pure overhead
    pgt_a = [sv[s]["pgt"] for s in range(n_samples)]
    ggt_a = [sv[s]["ggt"] for s in range(n_samples)]
    cp_a = [pre[s]["cp"] for s in range(n_samples)]

    ALL_L = ALL.tolist()  # tiny [10, 2] genotype-allele table

    def site_alt_order(i):
        if not ref_ok[i]:
            return []
        gt_entries = [(int(pgt_a[s][i]), int(ggt_a[s][i]),
                       2 if int(cp_a[s][i]) == 2 else 1)
                      for s in range(n_samples)]
        return nominate_site_alts(rank_v[i], ref_list[i], gt_entries)

    qual_cap_l = site_qual_cap
    qual_l = qual_v
    mapq_n_list = [result.samples[s].pileup.mapq_n for s in range(n_samples)]
    mapq_ss_list = [result.samples[s].pileup.mapq_sumsq
                    for s in range(n_samples)]

    # ---- read-backed phasing plan (VariantPhaser port; see
    # pipeline/phaser.py and _build_region_phase_plan above) ----
    phase_plan = {}
    if opt.enable_read_backed_phasing and result.phase_set_of_pos:
        phase_plan = _build_region_phase_plan(
            result, pre, pgt_a, cp_a, ALL_L, ref_list, site_alt_order,
            any_variant_v, locus_exists_v, indels_at, begin, L,
            n_samples)

    def emit_site_record(i):
        """Full site record (write_site_record_instance, diploid
        branch) written to the variants VCF and every sample gVCF."""
        pos = begin + i
        ref_gt = ref_list[i]
        ref_base = ref_chars[ref_gt]
        alts = site_alt_order(i)
        isalt = bool(alts)
        variant_locus = bool(any_variant_v[i])

        allele_map = {ref_gt: 0}
        for j, a in enumerate(alts):
            allele_map[a] = j + 1
        alt_str = ",".join(ref_chars[a] for a in alts) if isalt else "."

        # QUAL printed only for variant loci (isQual)
        qual = int(min(qual_l[i], qual_cap_l[i])) if variant_locus else "."

        hpol = snv_hpol(hpol_ref, i + hpol_off)
        mq_n = sum(int(m[i]) for m in mapq_n_list)
        mq_ss = sum(float(m[i]) for m in mapq_ss_list)
        mq = _round_half(float(np.sqrt(mq_ss / mq_n))) if mq_n > 0 else 0
        info = f"SNVHPOL={hpol};MQ={mq}"

        fmt = "GT:GQ:GQX:DP:DPF"
        if isalt:
            fmt += ":AD:ADF:ADR:SB"
        fmt += ":FT"
        if isalt:
            fmt += ":PL"

        locus_fset = set(_key_fsets(int(lbits_v[i]) << 6)[0])
        sample_cols = []
        sample_fsets = []
        any_pass_variant = False
        phases = []
        evsf = ""
        for s in range(n_samples):
            p = pre[s]
            dp = int(p["dp"][i])
            dpf = int(p["dpf"][i])
            unknown = bool(p["unknown"][i])
            cp = int(cp_a[s][i])
            is_var = bool(p["variant"][i])
            gq = int(p["gq"][i])
            gqx = int(p["gqx"][i])
            # raw strand bias is bounded to +-maxAbsSampleVariantStrandBias
            # (=99) before any use — output column, EVS features, and
            # the HighSNVSB filter all see the clamped value
            # (updateSiteSampleInfo, starling_pos_processor.cpp:231-233;
            # starling_shared.hh:94)
            sb = float(min(99.0, max(-99.0, sv[s]["sb"][i])))
            pgt = int(pgt_a[s][i])

            # GT
            phase = None
            if unknown:
                gt = "."
                gt_idx = None
            else:
                pair = ALL_L[pgt]
                if cp == 1:
                    gt_idx = [allele_map[pair[0]]]
                    gt = str(gt_idx[0])
                else:
                    gt_idx = sorted(allele_map[a] for a in pair)
                    gt = f"{gt_idx[0]}/{gt_idx[1]}"
                    dec = phase_plan.get((("site", i), s))
                    if dec is not None:
                        a, b = ((gt_idx[1], gt_idx[0]) if dec.flip
                                else (gt_idx[0], gt_idx[1]))
                        gt = f"{a}|{b}" if dec.phased else f"{a}/{b}"
                        phase = (gt, dec.ps)
            phases.append(phase)

            # EVS feature context shared by EVSF reporting and scoring
            pos_abs = begin + i
            site_rel_depth = (float(pooled_depth_v[i]) / chrom_depth
                              if chrom_depth else 1.0)
            hap_ratio = (result.snv_hap_ratio.get((s, pos_abs), 0.0)
                         if pos_abs in result.phase_set_of_pos else None)

            if s == 0 and is_var and isalt and opt.is_report_evs_features:
                f0 = germline_snv_features(
                    snv_forest or _EVSF_SNV_DEFAULT, result.samples[0], i,
                    hpol, int(qual_l[i]), alts[0], sb,
                    gt_indices=gt_idx, ploidy=cp, gqx=gqx,
                    rel_depth=site_rel_depth, hap_ratio=hap_ratio)
                evsf = ";EVSF=" + format_evsf(f0)

            # per-sample filters
            if is_var:
                if snv_forest is not None:
                    # EVS path: EVS replaces GQX; only the EVS LowGQX
                    # threshold applies from classify_site, plus the
                    # prefilter LowDepth (ScoringModelManager.cpp
                    # :124-160 — no HighDepth for EVS-scored samples)
                    feats = germline_snv_features(
                        snv_forest, result.samples[s], i, hpol,
                        int(qual_l[i]), alts[0] if alts else 0, sb,
                        gt_indices=gt_idx, ploidy=cp, gqx=gqx,
                        rel_depth=site_rel_depth, hap_ratio=hap_ratio)
                    evs = float(snv_forest.score_phred(feats[None])[0])
                    gqx = int(round(evs))
                    filters = set()
                    if evs < snv_forest.filter_cutoff:
                        filters.add("LowGQX")
                    if int(p["fcode"][i]) & _SF_LOWDEP:
                        filters.add("LowDepth")
                else:
                    filters = set(_site_sample_filters(
                        opt, gqx, sb, dp, dpf, True, chrom_depth,
                        ad_sum=int(csum_m[s][i]),
                        pooled_depth=int(pooled_depth_v[i]), hpol=hpol))
                # shared bits (PloidyConflict / SiteConflict) apply to
                # variant samples too
                fc = int(p["fcode"][i])
                if fc & _SF_PLOIDY:
                    filters.add("PloidyConflict")
                if fc & _SF_SITECONF:
                    filters.add("SiteConflict")
            else:
                filters = set(_key_fsets(int(p["fcode"][i]))[1])
            sample_fsets.append(filters)
            if is_var and not filters:
                any_pass_variant = True

            col = [gt]
            if unknown or bool(p["homalt"][i]) or dp == 0:
                col.append(".:.")
            else:
                col.append(f"{gq}:{gqx}")
            col.append(f"{dp}:{dpf}")
            if isalt:
                counts = result.samples[s].used_counts[i]
                fcounts = result.samples[s].used_fwd_counts[i]
                ads = [int(counts[ref_gt])] + [int(counts[a]) for a in alts]
                adfs = [int(fcounts[ref_gt])] + [int(fcounts[a])
                                                 for a in alts]
                adrs = [ads[j] - adfs[j] for j in range(len(ads))]
                col.append(",".join(map(str, ads)))
                col.append(",".join(map(str, adfs)))
                col.append(",".join(map(str, adrs)))
                col.append(f"{sb:.1f}")
            col.append(_filter_str(filters))
            if isalt:
                if unknown:
                    col.append(".")
                else:
                    pl_full = sv[s]["pl"][i]
                    order = [ref_gt] + list(alts)
                    pls = []
                    if cp == 1:
                        for b in order:
                            pls.append(int(pl_full[b]))
                    else:
                        for bj in range(len(order)):
                            for aj in range(bj + 1):
                                pls.append(int(pl_full[
                                    digt.het_gt_of(order[aj], order[bj])]))
                    col.append(",".join(str(min(v, 999)) for v in pls))
            sample_cols.append(":".join(col))

        if any(ph is not None for ph in phases):
            fmt += ":PS"
            sample_cols = [
                c + (f":{phases[s][1]}" if phases[s] is not None else ":.")
                for s, c in enumerate(sample_cols)]

        # FILTER merging (getExtendedLocusFilters)
        inter = (set.intersection(*sample_fsets) if sample_fsets else set())
        var_fset = locus_fset | inter
        if not any_pass_variant:
            var_fset.add("NoPassedVariantGTs")
        pre_cols = f"{chrom}\t{pos + 1}\t.\t{ref_base}\t{alt_str}\t{qual}"
        post_cols = f"{info}{evsf}\t{fmt}"
        var_lines.append(f"{pre_cols}\t{_filter_str(var_fset)}\t{post_cols}\t"
                         + "\t".join(sample_cols))
        for s in range(n_samples):
            gvcf_lines[s].append(
                f"{pre_cols}\t{_filter_str(locus_fset | sample_fsets[s])}\t"
                f"{post_cols}\t{sample_cols[s]}")

    # ---- main sweep: hom-ref runs between events; events are full
    # site records (variant / non-blockable / nocompress) and indel
    # emissions (which flush all blocks) ----
    stop_idx = np.nonzero(stop_site_v)[0]
    flush_idx = sorted(p - begin for p in indels_at if 0 <= p - begin < L)

    # defensive: indels anchored before the segment begin shouldn't
    # exist (anchor-based segment assignment) but emitting beats losing
    for p in sorted(p for p in indels_at if p < begin):
        for call in indels_at[p]:
            _emit_indel(opt, result, call, sample_names, gvcf_lines,
                        var_lines, indel_meta[id(call)],
                        indel_forest=indel_forest,
                        chrom_depth=chrom_depth, phase_plan=phase_plan)

    fi = 0
    i = 0
    while i < L:
        k = int(np.searchsorted(stop_idx, i))
        ns = int(stop_idx[k]) if k < len(stop_idx) else L
        while fi < len(flush_idx) and flush_idx[fi] < i:
            fi += 1
        nf = flush_idx[fi] if fi < len(flush_idx) else L
        j = min(ns, nf)
        if j > i:
            compress_run(i, j)
        if j >= L:
            break
        if nf == j:
            # indel locus at stream position j: emitted after site j-1,
            # before site j (starling_pos_processor.hh:70-74)
            for call in indels_at[begin + j]:
                _emit_indel(opt, result, call, sample_names, gvcf_lines,
                            var_lines, indel_meta[id(call)],
                            indel_forest=indel_forest,
                            chrom_depth=chrom_depth,
                            phase_plan=phase_plan)
            fi += 1
        if ns == j:
            emit_site_record(j)
            i = j + 1
        else:
            i = j

    # indels whose locus position is the segment end (anchor = last
    # report position) are emitted after every site
    for p in sorted(p for p in indels_at if p - begin >= L):
        for call in indels_at[p]:
            _emit_indel(opt, result, call, sample_names, gvcf_lines,
                        var_lines, indel_meta[id(call)],
                        indel_forest=indel_forest,
                        chrom_depth=chrom_depth, phase_plan=phase_plan)

    return gvcf_lines, var_lines

def germline_indel_features(forest, result, call: IndelCall, s: int,
                            chrom_depth: float | None):
    """Feature vector by name for a germline indel scoring model
    (gvcf_locus_info.cpp computeEmpiricalScoringFeatures :586-632,
    getAlleleBiasFeatures :219-247)."""
    from math import log

    from scipy import stats as spstats

    from ..models.indel_genotype import genotype_alleles
    from ..utils.refcontext import (context_compressability,
                                    indel_interrupted_hpol)

    A = len(call.keys) + 1
    ploidy = call.sample_ploidy[s] if call.sample_ploidy is not None else 2
    ga = genotype_alleles(max(ploidy, 1), A)
    a0, a1 = (int(x) for x in ga[call.sample_gt[s]])
    primary_alt = a0 if a0 > 0 else (a1 if a1 > 0 else 1)
    rec = call.records[primary_alt - 1]
    key = call.keys[primary_alt - 1]

    ad = np.asarray(call.sample_ad[s], dtype=np.float64)
    adf = np.asarray(call.sample_adf[s], dtype=np.float64)
    adr = ad - adf
    conf_depth = float(ad.sum())

    # genotype category (getEVSGenotypeCode: HET=0, HOM=1, HETALT=2)
    if ploidy == 2 and a0 != a1:
        gt_cat = 2.0 if (a0 > 0 and a1 > 0) else 0.0
    else:
        gt_cat = 1.0

    fudge = 1e-30
    bias_lower = 0.0
    bias = 0.0
    if ploidy == 2 and a0 != a1:
        r0, r1 = float(ad[a0]), float(ad[a1])
        lo = float(spstats.binom.cdf(r0, r0 + r1, 0.5))
        hi = float(spstats.binom.cdf(r1, r0 + r1, 0.5))
        bias_lower = -log(lo + fudge)
        bias = -log(min(1.0, 2.0 * min(lo, hi)) + fudge)
    else:
        bias_lower = -log(fudge)
        bias = -log(fudge)

    # locus mapq RMS from the pileup at the record position
    sd = result.samples[s]
    i = call.pos - 1 - result.begin
    mq_n = int(sd.pileup.mapq_n[i]) if 0 <= i < len(sd.pileup.mapq_n) else 0
    mq_rms = (float(np.sqrt(sd.pileup.mapq_sumsq[i] / mq_n))
              if mq_n > 0 else 0.0)

    rel_depth = 1.0
    if chrom_depth and chrom_depth > 0:
        total_depth = sum(
            int(r.pileup.mapq_n[i]) if 0 <= i < len(r.pileup.mapq_n) else 0
            for r in result.samples)
        rel_depth = total_depth / chrom_depth

    alt_fwd = float(adf[primary_alt])
    alt_rev = float(adr[primary_alt])
    from ..models.continuous import strand_bias
    sb_raw = float(strand_bias(alt_fwd, alt_rev,
                               float(adf.sum()) - alt_fwd,
                               float(adr.sum()) - alt_rev))
    sb = float(np.clip(sb_raw, -99.0, 99.0))

    rc = (result.ref_halo if result.ref_halo is not None
          else result.ref_codes)
    off = result.halo_off if result.ref_halo is not None else 0
    b0 = call.pos - result.begin + off
    b1 = b0 + key.delete_length
    vals = {
        "GenotypeCategory": gt_cat,
        "SampleIndelRepeatCount": float(rec.indel_repeat_count),
        "SampleIndelRepeatUnitSize": float(len(rec.repeat_unit or "")),
        "SampleIndelAlleleBiasLower": bias_lower,
        "SampleIndelAlleleBias": bias,
        "SampleProxyRMSMappingQuality": mq_rms,
        "RelativeTotalLocusDepth": rel_depth,
        "SamplePrimaryAltAlleleDepthFraction":
            float(ad[primary_alt]) / max(conf_depth, 1.0),
        "ConservativeGenotypeQuality": float(call.sample_gqx[s]),
        "InterruptedHomopolymerLength":
            float(indel_interrupted_hpol(rc, b0, b1)),
        "ContextCompressability":
            float(context_compressability(rc, b0, b1, 5)),
        "IndelCategory":
            1.0 if (key.delete_length > 0 and not key.insert_seq) else 0.0,
        "SampleAlleleCountStrandBias": sb,
        # RNA indel feature set (rnaVariantEmpiricalScoringFeatures.hh)
        "SampleRefAlleleDepth": float(ad[0]),
        "SamplePrimaryAltAlleleDepth": float(ad[primary_alt]),
        "VariantAlleleQuality": float(call.qual),
        "SampleRefRepeatCount": float(rec.ref_repeat_count),
        "SampleIndelMeanDistanceFromReadEdge": (
            float(call.sample_edge_dist[s])
            if call.sample_edge_dist else 0.0),
    }
    # NormalizedAltHaplotypeCountRatio (gvcf_locus_info.cpp:618-630):
    # -1 outside active regions; else the summed per-GT-allele
    # altHaplotypeCountRatio (starling_pos_processor.cpp:1506-1527)
    # capped at 1 (vcf_util.hh:273-279), doubled for haploid and
    # ref-het genotypes
    if call.pos not in result.phase_set_of_pos:
        vals["NormalizedAltHaplotypeCountRatio"] = -1.0
    else:
        r = 0.0
        gt_alleles = [a0] if ploidy == 1 else [a0, a1]
        for ai in gt_alleles:
            if ai > 0:
                r += float(result.indel_hap_ratio.get(
                    (s, call.keys[ai - 1]), 0.0))
        r = min(r, 1.0)
        het_with_ref = ploidy == 2 and a0 != a1 and (a0 == 0 or a1 == 0)
        vals["NormalizedAltHaplotypeCountRatio"] = (
            r * 2.0 if (ploidy == 1 or het_with_ref) else r)
    return np.array([vals.get(name, 0.0) for name in forest.features])


def _emit_indel(opt, result, call: IndelCall, sample_names, gvcf_lines,
                var_lines, meta, indel_forest=None,
                chrom_depth: float | None = None, phase_plan=None):
    """Serialize one indel locus (gvcf_writer
    write_indel_record_instance :816-1010). `meta` is the
    precomputed _indel_filters() result for this call; blocks are
    flushed by the caller (writer.process(indel) flushes all
    non-variant blocks before any indel record)."""
    n_samples = len(sample_names)
    pos0, ref_str, alts, cigars = vcf_indel_strings(result, call)
    A = len(call.keys) + 1
    not_genotyped = getattr(call, "not_genotyped", False)
    rus, refreps, idreps = [], [], []
    for rec in call.records:
        if not_genotyped:
            # repeat context is never computed for NotGenotyped loci
            # (isRepeatUnit false -> '.', write_indel_record_instance
            # :860-903)
            rus.append(".")
            refreps.append(".")
            idreps.append(".")
            continue
        ru = rec.repeat_unit if rec.repeat_unit and len(rec.repeat_unit) <= 20 else "."
        rus.append(ru)
        refreps.append(str(rec.ref_repeat_count))
        idreps.append(str(rec.indel_repeat_count))
    # MQ: RMS of the pooled all-sample mapq tracker at the position
    # preceding the locus (write_indel_record_instance :902-922,
    # addIndelSamplePileupInfo :1126-1139)
    dpi_idx = call.pos - 1 - result.begin
    mq_n = 0
    mq_ss = 0.0
    if 0 <= dpi_idx < result.end - result.begin:
        for s in range(n_samples):
            mq_n += int(result.samples[s].pileup.mapq_n[dpi_idx])
            mq_ss += float(result.samples[s].pileup.mapq_sumsq[dpi_idx])
    mq = _round_half(float(np.sqrt(mq_ss / mq_n))) if mq_n > 0 else 0
    if not_genotyped:
        mq = "."  # gvcf_writer.cpp:919-922
    info = (f"CIGAR={','.join(cigars)};RU={','.join(rus)};"
            f"REFREP={','.join(refreps)};IDREP={','.join(idreps)};MQ={mq}")
    fmt = "GT:GQ:GQX:DPI:AD:ADF:ADR:FT:PL"
    # phased indel loci append PS (gvcf_writer.cpp:948-965,1008-1022)
    phase_decs = [
        phase_plan.get((("indel", id(call)), s)) if phase_plan else None
        for s in range(n_samples)]
    any_phased = any(d is not None for d in phase_decs)
    if any_phased:
        fmt += ":PS"
    cols = []
    sample_filter_sets = meta["sample_fsets"]
    any_pass_variant = False
    evsf = ""
    if not_genotyped:
        # all-dot sample block + FT + '.' PL (gvcf_writer.cpp:1025-1054)
        for s in range(n_samples):
            fstr = _filter_str(sample_filter_sets[s])
            cols.append(f".:.:.:.:.:.:.:{fstr}:.")
    for s in range(n_samples if not not_genotyped else 0):
        ploidy = (call.sample_ploidy[s] if call.sample_ploidy is not None
                  else 2)
        dec = phase_decs[s]
        if ploidy == 0:
            gt = "."
        elif dec is not None:
            from ..models.indel_genotype import genotype_alleles
            ga = genotype_alleles(max(ploidy, 1), A)
            a0, a1 = (int(x) for x in ga[call.sample_gt[s]])
            if dec.flip:
                a0, a1 = a1, a0
            gt = f"{a0}|{a1}" if dec.phased else f"{a0}/{a1}"
        else:
            gt = _gt_string_indel(call.sample_gt[s], max(ploidy, 1), A)
        gqx = meta["gqx_out"][s]
        is_var_gt = meta["is_var_gt"][s] and ploidy > 0
        if s == 0 and is_var_gt and opt.is_report_evs_features:
            f0 = germline_indel_features(
                indel_forest or _EVSF_INDEL_DEFAULT, result, call, 0,
                chrom_depth)
            evsf = ";EVSF=" + format_evsf(f0)
        filters = sample_filter_sets[s]
        fstr = _filter_str(filters)
        if is_var_gt and not filters:
            any_pass_variant = True
        ps_col = ("" if not any_phased
                  else (f":{dec.ps}" if dec is not None else ":."))
        cols.append(
            f"{gt}:{call.sample_gq[s]}:{gqx}:{call.sample_dpi[s]}:"
            f"{','.join(map(str, call.sample_ad[s]))}:"
            f"{','.join(map(str, call.sample_adf[s]))}:"
            f"{','.join(map(str, call.sample_adr[s]))}:{fstr}:"
            f"{','.join(map(str, call.sample_pl[s]))}{ps_col}")
    # FILTER merging (getExtendedLocusFilters): IndelConflict is a
    # locus-level filter; variants VCF adds the per-sample filter
    # intersection + NoPassedVariantGTs; per-sample gVCF adds that
    # sample's filters
    locus_fset = meta["locus_fset"]
    inter = (set.intersection(*sample_filter_sets)
             if sample_filter_sets else set())
    var_fset = locus_fset | inter
    if not any_pass_variant:
        var_fset.add("NoPassedVariantGTs")
    pre_cols = (f"{result.chrom}\t{pos0 + 1}\t.\t{ref_str}\t"
                f"{','.join(alts)}\t{call.qual}")
    post_cols = f"{info}{evsf}\t{fmt}"
    line = (f"{pre_cols}\t{_filter_str(var_fset)}\t{post_cols}\t"
            + "\t".join(cols))
    var_lines.append(line)
    for s in range(n_samples):
        gvcf_lines[s].append(
            f"{pre_cols}\t{_filter_str(locus_fset | sample_filter_sets[s])}"
            f"\t{post_cols}\t{cols[s]}")
