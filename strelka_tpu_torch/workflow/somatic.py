"""Somatic workflow CLI + VCF serialization.

Reference: strelkaSomaticWorkflow.py + applications/strelka VCF
emission (somatic_call_shared.hh write_vcf_somatic_snv_genotype_
strand_grid, SomaticIndelVcfWriter.cpp). Output format mirrors the
demo's expected results (src/demo/expectedResults/somatic.*.vcf.gz).

Port of strelka_tpu/workflow/somatic.py, with --device {cuda,cpu} in
place of --platform: BAM or CRAM input, the fan-out of the JAX package
(--jobs, the cluster options, --process-index/--process-count with
--merge-only, and the coordinated STRELKA_TPU_* processes of
parallel/runner.py), and the engine mesh (--mesh auto|N|DPxSP: this
process's scoring launches and somatic SNV chunks sharded over local
devices of --device, parallel/mesh.py). The --jobs parent and a
--merge-only run touch no device.

Usage:
  python -m strelka_tpu_torch somatic --reference ref.fa \
      --normal-align-file n.bam --tumor-align-file t.bam \
      --output-dir out [--region chrom[:beg-end]] [--device cuda|cpu] \
      [--jobs N|auto] [--mesh auto|N|DPxSP]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .. import device as devmod
from ..io.bam import read_alignments, read_bam
from ..io.vcf import identity_header_lines
from ..io.bgzf import BgzfWriter
from ..io.fasta import FastaReference, decode_bases
from ..options import SomaticOptions
from ..parallel import runner as rn
from ..pipeline import somatic_caller as sc
from ..pipeline.gvcf import format_evsf
from ..utils import spans

BASES = "ACGT"


def snv_header(chrom, clen, opt, evs_on=True, depth_filter=False):
    return "\n".join([
        "##fileformat=VCFv4.1",
        *identity_header_lines(opt.cmdline, opt.reference_path),
        f"##contig=<ID={chrom},length={clen}>",
        "##content=strelka_tpu_torch somatic snv calls",
        "##priorSomaticSnvRate=0.0001",
        '##INFO=<ID=QSS,Number=1,Type=Integer,Description="Quality score for any somatic snv, ie. for the ALT allele to be present at a significantly different frequency in the tumor and normal">',
        '##INFO=<ID=TQSS,Number=1,Type=Integer,Description="Data tier used to compute QSS">',
        '##INFO=<ID=NT,Number=1,Type=String,Description="Genotype of the normal in all data tiers, as used to classify somatic variants. One of {ref,het,hom,conflict}.">',
        '##INFO=<ID=QSS_NT,Number=1,Type=Integer,Description="Quality score reflecting the joint probability of a somatic variant and NT">',
        '##INFO=<ID=TQSS_NT,Number=1,Type=Integer,Description="Data tier used to compute QSS_NT">',
        '##INFO=<ID=SGT,Number=1,Type=String,Description="Most likely somatic genotype excluding normal noise states">',
        '##INFO=<ID=SOMATIC,Number=0,Type=Flag,Description="Somatic mutation">',
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Combined depth across samples">',
        '##INFO=<ID=MQ,Number=1,Type=Float,Description="RMS Mapping Quality">',
        '##INFO=<ID=MQ0,Number=1,Type=Integer,Description="Total Mapping Quality Zero Reads">',
        '##INFO=<ID=ReadPosRankSum,Number=1,Type=Float,Description="Z-score from Wilcoxon rank sum test of Alt Vs. Ref read-position in the tumor">',
        '##INFO=<ID=SNVSB,Number=1,Type=Float,Description="Somatic SNV site strand bias">',
        '##INFO=<ID=PNOISE,Number=1,Type=Float,Description="Fraction of panel containing non-reference noise at this site">',
        '##INFO=<ID=PNOISE2,Number=1,Type=Float,Description="Fraction of panel containing more than one non-reference noise obs at this site">',
        '##INFO=<ID=SomaticEVS,Number=1,Type=Float,Description="Somatic Empirical Variant Score (EVS) expressing the phred-scaled probability of the call being a false positive observation.">',
    ] + ([
        '##INFO=<ID=EVSF,Number=.,Type=Float,Description="Empirical variant scoring features.">',
    ] if opt.is_report_evs_features else []) + [
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth for tier1 (used+filtered)">',
        '##FORMAT=<ID=FDP,Number=1,Type=Integer,Description="Number of basecalls filtered from original read depth for tier1">',
        '##FORMAT=<ID=SDP,Number=1,Type=Integer,Description="Number of reads with deletions spanning this site at tier1">',
        '##FORMAT=<ID=SUBDP,Number=1,Type=Integer,Description="Number of reads below tier1 mapping quality threshold aligned across this site">',
        '##FORMAT=<ID=AU,Number=2,Type=Integer,Description="Number of \'A\' alleles used in tiers 1,2">',
        '##FORMAT=<ID=CU,Number=2,Type=Integer,Description="Number of \'C\' alleles used in tiers 1,2">',
        '##FORMAT=<ID=GU,Number=2,Type=Integer,Description="Number of \'G\' alleles used in tiers 1,2">',
        '##FORMAT=<ID=TU,Number=2,Type=Integer,Description="Number of \'T\' alleles used in tiers 1,2">',
    ] + ([
        '##FILTER=<ID=LowEVS,Description="Somatic Empirical Variant Score (SomaticEVS) is below threshold">',
    ] if evs_on else [
        f'##FILTER=<ID=BCNoise,Description="Fraction of basecalls filtered at this site in either sample is at or above {opt.somatic_snv_max_filtered_basecall_frac}">',
        f'##FILTER=<ID=SpanDel,Description="Fraction of reads crossing site with spanning deletions in either sample exceeds {opt.somatic_snv_max_spanning_deletion_frac}">',
        f'##FILTER=<ID=QSS_ref,Description="Normal sample is not homozygous ref or ssnv Q-score < {opt.somatic_snv_min_qss_ref}, ie calls with NT!=ref or QSS_NT < {opt.somatic_snv_min_qss_ref}">',
    ]) + [
        f'##FILTER=<ID=LowDepth,Description="Tumor or normal sample read depth at this locus is below {opt.min_passed_call_depth}">',
    ] + ([
        f'##FILTER=<ID=HighDepth,Description="Locus depth is greater than {opt.max_depth_factor}x the mean chromosome depth in the normal sample">',
    ] if depth_filter else []) + [
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tNORMAL\tTUMOR",
    ]) + "\n"


def indel_header(chrom, clen, opt, evs_on=True, depth_filter=False):
    return "\n".join([
        "##fileformat=VCFv4.1",
        *identity_header_lines(opt.cmdline, opt.reference_path),
        f"##contig=<ID={chrom},length={clen}>",
        "##content=strelka_tpu_torch somatic indel calls",
        "##priorSomaticIndelRate=1e-06",
        '##INFO=<ID=QSI,Number=1,Type=Integer,Description="Quality score for any somatic variant, ie. for the ALT haplotype to be present at a significantly different frequency in the tumor and normal">',
        '##INFO=<ID=TQSI,Number=1,Type=Integer,Description="Data tier used to compute QSI">',
        '##INFO=<ID=NT,Number=1,Type=String,Description="Genotype of the normal in all data tiers, as used to classify somatic variants. One of {ref,het,hom,conflict}.">',
        '##INFO=<ID=QSI_NT,Number=1,Type=Integer,Description="Quality score reflecting the joint probability of a somatic variant and NT">',
        '##INFO=<ID=TQSI_NT,Number=1,Type=Integer,Description="Data tier used to compute QSI_NT">',
        '##INFO=<ID=SGT,Number=1,Type=String,Description="Most likely somatic genotype excluding normal noise states">',
        '##INFO=<ID=RU,Number=1,Type=String,Description="Smallest repeating sequence unit in inserted or deleted sequence">',
        '##INFO=<ID=RC,Number=1,Type=Integer,Description="Number of times RU repeats in the reference allele">',
        '##INFO=<ID=IC,Number=1,Type=Integer,Description="Number of times RU repeats in the indel allele">',
        '##INFO=<ID=IHP,Number=1,Type=Integer,Description="Largest reference interrupted homopolymer length intersecting with the indel">',
        '##INFO=<ID=MQ,Number=1,Type=Float,Description="RMS Mapping Quality">',
        '##INFO=<ID=MQ0,Number=1,Type=Integer,Description="Total Mapping Quality Zero Reads">',
        '##INFO=<ID=SOMATIC,Number=0,Type=Flag,Description="Somatic mutation">',
        '##INFO=<ID=OVERLAP,Number=0,Type=Flag,Description="Somatic indel possibly overlaps a second indel.">',
        '##INFO=<ID=SomaticEVS,Number=1,Type=Float,Description="Somatic Empirical Variant Score (EVS) expressing the phred-scaled probability of the call being a false positive observation.">',
    ] + ([
        '##INFO=<ID=EVSF,Number=.,Type=Float,Description="Empirical variant scoring features.">',
    ] if opt.is_report_evs_features else []) + [
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth for tier1">',
        '##FORMAT=<ID=DP2,Number=1,Type=Integer,Description="Read depth for tier2">',
        '##FORMAT=<ID=TAR,Number=2,Type=Integer,Description="Reads strongly supporting alternate allele for tiers 1,2">',
        '##FORMAT=<ID=TIR,Number=2,Type=Integer,Description="Reads strongly supporting indel allele for tiers 1,2">',
        '##FORMAT=<ID=TOR,Number=2,Type=Integer,Description="Other reads (weak support or insufficient indel breakpoint overlap) for tiers 1,2">',
        '##FORMAT=<ID=DP50,Number=1,Type=Float,Description="Average tier1 read depth within 50 bases">',
        '##FORMAT=<ID=FDP50,Number=1,Type=Float,Description="Average tier1 number of basecalls filtered from original read depth within 50 bases">',
        '##FORMAT=<ID=SUBDP50,Number=1,Type=Float,Description="Average number of reads below tier1 mapping quality threshold aligned across sites within 50 bases">',
        '##FORMAT=<ID=BCN50,Number=1,Type=Float,Description="Fraction of filtered reads within 50 bases of the indel.">',
    ] + ([
        '##FILTER=<ID=LowEVS,Description="Somatic Empirical Variant Score (SomaticEVS) is below threshold">',
    ] if evs_on else [
        f'##FILTER=<ID=IndelBCNoise,Description="Average fraction of filtered basecalls within {opt.indel_region_flank_size} bases of the indel exceeds {opt.somatic_indel_max_window_filtered_basecall_frac}">',
        f'##FILTER=<ID=QSI_ref,Description="Normal sample is not homozygous ref or sindel Q-score < 40, ie calls with NT!=ref or QSI_NT < 40">',
    ]) + [
        f'##FILTER=<ID=LowDepth,Description="Tumor or normal sample read depth at this locus is below {opt.min_passed_call_depth}">',
    ] + ([
        f'##FILTER=<ID=HighDepth,Description="Locus depth is greater than {opt.max_depth_factor}x the mean chromosome depth in the normal sample">',
    ] if depth_filter else []) + [
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tNORMAL\tTUMOR",
    ]) + "\n"


def _sgt_snv(site: sc.SomaticSnvSite) -> str:
    ref_b = BASES[site.ref_gt]
    alt_b = BASES[site.alt_id]
    n_labels = {0: ref_b + ref_b, 1: alt_b + alt_b,
                2: "".join(sorted(ref_b + alt_b))}
    n = n_labels.get(site.sgt_normal, ref_b + ref_b)
    # tumor side: somatic -> gains/loses the alt relative to normal
    if site.sgt_tumor_is_som:
        t = "".join(sorted(ref_b + alt_b)) if site.sgt_normal == 0 else (
            ref_b + ref_b if site.sgt_normal == 2 else
            "".join(sorted(ref_b + alt_b)))
    else:
        t = n
    return f"{n}->{t}"


def interrupted_hpol(ref_codes: np.ndarray, begin: int, pos: int, right: int) -> int:
    """Largest interrupted homopolymer intersecting the indel
    (reference: blt_common/hapscore / get_interrupted_hpol_size)."""
    best = 0
    n = len(ref_codes)
    for p in range(max(0, pos - begin - 1), min(n, right - begin + 2)):
        b = ref_codes[p]
        if b >= 4:
            continue
        # allow one interruption
        i = p
        while i > 0 and ref_codes[i - 1] == b:
            i -= 1
        j = p
        while j + 1 < n and ref_codes[j + 1] == b:
            j += 1
        run = j - i + 1
        # extend over a single interruption on either side
        ext = 0
        if i - 2 >= 0 and ref_codes[i - 2] == b:
            k = i - 2
            while k > 0 and ref_codes[k - 1] == b:
                k -= 1
            ext = max(ext, i - 1 - k + 1)
        if j + 2 < n and ref_codes[j + 2] == b:
            k = j + 2
            while k + 1 < n and ref_codes[k + 1] == b:
                k += 1
            ext = max(ext, k - (j + 2) + 1)
        best = max(best, run + ext)
    return best


@spans.span("emit")
def _emit_somatic_segment(args, opt, res, norm_chrom_depth, snv_forest,
                          indel_forest, noise_at):
    """Record lines for one called segment (snv, indel, callable).

    norm_chrom_depth: per-chromosome normal depth estimate, or None
    in exome mode (strelkaSharedWorkflow.py isHighDepthFilter = not
    exome/rna; without it is_max_depth() is false and the EVS
    depth-rate feature pins to 1.0,
    position_somatic_snv_strand_grid_vcf.cpp:100-110).
    """
    from ..models import evs

    snv_rows = None
    if res.snvs and (snv_forest is not None or opt.is_report_evs_features):
        snv_rows = [evs.somatic_snv_features(s, norm_chrom_depth)
                    for s in res.snvs]
    snv_evs = None
    if snv_forest is not None and snv_rows:
        snv_evs = evs.score_sites(snv_forest, snv_rows)
        # non-ref normal genotypes are forced to EVS 0
        # (somaticAlleleUtil.cpp:39-42)
        for i, s in enumerate(res.snvs):
            if s.ntype != 0:
                snv_evs[i] = 0.0
    indel_rows = None
    if res.indels and (indel_forest is not None
                       or opt.is_report_evs_features):
        indel_rows = [evs.somatic_indel_features(
            c, interrupted_hpol(res.ref_codes, res.begin, c.key.pos,
                                c.key.right_pos), norm_chrom_depth)
            for c in res.indels]
    indel_evs = None
    if indel_forest is not None and indel_rows:
        indel_evs = evs.score_sites(indel_forest, indel_rows)
        for i, c in enumerate(res.indels):
            if c.ntype != 0:
                indel_evs[i] = 0.0

    snv_lines = []
    for si_idx, site in enumerate(res.snvs):
        if snv_evs is not None:
            filters = ([] if snv_evs[si_idx] >= snv_forest.filter_cutoff
                       else ["LowEVS"])
        else:
            # legacy rule filters, enum order (strelka_vcf_locus_info.hh
            # + position_somatic_snv_strand_grid_vcf.cpp:280-327)
            filters = []
            if norm_chrom_depth is not None and \
                    site.dp[0] > opt.max_depth_factor * norm_chrom_depth:
                filters.append("HighDepth")
            def _frac(a, b):
                return a / b if b > 0 else 0.0
            if any(_frac(site.fdp[s], site.dp[s]) >=
                   opt.somatic_snv_max_filtered_basecall_frac
                   for s in range(2)):
                filters.append("BCNoise")
            if any(_frac(site.sdp[s], site.dp[s] + site.sdp[s]) >
                   opt.somatic_snv_max_spanning_deletion_frac
                   for s in range(2)):
                filters.append("SpanDel")
            if site.ntype != 0 or site.qss_nt < opt.somatic_snv_min_qss_ref:
                filters.append("QSS_ref")
        # LowDepth: tier1 depth below minPassedCallDepth in either
        # sample (position_somatic_snv_strand_grid_vcf.cpp:350-355)
        if min(site.dp) < opt.min_passed_call_depth:
            filters.append("LowDepth")
        filt = ";".join(filters) if filters else "PASS"
        info = (f"SOMATIC;QSS={site.qss};TQSS={site.tier_qss + 1};"
                f"NT={sc.NTYPE_LABELS[site.ntype]};QSS_NT={site.qss_nt};"
                f"TQSS_NT={site.tier_qss_nt + 1};SGT={_sgt_snv(site)};"
                f"DP={site.mapq_n};MQ={site.mq:.2f};MQ0={site.mq0};"
                f"ReadPosRankSum={site.read_pos_ranksum:.2f};"
                f"SNVSB={site.snv_sb:.2f}")
        pn = noise_at.get((res.chrom, site.pos))
        if pn is not None:
            info += f";PNOISE={pn[0]:.2f};PNOISE2={pn[1]:.2f}"
        if snv_evs is not None:
            info += f";SomaticEVS={snv_evs[si_idx]:.2f}"
        if opt.is_report_evs_features and snv_rows is not None:
            # scoring features only; the reference appends its
            # development features after them (not tracked here)
            info += ";EVSF=" + format_evsf(snv_rows[si_idx])
        cols = []
        for s in range(2):
            au = [f"{site.acgt_tier1[s][b]},{site.acgt_tier2[s][b]}"
                  for b in range(4)]
            cols.append(f"{site.dp[s]}:{site.fdp[s]}:{site.sdp[s]}:"
                        f"{site.subdp[s]}:" + ":".join(au))
        snv_lines.append(
            f"{res.chrom}\t{site.pos + 1}\t.\t{BASES[site.ref_gt]}\t"
            f"{BASES[site.alt_id]}\t.\t{filt}\t{info}\t"
            f"DP:FDP:SDP:SUBDP:AU:CU:GU:TU\t" + "\t".join(cols))

    indel_lines = []
    # OVERLAP flag: somatic indel possibly overlaps another emitted
    # indel (SomaticIndelVcfWriter OVERLAP INFO)
    spans = [(c.key.pos - 1, c.key.right_pos + 1) for c in res.indels]
    overlaps = [any(j != i and a0 < spans[j][1] and spans[j][0] < a1
                    for j in range(len(spans)))
                for i, (a0, a1) in enumerate(spans)]
    for ci_idx, call in enumerate(res.indels):
        key = call.key
        pos0 = key.pos - 1
        left = pos0 - res.begin
        ref_str = decode_bases(
            res.ref_codes[left:left + 1 + key.delete_length])
        alt_str = ref_str[0] + key.insert_seq
        # HighDepth applies with or without EVS for indels (normal
        # tier1 locus depth, SomaticIndelVcfWriter.cpp:95-103)
        filters = []
        if norm_chrom_depth is not None and \
                call.dp[0] > opt.max_depth_factor * norm_chrom_depth:
            filters.append("HighDepth")
        if indel_evs is not None:
            if indel_evs[ci_idx] < indel_forest.filter_cutoff:
                filters.append("LowEVS")
        else:
            # non-EVS filters (SomaticIndelVcfWriter.cpp :109-127)
            if any(w[3] >= opt.somatic_indel_max_window_filtered_basecall_frac
                   for w in call.win):
                filters.append("IndelBCNoise")
            if call.ntype != 0 or call.qsi_nt < \
                    opt.somatic_indel_min_qsi_filter:
                filters.append("QSI_ref")
        if min(call.dp) < opt.min_passed_call_depth:
            filters.append("LowDepth")
        filt = ";".join(filters) if filters else "PASS"
        ihp = interrupted_hpol(res.ref_codes, res.begin, key.pos,
                               key.right_pos)
        info = (f"SOMATIC;QSI={call.qsi};TQSI={call.tier + 1};"
                f"NT={sc.NTYPE_LABELS[call.ntype]};QSI_NT={call.qsi_nt};"
                f"TQSI_NT={call.tier + 1};"
                f"SGT=ref->{'het' if call.sgt_tumor_is_som else sc.NTYPE_LABELS[call.ntype]};"
                f"MQ={call.mq:.2f};MQ0={call.mq0};"
                f"RU={call.rec.repeat_unit or '.'};"
                f"RC={call.rec.ref_repeat_count};"
                f"IC={call.rec.indel_repeat_count};IHP={ihp}")
        if overlaps[ci_idx]:
            info += ";OVERLAP"
        if indel_evs is not None:
            info += f";SomaticEVS={indel_evs[ci_idx]:.2f}"
        if opt.is_report_evs_features and indel_rows is not None:
            info += ";EVSF=" + format_evsf(indel_rows[ci_idx])
        cols = []
        for s in range(2):
            w = call.win[s] if s < len(call.win) else (0.0, 0.0, 0.0, 0.0)
            cols.append(
                f"{call.dp[s]}:{call.dp[s]}:"
                f"{call.tar[s][0]},{call.tar[s][1]}:"
                f"{call.tir[s][0]},{call.tir[s][1]}:"
                f"{call.tor[s][0]},{call.tor[s][1]}:"
                f"{w[0]:.2f}:{w[1]:.2f}:{w[2]:.2f}:{w[3]:.2f}")
        indel_lines.append(
            f"{res.chrom}\t{pos0 + 1}\t.\t{ref_str}\t{alt_str}\t.\t"
            f"{filt}\t{info}\tDP:DP2:TAR:TIR:TOR:DP50:FDP50:SUBDP50:BCN50\t"
            + "\t".join(cols))

    callable_lines = [f"{res.chrom}\t{b}\t{e}"
                      for b, e in res.callable_intervals]
    return snv_lines, indel_lines, callable_lines


def run_somatic(argv=None) -> int:
    p = argparse.ArgumentParser(prog="strelka_tpu_torch somatic")
    p.add_argument("--reference", required=True)
    p.add_argument("--normal-align-file", required=True)
    p.add_argument("--tumor-align-file", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--region", action="append", default=None)
    p.add_argument("--process-index", type=int, default=None,
                   help="this worker's index for local multi-process "
                        "fan-out (pyflow-style); run one process per "
                        "index 0..count-1, then --merge-only")
    p.add_argument("--process-count", type=int, default=None)
    rn.add_fanout_args(p)
    p.add_argument("--merge-only", action="store_true",
                   help="skip calling; concatenate existing workspace "
                        "fragments into final outputs")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scoring kernel and the somatic SNV "
                        "model run (default cuda; cuda without a GPU is "
                        "an error)")
    rn.add_mesh_arg(p)
    p.add_argument("--output-realigned-bam", action="store_true",
                   help="write realigned.normal.bam / realigned.tumor.bam "
                        "with the post-realignment alignments (reference "
                        "--realigned-read-file)")
    p.add_argument("--config", default=None,
                   help="reference-style ini file overriding caller "
                        "options (configureStrelkaSomaticWorkflow.py.ini)")
    p.add_argument("--dry-run", action="store_true",
                   help="list the task schedule (incl. resume state) "
                        "and exit without calling (pyflow --dryRun)")
    p.add_argument("--call-regions-bed", default=None,
                   help="BED of regions to call (reference --callRegions)")
    p.add_argument("--indel-candidates", action="append", default=None)
    p.add_argument("--min-qss-filter", type=int, default=15)
    p.add_argument("--max-region-size", type=int, default=1_000_000)
    p.add_argument("--somatic-snv-scoring-model-file", default=None,
                   help="EVS model JSON for somatic SNVs (default: "
                        "config/empiricalVariantScoring/models/"
                        "somaticSNVScoringModels.json in the package; "
                        "where no model exists the rule-based filters "
                        "apply)")
    p.add_argument("--somatic-indel-scoring-model-file", default=None,
                   help="EVS model JSON for somatic indels (default: "
                        "somaticIndelScoringModels.json beside the SNV "
                        "model)")
    p.add_argument("--disable-evs", action="store_true")
    p.add_argument("--report-evs-features", action="store_true",
                   help="append ;EVSF=<scoring features> to records for "
                        "offline EVS training (reference "
                        "--reportEVSFeatures; development features are "
                        "not included)")
    p.add_argument("--exome", action="store_true",
                   help="targeted/exome input: disable the high-depth "
                        "filter and chrom-depth estimation")
    p.add_argument("--output-callable-regions", action="store_true",
                   help="write somatic.callable.regions.bed.gz")
    p.add_argument("--noise-vcf", action="append", default=None,
                   help="panel-of-normals site noise VCF(s)")
    args = p.parse_args(argv)

    return rn.dispatch("strelka_tpu_torch.workflow.somatic", args, argv,
                       _run_somatic)


def _run_somatic(args, argv) -> int:
    t0 = time.time()
    spans.stage("job.setup")
    opt = SomaticOptions()
    if args.config:
        from ..options import apply_ini
        opt, ini_extras = apply_ini(opt, args.config)
        if ini_extras.get("is_write_realigned_bam"):
            args.output_realigned_bam = True
    ref = FastaReference(args.reference)
    os.makedirs(args.output_dir, exist_ok=True)
    opt.is_report_evs_features = args.report_evs_features
    opt.cmdline = ("strelka_tpu_torch somatic "
                   + " ".join(argv if argv is not None else sys.argv[1:]))
    opt.reference_path = args.reference

    from .germline import parse_region
    regions = ([parse_region(r, ref) for r in args.region] if args.region
               else [(c, 0, ref.contig_length(c)) for c in ref.contig_names])
    if args.call_regions_bed:
        from ..io.bed import read_bed
        bed_by_chrom: dict[str, list] = {}
        for rec in read_bed(args.call_regions_bed):
            bed_by_chrom.setdefault(rec.chrom, []).append((rec.begin, rec.end))
        regions = [(chrom, max(beg, b0), min(end, e0))
                   for chrom, beg, end in regions
                   for b0, e0 in sorted(bed_by_chrom.get(chrom, []))
                   if max(beg, b0) < min(end, e0)]
        if not regions:
            print("call-regions BED leaves nothing to call",
                  file=sys.stderr)
            return 0

    # segment plan before input reads: fan-out processes use the BAM
    # index to load only their assigned halo'd spans (reference:
    # bam_streamer region open per 12Mb segment process)
    proc_idx, proc_cnt = rn.init_distributed()
    if args.process_index is not None:
        proc_idx = args.process_index
        proc_cnt = args.process_count or 1
    segments = []
    for chrom, beg, end in regions:
        for seg_beg in range(beg, end, args.max_region_size):
            segments.append(rn.GenomeSegment(
                chrom, seg_beg, min(seg_beg + args.max_region_size, end)))
    groups = rn.group_segments(segments, min_group=1)
    seg_halo = opt.max_indel_size + 250 + 100
    my_groups = [g for i, g in enumerate(groups)
                 if i % max(proc_cnt, 1) == proc_idx]
    needed_spans = rn.merge_group_spans(my_groups, seg_halo,
                                        {c: ref.contig_length(c)
                                         for c, _b, _e in regions})
    whole_genome = (args.region is None and proc_cnt <= 1
                    and not args.call_regions_bed)

    def _read_input(path):
        if not whole_genome:
            try:
                from ..io.bam import read_alignments_regions
                return read_alignments_regions(path, needed_spans, ref)
            except (FileNotFoundError, ValueError):
                pass  # no usable index: whole-file read
        return read_alignments(path, ref)

    spans.stage("decode")
    nhdr, nbatch_all = _read_input(args.normal_align_file)
    thdr, tbatch_all = _read_input(args.tumor_align_file)

    # input consistency validation (checkChromSet.py:144-211; the
    # somatic configure script validates normal+tumor vs the reference)
    from .validation import ConfigurationError, check_chrom_set
    try:
        check_chrom_set(ref, [nhdr, thdr],
                        labels=[args.normal_align_file,
                                args.tumor_align_file])
    except ConfigurationError as e:
        print(f"\nCONFIGURATION ERROR:\n{e}\n", file=sys.stderr)
        return 1

    spans.stage("job.setup")
    from ..models import evs
    snv_forest = indel_forest = None
    if not args.disable_evs:
        snv_forest = evs.load_somatic_snv_model(args.somatic_snv_scoring_model_file)
        indel_forest = evs.load_somatic_indel_model(args.somatic_indel_scoring_model_file)

    snv_path = os.path.join(args.output_dir, "somatic.snvs.vcf.gz")
    indel_path = os.path.join(args.output_dir, "somatic.indels.vcf.gz")
    workspace = os.path.join(args.output_dir, "workspace")

    # panel-of-normals site noise (NoiseBuffer/SiteNoise): PNOISE =
    # nfrac, PNOISE2 = n2frac. Reference-format panels carry per-sample
    # DP:AD columns and the fractions are computed at consumption time
    # exactly like set_noise_from_vcf (SiteNoise.cpp:29-78: every
    # sample column counts toward total; a non-'.' column counts as
    # noise; an AD alt count > 1 counts as noise2); repo-extension
    # panels may carry precomputed PNOISE/PNOISE2 INFO instead.
    noise_at: dict[tuple[str, int], tuple[float, float]] = {}
    if args.noise_vcf:
        from ..io.vcf import read_vcf
        for path in args.noise_vcf:
            for v in read_vcf(path):
                pn = None
                if v.samples:
                    total = len(v.samples)
                    noise = noise2 = 0
                    for col in v.samples:
                        if col.startswith("."):
                            continue
                        noise += 1
                        parts = col.split(":")
                        if len(parts) > 1 and "," in parts[1]:
                            try:
                                if int(parts[1].split(",")[1]) > 1:
                                    noise2 += 1
                            except ValueError:
                                pass
                    pn = (noise / total, noise2 / total)
                elif "PNOISE" in v.info:
                    info = dict(kv.split("=") for kv in v.info.split(";")
                                if "=" in kv)
                    pn = (float(info.get("PNOISE", 0)),
                          float(info.get("PNOISE2", 0)))
                if pn is not None:
                    noise_at[(v.chrom, v.pos)] = pn

    runner = rn.SegmentRunner(workspace, process_index=proc_idx,
                              process_count=proc_cnt)

    spans.stage("decode")
    batches_of = {}
    for chrom, _b, _e in regions:
        ntid = nhdr.ref_names.index(chrom) if chrom in nhdr.ref_names else -1
        ttid = thdr.ref_names.index(chrom) if chrom in thdr.ref_names else -1
        batches_of[chrom] = (
            nbatch_all.select(np.asarray(nbatch_all.tid == ntid)),
            tbatch_all.select(np.asarray(tbatch_all.tid == ttid)))

    spans.stage("job.depth")
    # per-chrom ref-end positions for segment batch slicing (keeps
    # per-segment work O(segment reads), not O(chrom reads)); chrom
    # depth (GetChromDepth analog) comes from the full chrom batch
    ref_ends_of = {c: (nbc.ref_end_positions(), tbc.ref_end_positions())
                   for c, (nbc, tbc) in batches_of.items()}
    chrom_depth_of = {}
    if not args.exome:
        from .tools import chrom_depth_estimate
        for c, (nbc, _tbc) in batches_of.items():
            chrom_depth_of[c] = chrom_depth_estimate(
                nbc, ref.contig_length(c)) or None

    def task_fn(group):
        snv_lines, indel_lines, callable_lines = [], [], []
        stats = rn.RunStats()
        for seg in group:
            nb, tb = batches_of[seg.chrom]
            nre, tre = ref_ends_of[seg.chrom]
            nm = (nre > seg.begin - seg_halo) & (nb.pos < seg.end + seg_halo)
            tm = (tre > seg.begin - seg_halo) & (tb.pos < seg.end + seg_halo)
            if not nm.all():
                nb = nb.select(nm)
            if not tm.all():
                tb = tb.select(tm)
            res = sc.call_somatic_region(
                opt, ref, seg.chrom, seg.begin, seg.end, nb, tb,
                external_indel_vcfs=args.indel_candidates,
                collect_realigned=args.output_realigned_bam)
            if res.realigned is not None:
                # per-segment realigned fragments (normal + tumor),
                # merged in segment order at the end
                from ..io.bam import scatter_rewrites
                from ..io.bam_writer import write_bam
                os.makedirs(workspace, exist_ok=True)
                for si, (label, raw, hdr) in enumerate(
                        [("normal", nb, nhdr), ("tumor", tb, thdr)]):
                    keep_idx, kb = res.realigned[si]
                    full = scatter_rewrites(raw, keep_idx, kb)
                    sel = (full.pos >= seg.begin) & (full.pos < seg.end)
                    frag = os.path.join(
                        workspace,
                        f"seg_{seg.label}.{label}.realigned.bam")
                    write_bam(frag, hdr, full.select(sel))
            sv, il, cl = _emit_somatic_segment(
                args, opt, res, chrom_depth_of.get(seg.chrom),
                snv_forest, indel_forest, noise_at)
            snv_lines.extend(sv)
            indel_lines.extend(il)
            callable_lines.extend(cl)
            stats.reads_processed += int(
                ((nb.pos >= seg.begin) & (nb.pos < seg.end)).sum()
                + ((tb.pos >= seg.begin) & (tb.pos < seg.end)).sum())
        return (snv_lines, indel_lines, callable_lines), stats

    def on_complete(gi, result):
        sv, il, cl = result
        for suffix, lines in (("snvs", sv), ("indels", il), ("callable", cl)):
            with open(os.path.join(workspace,
                                   f"seg_{gi:06d}.{suffix}"), "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))

    spans.stage(None)
    if args.dry_run:
        runner.dry_run(groups)
        return 0
    if not args.merge_only:
        runner.run(groups, task_fn, on_complete)
    if args.process_index is not None and not args.merge_only \
            and proc_cnt > 1:
        print(rn.worker_done_line(proc_idx, proc_cnt,
                                  runner.stats.segments_completed),
              file=sys.stderr)
        return 0

    # ordered concat + tabix-indexed bgzf
    from ..io.tabix import IndexedVcfWriter
    all_chroms = list(ref.contig_names)
    chrom0 = regions[0][0]
    clen0 = ref.contig_length(chrom0)
    n_snv = n_indel = 0
    evs_on = not args.disable_evs
    max_depth_on = not args.exome
    for path, header_text, suffix in (
            (snv_path, snv_header(chrom0, clen0, opt, evs_on,
                                  depth_filter=(not evs_on) and max_depth_on),
             "snvs"),
            (indel_path, indel_header(chrom0, clen0, opt, evs_on,
                                      depth_filter=max_depth_on),
             "indels")):
        with spans.span("merge"), IndexedVcfWriter(path, all_chroms) as w:
            w.write_header(header_text)
            for gi in range(len(groups)):
                frag = os.path.join(workspace, f"seg_{gi:06d}.{suffix}")
                if os.path.exists(frag):
                    with open(frag) as f:
                        for line in f:
                            if line.strip():
                                w.write_record_line(line)
                                if suffix == "snvs":
                                    n_snv += 1
                                else:
                                    n_indel += 1
    if args.output_callable_regions:
        with spans.span("merge"), BgzfWriter(os.path.join(
                args.output_dir, "somatic.callable.regions.bed.gz")) as w:
            for gi in range(len(groups)):
                frag = os.path.join(workspace, f"seg_{gi:06d}.callable")
                if os.path.exists(frag):
                    with open(frag, "rb") as f:
                        w.write(f.read())

    if args.output_realigned_bam:
        from ..io.bam import concat_batches
        from ..io.bam_writer import write_bam
        for label, hdr in (("normal", nhdr), ("tumor", thdr)):
            frags = []
            for seg in segments:
                frag = os.path.join(
                    workspace, f"seg_{seg.label}.{label}.realigned.bam")
                if os.path.exists(frag):
                    frags.append(read_bam(frag)[1])
            if not frags:
                continue
            with spans.span("merge"):
                merged = concat_batches(frags)
                out_bam = os.path.join(args.output_dir,
                                       f"realigned.{label}.bam")
                write_bam(out_bam, hdr, merged)
            print(f"realigned reads: {out_bam} ({merged.n} records)",
                  file=sys.stderr)

    spans.stage("job.finish")
    total_stats = rn.merge_run_stats(workspace)
    with open(os.path.join(args.output_dir, "runStats.xml"), "w") as _sf:
        _sf.write(total_stats.to_xml())
    from ..utils.flowlog import merge_worker_logs
    surfaced = merge_worker_logs(
        workspace, os.path.join(args.output_dir, "workflow.log"))
    for line in surfaced["warnings"] + surfaced["errors"]:
        print(line, file=sys.stderr)

    where = "merge" if args.merge_only else f"on {devmod.current()}"
    print(f"strelka_tpu_torch somatic {where} done in "
          f"{time.time() - t0:.1f}s; "
          f"snvs={n_snv} indels={n_indel}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    # a --jobs worker's or a merge's process: one job
    with spans.job(cmd="somatic"):
        raise SystemExit(run_somatic())
