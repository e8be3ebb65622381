"""Continuous variant-frequency calling over a region (mito mode).

Reference: applications/starling/starling_pos_processor.cpp
process_pos_snp_continuous:926 + gvcf emission with VF field.
Counts-only pileup (no depth axis) supports several-thousand-fold
mitochondrial coverage.

Port of strelka_tpu/pipeline/continuous_caller.py: host code, the same
statements on the port's modules (models/continuous.py, pipeline/pileup.py,
pipeline/reads.py, pipeline/gvcf.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.bam import ReadBatch
from ..io.fasta import FastaReference, decode_bases
from ..models import continuous as cont
from ..options import GermlineOptions
from . import pileup as pl
from . import reads as rd


@dataclass
class ContinuousRegionResult:
    chrom: str
    begin: int
    end: int
    ref_codes: np.ndarray
    counts: dict          # from build_pileup_counts
    alleles: list         # from call_continuous_sites


def call_continuous_region(opt: GermlineOptions, ref: FastaReference,
                           chrom: str, begin: int, end: int,
                           batch: ReadBatch) -> ContinuousRegionResult:
    rc = ref.fetch(chrom, begin, end)
    keep, level = rd.filter_and_classify_reads(batch, opt.min_mapping_quality)
    bk = batch.select(keep)
    ea = rd.expand_alignments(bk)
    mmf, _ = rd.mismatch_density_filter(
        bk, ea, rc, begin, opt.max_win_mismatch_flank_size,
        opt.max_win_mismatch) if bk.n else (None, None)
    counts = pl.build_pileup_counts(bk, ea, level[keep], begin, end,
                                    min_qscore=opt.min_qscore, mm_filter=mmf)
    alleles = cont.call_continuous_sites(
        counts["used_counts"], counts["used_fwd_counts"],
        rc.astype(np.int64),
        min_vf=opt.min_het_vf,
        expected_qscore=opt.continuous_frequency_expected_observation_quality,
        max_qscore=opt.continuous_frequency_max_qscore)
    return ContinuousRegionResult(chrom, begin, end, rc, counts, alleles)


def emit_continuous_region(opt: GermlineOptions,
                           res: ContinuousRegionResult) -> list[str]:
    """gVCF lines with VF format (expectedResultsMito layout)."""
    from .germline_caller import snv_hpol
    from .gvcf import BlockState

    L = res.end - res.begin
    counts = res.counts["used_counts"]
    dpf = res.counts["dpf"]
    lines: list[str] = []
    block = BlockState()
    max_q = opt.continuous_frequency_max_qscore
    for i in range(L):
        pos = res.begin + i
        ref_gt = int(res.ref_codes[i])
        dp = int(counts[i].sum())
        # best non-ref allele
        best_alt = -1
        for a in range(4):
            if a == ref_gt:
                continue
            if res.alleles[a]["variant"][i] and (
                    best_alt < 0 or counts[i, a] > counts[i, best_alt]):
                best_alt = a
        if best_alt < 0 or ref_gt >= 4:
            # hom-ref block path
            covered = dp + int(dpf[i]) > 0
            gqx = min(int(res.alleles[ref_gt]["q"][i]) if ref_gt < 4 and dp else 0,
                      max_q) if covered else 0
            # GQX for homref: confidence that ref allele is real
            filters = []
            if gqx < opt.gvcf_min_homref_gqx:
                filters.append("LowGQX")
            fstr = ";".join(filters) if filters else "PASS"
            gt = "0/0" if covered else "./."
            gqx_str = gqx if covered else "."
            ref_base = decode_bases([res.ref_codes[i]]) if ref_gt < 4 else "N"
            if not block.can_join(gqx if covered else 0, dp, int(dpf[i]), fstr,
                                  opt.block_abs_tol, opt.block_frac_tol,
                                  gt=gt, pl=2, used_cov=dp > 0):
                _flush_cont_block(block, res.chrom, lines, opt.block_label)
            block.add(pos, ref_base, gt, gqx if covered else 0, dp,
                      int(dpf[i]), fstr)
            del gqx_str
            continue
        _flush_cont_block(block, res.chrom, lines, opt.block_label)
        a = best_alt
        vf = float(res.alleles[a]["vf"][i])
        q = int(res.alleles[a]["q"][i])
        sb = float(res.alleles[a]["sb"][i])
        gt = ("1/1" if vf >= 1.0 - opt.min_het_vf else
              "0/1" if vf >= opt.min_het_vf else "0/0")
        hpol = snv_hpol(res.ref_codes, i)
        filters = []
        if q < opt.gvcf_min_gqx:
            filters.append("LowGQX")
        fstr = ";".join(filters) if filters else "PASS"
        ref_base = decode_bases([res.ref_codes[i]])
        alt_base = "ACGT"[a]
        ad = f"{counts[i, ref_gt]},{counts[i, a]}"
        lines.append(
            f"{res.chrom}\t{pos + 1}\t.\t{ref_base}\t{alt_base}\t{q}\t{fstr}\t"
            f"SNVSB={sb:.1f};SNVHPOL={hpol};Unphased\t"
            f"GT:GQ:GQX:DP:DPF:AD:VF\t"
            f"{gt}:{q}:{q}:{dp}:{int(dpf[i])}:{ad}:{vf:.3f}")
    _flush_cont_block(block, res.chrom, lines, opt.block_label)
    return lines


def _flush_cont_block(block, chrom, lines, label):
    from .gvcf import _round_half
    """Block record without MIN_DP (continuous-mode layout)."""
    if block.count == 0:
        return
    info = "."
    if block.count > 1:
        info = f"END={block.start + block.count};{label}"
    gqx_str = str(block.gqx_min) if block.gt != "./." else "."
    lines.append(
        f"{chrom}\t{block.start + 1}\t.\t{block.ref_base}\t.\t.\t"
        f"{block.filters}\t{info}\tGT:GQX:DP:DPF\t"
        f"{block.gt}:{gqx_str}:"
        f"{_round_half(block.dp_sum / block.count)}:"
        f"{_round_half(block.dpf_sum / block.count)}")
    block.__init__()
