"""Germline workflow CLI.

Reference analog: configureStrelkaGermlineWorkflow.py + runWorkflow.py +
strelkaGermlineWorkflow.py (pyflow DAG). The engine runs grouped genome
segments through the batched caller via the SegmentRunner (checkpointed
resume, retry, run stats — parallel/runner.py), writes per-segment
output fragments, and concatenates them in order into BGZF outputs
(the reference's compress+concat merge tasks,
strelkaSharedWorkflow.py:102-148).

Port of strelka_tpu/workflow/germline.py, with --device {cuda,cpu} in
place of --platform: one or more samples (joint calling), BAM or CRAM
input, germline EVS model files (--snv/--indel-scoring-model-file,
--disable-evs), continuous-VF chromosomes (--call-continuous-vf), RNA
mode (--rna: the het-VF extension on the SNV tiles, RNAseq models from
the flags or $STRELKA_TPU_MODEL_DIR), and the fan-out of the JAX package
(--jobs, the cluster options, --process-index/--process-count with
--merge-only, and the coordinated STRELKA_TPU_* processes of
parallel/runner.py), the sequence-error estimation pre-pass
(--estimate-sequence-error: host counting, the fits on --device), and
the engine mesh (--mesh auto|N|DPxSP: this process's scoring launches
and SNV tiles sharded over local devices of --device, parallel/mesh.py).

The --jobs parent and a --merge-only run touch no device: only the
workers, each on its own segment groups, run on --device.

Usage:
  python -m strelka_tpu_torch germline \
      --reference ref.fa --align-file a.bam [--align-file b.bam ...] \
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
from ..io.fasta import FastaReference
from ..options import GermlineOptions
from ..parallel import runner as rn
from ..pipeline import germline_caller, gvcf


def parse_region(text: str, ref: FastaReference):
    if ":" in text:
        chrom, rng = text.split(":")
        b, e = rng.replace(",", "").split("-")
        return chrom, int(b) - 1, int(e)
    return text, 0, ref.contig_length(text)


def estimate_chrom_depth(batch, min_mapq: int, chrom_len: int) -> float:
    """GetChromDepth equivalent (ReadChromDepthUtil.cpp): perfect
    in-place read spans, 16-position cell compression, zero-removed
    median. min_mapq is unused (the reference applies no MAPQ filter
    here) and kept for call-site compatibility."""
    del min_mapq
    from .tools import chrom_depth_estimate
    return chrom_depth_estimate(batch, chrom_len)


def run_germline(argv=None) -> int:
    p = argparse.ArgumentParser(prog="strelka_tpu_torch germline")
    p.add_argument("--reference", required=True)
    p.add_argument("--align-file", action="append", required=True, dest="align_files")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--region", action="append", default=None)
    p.add_argument("--indel-candidates", action="append", default=None)
    p.add_argument("--forced-gt", action="append", default=None,
                   help="VCF(s) of alleles to always genotype and report")
    p.add_argument("--ploidy-region-vcf", default=None,
                   help="VCF with per-sample CN (0/1) regions for "
                        "non-diploid calling")
    p.add_argument("--rna", action="store_true",
                   help="RNA-seq mode: het variant-frequency extension "
                        "0.45 + RNA scoring models")
    p.add_argument("--snv-scoring-model-file", default=None,
                   help="germline SNV EVS model JSON")
    p.add_argument("--indel-scoring-model-file", default=None,
                   help="germline indel EVS model JSON")
    p.add_argument("--disable-evs", action="store_true",
                   help="disable empirical variant scoring; hard "
                        "filters apply (reference --disableEVS)")
    p.add_argument("--report-evs-features", action="store_true",
                   help="append ;EVSF=<scoring features> to variant "
                        "records for offline EVS training "
                        "(reference --reportEVSFeatures; development "
                        "features are not included)")
    p.add_argument("--output-realigned-bam", action="store_true",
                   help="write per-sample realigned.SN.bam with the "
                        "post-realignment alignments (reference "
                        "--realigned-read-file)")
    p.add_argument("--min-mapping-quality", type=int, default=20)
    p.add_argument("--max-region-size", type=int, default=1_000_000)
    p.add_argument("--exome", action="store_true",
                   help="disable depth filters (exome/targeted mode)")
    p.add_argument("--call-regions-bed", default=None,
                   help="BED of regions to call (everything else is "
                        "skipped; reference --callRegions)")
    p.add_argument("--nocompress-bed", default=None,
                   help="BED of positions always emitted as individual "
                        "gVCF sites (reference --noCompress)")
    p.add_argument("--call-continuous-vf", action="append", default=None,
                   help="chromosome(s) to call in continuous "
                        "variant-frequency mode (e.g. chrM)")
    p.add_argument("--indel-error-models-file", action="append",
                   default=None, dest="indel_error_models_files",
                   help="per-sample adaptive indel error model JSON(s) "
                        "(as produced by --estimate-sequence-error)")
    p.add_argument("--estimate-sequence-error", action="store_true",
                   help="fit per-sample adaptive indel error models "
                        "before calling (EstimateSequenceError workflow; "
                        "the fits run on --device)")
    p.add_argument("--use-all-data-for-sequence-error-estimation",
                   action="store_true", dest="error_all_data",
                   help="count every input region instead of stopping "
                        "at the observation target (reference "
                        "--useAllDataForSequenceErrorEstimation)")
    p.add_argument("--error-count-target", type=int, default=25_000_000,
                   help="stop counting once this many context instances "
                        "are collected (dynamic early-stop)")
    p.add_argument("--process-index", type=int, default=None,
                   help="this worker's index for local multi-process "
                        "fan-out (pyflow-style); run one process per "
                        "index 0..count-1, then --merge-only")
    p.add_argument("--process-count", type=int, default=None)
    rn.add_fanout_args(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scoring kernel and the SNV tiles run "
                        "(default cuda; cuda without a GPU is an error)")
    rn.add_mesh_arg(p)
    p.add_argument("--config", default=None,
                   help="reference-style ini file overriding caller "
                        "options (configureStrelkaGermlineWorkflow.py.ini)")
    p.add_argument("--dry-run", action="store_true",
                   help="list the task schedule (incl. resume state) "
                        "and exit without calling (pyflow --dryRun)")
    p.add_argument("--merge-only", action="store_true",
                   help="skip calling; concatenate existing workspace "
                        "fragments into final outputs")
    args = p.parse_args(argv)

    args.evs_models = evs_models(args, p.error)
    return rn.dispatch("strelka_tpu_torch.workflow.germline", args, argv,
                       _run_germline)


def evs_models(args, error) -> tuple:
    """The germline EVS models to score with, (SNV, indel), each a
    (model JSON, category) or None: the JAX package's rule
    (strelka_tpu/workflow/germline.py:186-226). --disable-evs scores
    nothing. --rna takes the RNAseq models of the flags or of
    $STRELKA_TPU_MODEL_DIR (RNA{SNV,Indel}ScoringModels.json) and calls
    `error` where either is missing; otherwise each flag's file scores
    its type under the file's first category."""
    if args.disable_evs:
        return None, None
    if args.rna:
        cfg = os.environ.get("STRELKA_TPU_MODEL_DIR")
        paths = (args.snv_scoring_model_file
                 or (cfg and os.path.join(cfg, "RNASNVScoringModels.json")),
                 args.indel_scoring_model_file
                 or (cfg and os.path.join(cfg, "RNAIndelScoringModels.json")))
        for label, path in zip(("SNV", "indel"), paths):
            if not path or not os.path.exists(path):
                error(f"--rna requires an {label} EVS model: pass "
                      "--snv-scoring-model-file/--indel-scoring-model-file,"
                      " set $STRELKA_TPU_MODEL_DIR to a directory with "
                      "RNA{SNV,Indel}ScoringModels.json, or pass "
                      "--disable-evs")
        return tuple((path, "RNAseq") for path in paths)
    return tuple((path, None) if path else None
                 for path in (args.snv_scoring_model_file,
                              args.indel_scoring_model_file))


def estimate_sequence_error(args, ref, regions, batches_per_chrom,
                            n_samples: int) -> list[str]:
    """The --estimate-sequence-error pre-pass of the JAX package
    (strelka_tpu/workflow/germline.py:326-367): per sample, count the
    STR-context indel observations region by region on the host until
    --error-count-target instances (unless
    --use-all-data-for-sequence-error-estimation), write the merged
    counts (sequenceAlleleCounts.Sample*.npz), fit the adaptive indel
    error model on --device and write it
    (sequenceErrorModel.Sample*.json). Returns the model paths. A
    --merge-only run skips it (its workers wrote the files, and it
    touches no device), where the JAX package runs it again."""
    import json as _json

    from ..models.error_fit import estimate_indel_error_model
    from ..pipeline import allele_counts as ac
    from ..pipeline import reads as rdm
    estimated_paths = []
    for si in range(n_samples):
        per_region = []
        total_instances = 0
        for chrom, beg, end in regions:
            b = batches_per_chrom.get(chrom, [None] * n_samples)[si]
            if b is None or b.n == 0:
                continue
            keep, level = rdm.filter_and_classify_reads(
                b, args.min_mapping_quality)
            bk = b.select(keep)
            ea = rdm.expand_alignments(bk)
            rc = ref.fetch(chrom, beg, end)
            cc = ac.collect_context_counts(bk, ea, level[keep], rc, beg,
                                           beg, end)
            per_region.append(cc)
            total_instances += sum(c.total_instances for c in cc.values())
            if (not args.error_all_data
                    and total_instances >= args.error_count_target):
                break  # dynamic early stop
        merged = ac.merge_context_counts(per_region)
        ac.save_context_counts(
            os.path.join(args.output_dir,
                         f"sequenceAlleleCounts.Sample{si:03d}.npz"),
            merged)
        model, ok = estimate_indel_error_model(
            merged, sample_name=f"Sample{si:03d}", device=args.device)
        path = os.path.join(args.output_dir,
                            f"sequenceErrorModel.Sample{si:03d}.json")
        with open(path, "w") as f:
            _json.dump(model, f, indent=1)
        print(f"error model sample {si}: acceptable={ok} -> {path}",
              file=sys.stderr)
        estimated_paths.append(path)
    return estimated_paths


def _run_germline(args, argv) -> int:
    t0 = time.time()
    opt = GermlineOptions(min_mapping_quality=args.min_mapping_quality)
    if args.rna:
        # strelkaGermlineWorkflow.py's RNA branch: het-VF extension 0.45
        opt = GermlineOptions(min_mapping_quality=args.min_mapping_quality,
                              het_variant_frequency_extension=0.45,
                              retain_optimal_soft_clipping=True)
    from ..ops.rf import load_scoring_model
    snv_forest, indel_forest = (
        None if m is None else load_scoring_model(m[0], kind, m[1])
        for m, kind in zip(args.evs_models, ("SNV", "INDEL")))
    if args.config:
        from ..options import apply_ini
        opt, ini_extras = apply_ini(opt, args.config)
        if ini_extras.get("is_write_realigned_bam"):
            args.output_realigned_bam = True
    ref = FastaReference(args.reference)
    os.makedirs(args.output_dir, exist_ok=True)
    opt.is_report_evs_features = args.report_evs_features
    opt.cmdline = ("strelka_tpu_torch germline "
                   + " ".join(argv if argv is not None else sys.argv[1:]))
    opt.reference_path = args.reference
    workspace = os.path.join(args.output_dir, "workspace")

    regions = ([parse_region(r, ref) for r in args.region] if args.region
               else [(c, 0, ref.contig_length(c)) for c in ref.contig_names])
    if args.call_regions_bed:
        from ..io.bed import read_bed
        bed_by_chrom: dict[str, list] = {}
        for rec in read_bed(args.call_regions_bed):
            bed_by_chrom.setdefault(rec.chrom, []).append((rec.begin, rec.end))
        clipped = []
        for chrom, beg, end in regions:
            for b0, e0 in sorted(bed_by_chrom.get(chrom, [])):
                lo, hi = max(beg, b0), min(end, e0)
                if lo < hi:
                    clipped.append((chrom, lo, hi))
        regions = clipped
        if not regions:
            print("call-regions BED leaves nothing to call",
                  file=sys.stderr)
            return 0

    nocompress_by_chrom: dict[str, list] = {}
    if args.nocompress_bed:
        from ..io.bed import read_bed
        for rec in read_bed(args.nocompress_bed):
            nocompress_by_chrom.setdefault(rec.chrom, []).append(
                (rec.begin, rec.end))

    # --- segment plan (before input reads, so fan-out processes can
    # use the BAM index to load only their assigned spans) -------------
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

    # spans this process actually calls (halo'd, merged): indexed input
    # reads load only these when the input is a proper genome subset
    # (reference analog: starling_run.cpp:335-342 supplemental border +
    # bam_streamer region open per 12Mb segment process)
    my_groups = [g for i, g in enumerate(groups)
                 if i % max(proc_cnt, 1) == proc_idx]
    needed_spans = rn.merge_group_spans(my_groups, seg_halo,
                                        {c: ref.contig_length(c)
                                         for c, _b, _e in regions})
    whole_genome = (args.region is None and proc_cnt <= 1
                    and not args.call_regions_bed)

    sample_names = []
    batches_per_chrom: dict[str, list] = {}
    for path in args.align_files:
        name = os.path.basename(path).split(".")[0]
        sample_names.append(name)
    headers = []
    for si, path in enumerate(args.align_files):
        hdr, batch = None, None
        if not whole_genome:
            try:
                from ..io.bam import read_alignments_regions
                hdr, batch = read_alignments_regions(path, needed_spans, ref)
            except (FileNotFoundError, ValueError):
                hdr = batch = None  # no usable index: whole-file read
        if batch is None:
            hdr, batch = read_alignments(path, ref)
        headers.append(hdr)
        for tid, cname in enumerate(hdr.ref_names):
            lst = batches_per_chrom.setdefault(cname, [None] * len(args.align_files))
            lst[si] = batch.select(np.asarray(batch.tid == tid))

    # input consistency validation (checkChromSet.py:144-211)
    from .validation import ConfigurationError, check_chrom_set
    try:
        check_chrom_set(ref, headers, labels=list(args.align_files))
    except ConfigurationError as e:
        print(f"\nCONFIGURATION ERROR:\n{e}\n", file=sys.stderr)
        return 1

    n_samples = len(sample_names)

    # --- optional sequence error estimation pre-pass -------------------
    # (strelkaSequenceErrorEstimation.py: count until target reached,
    # merge, fit; static-model fallback when the fit is unacceptable)
    if args.estimate_sequence_error and not args.merge_only:
        estimated = estimate_sequence_error(args, ref, regions,
                                            batches_per_chrom, n_samples)
        if args.indel_error_models_files is None:
            args.indel_error_models_files = estimated

    # --- chromosome depth (feeds HighDepth filter) ---------------------
    chrom_depth: dict[str, float] = {}
    if not args.exome:
        for chrom, _b, _e in regions:
            depths = [estimate_chrom_depth(
                batches_per_chrom.get(chrom, [None] * n_samples)[si],
                args.min_mapping_quality, ref.contig_length(chrom))
                for si in range(n_samples)]
            chrom_depth[chrom] = float(np.mean([d for d in depths if d > 0]) or 0)

    # --- segment tasks through the runner ------------------------------
    runner = rn.SegmentRunner(workspace, process_index=proc_idx,
                              process_count=proc_cnt)

    continuous_chroms = set(args.call_continuous_vf or [])

    # per-chrom read ref-end positions: each segment task slices the
    # chromosome batch down to reads overlapping its halo'd window, so
    # per-segment work stays O(segment reads) instead of O(chrom reads)
    ref_ends_per_chrom = {
        c: [b.ref_end_positions() if b is not None else None for b in bl]
        for c, bl in batches_per_chrom.items()}

    def task_fn(group):
        lines_v = []
        lines_g = [[] for _ in range(n_samples)]
        stats = rn.RunStats()
        for seg in group:
            full_batches = batches_per_chrom.get(seg.chrom)
            if full_batches is None:
                continue
            ref_ends = ref_ends_per_chrom[seg.chrom]
            batches = []
            for b, re_arr in zip(full_batches, ref_ends):
                if b is None or b.n == 0:
                    batches.append(b)
                    continue
                m = (re_arr > seg.begin - seg_halo) & \
                    (b.pos < seg.end + seg_halo)
                batches.append(b.select(m) if not m.all() else b)
            if seg.chrom in continuous_chroms:
                from ..pipeline import continuous_caller as cc
                for si in range(n_samples):
                    res = cc.call_continuous_region(
                        opt, ref, seg.chrom, seg.begin, seg.end, batches[si])
                    clines = cc.emit_continuous_region(opt, res)
                    lines_g[si].extend(clines)
                    # reference blocks (ALT and QUAL ".") stay out of
                    # variants.vcf.gz
                    lines_v.extend(l for l in clines if "\t.\t.\t" not in
                                   "\t".join(l.split("\t")[3:6]))
                stats.reads_processed += sum(
                    int(((b.pos >= seg.begin) & (b.pos < seg.end)).sum())
                    for b in batches if b is not None)
                continue
            result = germline_caller.call_region(
                opt, ref, seg.chrom, seg.begin, seg.end, batches,
                external_indel_vcfs=args.indel_candidates,
                forced_gt_vcfs=args.forced_gt,
                ploidy_vcf=args.ploidy_region_vcf,
                collect_realigned=args.output_realigned_bam,
                indel_error_model_files=args.indel_error_models_files)
            if result.realigned is not None:
                # write per-segment realigned fragments to the
                # workspace so multi-process workers contribute too;
                # the merge step concatenates them in segment order
                from ..io.bam import scatter_rewrites
                from ..io.bam_writer import write_bam
                os.makedirs(workspace, exist_ok=True)
                for si in range(n_samples):
                    keep_idx, kb = result.realigned[si]
                    full = scatter_rewrites(batches[si], keep_idx, kb)
                    # batches[si] is the segment-sliced batch; keep_idx
                    # indexes it, so the scatter target matches
                    sel = (full.pos >= seg.begin) & (full.pos < seg.end)
                    frag = os.path.join(
                        workspace,
                        f"seg_{seg.label}.S{si + 1}.realigned.bam")
                    write_bam(frag, headers[si], full.select(sel))
            nc_mask = None
            ncs = nocompress_by_chrom.get(seg.chrom)
            if ncs:
                nc_mask = np.zeros(seg.end - seg.begin, dtype=bool)
                for b0, e0 in ncs:
                    lo, hi = max(seg.begin, b0), min(seg.end, e0)
                    if lo < hi:
                        nc_mask[lo - seg.begin:hi - seg.begin] = True
            gl, vl = gvcf.emit_region(opt, result, sample_names,
                                      chrom_depth=chrom_depth.get(seg.chrom),
                                      snv_forest=snv_forest,
                                      indel_forest=indel_forest,
                                      nocompress_mask=nc_mask)
            lines_v.extend(vl)
            for si in range(n_samples):
                lines_g[si].extend(gl[si])
            stats.candidate_indels += result.stats.get("n_candidate_indels", 0)
            stats.noncandidate_indels += (
                result.stats.get("n_indel_records", 0)
                - result.stats.get("n_candidate_indels", 0))
            stats.reads_processed += sum(
                int(((b.pos >= seg.begin) & (b.pos < seg.end)).sum())
                for b in batches if b is not None)
        return (lines_v, lines_g), stats

    def on_complete(gi, result):
        lines_v, lines_g = result
        with open(os.path.join(workspace, f"seg_{gi:06d}.variants.vcf"), "w") as f:
            f.write("\n".join(lines_v) + ("\n" if lines_v else ""))
        for si in range(n_samples):
            with open(os.path.join(workspace,
                                   f"seg_{gi:06d}.S{si+1}.gvcf"), "w") as f:
                f.write("\n".join(lines_g[si]) + ("\n" if lines_g[si] else ""))

    if args.dry_run:
        runner.dry_run(groups)
        return 0
    if not args.merge_only:
        runner.run(groups, task_fn, on_complete)
    if args.process_index is not None and not args.merge_only \
            and proc_cnt > 1:
        # worker shard done; a final --merge-only invocation concatenates
        print(rn.worker_done_line(proc_idx, proc_cnt,
                                  runner.stats.segments_completed),
              file=sys.stderr)
        return 0

    # --- ordered concat + bgzf (merge tasks) ---------------------------
    var_path = os.path.join(args.output_dir, "variants.vcf.gz")
    gvcf_paths = [os.path.join(args.output_dir, f"genome.S{si+1}.vcf.gz")
                  for si in range(n_samples)]
    chrom0 = regions[0][0]
    clen0 = ref.contig_length(chrom0)
    from ..io.tabix import IndexedVcfWriter
    all_chroms = list(ref.contig_names)

    def concat_indexed(path, header_text, frag_name_fn):
        with IndexedVcfWriter(path, all_chroms) as w:
            w.write_header(header_text)
            for gi in range(len(groups)):
                frag = os.path.join(workspace, frag_name_fn(gi))
                if os.path.exists(frag):
                    with open(frag) as f:
                        for line in f:
                            if line.strip():
                                w.write_record_line(line)

    concat_indexed(var_path,
                   gvcf.gvcf_header(opt, chrom0, clen0, sample_names),
                   lambda gi: f"seg_{gi:06d}.variants.vcf")
    for si in range(n_samples):
        concat_indexed(gvcf_paths[si],
                       gvcf.gvcf_header(opt, chrom0, clen0, [sample_names[si]]),
                       lambda gi, si=si: f"seg_{gi:06d}.S{si+1}.gvcf")

    if args.output_realigned_bam:
        from ..io.bam import concat_batches
        from ..io.bam_writer import write_bam
        for si in range(n_samples):
            frags = []
            for seg in segments:
                frag = os.path.join(
                    workspace, f"seg_{seg.label}.S{si + 1}.realigned.bam")
                if os.path.exists(frag):
                    frags.append(read_bam(frag)[1])
            if not frags:
                continue
            merged = concat_batches(frags)
            out_bam = os.path.join(args.output_dir,
                                   f"realigned.S{si + 1}.bam")
            write_bam(out_bam, headers[si], merged)
            print(f"realigned reads: {out_bam} ({merged.n} records)",
                  file=sys.stderr)

    total_stats = rn.merge_run_stats(workspace)
    with open(os.path.join(args.output_dir, "runStats.xml"),
              "w") as _sf:
        _sf.write(total_stats.to_xml())
    from ..utils.flowlog import merge_worker_logs
    surfaced = merge_worker_logs(
        workspace, os.path.join(args.output_dir, "workflow.log"))
    for line in surfaced["warnings"] + surfaced["errors"]:
        print(line, file=sys.stderr)
    elapsed = time.time() - t0
    where = "merge" if args.merge_only else f"on {devmod.current()}"
    print(f"strelka_tpu_torch germline {where} done in "
          f"{elapsed:.1f}s; "
          f"stats={total_stats.to_dict()}; outputs: {var_path}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(run_germline())
