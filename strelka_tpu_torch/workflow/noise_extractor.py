"""Panel site-noise extraction -> noise VCF.

Reference: applications/strelkaNoiseExtractor (snoise_pos_processor.cpp
:93-166) + snoiseWorkflow.py — scans panel BAMs and emits, per sample,
sites with non-reference noise that is too weak to be germline, as VCF
records the somatic caller's noise input consumes
(SiteNoise.cpp set_noise_from_vcf):

    CHROM POS . REF ALT . . . DP:AD  <used>:<ref>,<alt>  [per sample]

Per-sample gates (snoise_pos_processor.cpp):
  - >= 12 used basecalls at the site (min_used_calls)
  - unambiguous reference base
  - at least one non-reference call
  - top-alt fraction <= 0.2 ("too likely to be germline" above that)

The reference runs one extractor per BAM and panels are merged
externally (bcftools-style: absent samples print '.:.'); with several
--align-file inputs this tool emits that merged multi-sample panel
directly, so panels interchange with reference-produced ones in both
directions. The PNOISE/PNOISE2 INFO fields (the nfrac/n2frac fractions
SiteNoise computes at consumption time) are kept as an extension —
the reference declares these header lines (strelka_streams.cpp:156-157)
but computes the fractions only in memory.

Port of strelka_tpu/workflow/noise_extractor.py over the port's io.bam,
io.fasta, pipeline.reads and pipeline.pileup: the same gates, records,
header and messages (python -m strelka_tpu_torch noise-extractor ...).
It is host code in both packages and takes no --device.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io.bam import read_alignments
from ..io.bgzf import BgzfWriter
from ..io.fasta import FastaReference, decode_bases
from ..pipeline import pileup as pl
from ..pipeline import reads as rd

MIN_USED_CALLS = 12       # snoise_pos_processor.cpp:92
MAX_ALT_RATIO = 0.2       # :131


def run_noise_extractor(argv=None) -> int:
    p = argparse.ArgumentParser(prog="strelka_tpu_torch noise-extractor")
    p.add_argument("--reference", required=True)
    p.add_argument("--align-file", action="append", required=True,
                   dest="align_files", help="panel BAMs (one per sample)")
    p.add_argument("--output", required=True, help="noise VCF (.vcf.gz)")
    p.add_argument("--min-noise-count", type=int, default=1,
                   help="emit sites where at least this many panel "
                        "samples pass the noise gates")
    p.add_argument("--min-used-calls", type=int, default=MIN_USED_CALLS)
    p.add_argument("--min-mapping-quality", type=int, default=20)
    args = p.parse_args(argv)

    ref = FastaReference(args.reference)
    n_panel = len(args.align_files)

    lines = []
    for chrom in ref.contig_names:
        clen = ref.contig_length(chrom)
        rc = ref.load_contig(chrom)
        ref_ok = rc < 4
        rci = np.minimum(rc, 3)
        # per-sample site entries: (n_used, ref_count, alt_id, alt_count)
        per_sample = []
        for path in args.align_files:
            hdr, raw = read_alignments(path, ref)
            if chrom not in hdr.ref_names:
                per_sample.append(None)
                continue
            tid = hdr.ref_names.index(chrom)
            b = raw.select(np.asarray(raw.tid == tid))
            keep, level = rd.filter_and_classify_reads(
                b, args.min_mapping_quality)
            bk = b.select(keep)
            ea = rd.expand_alignments(bk)
            pu = pl.build_pileup(bk, ea, level[keep], rc, 0, clen,
                                 min_qscore=17)
            counts = pu.used_counts()                       # [L, 4]
            n_used = counts.sum(axis=1)
            ref_count = counts[np.arange(clen), rci]
            # top non-ref base per site (ties break to the lowest id,
            # matching the reference's scan order :114-120)
            masked = counts.copy()
            masked[np.arange(clen), rci] = -1
            alt_id = masked.argmax(axis=1)
            alt_count = masked[np.arange(clen), alt_id]
            ok = (ref_ok & (n_used >= args.min_used_calls)
                  & (ref_count != n_used)
                  & (alt_count <= MAX_ALT_RATIO * n_used))
            per_sample.append((ok, n_used, ref_count, alt_id, alt_count))

        live = [s for s in per_sample if s is not None]
        if not live:
            continue
        any_ok = np.zeros(clen, np.int32)
        for s in live:
            any_ok += s[0].astype(np.int32)
        for i in np.nonzero(any_ok >= args.min_noise_count)[0]:
            cols = []
            alt_votes = np.zeros(4, np.int64)
            noise = noise2 = 0
            for s in per_sample:
                if s is None or not s[0][i]:
                    cols.append(".:.")
                    continue
                _ok, n_used, ref_count, alt_id, alt_count = s
                cols.append(f"{n_used[i]}:{ref_count[i]},{alt_count[i]}")
                alt_votes[alt_id[i]] += alt_count[i]
                noise += 1
                if alt_count[i] > 1:
                    noise2 += 1
            alt = decode_bases([int(alt_votes.argmax())])
            pn = noise / n_panel
            pn2 = noise2 / n_panel
            lines.append(
                f"{chrom}\t{i + 1}\t.\t{decode_bases([rc[i]])}\t{alt}\t"
                f".\t.\tPNOISE={pn:.3f};PNOISE2={pn2:.3f}\tDP:AD\t"
                + "\t".join(cols))

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with BgzfWriter(args.output) as w:
        names = "\t".join(
            os.path.basename(p).rsplit(".", 1)[0] or f"S{i}"
            for i, p in enumerate(args.align_files))
        header = (
            "##fileformat=VCFv4.1\n"
            "##content=strelka_tpu site noise panel\n"
            '##INFO=<ID=PNOISE,Number=1,Type=Float,Description="Fraction of panel containing non-reference noise at this site">\n'
            '##INFO=<ID=PNOISE2,Number=1,Type=Float,Description="Fraction of panel containing more than one non-reference noise obs at this site">\n'
            '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Used basecall count">\n'
            '##FORMAT=<ID=AD,Number=2,Type=Integer,Description="Ref,alt used basecall counts">\n'
            f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{names}\n")
        w.write(header.encode())
        w.write(("\n".join(lines) + "\n").encode() if lines else b"")
    print(f"noise extractor: {len(lines)} sites -> {args.output}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(run_noise_extractor())
