"""Small workflow utility tools.

Reference: src/python/libexec/ — extractSmallIndelCandidates.py,
sortVcf.py, mergeChromDepth.py, updateNoPassedVariantGTsFilter.py,
vcfCmdlineSwapper.py, cat.py. These support the workflow's merge and
candidate-ingestion steps.

Port of strelka_tpu/workflow/tools.py: the same twelve tools, usage
text and exit codes (python -m strelka_tpu_torch tools <tool> ...).
Every tool is host code but estimate-parameters, whose fits
(models/error_zoo.py) run on --device cuda|cpu (default cuda).
"""
from __future__ import annotations

import gzip
import os
import sys


def _open_text(path):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    return gzip.open(path, "rt") if magic == b"\x1f\x8b" else open(path)


def extract_small_indel_candidates(in_vcf: str, out_vcf: str,
                                   max_size: int = 49) -> int:
    """Manta (or other SV) VCF -> small-indel candidate VCF
    (extractSmallIndelCandidates.py: keep non-symbolic indels <=49bp)."""
    from ..io.bgzf import BgzfWriter
    n = 0
    with _open_text(in_vcf) as fin, BgzfWriter(out_vcf) as w:
        for line in fin:
            if line.startswith("#"):
                w.write(line.encode())
                continue
            fields = line.split("\t")
            ref, alts = fields[3], fields[4].split(",")
            keep = []
            for alt in alts:
                if alt.startswith("<") or ":" in alt or alt == ".":
                    continue  # symbolic / breakend
                if len(ref) == len(alt):
                    continue  # not an indel
                if max(len(ref), len(alt)) - 1 <= max_size:
                    keep.append(alt)
            if keep:
                fields[4] = ",".join(keep)
                w.write("\t".join(fields).encode())
                n += 1
    return n


def sort_vcf(in_vcf: str, out_vcf: str) -> None:
    """Coordinate-sort a VCF preserving headers (sortVcf.py)."""
    from ..io.bgzf import BgzfWriter
    headers, records = [], []
    with _open_text(in_vcf) as f:
        for line in f:
            (headers if line.startswith("#") else records).append(line)
    chrom_order: dict[str, int] = {}
    for h in headers:
        if h.startswith("##contig=<ID="):
            name = h.split("ID=")[1].split(",")[0].split(">")[0]
            chrom_order[name] = len(chrom_order)

    def key(line):
        f = line.split("\t", 2)
        return (chrom_order.get(f[0], len(chrom_order)), f[0], int(f[1]))

    records.sort(key=key)
    with BgzfWriter(out_vcf) as w:
        for line in headers + records:
            w.write(line.encode())


def update_no_passed_variant_gts_filter(in_vcf: str, out_vcf: str) -> int:
    """Re-evaluate the NoPassedVariantGTs locus filter after merges
    (updateNoPassedVariantGTsFilter.py): a locus passes when any sample
    has a variant GT with FT=PASS."""
    from ..io.bgzf import BgzfWriter
    n_changed = 0
    with _open_text(in_vcf) as fin, BgzfWriter(out_vcf) as w:
        for line in fin:
            if line.startswith("#") or not line.strip():
                w.write(line.encode())
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 10 or fields[4] in (".", ""):
                w.write(line.encode())
                continue
            fmt = fields[8].split(":")
            gt_i = fmt.index("GT") if "GT" in fmt else -1
            ft_i = fmt.index("FT") if "FT" in fmt else -1
            any_pass = False
            for col in fields[9:]:
                vals = col.split(":")
                gt = vals[gt_i] if gt_i >= 0 and gt_i < len(vals) else "."
                ft = vals[ft_i] if ft_i >= 0 and ft_i < len(vals) else "PASS"
                is_var = any(a not in ("0", ".", "") for a in
                             gt.replace("|", "/").split("/"))
                if is_var and ft == "PASS":
                    any_pass = True
                    break
            new_filter = "PASS" if any_pass else "NoPassedVariantGTs"
            if fields[6] in ("PASS", "NoPassedVariantGTs") and \
                    fields[6] != new_filter:
                fields[6] = new_filter
                n_changed += 1
            w.write(("\t".join(fields) + "\n").encode())
    return n_changed


def chrom_depth_estimate(batch, chrom_len: int,
                         cell_size: int = 16) -> float:
    """GetChromDepth estimator (ReadChromDepthUtil.cpp DepthTracker):
    each primary, non-duplicate mapped read adds depth over
    [pos, pos+read_size) assuming a perfect in-place alignment (no
    MAPQ filter); per-position depth reads through a 16-position
    compressed cell (depth_buffer.hh:129 rounded cell mean); the
    median is taken over nonzero positions in [first read pos, last
    read pos] with the between-values midpoint rule
    (MedianDepthTracker.hh)."""
    import numpy as np
    if batch is None or batch.n == 0:
        return 0.0
    # starling_read_filter_shared: drop qc-fail/dup/unmapped/
    # secondary/supplementary
    flag = batch.flag
    keep = (flag & (0x4 | 0x100 | 0x200 | 0x400 | 0x800)) == 0
    pos = batch.pos[keep]
    if len(pos) == 0:
        return 0.0
    rsize = (batch.seq_off[1:] - batch.seq_off[:-1])[keep]
    n_cells = (chrom_len + 2 * cell_size) // cell_size + 1
    cells = np.zeros(n_cells, dtype=np.int64)
    # range-add [pos, pos+rsize) per read, accumulated per cell via a
    # per-position diff array folded into cells
    diff = np.zeros(n_cells * cell_size + 1, dtype=np.int64)
    np.add.at(diff, np.minimum(pos, n_cells * cell_size), 1)
    np.add.at(diff, np.minimum(pos + rsize, n_cells * cell_size), -1)
    perpos = np.cumsum(diff[:-1])
    cells = perpos.reshape(n_cells, cell_size).sum(axis=1)
    lo, hi = int(pos.min()), int(pos.max())
    obs_cells = np.arange(lo, hi + 1) // cell_size
    vals = (cells[obs_cells] + cell_size // 2) // cell_size
    vals = vals[vals > 0]
    if len(vals) == 0:
        return 0.0
    # MedianDepthTracker::getMedian with zero removal: when exactly
    # half the nonzero observations lie below the crossing value, the
    # median is the midpoint of the straddling values
    counts = np.bincount(vals.astype(np.int64))
    ztotal = len(vals) + 1
    s = 0
    last_before = 0
    first_after = 0
    for v in range(1, len(counts)):
        c = int(counts[v])
        if c == 0:
            continue
        s += c * 2
        if s >= ztotal:
            first_after = v
            if (ztotal + c * 2) != (s + 1):
                last_before = first_after
            break
        last_before = v
    if last_before == first_after:
        return float(last_before)
    return (last_before + first_after) / 2.0


def merge_chrom_depth(in_paths: list[str], out_path: str) -> None:
    """Merge per-chromosome depth files (mergeChromDepth.py)."""
    with open(out_path, "w") as out:
        for p in in_paths:
            with open(p) as f:
                out.write(f.read())


def get_region_depth(bam_path: str, region: str,
                     reference: str | None = None) -> float:
    """GetRegionDepth analog: chrom-depth estimator restricted to one
    region (chrom[:beg-end]). Accepts BAM or CRAM input."""
    import numpy as np

    from ..io.bam import read_alignments
    hdr, batch = read_alignments(bam_path, reference)
    if ":" in region:
        chrom, rng = region.split(":")
        beg, end = (int(x) for x in rng.replace(",", "").split("-"))
        beg -= 1
    else:
        chrom = region
        beg = 0
        end = hdr.ref_lengths[hdr.tid_of(chrom)]
    tid = hdr.tid_of(chrom)
    sel = (np.asarray(batch.tid) == tid) & (batch.pos >= beg) & \
        (batch.pos < end)
    return chrom_depth_estimate(batch.select(sel), end)


def dump_counts(path: str) -> None:
    """DumpSequenceAlleleCounts analog: readable summary of a counts
    file."""
    from ..pipeline.allele_counts import load_context_counts
    counts = load_context_counts(path)
    for (ps, rc) in sorted(counts):
        cc = counts[(ps, rc)]
        n_alt = int(cc.alt_obs.sum())
        print(f"pattern_size={ps} repeat_count={rc} "
              f"instances={cc.total_instances} "
              f"distinct_patterns={len(cc.ref_obs)} alt_obs={n_alt}")


def merge_counts(in_paths: list[str], out_path: str) -> None:
    """MergeSequenceAlleleCounts analog."""
    from ..pipeline.allele_counts import (load_context_counts,
                                          merge_context_counts,
                                          save_context_counts)
    merged = merge_context_counts([load_context_counts(p)
                                   for p in in_paths])
    save_context_counts(out_path, merged)


def vcf_cmdline_swapper(in_path: str, out_path: str, cmdline: str) -> None:
    """Replace or add the ##cmdline VCF header line
    (libexec/vcfCmdlineSwapper.py): an existing ##cmdline is replaced
    in place; otherwise the new line is inserted before #CHROM."""
    written = False
    with _open_text(in_path) as f, open(out_path, "w") as out:
        for line in f:
            if line.startswith("##cmdline="):
                out.write(f"##cmdline={cmdline}\n")
                written = True
            elif line.startswith("#CHROM") and not written:
                out.write(f"##cmdline={cmdline}\n")
                out.write(line)
                written = True
            else:
                out.write(line)


def cat_files(in_paths: list[str], out_path: str) -> None:
    """Portable concatenation (libexec/cat.py)."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as out:
        for p in in_paths:
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)


# the model names that fit on the device: (models/error_zoo's family,
# its indel type: insertions)
FITTED_MODELS = {
    "indelIndy": ("indy", True),
    "indelBinomialMixture": ("binom_mixture", True),
    "indelBetaBinomialInsert": ("beta_binomial", True),
    "indelBetaBinomialDelete": ("beta_binomial", False),
    "indelIndyNoOverlapInsert": ("indy_noovl", True),
    "indelIndyNoOverlapDelete": ("indy_noovl", False),
    "indelBinomialMixtureNoOverlapInsert": ("binom_mixture_noovl", True),
    "indelBinomialMixtureNoOverlapDelete": ("binom_mixture_noovl", False),
}


def estimate_parameters(counts_path: str, model: str,
                        lock_theta: bool = False, device=None) -> dict:
    """Research-grade error-model fits over a merged counts file
    (EstimateParametersFromAlleleCounts; models in
    models/error_zoo.py), on `device` (default: the current device): a
    fitted model's contexts all at once (error_zoo.fit_contexts: on a
    card every fit start side by side), indelModel1* on the host.
    Returns {context: fit dict}."""
    from ..models import error_zoo as ez
    from ..pipeline.allele_counts import load_context_counts

    counts = load_context_counts(counts_path)
    keys = sorted(counts)
    if not keys:
        return {}
    names = [f"unit{ps}_rep{rc}" for ps, rc in keys]
    if model in FITTED_MODELS:
        family, is_insert = FITTED_MODELS[model]
        fits = ez.fit_contexts(family, [counts[k] for k in keys], is_insert,
                               lock_theta, device=device)
        return dict(zip(names, fits))
    if model in ("indelModel1Insert", "indelModel1Delete"):
        return {name: ez.indel_model1_report(counts[k],
                                             model.endswith("Insert"))
                for name, k in zip(names, keys)}
    raise ValueError(f"unknown model: {model}")


def _take_device(rest: list[str]) -> tuple[list[str], str]:
    """(rest without its --device option, the device: default cuda)."""
    if "--device" not in rest:
        return rest, "cuda"
    i = rest.index("--device")
    if i + 1 >= len(rest) or rest[i + 1] not in ("cuda", "cpu"):
        raise SystemExit("estimate-parameters: --device takes cuda or cpu")
    return rest[:i] + rest[i + 2:], rest[i + 1]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("tools: extract-indel-candidates | sort-vcf | "
              "update-nopassed-filter | merge-chrom-depth | "
              "get-region-depth | dump-counts | merge-counts | "
              "estimate-parameters | validate-model | "
              "vcf-cmdline-swapper | evs-feature-csv | cat",
              file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "vcf-cmdline-swapper":
        vcf_cmdline_swapper(rest[0], rest[1], rest[2])
        return 0
    if cmd == "cat":
        cat_files(rest[:-1], rest[-1])
        return 0
    if cmd == "estimate-parameters":
        # estimate-parameters counts.npz [model] [--lock-theta]
        #                     [--device cuda|cpu]
        import json
        rest, device = _take_device(rest)
        model = rest[1] if len(rest) > 1 else "indelIndy"
        res = estimate_parameters(rest[0], model,
                                  lock_theta="--lock-theta" in rest,
                                  device=device)
        print(json.dumps(res, indent=1, sort_keys=True))
        return 0
    if cmd == "get-region-depth":
        ref = rest[2] if len(rest) > 2 else None
        print(f"{rest[1]}\t{get_region_depth(rest[0], rest[1], ref):.3f}")
        return 0
    if cmd == "dump-counts":
        dump_counts(rest[0])
        return 0
    if cmd == "merge-counts":
        merge_counts(rest[:-1], rest[-1])
        return 0
    if cmd == "extract-indel-candidates":
        n = extract_small_indel_candidates(rest[0], rest[1])
        print(f"kept {n} candidate records", file=sys.stderr)
        return 0
    if cmd == "sort-vcf":
        sort_vcf(rest[0], rest[1])
        return 0
    if cmd == "update-nopassed-filter":
        n = update_no_passed_variant_gts_filter(rest[0], rest[1])
        print(f"updated {n} records", file=sys.stderr)
        return 0
    if cmd == "validate-model":
        from ..models.schema import ModelValidationError, validate_model_file
        try:
            validate_model_file(rest[0], rest[1] if len(rest) > 1 else "evs")
        except ModelValidationError as e:
            print(str(e), file=sys.stderr)
            return 1
        print("valid", file=sys.stderr)
        return 0
    if cmd == "evs-feature-csv":
        # evs-feature-csv [--type SNV|INDEL] --tp a.vcf[.gz]...
        #                 --fp b.vcf... --out out.csv
        from ..training.evs_train import vcf_to_feature_csv
        vt = None
        out = None
        tp, fp = [], []
        cur = None
        i = 0
        while i < len(rest):
            a = rest[i]
            if a == "--type":
                vt = rest[i + 1]
                i += 2
            elif a == "--out":
                out = rest[i + 1]
                i += 2
            elif a == "--tp":
                cur = tp
                i += 1
            elif a == "--fp":
                cur = fp
                i += 1
            elif cur is None:
                print("evs-feature-csv: expected --tp/--fp before "
                      f"input path {a!r}", file=sys.stderr)
                return 2
            else:
                cur.append(a)
                i += 1
        if not out or not out.endswith(".csv"):
            print("evs-feature-csv: --out must name a .csv output "
                  "(refusing to overwrite a VCF input)", file=sys.stderr)
            return 2
        n = vcf_to_feature_csv(tp, fp, out, vt)
        print(f"wrote {n} labeled feature rows", file=sys.stderr)
        return 0
    if cmd == "merge-chrom-depth":
        merge_chrom_depth(rest[:-1], rest[-1])
        return 0
    print(f"unknown tool: {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
