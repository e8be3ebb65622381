"""The records a job wrote, against what the generator planted.

Numbers a job (each is worse when higher, and ``correct`` holds the
worst job of the window to each one's limit):

- germline: ``snv_miss`` and ``indel_miss``, the shares of planted SNVs
  and indels with no PASS record in ``variants.vcf.gz``;
  ``gt_disagree``, the share of the found sites whose genotype is not
  the planted one (0/1 on one haplotype, 1/1 on both);
  ``false_pass_per_mb``, PASS records that match nothing planted, a
  million bases; ``gvcf_gap``, the larger of the share of the contig's
  bases that no record of the gVCF (``genome.S1.vcf.gz``) covers and the
  share of the variant records that the gVCF lacks;
- somatic: ``somatic_miss``, the share of planted somatic SNVs and
  indels with no PASS record in ``somatic.snvs.vcf.gz`` or
  ``somatic.indels.vcf.gz``; ``somatic_false_pass_per_mb``.

An SNV matches by position and alleles, an indel by its length change
within 25 bases (an aligner may shift it along a repeat).
"""
from __future__ import annotations

import gzip
import os

import numpy as np

GVCF = "genome.S1.vcf.gz"


def _lines(path):
    if not os.path.exists(path):
        return []
    with gzip.open(path, "rt") as f:
        return [ln.rstrip("\n").split("\t") for ln in f
                if not ln.startswith("#")]


def _calls(rows, only_pass=True):
    """(0-based pos, ref, alt, genotype) of each alt allele."""
    out = []
    for c in rows:
        if only_pass and c[6] != "PASS":
            continue
        if c[4] == ".":
            continue
        gt = ""
        if len(c) > 9:
            keys = c[8].split(":")
            if "GT" in keys:
                gt = c[9].split(":")[keys.index("GT")]
        for alt in c[4].split(","):
            out.append((int(c[1]) - 1, c[3], alt, gt.replace("|", "/")))
    return out


def _match(planted, calls):
    """(found, genotype agrees, calls that match nothing planted)."""
    exact = {(p, r, a): gt for p, r, a, gt in calls}
    used, found, agree = set(), 0, 0
    by_len: dict[int, list] = {}
    for p, r, a, gt in calls:
        if len(r) != len(a):
            by_len.setdefault(len(a) - len(r), []).append((p, r, a, gt))
    for v in planted:
        key = (v.pos, v.ref, v.alt)
        hit = key if key in exact else None
        if hit is None and v.kind != "snv":
            for p, r, a, _gt in by_len.get(len(v.alt) - len(v.ref), []):
                if abs(p - v.pos) <= 25 and (p, r, a) not in used:
                    hit = (p, r, a)
                    break
        if hit is None:
            continue
        used.add(hit)
        found += 1
        want = "1/1" if len(v.haps) == 2 else "0/1"
        agree += exact.get(hit, "") == want
    false = sum((p, r, a) not in used for p, r, a, _gt in calls)
    return found, agree, false


def gvcf_gap(rows_g, rows_v, contig_bp: int) -> float:
    """The larger of the share of bases no gVCF record covers and the
    share of variant records missing from the gVCF."""
    cover = np.zeros(contig_bp, dtype=bool)
    for c in rows_g:
        beg = int(c[1]) - 1
        end = beg + len(c[3])
        for kv in c[7].split(";"):
            if kv.startswith("END="):
                end = int(kv[4:])
        cover[max(beg, 0):min(end, contig_bp)] = True
    uncovered = 1.0 - cover.mean() if contig_bp else 0.0
    have = {(c[1], c[3], c[4]) for c in rows_g if c[4] != "."}
    want = [(c[1], c[3], c[4]) for c in rows_v]
    lost = sum(w not in have for w in want) / len(want) if want else 0.0
    return float(max(uncovered, lost))


def job_numbers(config: dict, genome, keep: str) -> dict:
    """The numbers of one job's records in directory `keep`."""
    mb = len(genome.ref) / 1e6
    if config["mode"] == "germline":
        rows_v = _lines(os.path.join(keep, "variants.vcf.gz"))
        calls = _calls(rows_v)
        snv = [v for v in genome.germline if v.kind == "snv"]
        ind = [v for v in genome.germline if v.kind != "snv"]
        f_s, a_s, _ = _match(snv, calls)
        f_i, a_i, _ = _match(ind, calls)
        _f, _a, false = _match(genome.germline, calls)
        rows_g = _lines(os.path.join(keep, GVCF))
        return {"snv_miss": 1.0 - f_s / max(len(snv), 1),
                "indel_miss": 1.0 - f_i / max(len(ind), 1),
                "gt_disagree": 1.0 - (a_s + a_i) / max(f_s + f_i, 1),
                "false_pass_per_mb": false / mb,
                "gvcf_gap": gvcf_gap(rows_g, rows_v, len(genome.ref))}
    calls = (_calls(_lines(os.path.join(keep, "somatic.snvs.vcf.gz")))
             + _calls(_lines(os.path.join(keep, "somatic.indels.vcf.gz"))))
    found, _a, false = _match(genome.somatic, calls)
    return {"somatic_miss": 1.0 - found / max(len(genome.somatic), 1),
            "somatic_false_pass_per_mb": false / mb}


def numbers(config: dict, genome, keeps: list[str]) -> dict:
    """{number: (worst over the jobs, jobs read)}."""
    out: dict[str, tuple] = {}
    for keep in keeps:
        for k, v in job_numbers(config, genome, keep).items():
            worst, n = out.get(k, (0.0, 0))
            out[k] = (max(worst, v), n + 1)
    return out
