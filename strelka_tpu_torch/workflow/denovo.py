"""De novo variant quality scoring for trios.

Reference: src/python/deNovoQualityScore/denovo.py (1181 LoC; posterior
re-scoring of proband gVCF sites from trio PLs). Re-designed batched:
all trio-complete biallelic sites are scored in one vectorized pass —
genotype likelihoods from PLs, Mendelian transmission with mutation
rate, posterior mass on de-novo configurations -> DQ phred score added
to the proband records.

Port of strelka_tpu/workflow/denovo.py: the same options, messages,
outputs and exit codes (python -m strelka_tpu_torch denovo ...). It is
host code in both packages, float64 numpy with the same summation
order, so DQ is the JAX package's bit for bit; it takes no --device.
"""
from __future__ import annotations

import argparse
import gzip
import sys

import numpy as np

# diploid biallelic genotypes: 0=ref/ref 1=ref/alt 2=alt/alt
_GT_ALLELES = np.array([[0, 0], [0, 1], [1, 1]])


def transmission_matrix(mu: float = 1e-8) -> np.ndarray:
    """P(child gt | mother gt, father gt) with mutation rate mu.

    t[m, f, c]: Mendelian transmission of one allele from each parent,
    each transmitted allele flipping with probability mu.
    """
    t = np.zeros((3, 3, 3))
    for m in range(3):
        for f in range(3):
            # allele transmission distribution per parent
            pm = np.zeros(2)
            for a in _GT_ALLELES[m]:
                pm[a] += 0.5
            pf = np.zeros(2)
            for a in _GT_ALLELES[f]:
                pf[a] += 0.5
            # mutation flips the transmitted allele
            pm = pm * (1 - mu) + pm[::-1] * mu
            pf = pf * (1 - mu) + pf[::-1] * mu
            for am in range(2):
                for af in range(2):
                    c = am + af
                    t[m, f, c] += pm[am] * pf[af]
    return t


def denovo_posterior(child_pl, mother_pl, father_pl, theta: float = 0.001,
                     mu: float = 1e-8):
    """[N] posterior probability that the child's alt allele is de novo.

    PLs are [N, 3] phred-scaled genotype likelihoods. Parent-pair prior
    from theta (population polymorphism rate); the de-novo posterior is
    the mass of (mother, father, child) configurations whose
    transmission requires at least one allele mutation — any Mendelian
    violation, not only hom-ref x hom-ref parents (e.g. a 1/1 child of
    a 1/1 mother and 0/0 father is a paternal de novo; DeNovoGear's
    pp_dnm counts these, validated against the reference's shipped
    dng-auto-ref vectors in tests/test_denovo.py).
    """
    def pl_to_lh(pl):
        return np.power(10.0, -np.asarray(pl, dtype=np.float64) / 10.0)

    lc = pl_to_lh(child_pl)
    lm = pl_to_lh(mother_pl)
    lf = pl_to_lh(father_pl)

    gt_prior = np.array([1.0 - 3 * theta / 2, theta, theta / 2])
    t = transmission_matrix(mu)
    # mutation-requiring transmission mass: total minus the mu=0 part
    t_mut = t - transmission_matrix(0.0)

    def joint_with(trans):
        return (lm[:, :, None, None] * gt_prior[None, :, None, None]
                * lf[:, None, :, None] * gt_prior[None, None, :, None]
                * lc[:, None, None, :] * trans[None, :, :, :])

    total = joint_with(t).sum(axis=(1, 2, 3))
    dn = joint_with(t_mut).sum(axis=(1, 2, 3))
    with np.errstate(divide="ignore", invalid="ignore"):
        p_dn = np.where(total > 0, dn / np.maximum(total, 1e-300), 0.0)
    return p_dn


def _read_gvcf_sites(path):
    """(variant sites with PLs, hom-ref block list) from a gVCF.

    Blocks are [(chrom, begin1, end1, gqx)]; at sites covered only by
    a hom-ref block, hom-ref PLs are synthesized from the block GQX
    (the reference's denovo.py does the same for parents that are
    confidently hom-ref at the proband's candidate site)."""
    sites = {}
    blocks = []
    with gzip.open(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 10:
                continue
            fmt = fields[8].split(":")
            vals = fields[9].split(":")
            d = dict(zip(fmt, vals))
            if fields[4] in (".", ""):
                # hom-ref site or block
                try:
                    gqx = int(float(d.get("GQX", "0")))
                except ValueError:
                    continue
                begin = int(fields[1])
                end = begin
                for kv in fields[7].split(";"):
                    if kv.startswith("END="):
                        end = int(kv[4:])
                blocks.append((fields[0], begin, end, gqx))
                continue
            if "PL" not in d:
                continue
            pls = [int(x) for x in d["PL"].split(",")[:3]]
            if len(pls) < 3:
                continue
            sites[(fields[0], int(fields[1]))] = (fields, pls)
    return sites, blocks


def _homref_pl_at(blocks_by_chrom, key):
    """Synthesized hom-ref PL triplet when a block covers the site."""
    import bisect

    chrom, pos = key
    entry = blocks_by_chrom.get(chrom)
    if not entry:
        return None
    starts, rows = entry
    i = bisect.bisect_right(starts, pos) - 1
    if i < 0:
        return None
    _b, e, gqx = rows[i]
    if pos > e:
        return None
    return [0, max(int(gqx), 0), 2 * max(int(gqx), 0)]


def _run_denovo_multisample(args) -> int:
    """Reference-style interface (denovo.py:1040-1070): one
    multi-sample VCF + pedigree sample IDs -> DQ-annotated VCF. PLs are
    taken from the biallelic diploid FORMAT fields of the three named
    sample columns; records where any trio member lacks a 3-value PL
    pass through unscored."""
    from ..io.bgzf import BgzfWriter

    opener = gzip.open if args.vcf.endswith(".gz") else open
    n_scored = 0
    with opener(args.vcf, "rt") as fin, BgzfWriter(args.output) as w:
        cols = None
        for line in fin:
            if line.startswith("##"):
                w.write(line.encode())
                continue
            if line.startswith("#CHROM"):
                w.write(b'##INFO=<ID=DQ,Number=1,Type=Float,'
                        b'Description="Phred-scaled de novo quality">\n')
                w.write(line.encode())
                names = line.rstrip("\n").split("\t")[9:]
                try:
                    cols = [names.index(s) for s in
                            (args.proband_id, args.mother_id,
                             args.father_id)]
                except ValueError as e:
                    print(f"denovo: sample not in VCF: {e}",
                          file=sys.stderr)
                    return 1
                continue
            fields = line.rstrip("\n").split("\t")
            # records before #CHROM or without FORMAT+sample columns
            # pass through unscored
            if cols is None or len(fields) < 10 + max(cols):
                w.write(line.encode())
                continue
            fmt = fields[8].split(":")
            pls = None
            if "PL" in fmt and len(fields[4].split(",")) == 1 \
                    and fields[4] != ".":
                pi = fmt.index("PL")
                pls = []
                for c in cols:
                    sub = fields[9 + c].split(":")
                    if pi >= len(sub):
                        pls = None
                        break
                    vals = sub[pi].split(",")
                    if len(vals) != 3 or "." in vals:
                        pls = None
                        break
                    pls.append([int(v) for v in vals])
            if pls is not None:
                p_dn = denovo_posterior(
                    np.array([pls[0]]), np.array([pls[1]]),
                    np.array([pls[2]]))[0]
                tiny = np.finfo(np.float64).tiny
                dq = min(round(-10 * np.log10(max(1 - p_dn, tiny))), 999)
                if dq >= args.min_dq:
                    fields[7] = (f"{fields[7]};DQ={dq:.0f}"
                                 if fields[7] != "." else f"DQ={dq:.0f}")
                    n_scored += 1
            w.write(("\t".join(fields) + "\n").encode())
    print(f"denovo: scored {n_scored} trio records -> {args.output}",
          file=sys.stderr)
    return 0


def run_denovo(argv=None) -> int:
    p = argparse.ArgumentParser(prog="strelka_tpu_torch denovo")
    p.add_argument("--proband", help="proband gVCF (per-sample mode)")
    p.add_argument("--mother", help="mother gVCF (per-sample mode)")
    p.add_argument("--father", help="father gVCF (per-sample mode)")
    p.add_argument("--vcf", help="multi-sample VCF (reference-style "
                                 "mode; use --proband-id/--mother-id/"
                                 "--father-id)")
    p.add_argument("--proband-id")
    p.add_argument("--mother-id")
    p.add_argument("--father-id")
    p.add_argument("--output", required=True)
    p.add_argument("--min-dq", type=float, default=0.0)
    args = p.parse_args(argv)

    if args.vcf:
        if not (args.proband_id and args.mother_id and args.father_id):
            p.error("--vcf requires --proband-id/--mother-id/--father-id")
        return _run_denovo_multisample(args)
    if not (args.proband and args.mother and args.father):
        p.error("either --vcf or --proband/--mother/--father is required")

    child, _cb = _read_gvcf_sites(args.proband)
    mother, mb = _read_gvcf_sites(args.mother)
    father, fb = _read_gvcf_sites(args.father)

    def index_blocks(blocks):
        by = {}
        for chrom, b, e, gqx in blocks:
            by.setdefault(chrom, []).append((b, e, gqx))
        return {c: ([r[0] for r in sorted(rows)], sorted(rows))
                for c, rows in by.items()}

    mbi = index_blocks(mb)
    fbi = index_blocks(fb)

    def parent_pl(parent_sites, blocks_idx, k):
        if k in parent_sites:
            return parent_sites[k][1]
        return _homref_pl_at(blocks_idx, k)

    trio = []
    for k in child:
        mp = parent_pl(mother, mbi, k)
        fp = parent_pl(father, fbi, k)
        if mp is not None and fp is not None:
            trio.append((k, mp, fp))
    keys = [k for k, _m, _f in trio]
    if keys:
        cpl = np.array([child[k][1] for k in keys])
        mpl = np.array([m for _k, m, _f in trio])
        fpl = np.array([f for _k, _m, f in trio])
        p_dn = denovo_posterior(cpl, mpl, fpl)
        tiny = np.finfo(np.float64).tiny
        dq = np.minimum(np.round(-10 * np.log10(np.maximum(1 - p_dn, tiny))), 999)
    else:
        dq = np.zeros(0)

    from ..io.bgzf import BgzfWriter
    dq_of = dict(zip(keys, dq))
    n_scored = 0
    with gzip.open(args.proband, "rt") as fin, BgzfWriter(args.output) as w:
        for line in fin:
            if line.startswith("##"):
                w.write(line.encode())
                continue
            if line.startswith("#CHROM"):
                w.write(b'##INFO=<ID=DQ,Number=1,Type=Float,'
                        b'Description="Phred-scaled de novo quality">\n')
                w.write(line.encode())
                continue
            fields = line.rstrip("\n").split("\t")
            key = (fields[0], int(fields[1]))
            if key in dq_of and dq_of[key] >= args.min_dq:
                fields[7] = (f"{fields[7]};DQ={dq_of[key]:.0f}"
                             if fields[7] != "." else f"DQ={dq_of[key]:.0f}")
                n_scored += 1
            w.write(("\t".join(fields) + "\n").encode())
    print(f"denovo: scored {n_scored} trio sites -> {args.output}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(run_denovo())
