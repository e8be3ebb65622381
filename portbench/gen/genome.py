"""Synthetic genomes and aligned reads from a seed, in NumPy.

A vectorised rewrite of the semantics of ``strelka_tpu_torch/synth.py``
(a random reference, planted variants, reads sampled from the
haplotypes at a depth, substitution errors), with the shapes of real
data that the copy fixes:

- SNVs and indels are drawn independently, each at its own mean
  spacing, and a share of the sites is hom-alt (both haplotypes);
- indel lengths follow a weight table (mostly 1-2 bp);
- base qualities fall into binned values (NovaSeq's four bins) and each
  base is wrong with the probability its quality states;
- a tumour adds somatic SNVs and indels at allele fractions drawn per
  site.

Every size is fixed by the configuration, not by the seed: the number
of reads is exact and the number of variant sites is the configured
count less the few that collide. What was planted is returned beside
the reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BASES = "ACGT"


@dataclass
class Variant:
    pos: int           # 0-based anchor: the SNV's base, an indel's left base
    kind: str          # "snv", "ins" or "del"
    ref: str
    alt: str
    haps: tuple        # haplotypes that carry it: (0,), (1,) or (0, 1)
    vaf: float = 1.0   # a somatic site's allele fraction in the tumour


@dataclass
class Genome:
    ref: np.ndarray                    # uint8 codes 0..3
    germline: list = field(default_factory=list)
    somatic: list = field(default_factory=list)


def _pick(rng, lo, hi, n):
    n = min(n, hi - lo)
    return np.sort(rng.choice(np.arange(lo, hi), n, replace=False))


def plant(rng, L: int, g: dict, som: dict | None, read_len: int) -> Genome:
    """A random reference of L bases and its variants: germline SNVs and
    indels at mean spacings g["snv_every"], g["indel_every"], hom-alt
    with probability g["hom_alt_share"], indel lengths by
    g["indel_len_weights"] (index 0 is 1 bp); with `som`, somatic SNVs
    and indels at som["snv_every"], som["indel_every"], allele fractions
    uniform in som["vaf"], placed a read length and more away from any
    germline indel so that reads over them align without a germline
    gap."""
    ref = rng.integers(0, 4, L).astype(np.uint8)
    margin = read_len + 50
    w = np.asarray(g["indel_len_weights"], np.float64)
    w /= w.sum()
    n_snv = L // g["snv_every"]
    n_ind = L // g["indel_every"]
    snv = _pick(rng, margin, L - margin, n_snv)
    ind = _pick(rng, margin, L - margin - 30, n_ind)
    ind_len = 1 + rng.choice(len(w), len(ind), p=w)
    ind_del = rng.random(len(ind)) < 0.5
    # a deletion's removed bases or an insertion's anchor keep a gap of
    # two bases from every other site; SNVs inside one are dropped
    spans = [(int(p), int(p + (k if d else 0)) + 2, "ind", i)
             for i, (p, k, d) in enumerate(zip(ind, ind_len, ind_del))]
    spans += [(int(p), int(p) + 2, "snv", i) for i, p in enumerate(snv)]
    spans.sort()
    kept, end = [], -1
    for beg, stop, kind, i in spans:
        if beg <= end:
            continue
        kept.append((kind, i))
        end = stop
    hom = rng.random(len(kept)) < g["hom_alt_share"]
    side = rng.integers(0, 2, len(kept))
    snv_shift = rng.integers(1, 4, len(snv))
    genome = Genome(ref=ref)
    for j, (kind, i) in enumerate(kept):
        haps = (0, 1) if hom[j] else (int(side[j]),)
        if kind == "snv":
            p = int(snv[i])
            a = (int(ref[p]) + int(snv_shift[i])) % 4
            genome.germline.append(Variant(p, "snv", BASES[ref[p]],
                                           BASES[a], haps))
            continue
        p, k = int(ind[i]), int(ind_len[i])
        if ind_del[i]:
            r = "".join(BASES[c] for c in ref[p:p + k + 1])
            genome.germline.append(Variant(p, "del", r, r[0], haps))
        else:
            ins = "".join(BASES[c] for c in rng.integers(0, 4, k))
            genome.germline.append(Variant(p, "ins", BASES[ref[p]],
                                           BASES[ref[p]] + ins, haps))
    if som:
        gaps = np.array(sorted(v.pos for v in genome.germline
                               if v.kind != "snv"), np.int64)
        taken = np.array(sorted(v.pos for v in genome.germline), np.int64)
        lo, hi = som["vaf"]

        def clear(p, dist):
            j = np.searchsorted(gaps, p)
            near = [gaps[x] for x in (j - 1, j) if 0 <= x < len(gaps)]
            t = np.searchsorted(taken, p)
            close = [taken[x] for x in (t - 1, t) if 0 <= x < len(taken)]
            return (all(abs(int(q) - p) > dist for q in near)
                    and all(abs(int(q) - p) > 3 for q in close))
        for kind, every in (("snv", som["snv_every"]),
                            ("ind", som["indel_every"])):
            cand = _pick(rng, margin + 30, L - margin - 30, L // every)
            vafs = rng.uniform(lo, hi, len(cand))
            lens = 1 + rng.choice(len(w), len(cand), p=w)
            dels = rng.random(len(cand)) < 0.5
            shift = rng.integers(1, 4, len(cand))
            bases = rng.integers(0, 4, (len(cand), len(w)))
            for i, p in enumerate(cand):
                p = int(p)
                if not clear(p, 2 * read_len + 30):
                    continue
                if kind == "snv":
                    a = (int(ref[p]) + int(shift[i])) % 4
                    genome.somatic.append(Variant(
                        p, "snv", BASES[ref[p]], BASES[a], (), float(vafs[i])))
                elif dels[i]:
                    r = "".join(BASES[c] for c in ref[p:p + lens[i] + 1])
                    genome.somatic.append(Variant(
                        p, "del", r, r[0], (), float(vafs[i])))
                else:
                    ins = "".join(BASES[c] for c in bases[i, :lens[i]])
                    genome.somatic.append(Variant(
                        p, "ins", BASES[ref[p]], BASES[ref[p]] + ins, (),
                        float(vafs[i])))
    return genome


def _codes(s: str) -> np.ndarray:
    return np.array([BASES.index(c) for c in s], np.uint8)


def haplotype(genome: Genome, h: int):
    """(bases, ref_pos, is_ins) of haplotype h: each haplotype base,
    the reference position it lies on (an inserted base: its anchor's)
    and whether it is inserted."""
    ref = genome.ref
    L = len(ref)
    base = ref.copy()
    keep = np.ones(L, np.int64)
    ins_len = np.zeros(L, np.int64)
    ins_seq = []
    for v in genome.germline:
        if h not in v.haps:
            continue
        if v.kind == "snv":
            base[v.pos] = BASES.index(v.alt)
        elif v.kind == "del":
            keep[v.pos + 1:v.pos + len(v.ref)] = 0
        else:
            ins_len[v.pos] = len(v.alt) - 1
            ins_seq.append((v.pos, _codes(v.alt[1:])))
    counts = keep + ins_len
    ref_pos = np.repeat(np.arange(L), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    is_ins = (np.arange(len(ref_pos)) - first) >= np.repeat(keep, counts)
    bases = base[ref_pos]
    if ins_seq:
        ins_seq.sort(key=lambda x: x[0])
        bases[is_ins] = np.concatenate([s for _p, s in ins_seq])
    return bases, ref_pos, is_ins


def _cigar(ref_pos: np.ndarray, is_ins: np.ndarray):
    """(ops, lens) of one read from its bases' reference positions."""
    ops, lens = [], []
    prev = None
    for rp, ins in zip(ref_pos.tolist(), is_ins.tolist()):
        if ins:
            op = 1
        else:
            if prev is not None and rp > prev + 1:
                ops.append(2)
                lens.append(rp - prev - 1)
            op = 0
            prev = rp
        if ops and ops[-1] == op:
            lens[-1] += 1
        else:
            ops.append(op)
            lens.append(1)
    return ops, lens


def sample_reads(rng, genome: Genome, depth: float, read_len: int,
                 qual_bins, qual_shares, mapq: int, somatic: bool) -> dict:
    """Reads at `depth` from both haplotypes (half each), in position
    order: pos, flag (reverse strand half the time), mapq, seq / qual
    [n, read_len], the flattened CIGARs, ref_span; with `somatic`, each
    read over a somatic site carries its allele with the site's allele
    fraction."""
    L = len(genome.ref)
    n = int(round(depth * L / read_len))
    parts = []
    for h, nh in ((0, n // 2), (1, n - n // 2)):
        bases, rpos, ins = haplotype(genome, h)
        last = len(bases) - read_len
        ok = ~ins[:last + 1] & ~ins[read_len - 1:]
        starts = rng.choice(np.nonzero(ok)[0], nh)
        idx = starts[:, None] + np.arange(read_len)
        parts.append((bases[idx], rpos[idx], ins[idx], h, bases, rpos, ins))
    seq = np.concatenate([p[0] for p in parts])
    rp = np.concatenate([p[1] for p in parts])
    ins = np.concatenate([p[2] for p in parts])
    hap_of = np.concatenate([np.full(len(p[0]), p[3]) for p in parts])
    linear = ~ins.any(axis=1) & (rp[:, -1] - rp[:, 0] == read_len - 1)
    cig = {}                                   # read -> (ops, lens)
    for i in np.nonzero(~linear)[0]:
        cig[int(i)] = _cigar(rp[i], ins[i])
    if somatic:
        _apply_somatic(rng, genome, seq, rp, ins, cig, hap_of, parts,
                       read_len)
    # sequencing: binned qualities, each base wrong with its probability
    shares = np.cumsum(np.asarray(qual_shares, np.float64))
    shares /= shares[-1]
    u = rng.random(seq.shape, dtype=np.float32)
    b = np.zeros(seq.shape, np.uint8)
    for c in shares[:-1]:
        b += u >= np.float32(c)
    qual = np.asarray(qual_bins, np.uint8)[b]
    err_p = np.power(10.0, -np.asarray(qual_bins, np.float64) / 10.0)
    wrong = rng.random(seq.shape, dtype=np.float32) < err_p.astype(
        np.float32)[b]
    shift = rng.integers(1, 4, seq.shape, dtype=np.uint8)
    seq = np.where(wrong, (seq + shift) % 4, seq).astype(np.uint8)
    pos = rp[:, 0].astype(np.int64)
    tie = rng.permutation(len(pos))
    order = np.lexsort((tie, pos))
    n_cig = np.ones(len(pos), np.int64)
    for i, (o, _l) in cig.items():
        n_cig[i] = len(o)
    ops = np.zeros(int(n_cig.sum()), np.int8)
    lens = np.full(len(ops), read_len, np.int32)
    cig_off = np.zeros(len(pos) + 1, np.int64)
    np.cumsum(n_cig[order], out=cig_off[1:])
    span = np.full(len(pos), read_len, np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    for i, (o, ln) in cig.items():
        j = int(inv[i])
        s = cig_off[j]
        ops[s:s + len(o)] = o
        lens[s:s + len(o)] = ln
        span[i] = sum(x for op, x in zip(o, ln) if op != 1)
    flag = np.where(rng.random(len(pos)) < 0.5, 16, 0).astype(np.uint16)
    return {"pos": pos[order], "flag": flag, "mapq": np.full(len(pos), mapq,
                                                             np.uint8),
            "seq": seq[order], "qual": qual[order], "cig_ops": ops,
            "cig_lens": lens, "cig_off": cig_off, "ref_span": span[order]}


def _apply_somatic(rng, genome, seq, rp, ins, cig, hap_of, parts, read_len):
    """Somatic alleles into the tumour's reads, in place: an SNV's base
    where the read lies on its position; an indel rebuilt from the
    read's haplotype (reference-linear there) with its CIGAR."""
    start = rp[:, 0]
    stop = rp[:, -1]
    for v in genome.somatic:
        over = np.nonzero((start <= v.pos) & (stop >= v.pos))[0]
        carry = over[rng.random(len(over)) < v.vaf]
        if v.kind == "snv":
            for i in carry:
                hit = np.nonzero((rp[i] == v.pos) & ~ins[i])[0]
                if len(hit):
                    seq[i, hit[0]] = BASES.index(v.alt)
            continue
        k = abs(len(v.alt) - len(v.ref))
        for i in carry:
            left = v.pos - int(start[i]) + 1
            if left < 10 or read_len - left < 10 + k or int(i) in cig:
                continue
            bases, hrp, hins = parts[int(hap_of[i])][4:]
            at = int(np.searchsorted(hrp, start[i]))
            if v.kind == "del":
                new = np.concatenate([bases[at:at + left],
                                      bases[at + left + k:
                                            at + read_len + k]])
                ops, lens = [0, 2, 0], [left, k, read_len - left]
                rps = np.concatenate([hrp[at:at + left],
                                      hrp[at + left + k:at + read_len + k]])
                ii = np.zeros(read_len, bool)
            else:
                new = np.concatenate([bases[at:at + left],
                                      _codes(v.alt[1:]),
                                      bases[at + left:
                                            at + read_len - k]])
                ops, lens = [0, 1, 0], [left, k, read_len - left - k]
                rps = np.concatenate([hrp[at:at + left],
                                      np.full(k, v.pos),
                                      hrp[at + left:at + read_len - k]])
                ii = np.zeros(read_len, bool)
                ii[left:left + k] = True
            seq[i] = new
            rp[i] = rps
            ins[i] = ii
            cig[int(i)] = (ops, lens)
