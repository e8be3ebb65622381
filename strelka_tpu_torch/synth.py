"""Synthetic diploid read-batch generator for host-path perf soaks.

Generates a random reference plus a het-variant-planted diploid sample
at a target depth, with configurable SNV/indel density, and returns
(ref_str, ReadBatch, truth dict). Used by profile_host.py and the
scaling soaks; sensitivity math mirrors tests/test_sensitivity.py.
"""
from __future__ import annotations

import numpy as np

from .io import bam as bamio
from .io.fasta import decode_bases, encode_bases
from .utils import cigar as cg


def make_batch(reads):
    """reads: list of (pos, cigar_str, seq, qual, flag, mapq); seq may
    be a base string or a uint8 code array (shared with tests)."""
    b = bamio.ReadBatch()
    b.n = len(reads)
    b.names = [f"r{i}" for i in range(b.n)]
    b.tid = np.zeros(b.n, np.int32)
    b.pos = np.array([r[0] for r in reads], np.int64)
    b.mapq = np.array([r[5] for r in reads], np.uint8)
    b.flag = np.array([r[4] for r in reads], np.uint16)
    b.mate_tid = np.full(b.n, -1, np.int32)
    b.mate_pos = np.zeros(b.n, np.int64)
    b.tlen = np.zeros(b.n, np.int64)
    seqs, quals, ops_l, lens_l = [], [], [], []
    so, co = [0], [0]
    for pos, cstr, scodes, ql, flag, mapq in reads:
        seqs.append(encode_bases(scodes) if isinstance(scodes, str)
                    else scodes)
        quals.append(np.asarray(ql, np.uint8))
        o, l = cg.cigar_from_string(cstr)
        ops_l.append(o)
        lens_l.append(l)
        so.append(so[-1] + len(scodes))
        co.append(co[-1] + len(o))
    b.seq = np.concatenate(seqs)
    b.qual = np.concatenate(quals)
    b.seq_off = np.array(so, np.int64)
    b.cig_ops = np.concatenate(ops_l)
    b.cig_lens = np.concatenate(lens_l)
    b.cig_off = np.array(co, np.int64)
    return b


def generate(L=200_000, depth=40, read_len=100, snv_every=0,
             indel_every=0, indel_len=2, seed=7, err_rate=0.0015,
             qual=32, ref_seed=None, somatic_every=0, somatic_vaf=0.0,
             somatic_indel_every=0, somatic_indel_len=3):
    """Return (ref_str, batch, truth) for a het-planted diploid sample.

    snv_every / indel_every: average spacing of planted het variants
    (0 disables). Indels alternate del/ins of `indel_len` bases.
    ref_seed: seed for the reference sequence AND planted variant set
    (defaults to `seed`); pass the same ref_seed with different `seed`s
    to sample independent read sets (e.g. tumor/normal) from one truth.
    somatic_every/somatic_vaf: additionally plant somatic SNVs (offset
    from the germline grid) carried by each covering read with
    probability `somatic_vaf` — enable for the tumor read set only,
    with the same ref_seed as the normal (truth key "som_snv").
    """
    ref_rng = np.random.default_rng(seed if ref_seed is None else ref_seed)
    rng = np.random.default_rng(seed)
    ref_codes = ref_rng.integers(0, 4, L).astype(np.uint8)

    pad = read_len + 50
    spots = []
    step = min(x for x in (snv_every, indel_every) if x) if (
        snv_every or indel_every) else 0
    truth = {"snv": [], "del": [], "ins": []}
    if step:
        grid = np.arange(pad, L - pad, step)
        for i, p in enumerate(grid):
            p = int(p + ref_rng.integers(-step // 4, step // 4 + 1))
            if snv_every and indel_every:
                kind = "snv" if i % 2 == 0 else ("del" if i % 4 == 1 else "ins")
            elif snv_every:
                kind = "snv"
            else:
                kind = "del" if i % 2 == 0 else "ins"
            truth[kind].append(p)
            spots.append((p, kind))
    spots.sort()

    # somatic SNVs: positions on a grid offset half a step from the
    # germline grid, so covering reads never span a germline indel
    som_snv = {}
    som_indel = {}   # p -> +ilen (ins) / -dlen (del), applied after p
    truth["som_snv"] = []
    truth["som_del"] = []
    truth["som_ins"] = []
    min_gap = read_len + 3 * indel_len + somatic_indel_len
    occupied = {p for p, _k in spots}
    if somatic_every:
        for p in np.arange(pad + somatic_every // 2, L - pad,
                           somatic_every):
            p = int(p)
            if any(abs(p - q) < min_gap for q in occupied):
                continue
            som_snv[p] = (ref_codes[p] + 2) % 4
            truth["som_snv"].append(p)
            occupied.add(p)
    if somatic_indel_every:
        for k, p in enumerate(np.arange(pad + somatic_indel_every // 4,
                                        L - pad, somatic_indel_every)):
            p = int(p)
            if any(abs(p - q) < min_gap for q in occupied):
                continue
            if k % 2 == 0:
                som_indel[p] = -somatic_indel_len
                truth["som_del"].append(p)
            else:
                som_indel[p] = somatic_indel_len
                truth["som_ins"].append(p)
            occupied.add(p)
    som_ins_seq = ref_rng.integers(0, 4, somatic_indel_len).astype(np.uint8)

    # haplotype 1 carries all variants (het); build as code array + map
    hap1 = ref_codes.copy()
    del_set = {}
    ins_set = {}
    for p, kind in spots:
        if kind == "snv":
            hap1[p] = (ref_codes[p] + 1) % 4
        elif kind == "del":
            del_set[p] = indel_len
        else:
            ins_set[p] = ref_rng.integers(0, 4, indel_len).astype(np.uint8)

    som_pos = np.array(sorted(som_snv), np.int64)
    som_ind_pos = np.array(sorted(som_indel), np.int64)

    n_reads = L * depth // read_len
    reads = []
    starts = rng.integers(0, L - read_len - 3 * indel_len - 2,
                          n_reads).astype(np.int64)
    haps = rng.integers(0, 2, n_reads)
    flags = np.where(rng.random(n_reads) < 0.5, 0, 16).astype(np.uint16)
    nerr = rng.poisson(err_rate * read_len, n_reads)
    base_q = np.full(read_len, qual, np.uint8)
    for st, h, fl, ne in zip(starts, haps, flags, nerr):
        st = int(st)
        if h == 0:
            scodes = ref_codes[st:st + read_len].copy()
            cigar = f"{read_len}M"
        else:
            # walk ref coords applying het variants
            parts = []
            cig = []
            i = st
            # avoid starting mid-deletion
            bad = False
            for d, dl in del_set.items():
                if d < st <= d + dl:
                    bad = True
            if bad:
                st = i = st + indel_len + 1
            n = 0
            while n < read_len and i < L:
                parts.append(hap1[i])
                n += 1
                cig.append("M")
                if i in ins_set and n < read_len:
                    take = min(indel_len, read_len - n)
                    parts.extend(ins_set[i][:take])
                    n += take
                    cig.extend("I" * take)
                if i in del_set:
                    cig.extend("D" * del_set[i])
                    i += del_set[i] + 1
                else:
                    i += 1
            if n < read_len:
                continue
            # compress cigar
            cstr = []
            last, cnt = None, 0
            for c in cig:
                if c == last:
                    cnt += 1
                else:
                    if last:
                        cstr.append(f"{cnt}{last}")
                    last, cnt = c, 1
            cstr.append(f"{cnt}{last}")
            cigar = "".join(cstr)
            scodes = np.array(parts[:read_len], np.uint8)
        if som_snv and rng.random() < somatic_vaf:
            # somatic sites sit far from germline indels, so read
            # coordinates there are reference-linear for either hap
            j0 = np.searchsorted(som_pos, st)
            j1 = np.searchsorted(som_pos, st + read_len)
            if j1 > j0:
                scodes = scodes.copy()
                for p in som_pos[j0:j1]:
                    scodes[p - st] = som_snv[int(p)]
        if len(som_ind_pos) and rng.random() < somatic_vaf:
            # apply one somatic indel when the read brackets it with
            # >= 8bp flanks (read window is reference-linear here)
            j0 = np.searchsorted(som_ind_pos, st + 8)
            j1 = np.searchsorted(som_ind_pos, st + read_len - 8
                                 - somatic_indel_len)
            if j1 > j0:
                p = int(som_ind_pos[j0])
                sz = som_indel[p]
                left = p + 1 - st
                if sz < 0:
                    dlen = -sz
                    scodes = np.concatenate([
                        ref_codes[st:p + 1],
                        ref_codes[p + 1 + dlen:st + read_len + dlen]])
                    cigar = f"{left}M{dlen}D{read_len - left}M"
                else:
                    take = min(sz, read_len - left)
                    scodes = np.concatenate([
                        ref_codes[st:p + 1], som_ins_seq[:take],
                        ref_codes[p + 1:st + read_len - take]])
                    cigar = (f"{left}M{take}I{read_len - left - take}M"
                             if read_len - left - take > 0
                             else f"{left}M{take}I")
        if ne:
            idx = rng.integers(0, read_len, ne)
            scodes = scodes.copy()
            scodes[idx] = (scodes[idx] + rng.integers(1, 4, ne)) % 4
        reads.append((st, cigar, scodes, base_q, int(fl), 60))

    reads.sort(key=lambda r: r[0])
    return decode_bases(ref_codes), make_batch(reads), truth
