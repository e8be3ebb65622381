"""The generator: its rates and qualities, and the same inputs and
truth from the same seed."""
import filecmp
import json
import os

import numpy as np
import pytest

from portbench.gen import dataset, genome

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _config(name, bp):
    with open(os.path.join(CONFIG, f"{name}.json")) as f:
        c = json.load(f)
    c["genome"]["contig_bp"] = bp
    return c


@pytest.fixture(scope="module")
def germline(tmp_path_factory):
    c = _config("germline-wgs35", 300_000)
    return c, dataset.make(c, 2 ** 31 + 11, str(tmp_path_factory.mktemp("g")))


def test_variant_rates(germline):
    c, d = germline
    g = c["genome"]
    L = g["contig_bp"]
    snv = [v for v in d["genome"].germline if v.kind == "snv"]
    ind = [v for v in d["genome"].germline if v.kind != "snv"]
    assert abs(len(snv) - L / g["snv_every"]) <= 0.05 * L / g["snv_every"]
    assert abs(len(ind) - L / g["indel_every"]) <= 0.1 * L / g["indel_every"]
    hom = np.mean([len(v.haps) == 2 for v in d["genome"].germline])
    sd = np.sqrt(0.24 / len(d["genome"].germline))
    assert abs(hom - g["hom_alt_share"]) < 4 * sd
    lens = np.array([abs(len(v.alt) - len(v.ref)) for v in ind])
    assert lens.min() >= 1 and lens.max() <= len(g["indel_len_weights"])
    assert np.mean(lens <= 2) > 0.45


def test_reads_qualities_and_errors(germline):
    from strelka_tpu_torch.io.bam import read_bam
    c, d = germline
    g = c["genome"]
    _h, b = read_bam(d["bams"]["HG002"])
    n = int(round(c["samples"][0]["depth"] * g["contig_bp"] / g["read_len"]))
    assert b.n == n == d["reads"]
    assert np.all(np.diff(b.pos) >= 0)
    vals, counts = np.unique(b.qual, return_counts=True)
    assert list(vals) == g["qual_bins"]
    share = counts / counts.sum()
    assert np.allclose(share, np.array(g["qual_shares"])
                       / sum(g["qual_shares"]), atol=0.01)
    # bases of reads without gaps against the reference, away from sites
    ref = d["genome"].ref
    sites = np.array([v.pos for v in d["genome"].germline])
    wrong = {q: [0, 0] for q in g["qual_bins"]}
    for i in range(0, b.n, 13):
        ops, _l = b.get_cigar(i)
        p = int(b.pos[i])
        if len(ops) != 1 or np.any((sites >= p) & (sites < p + 150)):
            continue
        seq, qual = b.get_seq(i), b.get_qual(i)
        for q in g["qual_bins"]:
            m = qual == q
            wrong[q][0] += int((seq[m] != ref[p:p + 150][m]).sum())
            wrong[q][1] += int(m.sum())
    for q, (w, t) in wrong.items():
        e = 10 ** (-q / 10)
        assert abs(w / t - e) < 4 * np.sqrt(e * (1 - e) / t) + 1e-3, q


def test_same_seed_same_inputs(tmp_path):
    c = _config("somatic-tn60-30", 120_000)
    a = dataset.make(c, 77, str(tmp_path / "a"))
    b = dataset.make(c, 77, str(tmp_path / "b"))
    for k in a["bams"]:
        assert filecmp.cmp(a["bams"][k], b["bams"][k], shallow=False)
    assert filecmp.cmp(a["fasta"], b["fasta"], shallow=False)
    assert ([vars(v) for v in a["genome"].germline + a["genome"].somatic]
            == [vars(v) for v in b["genome"].germline + b["genome"].somatic])
    other = dataset.make(c, 78, str(tmp_path / "c"))
    assert not filecmp.cmp(a["fasta"], other["fasta"], shallow=False)
    assert a["reads"] == other["reads"]


def test_somatic_alleles_at_their_fractions(tmp_path):
    from strelka_tpu_torch.io.bam import read_bam
    c = _config("somatic-tn60-30", 400_000)
    d = dataset.make(c, 5, str(tmp_path))
    som = [v for v in d["genome"].somatic if v.kind == "snv"]
    assert len(som) >= 0.7 * 400_000 / c["somatic"]["snv_every"]
    _h, t = read_bam(d["bams"]["tumor"])
    _h, n = read_bam(d["bams"]["normal"])
    for v in som[:10]:
        for batch, lo in ((t, 0.0), (n, None)):
            idx = np.nonzero((batch.pos <= v.pos)
                             & (batch.pos + 150 > v.pos))[0]
            alt = sum(batch.get_seq(i)[v.pos - batch.pos[i]]
                      == genome.BASES.index(v.alt) for i in idx
                      if len(batch.get_cigar(i)[0]) == 1)
            if lo is None:
                assert alt <= 2          # errors only in the normal
            else:
                assert alt >= 1 or v.vaf < 0.1


def test_large_seed():
    rng = dataset.rng_for(2 ** 31 + 5, 0)
    assert 0 <= rng.integers(0, 10) < 10
